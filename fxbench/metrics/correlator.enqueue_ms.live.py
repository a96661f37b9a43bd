"""From the aligner handing a block over to its row's put for the writer
(``runtime.align`` end to the point ``products.queued``): the host's
preparing and enqueueing of the step.  p95 over the window's rows."""

from fxbench.program_spans import gap, row_p95


def read(record):
    return row_p95(record,
                   lambda r: gap(r, "runtime.align", "products.queued"))
