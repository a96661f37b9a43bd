"""From the last channel's read of a row's block ending to the aligner
handing the block over (``runtime.feeder.read`` end to ``runtime.align``
end): the rings and the aligner.  p95 over the window's rows."""

from fxbench.program_spans import gap, row_p95


def read(record):
    return row_p95(record,
                   lambda r: gap(r, "runtime.feeder.read", "runtime.align"))
