"""A row's copy to the host (``products.d2h``): the wait for the step's
kernels and the copy.  p95 over the window's rows."""

from fxbench.program_spans import length, row_p95


def read(record):
    return row_p95(record, lambda r: length(r, "products.d2h"))
