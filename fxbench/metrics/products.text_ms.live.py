"""A row's text and flush (``products.text`` plus ``products.flush``).
p95 over the window's rows."""

from fxbench.program_spans import length, row_p95


def read(record):
    return row_p95(record,
                   lambda r: length(r, "products.text", "products.flush"))
