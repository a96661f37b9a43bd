"""A row's wait in the writer's queue (``products.queue``, from the put to
the get): the writer's 0.1 s poll.  p95 over the window's rows."""

from fxbench.program_spans import length, row_p95


def read(record):
    return row_p95(record, lambda r: length(r, "products.queue"))
