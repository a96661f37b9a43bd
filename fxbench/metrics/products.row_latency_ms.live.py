"""The program's share of a row's latency: from the last channel's read of
its block ending to its flush ending (``runtime.feeder.read`` end to
``products.flush`` end).  ``live_latency_p95_ms`` less this is the
source's lateness and the follower's poll.  p95 over the window's rows."""

from fxbench.program_spans import gap, row_p95


def read(record):
    return row_p95(record,
                   lambda r: gap(r, "runtime.feeder.read", "products.flush"))
