"""The writer thread's CPU time over the wall time of its ``products.text``
spans, in %, over the window's rows: below 100 the thread was
descheduled or waited on the interpreter lock while formatting rows."""

from fxbench.program_spans import window_rows


def read(record):
    spans = [r["products.text"] for r in window_rows(record) or ()
             if "products.text" in r]
    wall = sum(b - a for a, b, _ in spans)
    if not spans or wall <= 0:
        return None
    return 100.0 * sum(cpu for _, _, cpu in spans) / wall
