"""The share of the traced window in which the card ran no kernel, copy
or memset (the union of their spans in a CUDA-only trace)."""


def read(record):
    trace = record.trace
    if not trace or not trace.get("window_s") or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
