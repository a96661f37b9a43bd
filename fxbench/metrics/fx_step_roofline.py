"""The FX step's share of its roofline: the least time the traced calls
need (``fxbench.roofline``: their operations at the float32 peak or their
bytes at the device memory's, whichever is longer) over the summed device
time of every kernel in the trace.  Nothing when the card has no peaks in
the table or the trace holds no kernel."""


def read(record):
    trace = record.trace
    if not trace or not trace.get("least_s") or not trace.get("kernel_s"):
        return None
    return 100.0 * trace["least_s"] / trace["kernel_s"]
