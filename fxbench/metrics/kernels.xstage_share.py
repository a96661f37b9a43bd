"""The X kernels' share of the summed device time of every kernel in the
trace.  Nothing where no X kernel ran or the trace holds no kernel."""


def read(record):
    trace = record.trace
    if not trace or not trace.get("xstage_s") or not trace.get("kernel_s"):
        return None
    return 100.0 * trace["xstage_s"] / trace["kernel_s"]
