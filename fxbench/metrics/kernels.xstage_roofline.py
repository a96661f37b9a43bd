"""The X stage's share of its roofline: the least time the traced calls'
cross power needs (``fxbench.xstage_work``: its operations at the float32
peak or its bytes at the device memory's, whichever is longer) over the
device time of the X kernels in the trace.  Nothing where the card has no
peaks in the table or no X kernel ran."""


def read(record):
    trace = record.trace
    if not trace or not trace.get("xstage_least_s") or \
            not trace.get("xstage_s"):
        return None
    return 100.0 * trace["xstage_least_s"] / trace["xstage_s"]
