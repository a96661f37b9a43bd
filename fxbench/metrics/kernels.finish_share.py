"""The epilogue's share of the traced calls' kernel time: the device time
of the kernels named ``fx_finish_kernel*`` (all its instances) over that of
every kernel in the trace.  Nothing where no epilogue kernel ran or the
trace holds no kernel."""

#: The epilogue kernel's name in a device trace, by substring.
FINISH_KERNEL = "fx_finish_kernel"


def read(record):
    trace = record.trace
    if not trace or not trace.get("kernel_s") or not trace.get("device_ops"):
        return None
    s = sum(sec for name, sec in trace["device_ops"] if FINISH_KERNEL in name)
    if s <= 0:
        return None
    return 100.0 * s / trace["kernel_s"]
