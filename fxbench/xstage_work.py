"""The X stage's work and the device time of its kernels: the least time
the cross power of the wide route needs, whatever computes it, and what a
trace says its kernels took.

Operations, float32: 8 a pair, frame and bin (a complex multiply-add).
Bytes: every channel's spectra read once (complex64) and the parts (the
pairs' cross power, T and GJ, ``nbl + 2 nch`` rows of complex64) written
once.  The least time is the larger of operations over the float32 rate
and bytes over the device memory's rate (``fxbench.roofline``'s peaks)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

__all__ = ["XSTAGE_KERNEL", "xstage_work", "xstage_seconds"]

#: The X kernel's name in a device trace, by substring (its instances over
#: either sample type and any rows a thread).
XSTAGE_KERNEL = "fx_xstage_kernel"


def xstage_work(*, nchan: int, n_baselines: int, num_samp: int,
                nbins: int, k: int) -> Tuple[float, float]:
    """(operations, bytes) of the X stage over ``k`` blocks."""
    frames = num_samp // nbins
    ops = 8.0 * k * n_baselines * frames * nbins
    nbytes = (8.0 * k * nchan * frames * nbins
              + 8.0 * k * (n_baselines + 2 * nchan) * nbins)
    return ops, nbytes


def xstage_seconds(device_ops: Optional[Sequence]) -> Optional[float]:
    """The summed device time of the X kernels among a trace's
    ``device_ops`` (``[name, seconds]``), or None where none ran."""
    if not device_ops:
        return None
    s = sum(sec for name, sec in device_ops if XSTAGE_KERNEL in name)
    return s if s > 0 else None
