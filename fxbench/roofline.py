"""The FX step's work and the card's peaks: the least time the function
needs, whatever computes it.

Operations, float32: 2 a sample for the block mean, 4 a tap and sample
for the direct-form FIR (whatever FIR form runs), 5 log2(nbins) a sample
for the FFT, and 8 a baseline, frame and bin for the cross power.  Bytes:
the samples, the carried history and the window's taps in once; the
visibilities and the history out once.  The least time is the larger of
operations over the float32 rate outside the tensor cores and bytes over
the device memory's rate."""

from __future__ import annotations

import math
from typing import Optional, Tuple

__all__ = ["PEAKS", "peaks", "step_work", "least_time_s"]

#: Published peaks by device-name substring: NVIDIA's H100 SXM data sheet
#: at its 700 W limit, float32 without the tensor cores and HBM3.
PEAKS = {"h100": {"fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}}


def peaks(device_name: str) -> Optional[dict]:
    """The peaks of the named card, or None for a card not in the table."""
    name = device_name.lower()
    return next((v for k, v in PEAKS.items() if k in name), None)


def step_work(*, nchan: int, num_samp: int, nbins: int, ntaps: int,
              n_baselines: int, k: int, int8: bool, continuum: bool
              ) -> Tuple[float, float]:
    """(operations, bytes) of one call of the step over ``k`` blocks."""
    frames = num_samp // nbins
    samples = k * nchan * frames * nbins
    ops = (samples * (2 + 4 * ntaps + 5 * math.log2(nbins))
           + 8 * k * n_baselines * frames * nbins)
    if int8:
        history = nchan * (ntaps - 1) * nbins * 2 + 8 * nchan
        sample_bytes = 2 * samples
    else:
        history = nchan * (ntaps - 1) * nbins * 8
        sample_bytes = 8 * samples
    vis = 8 * k * n_baselines * (1 if continuum else nbins)
    nbytes = sample_bytes + 2 * history + 4 * ntaps * nbins + vis
    return float(ops), float(nbytes)


def least_time_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time of ``ops`` operations and ``nbytes`` bytes."""
    return max(ops / peak["fp32_flops"], nbytes / peak["hbm_bytes_per_s"])
