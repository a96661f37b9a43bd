"""Delay calibration as the reference correlator defines it
(``effex/effex.py:558-627``): the leading samples of a block less their
mean, the circular cross-correlation of channel 0 with channel c over 2n
points, fftshifted magnitude, argmax clamped to the interior, a 3-point
Gaussian fit in the logs, ``delay = (n - (imax + delta)) / rate``."""

from __future__ import annotations

import numpy as np
import torch

from fxbench.reference.fx import Rnd, exact, work_dtype

__all__ = ["estimate_delays"]


def estimate_delays(block: torch.Tensor, rate: float, ncal: int,
                    rnd: Rnd = exact) -> np.ndarray:
    """Per-channel delays in seconds against channel 0 (``[nch]`` float64,
    ``[0] == 0``) from the leading ``ncal`` samples of ``block [nch,
    num_samp]``.  Under the control every operation, the lag's included,
    is rounded to bfloat16."""
    x = rnd(block[:, :ncal].to(work_dtype(rnd)))
    x = rnd(x - rnd(x.mean(dim=-1, keepdim=True)))
    n = x.shape[-1]
    spec = rnd(torch.fft.fft(x, n=2 * n, dim=-1))
    real = torch.float64 if rnd is exact else torch.float32
    tiny = torch.finfo(real).tiny
    out = np.zeros(x.shape[0], np.float64)
    for c in range(1, x.shape[0]):
        xc = rnd(torch.fft.ifft(rnd(spec[0] * spec[c].conj())))
        mag = rnd(torch.fft.fftshift(xc.abs()))
        ic = int(mag.argmax().clamp(1, 2 * n - 2))
        lp, lb, ln = (rnd(torch.log(torch.clamp(mag[ic + o], min=tiny)))
                      for o in (-1, 0, 1))
        denom = rnd(rnd(lp - rnd(2.0 * lb)) + ln)
        delta = (rnd(rnd(0.5 * rnd(lp - ln)) / denom) if float(denom) != 0.0
                 else torch.zeros((), dtype=real))
        icf = rnd(torch.tensor(float(ic), dtype=real))
        lag = rnd(torch.tensor(float(n), dtype=real) - rnd(icf + delta))
        out[c] = float(lag) / rate
    return out
