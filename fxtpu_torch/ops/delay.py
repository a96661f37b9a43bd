"""Inter-channel delay estimation: FFT cross-correlation + sub-sample peak.

PyTorch counterpart of ``fxtpu.ops.planes.estimate_delay_planes`` (and of
``fxtpu.ops.delay.estimate_delay_gaussian``), after the reference estimator
(``effex/effex.py:558-627``): zero-pad both series to 2n,
circular cross-correlation through ``torch.fft`` (cuFFT on the card; the
JAX package computes it in XLA, outside any Pallas kernel), fftshift,
argmax, 3-point Gaussian interpolation with the peak clamped to the
interior, ``delay = (n - (imax + delta)) / rate``.
"""

from __future__ import annotations

import torch

__all__ = ["estimate_delay"]


def estimate_delay(iq0: torch.Tensor, iq1: torch.Tensor,
                   rate: float) -> torch.Tensor:
    """Sub-sample delay of ``iq1`` against ``iq0`` in seconds (float32),
    batched over leading axes.  Positive means ``iq1`` lags ``iq0``."""
    if iq0.shape != iq1.shape:
        raise ValueError("Algorithm assumes input complex timeseries "
                         "are of equal length.")
    n = iq0.shape[-1]
    f0 = torch.fft.fft(iq0, n=2 * n)
    f1 = torch.fft.fft(iq1, n=2 * n)
    xc = torch.fft.ifft(f0 * f1.conj())
    mag2 = torch.fft.fftshift(xc.real ** 2 + xc.imag ** 2, dim=-1)
    ic = mag2.argmax(dim=-1).clamp(1, 2 * n - 2)

    def at(off):
        return torch.gather(mag2, -1, (ic + off)[..., None])[..., 0]

    tiny = torch.finfo(mag2.dtype).tiny
    # log|x| = 0.5*log|x|^2; the 0.5 cancels in the ratio
    lp, lb, ln = (torch.log(torch.clamp(at(o), min=tiny)) for o in (-1, 0, 1))
    denom = lp - 2.0 * lb + ln
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    delta = torch.where(denom.abs() > 0.0, 0.5 * (lp - ln) / safe,
                        torch.zeros_like(denom))
    lag = n - (ic.to(mag2.dtype) + delta)
    return lag / rate
