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

__all__ = ["xcorr_mag", "estimate_delay_gaussian", "estimate_delay"]


def xcorr_mag(iq0: torch.Tensor, iq1: torch.Tensor) -> torch.Tensor:
    """fftshifted magnitude of the zero-padded circular cross-correlation
    ``ifft(fft(iq0) conj(fft(iq1)))`` over ``2n`` points of two
    equal-length complex series (``fxtpu.ops.delay.xcorr_mag``)."""
    if iq0.shape != iq1.shape:
        raise ValueError("Algorithm assumes input complex timeseries "
                         "are of equal length.")
    n = iq0.shape[-1]
    xc = torch.fft.ifft(torch.fft.fft(iq0, n=2 * n)
                        * torch.fft.fft(iq1, n=2 * n).conj())
    return torch.fft.fftshift(xc.abs(), dim=-1)


def estimate_delay_gaussian(iq0: torch.Tensor, iq1: torch.Tensor,
                            rate: float) -> torch.Tensor:
    """Sub-sample delay of ``iq1`` against ``iq0`` in seconds (float32),
    batched over leading axes, by the 3-point Gaussian fit to
    :func:`xcorr_mag` around its peak
    (``fxtpu.ops.delay.estimate_delay_gaussian``).  Positive means
    ``iq1`` lags ``iq0``."""
    mag = xcorr_mag(iq0, iq1)
    n = mag.shape[-1] // 2
    ic = mag.argmax(dim=-1).clamp(1, 2 * n - 2)

    def at(off):
        return torch.gather(mag, -1, (ic + off)[..., None])[..., 0]

    tiny = torch.finfo(mag.dtype).tiny
    lp, lb, ln = (torch.log(torch.clamp(at(o), min=tiny)) for o in (-1, 0, 1))
    denom = lp - 2.0 * lb + ln
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    delta = torch.where(denom.abs() > 0.0, 0.5 * (lp - ln) / safe,
                        torch.zeros_like(denom))
    lag = n - (ic.to(mag.dtype) + delta)
    return lag / rate


def estimate_delay(iq0: torch.Tensor, iq1: torch.Tensor, rate: float,
                   test_offset: float = 0.0) -> torch.Tensor:
    """:func:`estimate_delay_gaussian` less ``test_offset``, TEST mode's
    sweep offset (``fxtpu.ops.delay.estimate_delay``)."""
    return estimate_delay_gaussian(iq0, iq1, rate) - test_offset
