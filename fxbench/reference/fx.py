"""The FX step in plain PyTorch, as the reference correlator defines it
(``effex/effex.py:126-127`` the filter, ``:391-395`` DC removal,
``:497-527`` PFB, rotation and cross power), with the tap history carried
from block to block:

  x       the block less its mean, framed into S rows of nbins samples;
  xp      ntaps-1 rows of the previous block's x, then the rows (zeros
          before the first correlated block);
  spec    FFT over bins of sum_t w[t] * xp[t : t+S];
  G_c     spec_c * exp(2 pi j (fftfreq(nbins, 1/bandwidth) + fc) d_c);
  V_pq    fftshift(mean over frames of G_p conj(G_q));
  CONTINUUM: mean of V over bins / bandwidth (:func:`continuum`).

``rnd`` is applied after every operation: :func:`exact` in float64 for the
reference, :func:`bf16` for the control."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import scipy.signal
import torch

__all__ = ["exact", "bf16", "prototype", "baselines", "dequantize",
           "corrected_rows", "fx_block", "continuum"]

Rnd = Callable[[torch.Tensor], torch.Tensor]


def exact(x: torch.Tensor) -> torch.Tensor:
    """The reference: no rounding (inputs are float64 / complex128)."""
    return x


def bf16(x: torch.Tensor) -> torch.Tensor:
    """The control: ``x`` rounded to bfloat16 (each component of a complex
    value), kept in float32 / complex64 for the next operation."""
    if x.is_complex():
        r = torch.view_as_real(x.to(torch.complex64))
        return torch.view_as_complex(
            r.to(torch.bfloat16).to(torch.float32).contiguous())
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(torch.float32)
    return x


def work_dtype(rnd: Rnd) -> torch.dtype:
    """complex128 for the reference, complex64 under the control."""
    return torch.complex128 if rnd is exact else torch.complex64


def prototype(ntaps: int, nbins: int, window: str = "hamming") -> np.ndarray:
    """The polyphase prototype filter ``[ntaps, nbins]`` float64: a
    periodic ``window`` of ntaps*nbins points times a rectangular-windowed
    sinc low-pass at one bin width, unit gain at DC (scipy.signal's
    ``get_window`` and ``firwin``, ``effex.py:126-127``)."""
    n = ntaps * nbins
    w = (scipy.signal.get_window(window, n)
         * scipy.signal.firwin(n, 1.0 / nbins, window="boxcar"))
    return w.reshape(ntaps, nbins)


def baselines(nchan: int, include_autos: bool) -> np.ndarray:
    """``[nbl, 2]`` pairs: the autos first when included, then the cross
    pairs p < q in row-major order (the product CSV's row order)."""
    pairs = [(c, c) for c in range(nchan)] if include_autos else []
    pairs += [(p, q) for p in range(nchan) for q in range(p + 1, nchan)]
    return np.asarray(pairs, dtype=np.int64)


def dequantize(q: torch.Tensor, step: float, rnd: Rnd = exact) -> torch.Tensor:
    """8-bit ``[..., 2]`` (I, Q) samples -> complex values ``q * step``."""
    f = q.to(torch.float64 if rnd is exact else torch.float32) * step
    return rnd(torch.view_as_complex(f.contiguous()))


def corrected_rows(block: torch.Tensor, nbins: int, rnd: Rnd = exact
                   ) -> torch.Tensor:
    """``[nch, num_samp]`` complex -> ``[nch, S, nbins]``: the block less
    its per-channel mean, framed, the tail beyond the last full row
    dropped."""
    x = rnd(block.to(work_dtype(rnd)))
    mu = rnd(x.mean(dim=-1, keepdim=True))
    s = x.shape[-1] // nbins
    return rnd(x - mu)[:, : s * nbins].reshape(x.shape[0], s, nbins)


def fx_block(block: torch.Tensor, prev: Optional[torch.Tensor],
             window2d: np.ndarray, pairs: np.ndarray, delays: Sequence[float],
             bandwidth: float, frequency: float, rnd: Rnd = exact
             ) -> torch.Tensor:
    """One block's visibility spectra ``[nbl, nbins]`` from its samples ``block [nch, num_samp]``, the block before it
    ``prev`` (None: the first correlated block, zero history) and the
    per-channel delays in seconds."""
    ntaps, nbins = window2d.shape
    dev = block.device
    real = torch.float64 if rnd is exact else torch.float32
    rows = corrected_rows(block, nbins, rnd)
    nch, s = rows.shape[:2]
    if ntaps > 1:
        if prev is None:
            hist = torch.zeros((nch, ntaps - 1, nbins), dtype=rows.dtype,
                               device=dev)
        else:
            hist = corrected_rows(prev, nbins, rnd)[:, s - (ntaps - 1):]
        xp = torch.cat([hist, rows], dim=1)
    else:
        xp = rows
    w = rnd(torch.as_tensor(window2d, dtype=real, device=dev))
    fir = rnd(w[0] * xp[:, 0:s])
    for t in range(1, ntaps):
        fir = rnd(fir + rnd(w[t] * xp[:, t:t + s]))
    spec = rnd(torch.fft.fft(fir, dim=-1))
    del fir, xp, rows
    f = np.fft.fftfreq(nbins, d=1.0 / bandwidth) + frequency
    cycles = np.mod(np.outer(np.asarray(delays, np.float64), f), 1.0)
    rot = torch.polar(torch.ones(cycles.shape, dtype=torch.float64),
                      torch.from_numpy(2.0 * math.pi * cycles))
    rot = rnd(rot.to(device=dev, dtype=spec.dtype))
    spec = rnd(spec * rot[:, None, :])
    p = torch.as_tensor(pairs[:, 0], device=dev)
    q = torch.as_tensor(pairs[:, 1], device=dev)
    vis = rnd(rnd(spec[p] * spec[q].conj()).mean(dim=1))
    return torch.fft.fftshift(vis, dim=-1)


def continuum(vis: torch.Tensor, bandwidth: float, rnd: Rnd = exact
              ) -> torch.Tensor:
    """CONTINUUM values ``[nbl]`` from spectra ``[nbl, nbins]``: the mean
    over bins over the bandwidth (``effex.py:523-524``)."""
    return rnd(rnd(vis.mean(dim=-1)) / bandwidth)
