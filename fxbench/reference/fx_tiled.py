"""The FX step of :mod:`fxbench.reference.fx` with the pairs taken in
tiles, for arrays whose every pair at once would not fit in device memory:
``fx.fx_block`` gathers ``spec[p]`` and ``spec[q]`` for all pairs together,
three ``[nbl, S, nbins]`` complex128 tensors (34.6 GB each at 128 inputs,
8,256 pairs, 64 frames of 4096 bins).  Here a tile holds at most
``tile_bytes`` of one such tensor.

Each pair's product and frame mean are the same operations on the same
numbers as in ``fx.fx_block``, element by element, with ``rnd`` after
each, so the visibilities agree bit for bit at any tiling, and the
control (``rnd=fx.bf16``) is the same control."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from fxbench.reference.fx import Rnd, corrected_rows, exact

__all__ = ["TILE_BYTES", "spectra", "fx_block"]

#: The most bytes of one ``[pairs, S, nbins]`` tensor of a tile.
TILE_BYTES = 2 << 30


def spectra(block: torch.Tensor, prev: Optional[torch.Tensor],
            window2d: np.ndarray, delays: Sequence[float], bandwidth: float,
            frequency: float, rnd: Rnd = exact) -> torch.Tensor:
    """``[nch, S, nbins]``: every channel's frames through the FIR and the
    FFT, rotated by its delay (``fx.fx_block``'s steps before the cross
    power, in its order and rounding)."""
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
    return rnd(spec * rot[:, None, :])


def fx_block(block: torch.Tensor, prev: Optional[torch.Tensor],
             window2d: np.ndarray, pairs: np.ndarray, delays: Sequence[float],
             bandwidth: float, frequency: float, rnd: Rnd = exact,
             tile_bytes: int = TILE_BYTES) -> torch.Tensor:
    """``fx.fx_block``'s visibility spectra ``[nbl, nbins]``, the pairs
    taken ``tile_bytes`` of gathered spectra at a time."""
    spec = spectra(block, prev, window2d, delays, bandwidth, frequency, rnd)
    nch, s, nbins = spec.shape
    per = max(1, tile_bytes // (s * nbins * spec.element_size()))
    dev = spec.device
    vis = torch.empty((len(pairs), nbins), dtype=spec.dtype, device=dev)
    for lo in range(0, len(pairs), per):
        p = torch.as_tensor(pairs[lo:lo + per, 0], device=dev)
        q = torch.as_tensor(pairs[lo:lo + per, 1], device=dev)
        vis[lo:lo + len(p)] = rnd(rnd(spec[p] * spec[q].conj()).mean(dim=1))
    return torch.fft.fftshift(vis, dim=-1)
