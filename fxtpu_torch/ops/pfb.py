"""F-stage: the plain streaming polyphase filterbank spectrometer.

PyTorch counterpart of ``fxtpu.ops.pfb`` and of the spectrometer half of
``fxtpu.ops.planes``: DC removal, a windowed FIR across ``ntaps``
consecutive rows of ``nbins`` samples that carries ``ntaps-1`` rows of
DC-corrected history from block to block, then ``torch.fft.fft`` over the
bins.  Framing contract (``fxtpu/ops/pfb.py``): a block of ``num_samp``
samples gives ``num_samp // nbins`` frames; frame ``k`` reads rows
``k .. k+ntaps-1`` of ``[history; rows]``; tail samples beyond the last
full row are dropped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["dc_remove", "dequantize", "zero_history", "frame_rows",
           "pfb_fir", "svd_fir", "spectrometer_rows", "spectrometer"]


def dc_remove(iq: torch.Tensor) -> torch.Tensor:
    """DC-spike removal: subtract the per-channel complex mean over the
    last axis (``effex.py:393-395``)."""
    return iq - iq.mean(dim=-1, keepdim=True)


def dequantize(q: torch.Tensor, quant_step: float) -> torch.Tensor:
    """8-bit samples ``int8 [..., 2]`` (I, Q interleaved, the ring's
    bytes) -> ``complex64 [...]`` = ``q * quant_step``, one float32
    multiply per plane (``fxtpu.fx._dequant``)."""
    return torch.view_as_complex((q.float() * quant_step).contiguous())


def zero_history(batch_shape, nbins: int, ntaps: int, device,
                 dtype=torch.complex64) -> torch.Tensor:
    """Fresh tap history ``[..., ntaps-1, nbins]`` of zeros."""
    return torch.zeros((*batch_shape, max(ntaps - 1, 0), nbins),
                       dtype=dtype, device=device)


def frame_rows(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """``[..., nsamp]`` -> ``[..., nsamp // nbins, nbins]`` (tail dropped)."""
    s = x.shape[-1] // nbins
    if s < 1:
        raise ValueError(
            f"block of {x.shape[-1]} samples is shorter than one row of "
            f"{nbins}")
    return x[..., : s * nbins].reshape(*x.shape[:-1], s, nbins)


def pfb_fir(xp: torch.Tensor, window2d: torch.Tensor) -> torch.Tensor:
    """``y[..., k, b] = sum_t w[t, b] * xp[..., k+t, b]`` for
    ``xp [..., S+ntaps-1, nbins]`` complex and ``window2d [ntaps, nbins]``
    real, summed in tap order."""
    ntaps = window2d.shape[0]
    s = xp.shape[-2] - ntaps + 1
    acc = window2d[0] * xp[..., 0:s, :]
    for t in range(1, ntaps):
        acc = acc + window2d[t] * xp[..., t:t + s, :]
    return acc


def svd_fir(xp: torch.Tensor, u: torch.Tensor, v: torch.Tensor
            ) -> torch.Tensor:
    """The FIR through the window's rank-r factors ``u [ntaps, r]``, ``v
    [r, nbins]`` (``ops.svd_fir``), computed literally: per rank the
    scalar-tap convolution ``c_k[..., f, b] = sum_t u[t, k] * xp[...,
    f+t, b]`` summed in tap order, then ``sum_k v[k, b] * c_k`` in rank
    order (not ``u @ v`` taken as a window, which rounds differently)."""
    ntaps, r = u.shape
    s = xp.shape[-2] - ntaps + 1
    col = (r,) + (1,) * xp.ndim
    c = u[0].reshape(col) * xp[..., 0:s, :]            # [r, ..., s, nbins]
    for t in range(1, ntaps):
        c = c + u[t].reshape(col) * xp[..., t:t + s, :]
    acc = v[0] * c[0]
    for k in range(1, r):
        acc = acc + v[k] * c[k]
    return acc


def spectrometer_rows(rows: torch.Tensor, window2d: torch.Tensor,
                      history: Optional[torch.Tensor] = None,
                      svd: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming PFB on pre-framed, already DC-corrected rows
    ``[..., S, nbins]`` -> ``(spectra [..., S, nbins], new_history)``.
    ``history`` is the previous block's DC-corrected tail (zeros at
    stream start).  ``svd=(u, v)`` runs the FIR through the window's
    factors (:func:`svd_fir`) instead of the tap loop over ``window2d``."""
    ntaps, nbins = window2d.shape
    batch = rows.shape[:-2]
    if ntaps == 1:
        xp = rows
        new_history = zero_history(batch, nbins, ntaps, rows.device,
                                   rows.dtype)
    else:
        if history is None:
            history = zero_history(batch, nbins, ntaps, rows.device,
                                   rows.dtype)
        xp = torch.cat([history.to(rows.dtype), rows], dim=-2)
        new_history = xp[..., -(ntaps - 1):, :]
    fir = pfb_fir(xp, window2d) if svd is None else svd_fir(xp, *svd)
    return torch.fft.fft(fir, dim=-1), new_history


def spectrometer(x: torch.Tensor, window2d: torch.Tensor, nbins: int,
                 history: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming PFB on a DC-corrected sample stream ``[..., nsamp]``
    (``fxtpu.ops.planes.spectrometer_planes`` contract)."""
    return spectrometer_rows(frame_rows(x, nbins), window2d, history)
