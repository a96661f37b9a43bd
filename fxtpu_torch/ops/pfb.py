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

__all__ = ["dc_remove", "zero_history", "frame_rows", "pfb_fir",
           "spectrometer_rows", "spectrometer"]


def dc_remove(iq: torch.Tensor) -> torch.Tensor:
    """DC-spike removal: subtract the per-channel complex mean over the
    last axis (``effex.py:393-395``)."""
    return iq - iq.mean(dim=-1, keepdim=True)


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


def spectrometer_rows(rows: torch.Tensor, window2d: torch.Tensor,
                      history: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming PFB on pre-framed, already DC-corrected rows
    ``[..., S, nbins]`` -> ``(spectra [..., S, nbins], new_history)``.
    ``history`` is the previous block's DC-corrected tail (zeros at
    stream start)."""
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
    return torch.fft.fft(pfb_fir(xp, window2d), dim=-1), new_history


def spectrometer(x: torch.Tensor, window2d: torch.Tensor, nbins: int,
                 history: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Streaming PFB on a DC-corrected sample stream ``[..., nsamp]``
    (``fxtpu.ops.planes.spectrometer_planes`` contract)."""
    return spectrometer_rows(frame_rows(x, nbins), window2d, history)
