"""The F-stage spectrometer on its own: DC removal, the PFB FIR with
carried history and the FFT, with the spectra written out.

PyTorch counterpart of ``fxtpu.ops.pfb_pallas.spectrometer_pallas``,
whose Pallas kernel ``_kernel`` becomes the CUDA entry point
``fxt_spectrometer`` in ``fxtpu_torch/csrc/fx_fused.cu``: the fused FX
step's mean pre-pass, FIR and FFT, with an output policy that writes each
spectrum to device memory in place of the X loop, so shared memory holds
one spectrum and the FFT's work buffer for any number of channels.

Contract of :func:`spectrometer_fused`, for ``x`` complex64 ``[nch,
nsamp]``, ``window2d`` float32 ``[ntaps, nbins]`` and the DC-corrected
``history`` complex64 ``[nch, ntaps-1, nbins]``: ``spec [nch, S, nbins]``
(``S = nsamp // nbins``), the FFT of the FIR over ``[history; x -
mean(x)]``, and the new history, the last ntaps-1 rows of that sequence.
The mean covers all ``nsamp`` samples, the tail beyond ``S * nbins``
included, as ``spectrometer_pallas`` takes it.  ``ntaps = 1`` is legal and
carries an empty history.  Neither package's main path calls it.
"""

from __future__ import annotations

import torch

from fxtpu_torch.ops.fx_fused import (MAX_SHARED_BYTES, MEAN_PARTS, _groups,
                                      _twiddles)
from fxtpu_torch.ops.pfb import dc_remove, spectrometer

__all__ = ["spectrometer_fused", "spectrometer_fused_reference",
           "supported_spectrometer"]


def supported_spectrometer(nbins: int, ntaps: int, nch: int) -> bool:
    """True when the CUDA spectrometer takes this shape: nbins a power of
    two in [256, 8192], ntaps >= 1, and one spectrum, the FFT's work
    buffer and the channel means in one block's shared memory."""
    return (256 <= nbins <= 8192 and nbins & (nbins - 1) == 0
            and ntaps >= 1 and nch >= 1
            and (2 * nbins + nch) * 8 <= MAX_SHARED_BYTES)


def spectrometer_fused_reference(x: torch.Tensor, window2d: torch.Tensor,
                                 nbins: int, history: torch.Tensor):
    """The spectrometer in plain torch: ``dc_remove`` then
    ``spectrometer`` (``ops/pfb.py``), the module docstring contract."""
    return spectrometer(dc_remove(x), window2d, nbins, history)


def _check(x, window2d, nbins, history):
    if x.dtype != torch.complex64 or history.dtype != torch.complex64:
        raise TypeError("x and history must be complex64")
    if window2d.dtype != torch.float32:
        raise TypeError("window2d must be float32")
    if x.ndim != 2:
        raise ValueError(f"x must be [nch, nsamp], got {tuple(x.shape)}")
    nch, nsamp = x.shape
    ntaps = window2d.shape[0]
    if window2d.shape != (ntaps, nbins):
        raise ValueError(f"window2d {tuple(window2d.shape)} does not match "
                         f"nbins={nbins}")
    if history.shape != (nch, ntaps - 1, nbins):
        raise ValueError(f"history {tuple(history.shape)} must be "
                         f"{(nch, ntaps - 1, nbins)}")
    if nsamp < nbins:
        raise ValueError(f"block of {nsamp} samples is shorter than one "
                         f"row of {nbins}")
    for name, t in (("x", x), ("window2d", window2d), ("history", history)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not supported_spectrometer(nbins, ntaps, nch):
        raise ValueError(
            f"the CUDA spectrometer does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch} (see supported_spectrometer)")


def spectrometer_fused(x: torch.Tensor, window2d: torch.Tensor, nbins: int,
                       history: torch.Tensor):
    """Fused DC removal + PFB + FFT -> ``(spec, new_history)`` (module
    docstring contract).

    CPU tensors run :func:`spectrometer_fused_reference`; CUDA tensors
    launch the kernel (built at first use) or raise.  Each launch adds one
    to ``spectrometer_fused.launches``."""
    if x.device.type == "cpu":
        return spectrometer_fused_reference(x, window2d, nbins, history)
    if x.device.type != "cuda":
        raise ValueError(
            f"spectrometer_fused runs on cuda or cpu, not {x.device}")
    _check(x, window2d, nbins, history)
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    nch, nsamp = x.shape
    ntaps = window2d.shape[0]
    s_rows = nsamp // nbins
    n_groups, per = _groups(s_rows, 1, nbins)
    dev = x.device
    spec = torch.empty((nch, s_rows, nbins), dtype=torch.complex64,
                       device=dev)
    new_hist = torch.empty((nch, ntaps - 1, nbins), dtype=torch.complex64,
                           device=dev)
    sums = torch.empty((nch, MEAN_PARTS, 2), dtype=torch.float64, device=dev)
    tw = _twiddles(nbins, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fxt_spectrometer(
            x.data_ptr(), history.data_ptr(), window2d.data_ptr(),
            tw.data_ptr(), sums.data_ptr(), spec.data_ptr(),
            new_hist.data_ptr(), nsamp, nch, s_rows, nbins, ntaps, n_groups,
            per, MEAN_PARTS, stream)
    check(lib, rc, "spectrometer kernel launch")
    spectrometer_fused.launches += 1
    return spec, new_hist


spectrometer_fused.launches = 0
