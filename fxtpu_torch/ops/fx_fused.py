"""The fused FX step: one block through DC removal, the PFB with carried
history, the FFT and the frame-summed cross power of every baseline.

PyTorch counterpart of ``fxtpu.ops.pfb_pallas.fx_pallas_raw``, whose
Pallas kernel ``_fx_kernel`` (f32 direct-tap mode) becomes the
hand-written CUDA kernel in ``fxtpu_torch/csrc/fx_fused.cu``.  Beside it
sits :func:`fx_fused_raw_reference`, the same function in plain torch.
:func:`fx_fused_raw` runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises.

Contract, for ``x`` complex64 ``[nch, S, nbins]``, the DC-corrected
``history`` complex64 ``[nch, ntaps-1, nbins]``, ``window2d`` float32
``[ntaps, nbins]`` and ``pairs`` ``[nbl, 2]``:

  xp [nbl, nbins]   sum over frames of spec_p * conj(spec_q), natural bin
                    order, no rotation and no normalisation;
  new_history       the block's last ntaps-1 rows minus the block mean;

where spec is the FFT of the FIR over ``[history; x - mean(x)]``.  The
rotation, ``1/n_frames``, fftshift and continuum stay with the caller
(``fxtpu_torch.fx._finish``), as ``_finish_fused`` stays XLA in JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from fxtpu_torch.ops.pfb import spectrometer_rows

__all__ = ["supported", "fx_fused_raw", "fx_fused_raw_reference",
           "pairs_tensor", "MAX_SHARED_BYTES"]

#: Dynamic shared memory one block may use on Hopper (227 KiB).
MAX_SHARED_BYTES = 232448
#: Blocks per channel in the kernel's mean pre-pass.
MEAN_PARTS = 32
#: Most CTAs the frame kernel is split into (two per H100 SM).
MAX_GROUPS = 264
#: Bound on the kernel's [n_groups, nbl, nbins] partial cross power.
MAX_PARTIAL_BYTES = 64 << 20


def shared_bytes(nbins: int, nch: int) -> int:
    """Dynamic shared memory of the frame kernel: every channel's
    spectrum, one FFT ping-pong buffer and the channel means."""
    return ((nch + 1) * nbins + nch) * 8


def supported(nbins: int, ntaps: int, nch: int) -> bool:
    """True when the CUDA kernel takes this shape: nbins a power of two
    in [256, 8192], ntaps >= 2, and the spectra of all channels (plus the
    FFT's work buffer) fit in one block's shared memory."""
    return (256 <= nbins <= 8192 and nbins & (nbins - 1) == 0
            and ntaps >= 2 and nch >= 1
            and shared_bytes(nbins, nch) <= MAX_SHARED_BYTES)


def pairs_tensor(pairs, nch: int, device) -> torch.Tensor:
    """Validated int32 ``[nbl, 2]`` baseline pairs on ``device``, the form
    :func:`fx_fused_raw` takes."""
    p = np.asarray(pairs)
    if p.ndim != 2 or p.shape[1] != 2 or len(p) == 0:
        raise ValueError(f"pairs must be [nbl, 2], got shape {p.shape}")
    if p.min() < 0 or p.max() >= nch:
        raise ValueError(f"pairs index channels outside [0, {nch})")
    return torch.as_tensor(p.astype(np.int32), device=device)


def fx_fused_raw_reference(x: torch.Tensor, history: torch.Tensor,
                           window2d: torch.Tensor, pairs: torch.Tensor):
    """The fused step in plain torch (``torch.fft``), same contract as
    :func:`fx_fused_raw`."""
    rows = x - x.mean(dim=(-2, -1), keepdim=True)
    spec, new_history = spectrometer_rows(rows, window2d, history)
    idx = pairs.to(device=x.device, dtype=torch.long)
    xp = (spec[idx[:, 0]] * spec[idx[:, 1]].conj()).sum(dim=-2)
    return xp, new_history


@functools.lru_cache(maxsize=16)
def _twiddles(nbins: int, device: torch.device) -> torch.Tensor:
    """``exp(-2 pi i m / nbins)`` for m < nbins/2, computed in float64."""
    m = np.arange(nbins // 2, dtype=np.float64)
    tw = np.exp(-2j * np.pi * m / nbins).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _groups(s_rows: int, nbl: int, nbins: int):
    """(n_groups, frames_per_group): one frame per CTA until the grid
    reaches MAX_GROUPS or the partials MAX_PARTIAL_BYTES."""
    cap = max(1, MAX_PARTIAL_BYTES // (nbl * nbins * 8))
    n = max(1, min(s_rows, MAX_GROUPS, cap))
    per = -(-s_rows // n)
    return -(-s_rows // per), per


def _check(x, history, window2d, pairs):
    if x.dtype != torch.complex64 or history.dtype != torch.complex64:
        raise TypeError("x and history must be complex64")
    if window2d.dtype != torch.float32 or pairs.dtype != torch.int32:
        raise TypeError("window2d must be float32 and pairs int32")
    if x.ndim != 3:
        raise ValueError(f"x must be framed [nch, S, nbins], got {x.shape}")
    nch, _, nbins = x.shape
    ntaps = window2d.shape[0]
    if window2d.shape != (ntaps, nbins):
        raise ValueError(f"window2d {tuple(window2d.shape)} does not match "
                         f"nbins={nbins}")
    if history.shape != (nch, ntaps - 1, nbins):
        raise ValueError(f"history {tuple(history.shape)} must be "
                         f"{(nch, ntaps - 1, nbins)}")
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.shape[0] < 1:
        raise ValueError(f"pairs must be [nbl, 2], got {tuple(pairs.shape)}")
    for name, t in (("x", x), ("history", history), ("window2d", window2d),
                    ("pairs", pairs)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not supported(nbins, ntaps, nch):
        raise ValueError(
            f"the CUDA FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch} (see fx_fused.supported)")


def fx_fused_raw(x: torch.Tensor, history: torch.Tensor,
                 window2d: torch.Tensor, pairs: torch.Tensor):
    """Fused DC + PFB + FFT + X for one block -> ``(xp, new_history)``
    (module docstring contract).  ``pairs`` comes from
    :func:`pairs_tensor`: int32 on ``x``'s device, entries in ``[0, nch)``.

    CPU tensors run :func:`fx_fused_raw_reference`; CUDA tensors launch
    the kernel (built at first use) or raise.  Each launch adds one to
    ``fx_fused_raw.launches``."""
    if x.device.type == "cpu":
        return fx_fused_raw_reference(x, history, window2d, pairs)
    if x.device.type != "cuda":
        raise ValueError(f"fx_fused_raw runs on cuda or cpu, not {x.device}")
    _check(x, history, window2d, pairs)
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    nch, s_rows, nbins = x.shape
    ntaps = window2d.shape[0]
    nbl = pairs.shape[0]
    n_groups, per = _groups(s_rows, nbl, nbins)
    dev = x.device
    xp = torch.empty((nbl, nbins), dtype=torch.complex64, device=dev)
    new_hist = torch.empty((nch, ntaps - 1, nbins), dtype=torch.complex64,
                           device=dev)
    partial = torch.empty((n_groups, nbl, nbins), dtype=torch.complex64,
                          device=dev)
    sums = torch.empty((nch, MEAN_PARTS, 2), dtype=torch.float64, device=dev)
    tw = _twiddles(nbins, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fxt_fx_fused(
            x.data_ptr(), history.data_ptr(), window2d.data_ptr(),
            tw.data_ptr(), pairs.data_ptr(), sums.data_ptr(),
            partial.data_ptr(), xp.data_ptr(), new_hist.data_ptr(),
            nch, s_rows, nbins, ntaps, nbl, n_groups, per, MEAN_PARTS,
            stream)
    check(lib, rc, "fx_fused kernel launch")
    fx_fused_raw.launches += 1
    return xp, new_hist


fx_fused_raw.launches = 0
