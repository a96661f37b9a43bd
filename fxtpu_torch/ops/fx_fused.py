"""The fused FX step: one block through DC removal, the PFB with carried
history, the FFT and the frame-summed cross power of every baseline.

PyTorch counterpart of ``fxtpu.ops.pfb_pallas.fx_pallas_raw``, whose
Pallas kernel ``_fx_kernel`` becomes the hand-written CUDA kernels in
``fxtpu_torch/csrc/fx_fused.cu``, one for each of its ingest modes:

  * :func:`fx_fused_raw`, complex64 samples (f32 direct-tap mode);
  * :func:`fx_fused_raw_i8`, 8-bit samples (int8-native mode).

Beside each sits its plain torch version (``*_reference``).  A wrapper
runs the plain version only for CPU tensors; for a CUDA tensor it
launches the kernel or raises.

Contract of :func:`fx_fused_raw`, for ``x`` complex64 ``[nch, S, nbins]``,
the DC-corrected ``history`` complex64 ``[nch, ntaps-1, nbins]``,
``window2d`` float32 ``[ntaps, nbins]`` and ``pairs`` ``[nbl, 2]``:

  xp [nbl, nbins]   sum over frames of spec_p * conj(spec_q), natural bin
                    order, no rotation and no normalisation;
  new_history       the block's last ntaps-1 rows minus the block mean;

where spec is the FFT of the FIR over ``[history; x - mean(x)]``.

:func:`fx_fused_raw_i8` takes ``x`` int8 ``[nch, S, nbins, 2]`` (I/Q
interleaved, the ring's bytes) and the raw-tail history of
``fx_pallas_raw_multi``'s int8-native mode, ``{"tail": int8 [nch,
ntaps-1, nbins, 2], "mu_prev": complex64 [nch]}``: the previous block's
last rows as they arrived and its mean in real units.  spec is then the
FFT of the FIR over ``[tail*step - mu_prev; x*step - mu]`` and the new
history is ``{"tail": x[:, S-ntaps+1:], "mu_prev": mu}``.

The rotation, ``1/n_frames``, fftshift and continuum stay with the caller
(``fxtpu_torch.fx._finish``), as ``_finish_fused`` stays XLA in JAX.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fxtpu_torch.ops.pfb import dequantize, spectrometer_rows

__all__ = ["supported", "supported_i8", "fx_fused_raw",
           "fx_fused_raw_reference", "fx_fused_raw_i8",
           "fx_fused_raw_i8_reference", "pairs_tensor", "MAX_SHARED_BYTES"]

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


def supported_i8(nbins: int, ntaps: int, nch: int, s_rows: int) -> bool:
    """True when the int8 kernel takes this shape: what :func:`supported`
    asks, and a block of at least ntaps-1 rows.  The new raw tail is the
    block's own last ntaps-1 rows; a shorter block would carry rows of two
    earlier blocks under one ``mu_prev`` (``fxtpu`` never takes its
    int8-native route there either: ``_pick_tile`` needs a tile >= the
    halo)."""
    return supported(nbins, ntaps, nch) and s_rows >= ntaps - 1


def pairs_tensor(pairs, nch: int, device) -> torch.Tensor:
    """Validated int32 ``[nbl, 2]`` baseline pairs on ``device``, the form
    :func:`fx_fused_raw` takes."""
    p = np.asarray(pairs)
    if p.ndim != 2 or p.shape[1] != 2 or len(p) == 0:
        raise ValueError(f"pairs must be [nbl, 2], got shape {p.shape}")
    if p.min() < 0 or p.max() >= nch:
        raise ValueError(f"pairs index channels outside [0, {nch})")
    return torch.as_tensor(p.astype(np.int32), device=device)


def _cross_power(spec: torch.Tensor, pairs: torch.Tensor) -> torch.Tensor:
    """``sum over frames of spec_p * conj(spec_q)`` -> ``[nbl, nbins]``."""
    idx = pairs.to(device=spec.device, dtype=torch.long)
    return (spec[idx[:, 0]] * spec[idx[:, 1]].conj()).sum(dim=-2)


def fx_fused_raw_reference(x: torch.Tensor, history: torch.Tensor,
                           window2d: torch.Tensor, pairs: torch.Tensor):
    """The fused step in plain torch (``torch.fft``), same contract as
    :func:`fx_fused_raw`."""
    rows = x - x.mean(dim=(-2, -1), keepdim=True)
    spec, new_history = spectrometer_rows(rows, window2d, history)
    return _cross_power(spec, pairs), new_history


def block_mean_i8(x: torch.Tensor, quant_step: float) -> torch.Tensor:
    """Per-channel mean of int8 ``[nch, S, nbins, 2]`` samples in real
    units, complex64 ``[nch]``.  The sum is taken in int64, so it is exact
    and the same in any order; the mean is formed in float64 and rounded
    once, as the kernel forms it."""
    s = x.sum(dim=(1, 2), dtype=torch.int64).double()
    m = s / (x.shape[1] * x.shape[2]) * quant_step
    return torch.view_as_complex(m.float().contiguous())


def _i8_history(x: torch.Tensor, ntaps: int, mu: torch.Tensor) -> dict:
    """The raw-tail history a block leaves: its last ntaps-1 rows as they
    arrived (a copy, so the block's memory is not held) and its mean."""
    tail = x[:, x.shape[1] - (ntaps - 1):].clone(
        memory_format=torch.contiguous_format)
    return {"tail": tail, "mu_prev": mu}


def fx_fused_raw_i8_reference(x: torch.Tensor, history: dict,
                              window2d: torch.Tensor, pairs: torch.Tensor,
                              quant_step: float):
    """The int8 fused step in plain torch, same contract as
    :func:`fx_fused_raw_i8`: both means are subtracted in real units
    before the FIR (the ``_dc_correct(mu_prev=...)`` algebra of
    ``fxtpu``, applied up front)."""
    mu = block_mean_i8(x, quant_step)
    rows = dequantize(x, quant_step) - mu[:, None, None]
    hist = (dequantize(history["tail"], quant_step)
            - history["mu_prev"][:, None, None])
    spec, _ = spectrometer_rows(rows, window2d, hist)
    return (_cross_power(spec, pairs),
            _i8_history(x, window2d.shape[0], mu))


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


def _check_args(x, window2d, pairs, nbins, tensors):
    """The checks both kernels share: window, pairs, one device and
    contiguous memory for every tensor the kernel reads."""
    if window2d.dtype != torch.float32 or pairs.dtype != torch.int32:
        raise TypeError("window2d must be float32 and pairs int32")
    ntaps = window2d.shape[0]
    if window2d.shape != (ntaps, nbins):
        raise ValueError(f"window2d {tuple(window2d.shape)} does not match "
                         f"nbins={nbins}")
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.shape[0] < 1:
        raise ValueError(f"pairs must be [nbl, 2], got {tuple(pairs.shape)}")
    for name, t in (("x", x), *tensors, ("window2d", window2d),
                    ("pairs", pairs)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check(x, history, window2d, pairs):
    if x.dtype != torch.complex64 or history.dtype != torch.complex64:
        raise TypeError("x and history must be complex64")
    if x.ndim != 3:
        raise ValueError(f"x must be framed [nch, S, nbins], got {x.shape}")
    nch, _, nbins = x.shape
    ntaps = window2d.shape[0]
    _check_args(x, window2d, pairs, nbins, [("history", history)])
    if history.shape != (nch, ntaps - 1, nbins):
        raise ValueError(f"history {tuple(history.shape)} must be "
                         f"{(nch, ntaps - 1, nbins)}")
    if not supported(nbins, ntaps, nch):
        raise ValueError(
            f"the CUDA FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch} (see fx_fused.supported)")


def _check_i8(x, history, window2d, pairs, quant_step):
    if not isinstance(history, dict) or set(history) != {"tail", "mu_prev"}:
        raise TypeError('history must be {"tail": ..., "mu_prev": ...}')
    tail, mu_prev = history["tail"], history["mu_prev"]
    if x.dtype != torch.int8 or tail.dtype != torch.int8:
        raise TypeError("x and the tail must be int8")
    if mu_prev.dtype != torch.complex64:
        raise TypeError("mu_prev must be complex64")
    if x.ndim != 4 or x.shape[-1] != 2:
        raise ValueError(
            f"x must be framed int8 [nch, S, nbins, 2], got {x.shape}")
    nch, s_rows, nbins, _ = x.shape
    ntaps = window2d.shape[0]
    _check_args(x, window2d, pairs, nbins,
                [("tail", tail), ("mu_prev", mu_prev)])
    if tail.shape != (nch, ntaps - 1, nbins, 2):
        raise ValueError(f"tail {tuple(tail.shape)} must be "
                         f"{(nch, ntaps - 1, nbins, 2)}")
    if mu_prev.shape != (nch,):
        raise ValueError(f"mu_prev {tuple(mu_prev.shape)} must be {(nch,)}")
    if x.data_ptr() % 2 or tail.data_ptr() % 2:
        raise ValueError("x and the tail must start on an (I, Q) pair "
                         "(an even address)")
    if not (math.isfinite(quant_step) and quant_step > 0):
        raise ValueError(f"quant_step must be positive, got {quant_step}")
    if not supported_i8(nbins, ntaps, nch, s_rows):
        raise ValueError(
            f"the CUDA int8 FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch}, S={s_rows} (see "
            "fx_fused.supported_i8)")


def _launch_setup(x, pairs, s_rows, nbins):
    """Library, output, scratch and grid shared by both kernels' launches."""
    from fxtpu_torch.cuda_build import load_kernels
    lib = load_kernels()
    nbl = pairs.shape[0]
    n_groups, per = _groups(s_rows, nbl, nbins)
    xp = torch.empty((nbl, nbins), dtype=torch.complex64, device=x.device)
    partial = torch.empty((n_groups, nbl, nbins), dtype=torch.complex64,
                          device=x.device)
    return lib, nbl, n_groups, per, xp, partial


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
    from fxtpu_torch.cuda_build import check
    nch, s_rows, nbins = x.shape
    ntaps = window2d.shape[0]
    lib, nbl, n_groups, per, xp, partial = _launch_setup(
        x, pairs, s_rows, nbins)
    dev = x.device
    new_hist = torch.empty((nch, ntaps - 1, nbins), dtype=torch.complex64,
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


def fx_fused_raw_i8(x: torch.Tensor, history: dict, window2d: torch.Tensor,
                    pairs: torch.Tensor, quant_step: float):
    """Fused DC + PFB + FFT + X for one block of 8-bit samples ->
    ``(xp, new_history)`` (module docstring contract; ``history`` is the
    raw-tail dict, zeros at stream start).

    CPU tensors run :func:`fx_fused_raw_i8_reference`; CUDA tensors
    launch the int8 kernel (built at first use) or raise.  Each launch
    adds one to ``fx_fused_raw_i8.launches``."""
    if x.device.type == "cpu":
        return fx_fused_raw_i8_reference(x, history, window2d, pairs,
                                         quant_step)
    if x.device.type != "cuda":
        raise ValueError(
            f"fx_fused_raw_i8 runs on cuda or cpu, not {x.device}")
    quant_step = float(quant_step)
    _check_i8(x, history, window2d, pairs, quant_step)
    from fxtpu_torch.cuda_build import check
    nch, s_rows, nbins, _ = x.shape
    ntaps = window2d.shape[0]
    lib, nbl, n_groups, per, xp, partial = _launch_setup(
        x, pairs, s_rows, nbins)
    dev = x.device
    mu = torch.empty((nch,), dtype=torch.complex64, device=dev)
    sums = torch.empty((nch, MEAN_PARTS, 2), dtype=torch.int64, device=dev)
    tw = _twiddles(nbins, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fxt_fx_fused_i8(
            x.data_ptr(), history["tail"].data_ptr(),
            history["mu_prev"].data_ptr(), window2d.data_ptr(),
            tw.data_ptr(), pairs.data_ptr(), sums.data_ptr(),
            partial.data_ptr(), xp.data_ptr(), mu.data_ptr(),
            nch, s_rows, nbins, ntaps, nbl, n_groups, per, MEAN_PARTS,
            quant_step, stream)
    check(lib, rc, "fx_fused_i8 kernel launch")
    fx_fused_raw_i8.launches += 1
    return xp, _i8_history(x, ntaps, mu)


fx_fused_raw_i8.launches = 0
