"""The fused FX step: one block through DC removal, the PFB with carried
history, the FFT and the frame-summed cross power of every baseline.

PyTorch counterpart of ``fxtpu.ops.pfb_pallas.fx_pallas_raw``, whose
Pallas kernel ``_fx_kernel`` becomes the hand-written CUDA kernels in
``fxtpu_torch/csrc/fx_fused.cu``, one for each of its ingest modes:

  * :func:`fx_fused_raw`, complex64 samples (f32 direct-tap mode);
  * :func:`fx_fused_raw_i8`, 8-bit samples (int8-native mode).

Each takes the FIR in one of two modes: the direct tap loop over the
window (``svd=None``), or, at deep taps, the window's rank-r factors
``svd=(u, v)`` (:func:`svd_tensors`; ``_fx_kernel``'s SVD-FIR mode,
``svd_r > 0``).  Beside each sits its plain torch version
(``*_reference``), which computes the same FIR in the same mode.  A
wrapper runs the plain version only for CPU tensors; for a CUDA tensor it
launches the kernel or raises.  Each mode counts its launches apart:
``.launches`` (direct) and ``.svd_launches`` on each wrapper.

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

K blocks per launch (``fx_pallas_raw_multi(..., merged=True)``):
:func:`fx_fused_raw_multi` and :func:`fx_fused_raw_i8_multi` take the
merged layout ``fxtpu`` stages, ``[nch, K, S, nbins]`` complex64 or
``[nch, K, S, nbins, 2]`` int8 (the same memory as ``[nch, K*S, nbins]``),
and return ``xp [K, nbl, nbins]`` and the history after the last block:
bit for bit what K chained single-block calls return (``fxtpu``'s own
contract, ``fxtpu/fx.py:305-307``), which is how their plain versions
compute it.  The single-block wrappers launch the same entry points at
K = 1.  Their launches count apart, on ``fx_fused_raw_multi`` and
``fx_fused_raw_i8_multi``.

The rotation, ``1/n_frames``, fftshift and continuum stay with the caller
(``fxtpu_torch.fx._finish``), as ``_finish_fused`` stays XLA in JAX.

The stage ablation (``scripts/fused_ablate.py``'s ``STAGE`` and
``_fx_kernel``'s ``FXTPU_FUSED_ABLATE``): :func:`fx_fused_ablate` launches
either entry point with the frame kernel truncated after one of
:data:`STAGES`, the X stage still run over what the truncated frame left,
so each stage's result is a defined function of the input, which
:func:`fx_fused_ablate_reference` computes in plain torch.  ``"full"`` is
the production kernel.  ``fxtpu_torch.probes.ablate`` times the stages.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from fxtpu_torch.ops.pfb import (dequantize, pfb_fir, spectrometer_rows,
                                 svd_fir)
from fxtpu_torch.ops.svd_fir import svd_fir_factors

__all__ = ["supported", "supported_i8", "fx_fused_raw",
           "fx_fused_raw_reference", "fx_fused_raw_i8",
           "fx_fused_raw_i8_reference", "fx_fused_raw_multi",
           "fx_fused_raw_multi_reference", "fx_fused_raw_i8_multi",
           "fx_fused_raw_i8_multi_reference", "fx_fused_ablate",
           "fx_fused_ablate_reference", "stockham_stages", "max_blocks",
           "pairs_tensor", "svd_tensors", "MAX_SHARED_BYTES",
           "MAX_SVD_RANK", "STAGES", "FFT_STAGE_BINS"]

#: Dynamic shared memory one block may use on Hopper (227 KiB).
MAX_SHARED_BYTES = 232448
#: Blocks per channel in the kernel's mean pre-pass.
MEAN_PARTS = 32
#: Most CTAs the frame kernel splits one block into (two per H100 SM).
MAX_GROUPS = 264
#: Bound on one block's [n_groups, nbl, nbins] partial cross power.
MAX_PARTIAL_BYTES = 64 << 20
#: Bound on a launch's partial cross power, all K blocks' together.
MAX_LAUNCH_PARTIAL_BYTES = 1 << 30
#: Largest SVD rank the kernel's FIR keeps in registers (kMaxRank).
MAX_SVD_RANK = 16
#: Most blocks one launch takes (the grid's second axis).
MAX_BLOCKS = 65535
#: Stages of the ablation, in the kernel's numbering (kStageFull ...):
#: the whole step; every tap row read and summed with unit weights,
#: DC-corrected (``load``) or as it arrived (``load_raw``); stop after the
#: FIR; after ``log2(nbins) // 2`` Stockham stages; after all of them,
#: with no X stage.
STAGES = ("full", "load", "load_raw", "fir", "fft_half", "fft")
#: Bins of baseline 0 that stage ``"fft"`` writes (one per thread).
FFT_STAGE_BINS = 256


def shared_bytes(nbins: int, nch: int, ntaps: int = 0, rank: int = 0,
                 mean_blocks: int = 1) -> int:
    """Dynamic shared memory of the frame kernel: every channel's
    spectrum, one FFT ping-pong buffer, the channel means of
    ``mean_blocks`` blocks (:func:`mean_blocks`; 1 for one block per
    launch) and, in the SVD-FIR mode (``rank > 0``), the ``[ntaps,
    rank]`` float32 table u."""
    return (((nch + 1) * nbins + nch * mean_blocks) * 8
            + ntaps * rank * 4)


def mean_blocks(k: int, s_rows: int, ntaps: int) -> int:
    """How many blocks' means a CTA of a K-block launch stages: the
    blocks its frames read rows of, its own and the ``ceil((ntaps-1) /
    S)`` before it, never more than K (the kernel's ``mean_blocks``)."""
    return min(k, -(-(ntaps - 1) // s_rows) + 1)


def supported(nbins: int, ntaps: int, nch: int, rank: int = 0) -> bool:
    """True when the CUDA kernel takes this shape: nbins a power of two
    in [256, 8192], ntaps >= 2, an SVD rank in [0, MAX_SVD_RANK] (0: the
    direct tap loop), and the spectra of all channels (plus the FFT's
    work buffer and the u table) fit in one block's shared memory."""
    return (256 <= nbins <= 8192 and nbins & (nbins - 1) == 0
            and ntaps >= 2 and nch >= 1 and 0 <= rank <= MAX_SVD_RANK
            and shared_bytes(nbins, nch, ntaps, rank) <= MAX_SHARED_BYTES)


def supported_i8(nbins: int, ntaps: int, nch: int, s_rows: int,
                 rank: int = 0) -> bool:
    """True when the int8 kernel takes this shape: what :func:`supported`
    asks, and a block of at least ntaps-1 rows.  The new raw tail is the
    block's own last ntaps-1 rows; a shorter block would carry rows of two
    earlier blocks under one ``mu_prev`` (``fxtpu`` never takes its
    int8-native route there either: ``_pick_tile`` needs a tile >= the
    halo)."""
    return supported(nbins, ntaps, nch, rank) and s_rows >= ntaps - 1


def svd_tensors(window2d, device):
    """The window's factors as the kernel takes them, ``(u [ntaps, r],
    v [r, nbins])`` float32 on ``device``, or None where the window does
    not factorise (``ops.svd_fir.svd_fir_factors``).  They are taken of
    the float32 window the kernel would otherwise read, as ``fxtpu``'s
    ``_fx_call`` factorises its float32 ``w2d``."""
    w = np.asarray(window2d, np.float32)
    fac = svd_fir_factors(w.astype(np.float64), w.shape[1])
    if fac is None:
        return None
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                 device=device) for a in fac[:2])


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
                           window2d: torch.Tensor, pairs: torch.Tensor,
                           svd=None):
    """The fused step in plain torch (``torch.fft``), same contract as
    :func:`fx_fused_raw`."""
    rows = x - x.mean(dim=(-2, -1), keepdim=True)
    spec, new_history = spectrometer_rows(rows, window2d, history, svd)
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
                              quant_step: float, svd=None):
    """The int8 fused step in plain torch, same contract as
    :func:`fx_fused_raw_i8`: both means are subtracted in real units
    before the FIR (the ``_dc_correct(mu_prev=...)`` algebra of
    ``fxtpu``, applied up front)."""
    mu = block_mean_i8(x, quant_step)
    rows = dequantize(x, quant_step) - mu[:, None, None]
    hist = (dequantize(history["tail"], quant_step)
            - history["mu_prev"][:, None, None])
    spec, _ = spectrometer_rows(rows, window2d, hist, svd)
    return (_cross_power(spec, pairs),
            _i8_history(x, window2d.shape[0], mu))


@functools.lru_cache(maxsize=16)
def _twiddles(nbins: int, device: torch.device) -> torch.Tensor:
    """``exp(-2 pi i m / nbins)`` for m < nbins/2, computed in float64."""
    m = np.arange(nbins // 2, dtype=np.float64)
    tw = np.exp(-2j * np.pi * m / nbins).astype(np.complex64)
    return torch.from_numpy(tw).to(device)


def _groups(s_rows: int, nbl: int, nbins: int):
    """(n_groups, frames_per_group) of one block: one frame per CTA until
    the block's CTAs reach MAX_GROUPS or its partials MAX_PARTIAL_BYTES.
    A launch of K blocks has K times the CTAs and the partials: the
    grouping of a block must not depend on K, or its frames would be
    summed in another order than a one-block launch sums them, and K
    blocks would no longer be K one-block launches bit for bit."""
    cap = max(1, MAX_PARTIAL_BYTES // (nbl * nbins * 8))
    n = max(1, min(s_rows, MAX_GROUPS, cap))
    per = -(-s_rows // n)
    return -(-s_rows // per), per


def _check_args(x, window2d, pairs, nbins, tensors, svd):
    """The checks both kernels share: window, pairs, the SVD factors, one
    device and contiguous memory for every tensor the kernel reads.
    Returns the FIR mode's rank (0: the direct tap loop)."""
    if window2d.dtype != torch.float32 or pairs.dtype != torch.int32:
        raise TypeError("window2d must be float32 and pairs int32")
    ntaps = window2d.shape[0]
    if window2d.shape != (ntaps, nbins):
        raise ValueError(f"window2d {tuple(window2d.shape)} does not match "
                         f"nbins={nbins}")
    if pairs.ndim != 2 or pairs.shape[1] != 2 or pairs.shape[0] < 1:
        raise ValueError(f"pairs must be [nbl, 2], got {tuple(pairs.shape)}")
    rank = 0
    if svd is not None:
        u, v = svd
        if u.dtype != torch.float32 or v.dtype != torch.float32:
            raise TypeError("the SVD factors u and v must be float32")
        rank = u.shape[-1]
        if u.shape != (ntaps, rank) or v.shape != (rank, nbins):
            raise ValueError(
                f"svd factors u {tuple(u.shape)} and v {tuple(v.shape)} "
                f"must be [ntaps, r] and [r, nbins] for ntaps={ntaps}, "
                f"nbins={nbins}")
        if not 1 <= rank <= MAX_SVD_RANK:
            raise ValueError(f"svd rank {rank} is outside [1, "
                             f"{MAX_SVD_RANK}] (fx_fused.MAX_SVD_RANK)")
        tensors = [*tensors, ("u", u), ("v", v)]
    for name, t in (("x", x), *tensors, ("window2d", window2d),
                    ("pairs", pairs)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return rank


def max_blocks(s_rows: int, nbins: int, ntaps: int, nch: int, rank: int,
               nbl: int) -> int:
    """The most blocks one launch of either FX kernel takes at this shape
    (0 when not even one fits): bounded by the grid's block axis
    (MAX_BLOCKS), the K blocks' partials together
    (MAX_LAUNCH_PARTIAL_BYTES: each block is grouped as alone, see
    :func:`_groups`, so they grow with K) and the means of the blocks a
    CTA reads in shared memory (MAX_SHARED_BYTES)."""
    per_block = _groups(s_rows, nbl, nbins)[0] * nbl * nbins * 8
    k = min(MAX_BLOCKS, MAX_LAUNCH_PARTIAL_BYTES // per_block)
    while k > 0 and shared_bytes(nbins, nch, ntaps, rank, mean_blocks(
            k, s_rows, ntaps)) > MAX_SHARED_BYTES:
        k = mean_blocks(k, s_rows, ntaps) - 1
    return k


def _check_blocks(k, s_rows, nbins, ntaps, nch, rank, nbl):
    """What a launch of k blocks adds to the per-frame checks: at least
    one block and at most :func:`max_blocks`."""
    most = max_blocks(s_rows, nbins, ntaps, nch, rank, nbl)
    if not 1 <= k <= most:
        raise ValueError(
            f"{k} blocks of S={s_rows} per launch: the kernel takes 1 to "
            f"{most} at this shape (fx_fused.max_blocks: the grid's block "
            f"axis, {MAX_BLOCKS}; the blocks' partial cross power, "
            f"{MAX_LAUNCH_PARTIAL_BYTES} bytes; the blocks' means in "
            f"shared memory, {MAX_SHARED_BYTES} bytes)")


def _check(x, history, window2d, pairs, svd, multi=False):
    if x.dtype != torch.complex64 or history.dtype != torch.complex64:
        raise TypeError("x and history must be complex64")
    if x.ndim != (4 if multi else 3):
        form = "[nch, K, S, nbins]" if multi else "[nch, S, nbins]"
        raise ValueError(f"x must be framed {form}, got {x.shape}")
    nch, s_rows, nbins = x.shape[0], x.shape[-2], x.shape[-1]
    ntaps = window2d.shape[0]
    rank = _check_args(x, window2d, pairs, nbins, [("history", history)],
                       svd)
    if history.shape != (nch, ntaps - 1, nbins):
        raise ValueError(f"history {tuple(history.shape)} must be "
                         f"{(nch, ntaps - 1, nbins)}")
    if not supported(nbins, ntaps, nch, rank):
        raise ValueError(
            f"the CUDA FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch}, rank={rank} (see "
            "fx_fused.supported)")
    if multi:
        _check_blocks(x.shape[1], s_rows, nbins, ntaps, nch, rank,
                      pairs.shape[0])
    return rank


def _check_i8(x, history, window2d, pairs, quant_step, svd, multi=False):
    if not isinstance(history, dict) or set(history) != {"tail", "mu_prev"}:
        raise TypeError('history must be {"tail": ..., "mu_prev": ...}')
    tail, mu_prev = history["tail"], history["mu_prev"]
    if x.dtype != torch.int8 or tail.dtype != torch.int8:
        raise TypeError("x and the tail must be int8")
    if mu_prev.dtype != torch.complex64:
        raise TypeError("mu_prev must be complex64")
    if x.ndim != (5 if multi else 4) or x.shape[-1] != 2:
        form = "[nch, K, S, nbins, 2]" if multi else "[nch, S, nbins, 2]"
        raise ValueError(f"x must be framed int8 {form}, got {x.shape}")
    nch, s_rows, nbins = x.shape[0], x.shape[-3], x.shape[-2]
    ntaps = window2d.shape[0]
    rank = _check_args(x, window2d, pairs, nbins,
                       [("tail", tail), ("mu_prev", mu_prev)], svd)
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
    if not supported_i8(nbins, ntaps, nch, s_rows, rank):
        raise ValueError(
            f"the CUDA int8 FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch}, S={s_rows}, rank={rank} (see "
            "fx_fused.supported_i8)")
    if multi:
        _check_blocks(x.shape[1], s_rows, nbins, ntaps, nch, rank,
                      pairs.shape[0])
    return rank


def _launch_setup(x, pairs, k, s_rows, nbins, merged, lib=None):
    """Library (``lib``, or the one built from this tree's sources),
    output, scratch and grid shared by both kernels' launches over k
    blocks: xp [k, nbl, nbins] (``[nbl, nbins]`` for a one-block call,
    ``merged`` False), partial [k, n_groups, nbl, nbins]."""
    if lib is None:
        from fxtpu_torch.cuda_build import load_kernels
        lib = load_kernels()
    nbl = pairs.shape[0]
    n_groups, per = _groups(s_rows, nbl, nbins)
    xp = torch.empty((k, nbl, nbins) if merged else (nbl, nbins),
                     dtype=torch.complex64, device=x.device)
    partial = torch.empty((k, n_groups, nbl, nbins), dtype=torch.complex64,
                          device=x.device)
    return lib, nbl, n_groups, per, xp, partial


def _svd_ptrs(svd):
    """The factors' addresses for the C call (NULL in the direct mode)."""
    return (None, None) if svd is None else (svd[0].data_ptr(),
                                             svd[1].data_ptr())


def _count(wrapper, rank):
    if rank:
        wrapper.svd_launches += 1
    else:
        wrapper.launches += 1


def _launch(x, history, window2d, pairs, svd, rank, what, merged,
            stage=None, lib=None):
    """The complex64 entry point over x (checked): one block ``[nch, S,
    nbins]`` -> (xp [nbl, nbins], new_history), or with ``merged`` the K
    blocks of ``[nch, K, S, nbins]`` -> (xp [K, nbl, nbins], new_history).
    One block is the same memory as ``[nch, 1, S, nbins]``.  ``stage``
    (an index into :data:`STAGES`) goes through the ablation's entry;
    ``lib`` is another build of the kernels to launch from (a comparison
    of two trees' kernels)."""
    from fxtpu_torch.cuda_build import check
    nch, s_rows, nbins = x.shape[0], x.shape[-2], x.shape[-1]
    k = x.shape[1] if merged else 1
    ntaps = window2d.shape[0]
    lib, nbl, n_groups, per, xp, partial = _launch_setup(
        x, pairs, k, s_rows, nbins, merged, lib)
    dev = x.device
    new_hist = torch.empty((nch, ntaps - 1, nbins), dtype=torch.complex64,
                           device=dev)
    sums = torch.empty((k, nch, MEAN_PARTS, 2), dtype=torch.float64,
                       device=dev)
    tw = _twiddles(nbins, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry, extra = ((lib.fxt_fx_fused, ()) if stage is None
                        else (lib.fxt_fx_ablate, (stage,)))
        rc = entry(
            x.data_ptr(), history.data_ptr(), window2d.data_ptr(),
            *_svd_ptrs(svd), tw.data_ptr(), pairs.data_ptr(),
            sums.data_ptr(), partial.data_ptr(), xp.data_ptr(),
            new_hist.data_ptr(), nch, k, s_rows, nbins, ntaps, rank, nbl,
            n_groups, per, MEAN_PARTS, *extra, stream)
    check(lib, rc, what)
    return xp, new_hist


def _launch_i8(x, history, window2d, pairs, quant_step, svd, rank, what,
               merged, stage=None, lib=None):
    """The int8 entry point over x (checked): one block ``[nch, S, nbins,
    2]`` -> (xp [nbl, nbins], mu [nch]), or with ``merged`` the K blocks of
    ``[nch, K, S, nbins, 2]`` -> (xp [K, nbl, nbins], mu [K, nch]).
    ``stage`` and ``lib`` as for :func:`_launch`."""
    from fxtpu_torch.cuda_build import check
    nch, s_rows, nbins = x.shape[0], x.shape[-3], x.shape[-2]
    k = x.shape[1] if merged else 1
    ntaps = window2d.shape[0]
    lib, nbl, n_groups, per, xp, partial = _launch_setup(
        x, pairs, k, s_rows, nbins, merged, lib)
    dev = x.device
    mu = torch.empty((k, nch) if merged else (nch,), dtype=torch.complex64,
                     device=dev)
    sums = torch.empty((k, nch, MEAN_PARTS, 2), dtype=torch.int64,
                       device=dev)
    tw = _twiddles(nbins, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry, extra = ((lib.fxt_fx_fused_i8, ()) if stage is None
                        else (lib.fxt_fx_ablate_i8, (stage,)))
        rc = entry(
            x.data_ptr(), history["tail"].data_ptr(),
            history["mu_prev"].data_ptr(), window2d.data_ptr(),
            *_svd_ptrs(svd), tw.data_ptr(), pairs.data_ptr(),
            sums.data_ptr(), partial.data_ptr(), xp.data_ptr(),
            mu.data_ptr(), nch, k, s_rows, nbins, ntaps, rank, nbl,
            n_groups, per, MEAN_PARTS, quant_step, *extra, stream)
    check(lib, rc, what)
    return xp, mu


def _on_card(x, name):
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if x.device.type in ("cpu", "cuda"):
        return x.device.type == "cuda"
    raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")


def fx_fused_raw(x: torch.Tensor, history: torch.Tensor,
                 window2d: torch.Tensor, pairs: torch.Tensor, svd=None):
    """Fused DC + PFB + FFT + X for one block -> ``(xp, new_history)``
    (module docstring contract).  ``pairs`` comes from
    :func:`pairs_tensor`: int32 on ``x``'s device, entries in ``[0, nch)``.
    ``svd`` is None (the direct tap loop over ``window2d``) or the
    factors ``(u, v)`` of :func:`svd_tensors` on ``x``'s device.

    CPU tensors run :func:`fx_fused_raw_reference`; CUDA tensors launch
    the kernel (built at first use) at K = 1 or raise.  Each launch adds
    one to ``fx_fused_raw.launches`` (direct) or
    ``fx_fused_raw.svd_launches``."""
    if not _on_card(x, "fx_fused_raw"):
        return fx_fused_raw_reference(x, history, window2d, pairs, svd)
    rank = _check(x, history, window2d, pairs, svd)
    out = _launch(x, history, window2d, pairs, svd, rank,
                  "fx_fused kernel launch", merged=False)
    _count(fx_fused_raw, rank)
    return out


fx_fused_raw.launches = 0
fx_fused_raw.svd_launches = 0


def fx_fused_raw_i8(x: torch.Tensor, history: dict, window2d: torch.Tensor,
                    pairs: torch.Tensor, quant_step: float, svd=None):
    """Fused DC + PFB + FFT + X for one block of 8-bit samples ->
    ``(xp, new_history)`` (module docstring contract; ``history`` is the
    raw-tail dict, zeros at stream start; ``svd`` as for
    :func:`fx_fused_raw`).

    CPU tensors run :func:`fx_fused_raw_i8_reference`; CUDA tensors
    launch the int8 kernel (built at first use) at K = 1 or raise.  Each
    launch adds one to ``fx_fused_raw_i8.launches`` (direct) or
    ``fx_fused_raw_i8.svd_launches``."""
    if not _on_card(x, "fx_fused_raw_i8"):
        return fx_fused_raw_i8_reference(x, history, window2d, pairs,
                                         quant_step, svd)
    quant_step = float(quant_step)
    rank = _check_i8(x, history, window2d, pairs, quant_step, svd)
    xp, mu = _launch_i8(x, history, window2d, pairs, quant_step, svd, rank,
                        "fx_fused_i8 kernel launch", merged=False)
    _count(fx_fused_raw_i8, rank)
    return xp, _i8_history(x, window2d.shape[0], mu)


fx_fused_raw_i8.launches = 0
fx_fused_raw_i8.svd_launches = 0


def fx_fused_raw_multi_reference(x: torch.Tensor, history: torch.Tensor,
                                 window2d: torch.Tensor, pairs: torch.Tensor,
                                 svd=None):
    """K blocks in plain torch: :func:`fx_fused_raw_reference` chained
    over the blocks of the merged ``x [nch, K, S, nbins]``, each block
    taken contiguous as a single-block caller holds it -> ``(xp [K, nbl,
    nbins], history after the last block)``."""
    xps = []
    for k in range(x.shape[1]):
        xp, history = fx_fused_raw_reference(x[:, k].contiguous(), history,
                                             window2d, pairs, svd)
        xps.append(xp)
    return torch.stack(xps), history


def fx_fused_raw_multi(x: torch.Tensor, history: torch.Tensor,
                       window2d: torch.Tensor, pairs: torch.Tensor,
                       svd=None):
    """Fused DC + PFB + FFT + X for the K blocks of the merged ``x [nch,
    K, S, nbins]`` in one launch -> ``(xp [K, nbl, nbins], new_history)``,
    K chained :func:`fx_fused_raw` calls bit for bit (``fxtpu``'s
    ``fx_pallas_raw_multi(..., merged=True)``).  Arguments as for
    :func:`fx_fused_raw`.

    CPU tensors run :func:`fx_fused_raw_multi_reference`; CUDA tensors
    launch the kernel or raise.  Each launch adds one to
    ``fx_fused_raw_multi.launches`` (direct) or
    ``fx_fused_raw_multi.svd_launches``."""
    if not _on_card(x, "fx_fused_raw_multi"):
        return fx_fused_raw_multi_reference(x, history, window2d, pairs, svd)
    rank = _check(x, history, window2d, pairs, svd, multi=True)
    out = _launch(x, history, window2d, pairs, svd, rank,
                  "fx_fused_multi kernel launch", merged=True)
    _count(fx_fused_raw_multi, rank)
    return out


fx_fused_raw_multi.launches = 0
fx_fused_raw_multi.svd_launches = 0


def fx_fused_raw_i8_multi_reference(x: torch.Tensor, history: dict,
                                    window2d: torch.Tensor,
                                    pairs: torch.Tensor, quant_step: float,
                                    svd=None):
    """K blocks of 8-bit samples in plain torch:
    :func:`fx_fused_raw_i8_reference` chained over the blocks of the
    merged ``x [nch, K, S, nbins, 2]`` -> ``(xp [K, nbl, nbins], the
    raw-tail history after the last block)``."""
    xps = []
    for k in range(x.shape[1]):
        xp, history = fx_fused_raw_i8_reference(
            x[:, k].contiguous(), history, window2d, pairs, quant_step, svd)
        xps.append(xp)
    return torch.stack(xps), history


def fx_fused_raw_i8_multi(x: torch.Tensor, history: dict,
                          window2d: torch.Tensor, pairs: torch.Tensor,
                          quant_step: float, svd=None):
    """Fused DC + PFB + FFT + X for the K blocks of the merged 8-bit ``x
    [nch, K, S, nbins, 2]`` in one launch -> ``(xp [K, nbl, nbins],
    new_history)``: K chained :func:`fx_fused_raw_i8` calls bit for bit.
    The new raw tail is the last block's last ntaps-1 rows and
    ``mu_prev`` its mean (``pfb_pallas.py:1719-1734``).

    CPU tensors run :func:`fx_fused_raw_i8_multi_reference`; CUDA tensors
    launch the int8 kernel or raise.  Each launch adds one to
    ``fx_fused_raw_i8_multi.launches`` (direct) or
    ``fx_fused_raw_i8_multi.svd_launches``."""
    if not _on_card(x, "fx_fused_raw_i8_multi"):
        return fx_fused_raw_i8_multi_reference(x, history, window2d, pairs,
                                               quant_step, svd)
    quant_step = float(quant_step)
    rank = _check_i8(x, history, window2d, pairs, quant_step, svd,
                     multi=True)
    xp, mu = _launch_i8(x, history, window2d, pairs, quant_step, svd, rank,
                        "fx_fused_i8_multi kernel launch", merged=True)
    _count(fx_fused_raw_i8_multi, rank)
    return xp, _i8_history(x[:, -1], window2d.shape[0], mu[-1])


fx_fused_raw_i8_multi.launches = 0
fx_fused_raw_i8_multi.svd_launches = 0


def stockham_stages(x: torch.Tensor, nstages: int) -> torch.Tensor:
    """The first ``nstages`` radix-2 Stockham stages of the frame kernel's
    FFT over the last axis of complex ``x`` (a power of two long), by
    tensor indexing, with the kernel's own index arithmetic
    (``fx_fused.cu``: ``b[d]``, ``b[d + ns]``).  All ``log2(n)`` stages
    give the DFT in natural order."""
    n = x.shape[-1]
    log2n = n.bit_length() - 1
    if n != 1 << log2n or not 0 <= nstages <= log2n:
        raise ValueError(f"{nstages} Stockham stages over {n} points")
    half = n // 2
    tw = _twiddles(n, x.device)
    j = torch.arange(half, device=x.device)
    a = x
    for s in range(nstages):
        ns = 1 << s
        k = j & (ns - 1)
        d = ((j - k) << 1) + k
        v0 = a[..., :half]
        v1 = a[..., half:] * tw[k << (log2n - 1 - s)]
        b = torch.empty_like(a)
        b[..., d] = v0 + v1
        b[..., d + ns] = v0 - v1
        a = b
    return a


def fx_fused_ablate_reference(x: torch.Tensor, history, window2d: torch.Tensor,
                              pairs: torch.Tensor, stage: str,
                              quant_step=None, svd=None) -> torch.Tensor:
    """The truncated step in plain torch, same contract as
    :func:`fx_fused_ablate`: the merged rows ``[history; x]`` (each block
    losing its own mean, 8-bit samples dequantized; ``"load_raw"``: as they
    arrived), the stage's share of FIR and Stockham stages, then the cross
    power of every pair summed over each block's frames."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    int8 = x.dtype == torch.int8
    if stage == "full":
        if int8:
            return fx_fused_raw_i8_multi_reference(
                x, history, window2d, pairs, quant_step, svd)[0]
        return fx_fused_raw_multi_reference(x, history, window2d, pairs,
                                            svd)[0]
    nch, k, s_rows = x.shape[:3]
    ntaps, nbins = window2d.shape
    raw = stage == "load_raw"
    if int8 and raw:
        rows = torch.view_as_complex(x.float())
        hist = torch.view_as_complex(history["tail"].float())
    elif int8:
        mu = torch.stack([block_mean_i8(x[:, j], quant_step)
                          for j in range(k)], dim=1)          # [nch, K]
        rows = dequantize(x, quant_step) - mu[:, :, None, None]
        hist = (dequantize(history["tail"], quant_step)
                - history["mu_prev"][:, None, None])
    else:
        rows = x if raw else x - x.mean(dim=(-2, -1), keepdim=True)
        hist = history
    merged = torch.cat([hist, rows.reshape(nch, k * s_rows, nbins)], dim=1)
    if stage in ("load", "load_raw"):
        y = pfb_fir(merged, torch.ones_like(window2d))
    elif svd is None:
        y = pfb_fir(merged, window2d)
    else:
        y = svd_fir(merged, *svd)
    log2n = nbins.bit_length() - 1
    if stage == "fft_half":
        y = stockham_stages(y, log2n // 2)
    elif stage == "fft":
        y = stockham_stages(y, log2n)
    y = y.reshape(nch, k, s_rows, nbins)
    if stage == "fft":
        # frames first, then channels: each block's sum is formed alike
        return y[..., :FFT_STAGE_BINS].sum(dim=2).sum(dim=0)[:, None, :]
    idx = pairs.to(device=y.device, dtype=torch.long)
    xp = (y[idx[:, 0]] * y[idx[:, 1]].conj()).sum(dim=-2)   # [nbl, K, nbins]
    return xp.permute(1, 0, 2).contiguous()


def fx_fused_ablate(x: torch.Tensor, history, window2d: torch.Tensor,
                    pairs: torch.Tensor, stage: str, quant_step=None,
                    svd=None) -> torch.Tensor:
    """The fused step over the K blocks of the merged ``x`` with the frame
    kernel truncated after ``stage`` (:data:`STAGES`) -> ``xp [K, nbl,
    nbins]``: the cross power of what the truncated frames left in the
    channels' slots.  Stage ``"fft"`` runs no X stage and returns ``[K, 1,
    FFT_STAGE_BINS]``, every channel's spectrum summed over the block's
    frames at the first bins.  ``x`` complex64 ``[nch, K, S, nbins]`` with
    a tensor history, or int8 ``[nch, K, S, nbins, 2]`` with the raw-tail
    dict and ``quant_step``; ``svd`` as for :func:`fx_fused_raw`.  No
    history is returned: a timing harness feeds the same one again.

    CPU tensors run :func:`fx_fused_ablate_reference`; CUDA tensors launch
    the kernels (mean pre-pass, truncated frame kernel, reduce) or raise.
    Each launch adds one to ``fx_fused_ablate.launches``."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    int8 = x.dtype == torch.int8
    if int8 and quant_step is None:
        raise ValueError("8-bit samples need their quant_step")
    if not _on_card(x, "fx_fused_ablate"):
        return fx_fused_ablate_reference(x, history, window2d, pairs, stage,
                                         quant_step, svd)
    index = STAGES.index(stage)
    what = f"fx_fused ablation ({stage}) kernel launch"
    if int8:
        quant_step = float(quant_step)
        rank = _check_i8(x, history, window2d, pairs, quant_step, svd,
                         multi=True)
        xp, _ = _launch_i8(x, history, window2d, pairs, quant_step, svd,
                           rank, what, merged=True, stage=index)
    else:
        rank = _check(x, history, window2d, pairs, svd, multi=True)
        xp, _ = _launch(x, history, window2d, pairs, svd, rank, what,
                        merged=True, stage=index)
    fx_fused_ablate.launches += 1
    return xp[:, :1, :FFT_STAGE_BINS] if stage == "fft" else xp


fx_fused_ablate.launches = 0
