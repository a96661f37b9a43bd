"""The epilogue of the fused FX step: from frame-summed cross power to
visibilities.

Counterpart of ``fxtpu.fx._finish_fused`` and, with the single-pass parts,
of what ``fxtpu`` jits into one executable with its kernel:

  * :func:`finish`, plain torch: the FSTC rotation ``rot_p conj(rot_q)``
    (it commutes with the frame sum), ``1/n_frames``, the fftshift and the
    continuum reduction on DC-corrected cross power (what the two-pass
    wrappers ``fx_fused_raw*`` return);
  * :func:`fx_finish`, one CUDA kernel (``fxtpu_torch/csrc/fx_finish.cu``):
    the post-hoc DC correction of the raw parts
    (``dc_posthoc.dc_correct``, raw-tail terms included) and then
    :func:`finish`, beside its plain version :func:`fx_finish_reference`,
    which is those two functions, some forty small launches;
  * :func:`fx_fused_step`, what the engine's fused route calls per block
    or per K blocks: the single pass (``fx_fused.fx_fused_parts`` or
    ``fx_fused_parts_i8``, either X stage) and :func:`fx_finish`, three
    kernel launches on a CUDA device.

A wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  ``fx_finish.launches`` counts launches.
"""

from __future__ import annotations

import numpy as np
import torch

from fxtpu_torch.ops.dc_posthoc import block_mu_prev, dc_correct
from fxtpu_torch.ops.fx_fused import (_on_card, fx_fused_parts,
                                      fx_fused_parts_i8)
from fxtpu_torch.ops.xengine import (continuum_reduce, rf_freqs,
                                     rotation_phase, split_delays)

__all__ = ["FinishTables", "finish", "fx_finish", "fx_finish_reference",
           "fx_fused_step", "MAX_FINISH_ROWS"]

#: Most (block, baseline) rows one launch of the epilogue takes (its
#: grid's second axis).
MAX_FINISH_ROWS = 65535


class FinishTables:
    """Device-resident constants of :func:`finish`, built once per step
    so the per-block finish makes no host-to-device copy."""

    def __init__(self, pairs: np.ndarray, nbins: int, bandwidth: float,
                 frequency: float, device):
        self.p = torch.as_tensor(pairs[:, 0], dtype=torch.long, device=device)
        self.q = torch.as_tensor(pairs[:, 1], dtype=torch.long, device=device)
        self.fbase = rf_freqs(nbins, bandwidth, frequency, True, device)
        self.frf = rf_freqs(nbins, bandwidth, frequency, False, device)


def finish(xp: torch.Tensor, delays: torch.Tensor, tables: FinishTables,
           n_frames: int, bandwidth: float, continuum: bool):
    """Frame-summed cross power ``[nbl, nbins]``, or ``[K, nbl, nbins]``
    with delays ``[K, nch(, 2)]`` per block -> the visibility
    (``fxtpu.fx._finish_fused``): ``vis[p,q] = xp[p,q] rot_p conj(rot_q) /
    n_frames`` with ``rot_c = exp(+2 pi j f d_c)``, fftshift, and the
    continuum reduction."""
    d, frac = split_delays(delays, xp.ndim - 1)
    dd = d[..., tables.p] - d[..., tables.q]                 # [..., nbl]
    if frac is not None:
        phase = rotation_phase(tables.fbase, dd,
                               frac[..., tables.p] - frac[..., tables.q])
    else:
        phase = rotation_phase(tables.frf, dd, None)
    rot = torch.complex(torch.cos(phase), torch.sin(phase))
    vis = torch.fft.fftshift(xp * rot / n_frames, dim=-1)
    return continuum_reduce(vis, bandwidth) if continuum else vis


def fx_finish_reference(xp, T, GJ, mu, pairs, consts, delays,
                        tables: FinishTables, n_frames: int,
                        bandwidth: float, continuum: bool, mu_prev=None):
    """The epilogue in plain torch, same contract as :func:`fx_finish`:
    ``dc_correct`` with ``block_mu_prev(mu, mu_prev)``, then
    :func:`finish`."""
    xp = dc_correct(xp, T, GJ, mu, pairs, consts,
                    mu_prev=block_mu_prev(mu, mu_prev))
    return finish(xp, delays, tables, n_frames, bandwidth, continuum)


def _rows_stride(name, t, shape):
    """The block stride (in elements) of ``t [K, rows, nbins]`` complex64
    whose ``[rows, nbins]`` blocks are contiguous (a slice of the parts
    tensor is)."""
    if (t.dtype != torch.complex64 or tuple(t.shape) != shape
            or t.stride(-1) != 1 or t.stride(-2) != shape[-1]):
        raise ValueError(
            f"{name} must be complex64 {shape} with contiguous rows, got "
            f"{t.dtype} {tuple(t.shape)} strides {t.stride()}")
    return t.stride(0)


def _check_small(tensors, device):
    """Each ``(name, tensor, dtype, shape)`` contiguous, of that type and
    shape, on ``device``."""
    for name, t, dtype, shape in tensors:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, xp on {device}")


def _check_delays(delays, k, nch, nbl, device):
    """``delays`` as the kernel reads them (float32, ``[k, nch]`` or packed
    ``[k, nch, 2]``, on ``device``) and whether they are packed."""
    if k * nbl > MAX_FINISH_ROWS:
        raise ValueError(f"{k} blocks of {nbl} baselines: one launch takes "
                         f"{MAX_FINISH_ROWS} rows "
                         "(fx_epilogue.MAX_FINISH_ROWS)")
    delays = delays.to(torch.float32)
    packed = delays.ndim == 3
    if tuple(delays.shape) != ((k, nch, 2) if packed else (k, nch)):
        raise ValueError(f"delays {tuple(delays.shape)} must be {(k, nch)} "
                         f"or {(k, nch, 2)}")
    _check_small([("delays", delays, torch.float32, tuple(delays.shape))],
                 device)
    return delays, packed


def _launch_finish(xp, T, GJ, mu, pairs, consts, delays, packed, tables,
                   n_frames, bandwidth, continuum, mu_prev):
    """The epilogue kernel over checked arguments -> vis."""
    from fxtpu_torch.cuda_build import check, load_kernels
    k, nbl, nbins = xp.shape
    abar, _, cs, cab, cbb = consts
    freqs = tables.fbase if packed else tables.frf
    lib = load_kernels()
    dev = xp.device
    vis = torch.empty((k, nbl) if continuum else (k, nbl, nbins),
                      dtype=torch.complex64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fxt_fx_finish(
            xp.data_ptr(), T.data_ptr(), GJ.data_ptr(), mu.data_ptr(),
            None if mu_prev is None else mu_prev.data_ptr(),
            pairs.data_ptr(), abar.data_ptr(), cs.data_ptr(), cab.data_ptr(),
            cbb.data_ptr(), delays.data_ptr(), freqs.data_ptr(),
            vis.data_ptr(), xp.stride(0), T.stride(0), GJ.stride(0), k, nbl,
            mu.shape[-1], nbins, int(packed), int(bool(continuum)),
            int(n_frames), float(bandwidth), stream)
    check(lib, rc, "fx_finish kernel launch")
    fx_finish.launches += 1
    return vis


def fx_finish(xp: torch.Tensor, T: torch.Tensor, GJ: torch.Tensor,
              mu: torch.Tensor, pairs: torch.Tensor, consts,
              delays: torch.Tensor, tables: FinishTables, n_frames: int,
              bandwidth: float, continuum: bool, mu_prev=None):
    """The raw parts of K blocks (``fx_fused.fx_fused_parts``: ``xp [K,
    nbl, nbins]``, ``T``, ``GJ [K, nch, nbins]``, ``mu [K, nch]``) -> the
    visibilities ``[K, nbl, nbins]`` fftshifted, or ``[K, nbl]`` with
    ``continuum``: the post-hoc DC correction (``consts`` of
    ``dc_posthoc.dc_constants``; block k >= 1 corrected for the raw rows of
    block k-1 it read, block 0 for ``mu_prev [nch]``, the carried mean of
    a raw tail, or for none when None), the rotation for ``delays [K,
    nch]`` seconds or packed ``[K, nch, 2]`` (``xengine.pack_delays``)
    against ``tables``, ``1/n_frames``, the shift and the continuum
    reduction over ``bandwidth``.  ``pairs`` as for ``fx_fused_raw``.

    CPU tensors run :func:`fx_finish_reference`; CUDA tensors launch one
    kernel or raise.  Each launch adds one to ``fx_finish.launches``."""
    if not _on_card(xp, "fx_finish"):
        return fx_finish_reference(xp, T, GJ, mu, pairs, consts, delays,
                                   tables, n_frames, bandwidth, continuum,
                                   mu_prev)
    k, nbl, nbins = xp.shape
    nch = mu.shape[-1]
    for name, t, shape in (("xp", xp, (k, nbl, nbins)),
                           ("T", T, (k, nch, nbins)),
                           ("GJ", GJ, (k, nch, nbins))):
        _rows_stride(name, t, shape)
        if t.device != xp.device:
            raise ValueError(f"{name} is on {t.device}, xp on {xp.device}")
    delays, packed = _check_delays(delays, k, nch, nbl, xp.device)
    abar, _, cs, cab, cbb = consts
    small = [("mu", mu, torch.complex64, (k, nch)),
             ("pairs", pairs, torch.int32, (nbl, 2)),
             ("abar", abar, torch.complex64, (nbins,)),
             ("cs", cs, torch.float32, (nbins,)),
             ("cab", cab, torch.complex64, (nbins,)),
             ("cbb", cbb, torch.float32, (nbins,)),
             ("freqs", tables.fbase if packed else tables.frf, torch.float32,
              (nbins,))]
    if mu_prev is not None:
        small.append(("mu_prev", mu_prev, torch.complex64, (nch,)))
    _check_small(small, xp.device)
    return _launch_finish(xp, T, GJ, mu, pairs, consts, delays, packed,
                          tables, n_frames, bandwidth, continuum, mu_prev)


fx_finish.launches = 0


def fx_fused_step(iq: torch.Tensor, history, window2d: torch.Tensor,
                  pairs: torch.Tensor, consts, delays: torch.Tensor,
                  tables: FinishTables, bandwidth: float, continuum: bool,
                  quant_step=None, svd=None):
    """The single-pass fused step over the K blocks of the merged ``iq``
    (``[nch, K, S, nbins]`` complex64 with the DC-corrected tail as
    ``history``, or int8 ``[nch, K, S, nbins, 2]`` with the raw-tail dict
    ``{"tail", "mu_prev"}`` and ``quant_step``) -> ``(vis [K, nbl, nbins]
    or [K, nbl], new_history)`` in the same history contract: the parts,
    then :func:`fx_finish` with ``delays [K, nch(, 2)]``.  On a CUDA
    device that is three kernel launches (frames, reduce or on the wide
    route the X kernel, epilogue) and nothing else; on the CPU the plain
    versions."""
    if isinstance(history, dict):
        xp, t, gj, mu, tail = fx_fused_parts_i8(
            iq, history["tail"], window2d, pairs, quant_step, svd, consts)
        mu_prev = history["mu_prev"]
        new_history = {"tail": tail, "mu_prev": mu[-1]}
    else:
        xp, t, gj, mu, new_history = fx_fused_parts(
            iq, history, window2d, pairs, svd, consts)
        mu_prev = None
    vis = fx_finish(xp, t, gj, mu, pairs, consts, delays, tables, iq.shape[2],
                    bandwidth, continuum, mu_prev)
    return vis, new_history
