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
    ``fx_fused_parts_i8``, either X stage) and :func:`fx_finish`.  On a
    CUDA device its arguments are checked once and one C call
    (``fxt_fx_step`` / ``fxt_fx_step_i8``, ``csrc/fx_step.cu``) enqueues
    the three kernels: the frame kernel (at deep taps behind the FIR
    launch, ``fx_fused.deep_fir``), then the reduce (on the wide route the
    X kernel) and the epilogue as programmatic dependents of the kernel
    before each.

The epilogue kernel has two instances of one contract, and
:func:`finish_plan` picks one by shape: the one-bin-a-thread instance (a
CTA a block, pair and 256 bins; CONTINUUM always), and from
:data:`FINISH_TILED_PAIRS` pairs on the pair-tiled one (a CTA a block and
tile of :data:`FINISH_TILE` bins, sweeping a chunk of pairs there).  Its
launcher takes the pair-tiled sweep at :data:`FINISH_NARROW_TILE` bins
where every channel's G and H at :data:`FINISH_TILE` do not fit a CTA
(past 433 channels).  The one-bin instance takes at most
:data:`MAX_FINISH_ROWS` (block, pair) rows a launch, so CONTINUUM is
refused past them (from 362 channels with autos at one block).

A wrapper runs the plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  ``fx_finish.launches`` counts launches,
``fx_finish.tiled`` those of the pair-tiled instance.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from fxtpu_torch.ops import fx_fused as ff
from fxtpu_torch.ops.dc_posthoc import block_mu_prev, dc_correct
from fxtpu_torch.ops.fx_fused import (fx_fused_parts, fx_fused_parts_i8,
                                      on_card)
from fxtpu_torch.ops.xengine import (continuum_reduce, rf_freqs,
                                     rotation_phase, split_delays,
                                     unit_phasor)

__all__ = ["FinishTables", "finish", "fx_finish", "fx_finish_reference",
           "fx_fused_step", "check_step", "step_buffers", "step_args",
           "launch_step", "StepPlan", "FinishPlan", "finish_plan",
           "tiled_plan", "finish_launch", "count_finish", "BIN_PLAN",
           "MAX_FINISH_ROWS", "FINISH_TILED_PAIRS", "FINISH_TILE",
           "FINISH_NARROW_TILE", "finish_tile"]

#: Most (block, baseline) rows one launch of the one-bin-a-thread instance
#: takes (its grid's second axis); the pair-tiled one puts K on that axis.
MAX_FINISH_ROWS = 65535
#: The one-bin-a-thread instance's CTA: 256 threads, a bin each
#: (``kThreads`` in ``csrc/fx_finish.cu``).
FINISH_THREADS = 256
#: The pair-tiled instance (``fx_finish_kernel_tiled``): bins a tile (a
#: pair a half-warp, two bins a lane; ``kTileBins`` in the kernel) and the
#: shared memory it takes a channel (G and H at the tile, mu, the mean
#: before it, the delay).
FINISH_TILE = 32
FINISH_CHANNEL_BYTES = (2 * FINISH_TILE + 3) * 8
#: The pair-tiled sweep's tile where :data:`FINISH_TILE`'s G and H of every
#: channel do not fit a CTA (``fx_finish_kernel_narrow``: ``kNarrowBins``,
#: 512 threads, a quarter-warp a pair): 280 bytes a channel, up to 830.
FINISH_NARROW_TILE = 16
#: From this many pairs on the plan takes the pair-tiled instance in
#: SPECTRUM: the lowest of 3, 36, 136, 666, 2,080 and 8,256 pairs (2 to 128
#: channels with autos) at which it won alone on an H100 (PERF.md: the A/B
#: of the two instances, ``scripts/finish_ab.py``, K = 3, 4096 bins; it
#: lost at 3 pairs, 1.05 against 0.82 us a block, and won from 36 on, 1.6
#: to 2.7 times faster).
FINISH_TILED_PAIRS = 36
#: CTAs the pair-tiled grid reaches for by splitting the pairs into
#: chunks: three resident a SM of the H100's 132.
FINISH_FILL_CTAS = 396


@dataclasses.dataclass(frozen=True)
class FinishPlan:
    """One launch of the epilogue (:func:`finish_plan`): ``chunk`` pairs a
    CTA of the pair-tiled instance (grid ``(nbins / tile, K, nbl /
    chunk)``), or 0 for the one-bin-a-thread instance (grid ``(nbins /
    tile, K nbl)``, one CTA a row in CONTINUUM); ``tile`` bins a CTA."""
    chunk: int
    tile: int

    @property
    def tiled(self) -> bool:
        """The pair-tiled instance."""
        return self.chunk > 0


#: The one-bin-a-thread instance's plan.
BIN_PLAN = FinishPlan(0, FINISH_THREADS)


def finish_tile(nch: int) -> Optional[int]:
    """The pair-tiled sweep's tile at ``nch`` channels, as its launcher
    takes it (``launch_tiled`` in ``csrc/fx_finish.cu``): :data:`FINISH_TILE`
    where a CTA's shared memory holds every channel's G and H there, else
    :data:`FINISH_NARROW_TILE` where it holds them at that, else None."""
    for tile in (FINISH_TILE, FINISH_NARROW_TILE):
        if nch * (2 * tile + 3) * 8 <= ff.MAX_SHARED_BYTES:
            return tile
    return None


def finish_plan(nch: int, nbl: int, nbins: int, k: int,
                continuum: bool = False) -> FinishPlan:
    """The epilogue's plan for K blocks of ``nch`` channels, ``nbl`` pairs
    and ``nbins`` bins: the pair-tiled instance (:func:`tiled_plan`) in
    SPECTRUM from :data:`FINISH_TILED_PAIRS` pairs on, where a CTA's
    shared memory holds every channel's G and H at its tile
    (:func:`finish_tile`); else the one-bin-a-thread instance
    (:data:`BIN_PLAN`).  The instance depends on the shape alone, not on
    K."""
    tile = finish_tile(nch)
    if continuum or nbl < FINISH_TILED_PAIRS or tile is None:
        return BIN_PLAN
    return tiled_plan(nbl, nbins, k, tile)


def tiled_plan(nbl: int, nbins: int, k: int,
               tile: int = FINISH_TILE) -> FinishPlan:
    """The pair-tiled instance's plan at ``tile`` bins a CTA: its pairs
    split into the fewest chunks that bring the grid to about
    :data:`FINISH_FILL_CTAS` CTAs."""
    tiles = -(-nbins // tile)
    chunks = max(1, min(nbl, FINISH_FILL_CTAS // (tiles * k)))
    return FinishPlan(-(-nbl // chunks), tile)


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
    rot = unit_phasor(phase)
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


def _tables(consts, freqs, nbins):
    """The window's constants and the frequencies the epilogue reads, in
    :func:`_check_small`'s form."""
    abar, _, cs, cab, cbb = consts
    return [("abar", abar, torch.complex64, (nbins,)),
            ("cs", cs, torch.float32, (nbins,)),
            ("cab", cab, torch.complex64, (nbins,)),
            ("cbb", cbb, torch.float32, (nbins,)),
            ("freqs", freqs, torch.float32, (nbins,))]


def _check_delays(delays, k, nch, nbl, device):
    """``delays`` as the kernel reads them (float32, ``[k, nch]`` or packed
    ``[k, nch, 2]``, on ``device``) and whether they are packed."""
    delays = delays.to(torch.float32)
    packed = delays.ndim == 3
    if tuple(delays.shape) != ((k, nch, 2) if packed else (k, nch)):
        raise ValueError(f"delays {tuple(delays.shape)} must be {(k, nch)} "
                         f"or {(k, nch, 2)}")
    _check_small([("delays", delays, torch.float32, tuple(delays.shape))],
                 device)
    return delays, packed


def _check_rows(plan: FinishPlan, k: int, nbl: int):
    """Refuse K blocks of ``nbl`` pairs where ``plan``'s instance does not
    take them: the one-bin-a-thread instance holds its K nbl rows on its
    grid's second axis (:data:`MAX_FINISH_ROWS`); the pair-tiled one its K
    and its chunks of pairs."""
    if not plan.tiled and k * nbl > MAX_FINISH_ROWS:
        raise ValueError(
            f"{k} blocks of {nbl} baselines on the epilogue's "
            f"one-bin-a-thread instance (CONTINUUM, or fewer than "
            f"{FINISH_TILED_PAIRS} pairs): one launch takes "
            f"{MAX_FINISH_ROWS} rows (fx_epilogue.MAX_FINISH_ROWS)")


def finish_launch(plan: FinishPlan, xp, T, GJ, mu, pairs, consts, delays,
                  tables: FinishTables, n_frames: int, bandwidth: float,
                  continuum: bool, mu_prev=None):
    """Launch the epilogue kernel as ``plan`` says over checked arguments
    (:func:`fx_finish`'s) on the current stream -> vis, and check the
    launch; the caller counts it (:func:`count_finish`)."""
    from fxtpu_torch.cuda_build import check, load_kernels
    k, nbl, nbins = xp.shape
    packed = delays.ndim == 3
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
            int(n_frames), plan.chunk, float(bandwidth), stream)
    check(lib, rc, "fx_finish kernel launch")
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
    kernel (on the instance :func:`finish_plan` takes) or raise.  Each
    launch adds one to ``fx_finish.launches`` and, on the pair-tiled
    instance, to ``fx_finish.tiled``."""
    if not on_card(xp, "fx_finish"):
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
    small = [("mu", mu, torch.complex64, (k, nch)),
             ("pairs", pairs, torch.int32, (nbl, 2)),
             *_tables(consts, tables.fbase if packed else tables.frf, nbins)]
    if mu_prev is not None:
        small.append(("mu_prev", mu_prev, torch.complex64, (nch,)))
    _check_small(small, xp.device)
    plan = finish_plan(nch, nbl, nbins, k, continuum)
    _check_rows(plan, k, nbl)
    vis = finish_launch(plan, xp, T, GJ, mu, pairs, consts, delays, tables,
                        n_frames, bandwidth, continuum, mu_prev)
    count_finish(plan)
    return vis


fx_finish.launches = 0
fx_finish.tiled = 0


def count_finish(plan: FinishPlan):
    """Count one launch of the epilogue on :func:`fx_finish`'s counters:
    ``launches`` and, on the pair-tiled instance, ``tiled``."""
    fx_finish.launches += 1
    fx_finish.tiled += int(plan.tiled)


@dataclasses.dataclass
class StepPlan(ff.PartsPlan):
    """One step's checked arguments (:func:`check_step`): the single
    pass's plan (``fx_fused.plan_parts``), what the epilogue reads and its
    plan (:func:`finish_plan`)."""
    mu_prev: Optional[torch.Tensor]     # int8: the mean the raw tail carries
    delays: torch.Tensor                # float32 [K, nch(, 2)]
    freqs: torch.Tensor
    bandwidth: float
    continuum: bool
    packed: bool
    finish_plan: FinishPlan


def check_step(iq, history, window2d, pairs, consts, delays, tables,
               bandwidth, continuum, quant_step=None,
               svd=None) -> StepPlan:
    """:func:`fx_fused_step`'s checks of CUDA tensors, made once for its
    kernels: the single pass's plan (``fx_fused.plan_parts``), the
    epilogue's checks (delays, the window's tables, the frequencies and,
    for 8-bit samples, the carried mean) and its plan
    (:func:`finish_plan`).  Raises on what the kernels do not take."""
    int8 = isinstance(history, dict)
    parts = ff.plan_parts(iq, history["tail"] if int8 else history, window2d,
                          pairs, svd, consts,
                          float(quant_step) if int8 else None)
    nch, nbins = parts.nch, parts.nbins
    delays, packed = _check_delays(delays, parts.k, nch, parts.nbl,
                                   iq.device)
    freqs = tables.fbase if packed else tables.frf
    small = _tables(consts, freqs, nbins)
    mu_prev = history["mu_prev"] if int8 else None
    if int8:
        small.append(("mu_prev", mu_prev, torch.complex64, (nch,)))
    _check_small(small, iq.device)
    fplan = finish_plan(nch, parts.nbl, nbins, parts.k, bool(continuum))
    _check_rows(fplan, parts.k, parts.nbl)
    return StepPlan(**vars(parts), mu_prev=mu_prev, delays=delays,
                    freqs=freqs, bandwidth=float(bandwidth),
                    continuum=bool(continuum), packed=packed,
                    finish_plan=fplan)


def step_buffers(plan: StepPlan, pool=None) -> dict:
    """The single pass's buffers (``fx_fused.parts_buffers``: its scratch
    from ``pool``, ``mu`` and ``new_hist`` new) and the visibilities
    ``vis``, new (they outlive the step)."""
    bufs = ff.parts_buffers(plan, pool)
    bufs["vis"] = torch.empty(
        (plan.k, plan.nbl) if plan.continuum
        else (plan.k, plan.nbl, plan.nbins), dtype=torch.complex64,
        device=plan.x.device)
    return bufs


def step_args(plan: StepPlan, bufs: dict):
    """The C entry's argument struct (``cuda_build.StepArgs``) for the
    plan and its buffers."""
    from fxtpu_torch.cuda_build import StepArgs
    abar, da, cs, cab, cbb = plan.consts
    xp = plan.xplan.args() if plan.xplan is not None else (0,) * 6
    fir = bufs.get("fir")
    return StepArgs(
        plan.x.data_ptr(), plan.hist.data_ptr(), plan.table.data_ptr(),
        None if fir is None else fir.data_ptr(), plan.tw.data_ptr(),
        plan.pairs.data_ptr(), da.data_ptr(), bufs["sums"].data_ptr(),
        bufs["scratch"].data_ptr(), bufs["parts"].data_ptr(),
        bufs["mu"].data_ptr(), bufs["new_hist"].data_ptr(),
        None if plan.mu_prev is None else plan.mu_prev.data_ptr(),
        abar.data_ptr(), cs.data_ptr(), cab.data_ptr(), cbb.data_ptr(),
        plan.delays.data_ptr(), plan.freqs.data_ptr(), bufs["vis"].data_ptr(),
        1.0 if plan.quant_step is None else plan.quant_step, plan.bandwidth,
        plan.nch, plan.k, plan.s_rows, plan.nbins, plan.ntaps, plan.nbl,
        plan.n_groups, plan.per, int(plan.route == "global"),
        int(plan.packed), int(plan.continuum), *xp,
        None if plan.rowmap is None else plan.rowmap.data_ptr(),
        plan.finish_plan.chunk)


def launch_step(plan: StepPlan, bufs: dict):
    """One call of ``fxt_fx_step`` (``_i8`` for 8-bit samples) over a
    checked plan and its buffers: three kernels on the current stream (four
    at deep taps: the FIR launch first), counted on their wrappers
    (``fx_fused.count_launches``)."""
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    args = step_args(plan, bufs)
    with torch.cuda.device(plan.x.device):
        stream = torch.cuda.current_stream(plan.x.device).cuda_stream
        entry = (lib.fxt_fx_step if plan.quant_step is None
                 else lib.fxt_fx_step_i8)
        rc = entry(ctypes.byref(args), stream)
    check(lib, rc, "fx_step launch")
    ff.count_launches(plan, count_finish)


def fx_fused_step(iq: torch.Tensor, history, window2d: torch.Tensor,
                  pairs: torch.Tensor, consts, delays: torch.Tensor,
                  tables: FinishTables, bandwidth: float, continuum: bool,
                  quant_step=None, svd=None, *, pool=None):
    """The single-pass fused step over the K blocks of the merged ``iq``
    (``[nch, K, S, nbins]`` complex64 with the DC-corrected tail as
    ``history``, or int8 ``[nch, K, S, nbins, 2]`` with the raw-tail dict
    ``{"tail", "mu_prev"}`` and ``quant_step``) -> ``(vis [K, nbl, nbins]
    or [K, nbl], new_history)`` in the same history contract: the parts
    (``fx_fused_parts*``, on the X stage the shape takes), then
    :func:`fx_finish` with ``delays [K, nch(, 2)]``.

    On the CPU the plain versions.  On a CUDA device the arguments are
    checked once (:func:`check_step`) and one C call launches three
    kernels (frames, reduce or on the wide route the X kernel, epilogue;
    at deep taps the FIR launch before them) and nothing else
    (:func:`launch_step`), each counted on its wrapper's counter
    (``fx_fused.count_launches``): ``fx_fused_parts[_i8]`` (its route's
    and FIR mode's counter), ``fx_fused.parts_reduce`` or
    ``fx_xstage.fx_xstage``, :func:`fx_finish` and ``fx_fused.fir_rows``.
    ``pool`` (a dict the caller keeps across steps) holds the step's
    scratch; ``vis`` and the new history are new."""
    if on_card(iq, "fx_fused_step"):
        plan = check_step(iq, history, window2d, pairs, consts, delays,
                          tables, bandwidth, continuum, quant_step, svd)
        bufs = step_buffers(plan, pool)
        launch_step(plan, bufs)
        mu = bufs["mu"]
        new_history = ({"tail": bufs["new_hist"], "mu_prev": mu[-1]}
                       if plan.quant_step is not None else bufs["new_hist"])
        return bufs["vis"], new_history
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
