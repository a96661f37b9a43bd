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
(``*_reference``), which computes the same FIR in the same mode (the SVD
mode as ``sum_k v_k (u_k conv x)``).  The kernels run either mode as the
direct loop over one table (:func:`fir_table`: the window, or ``u v``
formed in float64 and rounded once, the same function in another
association), and at deep taps (:func:`deep_fir`) that loop is a launch
of its own, ``fir_rows_kernel``, which reads each row once and writes
every frame's FIR output for the frame kernel (:func:`fir_rows` launches it
alone; each launch adds one to ``fir_rows.launches``).  A
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

The single pass (``fx_pallas_parts``): :func:`fx_fused_parts` and
:func:`fx_fused_parts_i8` run the FIR and the FFT over the samples as they
arrived, with no mean pre-pass, and return the raw accumulators of
``_fx_kernel`` for the K blocks of the merged layout: ``(xp_raw [K, nbl,
nbins], T [K, nch, nbins], GJ [K, nch, nbins], mu [K, nch], tail)``, from
which ``ops.dc_posthoc.dc_correct`` removes the means after the fact.  It
is what the engine's fused step launches (``ops.fx_epilogue.fx_fused_step``:
the parts, then one epilogue kernel).  Blocks k >= 1 of one call read
block k-1's rows raw in both ingests, so ``dc_correct`` takes
``mu_prev[k] = mu[k-1]`` for them (``dc_posthoc.block_mu_prev``); the
result agrees with K chained one-block calls within rounding, no longer
bit for bit.  The two-pass wrappers above keep their contract: one call
that returns corrected cross power, its DC bin included, exactly.

The single pass forms its X stage on one of two routes (``x_stage``,
:data:`X_STAGES`, chosen by :func:`x_route`): the shared-memory route,
where every channel's spectrum of a frame stays in the shared memory of
its frame group's cluster of two CTAs (:func:`supported`: 6 channels at
4096 bins, 2 at 8192; :func:`frame_ctas`; up to ``fxtpu``'s 64 channels,
:data:`MAX_FUSED_NCHAN`), and the wide route for the rest, up to
:data:`MAX_WIDE_NCHAN` = 512 channels: the frame kernel writes each
spectrum to a device scratch ``[K, nch, S, nbins]`` and the X kernel
(``ops.fx_xstage``, ``csrc/fx_xstage.cu``) forms the parts from it, with
the same contract; its plain versions are :func:`fx_fused_parts_wide_reference`
and :func:`fx_fused_parts_i8_wide_reference`, the spectra first and then
``fx_xstage.fx_xstage_reference``.  :func:`supported_parts` takes either.

The rotation, ``1/n_frames``, fftshift and continuum stay with the caller
(``fxtpu_torch.ops.fx_epilogue``), as ``_finish_fused`` stays XLA in JAX.

The stage ablation (``scripts/fused_ablate.py``'s ``STAGE`` and
``_fx_kernel``'s ``FXTPU_FUSED_ABLATE``): :func:`fx_fused_ablate` launches
either entry point with the frame kernel truncated after one of
:data:`STAGES`, the X stage still run over what the truncated frame left,
so each stage's result is a defined function of the input, which
:func:`fx_fused_ablate_reference` computes in plain torch.  ``"full"`` is
the production kernel.  ``fxtpu_torch.probes.ablate`` times the stages.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from fxtpu_torch.ops.dc_posthoc import dc_constants
from fxtpu_torch.ops.fx_xstage import (XStagePlan, count_launch,
                                       fx_xstage_reference, row_map,
                                       xstage_launch, xstage_plan)
from fxtpu_torch.ops.pfb import (dequantize, pfb_fir, spectrometer_rows,
                                 svd_fir)
from fxtpu_torch.ops.svd_fir import svd_fir_factors

__all__ = ["supported", "supported_i8", "fx_fused_raw",
           "fx_fused_raw_reference", "fx_fused_raw_i8",
           "fx_fused_raw_i8_reference", "fx_fused_raw_multi",
           "fx_fused_raw_multi_reference", "fx_fused_raw_i8_multi",
           "fx_fused_raw_i8_multi_reference", "fx_fused_parts",
           "fx_fused_parts_reference", "fx_fused_parts_i8",
           "fx_fused_parts_i8_reference", "fx_fused_parts_wide_reference",
           "PartsPlan", "plan_parts", "parts_buffers", "launch_parts",
           "count_launches", "on_card",
           "parts_reduce", "parts_reduce_reference",
           "fx_fused_parts_i8_wide_reference", "supported_parts", "x_route",
           "max_blocks_parts", "fx_fused_ablate",
           "fx_fused_ablate_reference", "stockham_stages", "fft_radices",
           "fft_passes", "fft_slot", "frame_ctas", "frame_shared_bytes",
           "kernel_bins", "wide_route_bytes", "FFT_MAX_SUB",
           "shared_route_bytes", "cluster_size", "max_blocks",
           "pairs_tensor", "svd_tensors", "fir_table", "deep_fir",
           "fir_rows", "fir_rows_reference", "DEEP_FIR_TAPS",
           "MAX_SHARED_BYTES", "CLUSTER_CTAS",
           "MAX_SVD_RANK", "MAX_FUSED_NCHAN", "MAX_WIDE_NCHAN", "X_STAGES",
           "STAGES",
           "MIXED_STAGES",
           "FFT_STAGE_BINS"]

#: Dynamic shared memory one block may use on Hopper (227 KiB).
MAX_SHARED_BYTES = 232448
#: Blocks per channel in the kernel's mean pre-pass.
MEAN_PARTS = 32
#: Most frame groups the frame kernel splits one block into (two per H100
#: SM; a cluster policy runs each on up to CLUSTER_CTAS CTAs).
MAX_GROUPS = 264
#: CTAs of a frame group's cluster where channels meet in one product.
CLUSTER_CTAS = 2
#: Bound on one block's [n_groups, nbl, nbins] partial cross power.
MAX_PARTIAL_BYTES = 64 << 20
#: Bound on a launch's partial cross power, all K blocks' together.
MAX_LAUNCH_PARTIAL_BYTES = 1 << 30
#: Bound on one block's buffers of the single pass (its scratch, sums and
#: parts, :func:`_layout`): 32 GiB of the H100's 80 GB, the rest left to
#: the visibilities, the staged blocks and the caller.  Where one block
#: passes the caps that bound K, a launch takes that block alone while its
#: buffers fit this (:func:`max_blocks_parts`).
MAX_BLOCK_BYTES = 32 << 30
#: float2 slots per channel the single-pass frame kernel keeps in shared
#: memory for its warps' sample sums (2 kWarps: a pair of doubles a warp).
PARTS_CHAN_SLOTS = 16
#: Largest SVD rank the wrappers take.  The kernels run the factors folded
#: into one table (:func:`fir_table`), whatever the rank; the bound stays
#: so that the routes' rules (:func:`shared_route_bytes`, which still count
#: the radix-2 kernel's ``[ntaps, rank]`` table) do not move.
MAX_SVD_RANK = 16
#: Taps from which the FIR is a launch of its own (``fir_rows_kernel``),
#: whose rows the frame kernel reads one a frame (:func:`deep_fir`):
#: ``fxtpu``'s deep-tap threshold (``ops.svd_fir.SVD_FIR_MIN_TAPS``).
DEEP_FIR_TAPS = 16
#: Frames a thread of the FIR launch sums (``kFirFrames``) and the block
#: means a CTA of it stages (``kFirMaxMeans``).
FIR_FRAMES = 16
FIR_MAX_MEANS = 256
#: Most channels the single pass takes on its shared route (``fxtpu``'s
#: ``MAX_FUSED_NCHAN``, ``pfb_pallas.py:87``).
MAX_FUSED_NCHAN = 64
#: Most channels the single pass takes on its wide route: LEDA's 256
#: dual-polarisation antennas (131,328 pairs with autos), whose pairs the
#: X kernel's band instance takes past MeerKAT's 128 channels
#: (``fx_xstage.xstage_plan``) and the epilogue's narrow pair-tiled
#: instance past 433 (``fx_epilogue.finish_plan``).
MAX_WIDE_NCHAN = 512
#: Where the single pass forms its X stage: ``"shared"``, every channel's
#: spectrum of a frame in one CTA's shared memory (``supported``);
#: ``"global"``, the wide route, the spectra written to device memory and
#: read by the X kernel (``ops.fx_xstage``); ``"auto"``, shared where it
#: fits, else global.
X_STAGES = ("auto", "shared", "global")
#: Most blocks one launch takes (the grid's second axis).
MAX_BLOCKS = 65535
#: Stages of the ablation, in the kernel's numbering (kStageFull ...):
#: the whole step; every tap row read and summed with unit weights,
#: DC-corrected (``load``) or as it arrived (``load_raw``); stop after the
#: FIR; after the first ``floor(passes / 2)`` of the FFT's radix passes
#: (:func:`fft_radices`); after all of them, with no X stage.
STAGES = ("full", "load", "load_raw", "fir", "fft_half", "fft")
#: The stages the ablation runs at bin counts that are not a power of two
#: in [256, 8192] (the frame kernel's mixed-radix instance): enough for
#: the FFT's own time, ``fft - fir``.
MIXED_STAGES = ("full", "fir", "fft")
#: Bins of baseline 0 that stage ``"fft"`` writes (one per thread).
FFT_STAGE_BINS = 256
#: The largest FFT the frame kernel runs as one Stockham sequence over its
#: slot (``kFftMaxSub``); above it, two halves of n/2 points and a radix-2
#: pass (:func:`fft_radices`).
FFT_MAX_SUB = 8192


def kernel_bins(nbins: int) -> bool:
    """True for the bin counts the frame kernel's FFT takes: those of
    ``fxtpu``'s Pallas kernels (``_kernel_factor``, ``pfb_pallas.py:75-81``),
    every multiple of 128 from 256 to 16,384."""
    return nbins % 128 == 0 and 2 <= nbins // 128 <= 128


def _pow2_bins(nbins: int) -> bool:
    """The bin counts of the radix-16 FFT (``fft_sized``): a power of two
    in [256, 8192]; every other count runs the mixed-radix one."""
    return 256 <= nbins <= FFT_MAX_SUB and nbins & (nbins - 1) == 0


def shared_route_bytes(nbins: int, nch: int, ntaps: int = 0, rank: int = 0,
                       mean_blocks: int = 1) -> int:
    """The shared route's rule: the bytes by which :func:`supported` and
    :func:`max_blocks` decide whether a shape takes the kernels that keep
    every channel's spectrum of a frame on chip.  It is the footprint of
    the radix-2 frame kernel these routes were first sized for (every
    channel's spectrum, an FFT ping-pong buffer, the channel means of
    ``mean_blocks`` blocks -- :func:`mean_blocks`; :data:`PARTS_CHAN_SLOTS`
    for the single pass's sample sums -- and in the SVD-FIR mode the
    ``[ntaps, rank]`` float32 table u), kept so that the routes do not
    move; a launch asks for :func:`frame_shared_bytes`, which is never
    more."""
    return (((nch + 1) * nbins + nch * mean_blocks) * 8
            + ntaps * rank * 4)


def wide_route_bytes(nbins: int, nch: int, ntaps: int = 0,
                     rank: int = 0) -> int:
    """The wide route's rule (:func:`supported_parts`), sized like
    :func:`shared_route_bytes` for its one-slot frame kernel: a spectrum,
    an FFT work buffer, the warps' sample sums of every channel and the
    SVD table u.  Above :data:`FFT_MAX_SUB` bins, where the spectrum and
    that buffer (2 x 16384 x 8 B at 16,384 bins) exceed a CTA's shared
    memory, the rule is the one-slot launch's footprint
    (:func:`frame_shared_bytes`: the spectrum and the twiddle table) and
    that table u."""
    if nbins > FFT_MAX_SUB:
        return (frame_shared_bytes(nbins, nch, PARTS_CHAN_SLOTS,
                                   one_slot=True) + ntaps * rank * 4)
    return ((2 * nbins + nch * PARTS_CHAN_SLOTS) * 8
            + ntaps * rank * 4)


def cluster_size(nch: int) -> int:
    """CTAs a frame group runs on where a frame's channels meet in one
    product (the two-pass and the single-pass shared-route kernels): a
    cluster of :data:`CLUSTER_CTAS`, one CTA for one channel."""
    return min(CLUSTER_CTAS, nch)


def frame_shared_bytes(nbins: int, nch: int, chan_slots: int = 1, *,
                       one_slot: bool = False) -> int:
    """Dynamic shared memory one CTA of the frame kernel asks for
    (``launch_frames`` in ``csrc/fx_fused.cu``): its spectrum slots --
    ``ceil(nch / cluster_size(nch))`` for a cluster policy, one for the
    one-slot policies (``one_slot``: the spectrometer and the wide route's
    frames) -- each its FFT's only buffer, the FFT's twiddle table
    (``nbins / 2`` float2) and ``chan_slots`` float2 per channel (the means
    of :func:`mean_blocks` blocks, or :data:`PARTS_CHAN_SLOTS` for the
    single pass's sample sums).  Neither FIR policy keeps a table there:
    the SVD mode's factors are folded into the FIR's table
    (:func:`fir_table`), which the tap loop reads from device memory."""
    slots = 1 if one_slot else -(-nch // cluster_size(nch))
    return (slots * nbins + nbins // 2 + nch * chan_slots) * 8


def frame_ctas(nch: int, nbins: int, n_groups: int, per: int, s_rows: int,
               *, one_slot: bool = False):
    """The frame kernel's split of one block, CTA by CTA, as
    ``csrc/fx_fused.cu`` makes it (its ``Cta``): a list of ``(group, rank,
    channels, frames, bins)``, ``channels`` the channels whose FIR and FFT
    the CTA runs, ``frames`` its group's frames and ``bins`` the range of
    bins of every pair whose cross power it forms (empty for the one-slot
    policies, which form none).  A cluster policy runs a group on
    :func:`cluster_size` CTAs, CTA r taking channels r, r + csize, ... and
    the r-th 1/csize of the bins; a one-slot policy runs one channel a
    CTA.  (Above :data:`FFT_MAX_SUB` bins the wide route's frames in the
    direct FIR mode run ``fx_wide_halves_kernel`` instead: a frame group
    of one channel on a cluster of two CTAs, CTA r holding the frame's
    samples of parity r and forming bins [r, r + 1) n / 4 and n / 2 on.)"""
    ctas = []
    for g in range(n_groups):
        frames = range(g * per, min((g + 1) * per, s_rows))
        if one_slot:
            ctas += [(g, 0, (c,), frames, range(0)) for c in range(nch)]
            continue
        cs = cluster_size(nch)
        part = nbins // cs
        ctas += [(g, r, tuple(range(r, nch, cs)), frames,
                  range(r * part, (r + 1) * part)) for r in range(cs)]
    return ctas


def mean_blocks(k: int, s_rows: int, ntaps: int) -> int:
    """How many blocks' means a CTA of a K-block launch stages: the
    blocks its frames read rows of, its own and the ``ceil((ntaps-1) /
    S)`` before it, never more than K (the kernel's ``mean_blocks``)."""
    return min(k, -(-(ntaps - 1) // s_rows) + 1)


def supported(nbins: int, ntaps: int, nch: int, rank: int = 0) -> bool:
    """True when the CUDA kernels take this shape: nbins a multiple of 128
    in [256, 16384] (:func:`kernel_bins`), ntaps >= 2, an SVD rank in [0,
    MAX_SVD_RANK] (0: the direct tap loop), and the shared route's rule
    holds
    (:func:`shared_route_bytes` of every channel's spectrum, an FFT work
    buffer, the u table and the single pass's sample sums within
    MAX_SHARED_BYTES; a launch asks for less, :func:`frame_shared_bytes`)."""
    return (kernel_bins(nbins)
            and ntaps >= 2 and nch >= 1 and 0 <= rank <= MAX_SVD_RANK
            and shared_route_bytes(nbins, nch, ntaps, rank, PARTS_CHAN_SLOTS)
            <= MAX_SHARED_BYTES)


def supported_i8(nbins: int, ntaps: int, nch: int, s_rows: int,
                 rank: int = 0) -> bool:
    """True when the int8 kernels take this shape: what :func:`supported`
    asks, and a block of at least ntaps-1 rows.  The new raw tail is the
    block's own last ntaps-1 rows; a shorter block would carry rows of two
    earlier blocks under one ``mu_prev`` (``fxtpu`` never takes its
    int8-native route there either: ``_pick_tile`` needs a tile >= the
    halo).  The single pass asks the same in either ingest
    (:func:`supported_parts`)."""
    return supported(nbins, ntaps, nch, rank) and s_rows >= ntaps - 1


def supported_parts(nbins: int, ntaps: int, nch: int, s_rows: int,
                    rank: int = 0) -> bool:
    """True when the single-pass kernels take this shape, in either
    ingest: nbins a multiple of 128 in [256, 16384] (:func:`kernel_bins`:
    ``fxtpu``'s Pallas kernels take the same), ntaps >= 2, an SVD rank
    in [0, MAX_SVD_RANK], 1 to MAX_WIDE_NCHAN channels, a block of at
    least ntaps-1 rows (the post-hoc correction assumes that a block's
    first ntaps-1 frames reach into the previous block only; ``fxtpu``'s
    ``_pick_tile`` asks the same), and one of the two X stages fits
    (:func:`x_route`): the shared-memory route where :func:`supported`
    holds up to MAX_FUSED_NCHAN channels (``fxtpu``'s bound), else the
    wide route, whose frame kernel and X kernel fit for every such nch.
    An engine's blocks always hold ntaps rows (the config's bound)."""
    if not (kernel_bins(nbins)
            and ntaps >= 2 and 1 <= nch <= MAX_WIDE_NCHAN
            and 0 <= rank <= MAX_SVD_RANK and s_rows >= ntaps - 1):
        return False
    return _shared_fits(nbins, ntaps, nch, rank) or (
        wide_route_bytes(nbins, nch, ntaps, rank) <= MAX_SHARED_BYTES
        and xstage_plan(nch, nch * (nch + 1) // 2, s_rows,
                        nbins).shared_bytes <= MAX_SHARED_BYTES)


def _shared_fits(nbins: int, ntaps: int, nch: int, rank: int) -> bool:
    """The single pass's shared route takes the shape: :func:`supported`
    and at most :data:`MAX_FUSED_NCHAN` channels."""
    return nch <= MAX_FUSED_NCHAN and supported(nbins, ntaps, nch, rank)


def x_route(nbins: int, ntaps: int, nch: int, rank: int = 0,
            x_stage: str = "auto") -> str:
    """The single pass's X stage at this shape: ``"shared"`` or
    ``"global"`` (:data:`X_STAGES`).  ``"auto"`` takes the shared-memory
    route where :func:`supported` holds, up to :data:`MAX_FUSED_NCHAN`
    channels, and the wide route elsewhere; ``"shared"`` raises where it
    does not hold; ``"global"`` is the wide route at any shape (a caller
    forces it where both fit, to compare them)."""
    if x_stage not in X_STAGES:
        raise ValueError(f"x_stage must be one of {X_STAGES}, got "
                         f"{x_stage!r}")
    fits = _shared_fits(nbins, ntaps, nch, rank)
    if x_stage == "shared" and not fits:
        raise ValueError(
            f"x_stage='shared': the spectra of nch={nch} channels of "
            f"{nbins} bins (rank={rank}) do not fit in one CTA's shared "
            f"memory, or nch > {MAX_FUSED_NCHAN} (see fx_fused.supported)")
    if x_stage == "auto":
        return "shared" if fits else "global"
    return x_stage


@functools.lru_cache(maxsize=8)
def _folded(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``u v`` formed in float64 and rounded once to float32, contiguous,
    on the factors' device (cached: an engine passes the same factors every
    step)."""
    return (u.double() @ v.double()).float().contiguous()


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
    u, v = (torch.as_tensor(np.ascontiguousarray(a, np.float32),
                            device=device) for a in fac[:2])
    _folded(u, v)   # the kernels' table, formed now and not in a step
    return u, v


def fir_table(window2d: torch.Tensor, svd=None) -> torch.Tensor:
    """The table ``[ntaps, nbins]`` float32 the kernels' FIR loop runs
    over: the window in the direct mode, the SVD mode's factors ``u [ntaps,
    r]``, ``v [r, nbins]`` folded into ``u v`` (float64, rounded once).
    ``sum_t (u v)[t, b] row[f + t, b]`` is the plain version's ``sum_k
    v[k, b] sum_t u[t, k] row[f + t, b]`` in another association, with
    ``ntaps`` multiply-adds an output instead of ``(ntaps + 1) r``; the
    two differ by rounding (within 1e-6 of scale,
    ``tests/test_torch_svd_fir.py``)."""
    return window2d if svd is None else _folded(*svd)


def deep_fir(ntaps: int, s_rows: int) -> bool:
    """True where the kernels run the FIR as a launch of its own
    (``fir_rows_kernel``) and the frame kernel reads one row of its output
    a frame: from :data:`DEEP_FIR_TAPS` taps, where the tap loop in the
    frame kernel read every row ``ntaps`` times, at block lengths whose
    rows a CTA of it spans lie in at most :data:`FIR_MAX_MEANS` blocks."""
    return (ntaps >= DEEP_FIR_TAPS
            and (FIR_FRAMES + ntaps - 2) // s_rows + 2 <= FIR_MAX_MEANS)


def _fir_scratch(nch: int, k: int, s_rows: int, nbins: int, ntaps: int,
                 device):
    """The FIR launch's output ``[nch, K S, nbins]`` complex64 where
    :func:`deep_fir` holds, else None (the frame kernel's own tap loop)."""
    if not deep_fir(ntaps, s_rows):
        return None
    return torch.empty((nch, k * s_rows, nbins), dtype=torch.complex64,
                       device=device)


def _ptr(t):
    """A tensor's address for a C call, NULL for None."""
    return None if t is None else t.data_ptr()


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
    """(n_groups, frames_per_group) of one block whose CTAs each write
    ``nbl`` rows of partials (the single pass's shared route: its ``nbl +
    2 nch`` rows; 0 where they write none, its wide route): one frame per
    CTA until the block's CTAs reach MAX_GROUPS or its partials
    MAX_PARTIAL_BYTES.
    A launch of K blocks has K times the CTAs and the partials: the
    grouping of a block must not depend on K, or its frames would be
    summed in another order than a one-block launch sums them, and K
    blocks would no longer be K one-block launches bit for bit."""
    cap = (max(1, MAX_PARTIAL_BYTES // (nbl * nbins * 8)) if nbl
           else MAX_GROUPS)
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
    while k > 0 and shared_route_bytes(nbins, nch, ntaps, rank, mean_blocks(
            k, s_rows, ntaps)) > MAX_SHARED_BYTES:
        k = mean_blocks(k, s_rows, ntaps) - 1
    return k


def _layout(route: str, k: int, nch: int, s_rows: int, nbins: int,
            ntaps: int, nbl: int, int8: bool):
    """The single pass's ``(n_groups, per, buffers)`` on ``route``, each
    buffer ``(name, shape, dtype)``: the groups' sample sums, the shared
    route's partials or the wide route's spectra (``scratch``), the parts
    and, where :func:`deep_fir` holds, the FIR's rows."""
    rows = nbl + 2 * nch
    c64 = torch.complex64
    if route == "global":
        n_groups, per = _groups(s_rows, 0, nbins)
        scratch = (k, nch, s_rows, nbins)
    else:
        n_groups, per = _groups(s_rows, rows, nbins)
        scratch = (k, n_groups, rows, nbins)
    buffers = (("sums", (k, n_groups, nch, 2),
                torch.int64 if int8 else torch.float64),
               ("scratch", scratch, c64),
               ("parts", (k, rows, nbins), c64))
    if deep_fir(ntaps, s_rows):
        buffers += (("fir", (nch, k * s_rows, nbins), c64),)
    return n_groups, per, buffers


def max_blocks_parts(s_rows: int, nbins: int, nch: int, nbl: int, *,
                     ntaps: int = 2, rank: int = 0,
                     x_stage: str = "auto") -> int:
    """:func:`max_blocks` for the single-pass kernels, on the X stage
    :func:`x_route` gives, from one block's buffers (:func:`_layout`): the
    shared route's partials hold ``nbl + 2 nch`` rows a CTA (the cross
    power, T and GJ); the wide route's scratch holds every channel's
    spectra of the block (``nch S nbins`` complex64: 64 MiB a block at 8
    channels of 2^20 samples, 256 MiB at 128 channels of 2^18, 1 GiB at
    512) and its groups' sample sums.  Either grows with K under
    MAX_LAUNCH_PARTIAL_BYTES; their shared memory does not.  K nbl is at
    most MAX_BLOCKS too, the bound the epilogue's grid set while its rows
    had only its second axis (31 blocks at 64 channels with autos, 7 at
    128), kept so that no shape's K moves.  Where one block passes either
    bound (LEDA's 512 channels: 131,328 pairs and 1 GiB of spectra) a
    launch takes one block, while its buffers fit MAX_BLOCK_BYTES; 0 where
    they do not.  Every offset the kernels form into a launch's spectra,
    parts and visibilities is 64-bit, so K is not bounded by 2^31
    elements."""
    route = x_route(nbins, ntaps, nch, rank, x_stage)
    layout = _layout(route, 1, nch, s_rows, nbins, ntaps, nbl, False)[2]
    counted = ("scratch", "sums") if route == "global" else ("scratch",)
    per_block = sum(math.prod(shape) * dtype.itemsize
                    for name, shape, dtype in layout if name in counted)
    most = min(MAX_BLOCKS // max(1, nbl),
               MAX_LAUNCH_PARTIAL_BYTES // per_block)
    if most > 0:
        return most
    block = sum(math.prod(shape) * dtype.itemsize
                for _, shape, dtype in layout)
    return int(block <= MAX_BLOCK_BYTES)


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


def _check(x, history, window2d, pairs, svd, multi=False, blocks=True,
           fits=True):
    """The complex64 kernels' checks; ``fits`` False leaves the
    shared-memory bound (:func:`supported`) to the caller."""
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
    if fits and not supported(nbins, ntaps, nch, rank):
        raise ValueError(
            f"the CUDA FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch}, rank={rank} (see "
            "fx_fused.supported)")
    if multi and blocks:
        _check_blocks(x.shape[1], s_rows, nbins, ntaps, nch, rank,
                      pairs.shape[0])
    return rank


def _check_i8(x, history, window2d, pairs, quant_step, svd, multi=False,
              **kw):
    if not isinstance(history, dict) or set(history) != {"tail", "mu_prev"}:
        raise TypeError('history must be {"tail": ..., "mu_prev": ...}')
    return _check_i8_rows(x, history["tail"], window2d, pairs, quant_step,
                          svd, multi, mu_prev=history["mu_prev"], **kw)


def _check_i8_rows(x, tail, window2d, pairs, quant_step, svd, multi=False,
                   blocks=True, mu_prev=None, fits=True):
    """The int8 kernels' checks over the samples and the raw tail, and
    over ``mu_prev`` where the entry takes it (the two-pass ones);
    ``fits`` as for :func:`_check`."""
    if x.dtype != torch.int8 or tail.dtype != torch.int8:
        raise TypeError("x and the tail must be int8")
    if mu_prev is not None and mu_prev.dtype != torch.complex64:
        raise TypeError("mu_prev must be complex64")
    if x.ndim != (5 if multi else 4) or x.shape[-1] != 2:
        form = "[nch, K, S, nbins, 2]" if multi else "[nch, S, nbins, 2]"
        raise ValueError(f"x must be framed int8 {form}, got {x.shape}")
    nch, s_rows, nbins = x.shape[0], x.shape[-3], x.shape[-2]
    ntaps = window2d.shape[0]
    carried = [] if mu_prev is None else [("mu_prev", mu_prev)]
    rank = _check_args(x, window2d, pairs, nbins, [("tail", tail), *carried],
                       svd)
    if tail.shape != (nch, ntaps - 1, nbins, 2):
        raise ValueError(f"tail {tuple(tail.shape)} must be "
                         f"{(nch, ntaps - 1, nbins, 2)}")
    if mu_prev is not None and mu_prev.shape != (nch,):
        raise ValueError(f"mu_prev {tuple(mu_prev.shape)} must be {(nch,)}")
    if x.data_ptr() % 2 or tail.data_ptr() % 2:
        raise ValueError("x and the tail must start on an (I, Q) pair "
                         "(an even address)")
    if not (math.isfinite(quant_step) and quant_step > 0):
        raise ValueError(f"quant_step must be positive, got {quant_step}")
    if fits and not supported_i8(nbins, ntaps, nch, s_rows, rank):
        raise ValueError(
            f"the CUDA int8 FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch}, S={s_rows}, rank={rank} (see "
            "fx_fused.supported_i8)")
    if multi and blocks:
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


def _count(wrapper, rank):
    if rank:
        wrapper.svd_launches += 1
    else:
        wrapper.launches += 1


def _launch(x, history, window2d, pairs, svd, what, merged,
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
    fir = _fir_scratch(nch, k, s_rows, nbins, ntaps, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry, extra = ((lib.fxt_fx_fused, ()) if stage is None
                        else (lib.fxt_fx_ablate, (stage,)))
        rc = entry(
            x.data_ptr(), history.data_ptr(),
            fir_table(window2d, svd).data_ptr(), _ptr(fir), tw.data_ptr(),
            pairs.data_ptr(), sums.data_ptr(),
            partial.data_ptr(), xp.data_ptr(), new_hist.data_ptr(), nch, k,
            s_rows, nbins, ntaps, nbl, n_groups, per, MEAN_PARTS, *extra,
            stream)
    check(lib, rc, what)
    if fir is not None:                 # the entry's FIR launch
        fir_rows.launches += 1
    return xp, new_hist


def _launch_i8(x, history, window2d, pairs, quant_step, svd, what,
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
    fir = _fir_scratch(nch, k, s_rows, nbins, ntaps, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        entry, extra = ((lib.fxt_fx_fused_i8, ()) if stage is None
                        else (lib.fxt_fx_ablate_i8, (stage,)))
        rc = entry(
            x.data_ptr(), history["tail"].data_ptr(),
            history["mu_prev"].data_ptr(),
            fir_table(window2d, svd).data_ptr(), _ptr(fir), tw.data_ptr(),
            pairs.data_ptr(), sums.data_ptr(), partial.data_ptr(),
            xp.data_ptr(), mu.data_ptr(), nch, k, s_rows, nbins, ntaps, nbl,
            n_groups, per, MEAN_PARTS, quant_step, *extra, stream)
    check(lib, rc, what)
    if fir is not None:                 # the entry's FIR launch
        fir_rows.launches += 1
    return xp, mu


def on_card(x, name):
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
    if not on_card(x, "fx_fused_raw"):
        return fx_fused_raw_reference(x, history, window2d, pairs, svd)
    rank = _check(x, history, window2d, pairs, svd)
    out = _launch(x, history, window2d, pairs, svd,
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
    if not on_card(x, "fx_fused_raw_i8"):
        return fx_fused_raw_i8_reference(x, history, window2d, pairs,
                                         quant_step, svd)
    quant_step = float(quant_step)
    rank = _check_i8(x, history, window2d, pairs, quant_step, svd)
    xp, mu = _launch_i8(x, history, window2d, pairs, quant_step, svd,
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
    if not on_card(x, "fx_fused_raw_multi"):
        return fx_fused_raw_multi_reference(x, history, window2d, pairs, svd)
    rank = _check(x, history, window2d, pairs, svd, multi=True)
    out = _launch(x, history, window2d, pairs, svd,
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
    if not on_card(x, "fx_fused_raw_i8_multi"):
        return fx_fused_raw_i8_multi_reference(x, history, window2d, pairs,
                                               quant_step, svd)
    quant_step = float(quant_step)
    rank = _check_i8(x, history, window2d, pairs, quant_step, svd,
                     multi=True)
    xp, mu = _launch_i8(x, history, window2d, pairs, quant_step, svd,
                        "fx_fused_i8_multi kernel launch", merged=True)
    _count(fx_fused_raw_i8_multi, rank)
    return xp, _i8_history(x[:, -1], window2d.shape[0], mu[-1])


fx_fused_raw_i8_multi.launches = 0
fx_fused_raw_i8_multi.svd_launches = 0


def _raw_spectra(rows, hist, x_shape, window2d, svd):
    """The spectra ``[nch, K, S, nbins]`` of the merged raw rows ``[nch,
    K S, nbins]`` behind the raw history ``hist``, by ``torch.fft``."""
    merged = torch.cat([hist, rows], dim=1)
    fir = pfb_fir(merged, window2d) if svd is None else svd_fir(merged, *svd)
    return torch.fft.fft(fir, dim=-1).reshape(x_shape)


def _parts_from_rows(rows, hist, x_shape, window2d, pairs, svd, consts):
    """(xp_raw, T, GJ) of the merged raw rows ``[nch, K S, nbins]`` behind
    the raw history ``hist``, by ``torch.fft``."""
    halo = window2d.shape[0] - 1
    spec = _raw_spectra(rows, hist, x_shape, window2d, svd)
    idx = pairs.to(device=spec.device, dtype=torch.long)
    xp = (spec[idx[:, 0]] * spec[idx[:, 1]].conj()).sum(dim=-2)
    gj = (spec[:, :, :halo] * consts[1].conj()).sum(dim=-2)
    return (xp.permute(1, 0, 2).contiguous(),
            spec.sum(dim=-2).permute(1, 0, 2).contiguous(),
            gj.permute(1, 0, 2).contiguous())


def _parts_consts(consts, window2d, nbins, s_rows, device, svd):
    """``consts``, or the constants of the window the FIR applies formed
    now (a copy to the host: callers on the card pass them in)."""
    if consts is not None:
        return consts
    return dc_constants(window2d.detach().cpu().numpy(), nbins, s_rows,
                        device, svd)


def fx_fused_parts_reference(x: torch.Tensor, history: torch.Tensor,
                             window2d: torch.Tensor, pairs: torch.Tensor,
                             svd=None, consts=None):
    """The single pass in plain torch, same contract as
    :func:`fx_fused_parts`."""
    nch, k, s_rows, nbins = x.shape
    halo = window2d.shape[0] - 1
    consts = _parts_consts(consts, window2d, nbins, s_rows, x.device, svd)
    xp, t, gj = _parts_from_rows(x.reshape(nch, k * s_rows, nbins), history,
                                 x.shape, window2d, pairs, svd, consts)
    mu = x.mean(dim=(-2, -1)).T.contiguous()                  # [K, nch]
    tail = x[:, -1, s_rows - halo:] - mu[-1][:, None, None]
    return xp, t, gj, mu, tail


def fx_fused_parts_i8_reference(x: torch.Tensor, tail: torch.Tensor,
                                window2d: torch.Tensor, pairs: torch.Tensor,
                                quant_step: float, svd=None, consts=None):
    """The single pass over 8-bit samples in plain torch, same contract
    as :func:`fx_fused_parts_i8`."""
    nch, k, s_rows, nbins = x.shape[:4]
    consts = _parts_consts(consts, window2d, nbins, s_rows, x.device, svd)
    rows = dequantize(x, quant_step).reshape(nch, k * s_rows, nbins)
    xp, t, gj = _parts_from_rows(rows, dequantize(tail, quant_step),
                                 x.shape[:4], window2d, pairs, svd, consts)
    mu = torch.stack([block_mean_i8(x[:, j], quant_step) for j in range(k)])
    return xp, t, gj, mu, _i8_history(x[:, -1], window2d.shape[0],
                                      mu[-1])["tail"]


def _wide_from_spectra(spec, pairs, da):
    """(xp_raw, T, GJ) of the spectra ``[nch, K, S, nbins]`` through the
    wide route's X stage (:func:`fx_xstage_reference`)."""
    nbl, nch = pairs.shape[0], spec.shape[0]
    parts = fx_xstage_reference(spec.transpose(0, 1).contiguous(), pairs, da)
    return parts[:, :nbl], parts[:, nbl:nbl + nch], parts[:, nbl + nch:]


def fx_fused_parts_wide_reference(x: torch.Tensor, history: torch.Tensor,
                                  window2d: torch.Tensor, pairs: torch.Tensor,
                                  svd=None, consts=None):
    """The single pass's wide route in plain torch, same contract as
    :func:`fx_fused_parts`: the spectra of the raw rows first, then the X
    stage over them (``ops.fx_xstage.fx_xstage_reference``, autos with no
    imaginary part), as the CUDA route composes them."""
    nch, k, s_rows, nbins = x.shape
    halo = window2d.shape[0] - 1
    consts = _parts_consts(consts, window2d, nbins, s_rows, x.device, svd)
    spec = _raw_spectra(x.reshape(nch, k * s_rows, nbins), history, x.shape,
                        window2d, svd)
    mu = x.mean(dim=(-2, -1)).T.contiguous()                  # [K, nch]
    tail = x[:, -1, s_rows - halo:] - mu[-1][:, None, None]
    return (*_wide_from_spectra(spec, pairs, consts[1]), mu, tail)


def fx_fused_parts_i8_wide_reference(x: torch.Tensor, tail: torch.Tensor,
                                     window2d: torch.Tensor,
                                     pairs: torch.Tensor, quant_step: float,
                                     svd=None, consts=None):
    """The int8 single pass's wide route in plain torch, same contract as
    :func:`fx_fused_parts_i8` (:func:`fx_fused_parts_wide_reference`'s
    composition)."""
    nch, k, s_rows, nbins = x.shape[:4]
    consts = _parts_consts(consts, window2d, nbins, s_rows, x.device, svd)
    rows = dequantize(x, quant_step).reshape(nch, k * s_rows, nbins)
    spec = _raw_spectra(rows, dequantize(tail, quant_step), x.shape[:4],
                        window2d, svd)
    mu = torch.stack([block_mean_i8(x[:, j], quant_step) for j in range(k)])
    return (*_wide_from_spectra(spec, pairs, consts[1]), mu,
            _i8_history(x[:, -1], window2d.shape[0], mu[-1])["tail"])


@functools.lru_cache(maxsize=64)
def _shape_plan(nch: int, k: int, s_rows: int, nbins: int, ntaps: int,
                nbl: int, rank: int, int8: bool, x_stage: str):
    """What :func:`plan_parts` decides from the shape alone: ``(route,
    n_groups, per, xplan, buffers)``, or ValueError."""
    if not supported_parts(nbins, ntaps, nch, s_rows, rank):
        raise ValueError(
            f"the single-pass FX kernel does not take nbins={nbins}, "
            f"ntaps={ntaps}, nch={nch}, S={s_rows}, rank={rank} (see "
            "fx_fused.supported_parts)")
    route = x_route(nbins, ntaps, nch, rank, x_stage)
    most = max_blocks_parts(s_rows, nbins, nch, nbl, ntaps=ntaps, rank=rank,
                            x_stage=route)
    if not 1 <= k <= most:
        raise ValueError(
            f"{k} blocks of S={s_rows} per launch: the single-pass kernel "
            f"takes 1 to {most} at this shape on its {route} X stage "
            "(fx_fused.max_blocks_parts)")
    n_groups, per, buffers = _layout(route, k, nch, s_rows, nbins, ntaps,
                                     nbl, int8)
    xplan = (xstage_plan(nch, nbl, s_rows, nbins, k) if route == "global"
             else None)
    return route, n_groups, per, xplan, buffers


@dataclasses.dataclass
class PartsPlan:
    """One launch of the single pass (:func:`plan_parts`): the checked
    tensors as the kernels read them, the route and the launch's shape,
    the frame groups, the X kernel's plan and row map (wide route), whether
    the FIR is a launch of its own and the buffers the kernels write."""
    x: torch.Tensor
    hist: torch.Tensor                  # the corrected tail, or the raw tail
    window2d: torch.Tensor
    svd: Optional[tuple]
    pairs: torch.Tensor
    consts: tuple
    quant_step: Optional[float]         # None: complex64 samples
    table: torch.Tensor                 # fir_table(window2d, svd)
    tw: torch.Tensor                    # the FFT's twiddles
    route: str                          # "shared" or "global" (the wide one)
    rank: int
    k: int
    nch: int
    s_rows: int
    nbins: int
    ntaps: int
    nbl: int
    n_groups: int
    per: int                            # frames a group
    xplan: Optional[XStagePlan]
    rowmap: Optional[torch.Tensor]      # the tiled X instance's row map
    fir: bool                           # deep_fir: the FIR launches alone
    buffers: tuple                      # (name, shape, dtype): _layout's


def plan_parts(x, history, window2d, pairs, svd, consts, quant_step=None,
               x_stage="auto") -> PartsPlan:
    """The single pass's launch over ``x`` behind ``history`` (the
    arguments of :func:`fx_fused_parts`, or with ``quant_step`` of
    :func:`fx_fused_parts_i8`), for the wrappers and the engine's step:
    the two-pass kernels' checks (their shared-memory bound only on the
    shared route), dA, S >= ntaps-1 and the route's K-block bound, then
    the route, groups, X plan, row map and buffers."""
    if quant_step is not None:
        rank = _check_i8_rows(x, history, window2d, pairs, quant_step, svd,
                              multi=True, blocks=False, fits=False)
    else:
        rank = _check(x, history, window2d, pairs, svd, multi=True,
                      blocks=False, fits=False)
    nch, k, s_rows, nbins = x.shape[:4]
    ntaps, nbl = window2d.shape[0], pairs.shape[0]
    route, n_groups, per, xplan, buffers = _shape_plan(
        nch, k, s_rows, nbins, ntaps, nbl, rank, quant_step is not None,
        x_stage)
    da = consts[1]
    if (da.dtype != torch.complex64 or da.device != x.device
            or da.shape != (ntaps - 1, nbins) or not da.is_contiguous()):
        raise ValueError(
            f"consts must be dc_posthoc.dc_constants on {x.device}: dA "
            f"{tuple(da.shape)} {da.dtype} on {da.device}, expected "
            f"{(ntaps - 1, nbins)} complex64")
    rowmap = row_map(pairs, nch) if xplan is not None and xplan.tiled else None
    return PartsPlan(x, history, window2d, svd, pairs, consts, quant_step,
                     fir_table(window2d, svd), _twiddles(nbins, x.device),
                     route, rank, k, nch, s_rows, nbins, ntaps, nbl,
                     n_groups, per, xplan, rowmap, deep_fir(ntaps, s_rows),
                     buffers)


def parts_buffers(plan: PartsPlan, pool=None) -> dict:
    """``plan.buffers``, ``pool``'s (a dict the caller keeps, keyed with
    the current stream, whose kernels run in order: the next launch writes
    the scratch only after this one has read it) or new where ``pool`` is
    None, and ``mu`` and ``new_hist``, new (they outlive the launch)."""
    dev = plan.x.device
    stream = (None if pool is None
              else torch.cuda.current_stream(dev).cuda_stream)
    bufs = {}
    for name, shape, dtype in plan.buffers:
        key = (name, shape, dtype, stream)
        t = None if pool is None else pool.get(key)
        if t is None:
            t = torch.empty(shape, dtype=dtype, device=dev)
            if pool is not None:
                pool[key] = t
        bufs[name] = t
    bufs["mu"] = torch.empty((plan.k, plan.nch), dtype=torch.complex64,
                             device=dev)
    bufs["new_hist"] = torch.empty_like(plan.hist)
    return bufs


def count_launches(plan: PartsPlan, count_finish=None):
    """Count each kernel a launch over ``plan`` made on its wrapper's
    counter: the frame kernel on ``fx_fused_parts[_i8]``'s by route and
    FIR mode, the FIR on :func:`fir_rows`', the reduce on
    :func:`parts_reduce`' or the X kernel on ``fx_xstage``'s, and where
    the launch also ran the epilogue (a step's; ``plan`` is then its
    ``fx_epilogue.StepPlan``), on the epilogue's wrapper's by
    ``count_finish(plan.finish_plan)`` (``fx_epilogue.count_finish``)."""
    wrapper = fx_fused_parts if plan.quant_step is None else (
        fx_fused_parts_i8)
    wide = plan.route == "global"
    attr = ("wide_" if wide else "") + (
        "svd_launches" if plan.rank else "launches")
    setattr(wrapper, attr, getattr(wrapper, attr) + 1)
    if plan.fir:
        fir_rows.launches += 1
    if wide:
        count_launch(plan.xplan, plan.nbins, plan.k)
    else:
        parts_reduce.launches += 1
    if count_finish is not None:
        count_finish(plan.finish_plan)


def launch_parts(plan: PartsPlan, bufs: dict):
    """The single pass over a plan and its buffers on the current stream
    -> ``(xp_raw, T, GJ, mu, new history)``, views of ``bufs``: the frame
    kernel (at deep taps behind the FIR launch), then on the shared route
    the reduce, which its entry launches, on the wide route the X kernel,
    a launch of its own that also forms mu and the new history
    (``fx_xstage.xstage_launch``)."""
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    p = plan
    int8 = p.quant_step is not None
    extra = (p.quant_step,) if int8 else ()
    sums, scratch, parts, mu, new_hist = (bufs[name].data_ptr() for name in (
        "sums", "scratch", "parts", "mu", "new_hist"))
    head = (p.x.data_ptr(), p.hist.data_ptr(), p.table.data_ptr(),
            _ptr(bufs.get("fir")), p.tw.data_ptr())
    what = "fx_parts_i8 kernel launch" if int8 else "fx_parts kernel launch"
    with torch.cuda.device(p.x.device):
        stream = torch.cuda.current_stream(p.x.device).cuda_stream
        if p.route == "global":
            entry = lib.fxt_fx_wide_frames_i8 if int8 else (
                lib.fxt_fx_wide_frames)
            rc = entry(*head, sums, scratch, p.nch, p.k, p.s_rows, p.nbins,
                       p.ntaps, p.n_groups, p.per, *extra, stream)
        else:
            entry = lib.fxt_fx_parts_i8 if int8 else lib.fxt_fx_parts
            rc = entry(*head, p.pairs.data_ptr(), p.consts[1].data_ptr(),
                       sums, scratch, parts, mu, new_hist, p.nch, p.k,
                       p.s_rows, p.nbins, p.ntaps, p.nbl, p.n_groups, p.per,
                       *extra, stream)
    check(lib, rc, what)
    if p.route == "global":
        xstage_launch(p.xplan, p.rowmap, bufs["scratch"], p.pairs,
                      p.consts[1], bufs["parts"], x=p.x, sums=bufs["sums"],
                      mu=bufs["mu"], new_hist=bufs["new_hist"],
                      n_groups=p.n_groups, quant_step=p.quant_step)
    count_launches(plan)
    nbl, nch, out = p.nbl, p.nch, bufs["parts"]
    return (out[:, :nbl], out[:, nbl:nbl + nch], out[:, nbl + nch:],
            bufs["mu"], bufs["new_hist"])


def fir_rows_reference(x: torch.Tensor, history: torch.Tensor,
                       table: torch.Tensor, quant_step=None) -> torch.Tensor:
    """The deep-tap FIR in plain torch, same contract as :func:`fir_rows`:
    ``ops.pfb.pfb_fir`` over the merged raw rows ``[history; x]``."""
    if quant_step is not None:
        x, history = (dequantize(x, quant_step),
                      dequantize(history, quant_step))
    nch, k, s_rows, nbins = x.shape
    merged = torch.cat([history, x.reshape(nch, k * s_rows, nbins)], dim=1)
    return pfb_fir(merged, table)


def fir_rows(x: torch.Tensor, history: torch.Tensor, table: torch.Tensor,
             quant_step=None) -> torch.Tensor:
    """The single pass's FIR at deep taps alone: the merged raw rows of
    ``x [nch, K, S, nbins]`` complex64 behind the corrected tail
    ``history [nch, ntaps-1, nbins]`` (or int8 ``x [nch, K, S, nbins, 2]``
    behind the raw tail, each sample times ``quant_step``) through the FIR
    table ``table [ntaps, nbins]`` float32 (:func:`fir_table`) -> ``[nch, K
    S, nbins]`` complex64, row g the FIR output of frame g (``sum_t
    table[t] row[g + t]`` in tap order).  It is what the deep-tap steps
    (:func:`deep_fir`) launch before their frame kernel.

    CPU tensors run :func:`fir_rows_reference`; CUDA tensors launch
    ``fir_rows_kernel`` (``fxt_fir_rows`` / ``_i8``) or raise.  Each launch
    adds one to ``fir_rows.launches``: this call's and those of every
    deep-tap step."""
    if not on_card(x, "fir_rows"):
        return fir_rows_reference(x, history, table, quant_step)
    from fxtpu_torch.cuda_build import check, load_kernels
    int8 = quant_step is not None
    want = (torch.int8, 5) if int8 else (torch.complex64, 4)
    if (x.dtype, x.ndim) != want or history.dtype != x.dtype:
        raise ValueError(f"x {x.dtype} {tuple(x.shape)} and history "
                         f"{history.dtype} must be {want[0]} with x "
                         f"[nch, K, S, nbins{', 2' if int8 else ''}]")
    nch, k, s_rows, nbins = x.shape[:4]
    ntaps = table.shape[0]
    if (table.dtype != torch.float32 or table.shape != (ntaps, nbins)
            or history.shape[:3] != (nch, ntaps - 1, nbins)
            or nbins % 128 or ntaps < 2 or k * s_rows > 16 * 65535
            or not deep_fir(ntaps, s_rows)):
        raise ValueError(
            f"fir_rows takes x [nch, K, S, nbins] with nbins a multiple of "
            f"128, history [nch, ntaps-1, nbins] and a float32 table "
            f"[ntaps, nbins] where fx_fused.deep_fir holds; got x "
            f"{tuple(x.shape)}, history {tuple(history.shape)}, table "
            f"{tuple(table.shape)} {table.dtype}")
    for name, t in (("history", history), ("table", table)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("history", history), ("table", table)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lib = load_kernels()
    out = torch.empty((nch, k * s_rows, nbins), dtype=torch.complex64,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if int8:
            rc = lib.fxt_fir_rows_i8(x.data_ptr(), history.data_ptr(),
                                     table.data_ptr(), out.data_ptr(), nch, k,
                                     s_rows, nbins, ntaps, float(quant_step),
                                     stream)
        else:
            rc = lib.fxt_fir_rows(x.data_ptr(), history.data_ptr(),
                                  table.data_ptr(), out.data_ptr(), nch, k,
                                  s_rows, nbins, ntaps, stream)
    check(lib, rc, "fir_rows kernel launch")
    fir_rows.launches += 1
    return out


fir_rows.launches = 0


def _reduce_shape(partial, sums, x, n_gj, halo, int8):
    """Check the reduce's operands (CUDA tensors) -> (K, n_groups, nbl,
    nch, S, nbins)."""
    if partial.dtype != torch.complex64 or partial.ndim != 4:
        raise TypeError("partial must be complex64 [K, n_groups, rows, nbins]")
    k, n_groups, rows, nbins = partial.shape
    want = (torch.int8, 5) if int8 else (torch.complex64, 4)
    if (x.dtype, x.ndim) != want or x.shape[1] != k:
        raise ValueError(f"x {tuple(x.shape)} {x.dtype} must be the step's "
                         f"samples [nch, {k}, S, {nbins}]"
                         + (", 2] int8" if int8 else "] complex64"))
    nch, _, s_rows = x.shape[:3]
    nbl = rows - 2 * nch
    if (x.shape[3] != nbins or nbl < 0
            or sums.dtype != (torch.int64 if int8 else torch.float64)
            or tuple(sums.shape) != (k, n_groups, nch, 2)):
        raise ValueError(
            f"partial {tuple(partial.shape)}, sums {tuple(sums.shape)} "
            f"{sums.dtype} and x {tuple(x.shape)} do not match")
    if not (1 <= n_gj <= n_groups and 1 <= halo <= s_rows
            and 1 <= k <= MAX_BLOCKS):
        raise ValueError(f"n_gj={n_gj} must be in [1, {n_groups}] and "
                         f"halo={halo} in [1, {s_rows}], K={k} in [1, "
                         f"{MAX_BLOCKS}]")
    for name, t in (("sums", sums), ("x", x)):
        if t.device != partial.device:
            raise ValueError(f"{name} is on {t.device}, partial on "
                             f"{partial.device}")
    for name, t in (("partial", partial), ("sums", sums), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return k, n_groups, nbl, nch, s_rows, nbins


def parts_reduce_reference(partial: torch.Tensor, sums: torch.Tensor,
                           x: torch.Tensor, n_gj: int, halo: int,
                           quant_step=None):
    """The reduce in plain torch, same contract as :func:`parts_reduce`:
    an explicit loop over the groups in order (``acc = p[0]; acc = acc +
    p[g]``) and over the sample sums, so it makes the kernel's float32 and
    double additions and the two agree bit for bit."""
    nch, k, s_rows = x.shape[:3]
    full = partial.shape[2] - nch           # xp and T, then GJ
    parts = partial[:, 0].clone()
    acc = sums[:, 0].clone()
    for g in range(1, partial.shape[1]):
        parts[:, :full] += partial[:, g, :full]
        if g < n_gj:
            parts[:, full:] += partial[:, g, full:]
        acc += sums[:, g]
    step = 1.0 if quant_step is None else float(quant_step)
    mean = (acc.double() / (s_rows * x.shape[3]) * step).float()
    mu = torch.complex(mean[..., 0], mean[..., 1])
    last = x[:, k - 1, s_rows - halo:]
    new_hist = last.clone() if quant_step is not None else (
        last - mu[k - 1][:, None, None])
    return parts, mu, new_hist


def parts_reduce(partial: torch.Tensor, sums: torch.Tensor, x: torch.Tensor,
                 n_gj: int, halo: int, quant_step=None):
    """The single pass's reduce alone: the frame kernel's per-group
    partials ``partial [K, n_groups, nbl + 2 nch, nbins]`` complex64 and
    sample sums ``sums [K, n_groups, nch, 2]`` (float64; int64 for 8-bit
    samples) of the step's samples ``x [nch, K, S, nbins]`` complex64 (or
    int8 ``[nch, K, S, nbins, 2]`` with ``quant_step``) -> ``(parts [K,
    nbl + 2 nch, nbins], mu [K, nch], new_hist)``: every row of parts
    summed over the groups in group order, g = 0 first, in float32, the GJ
    rows (the last nch) over the first ``n_gj`` groups only; mu the block
    means from the sums (double, rounded once; times ``quant_step`` for
    8-bit samples); ``new_hist [nch, halo, nbins]`` the last block's last
    ``halo`` rows, complex64 minus its mean, int8 as they arrived.

    CPU tensors run :func:`parts_reduce_reference`; CUDA tensors launch
    the reduce kernel (``fxt_parts_reduce`` / ``_i8``, the second kernel
    of :func:`fx_fused_parts`' shared route) or raise.  Each launch of the
    kernel adds one to ``parts_reduce.launches``: this call's and those of
    the single pass's shared route."""
    if partial.device.type == "cpu":
        return parts_reduce_reference(partial, sums, x, n_gj, halo,
                                      quant_step)
    if partial.device.type != "cuda":
        raise ValueError(f"parts_reduce runs on cuda or cpu, not "
                         f"{partial.device}")
    from fxtpu_torch.cuda_build import check, load_kernels
    int8 = quant_step is not None
    k, n_groups, nbl, nch, s_rows, nbins = _reduce_shape(
        partial, sums, x, n_gj, halo, int8)
    lib = load_kernels()
    dev = partial.device
    parts = torch.empty((k, nbl + 2 * nch, nbins), dtype=torch.complex64,
                        device=dev)
    mu = torch.empty((k, nch), dtype=torch.complex64, device=dev)
    new_hist = torch.empty((nch, halo, *x.shape[3:]), dtype=x.dtype,
                           device=dev)
    entry = lib.fxt_parts_reduce_i8 if int8 else lib.fxt_parts_reduce
    extra = (float(quant_step),) if int8 else ()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(partial.data_ptr(), sums.data_ptr(), x.data_ptr(),
                   parts.data_ptr(), mu.data_ptr(), new_hist.data_ptr(), nch,
                   k, s_rows, nbins, nbl, halo, n_groups, n_gj, *extra,
                   stream)
    check(lib, rc, "parts_reduce kernel launch")
    parts_reduce.launches += 1
    return parts, mu, new_hist


parts_reduce.launches = 0


def _cpu_route(x, window2d, svd, x_stage):
    """The X stage a CPU call's plain version follows: the one the card
    takes at this shape (:func:`x_route`)."""
    rank = 0 if svd is None else svd[0].shape[-1]
    ntaps, nbins = window2d.shape
    return x_route(nbins, ntaps, x.shape[0], rank, x_stage)


def fx_fused_parts(x: torch.Tensor, history: torch.Tensor,
                   window2d: torch.Tensor, pairs: torch.Tensor, svd=None,
                   consts=None, *, x_stage: str = "auto"):
    """The single-pass fused step over the K blocks of the merged ``x
    [nch, K, S, nbins]`` complex64 (one block: ``x[:, None]``) ->
    ``(xp_raw [K, nbl, nbins], T [K, nch, nbins], GJ [K, nch, nbins], mu
    [K, nch], tail [nch, ntaps-1, nbins])`` (``fxtpu``'s
    ``fx_pallas_parts``): the spectra are those of the FIR over ``[history;
    x]`` as they are, ``history`` being the DC-corrected tail the stream
    carries; ``xp_raw`` is their frame-summed cross power per block, ``T``
    their sum over the block's frames, ``GJ`` the block's first ntaps-1
    frames contracted with ``conj(dA)``, ``mu`` the block's sample mean
    and ``tail`` the last block's last rows minus its mean, the next
    call's history.  ``consts`` are ``dc_posthoc.dc_constants`` of the
    window for ``S`` on ``x``'s device (formed here when None, through
    the host); ``dc_posthoc.dc_correct(xp_raw, T, GJ, mu, pairs, consts,
    block_mu_prev(mu))`` is the corrected cross power.  S >= ntaps-1.
    ``x_stage`` (:data:`X_STAGES`) picks the X stage: every channel's
    spectrum of a frame in shared memory, or (the wide route, where they
    do not fit or where a caller forces it) the spectra through device
    memory to the X kernel; the contract is the same (:func:`x_route`).

    CPU tensors run :func:`fx_fused_parts_reference`, or on the wide route
    :func:`fx_fused_parts_wide_reference`; CUDA tensors launch the kernels
    (frames, then the reduce or the X kernel; no mean pre-pass) or raise.
    Each call adds one to ``fx_fused_parts.launches`` (direct) or
    ``fx_fused_parts.svd_launches``, on the wide route to
    ``fx_fused_parts.wide_launches`` or ``.wide_svd_launches`` (its frame
    kernel) and to ``fx_xstage.launches`` (its X kernel)."""
    if not on_card(x, "fx_fused_parts"):
        if _cpu_route(x, window2d, svd, x_stage) == "global":
            return fx_fused_parts_wide_reference(x, history, window2d, pairs,
                                                 svd, consts)
        return fx_fused_parts_reference(x, history, window2d, pairs, svd,
                                        consts)
    consts = _parts_consts(consts, window2d, x.shape[-1], x.shape[-2],
                           x.device, svd)
    plan = plan_parts(x, history, window2d, pairs, svd, consts,
                      x_stage=x_stage)
    return launch_parts(plan, parts_buffers(plan))


fx_fused_parts.launches = 0
fx_fused_parts.svd_launches = 0
fx_fused_parts.wide_launches = 0
fx_fused_parts.wide_svd_launches = 0


def fx_fused_parts_i8(x: torch.Tensor, tail: torch.Tensor,
                      window2d: torch.Tensor, pairs: torch.Tensor,
                      quant_step: float, svd=None, consts=None, *,
                      x_stage: str = "auto"):
    """The single-pass fused step over the K blocks of the merged 8-bit
    ``x [nch, K, S, nbins, 2]`` -> ``(xp_raw, T, GJ, mu, new_tail)`` as
    :func:`fx_fused_parts` returns them, in real units (each sample times
    ``quant_step``), over ``[tail; x]`` with ``tail`` the stream's raw
    tail int8 ``[nch, ntaps-1, nbins, 2]``; ``mu`` is exact (an integer
    sum).  ``new_tail`` is a copy of the last block's last rows as they
    arrived, the next call's ``tail`` (``fx_pallas_parts`` leaves that
    slice to its caller; here the reduce kernel writes it, so a step
    needs no launch of its own for it).  Correct with ``dc_correct(...,
    mu_prev=block_mu_prev(mu, carried mu_prev))``.  ``x_stage`` as for
    :func:`fx_fused_parts`.

    CPU tensors run :func:`fx_fused_parts_i8_reference`, or on the wide
    route :func:`fx_fused_parts_i8_wide_reference`; CUDA tensors launch
    the kernels or raise.  Each call adds one to
    ``fx_fused_parts_i8.launches`` (direct) or ``.svd_launches``, on the
    wide route to ``.wide_launches`` or ``.wide_svd_launches`` and to
    ``fx_xstage.launches``."""
    if not on_card(x, "fx_fused_parts_i8"):
        if _cpu_route(x, window2d, svd, x_stage) == "global":
            return fx_fused_parts_i8_wide_reference(
                x, tail, window2d, pairs, quant_step, svd, consts)
        return fx_fused_parts_i8_reference(x, tail, window2d, pairs,
                                           quant_step, svd, consts)
    consts = _parts_consts(consts, window2d, x.shape[-2], x.shape[-3],
                           x.device, svd)
    plan = plan_parts(x, tail, window2d, pairs, svd, consts,
                      float(quant_step), x_stage)
    return launch_parts(plan, parts_buffers(plan))


fx_fused_parts_i8.launches = 0
fx_fused_parts_i8.svd_launches = 0
fx_fused_parts_i8.wide_launches = 0
fx_fused_parts_i8.wide_svd_launches = 0


def stockham_stages(x: torch.Tensor, nstages: int) -> torch.Tensor:
    """The first ``nstages`` radix-2 Stockham stages over the last axis of
    complex ``x`` (a power of two long), by tensor indexing, with the
    index arithmetic of the probes' radix-2 FFT body (``csrc/probes.cu``:
    ``b[d]``, ``b[d + ns]``; the overlap and layout probes compare with
    it).  All ``log2(n)`` stages give the DFT in natural order."""
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


def _stockham_radices(n: int) -> tuple:
    """The passes of ``fft_mixed``'s Stockham sequence over n = 2^a q
    points (q odd, 2^a >= 64): radix 16 while 16 divides 2^a, then the
    rest of 2^a (2, 4 or 8) and each odd prime factor of q, smallest
    first, the largest last (``fft_stockham``)."""
    p2 = n & -n
    radices = []
    while p2 % 16 == 0:
        radices.append(16)
        p2 //= 16
    if p2 > 1:
        radices.append(p2)
    q, f = n // (n & -n), 3
    while q > 1:
        while q % f == 0:
            radices.append(f)
            q //= f
        f += 2
    return tuple(radices)


def fft_radices(n: int) -> tuple:
    """The radices of the frame kernel's FFT passes over ``n`` points, in
    the order they run (``csrc/fx_fused.cu``), for every n
    :func:`kernel_bins` takes: at a power of two in [256, 8192] 16 and 16,
    then one pass of radix ``n / 256`` (``fft_sized``); at any other n up
    to :data:`FFT_MAX_SUB` the Stockham sequence of ``fft_mixed`` (radix 16
    while 16 divides the power of two, then the rest of it and the odd
    prime factors); above it the sequence of ``n / 2`` points, run over
    each half of the slot, and a last radix-2 pass that combines the
    halves."""
    if not kernel_bins(n):
        raise ValueError(f"the frame kernel's FFT takes n = 128 m points, "
                         f"2 <= m <= 128 (256 to 16384), not {n}")
    if _pow2_bins(n):
        return (16, 16) if n == 256 else (16, 16, n >> 8)
    if n > FFT_MAX_SUB:
        return (*_stockham_radices(n // 2), 2)
    return _stockham_radices(n)


def _fft_swizzle(idx: torch.Tensor) -> torch.Tensor:
    """Where pass 0 stores, and pass 1 loads, logical point ``idx`` in the
    kernel's slot (``L ^ ((L >> 4) & 15)``: keeps both off one bank)."""
    return idx ^ ((idx >> 4) & 15)


def _prime_dft(v: torch.Tensor, tw: torch.Tensor, root: int) -> torch.Tensor:
    """The pure p-point DFT over the last axis of ``v`` (p odd, ``v`` its
    pre-twiddled inputs) as ``fft_pass_prime_last`` forms it: ``u_s = x_s +
    x_{p-s}``, ``v_s = x_s - x_{p-s}`` for ``1 <= s <= H = (p - 1) / 2``,
    ``A_r = sum_s cos(2 pi r s / p) u_s``, ``B_r = sum_s sin(2 pi r s / p)
    v_s``, ``y_0 = x_0 + sum_s u_s``, ``y_r = x_0 + A_r - i B_r`` and
    ``y_{p-r} = x_0 + A_r + i B_r``; the root of ``m = r s mod p`` read at
    ``min(m, p - m) root`` in the FFT's table ``tw`` (the sine negated for
    ``m > H``)."""
    p = v.shape[-1]
    h = (p - 1) // 2
    s = torch.arange(1, h + 1, device=v.device)
    x0 = v[..., 0]
    u = v[..., s] + v[..., p - s]
    w = v[..., s] - v[..., p - s]
    m = (s[:, None] * s[None, :]) % p                         # [r, s]
    hi = m > h
    t = tw[torch.where(hi, p - m, m) * root]
    cs, sn = t.real, torch.where(hi, t.imag, -t.imag)
    a = (cs * u[..., None, :]).sum(dim=-1)                    # [..., r]
    b = (sn * w[..., None, :]).sum(dim=-1)
    e = x0[..., None] + a
    out = torch.empty_like(v)
    out[..., 0] = x0 + u.sum(dim=-1)
    out[..., s] = e - 1j * b
    out[..., p - s] = e + 1j * b
    return out


def _stockham_pass(a: torch.Tensor, radices: tuple, p: int,
                   tw: torch.Tensor, kind: str) -> torch.Tensor:
    """Pass ``p`` of the Stockham sequence ``radices`` over the last axis
    of ``a`` (N points), its twiddles ``exp(-2 pi i e / N)`` read at ``e
    n / N`` in ``tw``, the table of n points (``_twiddles``); ``kind``:
    ``"direct"`` a direct DFT (``fft_pass_direct``), ``"prime"`` the input
    twiddles and then :func:`_prime_dft` (the last odd prime's pass,
    ``fft_pass_prime_last``), ``"fft"`` the input twiddles and then the
    R-point DFT (the register passes)."""
    n_pts = a.shape[-1]
    half = tw.shape[0]
    ts = 2 * half // n_pts
    radix = radices[p]
    ns = math.prod(radices[:p])
    nb = n_pts // radix
    j = torch.arange(nb, device=a.device)[:, None]
    r = torch.arange(radix, device=a.device)[None, :]
    load = j + r * nb
    # pass 0 stores through the swizzle, and pass 1 loads so, where pass 1
    # is a radix-16 pass
    swz = len(radices) > 1 and radices[1] == 16
    if p == 1 and swz:
        load = _fft_swizzle(load)
    v = a[..., load]                                       # [..., nb, R]
    k = j % ns

    def twiddle(m):
        t = tw[torch.where(m < half, m, m - half)]
        return torch.where(m >= half, -t, t)

    d = n_pts // (ns * radix) * ts
    if kind == "direct":
        # fft_pass_direct: output r is the direct R-point DFT with the
        # input twiddles folded in, exponent s (k + r Ns) d mod n for input s
        s_in = torch.arange(radix, device=a.device)
        m = ((k + r * ns) * d)[..., None] * s_in % (2 * half)  # [nb, R, R]
        v = (v[..., None, :] * twiddle(m)).sum(dim=-1)
    else:
        if ns > 1:
            v = v * twiddle(r * k * d)
        v = (_prime_dft(v, tw, nb * ts) if kind == "prime"
             else torch.fft.fft(v, dim=-1))
    store = (j - k) * radix + k + r * ns
    if p == 0 and swz:
        store = _fft_swizzle(store)
    b = torch.empty_like(a)
    b[..., store.reshape(-1)] = v.reshape(*v.shape[:-2], n_pts)
    return b


def fft_slot(y: torch.Tensor) -> torch.Tensor:
    """A frame's FIR output ``y`` (last axis, n bins) as the frame kernel
    stores it for its FFT (``fft_slot`` in ``csrc/fx_fused.cu``): as it is
    up to :data:`FFT_MAX_SUB` bins, above that the even bins in the first
    half and the odd ones in the second, where :func:`fft_passes` takes
    the slot before pass 0."""
    if y.shape[-1] <= FFT_MAX_SUB:
        return y
    return torch.cat([y[..., 0::2], y[..., 1::2]], dim=-1)


def fft_passes(x: torch.Tensor, stop: int, start: int = 0) -> torch.Tensor:
    """Passes ``start`` .. ``stop - 1`` of the frame kernel's in-place
    Stockham FFT (:func:`fft_radices`) over the last axis of complex ``x``,
    by tensor indexing with the kernel's own index arithmetic: butterfly j
    of a radix-R pass loads points ``j + r n / R``, multiplies point r by
    ``exp(-2 pi i r k / (Ns R))`` (k = j mod Ns, Ns the product of the
    radices before it; :func:`_twiddles`' table and its negation), takes
    the R-point DFT (in ``fft_mixed`` the last pass's odd prime as the
    kernel's ``fft_pass_prime_last`` forms it, :func:`_prime_dft`, and an
    odd prime before it as ``fft_pass_direct`` takes it: a direct sum over
    the inputs with each twiddle folded into one exponent) and stores
    output r
    at ``(j - k) R + k + r Ns``.  ``x`` and the result are the slot as the
    kernel leaves it after ``start`` and ``stop`` passes: after pass 0 in
    the swizzled order pass 1 reads (:func:`_fft_swizzle`; where pass 1 is
    a radix-16 pass, as it is at every power of two), after the last pass
    the DFT in natural order.  Above :data:`FFT_MAX_SUB` points the slot
    before pass 0 holds the FIR's output even samples first, odd ones
    after (:func:`fft_slot`); each pass but the last runs on both halves
    of the slot, the last combines them."""
    n = x.shape[-1]
    radices = fft_radices(n)
    if not 0 <= start <= stop <= len(radices):
        raise ValueError(f"passes {start} .. {stop} of {len(radices)}")
    tw = _twiddles(n, x.device)
    seq = radices[:-1] if n > FFT_MAX_SUB else radices
    # the sequence's last pass, where its radix is an odd prime, runs as
    # fft_pass_prime_last, any odd prime before it as a direct DFT
    kind = [("fft" if _pow2_bins(n) or r % 2 == 0 else
             "prime" if p == len(seq) - 1 else "direct")
            for p, r in enumerate(seq)]
    a = x
    if n <= FFT_MAX_SUB:
        for p in range(start, stop):
            a = _stockham_pass(a, radices, p, tw, kind[p])
        return a
    h = n // 2
    for p in range(start, stop):
        if p == len(radices) - 1:
            e, o = a[..., :h], a[..., h:] * tw
            a = torch.cat([e + o, e - o], dim=-1)
        else:
            a = torch.cat([_stockham_pass(a[..., :h], radices, p, tw,
                                          kind[p]),
                           _stockham_pass(a[..., h:], radices, p, tw,
                                          kind[p])], dim=-1)
    return a


def fx_fused_ablate_reference(x: torch.Tensor, history, window2d: torch.Tensor,
                              pairs: torch.Tensor, stage: str,
                              quant_step=None, svd=None) -> torch.Tensor:
    """The truncated step in plain torch, same contract as
    :func:`fx_fused_ablate`: the merged rows ``[history; x]`` (each block
    losing its own mean, 8-bit samples dequantized; ``"load_raw"``: as they
    arrived), the stage's share of FIR and FFT passes (the FIR's output in
    its slot order, :func:`fft_slot`; :func:`fft_passes`: ``"fft_half"``
    the first ``floor(passes / 2)``, the slot as the kernel leaves it),
    then the cross power of every pair summed over each block's frames."""
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
    else:
        # the FIR stores its output where the FFT wants it (fft_slot)
        y = fft_slot(pfb_fir(merged, window2d) if svd is None
                     else svd_fir(merged, *svd))
    passes = len(fft_radices(nbins))
    if stage == "fft_half":
        y = fft_passes(y, passes // 2)
    elif stage == "fft":
        y = fft_passes(y, passes)
    y = y.reshape(nch, k, s_rows, nbins)
    if stage == "fft":
        # frames first, then channels: each block's sum is formed alike
        return y[..., :FFT_STAGE_BINS].sum(dim=2).sum(dim=0)[:, None, :]
    idx = pairs.to(device=y.device, dtype=torch.long)
    xp = (y[idx[:, 0]] * y[idx[:, 1]].conj()).sum(dim=-2)   # [nbl, K, nbins]
    return xp.permute(1, 0, 2).contiguous()


def _check_ablate(x, window2d, pairs, rank):
    """The ablation's launch, which the shared route's rule does not
    bound (it times the frame kernel, and the FFT, at every bin count
    :func:`kernel_bins` takes, 16,256 included): its shared memory
    (:func:`frame_shared_bytes` of a cluster's CTA and the K blocks'
    means), its grid and its partials within the card's and the
    launch's limits, and a block of at least ntaps-1 rows for 8-bit
    samples (:func:`supported_i8`)."""
    nch, k, s_rows = x.shape[:3]
    ntaps, nbins = window2d.shape
    nbl = pairs.shape[0]
    partial = k * _groups(s_rows, nbl, nbins)[0] * nbl * nbins * 8
    if not (kernel_bins(nbins) and ntaps >= 2 and 1 <= k <= MAX_BLOCKS
            and partial <= MAX_LAUNCH_PARTIAL_BYTES
            and (x.dtype != torch.int8 or s_rows >= ntaps - 1)
            and frame_shared_bytes(nbins, nch, mean_blocks(
                k, s_rows, ntaps)) <= MAX_SHARED_BYTES):
        raise ValueError(
            f"the stage ablation does not take nbins={nbins}, ntaps={ntaps}, "
            f"nch={nch}, K={k}, S={s_rows}, rank={rank} (fx_fused."
            "_check_ablate)")


def fx_fused_ablate(x: torch.Tensor, history, window2d: torch.Tensor,
                    pairs: torch.Tensor, stage: str, quant_step=None,
                    svd=None) -> torch.Tensor:
    """The fused step over the K blocks of the merged ``x`` with the frame
    kernel truncated after ``stage`` (:data:`STAGES`) -> ``xp [K, nbl,
    nbins]``: the cross power of what the truncated frames left in the
    channels' slots (at bin counts that are not a power of two in [256,
    8192] the stages of :data:`MIXED_STAGES` only).  Stage ``"fft"`` runs
    no X stage and returns ``[K, 1, FFT_STAGE_BINS]``, every channel's
    spectrum summed over the block's frames at the first bins.  ``x``
    complex64 ``[nch, K, S, nbins]`` with a tensor history, or int8
    ``[nch, K, S, nbins, 2]`` with the raw-tail dict and ``quant_step``;
    ``svd`` as for :func:`fx_fused_raw`.  No
    history is returned: a timing harness feeds the same one again.

    CPU tensors run :func:`fx_fused_ablate_reference`; CUDA tensors launch
    the kernels (mean pre-pass, truncated frame kernel, reduce) or raise.
    Each launch adds one to ``fx_fused_ablate.launches``."""
    if stage not in STAGES:
        raise ValueError(f"stage {stage!r} is not one of {STAGES}")
    if stage not in MIXED_STAGES and not _pow2_bins(window2d.shape[-1]):
        raise ValueError(f"stage {stage!r} takes nbins a power of two in "
                         f"[256, {FFT_MAX_SUB}] (the radix-16 FFT's sizes); "
                         f"at {window2d.shape[-1]} bins the ablation runs "
                         f"{MIXED_STAGES}")
    int8 = x.dtype == torch.int8
    if int8 and quant_step is None:
        raise ValueError("8-bit samples need their quant_step")
    if not on_card(x, "fx_fused_ablate"):
        return fx_fused_ablate_reference(x, history, window2d, pairs, stage,
                                         quant_step, svd)
    index = STAGES.index(stage)
    what = f"fx_fused ablation ({stage}) kernel launch"
    if int8:
        quant_step = float(quant_step)
        rank = _check_i8(x, history, window2d, pairs, quant_step, svd,
                         multi=True, blocks=False, fits=False)
    else:
        rank = _check(x, history, window2d, pairs, svd, multi=True,
                      blocks=False, fits=False)
    _check_ablate(x, window2d, pairs, rank)
    if int8:
        xp, _ = _launch_i8(x, history, window2d, pairs, quant_step, svd,
                           what, merged=True, stage=index)
    else:
        xp, _ = _launch(x, history, window2d, pairs, svd, what, merged=True,
                        stage=index)
    fx_fused_ablate.launches += 1
    return xp[:, :1, :FFT_STAGE_BINS] if stage == "fft" else xp


fx_fused_ablate.launches = 0
