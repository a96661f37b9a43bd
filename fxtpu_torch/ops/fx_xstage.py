"""The X stage of the single pass over spectra in device memory.

Counterpart of the X loop of ``fxtpu.ops.pfb_pallas._fx_kernel``
(any pair list, autos with no imaginary part) and of its T and GJ
accumulators, for channel counts whose spectra of a frame do not fit in
one CTA's shared memory together.  The CUDA kernel is
``fxtpu_torch/csrc/fx_xstage.cu``; the wide route of the single pass
(``fx_fused.fx_fused_parts(..., x_stage="global")``) launches it after the
frame kernel has written every spectrum out, and :func:`fx_xstage`
launches it alone, beside its plain version :func:`fx_xstage_reference`.

Contract, for ``spec`` complex64 ``[K, nch, S, nbins]``, ``pairs`` int32
``[nbl, 2]`` and ``da`` complex64 ``[halo, nbins]``
(``dc_posthoc.dc_constants``' dA): ``parts [K, nbl + 2 nch, nbins]``,
rows ``0 .. nbl-1`` the frame-summed ``spec_p conj(spec_q)`` of each pair
(imaginary part exactly 0 for an auto pair), then ``T_c``, the sum of
channel c's spectra, then ``GJ_c``, the sum over frames ``f < halo`` of
``spec_c[f] conj(dA[f])``.

The kernel has three instances of that contract, and :func:`xstage_plan`
picks one by shape: below :data:`XSTAGE_TILED_NCH` channels a row
instance (:func:`row_plan`: each thread sums a few rows of parts, bound
by bytes), from there to :data:`XSTAGE_TILED_MAX_NCH` the register-tiled
one (:func:`tiled_plan`: each thread sums an 8 x 8 tile of pairs in
registers, bound by float32 operations), and past it the band instance
(:func:`band_plan`: the same tiles, a CTA a pair of bands of 64 channels,
so that each CTA reads only its two bands' spectra).  The register-tiled
instances write through the pair list's :func:`row_map`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["fx_xstage", "fx_xstage_reference", "xstage_plan", "row_plan",
           "tiled_plan", "band_plan", "XStagePlan", "xstage_launch",
           "count_launch", "row_map", "XSTAGE_BINS", "XSTAGE_TILED_NCH",
           "XSTAGE_TILED_MAX_NCH"]

#: The wrappers take bin counts that are multiples of this (every bin
#: count the port takes is one).
XSTAGE_BINS = 32
#: Rows of parts a thread of a row instance sums (``kRows``) -> the
#: threads a CTA that instance takes at most (its ``__launch_bounds__``,
#: ``RowThreads`` in ``csrc/fx_xstage.cu``): 576 x 8 rows cover 64
#: channels' 2,208 rows at a tile of 2 bins.
XSTAGE_ROW_THREADS = {2: 256, 4: 256, 8: 576}
XSTAGE_ROWS = max(XSTAGE_ROW_THREADS)
#: The rows the row instances hold in one CTA: 576 threads of 8 rows at a
#: tile of 2 bins.
XSTAGE_ROW_CAPACITY = XSTAGE_ROW_THREADS[XSTAGE_ROWS] // 2 * XSTAGE_ROWS
#: The register-tiled instance (``fx_xstage_kernel_tiled``): channels a
#: group, a thread's tile ``XSTAGE_GROUP`` x ``XSTAGE_GROUP`` pairs (the
#: plan's ``rows``, :data:`XSTAGE_TILED_ROWS`, names the instance), at most
#: :data:`XSTAGE_TILED_THREADS` threads a CTA (8 warps: two a
#: sub-partition, 255 registers a thread) and :data:`XSTAGE_TILED_TILE`
#: bins a tile, a bin's channels of a group :data:`XSTAGE_BIN_STRIDE`
#: values apart in the ring, at most :data:`XSTAGE_MAX_UNITS` T and GJ
#: sums and tail units of 2 x 2 pairs a thread (``kGroup``,
#: ``kTiledRows``, ``kTiledThreads``, ``kMaxTiledTile``, ``kBinStride``,
#: ``kMaxUnits`` in the kernel).
XSTAGE_GROUP = 8
XSTAGE_TILED_ROWS = XSTAGE_GROUP * XSTAGE_GROUP
XSTAGE_TILED_THREADS = 256
XSTAGE_TILED_TILE = 32
XSTAGE_BIN_STRIDE = XSTAGE_GROUP + 2
XSTAGE_MAX_UNITS = 2
#: From this many channels on the plan takes the register-tiled instance
#: (float32 operations bound it there), below it a row instance (bytes
#: bound it): the lowest of 36, 48 and 64 channels at which the tiled one
#: won alone on an H100 (PERF.md: the A/B of the two instances at S = 64,
#: 4096 bins, K = 3; it won at each, 3.0, 5.0 and 7.0 times faster).
XSTAGE_TILED_NCH = 36
#: The most channels the register-tiled instance's plan takes: 16 groups,
#: whose triangle fills 8 warps on two CTAs a bin tile (:func:`tiled_plan`
#: raises past it).  Past it the band instance (:func:`band_plan`).
XSTAGE_TILED_MAX_NCH = 128
#: The band instance (``fx_xstage_kernel_bands``): bands of
#: :data:`XSTAGE_BAND` groups (64 channels), a CTA a pair of bands (P, Q),
#: P <= Q, at one bin tile: its 8 x 8 tiles of 8 x 8 pairs, one a slot of
#: :data:`XSTAGE_BAND_SLOTS` (the 36 with i <= j where P = Q), and where P
#: = Q its band's T and GJ sums; the plan's ``rows``,
#: :data:`XSTAGE_BAND_ROWS`, names it (``kBand``, ``kBandSlots``,
#: ``kBandRows`` in the kernel).
XSTAGE_BAND = 8
XSTAGE_BAND_SLOTS = XSTAGE_BAND * XSTAGE_BAND
XSTAGE_BAND_ROWS = 2 * XSTAGE_TILED_ROWS
#: Stages of the ring the frames stream through (at least 2), and the
#: shared memory the ring takes at most: 96 KiB for a row instance, two
#: CTAs an SM; 160 KiB for the tiled one, whose registers leave one CTA an
#: SM (8 frames a stage at MeerKAT's 128 channels, not 4).
XSTAGE_STAGES = 3
XSTAGE_RING_BYTES = 96 << 10
XSTAGE_TILED_RING_BYTES = 160 << 10
#: CTAs the grid reaches for where the bins allow: two an SM of the
#: H100's 132, rounded to a power of two of tiles.
XSTAGE_FILL_CTAS = 256


@dataclasses.dataclass(frozen=True)
class XStagePlan:
    """One launch's shape (``XStagePlan`` in ``csrc/fx_xstage.cu``): a CTA
    owns ``tile`` bins of one block (grid ``(nbins / tile, K)``) and every
    row of parts at them; ``rows`` names the kernel instance.  A row
    instance (``rows`` a key of :data:`XSTAGE_ROW_THREADS`): thread t sums
    bin ``t % tile`` of the rows ``slot, slot + slots, ...`` (``slot = t //
    tile``), ``rows`` of them.  The tiled instance (``rows`` =
    :data:`XSTAGE_TILED_ROWS`): slot s holds one tile of pairs of the ``ng
    (ng + 1) / 2`` in the triangle of groups of :data:`XSTAGE_GROUP`
    channels on ``split`` CTAs (1 or 2, the grid's third axis, which the
    kernel derives from ``slots``, so it is not among :meth:`args`),
    ``slots`` tiles a CTA.  The band instance (``rows`` =
    :data:`XSTAGE_BAND_ROWS`, :attr:`bands`): ``split`` CTAs a bin tile,
    one a pair of bands (grid ``(split, nbins / tile, K)``, which the
    kernel derives from nch), ``slots`` tiles each.  The frames stream
    through ``stages`` buffers of ``frames`` frames of the CTA's channels
    (tile and frames powers of two); ``threads`` a CTA; ``shared_bytes``
    the ring and the block's means; ``reads`` the CTAs that stage each bin
    tile's spectra (1 on a row instance, ``split`` on the tiled one, the
    bands on the band one)."""
    tile: int
    slots: int
    rows: int
    frames: int
    stages: int
    threads: int
    shared_bytes: int
    split: int = 1
    reads: int = 1

    def args(self):
        """The entry's plan arguments, in its order."""
        return (self.tile, self.slots, self.rows, self.frames, self.stages,
                self.threads)

    @property
    def tiled(self) -> bool:
        """A register-tiled instance (the tiled one or the band one), which
        writes through the pair list's :func:`row_map`."""
        return self.rows in (XSTAGE_TILED_ROWS, XSTAGE_BAND_ROWS)

    @property
    def bands(self) -> bool:
        """The band instance."""
        return self.rows == XSTAGE_BAND_ROWS

    def ctas(self, nbins: int, k: int) -> int:
        """CTAs a launch over ``k`` blocks of ``nbins`` bins runs."""
        return nbins // self.tile * k * self.split


def _fill_tile(nbins: int, k: int) -> int:
    """The widest power-of-two tile, 2 to 256 bins, that leaves about
    :data:`XSTAGE_FILL_CTAS` CTAs or more."""
    top = min(256, nbins & -nbins)
    fill = 2
    while fill * 2 <= min(top, nbins * k // XSTAGE_FILL_CTAS):
        fill *= 2
    return fill


def _ring(frame_bytes: int, s_rows: int, budget: int = XSTAGE_RING_BYTES):
    """(stages, frames) of the ring: :data:`XSTAGE_STAGES` stages (fewer
    only where one frame would not fit, never fewer than 2) of the most
    frames, a power of two, that ``budget`` bytes allow (few, large
    chunks: each costs the CTA a barrier), at most a third of the block's
    so that short blocks still overlap."""
    stages = XSTAGE_STAGES
    while stages > 2 and stages * frame_bytes > budget:
        stages -= 1
    most = max(1, min(budget // (stages * frame_bytes),
                      -(-s_rows // stages)))
    return stages, 1 << (most.bit_length() - 1)


def xstage_plan(nch: int, nbl: int, s_rows: int, nbins: int,
                k: int = 1) -> XStagePlan:
    """The X kernel's plan for K blocks of ``nch`` channels, ``nbl``
    pairs, ``s_rows`` frames and ``nbins`` bins (a multiple of
    :data:`XSTAGE_BINS`): the register-tiled instance from
    :data:`XSTAGE_TILED_NCH` channels on, or wherever the ``nbl + 2 nch``
    rows pass what a row instance holds in one CTA
    (:data:`XSTAGE_ROW_CAPACITY`), the band instance past
    :data:`XSTAGE_TILED_MAX_NCH` channels, else a row instance."""
    if nch > XSTAGE_TILED_MAX_NCH:
        return band_plan(nch, s_rows, nbins, k)
    if nch >= XSTAGE_TILED_NCH or nbl + 2 * nch > XSTAGE_ROW_CAPACITY:
        return tiled_plan(nch, s_rows, nbins, k)
    return row_plan(nch, nbl, s_rows, nbins, k)


def row_plan(nch: int, nbl: int, s_rows: int, nbins: int,
              k: int) -> XStagePlan:
    """A row instance's plan.  The tile is the widest power of two that
    leaves about :data:`XSTAGE_FILL_CTAS` CTAs or more, narrowed until the
    ``nbl + 2 nch`` rows spread over 256 threads (576 where 256 cannot
    hold them), at most :data:`XSTAGE_ROWS` a thread.  A slot takes one row
    of those summed over every frame (pairs and T) where they are few, and
    the GJ rows, summed over the first halo frames only, ride on the same
    threads, so every thread sums over every frame.  The kernel instance
    is the fewest rows a thread of :data:`XSTAGE_ROW_THREADS` that hold a
    slot's rows and take the threads.  The ring is :func:`_ring`'s; after
    it, the block's means (nch float2)."""
    rows = nbl + 2 * nch
    busy = max(1, rows - nch)     # the rows summed over every frame
    fill = _fill_tile(nbins, k)
    for most in sorted(set(XSTAGE_ROW_THREADS.values())):
        tile = fill
        while tile > 2 and -(-rows // (most // tile)) > XSTAGE_ROWS:
            tile //= 2
        slots = min(most // tile, busy)
        if -(-rows // slots) <= XSTAGE_ROWS:
            break
    threads = -(-tile * slots // 32) * 32
    per = min(n for n, top in XSTAGE_ROW_THREADS.items()
              if n * slots >= rows and threads <= top)
    frame_bytes = nch * tile * 8
    stages, frames = _ring(frame_bytes, s_rows)
    return XStagePlan(tile, slots, per, frames, stages, threads,
                      stages * frames * frame_bytes + nch * 8)


def tiled_plan(nch: int, s_rows: int, nbins: int, k: int) -> XStagePlan:
    """The register-tiled instance's plan over the triangle of ``ng =
    ceil(nch / 8)`` groups, ``ng (ng + 1) / 2`` tiles of pairs: one slot a
    tile, or, where ng is even and at least 8, one slot a tile of the ng /
    2 whole diagonals (``ng^2 / 2`` tiles) and the half diagonal's tiles in
    the tail, in units of 2 x 2 pairs over every thread.  The tile is the
    widest power of two up to :data:`XSTAGE_TILED_TILE` bins that
    :func:`_fill_tile` allows and that leaves :data:`XSTAGE_TILED_THREADS`
    threads or fewer, each slot one at a bin and at most
    :data:`XSTAGE_MAX_UNITS` of the tail's units and of the ``nch x
    tile`` T sums a thread (more threads than slots where those need
    them).  Where that tile is 2 bins (16 bytes of a row) and the tiles
    split evenly, two CTAs share a tile of 4 bins (``split`` 2), half the
    tiles each: each row's 32 bytes, a whole sector, from one CTA, each
    spectrum byte read by both.  A frame in the ring is ``ng x tile x``
    :data:`XSTAGE_BIN_STRIDE` values.  Raises ValueError where the
    triangle does not fit (past 128 channels)."""
    ng = -(-nch // XSTAGE_GROUP)
    tail = ng % 2 == 0 and ng >= 8
    tiles = ng * ng // 2 if tail else ng * (ng + 1) // 2
    top = min(XSTAGE_TILED_TILE, _fill_tile(nbins, k))

    def lanes(split):
        # a bin's slots, tail units and T sums on a CTA, in threads
        per_bin = max(ng // 2 * 16 if tail else 0, nch)
        return max(tiles // split,
                   -(-per_bin // (split * XSTAGE_MAX_UNITS)))

    split, tile = 1, 2
    while tile < top and 2 * tile * lanes(1) <= XSTAGE_TILED_THREADS:
        tile *= 2
    if tile == 2 and tiles % 2 == 0 and top >= 4:
        split, tile = 2, 4
    slots = tiles // split
    threads = -(-tile * lanes(split) // 32) * 32
    if threads > XSTAGE_TILED_THREADS:
        raise ValueError(f"the X kernel's tiled instance takes at most "
                         f"{XSTAGE_TILED_THREADS} threads a CTA; {nch} "
                         f"channels need {threads}")
    frame_bytes = ng * tile * XSTAGE_BIN_STRIDE * 8
    stages, frames = _ring(frame_bytes, s_rows, XSTAGE_TILED_RING_BYTES)
    return XStagePlan(tile, slots, XSTAGE_TILED_ROWS, frames, stages,
                      threads, stages * frames * frame_bytes + nch * 8,
                      split, split)


def band_plan(nch: int, s_rows: int, nbins: int, k: int) -> XStagePlan:
    """The band instance's plan past :data:`XSTAGE_TILED_MAX_NCH`
    channels: ``nb = ceil(ng / 8)`` bands of :data:`XSTAGE_BAND` groups,
    one CTA a pair of bands at a bin tile (``nb (nb + 1) / 2`` of them,
    the ``split``), :data:`XSTAGE_BAND_SLOTS` tiles of 8 x 8 pairs a CTA,
    one a slot at each bin, so 4 bins a tile (256 threads, each row's 32
    bytes a sector) where :func:`_fill_tile` allows, else 2.  A frame in
    the ring is the two bands' 16 groups, ``16 x tile x``
    :data:`XSTAGE_BIN_STRIDE` values whatever nch (a quarter of every
    channel's at 512), and each spectrum byte is read by the
    ``nb`` CTAs whose pair holds its band.  At LEDA's 512 channels: 8
    bands, 36 CTAs a bin tile, 90% of the slots owning a tile (the 8
    diagonal pairs own 36 of 64)."""
    ng = -(-nch // XSTAGE_GROUP)
    nb = -(-ng // XSTAGE_BAND)
    tile = 4 if min(XSTAGE_TILED_TILE, _fill_tile(nbins, k)) >= 4 else 2
    frame_bytes = 2 * XSTAGE_BAND * tile * XSTAGE_BIN_STRIDE * 8
    stages, frames = _ring(frame_bytes, s_rows, XSTAGE_TILED_RING_BYTES)
    return XStagePlan(tile, XSTAGE_BAND_SLOTS, XSTAGE_BAND_ROWS, frames,
                      stages, tile * XSTAGE_BAND_SLOTS,
                      stages * frames * frame_bytes + nch * 8,
                      nb * (nb + 1) // 2, nb)


def row_map(pairs: torch.Tensor, nch: int) -> torch.Tensor:
    """The tiled instance's row map: int32 ``[np, np]`` on ``pairs``'
    device, ``np`` = nch rounded up to a group of :data:`XSTAGE_GROUP`;
    entry ``[p, q]`` the row of pair ``(p, q)`` in ``pairs`` and -1 where
    the list has none (every entry past nch).  Built once a pair tensor and
    kept on it (rebuilt only after an in-place change of the tensor or for
    another nch).  Raises ValueError on a pair listed twice: one entry
    cannot name two rows."""
    key = (pairs._version, nch)
    kept = getattr(pairs, "_xstage_row_map", None)
    if kept is not None and kept[0] == key:
        return kept[1]
    side = -(-nch // XSTAGE_GROUP) * XSTAGE_GROUP
    p = pairs.cpu().numpy().astype(np.int64).reshape(-1, 2)
    flat = p[:, 0] * side + p[:, 1]
    if np.unique(flat).size != flat.size:
        raise ValueError("the pair list names a pair twice; the X kernel's "
                         "row map takes distinct pairs")
    table = np.full(side * side, -1, np.int32)
    table[flat] = np.arange(len(flat), dtype=np.int32)
    out = torch.from_numpy(table.reshape(side, side)).to(pairs.device)
    pairs._xstage_row_map = (key, out)
    return out


def fx_xstage_reference(spec: torch.Tensor, pairs: torch.Tensor,
                        da: torch.Tensor) -> torch.Tensor:
    """The X stage in plain torch, same contract as :func:`fx_xstage`."""
    halo = da.shape[0]
    idx = pairs.to(device=spec.device, dtype=torch.long)
    xp = (spec[:, idx[:, 0]] * spec[:, idx[:, 1]].conj()).sum(dim=2)
    autos = idx[:, 0] == idx[:, 1]
    xp[:, autos] = xp[:, autos].real.to(xp.dtype)
    t = spec.sum(dim=2)
    gj = (spec[:, :, :halo] * da.conj()).sum(dim=2)
    return torch.cat([xp, t, gj], dim=1)


def _check(spec, pairs, da):
    if spec.dtype != torch.complex64 or da.dtype != torch.complex64:
        raise TypeError("spec and da must be complex64")
    if pairs.dtype != torch.int32:
        raise TypeError("pairs must be int32")
    if spec.ndim != 4:
        raise ValueError(f"spec must be [K, nch, S, nbins], got "
                         f"{tuple(spec.shape)}")
    k, _, s_rows, nbins = spec.shape
    if da.ndim != 2 or da.shape[1] != nbins or da.shape[0] > s_rows:
        raise ValueError(f"da {tuple(da.shape)} must be [halo <= {s_rows}, "
                         f"{nbins}]")
    if pairs.ndim != 2 or pairs.shape[1] != 2:
        raise ValueError(f"pairs must be [nbl, 2], got {tuple(pairs.shape)}")
    if not (1 <= k <= 65535 and nbins % XSTAGE_BINS == 0):
        raise ValueError(f"the X kernel takes 1 to 65535 blocks and nbins a "
                         f"multiple of {XSTAGE_BINS}, got K={k}, "
                         f"nbins={nbins}")
    for name, t in (("pairs", pairs), ("da", da)):
        if t.device != spec.device:
            raise ValueError(f"{name} is on {t.device}, spec on "
                             f"{spec.device}")
    for name, t in (("spec", spec), ("pairs", pairs), ("da", da)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def count_launch(plan: XStagePlan, nbins: int, k: int):
    """Count one launch of the X kernel on :func:`fx_xstage`'s counters:
    ``launches``, its CTAs ``ctas`` (:meth:`XStagePlan.ctas`), the CTAs
    that stage each bin tile's spectra ``spectra_reads``
    (:attr:`XStagePlan.reads`) and, where it took a register-tiled instance, ``tiled``."""
    fx_xstage.launches += 1
    fx_xstage.ctas += plan.ctas(nbins, k)
    fx_xstage.spectra_reads += plan.reads
    fx_xstage.tiled += int(plan.tiled)


def xstage_launch(plan: XStagePlan, rowmap, spec, pairs, da, parts, *,
                  x=None, sums=None, mu=None, new_hist=None, n_groups=0,
                  quant_step=None):
    """Launch the X kernel as ``plan`` says over ``spec [K, nch, S,
    nbins]`` into ``parts`` on the current stream, writing through
    ``rowmap`` (:func:`row_map`; None on the row instance), and check the
    launch; the caller counts it.  The single pass's wide route
    (``fx_fused.launch_parts``) also gives the merged samples ``x``
    (8-bit ones with their ``quant_step``), the frame kernel's
    ``n_groups`` groups of sample sums ``sums`` and ``mu`` and
    ``new_hist``, which the launch forms."""
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    k, nch, s_rows, nbins = spec.shape
    entry = lib.fxt_xstage if quant_step is None else lib.fxt_xstage_i8
    extra = () if quant_step is None else (quant_step,)

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with torch.cuda.device(spec.device):
        stream = torch.cuda.current_stream(spec.device).cuda_stream
        rc = entry(spec.data_ptr(), pairs.data_ptr(), ptr(rowmap), ptr(da),
                   parts.data_ptr(), ptr(x), ptr(sums), ptr(mu),
                   ptr(new_hist), nch, k, s_rows, nbins, pairs.shape[0],
                   da.shape[0], n_groups, *plan.args(), *extra, stream)
    check(lib, rc, "fx_xstage kernel launch")


def fx_xstage(spec: torch.Tensor, pairs: torch.Tensor,
              da: torch.Tensor) -> torch.Tensor:
    """The X stage over the frames' spectra ``spec [K, nch, S, nbins]``
    -> ``parts [K, nbl + 2 nch, nbins]`` (module docstring contract).

    CPU tensors run :func:`fx_xstage_reference`; CUDA tensors launch the
    kernel (built at first use) or raise.  Each launch of the kernel adds
    one to ``fx_xstage.launches``, its CTAs to ``fx_xstage.ctas``, the CTAs
    that stage each bin tile's spectra to ``fx_xstage.spectra_reads`` and,
    where it took a register-tiled instance, one to ``fx_xstage.tiled``:
    those of this call, and those of the single pass's wide route, which
    launches it after its frame kernel (``fx_fused.fx_fused_parts(...,
    x_stage="global")``)."""
    if spec.device.type == "cpu":
        return fx_xstage_reference(spec, pairs, da)
    if spec.device.type != "cuda":
        raise ValueError(f"fx_xstage runs on cuda or cpu, not {spec.device}")
    _check(spec, pairs, da)
    k, nch, s_rows, nbins = spec.shape
    plan = xstage_plan(nch, pairs.shape[0], s_rows, nbins, k)
    parts = torch.empty((k, pairs.shape[0] + 2 * nch, nbins),
                        dtype=torch.complex64, device=spec.device)
    xstage_launch(plan, row_map(pairs, nch) if plan.tiled else None, spec,
                  pairs, da, parts)
    count_launch(plan, nbins, k)
    return parts


fx_xstage.launches = 0
fx_xstage.ctas = 0
fx_xstage.spectra_reads = 0
fx_xstage.tiled = 0
