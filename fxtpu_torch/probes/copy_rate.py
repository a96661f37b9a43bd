"""Copy rate from device memory into shared memory, against the length of
the contiguous run and against the indexing shape.

Counterpart of ``scripts/dma_width_probe.py`` (``make_fn``: the DMA rate
against the destination row width, identical bytes at every width) and of
``scripts/dma_shape_probe.py`` (``make_kernel``: merged 3-D source against
per-block 4-D source, contiguous against strided destination), both as
one CUDA kernel, ``fxt_copy_probe`` in ``csrc/probes.cu``.  A CTA brings a
tile of ``nch x rows`` runs of ``width`` contiguous bytes into shared
memory, sums the 32-bit words that arrived and adds the sum to the tile's
checksum; the plain version forms the same sums by tensor indexing.

Mechanisms (each takes the place of the TPU's one DMA engine):

  ldg2, ldg8, ldg   loads through registers, 2, 8 or 16 bytes a thread:
                    what the frame kernel does today (one ``char2`` or
                    ``float2`` per thread and tap);
  cp_async          16-byte ``cp.async.cg``, no registers;
  bulk              TMA's 1-D ``cp.async.bulk``, one per run, completing
                    on an ``mbarrier``.

Sweeps:

  width   runs of 512 B ... 32 KB cut from one ``[R, 32 KB]`` array, the
          same bytes walked at every width (``dma_width_probe``'s r sweep:
          the TPU's rows of 16 KB ... 512 B).  The frame kernel's runs are
          one tap row: 32 KB at 4096 bins complex64, 8 KB int8.
  shape   a frame's rows of every channel: ``chan`` (merged ``[nch, K S,
          nbins]`` source, contiguous destination), ``prodsrc``
          (per-block ``[K, nch, S, nbins]`` source), ``proddst`` (merged
          source, channel-strided destination), ``prod`` (both), in
          complex64 and in interleaved int8 (``dma_shape_probe``'s four
          modes over its int32 planes).

Each leg is timed cold (a walk of at least 256 MB of distinct addresses
per repeat, five times the L2) and hot (a walk that stays in the L2), by
the slope between two repeat counts inside one launch.  The main path sees
the cold number for a block's first read (the mean pre-pass) and the hot
one for the frame kernel's re-reads of the tap rows.

    python -m fxtpu_torch.probes copy_rate [--sweep width|shape|all]

prints one JSON line per leg: ``gbps`` beside ``hbm_gbps`` (3350).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass

import torch

from fxtpu_torch.probes.common import (HBM_GBPS, L2_BYTES, MAX_SHARED_BYTES,
                                       add_device_argument, card_line, emit,
                                       resolve_device, slope_ms, sm_count)

__all__ = ["MECHS", "CopyPlan", "width_plan", "shape_plan", "shape_plans",
           "copy_probe", "copy_probe_reference", "main"]

#: name -> (mechanism, bytes a thread loads at a time) of ``fxt_copy_probe``.
MECHS = {"ldg2": (0, 2), "ldg8": (0, 8), "ldg": (0, 16),
         "cp_async": (1, 16), "bulk": (2, 16)}
WIDTHS = (512, 1024, 2048, 4096, 8192, 16384, 32768)
SHAPE_MODES = ("chan", "prodsrc", "proddst", "prod")
#: Pitch of the width sweep's source array: the longest run, one complex64
#: tap row at 4096 bins.
PITCH = 32768
TILE_BYTES = 65536
COLD_BYTES = 256 * 2**20
#: Mechanisms of the width sweep, and the (lo, hi) repeats of each walk's
#: slope: a cold launch at 2 repeats already lasts a millisecond.
WIDTH_MECHS = ("ldg", "cp_async", "bulk")
COLD_REPS = (2, 10)
HOT_REPS = (8, 264)


@dataclass(frozen=True)
class CopyPlan:
    """The byte geometry of one leg (every field in bytes or counts):
    tile ``t`` is ``nch x rows`` runs of ``width`` bytes, run ``(c, i)``
    at ``(t // tpb) blk_stride + (t % tpb) tile_stride + c chan_stride + i
    row_stride`` of the source and at ``c dst_chan_stride + i
    dst_row_stride`` of the CTA's shared memory."""
    ntiles: int
    tpb: int
    nch: int
    rows: int
    width: int
    blk_stride: int
    tile_stride: int
    chan_stride: int
    row_stride: int
    dst_chan_stride: int
    dst_row_stride: int
    src_bytes: int

    @property
    def tile_bytes(self) -> int:
        return self.nch * self.rows * self.width

    @property
    def bytes_per_rep(self) -> int:
        """Bytes one walk over all tiles brings in: each byte of the
        source once."""
        return self.ntiles * self.tile_bytes


def width_plan(width: int, total_bytes: int, tile_bytes: int = TILE_BYTES,
               pitch: int = PITCH) -> CopyPlan:
    """The width sweep's leg: the ``[R, pitch]`` array of ``total_bytes``
    cut into tiles of ``tile_bytes``, each ``tile_bytes / width`` runs of
    ``width`` bytes one pitch apart.  Every width walks every byte once."""
    rows = tile_bytes // width
    tpb = pitch // width
    ntiles = total_bytes // tile_bytes
    if (width * rows != tile_bytes or width * tpb != pitch
            or ntiles * tile_bytes != total_bytes or ntiles % tpb):
        raise ValueError(
            f"width {width} does not tile {total_bytes} bytes in tiles of "
            f"{tile_bytes} at pitch {pitch}")
    return CopyPlan(ntiles=ntiles, tpb=tpb, nch=1, rows=rows, width=width,
                    blk_stride=rows * pitch, tile_stride=width,
                    chan_stride=0, row_stride=pitch,
                    dst_chan_stride=tile_bytes, dst_row_stride=width,
                    src_bytes=total_bytes)


def shape_plan(mode: str, *, row_bytes: int, rows: int, nch: int,
               k_blocks: int, s_rows: int) -> CopyPlan:
    """The shape sweep's leg: a tile is ``rows`` consecutive rows of
    ``row_bytes`` of each of ``nch`` channels; the tiles cover K blocks of
    S rows once.  ``chan`` / ``proddst`` read the merged ``[nch, K S,
    row]`` source, ``prodsrc`` / ``prod`` the per-block ``[K, nch, S,
    row]`` one; ``proddst`` / ``prod`` interleave the channels' rows in
    shared memory, the others keep each channel's rows together."""
    if mode not in SHAPE_MODES:
        raise ValueError(f"mode {mode!r} is not one of {SHAPE_MODES}")
    if s_rows % rows:
        raise ValueError(f"tiles of {rows} rows do not cover {s_rows}")
    per_block = s_rows // rows
    ntiles = k_blocks * per_block
    if mode in ("prodsrc", "prod"):
        tpb, blk = per_block, nch * s_rows * row_bytes
        chan = s_rows * row_bytes
    else:
        tpb, blk = ntiles, 0
        chan = k_blocks * s_rows * row_bytes
    if mode in ("proddst", "prod"):
        dst_chan, dst_row = row_bytes, nch * row_bytes
    else:
        dst_chan, dst_row = rows * row_bytes, row_bytes
    return CopyPlan(ntiles=ntiles, tpb=tpb, nch=nch, rows=rows,
                    width=row_bytes, blk_stride=blk,
                    tile_stride=rows * row_bytes, chan_stride=chan,
                    row_stride=row_bytes, dst_chan_stride=dst_chan,
                    dst_row_stride=dst_row,
                    src_bytes=nch * k_blocks * s_rows * row_bytes)


#: The shape sweep's sample formats: (ingest, bytes a sample, mechanisms).
SHAPE_INGESTS = (("complex64", 8, ("ldg8", "ldg", "cp_async", "bulk")),
                 ("int8", 2, ("ldg2", "ldg", "cp_async", "bulk")))


def shape_plans(nbytes: int, nbins: int = 4096, nch: int = 2):
    """The shape sweep over a walk of ``nbytes``: ``(ingest, mechanisms,
    mode, plan)`` for each sample format and mode.  A tile is a frame's
    newest rows of every channel, 128 KB: two complex64 tap rows or eight
    int8 ones per channel at 4096 bins; blocks of at most 64 tiles."""
    for ingest, sample, mechs in SHAPE_INGESTS:
        row = nbins * sample
        rows = max(1, 2 * TILE_BYTES // (nch * row))
        tile = nch * rows * row
        s_rows = rows * max(1, min(64, nbytes // tile))
        k = max(1, nbytes // (nch * s_rows * row))
        for mode in SHAPE_MODES:
            yield ingest, mechs, mode, shape_plan(
                mode, row_bytes=row, rows=rows, nch=nch, k_blocks=k,
                s_rows=s_rows)


def _check(src: torch.Tensor, plan: CopyPlan, reps: int):
    if src.dtype != torch.uint8 or src.ndim != 1 or not src.is_contiguous():
        raise TypeError("src must be a contiguous 1-D uint8 tensor")
    if src.numel() < plan.src_bytes:
        raise ValueError(f"src holds {src.numel()} bytes, the plan walks "
                         f"{plan.src_bytes}")
    strides = (plan.blk_stride, plan.tile_stride, plan.chan_stride,
               plan.row_stride, plan.dst_chan_stride, plan.dst_row_stride,
               plan.width)
    if any(v % 16 for v in strides) or src.data_ptr() % 16:
        raise ValueError("every stride, the width and the source address "
                         "must be multiples of 16 bytes")
    if plan.width & (plan.width - 1) or plan.width < 16:
        raise ValueError(f"width {plan.width} must be a power of two >= 16")
    if reps < 1 or plan.ntiles < 1 or plan.ntiles % plan.tpb:
        raise ValueError("reps and ntiles must be >= 1, ntiles a multiple "
                         "of tpb")
    last = ((plan.ntiles // plan.tpb - 1) * plan.blk_stride
            + (plan.tpb - 1) * plan.tile_stride
            + (plan.nch - 1) * plan.chan_stride
            + (plan.rows - 1) * plan.row_stride + plan.width)
    if last > src.numel():
        raise ValueError(f"the plan reads up to byte {last} of "
                         f"{src.numel()}")


def copy_probe_reference(src: torch.Tensor, plan: CopyPlan,
                         reps: int = 1) -> torch.Tensor:
    """The checksums in plain torch: for each tile ``reps`` times the sum
    of its 32-bit words, modulo 2^32 -> int64 ``[ntiles]``."""
    _check(src, plan, reps)
    words = src.view(torch.int32)
    tiles = words.as_strided(
        (plan.ntiles // plan.tpb, plan.tpb, plan.nch, plan.rows,
         plan.width // 4),
        (plan.blk_stride // 4, plan.tile_stride // 4, plan.chan_stride // 4,
         plan.row_stride // 4, 1))
    sums = (tiles.to(torch.int64) & 0xffffffff).sum(dim=(2, 3, 4))
    return (sums.reshape(-1) * reps) & 0xffffffff


def copy_probe(src: torch.Tensor, plan: CopyPlan, mech: str = "ldg",
               reps: int = 1) -> torch.Tensor:
    """Walk the plan's tiles ``reps`` times through shared memory by
    ``mech`` (:data:`MECHS`) -> int64 ``[ntiles]`` checksums, ``reps``
    times the sum of each tile's 32-bit words modulo 2^32.  As many CTAs
    as are resident at once share the tiles, each with a tile's bytes of
    dynamic shared memory.

    A CPU tensor runs :func:`copy_probe_reference`; a CUDA tensor launches
    ``fxt_copy_probe`` or raises.  Each launch adds one to
    ``copy_probe.launches``."""
    if mech not in MECHS:
        raise ValueError(f"mech {mech!r} is not one of {tuple(MECHS)}")
    if src.device.type == "cpu":
        return copy_probe_reference(src, plan, reps)
    if src.device.type != "cuda":
        raise ValueError(f"copy_probe runs on cuda or cpu, not {src.device}")
    _check(src, plan, reps)
    smem = plan.tile_bytes
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"a tile of {smem} bytes does not fit the {MAX_SHARED_BYTES} "
            "bytes of shared memory a block may have")
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    per_sm = max(1, min(8, MAX_SHARED_BYTES // (smem + 1024)))
    grid = min(per_sm * sm_count(src.device), plan.ntiles)
    out = torch.empty(plan.ntiles, dtype=torch.int32, device=src.device)
    code, vec = MECHS[mech]
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.fxt_copy_probe(
            src.data_ptr(), out.data_ptr(), plan.blk_stride,
            plan.tile_stride, plan.chan_stride, plan.row_stride,
            plan.ntiles, plan.tpb, plan.nch, plan.rows, plan.width,
            plan.dst_chan_stride, plan.dst_row_stride, reps, code, vec, grid,
            smem, stream)
    check(lib, rc, f"copy probe ({mech}) kernel launch")
    copy_probe.launches += 1
    return out.to(torch.int64) & 0xffffffff


copy_probe.launches = 0


def _source(nbytes: int, device: torch.device, seed: int) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    words = torch.randint(-2**31, 2**31 - 1, (nbytes // 4,), device=device,
                          dtype=torch.int32, generator=gen)
    return words.view(torch.uint8)


def run_leg(records, src, plan, mech, reps, card, **tags):
    """Check one leg's checksums against the plain version at ``reps[0]``
    repeats, then (on the card) time it by the slope between the two
    repeat counts."""
    lo, hi = reps
    got = copy_probe(src, plan, mech, reps=lo)
    want = copy_probe_reference(src, plan, reps=lo)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        raise AssertionError(
            f"copy probe {tags} ({mech}): {bad} of {plan.ntiles} tile "
            "checksums differ from the plain version")
    rec = dict(probe="copy_rate", **tags, mech=mech, width=plan.width,
               tile_bytes=plan.tile_bytes, ntiles=plan.ntiles,
               bytes_per_rep=plan.bytes_per_rep, checksum_ok=True,
               ms_lo=None, ms_hi=None, ms_per_rep=None, gbps=None,
               hbm_gbps=HBM_GBPS, share_of_hbm=None, card=card)
    if src.device.type == "cuda":
        ms_lo, ms_hi, per = slope_ms(
            lambda r: copy_probe(src, plan, mech, reps=r), lo, hi)
        gbps = plan.bytes_per_rep / (per * 1e-3) / 1e9
        rec.update(ms_lo=ms_lo, ms_hi=ms_hi, ms_per_rep=per, gbps=gbps,
                   share_of_hbm=gbps / HBM_GBPS, reps=[lo, hi])
    return emit(records, **rec)


def _walks(args):
    """(temperature, bytes walked, (lo, hi) repeats) of each timing."""
    walks = []
    if args.cold_bytes:
        walks.append(("cold", args.cold_bytes, COLD_REPS))
    if args.hot_bytes:
        walks.append(("hot", args.hot_bytes, HOT_REPS))
    return walks


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m fxtpu_torch.probes copy_rate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(ap)
    ap.add_argument("--sweep", choices=("width", "shape", "all"),
                    default="all")
    ap.add_argument("--nbins", type=int, default=4096)
    ap.add_argument("--nch", type=int, default=2)
    ap.add_argument("--cold_bytes", type=int, default=COLD_BYTES,
                    help="bytes of a cold walk (0: none); at least 256 MB "
                         "to defeat the 50 MB L2")
    ap.add_argument("--hot_bytes", type=int, default=16 * 2**20,
                    help="bytes of a hot walk (0: none); it must fit the L2")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    records = []
    for temp, nbytes, reps in _walks(args):
        if temp == "hot" and nbytes > L2_BYTES:
            raise ValueError(f"a hot walk of {nbytes} bytes does not fit "
                             f"the {L2_BYTES}-byte L2")
        src = _source(nbytes, device, args.seed)
        if args.sweep in ("width", "all"):
            for width in WIDTHS:
                plan = width_plan(width, nbytes)
                for mech in WIDTH_MECHS:
                    run_leg(records, src, plan, mech, reps, card,
                            sweep="width", walk=temp)
        if args.sweep in ("shape", "all"):
            for ingest, mechs, mode, plan in shape_plans(nbytes, args.nbins,
                                                         args.nch):
                for mech in mechs:
                    run_leg(records, src, plan, mech, reps, card,
                            sweep="shape", walk=temp, mode=mode,
                            ingest=ingest)
        del src
    return records
