"""Does a copy into shared memory hide behind the frame's arithmetic?

Counterpart of ``scripts/dma_overlap_probe.py`` (``make_kernel`` /
``make_2d_kernel``), as the CUDA kernel ``fxt_overlap_probe`` in
``csrc/probes.cu``.  A CTA works through frames of an ``[R, n]``
complex64 array; frame f reads rows ``f .. f + ntaps - 1``, as the frame
kernel's FIR does.  Rows are copied into a ring of slots in shared memory
(each slot's copy completing on an mbarrier, each slot released by the
team that read it last) and one or two teams of 256 threads run the body
on frames in turn.  The bulk copies are started by a producer warp, the
cp.async copies (16 bytes a thread) by the team that releases the slot,
all its 256 threads.  Legs, each with the TPU leg whose place it takes:

  copy       the rows are copied and 256 values of each chunk of the
             frame's first row are touched, no body (TPU ``dma``);
  comp_fma   no copy, the body alone: multiply-add passes through shared
             memory over resident rows (TPU ``vcomp``);
  comp_fx    no copy, the frame kernel's body on resident rows: the FIR
             over ntaps rows, then its radix-16 FFT (``csrc/fx_fft.cuh``)
             (TPU ``mix``);
  serial     a frame's new row is asked for after the body before it, and
             waited for, one CTA per SM: nothing can overlap;
  occupancy  the same with two CTAs per SM: the scheduler overlaps one
             CTA's copy with the other's body;
  pipelined  rows asked for ahead while the body runs, one CTA per SM with
             two teams, so two frames' FFTs are in flight (TPU ``dyn`` /
             ``vdyn`` / ``dynmix``).

The TPU's ``dyn`` against ``static`` question (does a dynamic slot index
serialise the pipeline) and its ``dyn2d`` leg are about its compiler and
have no counterpart here.  The copy is ``cp.async`` or the bulk copy
(``--mech``).  Every leg does the same work, the same frames; ``copy`` and
``comp_*`` are measured in each of the structures, and for each
structure and body the probe prints sum(copy, comp), max(copy, comp) and
the measured time, as ``dma_overlap_probe.py`` does: measured near the
sum means the body serialises against the copy, near the max that they
overlap.

Shared memory, reckoned first (:func:`plan`).  Where the ring of whole
rows fits (:func:`layout`, ``rows_read_once``), each row is copied once a
walk: a CTA's frames are consecutive, so frame f + 1 needs one new row,
and a frame's FIR is written over its first row, which no later frame
reads, where its FFT runs in place.  At the flagship (n = 4096, 4 taps)
the pipelined leg's ring is ntaps + teams + nbuf - 2 = 6 rows of 32 KB
beside the 16 KB twiddle table, 208.5 KB: one CTA per SM of two teams and
the producer.  Where it does not fit (two CTAs per SM at the flagship,
8192 bins beyond two taps, many taps), the leg streams chunks of ``cb``
bins of the frame's ntaps rows, so each row is copied ntaps times, into a
work slot of n bins for the FIR and the FFT: one slot and the buffers
64.5 KB (two CTAs per SM), two slots 80.5 KB.  On the card each leg's
record carries the layout the kernel took (``fxt_overlap_layout``: its
``rows_read_once``, ``teams``, ``threads``) and ``device_bytes_per_rep``,
the bytes a repeat of its copies asked for as the kernel counts them
(``fxt_overlap_copied``), beside ``bytes_per_rep``, the script's
accounting; the probe raises if either differs from this module's mirror
(:func:`layout`, :func:`device_bytes`).  Last, the serial and pipelined
structures' fx legs run again with the chunks (``copy_reread``,
``comp_fx_reread``, ``serial_reread`` / ``pipelined_reread``, one team,
the deepest chunk ring that leaves no room for the rows): what reading
each row once saves, structure for structure; the occupancy structure,
chunked by its shared memory, compares with ``serial_reread``.

    python -m fxtpu_torch.probes overlap [--n 4096 --cb 512 --mech bulk]

prints one JSON line per leg and one per (structure, body) summary.
"""

from __future__ import annotations

import argparse
import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from fxtpu_torch.ops.fx_fused import _twiddles, stockham_stages
from fxtpu_torch.probes.common import (MAX_SHARED_BYTES, add_device_argument,
                                       card_line, emit, resolve_device,
                                       slope_ms, sm_count)

__all__ = ["BODIES", "MECHS", "STRUCTURES", "Layout", "shared_bytes",
           "layout", "kernel_layout", "plan", "fits", "copy_bytes",
           "device_bytes", "copied_bytes", "counted_bytes_per_rep",
           "row_schedule", "overlap_probe", "overlap_probe_reference",
           "main"]

BODIES = ("touch", "fma", "fx")
MECHS = {"cp_async": 1, "bulk": 2}
#: structure -> (ring slots, CTAs per SM)
STRUCTURES = {"serial": (1, 1), "occupancy": (1, 2), "pipelined": (2, 1)}
#: Most chunk slots of the chunked layout (kMaxRing).
MAX_RING = 8
#: Most slots of the ring (kMaxSlots): one pair of mbarriers each.
MAX_SLOTS = 32
#: The mbarriers' bytes at the start of a CTA's shared memory.
BARRIER_BYTES = 2 * MAX_SLOTS * 8
#: Threads of a consumer team (one FFT's); a CTA adds one producer warp.
TEAM = 256
#: Values of each chunk's first row that the touch body adds (one a thread).
TOUCH_BINS = 256
FMA_PASSES = 12


@dataclass(frozen=True)
class Layout:
    """How a CTA lays out its shared memory (``overlap_layout`` in
    ``csrc/probes.cu``): a ring of whole rows, each copied once a walk
    (``rows_once``), or of chunks; ``teams`` consumer teams; ``slots``
    slots of the ring; ``shared_bytes`` of dynamic shared memory."""
    rows_once: bool
    teams: int
    slots: int
    shared_bytes: int

    @property
    def threads(self) -> int:
        return self.teams * TEAM + 32


def ring_rows(ntaps: int, nbuf: int, teams: int) -> int:
    """Whole-row slots of the rows-once ring: a copying leg's ntaps rows of
    each team's frame (ntaps + teams - 1 together) and nbuf - 1 rows in
    flight; without the copy, the first frame's rows and a slot a team for
    its FIR (at least one slot beyond the frame's rows either way)."""
    return ntaps + teams - 1 + max(nbuf - 1, 1)


def shared_bytes(n: int, cb: int, ntaps: int, nbuf: int,
                 rows_once: bool = False, teams: int = 1) -> int:
    """Dynamic shared memory of a layout: the mbarriers, the ring (whole
    rows, or ``nbuf`` chunks of ``ntaps`` rows of ``cb`` complex64 bins and
    a work slot of n bins), and the n / 2 twiddles."""
    ring = (ring_rows(ntaps, nbuf, teams) * n if rows_once
            else nbuf * ntaps * cb + n)
    return BARRIER_BYTES + (ring + n // 2) * 8


def _layouts(n: int, cb: int, ntaps: int, nbuf: int):
    """The layouts in the order a CTA takes them: rows once with two teams
    (nbuf > 1, n <= 4096: a thread's 16 bins and its FFT in registers
    beside its sums), rows once with one team, chunked."""
    for rows_once, teams in ((True, 2), (True, 1), (False, 1)):
        if teams == 2 and (nbuf < 2 or n > 4096):
            continue
        slots = ring_rows(ntaps, nbuf, teams) if rows_once else nbuf
        if slots <= MAX_SLOTS:
            yield Layout(rows_once, teams, slots,
                         shared_bytes(n, cb, ntaps, nbuf, rows_once, teams))


def layout(n: int, cb: int, ntaps: int, nbuf: int, smem: int):
    """The layout a CTA with ``smem`` bytes of dynamic shared memory takes,
    or None if none fits: the mirror of the kernel's rule
    (:func:`kernel_layout`), for the CPU and for planning."""
    return next((lay for lay in _layouts(n, cb, ntaps, nbuf)
                 if lay.shared_bytes <= smem), None)


def kernel_layout(n: int, cb: int, ntaps: int, nbuf: int, smem: int):
    """The layout the kernel takes with ``smem`` bytes (``overlap_layout``
    in ``csrc/probes.cu``, through ``fxt_overlap_layout``: the rule its
    launches use), or None if none fits.  Needs the card's build."""
    from fxtpu_torch.cuda_build import load_kernels
    out = (ctypes.c_int * 5)()
    if load_kernels().fxt_overlap_layout(n, cb, ntaps, nbuf, smem, out):
        return None
    rows_once, teams, slots, threads, need = out
    lay = Layout(bool(rows_once), teams, slots, need)
    if lay.threads != threads:
        raise AssertionError(f"the kernel's CTA is {threads} threads, "
                             f"Layout.threads says {lay.threads}")
    return lay


def plan(n: int, cb: int, ntaps: int, nbuf: int, ctas_per_sm: int = 1):
    """The first layout of which ``ctas_per_sm`` CTAs share an SM's 227 KB
    (each block also takes 1 KB the system reserves), or None."""
    return next((lay for lay in _layouts(n, cb, ntaps, nbuf)
                 if ctas_per_sm * (lay.shared_bytes + 1024)
                 <= MAX_SHARED_BYTES), None)


def fits(n: int, cb: int, ntaps: int, nbuf: int, ctas_per_sm: int = 1
         ) -> bool:
    """True when a frame has at least ``nbuf`` chunks and ``ctas_per_sm``
    CTAs of some layout share an SM."""
    return nbuf <= n // cb and plan(n, cb, ntaps, nbuf,
                                    ctas_per_sm) is not None


def copy_bytes(grid: int, frames: int, ntaps: int, n: int) -> int:
    """Bytes one repeat of a copying leg brings in: every frame's
    ``ntaps`` rows of ``n`` complex64 (``dma_overlap_probe.py``'s ``NT x 2
    x 2 x ROWS x L x 4`` per repeat, its tile of two arrays of two planes
    of ROWS rows of L words being a frame of ROWS rows here)."""
    return grid * frames * ntaps * n * 8


def device_bytes(grid: int, frames: int, ntaps: int, n: int,
                 rows_once: bool) -> int:
    """Bytes one repeat of a copying leg's schedule reads from device
    memory: with the rows read once, each CTA's ``frames + ntaps - 1`` rows
    (the ntaps - 1 rows it shares with the next CTA read by both);
    chunked, :func:`copy_bytes`."""
    if rows_once:
        return grid * (frames + ntaps - 1) * n * 8
    return copy_bytes(grid, frames, ntaps, n)


def copied_bytes(device) -> int:
    """The bytes the probe's copies on ``device`` have asked for since the
    last call, as the kernel counts them (each CTA adds its threads' copies
    to a counter on the card, ``fxt_overlap_copied``); the count starts
    again at 0.  Waits for the device."""
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    out = (ctypes.c_ulonglong * 1)()
    with torch.cuda.device(device):
        rc = lib.fxt_overlap_copied(out)
    check(lib, rc, "overlap probe byte count")
    return out[0]


def counted_bytes_per_rep(src: torch.Tensor, lo: int, hi: int, **kw) -> int:
    """The bytes a repeat of a leg's copies asks for, as the kernel counts
    them: a launch at ``lo`` repeats and one at ``hi``, the difference over
    ``hi - lo`` (which drops the resident rows a leg without the copy takes
    once a launch).  ``kw`` as :func:`overlap_probe`'s, without ``reps``."""
    copied_bytes(src.device)
    overlap_probe(src, reps=lo, **kw)
    at_lo = copied_bytes(src.device)
    overlap_probe(src, reps=hi, **kw)
    return (copied_bytes(src.device) - at_lo) // (hi - lo)


def row_schedule(ntaps: int, nbuf: int, frames: int, teams: int = 1,
                 reps: int = 1) -> list:
    """The rows-once ring's schedule for one CTA of a copying leg, in an
    order the kernel may take, as events:

      ("copy", g, rep, row, slot)  copy g of the walk: the CTA's row
                                   ``row`` of repeat ``rep`` into ``slot``
      ("read", u, [(rep, row, slot), ...])  frame u reads its ntaps rows
      ("write", u, slot)           frame u's FIR output goes over ``slot``
      ("free", u, slot)            frame u's team releases ``slot``

    The kernel's rules: copy g goes to slot g mod S (S = ntaps + teams +
    nbuf - 2) once the slot's previous copy has been released (started by
    the producer warp under bulk, by the releasing team under cp.async); frame u of
    repeat r is walk frame f = u mod frames and reads copies g0 .. g0 +
    ntaps - 1, g0 = r (frames + ntaps - 1) + f; it writes over its first
    row's slot, with two teams after frame u - 1 has read; at its end it
    releases that slot and, as the repeat's last frame, its other rows'.
    The producer here copies as soon as a slot is free, and with two teams
    frame u - 1 ends after frame u has read and written, unless frame u's
    rows wait on the slots it releases (at a repeat's first frame)."""
    S = ntaps + teams + nbuf - 2
    per_rep = frames + ntaps - 1
    total, n_frames = reps * per_rep, reps * frames
    events, released, nxt = [], set(), [0]

    def produce():
        while nxt[0] < total and (nxt[0] < S or nxt[0] - S in released):
            g = nxt[0]
            events.append(("copy", g, g // per_rep, g % per_rep, g % S))
            nxt[0] += 1

    def first_copy(u):
        return (u // frames) * per_rep + u % frames

    def end(u):
        g0 = first_copy(u)
        done = [g0] + ([g0 + t for t in range(1, ntaps)]
                       if u % frames == frames - 1 else [])
        for g in done:
            released.add(g)
            events.append(("free", u, g % S))

    in_flight = []  # frames that have read and not yet ended
    for u in range(n_frames):
        produce()
        g0 = first_copy(u)
        if nxt[0] < g0 + ntaps and in_flight:
            # its rows wait on slots the frame in flight releases
            end(in_flight.pop(0))
            produce()
        events.append(("read", u, [((g0 + t) // per_rep, (g0 + t) % per_rep,
                                    (g0 + t) % S) for t in range(ntaps)]))
        events.append(("write", u, g0 % S))
        in_flight.append(u)
        if len(in_flight) == teams:  # a team ends a frame before its next
            end(in_flight.pop(0))
    for u in in_flight:
        end(u)
    produce()
    return events


def _check(src, n, cb, ntaps, frames, reps, nbuf, body, grid):
    if src.dtype != torch.complex64 or src.ndim != 2 or not src.is_contiguous():
        raise TypeError("src must be a contiguous complex64 [R, n] tensor")
    if body not in BODIES:
        raise ValueError(f"body {body!r} is not one of {BODIES}")
    if src.shape[1] != n or n & (n - 1) or not 256 <= n <= 8192:
        raise ValueError(f"n = {n} must be a power of two in [256, 8192] "
                         f"and src's row length ({src.shape[1]})")
    if (cb % 256 or n % cb or nbuf not in (1, 2, 4, 8)
            or nbuf > min(MAX_RING, n // cb)):
        raise ValueError(f"cb = {cb} must be a multiple of 256 dividing n, "
                         f"nbuf = {nbuf} a power of two, at most "
                         f"{MAX_RING} and n / cb")
    if ntaps < 2 or frames < 1 or reps < 1 or grid < 1:
        raise ValueError("ntaps >= 2, frames, reps and grid >= 1")
    if src.shape[0] < grid * frames + ntaps - 1:
        raise ValueError(f"src has {src.shape[0]} rows, the legs read "
                         f"{grid * frames + ntaps - 1}")


def _tap_weights(ntaps: int, device) -> torch.Tensor:
    """The fx body's taps, 0.25 + 0.01 t in float32."""
    t = np.arange(ntaps, dtype=np.float32)
    return torch.from_numpy(np.float32(0.25) + np.float32(0.01) * t
                            ).to(device)


def overlap_probe_reference(src: torch.Tensor, *, cb: int, ntaps: int,
                            frames: int, reps: int, nbuf: int, copy: bool,
                            body: str, grid: int) -> torch.Tensor:
    """The legs' checksums in plain torch -> complex64 ``[grid, n]``: for
    each CTA the sum over its ``reps x frames`` frames of the body's
    values.  With ``copy`` frame f of CTA b is rows ``b frames + f ..``;
    without it every frame is the CTA's resident chunks, chunk q of the
    frame being chunk ``q % nbuf`` of its first frame."""
    n = src.shape[1]
    _check(src, n, cb, ntaps, frames, reps, nbuf, body, grid)
    first = torch.arange(grid, device=src.device)[:, None] * frames
    if copy:
        f = first + torch.arange(frames, device=src.device)      # [grid, F]
        rows = src[f[..., None] + torch.arange(ntaps, device=src.device)]
    else:
        rows = src[first + torch.arange(ntaps, device=src.device)]
        rows = rows[:, None]                          # [grid, 1, ntaps, n]
        q = torch.arange(n, device=src.device)
        rows = rows[..., (q // cb % nbuf) * cb + q % cb]
    # rows: [grid, frames or 1, ntaps, n]
    if body == "touch":
        val = torch.zeros_like(rows[:, :, 0])
        chunks = rows[:, :, 0].reshape(*rows.shape[:2], n // cb, cb)
        val[..., :TOUCH_BINS] = chunks[..., :TOUCH_BINS].sum(dim=2)
    elif body == "fma":
        x, y = rows[:, :, 0].clone(), rows[:, :, 1].clone()
        for _ in range(FMA_PASSES):
            x = x * np.float32(1.0000001) + y
            y = y * np.float32(0.9999999) + x
        val = x
    else:
        w = _tap_weights(ntaps, src.device)
        fir = (w[:, None] * rows).sum(dim=2)
        val = stockham_stages(fir, n.bit_length() - 1)
    count = reps if copy else reps * frames
    return (val.sum(dim=1) * count).contiguous()


def overlap_probe(src: torch.Tensor, *, cb: int, ntaps: int, frames: int,
                  reps: int, nbuf: int, copy: bool, body: str, grid: int,
                  mech: str = "bulk", smem: int = 0) -> torch.Tensor:
    """One leg over ``src [R, n]`` -> complex64 ``[grid, n]`` checksums
    (:func:`overlap_probe_reference`'s contract).  ``smem`` (0: the first
    layout that fits, :func:`plan`) is the dynamic shared memory a CTA
    asks for: it decides the layout (:func:`layout`), and asking for more
    than half an SM's keeps one CTA per SM.

    A CPU tensor runs the plain version; a CUDA tensor launches
    ``fxt_overlap_probe`` or raises.  Each launch adds one to
    ``overlap_probe.launches``."""
    if mech not in MECHS:
        raise ValueError(f"mech {mech!r} is not one of {tuple(MECHS)}")
    kw = dict(cb=cb, ntaps=ntaps, frames=frames, reps=reps, nbuf=nbuf,
              copy=copy, body=body, grid=grid)
    if src.device.type == "cpu":
        return overlap_probe_reference(src, **kw)
    if src.device.type != "cuda":
        raise ValueError(f"overlap_probe runs on cuda or cpu, not "
                         f"{src.device}")
    n = src.shape[1]
    _check(src, n, cb, ntaps, frames, reps, nbuf, body, grid)
    if not smem:
        lay = plan(n, cb, ntaps, nbuf)
        smem = lay.shared_bytes if lay else 0
    lay = layout(n, cb, ntaps, nbuf, smem)
    if lay is None or smem > MAX_SHARED_BYTES:
        least = min(x.shared_bytes for x in _layouts(n, cb, ntaps, nbuf))
        raise ValueError(f"the leg needs at least {least} bytes of shared "
                         f"memory, asked for {smem} (at most "
                         f"{MAX_SHARED_BYTES})")
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    out = torch.empty((grid, n), dtype=torch.complex64, device=src.device)
    tw = _twiddles(n, src.device)
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        rc = lib.fxt_overlap_probe(
            src.data_ptr(), out.data_ptr(), tw.data_ptr(), n,
            n.bit_length() - 1, cb, ntaps, frames, reps, nbuf, int(copy),
            FMA_PASSES, BODIES.index(body), MECHS[mech], grid, smem, stream)
    check(lib, rc, f"overlap probe ({body}, {mech}) kernel launch")
    overlap_probe.launches += 1
    return out


overlap_probe.launches = 0

#: A single CTA on an SM: more than half the SM's shared memory.
ONE_CTA_BYTES = MAX_SHARED_BYTES // 2 + 2048


def check_leg(src, tol=2e-5, **kw):
    """Hold one leg against its plain version: within ``tol`` of
    max|plain| (the frame kernel's bound; the sums run in another order
    and the card fuses multiply and add)."""
    got = overlap_probe(src, **kw)
    want = overlap_probe_reference(
        src, **{k: v for k, v in kw.items() if k not in ("mech", "smem")})
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"overlap probe leg {kw}: {err / scale:.3g} of "
                             f"max|plain| > {tol}")
    return err / scale


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m fxtpu_torch.probes overlap", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(ap)
    ap.add_argument("--n", type=int, default=4096, help="bins of a row")
    ap.add_argument("--cb", type=int, default=512, help="bins of a chunk")
    ap.add_argument("--ntaps", type=int, default=4)
    ap.add_argument("--frames", type=int, default=32,
                    help="frames of a CTA at two CTAs per SM (a lone CTA "
                         "takes twice as many)")
    ap.add_argument("--mech", choices=tuple(MECHS), default="bulk")
    ap.add_argument("--reps", default="2,8",
                    help="the two repeat counts of the slope")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    n, cb, ntaps = args.n, args.cb, args.ntaps
    lo, hi = (int(v) for v in args.reps.split(","))
    sms = sm_count(device)
    records = []

    # the budget: which layouts fit, and how many CTAs of each an SM holds
    for name, rows_once, teams, nbuf in (
            ("rows once, two teams, a row in flight", True, 2, 2),
            ("rows once, one team, a row in flight", True, 1, 2),
            ("rows once, one team, serial", True, 1, 1),
            ("chunked, one slot", False, 1, 1),
            ("chunked, two slots", False, 1, 2),
            ("chunked, n / cb slots", False, 1, min(MAX_RING, n // cb))):
        need = shared_bytes(n, cb, ntaps, nbuf, rows_once, teams)
        emit(records, probe="overlap", budget=name, n=n, cb=cb, ntaps=ntaps,
             nbuf=nbuf, teams=teams, rows_read_once=rows_once,
             shared_bytes=need,
             ctas_per_sm=MAX_SHARED_BYTES // (need + 1024))

    rows = 2 * sms * args.frames + ntaps - 1
    gen = torch.Generator(device=device).manual_seed(args.seed)
    src = torch.view_as_complex(torch.randn(
        (rows, n, 2), device=device, dtype=torch.float32, generator=gen))
    on_card = device.type == "cuda"

    def run_leg(leg, structure, copy, body, nbuf, per_sm, frames, smem):
        """One leg: checked against its plain version, then on the card
        its layout and its copies' bytes read from the kernel and its
        slope timed; returns (record, ms a repeat or None)."""
        grid = per_sm * sms
        kw = dict(cb=cb, ntaps=ntaps, frames=frames, nbuf=nbuf, copy=copy,
                  body=body, grid=grid, mech=args.mech, smem=smem)
        err = check_leg(src, reps=lo, **kw)
        lay = layout(n, cb, ntaps, nbuf, smem)
        rec = dict(probe="overlap", leg=leg, structure=structure, body=body,
                   copy=copy, mech=args.mech, n=n, cb=cb, ntaps=ntaps,
                   nbuf=nbuf, grid=grid, frames_per_cta=frames,
                   shared_bytes=lay.shared_bytes, ctas_per_sm=per_sm,
                   rows_read_once=lay.rows_once, teams=lay.teams,
                   threads=lay.threads,
                   bytes_per_rep=copy_bytes(grid, frames, ntaps, n) * copy,
                   device_bytes_per_rep=None, max_rel_err=err, ms_lo=None,
                   ms_hi=None, ms_per_rep=None, card=card)
        if not on_card:
            return emit(records, **rec), None
        took = kernel_layout(n, cb, ntaps, nbuf, smem)
        if took != lay:
            raise AssertionError(f"{leg}: the kernel took {took}, "
                                 f"overlap.layout says {lay}")
        counted = counted_bytes_per_rep(src, lo, hi, **kw)
        if counted != device_bytes(grid, frames, ntaps, n,
                                   lay.rows_once) * copy:
            raise AssertionError(
                f"{leg}: the kernel's copies asked for {counted} bytes a "
                f"repeat, overlap.device_bytes says "
                f"{device_bytes(grid, frames, ntaps, n, lay.rows_once)}")
        ms_lo, ms_hi, per = slope_ms(
            lambda r: overlap_probe(src, reps=r, **kw), lo, hi)
        rec.update(device_bytes_per_rep=counted, ms_lo=ms_lo, ms_hi=ms_hi,
                   ms_per_rep=per, reps=[lo, hi])
        return emit(records, **rec), per

    def summary(structure, body, lay, t_copy, t_comp, t_both, **extra):
        emit(records, probe="overlap", summary=body, structure=structure,
             rows_read_once=lay.rows_once, teams=lay.teams, **extra,
             copy_ms=t_copy, comp_ms=t_comp,
             sum_ms=None if t_copy is None else t_copy + t_comp,
             max_ms=None if t_copy is None else max(t_copy, t_comp),
             measured_ms=t_both, card=card)

    for structure, (nbuf, per_sm) in STRUCTURES.items():
        if not fits(n, cb, ntaps, nbuf, per_sm):
            emit(records, probe="overlap", structure=structure, fits=False,
                 shared_bytes=min(x.shared_bytes
                                  for x in _layouts(n, cb, ntaps, nbuf)))
            continue
        frames = args.frames * 2 // per_sm
        lay = plan(n, cb, ntaps, nbuf, per_sm)
        smem = (lay.shared_bytes if per_sm > 1
                else max(lay.shared_bytes, ONE_CTA_BYTES))
        times = {}
        for leg, copy, body in (("copy", True, "touch"),
                                ("comp_fma", False, "fma"),
                                ("comp_fx", False, "fx"),
                                (structure, True, "fma"),
                                (structure, True, "fx")):
            times[(copy, body)] = run_leg(leg, structure, copy, body, nbuf,
                                          per_sm, frames, smem)[1]
        for body in ("fma", "fx"):
            summary(structure, body, lay, times[(True, "touch")],
                    times[(False, body)], times[(True, body)])

    # what reading each row once saves: the serial and pipelined structures'
    # fx legs again with chunks, each frame's ntaps rows copied again,
    # through the deepest chunk ring (up to a whole frame in flight) whose
    # shared memory leaves no room for the rows; one team, as the chunks
    # always have.  The occupancy structure's chunks pair with serial's.
    for structure in ("serial", "pipelined"):
        nbuf0, per_sm = STRUCTURES[structure]
        lay = plan(n, cb, ntaps, nbuf0)
        if lay is None or not lay.rows_once:
            continue
        for nbuf in ((1,) if nbuf0 == 1 else (8, 4, 2)):
            smem = max(shared_bytes(n, cb, ntaps, nbuf), ONE_CTA_BYTES)
            chunked = layout(n, cb, ntaps, nbuf, smem)
            if (nbuf <= n // cb and smem <= MAX_SHARED_BYTES
                    and not chunked.rows_once):
                break
        else:
            continue
        times = {}
        for leg, copy, body in (("copy_reread", True, "touch"),
                                ("comp_fx_reread", False, "fx"),
                                (f"{structure}_reread", True, "fx")):
            times[(copy, body)] = run_leg(leg, structure, copy, body, nbuf,
                                          per_sm, args.frames * 2, smem)[1]
        summary(f"{structure}_reread", "fx", chunked, times[(True, "touch")],
                times[(False, "fx")], times[(True, "fx")], nbuf=nbuf)
    return records
