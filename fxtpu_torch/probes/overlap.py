"""Does a copy into shared memory hide behind the frame's arithmetic?

Counterpart of ``scripts/dma_overlap_probe.py`` (``make_kernel`` /
``make_2d_kernel``), as the CUDA kernel ``fxt_overlap_probe`` in
``csrc/probes.cu``.  A CTA works through frames of an ``[R, n]``
complex64 array; frame f reads rows ``f .. f + ntaps - 1``, as the frame
kernel's FIR does, in chunks of ``cb`` bins that stream through a ring of
``nbuf`` slots in shared memory.  Legs, each with the TPU leg whose place
it takes:

  copy       the chunks are copied and 256 values of each are touched,
             no body (TPU ``dma``);
  comp_fma   no copy, the body alone: multiply-add passes through shared
             memory over resident chunks (TPU ``vcomp``);
  comp_fx    no copy, the production-shaped body in miniature: a 4-tap FIR
             and log2 n Stockham stages on resident chunks (TPU ``mix``);
  serial     copy a chunk, wait, run the body, one CTA per SM: nothing
             can overlap;
  occupancy  the same with two CTAs per SM: the scheduler overlaps one
             CTA's copy with the other's body, what the frame kernel
             relies on today with its 98 KB per CTA;
  pipelined  a ring of two slots, chunk g + 1 in flight while the body
             runs on chunk g, one CTA per SM (TPU ``dyn`` / ``vdyn`` /
             ``dynmix``).

The TPU's ``dyn`` against ``static`` question (does a dynamic slot index
serialise the pipeline) and its ``dyn2d`` leg are about its compiler and
have no counterpart here.  The copy is ``cp.async`` or the bulk copy
(``--mech``).  Every leg does the same work, the same frames; ``copy`` and
``comp_*`` are measured in each of the structures, and for each
structure and body the probe prints sum(copy, comp), max(copy, comp) and
the measured time, as ``dma_overlap_probe.py`` does: measured near the
sum means the body serialises against the copy, near the max that they
overlap.

Shared memory, reckoned first (:func:`shared_bytes`): at the flagship (n
= 4096, 4 taps) a ring of ntaps + 1 whole complex64 rows is 5 x 32 KB
beside 64 KB of FFT buffers, 224 KB of the 227 KB a block may have and
so one channel at most; the probe therefore streams chunks of ``cb`` bins
of the ntaps rows: at cb = 512 a slot is 16 KB, one slot and the buffers
80 KB (two CTAs per SM), two slots 96 KB, eight 192 KB.

    python -m fxtpu_torch.probes overlap [--n 4096 --cb 512 --mech bulk]

prints one JSON line per leg and one per (structure, body) summary.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fxtpu_torch.ops.fx_fused import _twiddles, stockham_stages
from fxtpu_torch.probes.common import (MAX_SHARED_BYTES, add_device_argument,
                                       card_line, emit, resolve_device,
                                       slope_ms, sm_count)

__all__ = ["BODIES", "MECHS", "STRUCTURES", "shared_bytes", "fits",
           "copy_bytes", "overlap_probe", "overlap_probe_reference", "main"]

BODIES = ("touch", "fma", "fx")
MECHS = {"cp_async": 1, "bulk": 2}
#: structure -> (ring slots, CTAs per SM)
STRUCTURES = {"serial": (1, 1), "occupancy": (1, 2), "pipelined": (2, 1)}
#: Most slots of the ring (kMaxRing).
MAX_RING = 8
#: Values of each chunk's first row that the touch body adds (one a thread).
TOUCH_BINS = 256
FMA_PASSES = 12


def shared_bytes(n: int, cb: int, ntaps: int, nbuf: int) -> int:
    """Dynamic shared memory of a leg: the ring of ``nbuf`` chunks of
    ``ntaps`` rows of ``cb`` complex64 bins, and two n-point buffers."""
    return (nbuf * ntaps * cb + 2 * n) * 8


def fits(n: int, cb: int, ntaps: int, nbuf: int, ctas_per_sm: int = 1
         ) -> bool:
    """True when a frame has at least ``nbuf`` chunks and ``ctas_per_sm``
    CTAs of that leg share an SM's 227 KB (each block also takes 1 KB the
    system reserves)."""
    return (nbuf <= n // cb
            and ctas_per_sm * (shared_bytes(n, cb, ntaps, nbuf) + 1024)
            <= MAX_SHARED_BYTES)


def copy_bytes(grid: int, frames: int, ntaps: int, n: int) -> int:
    """Bytes one repeat of a copying leg brings in: every frame's
    ``ntaps`` rows of ``n`` complex64 (``dma_overlap_probe.py``'s ``NT x 2
    x 2 x ROWS x L x 4`` per repeat, its tile of two arrays of two planes
    of ROWS rows of L words being a frame of ROWS rows here)."""
    return grid * frames * ntaps * n * 8


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
    (:func:`overlap_probe_reference`'s contract).  ``smem`` (0: what the
    leg needs) is the dynamic shared memory a CTA asks for: asking for
    more than half an SM's keeps one CTA per SM.

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
    need = shared_bytes(n, cb, ntaps, nbuf)
    smem = smem or need
    if not need <= smem <= MAX_SHARED_BYTES:
        raise ValueError(f"the leg needs {need} bytes of shared memory, "
                         f"asked for {smem} (at most {MAX_SHARED_BYTES})")
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
    ap.add_argument("--reps", default="1,3",
                    help="the two repeat counts of the slope")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    n, cb, ntaps = args.n, args.cb, args.ntaps
    lo, hi = (int(v) for v in args.reps.split(","))
    sms = sm_count(device)
    records = []

    # the budget: which rings fit beside the two n-point buffers
    for name, ring_cb, nbuf in (("whole rows, ntaps + 1", n, None),
                                ("chunked, one slot", cb, 1),
                                ("chunked, two slots", cb, 2),
                                ("chunked, n / cb slots", cb,
                                 min(MAX_RING, n // cb))):
        if nbuf is None:    # a ring of ntaps + 1 whole rows
            need = ((ntaps + 1) * n + 2 * n) * 8
        else:
            need = shared_bytes(n, ring_cb, ntaps, nbuf)
        emit(records, probe="overlap", budget=name, n=n, cb=ring_cb,
             ntaps=ntaps, shared_bytes=need,
             ctas_per_sm=MAX_SHARED_BYTES // (need + 1024),
             channels_resident=1)

    rows = 2 * sms * args.frames + ntaps - 1
    gen = torch.Generator(device=device).manual_seed(args.seed)
    src = torch.view_as_complex(torch.randn(
        (rows, n, 2), device=device, dtype=torch.float32, generator=gen))
    times = {}
    for structure, (nbuf, per_sm) in STRUCTURES.items():
        if not fits(n, cb, ntaps, nbuf, per_sm):
            emit(records, probe="overlap", structure=structure, fits=False,
                 shared_bytes=shared_bytes(n, cb, ntaps, nbuf))
            continue
        grid = per_sm * sms
        frames = args.frames * 2 // per_sm
        need = shared_bytes(n, cb, ntaps, nbuf)
        smem = need if per_sm > 1 else max(need, ONE_CTA_BYTES)
        for leg, copy, body in (("copy", True, "touch"),
                                ("comp_fma", False, "fma"),
                                ("comp_fx", False, "fx"),
                                (structure, True, "fma"),
                                (structure, True, "fx")):
            kw = dict(cb=cb, ntaps=ntaps, frames=frames, nbuf=nbuf,
                      copy=copy, body=body, grid=grid, mech=args.mech,
                      smem=smem)
            err = check_leg(src, reps=lo, **kw)
            rec = dict(probe="overlap", leg=leg, structure=structure,
                       body=body, copy=copy, mech=args.mech, n=n, cb=cb,
                       ntaps=ntaps, grid=grid, frames_per_cta=frames,
                       shared_bytes=need, ctas_per_sm=per_sm,
                       bytes_per_rep=copy_bytes(grid, frames, ntaps, n) * copy,
                       max_rel_err=err, ms_lo=None, ms_hi=None,
                       ms_per_rep=None, card=card)
            if device.type == "cuda":
                ms_lo, ms_hi, per = slope_ms(
                    lambda r: overlap_probe(src, reps=r, **kw), lo, hi)
                rec.update(ms_lo=ms_lo, ms_hi=ms_hi, ms_per_rep=per,
                           reps=[lo, hi])
                times[(structure, copy, body)] = per
            emit(records, **rec)
        for body in ("fma", "fx"):
            t_copy = times.get((structure, True, "touch"))
            t_comp = times.get((structure, False, body))
            t_both = times.get((structure, True, body))
            emit(records, probe="overlap", summary=body, structure=structure,
                 copy_ms=t_copy, comp_ms=t_comp,
                 sum_ms=None if t_copy is None else t_copy + t_comp,
                 max_ms=None if t_copy is None else max(t_copy, t_comp),
                 measured_ms=t_both, card=card)
    return records
