"""What it costs to re-lay a FIR output ``[nbins]`` as ``[n1, n2]`` for a
four-step FFT's first stage.

Counterpart of ``scripts/retile_probe.py`` (``make_fn``), as the CUDA
kernel ``fxt_retile_probe`` in ``csrc/probes.cu``, with that script's
constants: frames of 4096 float32 in tiles of 16, ``[n1, n2] = [32,
128]``, 32 tile slots per repeat walked over 8 rotating source tiles.
Thread i2 of a CTA owns column i2 of the frame's ``[n1, n2]`` matrix and
runs the script's body on it, ``acc += m @ bf16(x2)`` with ``m`` a ``[32,
32]`` matrix of bf16 values (one frame's ``[32, 32] @ [32, 128]`` dot).
The legs differ in how the column reaches the thread's registers; each
takes the place of a TPU formulation:

  control        the frame arrives pre-tiled, ``[n2, n1]``: the thread
                 loads its own 128 bytes (TPU ``control``);
  transpose      the ``[n1, n2]`` frame goes through shared memory laid
                 ``[n2][n1]``, unpadded: every thread of a warp on one
                 bank (TPU ``reshape``, the production form there);
  transpose_pad  the same with rows padded by one float: no two threads
                 on one bank (TPU ``stack``);
  gather         each thread loads its 32 strided elements itself, with
                 no shared memory (TPU ``gather``).

All four write the same checksum (the script's ``out``: the sum over all
frame slots of ``m @ bf16(x2)``); leg minus ``control`` is the layout's
cost in ps per sample.  Beside them ``stockham`` runs radix-2 Stockham
stages (``b[d]``, ``b[d + ns]``: the frame kernel's FFT up to its
radix-16 redesign, ``fx_fused.stockham_stages``) over the same frames
taken as 2048 complex points: that access pattern's cost per stage.

    python -m fxtpu_torch.probes retile

prints one JSON line per leg (slope between ``--reps`` 32 and 256: the
script's 8 and 64 leave a launch under a millisecond on this card).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fxtpu_torch.ops.fx_fused import _twiddles, stockham_stages
from fxtpu_torch.probes.common import (add_device_argument, card_line, emit,
                                       resolve_device, slope_ms, sm_count)

__all__ = ["FORMS", "NBINS", "TILE", "N1", "N2", "NT", "NSRC", "make_inputs",
           "retile_probe", "retile_reference", "stockham_reference", "main"]

FORMS = ("control", "transpose", "transpose_pad", "gather", "stockham")
NBINS = 4096
TILE = 16
N1, N2 = 32, 128          # the four-step factors of 4096
NT = 32                   # tile slots walked per repeat
NSRC = 8                  # rotating source tiles
STOCKHAM_POINTS = NBINS // 2
STOCKHAM_STAGES = 11


def make_inputs(device, seed: int = 7):
    """``(x [NSRC TILE, NBINS], xt, m [N1, N1])`` float32 on ``device``,
    drawn as ``scripts/retile_probe.py`` draws them (numpy, seed 7): ``xt``
    holds each frame's ``[n1, n2]`` matrix transposed, the pre-tiled copy
    ``control`` reads, and ``m`` is rounded to bf16."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(NSRC * TILE, NBINS)).astype(np.float32)
    m = rng.normal(size=(N1, N1)).astype(np.float32)
    xt = np.ascontiguousarray(
        x.reshape(-1, N1, N2).transpose(0, 2, 1)).reshape(-1, NBINS)
    return (torch.from_numpy(x).to(device), torch.from_numpy(xt).to(device),
            torch.from_numpy(m).bfloat16().float().to(device))


def _slot_counts(nsrc: int, slots: int, device) -> torch.Tensor:
    """How many of ``slots`` frame slots read each source frame (slot g
    reads frame ``g % nsrc``)."""
    g = torch.arange(nsrc, device=device)
    return (slots // nsrc + (g < slots % nsrc)).to(torch.float32)


def retile_reference(x: torch.Tensor, m: torch.Tensor, nt: int = NT,
                     reps: int = 1) -> torch.Tensor:
    """The four layout legs' checksum in plain torch -> float32 ``[N1,
    N2]``: the sum over the ``reps x nt x TILE`` frame slots of ``m @
    bf16(x2)``, x2 the slot's frame as ``[N1, N2]``."""
    x2 = x.bfloat16().float().reshape(-1, N1, N2)
    per_frame = torch.matmul(m, x2)                       # [nsrc, N1, N2]
    counts = _slot_counts(x.shape[0], reps * nt * TILE, x.device)
    return (per_frame * counts[:, None, None]).sum(dim=0)


def stockham_reference(x: torch.Tensor, nt: int = NT,
                       reps: int = 1) -> torch.Tensor:
    """The ``stockham`` leg's checksum in plain torch -> float32 ``[N1,
    N2]``: each frame as 2048 complex points through the 11 radix-2
    stages, summed over the frame slots; point ``i2 + 128 j`` lands at
    ``[2 j, i2]`` (real) and ``[2 j + 1, i2]`` (imaginary)."""
    pts = torch.view_as_complex(x.reshape(-1, STOCKHAM_POINTS, 2).contiguous())
    spec = stockham_stages(pts, STOCKHAM_STAGES)
    counts = _slot_counts(x.shape[0], reps * nt * TILE, x.device)
    total = (spec * counts[:, None]).sum(dim=0)           # [2048]
    parts = torch.view_as_real(total.reshape(N1 // 2, N2))  # [j, i2, 2]
    return parts.permute(0, 2, 1).reshape(N1, N2).contiguous()


def _check(x, xt, m):
    for name, t in (("x", x), ("xt", xt), ("m", m)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise TypeError(f"{name} must be contiguous float32")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.ndim != 2 or x.shape[1] != NBINS or xt.shape != x.shape:
        raise ValueError(f"x and xt must be [frames, {NBINS}], got "
                         f"{tuple(x.shape)} and {tuple(xt.shape)}")
    if m.shape != (N1, N1):
        raise ValueError(f"m must be [{N1}, {N1}], got {tuple(m.shape)}")


def retile_probe(x: torch.Tensor, xt: torch.Tensor, m: torch.Tensor,
                 form: str, nt: int = NT, reps: int = 1) -> torch.Tensor:
    """One leg over the ``reps x nt x TILE`` frame slots -> float32
    ``[N1, N2]`` checksum (:func:`retile_reference`'s, or for ``stockham``
    :func:`stockham_reference`'s).  Eight CTAs of 128 threads per SM share
    the slots; their partial checksums are summed here.

    CPU tensors run the plain version; CUDA tensors launch
    ``fxt_retile_probe`` or raise.  Each launch adds one to
    ``retile_probe.launches``."""
    if form not in FORMS:
        raise ValueError(f"form {form!r} is not one of {FORMS}")
    if x.device.type == "cpu":
        if form == "stockham":
            return stockham_reference(x, nt, reps)
        return retile_reference(x, m, nt, reps)
    if x.device.type != "cuda":
        raise ValueError(f"retile_probe runs on cuda or cpu, not {x.device}")
    _check(x, xt, m)
    if nt < 1 or reps < 1:
        raise ValueError("nt and reps must be >= 1")
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    slots = reps * nt * TILE
    grid = min(8 * sm_count(x.device), slots)
    out = torch.empty((grid, N1, N2), dtype=torch.float32, device=x.device)
    tw = _twiddles(STOCKHAM_POINTS, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fxt_retile_probe(
            x.data_ptr(), xt.data_ptr(), m.data_ptr(), tw.data_ptr(),
            out.data_ptr(), x.shape[0], nt * TILE, reps, FORMS.index(form),
            grid, stream)
    check(lib, rc, f"retile probe ({form}) kernel launch")
    retile_probe.launches += 1
    return out.sum(dim=0)


retile_probe.launches = 0


def check_form(x, xt, m, form, nt=NT, reps=1, tol=1e-5):
    """Hold one leg against its plain version, within ``tol`` of
    max|plain| (float32 sums in another order)."""
    got = retile_probe(x, xt, m, form, nt, reps)
    want = (stockham_reference(x, nt, reps) if form == "stockham"
            else retile_reference(x, m, nt, reps))
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"retile probe {form}: {err / scale:.3g} of "
                             f"max|plain| > {tol}")
    return err / scale


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m fxtpu_torch.probes retile", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(ap)
    ap.add_argument("--nt", type=int, default=NT,
                    help="tile slots (of 16 frames) walked per repeat")
    ap.add_argument("--reps", default="32,256",
                    help="the two repeat counts of the slope")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    lo, hi = (int(v) for v in args.reps.split(","))
    x, xt, m = make_inputs(device, args.seed)
    samples = args.nt * TILE * NBINS
    records, base = [], None
    for form in FORMS:
        err = check_form(x, xt, m, form, args.nt, lo)
        rec = dict(probe="retile", form=form, nt=args.nt, tile=TILE,
                   nbins=NBINS, samples_per_rep=samples, max_rel_err=err,
                   ms_lo=None, ms_hi=None, us_per_tile=None,
                   ps_per_sample=None, ps_vs_control=None, card=card)
        if device.type == "cuda":
            ms_lo, ms_hi, per = slope_ms(
                lambda r: retile_probe(x, xt, m, form, args.nt, r), lo, hi)
            ps = per * 1e9 / samples
            if form == "control":
                base = ps
            rec.update(ms_lo=ms_lo, ms_hi=ms_hi,
                       us_per_tile=per * 1e3 / args.nt, ps_per_sample=ps,
                       ps_vs_control=(None if form == "stockham"
                                      else ps - base), reps=[lo, hi])
            if form == "stockham":
                rec["ps_per_sample_per_stage"] = ps / STOCKHAM_STAGES
        emit(records, **rec)
    return records
