"""What it costs to re-lay a FIR output ``[nbins]`` as ``[n1, n2]`` for a
four-step FFT's first stage.

Counterpart of ``scripts/retile_probe.py`` (``make_fn``), as the CUDA
kernel ``fxt_retile_probe`` in ``csrc/probes.cu``, with that script's
constants: frames of 4096 float32 in tiles of 16, ``[n1, n2] = [32,
128]``, 32 tile slots per repeat walked over 8 rotating source tiles.
Every frame slot's product ``m @ bf16(x2)`` (``m`` a ``[32, 32]`` matrix
of bf16 values, the script's MXU dot with float32 sums) runs on the
tensor cores: ``mma.m16n8k16`` with bf16 operands and float32 sums, warp
w of a CTA's four forming columns ``32 w .. 32 w + 31``, ``m``'s
fragments loaded once, the sums kept in registers across the CTA's slots.
The legs differ in how the frame reaches the mma's B fragments; each
takes the place of a TPU formulation:

  control        the frame arrives pre-tiled, ``[n2, n1]``: a thread's
                 four values of a fragment are one float4 (TPU
                 ``control``);
  transpose      the warp's ``[32, 32]`` block goes through shared memory
                 as bf16 ``[n2][n1]``, rows unpadded, then ``ldmatrix``
                 (TPU ``reshape``, the production form there);
  transpose_pad  the same with rows padded by 8 bf16 (TPU ``stack``);
  gather         each thread's float4s are loaded from the ``[n1, n2]``
                 frame straight into fragments, with no shared memory (TPU
                 ``gather``).

:func:`fragment_checksum` mirrors each leg's index arithmetic (loads,
staging, ``ldmatrix``, fragments, the mma's layouts) on the CPU.  All four
write the same checksum (the script's ``out``: the sum over all frame
slots of ``m @ bf16(x2)``); leg minus ``control`` is the layout's cost in
ps per sample.  Every slot loads its frame from L2 and forms its
products.  Beside them ``stockham`` runs radix-2 Stockham stages (``b[d]``,
``b[d + ns]``: the frame kernel's FFT up to its radix-16 redesign,
``fx_fused.stockham_stages``) over the same frames taken as 2048 complex
points: that access pattern's cost per stage.

    python -m fxtpu_torch.probes retile

prints one JSON line per leg (slope between ``--reps`` 64 and 1024: a
repeat takes about a microsecond on this card, so the script's 8 and 64
leave the two launches under a millisecond apart).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from fxtpu_torch.ops.fx_fused import _twiddles, stockham_stages
from fxtpu_torch.probes.common import (add_device_argument, card_line, emit,
                                       resolve_device, slope_ms, sm_count)

__all__ = ["FORMS", "NBINS", "TILE", "N1", "N2", "NT", "NSRC", "make_inputs",
           "launch_grid", "fragment_checksum", "retile_probe",
           "retile_reference", "stockham_reference", "main"]

FORMS = ("control", "transpose", "transpose_pad", "gather", "stockham")
NBINS = 4096
TILE = 16
N1, N2 = 32, 128          # the four-step factors of 4096
NT = 32                   # tile slots walked per repeat
NSRC = 8                  # rotating source tiles
STOCKHAM_POINTS = NBINS // 2
STOCKHAM_STAGES = 11
#: The layout legs (the tensor-core body) and their CTAs an SM.
LAYOUT_FORMS = FORMS[:4]
MMA_CTAS_PER_SM = 4
STOCKHAM_CTAS_PER_SM = 8


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


# --- the tensor-core legs' index arithmetic (csrc/probes.cu) --------------

def _permuted(form: str) -> bool:
    """control and gather permute a K step's rows so that a thread's four
    values of a fragment are one float4."""
    return form in ("control", "gather")


def _kj(form: str, k: int) -> int:
    """x2's row, within a K step of 16, of a fragment's row k."""
    if _permuted(form):
        return 4 * ((k & 7) >> 1) + 2 * (k >> 3) + (k & 1)
    return k


def _column(form: str, warp: int, t: int, n: int) -> int:
    """x2's column of column n of N tile t of a warp's 32."""
    return 32 * warp + (4 * n + t if _permuted(form) else 8 * t + n)


def _pitch(form: str) -> int:
    """bf16 elements in a row of a warp's staged block."""
    return N1 + 8 if form == "transpose_pad" else N1


def _loads(form: str, warp: int, lane: int) -> list:
    """The flat index, into a frame of the form's array (``xt`` for
    control, else ``x``), of the first float of each of a thread's eight
    float4 loads."""
    r, c, nbase = lane >> 2, lane & 3, 32 * warp
    out = []
    for i in range(8):
        if form == "gather":        # row 16 kk + 4 c + j4, 4 columns
            out.append((16 * (i >> 2) + 4 * c + (i & 3)) * N2 + nbase + 4 * r)
        elif form == "control":     # column 4 r + t, 4 rows
            out.append((nbase + 4 * r + (i & 3)) * N1 + 16 * (i >> 2) + 4 * c)
        else:                       # row 2 rp + (i & 1) of the warp's block
            row = 2 * ((lane >> 3) + 4 * (i >> 1)) + (i & 1)
            out.append(row * N2 + nbase + 4 * (lane & 7))
    return out


def _staged(form: str, warp: int) -> dict:
    """A transpose's staged block: bf16 element -> the frame's flat index
    stored there (each lane's rows 2 rp, 2 rp + 1 as pairs at [4 q + e,
    2 rp])."""
    p, stage = _pitch(form), {}
    for lane in range(32):
        ld = _loads(form, warp, lane)
        for i in range(4):
            rp, q = (lane >> 3) + 4 * i, lane & 7
            for e in range(4):
                for h in range(2):
                    stage[(4 * q + e) * p + 2 * rp + h] = ld[2 * i + h] + e
    return stage


def _b_registers(form: str, warp: int, t: int, lane: int, stage=None):
    """A thread's B fragments of N tile t: ``[K step][register][half]`` ->
    the frame's flat index."""
    c = lane & 3
    if form in ("transpose", "transpose_pad"):
        p = _pitch(form)

        def addr(ln):       # the row lane ln hands ldmatrix
            return (8 * t + (ln & 7)) * p + 8 * (ln >> 3)
        mats = [[stage[addr(8 * mi + (lane >> 2)) + 2 * c + h]
                 for h in range(2)] for mi in range(4)]
        return [[mats[2 * kk], mats[2 * kk + 1]] for kk in range(2)]
    ld = _loads(form, warp, lane)
    if form == "gather":
        return [[[ld[4 * kk + 2 * g] + t, ld[4 * kk + 2 * g + 1] + t]
                 for g in range(2)] for kk in range(2)]
    return [[[ld[4 * kk + t] + 2 * g, ld[4 * kk + t] + 2 * g + 1]
             for g in range(2)] for kk in range(2)]


def _a_registers(form: str, mu: int, kk: int, lane: int):
    """A thread's A fragment of M tile mu, K step kk: ``[register][half]``
    -> (row, column) of m."""
    r, c = lane >> 2, lane & 3
    return [[(16 * mu + r + 8 * (g & 1),
              16 * kk + _kj(form, 2 * c + 8 * (g >> 1) + h))
             for h in range(2)] for g in range(4)]


def fragment_checksum(x: torch.Tensor, xt: torch.Tensor, m: torch.Tensor,
                      form: str, nt: int = NT, reps: int = 1
                      ) -> torch.Tensor:
    """A layout leg's checksum formed as its kernel forms it, on the CPU:
    each thread's loads (and a transpose's staged block and ``ldmatrix``)
    into A and B fragments, the fragments placed by ``mma.m16n8k16``'s
    layouts (A: rows r, r + 8 and columns 2 c, 2 c + 8 of register 0 .. 3;
    B: rows 2 c, 2 c + 8 of column r; C: rows r, r + 8, columns 2 c, 2 c +
    1), the tile products, and the accumulators written back by the form's
    columns, for every source frame, then weighted by the slots that read
    it -> float32 ``[N1, N2]``, :func:`retile_reference`'s checksum."""
    if form not in LAYOUT_FORMS:
        raise ValueError(f"form {form!r} is not one of {LAYOUT_FORMS}")
    frames = (xt if form == "control" else x).bfloat16().double()
    mm = m.bfloat16().double()
    nsrc = frames.shape[0]
    out = torch.zeros((nsrc, N1, N2), dtype=torch.float64)
    a = torch.zeros((2, 2, 16, 16), dtype=torch.float64)   # [mu, kk]
    for mu in range(2):
        for kk in range(2):
            for lane in range(32):
                r, c = lane >> 2, lane & 3
                for g, pair in enumerate(_a_registers(form, mu, kk, lane)):
                    for h, (row, col) in enumerate(pair):
                        a[mu, kk, r + 8 * (g & 1),
                          2 * c + 8 * (g >> 1) + h] = mm[row, col]
    for warp in range(N2 // 32):
        stage = (_staged(form, warp) if form in ("transpose", "transpose_pad")
                 else None)
        for t in range(4):
            b = torch.zeros((2, nsrc, 16, 8), dtype=torch.float64)
            for lane in range(32):
                r, c = lane >> 2, lane & 3
                regs = _b_registers(form, warp, t, lane, stage)
                for kk in range(2):
                    for g in range(2):
                        for h in range(2):
                            b[kk, :, 2 * c + 8 * g + h, r] = \
                                frames[:, regs[kk][g][h]]
            for mu in range(2):
                d = a[mu, 0] @ b[0] + a[mu, 1] @ b[1]     # [nsrc, 16, 8]
                for lane in range(32):
                    r, c = lane >> 2, lane & 3
                    for e in range(2):
                        col = _column(form, warp, t, 2 * c + e)
                        out[:, 16 * mu + r, col] = d[:, r, 2 * c + e]
                        out[:, 16 * mu + r + 8, col] = d[:, r + 8, 2 * c + e]
    counts = _slot_counts(nsrc, reps * nt * TILE, "cpu").double()
    return (out * counts[:, None, None]).sum(dim=0).float()


def launch_grid(form: str, slots: int, nsrc: int, sms: int) -> int:
    """CTAs of a launch: 4 an SM for the tensor-core legs (128 registers a
    thread), 8 for stockham, at most one a slot; never a multiple of
    ``nsrc`` above it, so that a CTA does not meet the same source frame at
    every slot."""
    per_sm = STOCKHAM_CTAS_PER_SM if form == "stockham" else MMA_CTAS_PER_SM
    grid = min(per_sm * sms, slots)
    if grid > nsrc and grid % nsrc == 0:
        grid -= 1
    return grid


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
    :func:`stockham_reference`'s).  CTAs of 128 threads share the slots
    (:func:`launch_grid`); their partial checksums are summed here.

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
    grid = launch_grid(form, slots, x.shape[0], sm_count(x.device))
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
    ap.add_argument("--reps", default="64,1024",
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
