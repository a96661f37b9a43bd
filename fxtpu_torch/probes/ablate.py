"""Where the fused step's time goes, stage by stage.

Counterpart of ``scripts/fused_ablate.py`` (its harness, ``main``): the
fused FX step over K blocks per launch with the frame kernel truncated
after a stage (``ops.fx_fused.fx_fused_ablate``; ``csrc/fx_fused.cu``'s
stage tags), timed with CUDA events, ms per block and GS/s per stage, then
the differences between consecutive stages:

  load                 every tap row read as the FIR reads it and summed
                       with unit weights (TPU ``STAGE=dma``); ``load_raw``
                       the same without the DC correction and, for 8-bit
                       samples, without the dequantisation (TPU ``dma0``);
  fir - load           the window and the multiply-adds (TPU ``fir``);
  fft_half - fir       the first log2(n) // 2 Stockham stages (``fft1``);
  fft - fft_half       the rest of them, with no X stage (``fft2``);
  full - fft           the X stage and the partials written out.

Every stage but ``fft`` still runs the X stage over what it left, so a
difference between two of them is the stage's own arithmetic.  The mean
pre-pass and the reduce run in every stage alike and cancel in the
differences; their own device times per block, and the frame kernel's,
come from a ``torch.profiler`` trace of each stage (``device_us``) and
stand beside the event times.  The
script's TPU levers (``CMM``, ``SPLITDMA``, ``GRIDK``, ``ALT``, ``TWOIN``,
``HOUT``) are about its compiler's lowering and are not options here.

    python -m fxtpu_torch.probes ablate [--stage all --nbins 4096 --ntaps 4
        --num_samp 2097152 --k 8 --ingest complex64 --fir_mode auto]

prints one JSON line per stage, then one line of differences: of the
event times, and of the frame kernel's device times, which are the ones to
read where a launch is too short for its event time to be more than the
host's enqueue (a one-block launch at the flagship).
"""

from __future__ import annotations

import argparse
import statistics

import numpy as np
import torch

from fxtpu_torch.ops import fx_fused as ff
from fxtpu_torch.ops.svd_fir import deep_svd_applies
from fxtpu_torch.ops.window import pfb_window
from fxtpu_torch.ops.xengine import baseline_pairs
from fxtpu_torch.probes.common import (add_device_argument, card_line,
                                       device_events, emit, event_ms,
                                       resolve_device)

__all__ = ["ORDER", "make_inputs", "kernel_durations", "device_times",
           "main"]

#: The stages in the order their differences are taken.
ORDER = ("load_raw", "load", "fir", "fft_half", "fft", "full")
QUANT_STEP = 1.0 / 32
#: Substrings of the three kernels' names in a profiler trace.
KERNELS = {"prepass": "mean_partial_kernel", "frames": "fx_frames_kernel",
           "reduce": "fx_reduce"}


def make_inputs(device, *, nch, k, num_samp, nbins, ntaps, ingest, fir_mode,
                seed=0):
    """``(x, history, window2d, pairs, quant_step, svd)`` of one K-block
    call: noise with a DC offset per channel, made on ``device`` from
    ``seed``; a zero history; the engine's window; ``svd`` the window's
    factors when ``fir_mode`` is ``"svd"``, or ``"auto"`` and the engine
    would choose them (``ops.svd_fir.deep_svd_applies``)."""
    s_rows = num_samp // nbins
    w_np = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    window2d = torch.as_tensor(w_np, device=device)
    svd = None
    if fir_mode == "svd" or (fir_mode == "auto"
                             and deep_svd_applies(w_np, nbins)):
        svd = ff.svd_tensors(w_np, device)
        if svd is None:
            raise ValueError(f"the {ntaps}-tap window does not factorise")
    pairs = ff.pairs_tensor(baseline_pairs(nch), nch, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dc = torch.arange(1, nch + 1, device=device, dtype=torch.float32)
    if ingest == "int8":
        noise = torch.randn((nch, k, s_rows, nbins, 2), device=device,
                            generator=gen)
        x = (30 * noise + 3 * dc[:, None, None, None, None]).round_().clamp_(
            -127, 127).to(torch.int8)
        history = {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                       dtype=torch.int8, device=device),
                   "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                          device=device)}
        return x, history, window2d, pairs, QUANT_STEP, svd
    x = torch.view_as_complex(
        torch.randn((nch, k, s_rows, nbins, 2), device=device, generator=gen)
        + 0.3 * dc[:, None, None, None, None])
    history = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                          device=device)
    return x, history, window2d, pairs, None, svd


def kernel_durations(fn, n: int = 10) -> dict:
    """Device microseconds of every launch of the mean pre-pass, the frame
    kernel and the reduce during ``n`` calls of ``fn``, which launches
    each once, read from a CUDA-only ``torch.profiler`` trace
    (``common.device_events``) -> ``{kernel: [us] * n}``.  Raises when the
    trace does not show ``n`` launches of each."""
    fn()
    torch.cuda.synchronize()
    kernels = [e for e in device_events(fn, n) if e["cat"] == "kernel"]
    durs = {key: [e["dur"] for e in kernels if name in e["name"]]
            for key, name in KERNELS.items()}
    if any(len(v) != n for v in durs.values()):
        raise RuntimeError(
            f"the trace of {n} calls shows "
            f"{ {k: len(v) for k, v in durs.items()} } launches")
    return durs


def device_times(fn, n: int = 10) -> dict:
    """Median device microseconds per launch of the mean pre-pass, the
    frame kernel and the reduce (``fn`` launches each once) over ``n``
    calls of ``fn``."""
    return {key: statistics.median(durs)
            for key, durs in kernel_durations(fn, n).items()}


def _differences(times: dict):
    """Each stage's time less the stage before it in :data:`ORDER`
    (``load`` as it is; ``load_raw`` stands beside the chain, as ``load -
    load_raw``), or None when fewer than two stages were timed."""
    diffs, prev = {}, None
    for stage in ORDER[1:]:
        if stage in times:
            name = stage if prev is None else f"{stage} - {prev}"
            diffs[name] = times[stage] - (times[prev] if prev else 0.0)
            prev = stage
    if "load" in times and "load_raw" in times:
        diffs["load - load_raw"] = times["load"] - times["load_raw"]
    return diffs if len(times) > 1 else None


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        prog="python -m fxtpu_torch.probes ablate", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_device_argument(ap)
    ap.add_argument("--stage", default="all",
                    help=f"one of {ORDER}, or all")
    ap.add_argument("--nch", type=int, default=2)
    ap.add_argument("--nbins", type=int, default=4096)
    ap.add_argument("--ntaps", type=int, default=4)
    ap.add_argument("--num_samp", type=int, default=2**21,
                    help="samples of a block, per channel")
    ap.add_argument("--k", type=int, default=8, help="blocks per launch")
    ap.add_argument("--ingest", choices=("complex64", "int8"),
                    default="complex64")
    ap.add_argument("--fir_mode", choices=("auto", "direct", "svd"),
                    default="auto")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed launches per stage")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    stages = ORDER if args.stage == "all" else (args.stage,)
    for stage in stages:
        if stage not in ORDER:
            raise ValueError(f"--stage {stage!r} is not one of {ORDER}")
    device = resolve_device(args.device)
    card = card_line(device)
    x, hist, w, pairs, step, svd = make_inputs(
        device, nch=args.nch, k=args.k, num_samp=args.num_samp,
        nbins=args.nbins, ntaps=args.ntaps, ingest=args.ingest,
        fir_mode=args.fir_mode, seed=args.seed)
    shape = dict(nch=args.nch, k=args.k, num_samp=args.num_samp,
                 nbins=args.nbins, ntaps=args.ntaps, ingest=args.ingest,
                 fir_mode="direct" if svd is None else "svd",
                 rank=0 if svd is None else int(svd[0].shape[1]))
    samples = args.nch * (args.num_samp // args.nbins) * args.nbins
    records, ms = [], {}
    for stage in stages:
        def call(stage=stage):
            return ff.fx_fused_ablate(x, hist, w, pairs, stage, step, svd)
        xp = call()
        rec = dict(probe="ablate", stage=stage, **shape,
                   finite=bool(torch.isfinite(torch.view_as_real(xp)).all()),
                   ms_per_block=None, gs_per_s=None, device_us=None,
                   card=card)
        if device.type == "cuda":
            ms[stage] = event_ms(call, n=args.iters, warm=2) / args.k
            rec.update(ms_per_block=ms[stage],
                       gs_per_s=samples / ms[stage] / 1e6)
            durs = kernel_durations(call)
            rec["device_us"] = {key: statistics.median(v) / args.k
                                for key, v in durs.items()}
            rec["frames_us_min_max"] = [f(durs["frames"]) / args.k
                                        for f in (min, max)]
        emit(records, **rec)
    if len(stages) > 1:
        frames = {r["stage"]: r["device_us"]["frames"] for r in records
                  if r.get("device_us")}
        emit(records, probe="ablate",
             differences_ms_per_block=_differences(ms),
             frame_kernel_differences_us_per_block=_differences(frames),
             **shape, card=card)
    return records
