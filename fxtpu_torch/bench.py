"""Benchmark: steady-state FX-correlator throughput on one card.

Counterpart of ``bench.py``: the same configurations, flags, metric names
and JSON line.  It measures aggregate samples/s through the FX step
(``bench``: the fused single pass and its epilogue on the card, K blocks
a timed iteration), the end-to-end pipeline (``bench_pipeline``: replayed
source -> rings -> aligner -> staging -> step -> CSV rows through the
Correlator) or the host data plane alone (``bench_host_pipeline``: the
device sink stubbed).  ``vs_baseline`` compares against the reference's
implied real-time rate, 2 channels x 2.4 MS/s on its RTL-SDRs.

Every measurement runs on the card (``torch.cuda``) unless ``--cpu`` is
given; without a card and without ``--cpu`` it prints the error line and
exits 1.  A number taken under ``--cpu`` is a functional smoke of the
path, not a statement about any device.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "samples/s", "vs_baseline": N, ...}

Usage:  python -m fxtpu_torch.bench [--config NAME] [--pipeline]
        [--host_pipeline [--single_feeder]] [--ingest complex64|int8]
        [--iters N] [--seconds S] [--cpu]
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.correlator import Correlator
from fxtpu_torch.fx import FxEngine
from fxtpu_torch.ops.xengine import pack_delays
from fxtpu_torch.runtime.feeder import BlockAligner, Feeder
from fxtpu_torch.runtime.native import make_ring, require_native
from fxtpu_torch.sources import (NoiseSource, QuantizedSource, ReplaySource,
                                 save_recording)

__all__ = ["CONFIGS", "REFERENCE_AGGREGATE_SAMPLES_PER_S", "ITERS", "WARMUP",
           "PIPELINE_SECONDS", "HOST_PIPELINE_SECONDS", "roofline",
           "dispatch_sizes", "stage_calls", "run_calls", "bench",
           "bench_pipeline", "bench_host_pipeline", "metric_name",
           "step_line", "main"]

#: The reference's implied sustained real-time rate: 2 channels x 2.4 MS/s
#: on its RTL-SDRs (BASELINE.md: effex.py:47,713-718).
REFERENCE_AGGREGATE_SAMPLES_PER_S = 4.8e6

#: Timed and warm-up steps of ``bench`` (bench.py's defaults).
ITERS = 30
WARMUP = 5
#: Run lengths of the two pipelines (bench.py's defaults; ``--seconds``).
PIPELINE_SECONDS = 12.0
HOST_PIPELINE_SECONDS = 6.0

#: Peak float32 flop/s outside the tensor cores and device-memory bytes/s
#: by device-name substring: NVIDIA's published H100 SXM figures at 700 W,
#: the rates chip_smoke.py's bounds use.
_CARD_PEAKS = {"h100": (67e12, 3.35e12)}

#: Threads that make the blocks of ``bench``.
_MAKERS = min(8, os.cpu_count() or 1)

#: A share of the peak above this is a fault of the count or of the timing
#: window, not a reading.
_MAX_SHARE = 1.05


def _emit_error(metric: str, err: str) -> None:
    """The failure path: still ONE parseable JSON line under the metric's
    name, so a caller records a structured error, not a stack trace."""
    print(json.dumps({"metric": metric, "value": 0, "unit": "samples/s",
                      "vs_baseline": 0.0, "error": err}))


def roofline(samples_per_s: float, *, nbins: int, ntaps: int, nchan: int,
             n_baselines: int, device_kind: str,
             bytes_per_sample: float = 8.0, precision: str = "high") -> dict:
    """The FX step's work per aggregate sample -> achieved rates and their
    shares of the card's peaks.

    Float32 operations per sample, whatever computes them: 2 for the
    mean, 4 a tap for the FIR, 5 log2(nbins) for the FFT, and 8 a
    baseline for the cross power, spread over the channels (chip_smoke.py's
    ``fx_bound``).  Bytes: the input read once, ``bytes_per_sample`` 8 for
    complex64, 2 for 8-bit (I, Q); the outputs are O(nbl nbins) a block.
    ``flop_frac`` and ``hbm_frac`` are reported on a card of
    ``_CARD_PEAKS``; a share above 1.05 raises."""
    flops = (2.0 + 4.0 * ntaps + 5.0 * float(np.log2(nbins))
             + 8.0 * n_baselines / nchan)
    out = {
        "precision": precision,
        "model_flops_per_sample": flops,
        "tflops": round(samples_per_s * flops / 1e12, 2),
        "hbm_gbps": round(samples_per_s * bytes_per_sample / 1e9, 1),
    }
    peak = next((v for k, v in _CARD_PEAKS.items()
                 if k in device_kind.lower()), None)
    if peak:
        shares = {"flop_frac": samples_per_s * flops / peak[0],
                  "hbm_frac": samples_per_s * bytes_per_sample / peak[1]}
        for name, share in shares.items():
            if share > _MAX_SHARE:
                raise ValueError(
                    f"{name} {share:.3f} of the {device_kind} peak: the "
                    "count or the timing window is wrong")
            out[name] = round(share, 3)
    return out


def dispatch_sizes(k: int, most: int) -> list:
    """K blocks as ceil(K / most) calls of near-equal size, the larger
    first."""
    n = -(-k // most)
    return [k // n + (i < k % n) for i in range(n)]


def stage_calls(eng: FxEngine, blocks, k: int) -> list:
    """The first ``k`` of ``blocks`` (an iterable of host blocks) staged as
    the inputs ``(iq, delays)`` of consecutive ``eng.multi_step`` calls:
    one call where the engine takes K blocks in one launch, else
    ``dispatch_sizes(k, eng.dispatch_batch_for(k))``.  Each call's host
    buffer is released once its copy has completed, so at most one call's
    blocks sit in pinned memory."""
    blocks = iter(blocks)
    calls = []
    for size in dispatch_sizes(k, eng.dispatch_batch_for(k)):
        host = eng.batch_host_buffer(size)
        iq = eng.prepare_batch(itertools.islice(blocks, size), host)
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        del host
        calls.append((iq, torch.zeros((size, eng.cfg.nchan),
                                      device=eng.device)))
    return calls


def run_calls(step, calls, history):
    """One pass of ``step`` over ``calls``, the history carried from each
    call to the next: returns ``(vis of every call, history)``."""
    vis = []
    for iq, delays in calls:
        v, history = step(iq, delays, history)
        vis.append(v)
    return vis, history


def _make_block(seq, nchan: int, num_samp: int, ingest: str) -> np.ndarray:
    """One host block from the generator of ``seq``: int8 (I, Q) integers
    in [-127, 127], or complex64 with standard-normal parts."""
    rng = np.random.default_rng(seq)
    if ingest == "int8":
        return rng.integers(-127, 128, size=(nchan, num_samp, 2),
                            dtype=np.int8)
    block = np.empty((nchan, num_samp), np.complex64)
    rng.standard_normal(out=block.view(np.float32), dtype=np.float32)
    return block


def _blocks(seed: int, k: int, nchan: int, num_samp: int, ingest: str):
    """``k`` distinct host blocks, block j drawn from the j-th child of
    ``SeedSequence(seed)``, made ``_MAKERS`` at a time by threads (numpy
    fills without the interpreter lock): making 128 blocks of 2 x 2^21
    samples one by one takes longer than timing them."""
    seqs = np.random.SeedSequence(seed).spawn(k)
    make = functools.partial(_make_block, nchan=nchan, num_samp=num_samp,
                             ingest=ingest)
    with ThreadPoolExecutor(_MAKERS) as pool:
        for i in range(0, k, _MAKERS):
            yield from pool.map(make, seqs[i: i + _MAKERS])


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _release_pinned():
    """Return cached pinned host memory to the system (torch keeps freed
    pinned blocks for reuse; a batch's can be GiBs)."""
    empty = getattr(torch._C, "_host_emptyCache", None)
    if empty is not None:
        empty()


def bench(block_pow: int = 21, nbins: int = 4096, nchan: int = 2,
          iters: int = ITERS, warmup: int = WARMUP, mode: str = "SPECTRUM",
          ntaps: int = 4, include_autos: bool = False,
          blocks_per_call: int = 128, ingest: str = "complex64",
          device: str = "cuda") -> dict:
    """Steady-state throughput of the FX step.  ``blocks_per_call`` K > 1
    correlates K distinct blocks a timed iteration, the history carried
    across them, through ``multi_step`` calls of at most what one launch
    takes at this shape (``FxEngine.dispatch_batch_for``: ceil(K / m)
    calls an iteration); ``blocks_per_dispatch`` in the result is the
    largest call's K.  One untimed step and ``warmup`` steps (the first
    builds the kernels) precede ``iters`` timed ones, closed by
    ``torch.cuda.synchronize()``."""
    num_samp = 2 ** block_pow
    cfg = CorrelatorConfig(mode=mode, nchan=nchan, num_samp=num_samp,
                           nbins=nbins, ntaps=ntaps,
                           include_autos=include_autos, clamp_num_samp=False,
                           ingest_dtype=ingest, device=device)
    eng = FxEngine(cfg)
    k = max(1, blocks_per_call)
    blocks = _blocks(0, k, nchan, num_samp, ingest)
    if k == 1:
        step, per_call = eng.step, 1
        calls = [(eng.prepare_block(next(blocks)),
                  torch.zeros(nchan, device=eng.device))]
    else:
        step = eng.multi_step
        calls = stage_calls(eng, blocks, k)
        per_call = max(delays.shape[0] for _, delays in calls)
    if eng.device.type == "cuda":
        _release_pinned()
    history = eng.fresh_history()

    _, history = run_calls(step, calls, history)
    for _ in range(warmup):
        _, history = run_calls(step, calls, history)
    _sync(eng.device)

    t0 = time.perf_counter()
    for _ in range(iters):
        _, history = run_calls(step, calls, history)
    _sync(eng.device)
    dt = time.perf_counter() - t0

    agg_samples = nchan * num_samp * k * iters
    frames = num_samp // nbins
    return {
        "samples_per_s": agg_samples / dt,
        "spectra_per_s": frames * k * iters / dt,
        "block_seconds": dt / (iters * k),
        "num_samp": num_samp,
        "nbins": nbins,
        "nchan": nchan,
        "blocks_per_dispatch": per_call,
    }


def bench_pipeline(block_pow: int = 21, nbins: int = 4096, nchan: int = 2,
                   seconds: float = PIPELINE_SECONDS,
                   blocks_per_dispatch: int = 8, ingest: str = "complex64",
                   device: str = "cuda") -> dict:
    """End-to-end pipeline rate: replayed source -> ring buffers ->
    aligner -> staging and copy -> FX step -> CSV rows, through the
    Correlator in CONTINUUM mode.  Reports the steady-state rate, between
    the Correlator's ``steady`` mark (the first correlated call returned)
    and its ``end`` mark, so the kernels' first build and load do not count
    as pipeline time; what the run launches is warmed first at the
    Correlator's own input layouts."""
    num_samp = 2 ** block_pow
    with tempfile.TemporaryDirectory() as d:
        rec = save_recording(NoiseSource(nchan=nchan, seed=1),
                             f"{d}/rec.npy", num_samp, 4)
        cfg = CorrelatorConfig(
            mode="CONTINUUM", nchan=nchan, num_samp=num_samp, nbins=nbins,
            run_time=max(seconds, 1), clamp_num_samp=False,
            loglevel="WARNING", source="replay", replay_file=rec,
            blocks_per_dispatch=blocks_per_dispatch,
            buffer_chunks=4 * blocks_per_dispatch, ingest_dtype=ingest,
            output_file=f"{d}/vis.csv", device=device)
        _warm_pipeline(cfg)
        cor = Correlator(config=cfg)
        # stream the recording for run_time seconds (under int8 the
        # replay sits behind a QuantizedSource)
        getattr(cor.source, "inner", cor.source).loop = True
        cor.run_state_machine()
        r = cor.metrics.rates(since="steady", until="end")
        return {"samples_per_s": r["samples_per_s"],
                "blocks": cor.blocks_processed,
                "blocks_per_dispatch": cor.engine.dispatch_batch_for(
                    blocks_per_dispatch)}


def _warm_pipeline(cfg: CorrelatorConfig):
    """One K-block call (where the Correlator makes them), one step and one
    calibration on an engine of ``cfg``, with the packed delays and the
    prepared blocks the Correlator hands them."""
    eng = FxEngine(cfg)
    k = eng.dispatch_batch_for(cfg.blocks_per_dispatch)
    if cfg.ingest_dtype == "int8":
        arr = np.zeros((k, cfg.nchan, cfg.num_samp, 2), np.int8)
    else:
        arr = np.zeros((k, cfg.nchan, cfg.num_samp), np.complex64)
    hist = eng.fresh_history()
    if k > 1:
        dk = torch.as_tensor(pack_delays(np.zeros((k, cfg.nchan)),
                                         cfg.frequency), device=eng.device)
        eng.multi_step(eng.prepare_batch(arr), dk, hist)
    d1 = torch.as_tensor(pack_delays(np.zeros(cfg.nchan), cfg.frequency),
                         device=eng.device)
    eng.step(eng.prepare_block(arr[0]), d1, hist)
    eng.calibrate_block(eng.prepare_block(arr[0]),
                        min(cfg.calibrate_samples, cfg.num_samp))
    _sync(eng.device)


def bench_host_pipeline(block_pow: int = 21, nchan: int = 2,
                        seconds: float = HOST_PIPELINE_SECONDS,
                        ingest: str = "complex64",
                        channel_feeders: bool = True,
                        device: str = "cuda") -> dict:
    """The HOST pipeline rate with the device sink stubbed: replayed source
    -> per-channel feeder threads (or one) -> rings -> aligner -> the
    staging copy ``FxEngine.prepare_block`` makes on the fused route (the
    block framed ``[nch, S, 4096(, 2)]`` into a reused host buffer by
    torch's threaded ``copy_``; pinned when ``device`` is ``"cuda"``),
    and no copy to the device.  Every byte flows source read -> ring slot
    -> aligned gather -> staging buffer."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda."
                           "is_available() is False; ask for 'cpu'")
    require_native(device, "bench_host_pipeline's rings")
    num_samp = 2 ** block_pow
    int8 = ingest == "int8"
    iq = (2,) if int8 else ()
    ring_dtype = np.int8 if int8 else np.complex64
    nbins = CONFIGS["default"]["nbins"]
    frames = num_samp // nbins
    stage = torch.empty((nchan, frames, nbins, *iq),
                        dtype=torch.int8 if int8 else torch.complex64,
                        pin_memory=device == "cuda")
    with tempfile.TemporaryDirectory() as d:
        rec = save_recording(NoiseSource(nchan=nchan, seed=1),
                             f"{d}/rec.npy", num_samp, 4)

        def make_source(channels=None):
            src = ReplaySource(rec, loop=True)
            if channels is not None:
                src = src.select_channels(channels)
            return QuantizedSource(src) if int8 else src

        bufs = [make_ring(8, (num_samp, *iq), dtype=ring_dtype)
                for _ in range(nchan)]
        if channel_feeders:
            feeders = [Feeder(make_source([c]), [bufs[c]], num_samp)
                       for c in range(nchan)]
        else:
            feeders = [Feeder(make_source(), bufs, num_samp)]
        aligner = BlockAligner(bufs)
        for f in feeders:
            f.start()
        blocks = 0
        try:
            deadline = time.perf_counter() + seconds
            t0 = time.perf_counter()
            while time.perf_counter() < deadline:
                block = aligner.get(timeout=1.0)
                if block is None:
                    break
                framed = block[:, : frames * nbins].reshape(stage.shape)
                stage.copy_(torch.from_numpy(framed))
                blocks += 1
            dt = time.perf_counter() - t0
        finally:
            for f in feeders:
                f.stop()
            for f in feeders:
                f.join(2.0)
        rate = blocks * nchan * num_samp / dt
        return {"samples_per_s": rate, "blocks": blocks,
                "bytes_per_s": rate * (2 if int8 else 8),
                "drops": sum(b.drops for b in bufs)}


CONFIGS = {
    # the flagship: 2 channels, 4096 bins, 4 taps
    "default": dict(block_pow=21, nbins=4096, nchan=2),
    # wideband: 8192 bins, 32 taps (the FIR through the window's factors)
    "wideband": dict(block_pow=21, nbins=8192, nchan=2, ntaps=32,
                     blocks_per_call=64),
    # wideband at the 8-bit ingest width radio samples arrive in
    "wideband_int8": dict(block_pow=21, nbins=8192, nchan=2, ntaps=32,
                          blocks_per_call=32, ingest="int8"),
    # the flagship at the 8-bit ingest width
    "default_int8": dict(block_pow=21, nbins=4096, nchan=2, ingest="int8"),
    # 8 inputs, 36 baselines with autos (the wide route)
    "nchan8": dict(block_pow=20, nbins=4096, nchan=8, include_autos=True,
                   blocks_per_call=64),
}


def metric_name(config: str = "default", pipeline: bool = False,
                host_pipeline: bool = False,
                ingest: str = "complex64") -> str:
    """The JSON line's ``metric``, as bench.py names it."""
    suffix = "" if ingest == "complex64" else "_int8"
    if host_pipeline:
        return "2ch_host_pipeline_throughput" + suffix
    if pipeline:
        return "2ch_end_to_end_pipeline_throughput" + suffix
    if config == "default":
        return "2ch_4096bin_pfb_fft_x_aggregate_throughput"
    return f"{config}_pfb_fft_x_aggregate_throughput"


def _rate_fields(samples_per_s: float) -> dict:
    return {"value": round(samples_per_s, 1), "unit": "samples/s",
            "vs_baseline": round(
                samples_per_s / REFERENCE_AGGREGATE_SAMPLES_PER_S, 3)}


def step_line(config: str, res: dict, device: str, device_kind: str) -> dict:
    """The JSON line of ``bench``'s result ``res`` for ``config``: the rate,
    the device, the roofline and the largest call's K."""
    kw = CONFIGS[config]
    nchan = kw.get("nchan", 2)
    nbl = nchan * (nchan - 1) // 2 + (nchan if kw.get("include_autos")
                                      else 0)
    return {
        "metric": metric_name(config),
        **_rate_fields(res["samples_per_s"]),
        "spectra_per_s": round(res["spectra_per_s"], 1),
        "device": device,
        **roofline(res["samples_per_s"], nbins=kw.get("nbins", 4096),
                   ntaps=kw.get("ntaps", 4), nchan=nchan, n_baselines=nbl,
                   device_kind=device_kind,
                   bytes_per_sample=(2.0 if kw.get("ingest") == "int8"
                                     else 8.0)),
        "blocks_per_dispatch": res["blocks_per_dispatch"],
    }


def _card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Steady-state FX correlator throughput on one card: "
                    "prints one JSON line.")
    p.add_argument("--config", default="default", choices=sorted(CONFIGS))
    p.add_argument("--pipeline", action="store_true",
                   help="measure the end-to-end host pipeline instead of "
                        "the device step")
    p.add_argument("--host_pipeline", action="store_true",
                   help="measure the HOST data plane alone (device sink "
                        "stubbed; no copy to the card)")
    p.add_argument("--single_feeder", action="store_true",
                   help="host_pipeline: one multi-channel feeder thread "
                        "instead of per-channel parallel feeders")
    p.add_argument("--ingest", default="complex64",
                   choices=["complex64", "int8"],
                   help="pipeline ingest dtype (int8 = 8-bit quantized)")
    p.add_argument("--iters", type=int, default=ITERS)
    p.add_argument("--seconds", type=float, default=None,
                   help="run length of --pipeline and --host_pipeline "
                        f"(default {PIPELINE_SECONDS:g} and "
                        f"{HOST_PIPELINE_SECONDS:g} s)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (a functional smoke of every "
                        "config path; its numbers are NOT hardware "
                        "statements)")
    return p


def main(argv=None) -> int:
    """Run the measurement the flags ask for and print its JSON line;
    returns the exit status (1 after printing the error line)."""
    args = _parser().parse_args(argv)
    metric = metric_name(args.config, args.pipeline, args.host_pipeline,
                         args.ingest)
    if not args.cpu and not torch.cuda.is_available():
        _emit_error(metric, "backend_unavailable: no CUDA device")
        return 1
    try:
        out = _run_measurement(args, metric)
    except Exception as e:  # a failed run still emits a record
        traceback.print_exc()
        _emit_error(metric, f"{type(e).__name__}: {e}")
        return 1
    print(json.dumps(out))
    return 0


def _run_measurement(args, metric: str) -> dict:
    device = "cpu" if args.cpu else "cuda"
    if args.host_pipeline:
        kw = {} if args.seconds is None else {"seconds": args.seconds}
        res = bench_host_pipeline(ingest=args.ingest,
                                  channel_feeders=not args.single_feeder,
                                  device=device, **kw)
        return {"metric": metric, **_rate_fields(res["samples_per_s"]),
                "bytes_per_s": round(res["bytes_per_s"], 1),
                "drops": res["drops"],
                "device": "host-only (device sink stubbed)"}
    name = "cpu" if args.cpu else _card_line()
    if args.pipeline:
        kw = {} if args.seconds is None else {"seconds": args.seconds}
        res = bench_pipeline(ingest=args.ingest, device=device, **kw)
        print(f"# blocks_per_dispatch {res['blocks_per_dispatch']}",
              file=sys.stderr)
        return {"metric": metric, **_rate_fields(res["samples_per_s"]),
                "device": name,
                "blocks_per_dispatch": res["blocks_per_dispatch"]}
    res = bench(iters=args.iters, device=device, **CONFIGS[args.config])
    print(f"# blocks_per_dispatch {res['blocks_per_dispatch']}",
          file=sys.stderr)
    kind = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    return step_line(args.config, res, name, kind)


if __name__ == "__main__":
    sys.exit(main())
