"""The engine as a library on samples already in device memory, in either
ingest and on either X stage: ``engine``'s loop for arrays of any width
the single pass takes.

The mix names what the cell measures: ``ingest`` (``"int8"``, the 8-bit
samples reaching the single pass as they arrived; ``"complex64"``) and
``x_stage`` (``"shared"`` or ``"global"``, ``FxEngine.x_stage``).  The
engine is built from the configuration with its own route choice on a
card (the fused route's plain versions on the CPU), and the driver raises
before it stages anything if the engine took another route, ingest or X
stage, or (on a card) no hand-written kernel.

``blocks`` distinct blocks of the harness's stream from the seed, 8-bit
or complex64, are staged once by ``FxEngine.prepare_batch`` into the
inputs of ``multi_step`` calls of at most ``FxEngine.dispatch_batch_for
(blocks)`` blocks each, and stay on the device.  The window runs the calls
over the blocks in turn, the history carried from call to call, for
``--seconds``.

``engine_gsamp_per_s``: every sample correlated in the window over the
window, with ``torch.cuda.synchronize()`` at both ends.  ``correct``: the
visibilities of ``check_calls`` calls drawn from the seed (every block,
every baseline) and the history after the last call, against the
reference, its pairs taken in tiles (``reference.fx_tiled``), the blocks
read from the host one at a time.  ``memory_peak_bytes``: the device
memory the window held at most, less the visibilities the check keeps
(the staged blocks, the step's buffers and the calls in flight).  A traced
run's record holds ``engine``'s least time and kernel time, the X kernels'
device time and least time (``fxbench.xstage_work``) and, in
``counters``, what the engine's launch counters (``FxEngine.
launch_counts``: the X stage's launches, row tiles and CTAs on the wide
route) moved over the traced calls."""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from fxbench import roofline, streams, xstage_work
from fxbench.cells import Cell, Outcome, Record
from fxbench.devtrace import DeviceTrace
from fxbench.drivers.engine import (_history, _history_gap, dispatch_sizes,
                                    packed_delays)
from fxbench.pipeline import correlator_config, note, release, sync
from fxbench.reference import fx as ref_fx
from fxbench.reference import fx_tiled
from fxbench.reference import judge
from fxbench.spans import SpanRecorder

INGESTS = ("int8", "complex64")


def engine_for(cell: Cell, device: str):
    """The cell's engine, checked against the route its mix names; raises
    RuntimeError on any other route before anything is staged."""
    from fxtpu_torch.fx import FxEngine
    mix = cell.mix
    if mix["ingest"] not in INGESTS:
        raise ValueError(f"the mix's ingest must be one of {INGESTS}, got "
                         f"{mix['ingest']!r}")
    on_card = torch.device(device).type == "cuda"
    cfg = correlator_config(cell, output_file="unused.csv", device=device)
    eng = FxEngine(cfg, fused=None if on_card else True)
    int8 = mix["ingest"] == "int8"
    if (eng.x_stage != mix["x_stage"] or eng.int8_native != int8
            or (on_card and not eng.kernel_active)):
        raise RuntimeError(
            f"the engine took the route fused={eng.fused_active}, "
            f"kernel={eng.kernel_active}, int8_native={eng.int8_native}, "
            f"x_stage={eng.x_stage}: the cell measures the single pass's "
            f"{mix['x_stage']} X stage on {mix['ingest']} samples")
    return cfg, eng


def _x_counts(eng) -> dict:
    """The engine's X stage counters (none where the program keeps
    none)."""
    return {k: v for k, v in eng.launch_counts().items()
            if k.startswith("fx_xstage")}


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
        control: bool = False) -> Outcome:
    on_card = torch.device(device).type == "cuda"
    mix = cell.mix
    with tempfile.TemporaryDirectory(prefix="fxbench-") as tmp:
        cfg, eng = engine_for(cell, device)
        int8 = mix["ingest"] == "int8"
        nblocks, num, nch = mix["blocks"], cfg.num_samp, cfg.nchan
        # the FSTC delays are the stream's own: the array's known delays
        delays_s = [float(np.float32(d)) for d in mix["delays_s"]]
        x = streams.stream(seed, nch, nblocks * num,
                           [d * cfg.bandwidth for d in delays_s],
                           mix["snr"], mix["rms"], device)
        if int8:
            q = streams.quantize(x, cfg.quant_step).reshape(nch, nblocks,
                                                            num, 2)
        else:
            q = x.reshape(nch, nblocks, num)
        # the blocks as made stay on the host, where the check reads them
        # a block at a time: in device memory they would count in the
        # window's peak (1.6 GB at 128 int8 inputs)
        q = q.cpu()
        del x
        q_host = q.numpy()
        sizes = dispatch_sizes(nblocks, eng.dispatch_batch_for(nblocks))
        calls, start = [], 0
        for k in sizes:
            host = eng.batch_host_buffer(k)
            iq = eng.prepare_batch([q_host[:, j] for j in
                                    range(start, start + k)], host)
            sync(device)
            del host
            calls.append((iq, packed_delays(delays_s, cfg.frequency, k,
                                            device), k))
            start += k
        del q_host
        if on_card:
            # the peak the window holds: the staged blocks and the step's
            # buffers, not the stream's making
            torch.cuda.reset_peak_memory_stats()
        step = eng.multi_step
        spans = SpanRecorder() if trace else None
        kept, seen = [], 0
        rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
        n_keep = mix["check_calls"]
        history = eng.fresh_history()
        m = 0    # calls made, the warm pass's included

        def call(c):
            nonlocal history, m
            iq, d, _ = calls[c % len(calls)]
            vis, history = step(iq, d, history)
            m += 1
            return vis

        for c in range(len(calls)):     # warm: one pass over every shape
            call(c)
        sync(device)
        dev_trace = DeviceTrace(tmp) if trace and on_card else None
        trace_s = min(float(mix["trace_seconds"]), seconds)
        traced = None
        counts0 = _x_counts(eng)
        counts1 = None
        if dev_trace is not None:
            dev_trace.start()
        t0 = time.perf_counter()
        done = blocks_done = 0
        while True:
            c = m % len(calls)
            if spans is not None:
                h0 = time.perf_counter()
            vis = call(c)
            if spans is not None:
                spans.record("fx.multi_step", h0, time.perf_counter())
            done += 1
            blocks_done += calls[c][2]
            # reservoir of the calls compared, drawn from the seed
            seen += 1
            if len(kept) < n_keep:
                kept.append((m - 1, vis))
            else:
                j = int(rng.integers(seen))
                if j < n_keep:
                    kept[j] = (m - 1, vis)
            del vis
            now = time.perf_counter()
            if (dev_trace is not None and traced is None
                    and now - t0 >= trace_s):
                sync(device)
                tt = time.perf_counter()
                dev_trace.stop()
                traced = (tt, done)
                counts1 = _x_counts(eng)
            if now - t0 >= seconds:
                break
        sync(device)
        t1 = time.perf_counter()
        # the window's peak less the reservoir's visibilities, which the
        # check holds and the program does not (3.2 GB at 128 inputs):
        # they are all held from the n_keep-th call on, so through the
        # peak of every later call
        held = {v.untyped_storage().data_ptr(): v.untyped_storage().nbytes()
                for _, v in kept}
        peak = (torch.cuda.max_memory_allocated() - sum(held.values())
                if on_card else 0)
        rate = blocks_done * nch * num / (t1 - t0) / 1e9
        note(f"{done} calls of {sizes} blocks in {t1 - t0:.3f} s "
             f"({mix['ingest']}, x_stage {eng.x_stage})")
        record = None
        if trace:
            hi, n_traced = traced or (t1, done)
            counts1 = counts1 if counts1 is not None else _x_counts(eng)
            moved = {k: v - counts0.get(k, 0) for k, v in counts1.items()}
            span_in = spans.between("fx.multi_step", t0, hi)
            summary = (dev_trace.read(t0, hi, {"fx.multi_step": span_in})
                       if dev_trace is not None else None)
            record = _record(cfg, calls, n_traced, summary, span_in,
                             len(eng.pairs), moved)
        final = {key: (v.cpu() if torch.is_tensor(v) else v)
                 for key, v in (history.items()
                                if isinstance(history, dict)
                                else {"tail": history}.items())}
        last_call = m - 1
        kept = [(mm, v.cpu()) for mm, v in kept]
        del calls, history, eng, step
        release(device)
        readings, ctl = _check(cfg, q, int8, sizes, kept, final, last_call,
                               delays_s, device, control)
        del q
    return Outcome(end_to_end={"engine_gsamp_per_s": rate},
                   window_start=t0, attempted=blocks_done, failed=0,
                   memory_peak_bytes=peak, checks=readings, record=record,
                   control=ctl)


def _record(cfg, calls, n_traced, summary, spans_in, nbl, counters
            ) -> Record:
    """The traced sub-window's work and times for the readers: the least
    time of the calls it holds, and of their X stage, synchronised at both
    ends."""
    spans = {"fx.multi_step": spans_in}
    if summary is None:
        return Record(spans=spans, counters=counters, trace=None)
    peak = roofline.peaks(torch.cuda.get_device_name(0))
    least = x_least = 0.0
    for c in range(n_traced):
        # the traced calls are the window's first n_traced, in turn
        k = calls[c % len(calls)][2]
        o, b = roofline.step_work(
            nchan=cfg.nchan, num_samp=cfg.num_samp, nbins=cfg.nbins,
            ntaps=cfg.ntaps, n_baselines=nbl, k=k,
            int8=cfg.ingest_dtype == "int8", continuum=cfg.mode != "SPECTRUM")
        xo, xb = xstage_work.xstage_work(
            nchan=cfg.nchan, n_baselines=nbl, num_samp=cfg.num_samp,
            nbins=cfg.nbins, k=k)
        if peak is not None:
            least += roofline.least_time_s(o, b, peak)
            x_least += roofline.least_time_s(xo, xb, peak)
    trace = dict(summary)
    trace["least_s"] = least if peak is not None else None
    trace["xstage_s"] = xstage_work.xstage_seconds(summary["device_ops"])
    trace["xstage_least_s"] = (x_least if peak is not None
                               and trace["xstage_s"] else None)
    return Record(spans=spans, counters=counters, trace=trace)


def _check(cfg, q, int8, sizes, kept, final, last_call, delays_s, device,
           control):
    """``vis_gap``: every block and baseline of the kept calls against the
    reference with the history of the block before it; ``history_gap``:
    the history after the last call against the last block's.  ``q``:
    the staged blocks ``[nch, blocks, num_samp(, 2)]`` on the host,
    8-bit or complex64."""
    dev = torch.device(device)
    nblocks = q.shape[1]
    starts = np.cumsum([0] + sizes[:-1])
    w2d = ref_fx.prototype(cfg.ntaps, cfg.nbins, cfg.window)
    pairs = ref_fx.baselines(cfg.nchan, cfg.include_autos)

    def block(j, rnd=ref_fx.exact):
        b = q[:, j % nblocks].to(dev)
        return ref_fx.dequantize(b, cfg.quant_step, rnd) if int8 else b

    def blocks_of(mm):
        c = mm % len(sizes)
        return [int(starts[c]) + i for i in range(sizes[c])]

    def vis_of(j, first, rnd=ref_fx.exact):
        return fx_tiled.fx_block(block(j, rnd),
                                 None if first else block(j - 1, rnd), w2d,
                                 pairs, delays_s, cfg.bandwidth,
                                 cfg.frequency, rnd=rnd)

    gaps, ctl_gaps = [], []
    for mm, vis in kept:
        for i, j in enumerate(blocks_of(mm)):
            first = mm == 0 and i == 0   # the stream's first block
            want = vis_of(j, first).cpu().numpy()
            gaps.append(judge.spectrum_gap(vis[i].numpy(), want))
            if control:
                out = vis_of(j, first, ref_fx.bf16).cpu().numpy()
                ctl_gaps.append(judge.spectrum_gap(out, want))
            del want
    last = q[:, blocks_of(last_call)[-1] % nblocks].to(dev)
    hist = _history if int8 else _history_c64
    want = hist(last, cfg, int8)
    readings = {"vis_gap": max(gaps),
                "history_gap": _history_gap(final, want)}
    ctl = None
    if control:
        ctl = {"vis_gap": max(ctl_gaps),
               "history_gap": _history_gap(hist(last, cfg, int8, ref_fx.bf16),
                                           want)}
    return readings, ctl


def _history_c64(x, cfg, native: bool = False, rnd=ref_fx.exact) -> dict:
    """The history the complex64 block ``x [nch, num_samp]`` leaves: its
    last ntaps-1 rows less its mean (``tail``)."""
    s = cfg.num_samp // cfg.nbins
    rows = ref_fx.corrected_rows(x, cfg.nbins, rnd)
    return {"tail": rows[:, s - (cfg.ntaps - 1):].cpu()}
