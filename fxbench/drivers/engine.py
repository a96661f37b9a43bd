"""The engine as a library on samples already in device memory, as in
arrays whose receivers write to the card.

``blocks`` distinct 8-bit blocks of the harness's stream from the seed are
staged once, by ``FxEngine.prepare_batch``, into the inputs of ``multi_step``
calls of at most ``FxEngine.dispatch_batch_for(blocks)`` blocks each, and
stay on the device.  The window runs the calls over the blocks in turn,
the history carried from call to call, for ``--seconds``.

``engine_gsamp_per_s``: every sample correlated in the window over the
window, with ``torch.cuda.synchronize()`` at both ends.  ``correct``: the
visibilities of a few calls drawn from the seed (every block, every
baseline) and the history after the last call, against the reference."""

from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from fxbench import roofline, streams
from fxbench.cells import Cell, Outcome, Record
from fxbench.devtrace import DeviceTrace
from fxbench.pipeline import correlator_config, note, release, sync
from fxbench.reference import fx as ref_fx
from fxbench.reference import judge
from fxbench.spans import SpanRecorder


def dispatch_sizes(k: int, most: int) -> list:
    """``k`` blocks as ceil(k / most) calls of near-equal size, the larger
    first."""
    n = -(-k // most)
    return [k // n + (i < k % n) for i in range(n)]


def packed_delays(delays_s, frequency: float, k: int, device):
    """``[k, nch, 2]`` float32 ``(delay, frac(frequency * delay))``, the
    carrier's cycles reduced in float64: the engine's packed delays."""
    d = np.asarray(delays_s, np.float64)
    pair = np.stack([d, np.mod(frequency * d, 1.0)], axis=-1)
    return torch.as_tensor(np.repeat(pair[None], k, axis=0),
                           dtype=torch.float32, device=device)


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
        control: bool = False) -> Outcome:
    from fxtpu_torch.fx import FxEngine
    on_card = torch.device(device).type == "cuda"
    mix = cell.mix
    with tempfile.TemporaryDirectory(prefix="fxbench-") as tmp:
        cfg = correlator_config(cell, output_file="unused.csv",
                                device=device)
        eng = FxEngine(cfg)
        if on_card and not (eng.kernel_active and eng.int8_native
                            and eng.x_stage == "global"):
            raise RuntimeError(
                f"the engine took the route fused={eng.fused_active}, "
                f"int8_native={eng.int8_native}, x_stage={eng.x_stage}: the "
                "cell measures the wide route's 8-bit kernels")
        nblocks, num, nch = mix["blocks"], cfg.num_samp, cfg.nchan
        # the FSTC delays are the stream's own: the array's known delays
        delays_s = [float(np.float32(d)) for d in mix["delays_s"]]
        x = streams.stream(seed, nch, nblocks * num,
                           [d * cfg.bandwidth for d in delays_s],
                           mix["snr"], mix["rms"], device)
        q = streams.quantize(x, cfg.quant_step).reshape(nch, nblocks, num, 2)
        del x
        q_host = q.cpu().numpy()
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
            if now - t0 >= seconds:
                break
        sync(device)
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        rate = blocks_done * nch * num / (t1 - t0) / 1e9
        note(f"{done} calls of {sizes} blocks in {t1 - t0:.3f} s")
        record = None
        if trace:
            hi, n_traced = traced or (t1, done)
            span_in = spans.between("fx.multi_step", t0, hi)
            summary = (dev_trace.read(t0, hi, {"fx.multi_step": span_in})
                       if dev_trace is not None else None)
            record = _record(cfg, calls, n_traced, summary, span_in,
                             len(eng.pairs))
        final = {key: (v.cpu() if torch.is_tensor(v) else v)
                 for key, v in (history.items()
                                if isinstance(history, dict)
                                else {"tail": history}.items())}
        last_call = m - 1
        native = eng.int8_native
        kept = [(mm, v.cpu()) for mm, v in kept]
        del calls, history, eng, step
        release(device)
        readings, ctl = _check(cfg, q, sizes, kept, final, last_call,
                               delays_s, native, device, control)
        del q
    return Outcome(end_to_end={"engine_gsamp_per_s": rate},
                   window_start=t0, attempted=blocks_done, failed=0,
                   memory_peak_bytes=peak, checks=readings, record=record,
                   control=ctl)


def _record(cfg, calls, n_traced, summary, spans_in, nbl) -> Record:
    """The traced sub-window's work and times for the readers: the least
    time of the calls it holds, synchronised at both ends."""
    if summary is None:
        return Record(spans={"fx.multi_step": spans_in}, counters={},
                      trace=None)
    peak = roofline.peaks(torch.cuda.get_device_name(0))
    least = 0.0
    for c in range(n_traced):
        # the traced calls are the window's first n_traced, in turn
        k = calls[c % len(calls)][2]
        o, b = roofline.step_work(
            nchan=cfg.nchan, num_samp=cfg.num_samp, nbins=cfg.nbins,
            ntaps=cfg.ntaps, n_baselines=nbl, k=k,
            int8=cfg.ingest_dtype == "int8", continuum=cfg.mode != "SPECTRUM")
        if peak is not None:
            least += roofline.least_time_s(o, b, peak)
    trace = dict(summary)
    trace["least_s"] = least if peak is not None else None
    return Record(spans={"fx.multi_step": spans_in}, counters={},
                  trace=trace)


def _check(cfg, q, sizes, kept, final, last_call, delays_s, native,
           device, control):
    """``vis_gap``: every block and baseline of the kept calls against the
    reference with the history of the block before it; ``history_gap``:
    the history after the last call against the last block's."""
    dev = torch.device(device)
    nblocks = q.shape[1]
    starts = np.cumsum([0] + sizes[:-1])
    w2d = ref_fx.prototype(cfg.ntaps, cfg.nbins, cfg.window)
    pairs = ref_fx.baselines(cfg.nchan, cfg.include_autos)
    step = cfg.quant_step

    def block(j, rnd=ref_fx.exact):
        return ref_fx.dequantize(q[:, j % nblocks].to(dev), step, rnd)

    def blocks_of(mm):
        c = mm % len(sizes)
        return [int(starts[c]) + i for i in range(sizes[c])]

    gaps, ctl_gaps = [], []
    for mm, vis in kept:
        for i, j in enumerate(blocks_of(mm)):
            first = mm == 0 and i == 0   # the stream's first block
            cur = block(j)
            prev = None if first else block(j - 1)
            want = ref_fx.fx_block(cur, prev, w2d, pairs, delays_s,
                                   cfg.bandwidth, cfg.frequency).cpu().numpy()
            gaps.append(judge.spectrum_gap(vis[i].numpy(), want))
            if control:
                cb = block(j, ref_fx.bf16)
                cp = None if first else block(j - 1, ref_fx.bf16)
                out = ref_fx.fx_block(cb, cp, w2d, pairs, delays_s,
                                      cfg.bandwidth, cfg.frequency,
                                      rnd=ref_fx.bf16)
                ctl_gaps.append(judge.spectrum_gap(out.cpu().numpy(), want))
    last = q[:, blocks_of(last_call)[-1] % nblocks].to(dev)
    want = _history(last, cfg, native)
    readings = {"vis_gap": max(gaps),
                "history_gap": _history_gap(final, want)}
    ctl = None
    if control:
        ctl = {"vis_gap": max(ctl_gaps),
               "history_gap": _history_gap(
                   _history(last, cfg, native, ref_fx.bf16), want)}
    return readings, ctl


def _history(x, cfg, native: bool, rnd=ref_fx.exact) -> dict:
    """The history the block ``x`` (8-bit ``[nch, num_samp, 2]``) leaves:
    on the 8-bit-native route its last ntaps-1 rows as they arrived and
    its mean (``tail``, ``mu_prev``), otherwise its last ntaps-1 rows less
    its mean (``tail``)."""
    halo = cfg.ntaps - 1
    s = cfg.num_samp // cfg.nbins
    if native:
        raw = x[:, (s - halo) * cfg.nbins: s * cfg.nbins]
        mu = rnd(ref_fx.dequantize(x, cfg.quant_step, rnd).mean(dim=-1))
        return {"tail": raw.reshape(cfg.nchan, halo, cfg.nbins, 2).cpu(),
                "mu_prev": mu.cpu()}
    rows = ref_fx.corrected_rows(ref_fx.dequantize(x, cfg.quant_step, rnd),
                                 cfg.nbins, rnd)
    return {"tail": rows[:, s - halo:].cpu()}


def _history_gap(got: dict, want: dict) -> float:
    """On the 8-bit-native route 1 where the raw tail differs in any byte,
    else the relative gap of the mean; otherwise the tail's widest gap as
    a share of its largest magnitude."""
    if "mu_prev" in want:
        tail = got["tail"].reshape(want["tail"].shape)
        if not torch.equal(tail.to(torch.int8), want["tail"]):
            return 1.0
        return judge.mean_gap(
            got["mu_prev"].numpy().astype(np.complex128),
            want["mu_prev"].numpy().astype(np.complex128))
    w = want["tail"].numpy()
    g = got["tail"].numpy().reshape(w.shape)
    return float(np.abs(g - w).max() / np.abs(w).max())
