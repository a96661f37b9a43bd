"""The port's own trace on the CPU: ``Metrics`` keeps, once its trace is
on, every stage's span keyed by the ring seq of its block, so each row on
disk can be followed back to the feeders' read of its block.

Each run is a Correlator over a finite source (block 0 calibrates, every
later block writes a row); the chain of a row is held to its order in
time, the staged path and ``integration_blocks`` to their seqs, and a run
without the trace to the same CSV and no records."""

import collections
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.correlator import Correlator  # noqa: E402
from fxtpu_torch.runtime.metrics import Metrics, TraceRecord  # noqa: E402
from fxtpu_torch.sources import NoiseSource, save_recording  # noqa: E402
from fxtpu_torch.sources.base import LimitedSource  # noqa: E402

SMALL = dict(num_samp=2**13, nbins=256, clamp_num_samp=False, run_time=60,
             startup_duration=0.1, loglevel="WARNING", device="cpu")
BLOCKS = 7


def _run(tmp_path, source, *, trace=True, name="v", **kw):
    """A Correlator over ``source`` (``replay``: a recording of BLOCKS
    blocks; ``split``: the synthetic source, a feeder a channel;
    ``joint``: the synthetic source through one feeder), run to its end."""
    out = str(tmp_path / f"{name}.csv")
    noise = NoiseSource(nchan=2, delays=[0.0, 2e-6], seed=41)
    if source == "replay":
        rec = save_recording(noise, str(tmp_path / "rec.npy"),
                             SMALL["num_samp"], BLOCKS)
        cor = Correlator(config=CorrelatorConfig(
            **SMALL, **kw, source="replay", replay_file=rec,
            output_file=out))
    else:
        cor = Correlator(config=CorrelatorConfig(
            **SMALL, **kw, output_file=out,
            channel_feeders=source == "split"),
            source=LimitedSource(noise, BLOCKS))
    if trace:
        cor.metrics.start_trace()
    cor.run_state_machine()
    return cor


def _by_name(cor):
    out = collections.defaultdict(list)
    for r in cor.metrics.trace:
        out[r.name].append(r)
    return out


def _one(records, seq):
    found = [r for r in records if r.seq == seq]
    assert len(found) == 1, (seq, found)
    return found[0]


@pytest.mark.parametrize("source", ["replay", "split", "joint"])
def test_every_row_has_one_chain_in_time_order(tmp_path, source):
    cor = _run(tmp_path, source)
    spans = _by_name(cor)
    assert cor.writer.rows_written == BLOCKS - 1
    assert cor.metrics.get("products.rows_written") == cor.writer.rows_written
    assert 1 <= cor.metrics.get("products.wakes") <= cor.writer.rows_written
    rows = [r.seq for r in spans["products.flush"]]
    assert rows == list(range(1, BLOCKS))
    assert [r.seq for r in spans["products.rows_written"]] == rows
    feeders = {r.thread for r in spans["runtime.feeder.read"]}
    assert len(feeders) == 1   # one thread name, one feeder or two
    nread = 1 if source == "joint" else 2
    cal = _one(spans["correlator.calibrate"], 0)
    assert _one(spans["correlator.h2d"], 0).end_ns <= cal.start_ns
    for seq in rows:
        reads = [r for r in spans["runtime.feeder.read"] if r.seq == seq]
        puts = [r for r in spans["runtime.feeder.put"] if r.seq == seq]
        assert len(reads) == len(puts) == nread
        for read, put in zip(sorted(reads, key=lambda r: r.thread),
                             sorted(puts, key=lambda r: r.thread)):
            assert read.end_ns <= put.end_ns
        align = _one(spans["runtime.align"], seq)
        copy = _one(spans["runtime.align.copy"], seq)
        h2d = _one(spans["correlator.h2d"], seq)
        step = _one(spans["correlator.fx_step"], seq)
        queued = _one(spans["products.queued"], seq)
        queue = _one(spans["products.queue"], seq)
        d2h = _one(spans["products.d2h"], seq)
        text = _one(spans["products.text"], seq)
        flush = _one(spans["products.flush"], seq)
        written = _one(spans["products.rows_written"], seq)
        # the put's end is taken after the ring's commit, which the
        # aligner may see first
        assert max(r.end_ns for r in reads) <= align.end_ns
        assert max(r.start_ns for r in puts) <= align.end_ns
        assert align.start_ns <= copy.start_ns <= copy.end_ns <= align.end_ns
        assert align.end_ns <= h2d.start_ns <= h2d.end_ns <= step.start_ns
        assert step.start_ns <= queue.start_ns <= queued.end_ns <= step.end_ns
        assert queue.end_ns <= d2h.start_ns <= d2h.end_ns <= text.start_ns
        assert text.end_ns <= flush.start_ns <= flush.end_ns <= written.end_ns
        assert queued.value >= 1 and written.value == 1
        assert align.thread == h2d.thread == step.thread == queued.thread
        assert {queue.thread, d2h.thread, text.thread} == {
            "fxtpu_torch-writer"}
        for r in (*reads, *puts, align, copy, h2d, step, d2h, text, flush):
            assert r.cpu_ns >= 0
    assert queue.cpu_ns is None   # a wait handed between threads


def test_staged_path_keys_batches_and_rows(tmp_path):
    """K = 4: block 0 calibrates unstaged, blocks 1-4 are one staged call
    whose spans carry its first and last seq, blocks 5 and 6 the tail, a
    call each; each block of a call still writes its own row."""
    cor = _run(tmp_path, "split", blocks_per_dispatch=4)
    spans = _by_name(cor)
    assert [r.seq for r in spans["runtime.stage"]] == [(1, 4)]
    assert {r.thread for r in spans["runtime.stage"]} == {
        "fxtpu_torch-stager"}
    steps = [r.seq for r in spans["correlator.fx_step"]]
    assert steps[0] == (1, 4) and steps[1:] == [5, 6]   # the tail, a block
    assert [r.seq for r in spans["products.flush"]] == list(range(1, BLOCKS))
    assert {r.thread for r in spans["runtime.align"] if r.seq != 0} == {
        "fxtpu_torch-stager"}
    call = _one(spans["correlator.fx_step"], (1, 4))
    for seq in range(1, 5):
        assert call.start_ns <= _one(spans["products.queued"],
                                     seq).end_ns <= call.end_ns


def test_integrated_row_carries_its_first_and_last_seq(tmp_path):
    cor = _run(tmp_path, "split", integration_blocks=2)
    spans = _by_name(cor)
    rows = [(1, 2), (3, 4), (5, 6)]
    assert cor.writer.rows_written == len(rows)
    for name in ("products.queued", "products.queue", "products.d2h",
                 "products.text", "products.flush", "products.rows_written"):
        assert [r.seq for r in spans[name]] == rows, name
    assert [r.seq for r in spans["correlator.fx_step"]] == list(range(1, 7))


def test_untraced_run_records_nothing_and_writes_the_same_csv(tmp_path):
    traced = _run(tmp_path, "replay", name="traced")
    plain = _run(tmp_path, "replay", trace=False, name="plain")
    assert traced.metrics.trace and not plain.metrics.trace
    assert not plain.metrics.tracing and not plain.metrics.clock_pairs
    with open(traced.output_file, "rb") as a, open(plain.output_file,
                                                   "rb") as b:
        assert a.read() == b.read()
    # the timers and counters are kept either way
    assert plain.metrics.timer("fx_step").count == BLOCKS - 1
    assert plain.metrics.get("products.rows_written") == BLOCKS - 1


def test_profile_dir_turns_the_trace_on_with_ranges(tmp_path):
    cor = _run(tmp_path, "joint", trace=False,
               profile_dir=str(tmp_path / "prof"))
    assert not cor.metrics.tracing and len(cor.metrics.clock_pairs) == 2
    names = {r.name for r in cor.metrics.trace}
    assert {"runtime.align", "correlator.fx_step", "products.flush"} <= names
    with open(tmp_path / "prof" / "trace.json") as fh:
        events = json.load(fh)["traceEvents"]
    ranges = {e.get("name") for e in events}
    assert {"runtime.align", "correlator.h2d", "correlator.fx_step"} <= ranges


def test_metrics_spans_points_and_handoffs():
    m = Metrics()
    with m.stage("correlator.fx_step", 3):
        pass
    m.count("blocks", 1, 3)
    assert m.timer("fx_step").count == 1 and not m.trace   # off: timers only
    m.start_trace()
    span = m.begin("runtime.align")
    m.drop(span)                       # a wait that returned nothing
    with m.stage("correlator.fx_step", (4, 7)):
        time.sleep(0.002)
    m.hand_off("products.queue", 5)
    m.gauge("products.queued", 2, 5)
    m.gauge("products.queued", 1, 6)
    done = threading.Thread(target=m.pick_up, args=("products.queue", 5),
                            name="picker")
    done.start()
    done.join()
    m.pick_up("products.queue", 9)     # never handed off: nothing kept
    m.count("products.rows_written", 1, 5)
    m.stop_trace()
    with m.stage("correlator.fx_step", 8):
        pass
    assert [(r.name, r.seq) for r in m.trace] == [
        ("correlator.fx_step", (4, 7)), ("products.queued", 5),
        ("products.queued", 6), ("products.queue", 5),
        ("products.rows_written", 5)]
    step, _, _, queue, written = m.trace
    assert isinstance(step, TraceRecord) and step.value is None
    assert step.end_ns - step.start_ns >= 2e6 and step.cpu_ns >= 0
    assert queue.thread == "picker" and queue.cpu_ns is None
    assert written.start_ns == written.end_ns and written.value == 1
    assert m.timer("fx_step").count == 3 and m.timer("align") is None
    assert m.get("products.rows_written") == 1
    assert "products.queued: max 2" in m.report()
    (w0, p0), (w1, p1) = m.clock_pairs
    assert p1 > p0 and abs((w1 - w0) - (p1 - p0)) < 1e8


def test_marks_and_rates_read_the_host_clock():
    """``mark_once`` and ``started_at`` are on ``perf_counter``, the
    clock of every span."""
    m = Metrics()
    assert abs(m.started_at - time.perf_counter()) < 1.0
    m.count("blocks", 4)
    m.mark_once("end")
    t = m._marks["end"][0]
    assert m.started_at <= t <= time.perf_counter()
    time.sleep(0.05)
    ended = m.rates(until="end")
    assert ended == m.rates(until="end")
    assert ended["blocks_per_s"] == pytest.approx(4 / (t - m.started_at))
    assert np.isfinite(m.rates()["blocks_per_s"])


def test_metrics_lose_nothing_across_threads():
    """Sixteen threads close spans, count and hand items over at once,
    with the interpreter switching threads every microsecond: every span,
    count and hand-over is kept once."""
    import sys
    m, n, per = Metrics(), 16, 300
    m.start_trace()

    def work(w):
        for i in range(per):
            seq = w * per + i
            with m.stage("runtime.align", seq):
                m.hand_off("products.queue", seq)
            m.count("blocks", 1, seq)
            m.pick_up("products.queue", seq)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(w,)) for w in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    trace = m.trace
    assert m.timer("align").count == m.get("blocks") == n * per
    for name in ("runtime.align", "blocks", "products.queue"):
        seqs = sorted(r.seq for r in trace if r.name == name)
        assert seqs == list(range(n * per)), name
