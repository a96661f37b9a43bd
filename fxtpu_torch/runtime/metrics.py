"""Structured per-stage timing, throughput counters, and the run's trace.

Replaces the reference's ad-hoc DEBUG wall-clock logging around each hot
stage (``effex/effex.py:361-373,390-397,405-408,415-417``)
with accumulating stage timers and science-rate counters — these are the
BASELINE metrics (samples/s, spectra/s) reported at shutdown and queryable
live.  A ``torch.profiler`` trace can be wrapped around any region for
kernel-level analysis (SURVEY.md §5.1).

:class:`Metrics` is also the program's one tracer.  A span is named
``<layer>.<stage>`` (``runtime.feeder.read``, ``correlator.fx_step``,
``products.text``) and feeds the timer of its stage, named without the
layer (``feeder.read``, ``fx_step``, ``text``).  While the trace is on
(:meth:`Metrics.start_trace`) every span and every count or gauge is also
kept as a :class:`TraceRecord` carrying the ring seq of its block, so one
block can be followed from the receivers' read to its row on disk.  Every
time is ``time.perf_counter_ns``; off, a span costs one attribute test
more than its timer.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

logger = logging.getLogger(__name__)

#: A record's block id: the ring seq of one block, ``(first, last)`` of a
#: staged batch or an integrated row, None where no block is meant.
Seq = Union[int, Tuple[Optional[int], int], None]


class TraceRecord(NamedTuple):
    """One span or point of a traced run.  Times are ``perf_counter_ns``;
    a span has its thread's CPU time over it in ``cpu_ns`` (None for a
    wait handed from one thread to another), a point (a count or a gauge)
    ``start_ns == end_ns`` and its ``value``."""
    name: str
    seq: Seq
    start_ns: int
    end_ns: int
    cpu_ns: Optional[int]
    thread: str
    value: Optional[float] = None


class StageTimer:
    """Accumulating timer for one pipeline stage."""

    __slots__ = ("name", "total", "count", "last", "max")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0
        self.count = 0
        self.last = 0.0
        self.max = 0.0

    def add(self, dt: float):
        self.total += dt
        self.count += 1
        self.last = dt
        if dt > self.max:
            self.max = dt

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> str:
        return (f"{self.name}: n={self.count} mean={self.mean * 1e3:.3f}ms "
                f"last={self.last * 1e3:.3f}ms max={self.max * 1e3:.3f}ms "
                f"total={self.total:.3f}s")


class Metrics:
    """Thread-safe stage timers, monotonic counters, gauges and the trace
    of one run."""

    def __init__(self):
        self._timers: Dict[str, StageTimer] = {}
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        self._marks: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.started_at = time.perf_counter()
        #: ``(time.time_ns(), time.perf_counter_ns())`` at each start and
        #: stop of the trace: the drift between the two clocks over a run.
        self.clock_pairs: List[Tuple[int, int]] = []
        # The records' fields, flat: a list of numbers and strings holds no
        # object a record, so the trace leaves the garbage collector's
        # counts as they are; a tuple a record would bring the next full
        # collection, which stalls every thread for 0.1-0.3 s, sooner.
        self._records: list = []
        self._tracing: Optional[list] = None
        self._ranges = False
        self._handed: Dict[tuple, int] = {}

    # -- the trace ----------------------------------------------------------
    @property
    def tracing(self) -> bool:
        return self._tracing is not None

    @property
    def trace(self) -> List[TraceRecord]:
        """Every record kept while the trace was on, in the order closed."""
        with self._lock:
            flat = list(self._records)
        n = len(TraceRecord._fields)
        return [TraceRecord(*flat[i:i + n]) for i in range(0, len(flat), n)]

    def start_trace(self, ranges: bool = False):
        """Keep every span, count and gauge from now on (:attr:`trace`);
        with ``ranges`` also enter each span as a
        ``torch.profiler.record_function`` range (a profile then shows the
        program's spans beside its kernels)."""
        with self._lock:
            self.clock_pairs.append((time.time_ns(), time.perf_counter_ns()))
            self._ranges = ranges
            self._tracing = self._records

    def stop_trace(self):
        with self._lock:
            self._tracing = None
            self._ranges = False
            self._handed.clear()
            self.clock_pairs.append((time.time_ns(), time.perf_counter_ns()))

    def _keep(self, record: tuple):
        """Append ``record`` (a :class:`TraceRecord`'s fields) to the
        trace; the caller holds the lock."""
        if self._tracing is not None:
            self._tracing.extend(record)

    # -- timers ----------------------------------------------------------
    def begin(self, name: str) -> tuple:
        """Open span ``name`` on this thread: close it with :meth:`end`, or
        :meth:`drop` it where it timed nothing."""
        if self._tracing is None:
            return name, time.perf_counter_ns(), None, None
        ranges = None
        if self._ranges:
            import torch
            ranges = torch.profiler.record_function(name)
            ranges.__enter__()
        return name, time.perf_counter_ns(), time.thread_time_ns(), ranges

    def end(self, span: tuple, seq: Seq = None):
        """Close ``span``: its stage's timer takes its time, and where it
        was opened while tracing it is kept with ``seq``."""
        t1 = time.perf_counter_ns()
        name, t0, c0, ranges = span
        if ranges is not None:
            ranges.__exit__(None, None, None)
        cpu = None if c0 is None else time.thread_time_ns() - c0
        stage = name.partition(".")[2] or name
        with self._lock:
            timer = self._timers.get(stage)
            if timer is None:
                timer = self._timers[stage] = StageTimer(stage)
            timer.add((t1 - t0) * 1e-9)
            if cpu is not None:
                self._keep((name, seq, t0, t1, cpu,
                            threading.current_thread().name, None))

    def drop(self, span: tuple):
        """Discard ``span`` (a wait that returned nothing)."""
        if span[3] is not None:
            span[3].__exit__(None, None, None)

    @contextlib.contextmanager
    def stage(self, name: str, seq: Seq = None):
        span = self.begin(name)
        try:
            yield
        finally:
            self.end(span, seq)

    def timer(self, name: str) -> Optional[StageTimer]:
        return self._timers.get(name)

    def hand_off(self, name: str, seq: Seq):
        """Open span ``name`` of ``seq`` on this thread, for another thread
        to close with :meth:`pick_up` (the wait of an item in a queue);
        kept only in the trace."""
        if self._tracing is not None:
            with self._lock:
                self._handed[(name, seq)] = time.perf_counter_ns()

    def pick_up(self, name: str, seq: Seq):
        if self._tracing is None:
            return
        t1 = time.perf_counter_ns()
        with self._lock:
            t0 = self._handed.pop((name, seq), None)
            if t0 is not None:
                self._keep((name, seq, t0, t1, None,
                            threading.current_thread().name, None))

    # -- counters ----------------------------------------------------------
    def count(self, name: str, value: float = 1, seq: Seq = None):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value
            if self._tracing is not None:
                self._keep(self._point(name, seq, value))

    def gauge(self, name: str, value: float, seq: Seq = None):
        """A level (a queue's depth): its largest reading is kept, and
        while tracing each reading with its time."""
        with self._lock:
            self._gauges[name] = max(self._gauges.get(name, value), value)
            if self._tracing is not None:
                self._keep(self._point(name, seq, value))

    @staticmethod
    def _point(name: str, seq: Seq, value: float) -> tuple:
        t = time.perf_counter_ns()
        return name, seq, t, t, None, threading.current_thread().name, value

    def get(self, name: str) -> float:
        return self._counters.get(name, 0)

    def mark_once(self, name: str):
        """Snapshot (time, counters) the FIRST time ``name`` is marked —
        e.g. 'steady' after the first device dispatch returns, so sustained
        rates exclude compile/warmup."""
        with self._lock:
            if name not in self._marks:
                self._marks[name] = (time.perf_counter(),
                                     dict(self._counters))

    # -- reporting ----------------------------------------------------------
    def rates(self, since: Optional[str] = None,
              until: Optional[str] = None) -> Dict[str, float]:
        """Throughput rates over the whole run, or between the
        :meth:`mark_once` marks ``since`` (e.g. 'steady', so sustained
        rates exclude warm-up) and ``until`` (e.g. 'end', so a report
        read after the run is not diluted by the time since); a mark not
        set yet stands for the run's start or now."""
        t0, base = self.started_at, {}
        if since is not None and since in self._marks:
            t0, base = self._marks[since]
        t1, top = time.perf_counter(), self._counters
        if until is not None and until in self._marks:
            t1, top = self._marks[until]
        elapsed = max(t1 - t0, 1e-9)

        def delta(name):
            return top.get(name, 0) - base.get(name, 0)

        return {
            "elapsed_s": elapsed,
            "samples_per_s": delta("samples_in") / elapsed,
            "blocks_per_s": delta("blocks") / elapsed,
            "spectra_per_s": delta("spectra_out") / elapsed,
        }

    def report(self) -> str:
        lines = ["run metrics:"]
        r = self.rates(until="end")
        lines.append(
            f"  throughput: {r['samples_per_s'] / 1e6:.2f} Msamp/s, "
            f"{r['blocks_per_s']:.2f} blocks/s, "
            f"{r['spectra_per_s']:.2f} integrated spectra/s "
            f"over {r['elapsed_s']:.1f}s")
        with self._lock:
            for k in sorted(self._counters):
                lines.append(f"  {k}: {self._counters[k]:.0f}")
            for k in sorted(self._gauges):
                lines.append(f"  {k}: max {self._gauges[k]:.0f}")
            for t in self._timers.values():
                lines.append("  " + t.summary())
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace (no-op when log_dir is
    None).  Writes ``trace.json`` (Chrome trace format; open it in
    Perfetto or chrome://tracing) into ``log_dir``; CUDA activity is
    recorded when a card is present."""
    if not log_dir:
        yield
        return
    import os

    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
