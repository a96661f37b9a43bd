"""Structured per-stage timing + throughput counters (+ profiler hooks).

Replaces the reference's ad-hoc DEBUG wall-clock logging around each hot
stage (``effex/effex.py:361-373,390-397,405-408,415-417``)
with accumulating stage timers and science-rate counters — these are the
BASELINE metrics (samples/s, spectra/s) reported at shutdown and queryable
live.  A ``torch.profiler`` trace can be wrapped around any region for
kernel-level analysis (SURVEY.md §5.1).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


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
    """Thread-safe stage timers + monotonic counters for one run."""

    def __init__(self):
        self._timers: Dict[str, StageTimer] = {}
        self._counters: Dict[str, float] = {}
        self._marks: Dict[str, tuple] = {}
        self._lock = threading.Lock()
        self.started_at = time.time()

    # -- timers ----------------------------------------------------------
    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._timers.setdefault(name, StageTimer(name)).add(dt)

    def timer(self, name: str) -> Optional[StageTimer]:
        return self._timers.get(name)

    # -- counters ----------------------------------------------------------
    def count(self, name: str, value: float = 1):
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def get(self, name: str) -> float:
        return self._counters.get(name, 0)

    def mark_once(self, name: str):
        """Snapshot (time, counters) the FIRST time ``name`` is marked —
        e.g. 'steady' after the first device dispatch returns, so sustained
        rates exclude compile/warmup."""
        with self._lock:
            if name not in self._marks:
                self._marks[name] = (time.time(), dict(self._counters))

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
        t1, top = time.time(), self._counters
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
