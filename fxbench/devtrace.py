"""The device's side of a traced run: a CUDA-only ``torch.profiler`` trace
and what the harness reads from it.

The busy time is the union of the kernels', copies' and memsets' spans
inside the traced window; device records are matched to the host's
launching calls by ``correlation``, and launches whose record the tracer
lost are counted beside it, since a busy share over a trace that lost some
reads low.  The trace's clock (``ts`` in microseconds after
``baseTimeNanoseconds``, the wall clock) is moved onto the host clock the
harness's spans use (``time.perf_counter``)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, List, Tuple

__all__ = ["LAUNCH_CALLS", "DeviceTrace", "union", "gaps", "summarise"]

#: Host calls that put work on the device, by name prefix.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(spans: List[Tuple[float, float]], lo: float, hi: float
          ) -> List[Tuple[float, float]]:
    """``spans`` clipped to ``[lo, hi]`` and merged where they overlap."""
    out: List[List[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(busy: List[Tuple[float, float]], lo: float, hi: float
         ) -> List[Tuple[float, float]]:
    """The idle intervals of ``[lo, hi]`` between the merged ``busy``."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def summarise(events: List[dict], base_us: float, wall_minus_pc: float,
              lo: float, hi: float, host_spans: Dict[str, list]) -> dict:
    """The traced window ``[lo, hi]`` (host clock, seconds) of a trace's
    ``events``: busy and idle seconds, kernel and copy seconds, device
    seconds by operation name, launches and lost records, and the ten
    longest idle gaps labelled by the host spans that cover their middle
    (``"host idle"`` where none does)."""
    def host_s(ts_us: float) -> float:
        return (ts_us + base_us) / 1e6 - wall_minus_pc

    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    launched = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("name", "").startswith(LAUNCH_CALLS)
                and lo <= host_s(e["ts"]) <= hi}
    recorded = {e.get("args", {}).get("correlation") for e in device}
    spans, kern, copy, by_name = [], 0.0, 0.0, {}
    for e in device:
        a = host_s(e["ts"])
        b = a + e["dur"] / 1e6
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        spans.append((a, b))
        if e["cat"] == "kernel":
            kern += b - a
        elif e["cat"] == "gpu_memcpy":
            copy += b - a
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a)
    busy = union(spans, lo, hi)
    idle = gaps(busy, lo, hi)
    labelled = []
    for a, b in sorted(idle, key=lambda g: g[1] - g[0], reverse=True)[:10]:
        mid = 0.5 * (a + b)
        names = sorted(n for n, ss in host_spans.items()
                       if any(s0 <= mid <= s1 for s0, s1 in ss))
        labelled.append(["+".join(names) or "host idle", b - a])
    return {
        "window_s": hi - lo,
        "busy_s": sum(b - a for a, b in busy),
        "kernel_s": kern,
        "copy_s": copy,
        "launches": len(launched),
        "lost_records": len(launched - recorded),
        "device_ops": sorted(([n, s] for n, s in by_name.items()),
                             key=lambda x: x[1], reverse=True)[:10],
        "idle_gaps": labelled,
        "device_events": len(spans),
    }


class DeviceTrace:
    """A CUDA-only profile, started and stopped by the harness; its trace
    is written to ``tmpdir`` and read back by :meth:`read`."""

    def __init__(self, tmpdir: str):
        self.path = os.path.join(tmpdir, "trace.json")
        self._prof = None

    def start(self):
        import torch
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()

    def stop(self):
        self._prof.stop()

    def read(self, lo: float, hi: float, host_spans: Dict[str, list]
             ) -> dict:
        """Export, read and summarise the trace over ``[lo, hi]``."""
        self._prof.export_chrome_trace(self.path)
        with open(self.path) as fh:
            doc = json.load(fh)
        os.remove(self.path)
        events = doc.get("traceEvents", [])
        base_us = float(doc.get("baseTimeNanoseconds", 0)) / 1e3
        wall_minus_pc = time.time() - time.perf_counter()
        out = summarise(events, base_us, wall_minus_pc, lo, hi, host_spans)
        if out["device_events"] == 0 and any(
                e.get("cat") in DEVICE_CATS for e in events):
            starts = [e["ts"] for e in events if e.get("cat") in DEVICE_CATS]
            print(f"fxbench: the trace's clock does not meet the host's: "
                  f"device events at {min(starts) + base_us:.0f} us, "
                  f"window {(lo + wall_minus_pc) * 1e6:.0f} us",
                  file=sys.stderr)
        return out
