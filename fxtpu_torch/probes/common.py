"""What the probes share: the device argument, CUDA-event timing with the
slope method, and the JSON lines they print."""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import tempfile

import torch

from fxtpu_torch.ops.fx_fused import MAX_SHARED_BYTES  # noqa: F401  (shared)

#: The H100's published device-memory rate (SXM), GB/s.
HBM_GBPS = 3350.0
#: The H100's L2 cache; a walk this long or shorter is served from it.
L2_BYTES = 50 * 2**20


def add_device_argument(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda",
        help="cuda (the default; raises without a card) or cpu (runs the "
             "plain versions: checksums and byte counts, no times)")


def resolve_device(name: str) -> torch.device:
    """``torch.device(name)``; a CUDA device raises when there is no card
    (a probe never falls back to the CPU by itself)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but torch.cuda.is_available() "
                "is False; pass --device cpu to run the plain versions")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"the probes run on cuda or cpu, not {name!r}")
    return device


def card_line(device: torch.device):
    """``nvidia-smi``'s name and power limit of the card (the line every
    kept number is written beside), or None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card (132 on an H100; the same
    figure on the CPU, where only the plans' arithmetic uses it)."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).multi_processor_count
    return 132


def event_ms(fn, n: int = 5, warm: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events over ``n`` calls
    after ``warm`` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: Host calls that put one kernel, copy or memset on the device (the
#: start of the call's runtime-API or driver-API name).
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy",
                "cudaMemset", "cuMemset")


def counted_device_events(events: list, calls: int, lead: int,
                          tail: int = 0):
    """From a trace's events of ``lead + calls + tail`` calls, the device
    events of the ``calls`` calls after the first ``lead`` in the order the
    host launched them, one per launching call (:data:`LAUNCH_CALLS`; a
    call and its device event share a ``correlation``), or None when one of
    them is missing.  Raises when the calls do not hold the same number of
    launches each, or when a device event belongs to a host call that
    :data:`LAUNCH_CALLS` does not name."""
    device = {e["args"]["correlation"]: e for e in events if e.get(
        "cat") in ("kernel", "gpu_memcpy", "gpu_memset")}
    host = sorted((e for e in events if e.get("cat") in (
        "cuda_runtime", "cuda_driver")), key=lambda e: e["ts"])
    launches = [e for e in host if e["name"].startswith(LAUNCH_CALLS)]
    launched = {e["args"]["correlation"] for e in launches}
    others = sorted({e["name"] for e in host
                     if e["args"]["correlation"] in set(device) - launched})
    if others:
        raise RuntimeError(f"device work launched by {others}, which "
                           "LAUNCH_CALLS does not name")
    per, rest = divmod(len(launches), lead + calls + tail)
    if rest or not per:
        raise RuntimeError(
            f"{len(launches)} launching calls in {lead + calls + tail} calls")
    counted = [e["args"]["correlation"]
               for e in launches[lead * per:(lead + calls) * per]]
    if all(c in device for c in counted):
        return [device[c] for c in counted]
    return None


def device_events(fn, calls: int, lead: int = 2, tail: int = 2,
                  tries: int = 10) -> list:
    """What the device ran during ``calls`` calls of ``fn``, in the order
    the host launched them: the events of a CUDA-only ``torch.profiler``
    trace whose ``cat`` is ``kernel``, ``gpu_memcpy`` or ``gpu_memset``
    (``name``; ``dur`` in microseconds), one per launching call.

    The tracer's device records are lossy in a process that has traced a
    long run before: a trace may lack its first launches' records, or
    more.  Its records of the host's calls are not.  So calls that are not
    counted come first (``lead``, doubled on each retake up to 16 times
    as many) and last (``tail``) in the trace, every counted launching
    call must have its device record (:func:`counted_device_events`), and a
    trace that lacks one is taken again.  Raises after ``tries`` such
    traces."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(tries):
        first = lead << min(attempt, 4)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(first + calls + tail):
                fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        counted = counted_device_events(events, calls, first, tail)
        if counted is not None:
            return counted
    raise RuntimeError(f"{tries} traces in a row lack device records of "
                       f"the {calls} counted calls")


def step_exposed_us(events: list, per: int = 3):
    """From the device events of calls that launch ``per`` kernels each,
    the epilogue (``fx_finish_kernel``) last (:func:`device_events` of a
    fused step): the medians of the epilogue's end less its predecessor's
    end, what it adds to the step, and of a call's span on the card (first
    start to last end), in µs.  Raises when a call's last kernel is not
    the epilogue."""
    exposed, span = [], []
    for i in range(0, len(events) - per + 1, per):
        call = events[i:i + per]
        if "fx_finish_kernel" not in call[-1]["name"]:
            raise RuntimeError(f"the step's last kernel is "
                               f"{call[-1]['name'][:60]}")
        end = [e["ts"] + e["dur"] for e in call]
        exposed.append(end[-1] - end[-2])
        span.append(max(end) - call[0]["ts"])
    return statistics.median(exposed), statistics.median(span)


def slope_ms(launch, lo: int, hi: int, n: int = 5):
    """The slope method: ``launch(reps)`` repeats its walk ``reps`` times
    inside one kernel launch; the time of one repeat is the difference of
    a launch at ``hi`` and one at ``lo`` over ``hi - lo``, which cancels
    the launch's fixed cost.  Returns ``(ms_lo, ms_hi, ms_per_rep)``."""
    ms_lo = event_ms(lambda: launch(lo), n)
    ms_hi = event_ms(lambda: launch(hi), n)
    return ms_lo, ms_hi, (ms_hi - ms_lo) / (hi - lo)


def emit(records: list, **fields) -> dict:
    """Print one JSON line and keep it."""
    print(json.dumps(fields), flush=True)
    records.append(fields)
    return fields
