"""The program's own spans in a traced run, and the per-layer readings
made from them.

``fxtpu_torch``'s ``Metrics`` records, once its trace is on, a span for
each stage a block passes through and keys it by the block's ring seq:
the feeders' read, the aligner, the step's enqueue, the writer's queue,
the copy to the host, the text and the flush.  This module turns that
trace on in a traced run, hands its records to the readers as
``Record.counters["program"]``, and adds the program's spans to the host
spans that label the device's idle gaps (:func:`wired`).  The readers
(``metrics/runtime.*``, ``correlator.*``, ``products.*_ms.live``) take a
95th percentile over the rows whose flush ends inside the window
(:func:`row_p95`).

``BENCHMARK.json`` names none of these readers yet: its traced runs go
through ``pipeline.CorrelatorRun`` as it stands.  :data:`PENDING` holds
their entries, and

    python3 -m fxbench.program_spans --workload effex2.live_spectrum --seed <n> --seconds <s> --trace 1

runs a cell as ``fxbench.run`` does, wired, with them, and prints one
JSON line: ``metrics`` (every per-layer metric of the cell, these
included), ``end_to_end``, ``program`` (the rows of the window, those
with a whole chain of spans, the two clocks' drift over the run),
``breakdown`` and ``checks``.  On a program without the trace nothing is
wired and each reader returns None."""

from __future__ import annotations

import contextlib
import json
import sys
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from fxbench import run
from fxbench.cells import Record, find_cell, load_benchmark
from fxbench.pipeline import CorrelatorRun

__all__ = ["PENDING", "CHAIN", "enable", "program_counters", "host_spans",
           "window_rows", "complete", "row_p95", "gap", "length", "wired",
           "summary", "main"]

_LIVE = ["effex2.live_spectrum"]


def _metric(name: str, layer: str, unit: str = "ms",
            better: str = "lower") -> dict:
    return {"name": name, "unit": unit, "better": better,
            "source": "host_clock", "layer": layer,
            "moves": "live_latency_p95_ms", "workloads": list(_LIVE)}


#: The entries of ``BENCHMARK.json``'s ``per_layer`` these readers await.
PENDING = [
    _metric("runtime.handover_ms.live", "runtime"),
    _metric("correlator.enqueue_ms.live", "correlator"),
    _metric("products.queue_ms.live", "products"),
    _metric("products.d2h_ms.live", "products"),
    _metric("products.text_ms.live", "products"),
    _metric("products.row_latency_ms.live", "products"),
    _metric("products.text_cpu_share.live", "products", "%", "higher"),
]

#: A row's chain, in the order its ends fall: the last channel's read of
#: its (last) block, the aligner handing that block over, the put of the
#: row for the writer (a point), the row's wait in the queue, the copy to
#: the host, the text, the flush.
CHAIN = ("runtime.feeder.read", "runtime.align", "products.queued",
         "products.queue", "products.d2h", "products.text", "products.flush")
#: Names kept per block (the rest are kept per row).
_BLOCK_NAMES = ("runtime.feeder.read", "runtime.align")


def enable(cor) -> bool:
    """Turn the Correlator ``cor``'s trace on; False where the program
    has none."""
    start = getattr(getattr(cor, "metrics", None), "start_trace", None)
    if start is None:
        return False
    start()
    return True


def program_counters(cor, lo: float, hi: float) -> dict:
    """What the readers take from a stopped run of ``cor``: the window
    ``[lo, hi]`` (host clock, seconds), every record of its trace as a
    plain tuple ``(name, seq, start_ns, end_ns, cpu_ns, thread, value)``,
    and the ``(time_ns, perf_counter_ns)`` pairs of the trace's start and
    stop (the trace is stopped here)."""
    cor.metrics.stop_trace()
    return {"window": (lo, hi),
            "records": [tuple(r) for r in cor.metrics.trace],
            "clock_pairs": list(cor.metrics.clock_pairs)}


def host_spans(program: dict) -> Dict[str, list]:
    """The program's spans (points left out) as ``(start, end)`` seconds
    by name."""
    out: Dict[str, list] = {}
    for name, _seq, t0, t1, _cpu, _thread, value in program["records"]:
        if value is None:
            out.setdefault(name, []).append((t0 * 1e-9, t1 * 1e-9))
    return out


def _key(seq):
    """A seq as a dict key (a row's ``(first, last)`` may arrive as a
    list)."""
    return tuple(seq) if isinstance(seq, list) else seq


def window_rows(record: Optional[Record]) -> Optional[List[dict]]:
    """Each row whose ``products.flush`` ends inside the window, as a
    dict from each name of :data:`CHAIN` it has to ``(start_s, end_s,
    cpu_s)``; ``runtime.*`` are its last block's (the read whose end is
    latest across the channels).  None without the program's records."""
    program = record.counters.get("program") if record is not None else None
    if not program or not program.get("records"):
        return None
    lo, hi = program["window"]
    blocks: Dict[int, dict] = {}
    rows: Dict[object, dict] = {}
    for name, seq, t0, t1, cpu, _thread, _value in program["records"]:
        if name not in CHAIN or seq is None:
            continue
        span = (t0 * 1e-9, t1 * 1e-9, None if cpu is None else cpu * 1e-9)
        at = (blocks.setdefault(seq, {}) if name in _BLOCK_NAMES
              else rows.setdefault(_key(seq), {}))
        if name not in at or span[1] > at[name][1]:
            at[name] = span
    out = []
    for seq, row in rows.items():
        flush = row.get("products.flush")
        if flush is None or not lo <= flush[1] <= hi:
            continue
        last = seq[1] if isinstance(seq, tuple) else seq
        out.append({**blocks.get(last, {}), **row})
    return out


def complete(row: dict) -> bool:
    """The row has every span of :data:`CHAIN`, and their ends fall in
    its order (the queue's wait from its start: the put's point is taken
    just after the put, which the writer may already have picked up)."""
    if any(name not in row for name in CHAIN):
        return False
    marks = [row["runtime.feeder.read"][1], row["runtime.align"][1],
             row["products.queue"][0], row["products.queue"][1],
             row["products.d2h"][1], row["products.text"][1],
             row["products.flush"][1]]
    return all(a <= b for a, b in zip(marks, marks[1:]))


def row_p95(record: Optional[Record],
            between: Callable[[dict], Optional[float]]) -> Optional[float]:
    """The 95th percentile, in ms, of ``between(row)`` (seconds, or None
    where the row lacks a span it needs) over the window's rows."""
    rows = window_rows(record)
    if not rows:
        return None
    values = [v for v in map(between, rows) if v is not None]
    if not values:
        return None
    return float(np.percentile(np.asarray(values), 95)) * 1e3


def gap(row: dict, a: str, b: str) -> Optional[float]:
    """From the end of ``a`` to the end of ``b``."""
    if a not in row or b not in row:
        return None
    return row[b][1] - row[a][1]


def length(row: dict, *names: str) -> Optional[float]:
    """The summed length of the spans ``names``."""
    if any(n not in row for n in names):
        return None
    return sum(row[n][1] - row[n][0] for n in names)


@contextlib.contextmanager
def wired() -> Iterator[None]:
    """While open, a traced ``CorrelatorRun`` turns the program's trace
    on, hands its records to the readers and its spans to the idle gaps'
    labels; an untraced one is left as it is."""
    init, record = CorrelatorRun.__init__, CorrelatorRun.record

    def traced_init(self, cfg, source, *, trace: bool, **kw):
        init(self, cfg, source, trace=trace, **kw)
        self.program_traced = trace and enable(self.cor)

    def traced_record(self, lo: float, hi: float, counters: dict) -> Record:
        if getattr(self, "program_traced", False):
            program = program_counters(self.cor, lo, hi)
            counters = {**counters, "program": program}
            for name, spans in host_spans(program).items():
                for a, b in spans:
                    self.spans.record(name, a, b)
        return record(self, lo, hi, counters)

    CorrelatorRun.__init__, CorrelatorRun.record = traced_init, traced_record
    try:
        yield
    finally:
        CorrelatorRun.__init__, CorrelatorRun.record = init, record


def summary(program: Optional[dict], record: Record) -> dict:
    """The window's rows, those with a whole chain, and the drift of the
    wall clock against the host clock between the trace's start and
    stop."""
    if not program:
        return {}
    rows = window_rows(record) or []
    out = {"rows": len(rows), "complete_chains": sum(map(complete, rows))}
    pairs = program["clock_pairs"]
    if len(pairs) >= 2:
        (w0, p0), (w1, p1) = pairs[0], pairs[-1]
        out["clock_drift_us"] = ((w1 - w0) - (p1 - p0)) / 1e3
        out["clock_span_s"] = (p1 - p0) / 1e9
    return out


def main(argv=None) -> int:
    args = run.parser().parse_args(argv)
    bench = load_benchmark()
    known = {m["name"] for m in bench["per_layer"]}
    bench["per_layer"] += [m for m in PENDING if m["name"] not in known]
    cell = find_cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("fxbench: needs a CUDA card", file=sys.stderr)
        return 3
    with wired():
        outcome = cell.driver.run(cell, seed=args.seed, seconds=args.seconds,
                                  trace=bool(args.trace), device="cuda")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes),
              "card": run.card_power_limit()}
    line = run.result_line(cell, outcome, bool(args.trace), device,
                           outcome.window_start - run.T_START)
    checks = line.pop("checks")
    line["end_to_end"] = outcome.end_to_end
    if outcome.record is not None:
        line["program"] = summary(outcome.record.counters.get("program"),
                                  outcome.record)
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
