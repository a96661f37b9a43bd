"""The readers of the program's own spans: each one's p95 over the rows of
a hand-built trace whose seqs and times are known, None without the
program's records, and the wiring on the live cell at the CPU's size."""

import numpy as np
import pytest

from fxbench import cells, program_spans
from fxbench.cells import Record, load_benchmark, metric_reader
from fxbench.pipeline import CorrelatorRun
from fxbench.tests.conftest import tiny_cell
from fxbench.tests.test_fxbench_cells import NAME, UNIT

MS = 1_000_000   # ns


def _rows(n: int, lo_s: float = 10.0):
    """Records of rows 1..n, row r's block read ending at lo + r / 10 s,
    each stage r-dependent, so the p95 of each reading is known; and the
    readings each row should give, in ms."""
    recs, want = [], {m["name"]: [] for m in program_spans.PENDING}
    for r in range(1, n + 1):
        t = int((lo_s + r / 10) * 1e9)
        read0 = (t - 3 * MS, t - 2 * MS + r * 1000)   # the other channel
        read1 = (t - 2 * MS, t)                        # ends last
        align = t + (100 + r) * 1000
        queued = align + (2 * MS + r * 2000)
        queue = (queued - 1000, queued + 90 * MS + r * MS)
        d2h = (queue[1], queue[1] + MS + r * 100)
        text = (d2h[1], d2h[1] + 8 * MS + r * 10_000)
        flush = (text[1], text[1] + 5000)
        recs += [("runtime.feeder.read", r, *read0, 1, "feeder", None),
                 ("runtime.feeder.read", r, *read1, 1, "feeder", None),
                 ("runtime.feeder.put", r, t, t + 1000, 1, "feeder", None),
                 ("runtime.align", r, align - 500_000, align, 1, "main",
                  None),
                 ("correlator.fx_step", r, align, queued + 500, 1, "main",
                  None),
                 ("products.queued", r, queued, queued, None, "main", 1),
                 ("products.queue", r, *queue, None, "writer", None),
                 ("products.d2h", r, *d2h, 1, "writer", None),
                 ("products.text", r, *text, (text[1] - text[0]) // 2,
                  "writer", None),
                 ("products.flush", r, *flush, 1, "writer", None),
                 ("products.rows_written", r, flush[1], flush[1], None,
                  "writer", 1)]
        add = lambda name, ns: want[name].append(ns / MS)  # noqa: E731
        add("runtime.handover_ms.live", align - read1[1])
        add("correlator.enqueue_ms.live", queued - align)
        add("products.queue_ms.live", queue[1] - queue[0])
        add("products.d2h_ms.live", d2h[1] - d2h[0])
        add("products.text_ms.live", text[1] - text[0] + flush[1] - flush[0])
        add("products.row_latency_ms.live", flush[1] - read1[1])
        add("products.text_cpu_share.live", 50.0)
    return recs, want


def _record(recs, lo, hi, **counters):
    return Record(spans={}, counters={
        **counters, "program": {"window": (lo, hi), "records": recs,
                                "clock_pairs": []}}, trace=None)


@pytest.mark.parametrize("name", [m["name"] for m in program_spans.PENDING])
def test_each_reader_gives_its_p95_over_the_window(name):
    recs, want = _rows(40)
    # the window takes the rows whose flush ends inside it: 5..34
    ends = sorted(r[3] for r in recs if r[0] == "products.flush")
    lo, hi = ends[4] / 1e9, ends[33] / 1e9
    # a row flushed before the window, and a count without a seq
    extra = [("products.flush", 99, int(5e9), int(5e9) + 1, 1, "writer",
              None), ("blocks", None, int(12e9), int(12e9), None, "main", 1)]
    got = metric_reader(name)(_record(recs + extra, lo, hi, rows=30))
    inside = want[name][4:34]
    if name.endswith("cpu_share.live"):
        assert got == pytest.approx(50.0, rel=1e-6)
    else:
        assert got == pytest.approx(np.percentile(inside, 95), rel=1e-9)
        assert got != pytest.approx(np.percentile(want[name], 95), rel=1e-9)


@pytest.mark.parametrize("name", [m["name"] for m in program_spans.PENDING])
def test_each_reader_reads_nothing_without_the_program(name):
    read = metric_reader(name)
    assert read(Record(spans={}, counters={"rows": 3}, trace=None)) is None
    assert read(None) is None
    assert read(_record([], 0.0, 1.0)) is None


def test_rows_are_keyed_by_their_last_block():
    """An integrated row ``(first, last)``: its read and aligner spans are
    its last block's, and its chain is whole."""
    recs, _ = _rows(4)
    row_of = {1: None, 2: [1, 2]}    # blocks 1 and 2 make one row
    merged = [(rec[0], row_of.get(rec[1], rec[1]), *rec[2:])
              if rec[0].startswith("products.") else rec for rec in recs]
    merged = [rec for rec in merged if rec[1] is not None]
    rows = program_spans.window_rows(_record(merged, 0.0, 100.0))
    assert len(rows) == 3 and all(map(program_spans.complete, rows))

    def end(name, seq):
        return max(r[3] for r in recs if r[:2] == (name, seq)) * 1e-9

    row = next(r for r in rows
               if r["products.flush"][1] == end("products.flush", 2))
    assert row["runtime.align"][1] == end("runtime.align", 2)
    assert row["runtime.feeder.read"][1] == end("runtime.feeder.read", 2)


def test_pending_entries_fit_the_benchmark():
    bench = load_benchmark()
    e2e = {m["name"] for m in bench["end_to_end"]}
    layers = {m["layer"] for m in bench["per_layer"]}
    workloads = {w["name"] for w in bench["workloads"]}
    names = {m["name"] for m in bench["per_layer"]}
    for m in program_spans.PENDING:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["name"] not in names and m["moves"] in e2e
        assert set(m["workloads"]) <= workloads
        assert m["layer"] in layers | {"runtime", "correlator"}
        assert (cells.HERE / "metrics" / f"{m['name']}.py").exists()


def test_the_live_cell_wired_reads_every_row():
    cell = tiny_cell("effex2.live_spectrum")
    init = CorrelatorRun.__init__
    with program_spans.wired():
        out = cell.driver.run(cell, seed=2**31 + 23, seconds=1.5,
                              trace=True, device="cpu")
    assert CorrelatorRun.__init__ is init
    program = out.record.counters["program"]
    summary = program_spans.summary(program, out.record)
    assert summary["rows"] == summary["complete_chains"] >= out.attempted - 3
    assert summary["clock_span_s"] > 1.5
    for m in program_spans.PENDING:
        assert metric_reader(m["name"])(out.record) > 0, m["name"]
    # the program's spans label the idle gaps beside the harness's
    assert {"runtime.feeder.read", "runtime.align",
            "products.append_visibility"} <= set(out.record.spans)
    queue = metric_reader("products.queue_ms.live")(out.record)
    assert 50 < queue < 150    # the writer's 0.1 s poll
