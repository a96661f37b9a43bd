"""The benchmark's definition: every cell, mix, driver, check and metric is
found by name from its own file, and a cell made of new files alone runs."""

import json
import re
import shutil

import pytest

from fxbench import cells
from fxbench.cells import find_cell, load_benchmark, metric_reader
from fxbench.run import result_line
from fxbench.tests.conftest import tiny_cell

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = find_cell(BENCH, workload)
    assert callable(cell.driver.run)
    assert cell.chips in (1, 4)   # run.py asks torch for this many cards
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert callable(metric_reader(m["name"]))
    assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
    fields = cell.correlator_fields()
    from fxtpu_torch.config import CorrelatorConfig
    CorrelatorConfig(**fields, device="cpu")   # the fields are the config's
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert isinstance(entry["reduced"], list)
    assert cell.config["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= set(cell.config["correlator"])


def test_benchmark_json_keeps_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fxbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    all_names = ([c["name"] for c in BENCH["configs"]]
                 + [w["name"] for w in BENCH["workloads"]]
                 + [m["name"] for m in BENCH["end_to_end"]]
                 + [m["name"] for m in BENCH["per_layer"]])
    assert all(NAME.match(n) for n in all_names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fxbench/")
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert (HERE_METRICS / f"{m['name']}.py").exists()
    # the whole check fits its time with 24 cells
    cell_s = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * cell_s + 24 * 180 + 1200 <= 43200


HERE_METRICS = cells.HERE / "metrics"


def test_a_cell_from_new_files_alone(tmp_path):
    """A later cell: a configuration, a mix, the driver it names, its
    limits and a per-layer metric, each a new file under the checkout, and
    entries in BENCHMARK.json; nothing that is there is edited.  The mix
    runs the live driver in CONTINUUM at 8 blocks a call, which no cell
    here runs: the stager and the continuum rows' check."""
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "fxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = root / "fxbench"
    conf = json.loads((here / "configs" / "effex2.json").read_text())
    conf["correlator"]["ntaps"] = 8
    (here / "configs" / "effex8tap.json").write_text(json.dumps(conf))
    mix = json.loads((here / "mixes" / "live_spectrum.json").read_text())
    mix["check_rows"] = 5
    mix["correlator"] = {"mode": "CONTINUUM", "blocks_per_dispatch": 8}
    mix["driver"] = "live_again"
    (here / "drivers" / "live_again.py").write_text(
        "from fxbench.drivers.live import run  # noqa: F401\n")
    (here / "mixes" / "live_continuum_k8.json").write_text(json.dumps(mix))
    (here / "checks" / "effex8tap.live_continuum_k8.json").write_text(
        json.dumps({"limits": {"delay_gap_samples": 0.1, "row_gap": 1e-5,
                               "failed_blocks": 0}}))
    (here / "metrics" / "rows_in_window.py").write_text(
        "def read(record):\n    return record.counters.get('rows')\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "effex8tap", "source": "x",
                             "file": "fxbench/configs/effex8tap.json",
                             "reduced": [], "why": "8 taps"})
    bench["workloads"].append({"name": "effex8tap.live_continuum_k8",
                               "config": "effex8tap",
                               "traffic": "live_continuum_k8", "chips": 1,
                               "why": "test"})
    next(m for m in bench["end_to_end"] if m["name"] == "live_latency_p95_ms"
         )["workloads"].append("effex8tap.live_continuum_k8")
    bench["per_layer"].append({"name": "rows_in_window", "unit": "rows",
                               "better": "higher", "source": "host_clock",
                               "layer": "products",
                               "moves": "live_latency_p95_ms",
                               "workloads": ["effex8tap.live_continuum_k8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = tiny_cell("effex8tap.live_continuum_k8", root=root)
    assert cell.correlator_fields()["ntaps"] == 8
    assert cell.correlator_fields()["blocks_per_dispatch"] == 8
    assert cell.driver.__file__ == str(here / "drivers" / "live_again.py")
    assert [m["name"] for m in cell.per_layer][-1] == "rows_in_window"
    out = cell.driver.run(cell, seed=2**31 + 17, seconds=1.5, trace=True,
                          device="cpu")
    rows = metric_reader("rows_in_window", root)(out.record)
    assert rows == out.attempted > 0
    line = result_line(cell, out, False, {}, 1.0)
    assert line["correct"] and list(line)[-1] == "checks", line["checks"]
    assert set(line["metrics"]) == {"live_latency_p95_ms", "setup_s"}


def test_drivers_are_modules_by_name():
    for w in BENCH["workloads"]:
        cell = find_cell(BENCH, w["name"])
        assert cell.driver.__file__ == str(
            cells.HERE / "drivers" / f"{cell.mix['driver']}.py")

