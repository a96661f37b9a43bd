"""Each cell as the benchmark's command runs it, on the card, with a short
window: one result line, correct, with the cell's metrics."""

import json

import pytest

from fxbench import run
from fxbench.cells import find_cell, load_benchmark

BENCH = load_benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_the_card(workload, trace, card, capsys):
    rc = run.main(["--workload", workload, "--seed", str(2**31 + 911),
                   "--seconds", "3", "--trace", str(trace)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert list(line)[-1] == "checks"
    cell = find_cell(BENCH, workload)
    want = cell.per_layer if trace else cell.end_to_end
    assert set(line["metrics"]) == {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
