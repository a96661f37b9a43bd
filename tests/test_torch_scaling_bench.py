"""``python -m fxtpu_torch.scaling_bench`` on the CPU, the port of
``scripts/scaling_bench.py``: the sweep's rows carry fxtpu's keys (each
checked against the rows fxtpu's bench prints on its virtual CPU mesh),
the first row's efficiency is 1.0 by definition, ``--multi`` takes the
block-parallel path on the fused route, and ``--device cuda`` without a
card raises.  The times on the CPU are no measurement of anything."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch import scaling_bench  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--block_pow", "13", "--nbins", "256",
         "--devices", "1", "2", "4", "--iters", "1"]
SWEEP_KEYS = {"devices", "samples_per_s", "per_device",
              "efficiency_vs_linear"}
MULTI_KEYS = {"devices", "k", "path", "single_samples_per_s",
              "multi_samples_per_s", "multi_speedup"}


def _fxtpu_rows(argv, capsys):
    """The JSON lines fxtpu's scripts/scaling_bench.py prints for
    ``argv`` on this process's JAX CPU devices."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "fxtpu_scaling_bench", os.path.join(REPO, "scripts",
                                            "scaling_bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    old = sys.argv
    sys.argv = ["scaling_bench.py", *argv]
    try:
        capsys.readouterr()
        bench.main()
    finally:
        sys.argv = old
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_sweep_rows_and_metric(capsys):
    got = scaling_bench.main(SMALL)
    out = [json.loads(line) for line in capsys.readouterr().out.splitlines()
           if line.startswith("{")]
    assert out[-1] == got and got["metric"] == "sharded_scaling_sweep"
    assert got["platform"] == "cpu" and out[:-1] == got["rows"]
    rows = got["rows"]
    assert [r["devices"] for r in rows] == [1, 2, 4]
    assert all(SWEEP_KEYS | {"steps", "launches"} == set(r) for r in rows)
    assert rows[0]["efficiency_vs_linear"] == 1.0
    for r in rows:
        assert r["samples_per_s"] > 0
        assert r["steps"] == 1 + scaling_bench.WARMUP + 1
        assert r["launches"] == {}   # the plain route on the CPU
        assert abs(r["per_device"] - r["samples_per_s"] / r["devices"]) <= 0.1
    theirs = _fxtpu_rows(["--block_pow", "13", "--nbins", "256",
                          "--devices", "1", "2", "4", "--iters", "1"],
                         capsys)
    assert [set(r) for r in theirs[:-1]] == [SWEEP_KEYS] * 3
    assert set(theirs[-1]) <= set(got) and theirs[-1]["metric"] == got[
        "metric"]


def test_multi_takes_the_block_parallel_path(capsys):
    got = scaling_bench.main(SMALL + ["--multi", "4", "--fused", "true"])
    assert got["metric"] == "sharded_multi_dispatch_amortization"
    rows = got["rows"]
    assert [r["devices"] for r in rows] == [2, 4]   # a mesh of 1 is skipped
    for r in rows:
        assert MULTI_KEYS <= set(r)
        assert r["path"] == "block-DP" and r["k"] == 4
        assert r["single_samples_per_s"] > 0 and r["multi_samples_per_s"] > 0
        # the fused route's plain versions on the CPU launch no kernel
        assert r["single_launches"] == r["multi_launches"] == {
            "fx_fused_parts": 0, "parts_reduce": 0, "fx_finish": 0}


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="is_available"):
        scaling_bench.main(["--device", "cuda"])
    res = subprocess.run(
        [sys.executable, "-m", "fxtpu_torch.scaling_bench"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode != 0 and "is_available" in res.stderr
    assert not res.stdout.strip()
