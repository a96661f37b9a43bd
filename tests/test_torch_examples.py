"""The port's example scripts run (``examples/observe_torch.sh`` and
``examples/multihost_torch.sh``, the counterparts of ``observe.sh`` and
``multihost.sh``, ``tests/test_examples.py``), here with ``--device
cpu`` at small shapes, and write products that load with the
reference's recipe (``np.loadtxt(..., dtype=complex128, delimiter=',',
skiprows=2)``) and agree with ``fxtpu``'s on the same input."""

import os
import subprocess

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = os.environ.copy()
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["MPLBACKEND"] = "Agg"
    env.update(extra)
    return env


def _load(path):
    return np.loadtxt(path, dtype=np.complex128, delimiter=",", skiprows=2)


def _header(path):
    with open(path) as fh:
        return [fh.readline() for _ in range(2)]


def _observe(script, cwd, *flags):
    cwd.mkdir()
    r = subprocess.run(
        ["bash", os.path.join(REPO, "examples", script), *flags, "--time",
         "1", "--num_samp", "16384", "--resolution", "1024", "-L",
         "WARNING"],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    csv = cwd / "visibilities_example.csv"
    assert csv.exists() and (cwd / "visibilities_example.png").exists()
    return csv


def test_observe_example(tmp_path):
    """Both packages' observe scripts over the seeded synthetic source:
    the same header, and the rows both runs reached (each ends by the
    clock; the synthetic feeder waits for ring space, so no block is
    dropped) within 2e-5 of their scale."""
    csv = _observe("observe_torch.sh", tmp_path / "t", "--device", "cpu")
    data = np.atleast_2d(_load(csv))
    assert data.shape[1] == 1024 and np.isfinite(data).all()
    pytest.importorskip("jax")
    ref = _observe("observe.sh", tmp_path / "j", "--platform", "cpu")
    want = np.atleast_2d(_load(ref))
    assert _header(csv) == _header(ref)
    n = min(len(data), len(want))
    assert n >= 1
    np.testing.assert_allclose(data[:n], want[:n],
                               atol=2e-5 * np.abs(want[:n]).max())


def test_multihost_example(tmp_path):
    """Two processes of 4 CPU shards each over gloo, the coordinator on a
    free port: process 0's product holds every block but the calibrating
    one, one 256-bin row a block, and its rows are those of fxtpu's
    single-process run over the same replay within 2e-5 of their scale."""
    from fxtpu_torch.parallel.multihost import _free_port
    from fxtpu_torch.sources import NoiseSource, save_recording
    rec = save_recording(NoiseSource(nchan=2, seed=5),
                         str(tmp_path / "rec.npy"), 16384, 6)
    out = tmp_path / "vis_mh.csv"
    r = subprocess.run(
        ["bash", os.path.join(REPO, "examples", "multihost_torch.sh"), rec,
         "--device", "cpu", "-L", "WARNING"],
        cwd=tmp_path, capture_output=True, text=True, timeout=540,
        env=_env(FXTPU_COORD=f"127.0.0.1:{_free_port()}",
                 FXTPU_OUT=str(out)))
    assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-2000:])
    data = np.atleast_2d(_load(out))
    assert data.shape == (5, 256) and np.isfinite(data).all()
    pytest.importorskip("jax")
    from fxtpu.cli import main
    ref = tmp_path / "vis_ref.csv"
    main(["--source", "replay", "--replay_file", rec, "--num_samp", "16384",
          "--resolution", "256", "--mode", "spectrum", "--omit_plot",
          "--no_keyboard", "--output", str(ref), "-L", "WARNING"])
    want = np.atleast_2d(_load(ref))
    assert _header(out) == _header(ref)
    assert want.shape == data.shape
    np.testing.assert_allclose(data, want, atol=2e-5 * np.abs(want).max())
