"""The port's slice as a whole on the CPU: one fixed-length replay
recording through both Correlators (fxtpu and fxtpu_torch) on either
route and ingest, the port's CLI end to end, its independence from JAX,
and the options it does not carry yet.

Tolerances: CSV rows within 2e-5*scale (fxtpu's fused-against-unfused
bound, tests/test_planes.py:318-321), 3e-5*scale under int8 ingest
(fxtpu's int8-native bound, tests/test_planes.py:558) and at deep taps
(the SVD-FIR mode, tests/test_planes.py:485), delays within 0.01
sample."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
pytest.importorskip("jax")   # the reference; absent on the card's machine

from fxtpu.config import CorrelatorConfig as JConfig  # noqa: E402
from fxtpu.correlator import Correlator as JCorrelator  # noqa: E402
from fxtpu_torch.cli import main as cli_main  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.correlator import Correlator, StateTransitionError  # noqa: E402
from fxtpu_torch.products import load_products  # noqa: E402
from fxtpu_torch.runtime.native import native_available  # noqa: E402
from fxtpu_torch.sources import NoiseSource, save_recording  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_samp=2**13, nbins=256, clamp_num_samp=False, run_time=1,
             startup_duration=0.1, loglevel="WARNING")


def _csv_lines(path, n):
    with open(path) as fh:
        return [fh.readline() for _ in range(n)]


@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM", "TEST"])
def test_replay_run_matches_fxtpu(tmp_path, mode):
    src = NoiseSource(nchan=2, delays=[0.0, 2e-6], seed=31)
    rec = save_recording(src, str(tmp_path / "rec.npy"), SMALL["num_samp"], 6)
    common = dict(SMALL, mode=mode, source="replay", replay_file=rec)
    jcor = JCorrelator(config=JConfig(
        **common, output_file=str(tmp_path / "jax.csv")))
    jcor.run_state_machine()
    tcor = Correlator(config=CorrelatorConfig(
        **common, output_file=str(tmp_path / "torch.csv"), device="cpu"))
    tcor.run_state_machine()

    # 6 recorded blocks: 1 consumed by calibrate-on-start, 5 correlated
    assert tcor.blocks_processed == jcor.blocks_processed == 5
    assert tcor.state == "SHUTDOWN"
    nhead = 2 if mode == "SPECTRUM" else 1
    assert (_csv_lines(tcor.output_file, nhead)
            == _csv_lines(jcor.output_file, nhead))
    _, want = load_products(jcor.output_file)
    _, got = load_products(tcor.output_file)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())
    bw = tcor.bandwidth
    np.testing.assert_allclose(tcor.calibrated_delays * bw,
                               jcor.calibrated_delays * bw, atol=0.01)


def _replay_pair(tmp_path, **kw):
    """Both Correlators over the same 6-block recording: 1 block consumed
    by calibrate-on-start, 5 correlated."""
    src = NoiseSource(nchan=2, delays=[0.0, 2e-6], seed=32)
    rec = save_recording(src, str(tmp_path / "rec.npy"), SMALL["num_samp"], 6)
    common = dict(SMALL, mode="SPECTRUM", source="replay", replay_file=rec,
                  **kw)
    jcor = JCorrelator(config=JConfig(
        **common, output_file=str(tmp_path / "jax.csv")))
    jcor.run_state_machine()
    tcor = Correlator(config=CorrelatorConfig(
        **common, output_file=str(tmp_path / "torch.csv"), device="cpu"))
    tcor.run_state_machine()
    assert tcor.blocks_processed == jcor.blocks_processed == 5
    _, want = load_products(jcor.output_file)
    _, got = load_products(tcor.output_file)
    assert got.shape == want.shape and np.isfinite(got).all()
    bw = tcor.bandwidth
    np.testing.assert_allclose(tcor.calibrated_delays * bw,
                               jcor.calibrated_delays * bw, atol=0.01)
    return jcor, tcor, got, want


def test_fused_route_correlator_matches_fxtpu_on_cpu(tmp_path):
    """fused=True through both Correlators on the CPU: fxtpu runs its
    Pallas kernel in interpret mode, the port the kernel's plain version
    (the fused route, with no CUDA kernel)."""
    jcor, tcor, got, want = _replay_pair(tmp_path, fused=True)
    assert jcor.engine.fused_active and tcor.engine.fused_active
    assert not tcor.engine.kernel_active
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


@pytest.mark.parametrize("fused", [False, True])
def test_int8_replay_run_matches_fxtpu(tmp_path, fused):
    """8-bit ingest end to end: QuantizedSource splits feed int8 rings,
    int8 blocks cross the state machine, the fused route carries the
    raw-tail dict history."""
    jcor, tcor, got, want = _replay_pair(tmp_path, fused=fused,
                                         ingest_dtype="int8")
    assert all(b.dtype == np.int8 and b.block_shape == (SMALL["num_samp"], 2)
               for b in tcor.bufs)
    # each channel's split quantizes straight into its native ring's slots
    assert ([f.zero_copy for f in tcor.feeders]
            == [native_available()] * 2)
    assert tcor.engine.int8_native == jcor.engine.int8_native == fused
    assert isinstance(tcor.history, dict) == fused
    np.testing.assert_allclose(got, want, atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_deep_tap_fused_replay_run_matches_fxtpu(tmp_path, ingest):
    """The deep-tap path as a whole: 32 taps, fused route in both
    Correlators on the CPU (fxtpu's SVD-FIR kernel in interpret mode, the
    port's SVD-FIR plain version), 4 recorded blocks: 1 consumed by
    calibrate-on-start, 3 correlated."""
    src = NoiseSource(nchan=2, delays=[0.0, 2e-6], seed=33)
    rec = save_recording(src, str(tmp_path / "rec.npy"), SMALL["num_samp"], 4)
    common = dict(SMALL, mode="SPECTRUM", source="replay", replay_file=rec,
                  ntaps=32, fused=True, ingest_dtype=ingest)
    jcor = JCorrelator(config=JConfig(
        **common, output_file=str(tmp_path / "jax.csv")))
    jcor.run_state_machine()
    tcor = Correlator(config=CorrelatorConfig(
        **common, output_file=str(tmp_path / "torch.csv"), device="cpu"))
    tcor.run_state_machine()
    assert tcor.blocks_processed == jcor.blocks_processed == 3
    assert jcor.engine.fused_active and tcor.engine.fused_active
    assert tcor.engine.fir_mode == "svd" and not tcor.engine.kernel_active
    assert tcor.engine.int8_native == jcor.engine.int8_native == (
        ingest == "int8")
    _, want = load_products(jcor.output_file)
    _, got = load_products(tcor.output_file)
    assert got.shape == want.shape == (3, SMALL["nbins"])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-5 * np.abs(want).max())
    bw = tcor.bandwidth
    np.testing.assert_allclose(tcor.calibrated_delays * bw,
                               jcor.calibrated_delays * bw, atol=0.01)


def test_cli_runs_end_to_end_on_cpu(tmp_path):
    out = str(tmp_path / "vis.csv")
    cor = cli_main(["--time", "1", "--mode", "spectrum", "--num_samp",
                    "8192", "--resolution", "256", "--true_delay", "2e-6",
                    "--no_keyboard", "--omit_plot", "--output", out,
                    "--device", "cpu", "-L", "WARNING"])
    assert not cor.engine.kernel_active
    assert abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6 < 0.5
    data = np.atleast_2d(np.loadtxt(out, dtype=np.complex128, delimiter=",",
                                    skiprows=2))
    assert data.shape == (cor.blocks_processed, 256)
    assert cor.blocks_processed >= 1
    inner = slice(256 // 4, 3 * 256 // 4)
    assert np.std(np.unwrap(np.angle(data.mean(axis=0)[inner]))) < 0.3


def test_cli_int8_runs_end_to_end_on_cpu(tmp_path):
    out = str(tmp_path / "vis.csv")
    cor = cli_main(["--time", "1", "--mode", "spectrum", "--num_samp",
                    "8192", "--resolution", "256", "--true_delay", "2e-6",
                    "--ingest", "int8", "--no_keyboard", "--omit_plot",
                    "--output", out, "--device", "cpu", "-L", "WARNING"])
    assert cor.bufs[0].dtype == np.int8 and not cor.engine.kernel_active
    assert abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6 < 0.5
    data = np.atleast_2d(np.loadtxt(out, dtype=np.complex128, delimiter=",",
                                    skiprows=2))
    assert data.shape == (cor.blocks_processed, 256)
    assert cor.blocks_processed >= 1 and np.isfinite(data).all()
    inner = slice(256 // 4, 3 * 256 // 4)
    assert np.std(np.unwrap(np.angle(data.mean(axis=0)[inner]))) < 0.35


def test_cli_deep_taps_runs_end_to_end_on_cpu(tmp_path):
    """``--ntaps 32`` through the CLI (the plain route on the CPU)."""
    out = str(tmp_path / "vis.csv")
    cor = cli_main(["--time", "1", "--mode", "spectrum", "--num_samp",
                    "16384", "--resolution", "256", "--ntaps", "32",
                    "--true_delay", "2e-6", "--no_keyboard", "--omit_plot",
                    "--output", out, "--device", "cpu", "-L", "WARNING"])
    assert cor.config.ntaps == 32 and not cor.engine.kernel_active
    assert abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6 < 0.5
    data = np.atleast_2d(np.loadtxt(out, dtype=np.complex128, delimiter=",",
                                    skiprows=2))
    assert data.shape == (cor.blocks_processed, 256)
    assert cor.blocks_processed >= 1 and np.isfinite(data).all()
    inner = slice(256 // 4, 3 * 256 // 4)
    assert np.std(np.unwrap(np.angle(data.mean(axis=0)[inner]))) < 0.3


def test_port_never_imports_jax():
    code = ("import sys, fxtpu_torch.cli, fxtpu_torch.correlator, "
            "fxtpu_torch.ops, fxtpu_torch.ops.spectrometer, "
            "fxtpu_torch.ops.svd_fir, fxtpu_torch.post_process; "
            "sys.exit(1 if 'jax' in sys.modules else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("kw", [
    dict(mesh_time=2), dict(mesh_freq=2),
    dict(blocks_per_dispatch=4, resume_from="state.npz"),
    dict(ingest_dtype="int8", snapshot_every=5), dict(snapshot_every=5),
    dict(resume_from="state.npz")])
def test_unported_options_raise(kw):
    cfg = CorrelatorConfig(**SMALL, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A."):
        Correlator(config=cfg)


def test_unported_cli_flags_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.9"):
        cli_main(["--num_processes", "2", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.8"):
        cli_main(["--blocks_per_dispatch", "2", "--snapshot_every", "2",
                  "--device", "cpu", "--output", str(tmp_path / "v.csv")])


def test_illegal_transition_raises():
    cor = Correlator(config=CorrelatorConfig(**SMALL, device="cpu"))
    with pytest.raises(StateTransitionError):
        cor.state = "RUN"   # OFF -> RUN is not an edge
