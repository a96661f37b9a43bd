"""Multi-process runs of fxtpu_torch on torch.distributed (gloo over TCP on
this machine): separate Python processes, 4 CPU shards each of one
8-shard mesh, held against fxtpu's single-process mesh on its 8 virtual
CPU devices, computed here in the pytest process (the workers import no
JAX).  Every launch has a timeout and kills its workers when one fails.

Tolerances, as tests/test_multihost.py: the step's visibility rtol 2e-5,
atol 2e-4, its history rtol 1e-6, atol 1e-6; the Correlator's CSV rows
rtol 2e-4, atol 1e-5; calibration within half a sample.
"""

import json
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.parallel.multihost import (_free_port, launch,  # noqa: E402
                                            step_block)

NBINS = 256
NUM_SAMP = NBINS * 64
TIMEOUT = 240


def _fxtpu_step(fused):
    """fxtpu's single-process (4, 2) mesh step on the step role's block."""
    import jax
    from fxtpu.config import CorrelatorConfig
    from fxtpu.fx import FxEngine
    from fxtpu.parallel.ingest import put_block
    from fxtpu.parallel.mesh import make_correlator_mesh

    mesh = make_correlator_mesh(4, 2)
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, ntaps=4, nbins=NBINS,
                           num_samp=NUM_SAMP, clamp_num_samp=False,
                           fused=fused)
    eng = FxEngine(cfg, mesh=mesh, fused=fused)
    iq = put_block(step_block(NUM_SAMP), mesh)
    delays = np.asarray([0.0, 1.25e-6], np.float32)
    vis, hist = eng.step(iq, delays, eng.fresh_history())
    return (np.asarray(jax.device_get(vis)),
            np.asarray(jax.device_get(hist.re))
            + 1j * np.asarray(jax.device_get(hist.im)))


@pytest.mark.parametrize("fused", [False, True],
                         ids=["xla_path", "fused_kernel"])
def test_two_process_step_matches_single_process(tmp_path, fused):
    """Two processes, each placing only its span of the block, run one
    sharded step (the halo and the sums across processes): fxtpu's
    single-process mesh result."""
    out = str(tmp_path / "mh_step.npz")
    args = ["--out", out, "--nbins", str(NBINS), "--num_samp", str(NUM_SAMP)]
    if fused:
        args.append("--fused")
    results = launch(2, "step", args, timeout=TIMEOUT, device="cpu")
    assert all(r.returncode == 0 for r in results)
    assert f"fused={fused}" in results[0].stdout
    # every process reports its step's launch counts: on the CPU the
    # kernels' plain versions run, so no counter moves
    for pid, r in enumerate(results):
        line = next(json.loads(l) for l in r.stdout.splitlines()
                    if l.startswith('{"process"'))
        assert line["process"] == pid and line["local_shards"] == 4
        assert line["kernel_active"] is False
        assert set(line["launches"]) == (
            {"fx_fused_parts", "parts_reduce", "fx_finish"}
            if fused else set())
        assert not any(line["launches"].values())
    got = np.load(out)
    want_vis, want_hist = _fxtpu_step(fused)
    vis = got["vis"]
    want = want_vis[0] + 1j * want_vis[1] if want_vis.ndim == 3 else want_vis
    np.testing.assert_allclose(vis.real, want.real, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(vis.imag, want.imag, rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(got["hist"], want_hist, rtol=1e-6, atol=1e-6)
    assert int(got["staged_bytes"]) == 0   # CPU tensors go to gloo as they are


def test_two_process_correlator_product_matches(tmp_path):
    """A two-process Correlator run over a replay recording (each feeder
    reads its span, process 0 writes the CSV) against fxtpu's
    single-process mesh run: the same rows, the injected 2.5 us delay
    recovered."""
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.correlator import Correlator as JCorrelator
    from fxtpu.parallel.mesh import make_correlator_mesh as jmesh
    from fxtpu.products import load_products

    from fxtpu_torch.sources import NoiseSource, save_recording

    rec = save_recording(NoiseSource(nchan=2, seed=11, delays=[0.0, 2.5e-6]),
                         str(tmp_path / "rec.npy"), NUM_SAMP, 4)
    ref_csv = str(tmp_path / "ref.csv")
    cfg = JConfig(mode="SPECTRUM", nchan=2, nbins=NBINS, num_samp=NUM_SAMP,
                  clamp_num_samp=False, source="replay", replay_file=rec,
                  run_time=30, loglevel="WARNING", output_file=ref_csv,
                  startup_duration=0.2, fused=False)
    cor = JCorrelator(config=cfg, mesh=jmesh(4, 2))
    cor.run_state_machine()
    ref_delays = cor.calibrated_delays.copy()

    mh_csv = str(tmp_path / "mh.csv")
    results = launch(2, "correlate",
                     ["--recording", rec, "--out", mh_csv,
                      "--nbins", str(NBINS), "--num_samp", str(NUM_SAMP)],
                     timeout=TIMEOUT, device="cpu")
    w0 = next(r.stdout for r in results if "[correlate worker 0]" in r.stdout)
    assert "blocks=3" in w0, w0[-500:]
    m = re.search(r"delays_us=\[([^\]]+)\]", w0)
    assert m, w0[-500:]
    assert abs(float(m.group(1).split()[-1]) - 2.5) < 0.5 / 2.4e6 * 1e6
    meta_ref, data_ref = load_products(ref_csv)
    meta_mh, data_mh = load_products(mh_csv)
    assert {k: meta_mh[k] for k in meta_ref} == meta_ref
    assert data_ref.shape == data_mh.shape == (3, NBINS)
    np.testing.assert_allclose(data_mh.real, data_ref.real,
                               rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(data_mh.imag, data_ref.imag,
                               rtol=2e-4, atol=1e-5)
    assert abs(ref_delays[1] - 2.5e-6) < 0.5 / 2.4e6


def test_local_sample_span_single_process():
    """In one process every sample belongs to it."""
    from fxtpu_torch.parallel.ingest import local_sample_span
    from fxtpu_torch.parallel.mesh import make_correlator_mesh

    mesh = make_correlator_mesh(4, 2, [torch.device("cpu")] * 8)
    assert local_sample_span(mesh, 1024) == (0, 1024)


def test_span_sources_match_full_reads(tmp_path):
    """read_block_span returns exactly the [start, stop) slice of what
    read_block would have produced, for replay and quantized sources, and
    what fxtpu's ReplaySource reads from the same file."""
    from fxtpu.sources.replay import ReplaySource as JReplay

    from fxtpu_torch.sources import NoiseSource
    from fxtpu_torch.sources.base import QuantizedSource
    from fxtpu_torch.sources.replay import ReplaySource, save_recording

    rec = save_recording(NoiseSource(nchan=2, seed=3), str(tmp_path / "r.npy"),
                         1024, 3)
    a, b, j = ReplaySource(rec), ReplaySource(rec), JReplay(rec)
    for _ in range(3):
        full = a.read_block(1024)
        span = b.read_block_span(1024, 256, 768)
        np.testing.assert_array_equal(full[:, 256:768], span)
        np.testing.assert_array_equal(j.read_block_span(1024, 256, 768), span)
    assert a.read_block(1024) is None
    assert b.read_block_span(1024, 256, 768) is None

    q1 = QuantizedSource(ReplaySource(rec))
    q2 = QuantizedSource(ReplaySource(rec))
    full = q1.read_block(1024)
    span = q2.read_block_span(1024, 0, 512)
    np.testing.assert_array_equal(full[:, :512], span)


def test_cli_multiprocess_run(tmp_path):
    """The CLI drives a two-process run itself (the same command on every
    process): process 0 writes a CSV with fxtpu's header."""
    from fxtpu.products import load_products

    from fxtpu_torch.sources import NoiseSource, save_recording

    rec = save_recording(NoiseSource(nchan=2, seed=4), str(tmp_path / "r.npy"),
                         NUM_SAMP, 3)
    out = str(tmp_path / "vis_mh.csv")
    coord = f"127.0.0.1:{_free_port()}"
    common = [sys.executable, "-m", "fxtpu_torch", "--source", "replay",
              "--replay_file", rec, "--num_samp", str(NUM_SAMP),
              "--resolution", str(NBINS), "--mode", "spectrum",
              "--omit_plot", "--no_keyboard", "--output", out,
              "--num_processes", "2", "--coordinator", coord,
              "--local_devices", "4", "--device", "cpu", "-L", "WARNING"]
    procs = [subprocess.Popen(common + ["--process_id", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            o, _ = p.communicate(timeout=TIMEOUT)
            outs.append(o)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), outs
    md, data = load_products(out)
    assert md["mode"] == "SPECTRUM"
    assert data.shape == (2, NBINS)   # 3 blocks - 1 calibration block
    assert np.all(np.isfinite(data))


@pytest.mark.parametrize("entry", ["launch", "worker", "mesh"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """launch, the worker's --device and make_correlator_mesh() without
    devices run on the card unless the caller asks for the CPU: with no
    card they raise (launch before any worker starts) instead of running
    on the CPU."""
    from fxtpu_torch.parallel import multihost
    from fxtpu_torch.parallel.mesh import make_correlator_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(multihost.subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    with pytest.raises(RuntimeError, match="is_available"):
        if entry == "launch":
            launch(2, "step", [], timeout=TIMEOUT)
        elif entry == "worker":
            multihost.main(["--role", "step", "--process_id", "0",
                            "--num_processes", "1",
                            "--coordinator", "127.0.0.1:1"])
        else:
            make_correlator_mesh(2, 2)
    assert started == []
