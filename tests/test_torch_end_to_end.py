"""The port's Correlator end to end against ``fxtpu``'s: the cases of
``tests/test_end_to_end.py`` that no other ``test_torch_*`` file holds,
each run through both packages on the same seeded input, at the
reference's shapes (2^14 samples, 1024 bins).

Runs over a finite source (a replay, or a ``LimitedSource`` over the
synthetic one) end at the same block in both packages: their CSV rows
agree within 2e-5 of the largest (3e-5 under int8 ingest), fxtpu's
bounds (tests/test_planes.py:318-321, 558), their headers line for line
and their delays within 0.01 sample.  Runs whose length is the wall
clock's (a keypress, the CLI's ``--time``) are held each to the
reference's own oracle, and their first calibration, taken on the same
block, to each other.  The span-mode snapshot at the end holds the
repaired feeder: a resume from it seeks a replay and refuses a synthetic
source, as in ``fxtpu``."""

import json
import threading
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
jnp = pytest.importorskip("jax.numpy")   # absent on the card's machine

BW = 2.4e6
BASE = dict(num_samp=2**14, nbins=2**10, run_time=60, clamp_num_samp=False,
            loglevel="WARNING", startup_duration=0.1)
INNER = slice(2**10 // 4, 3 * 2**10 // 4)
PKGS = ("fxtpu", "fxtpu_torch")


def _pkg(name):
    if name == "fxtpu":
        from fxtpu import sources
        from fxtpu.cli import main
        from fxtpu.config import CorrelatorConfig
        from fxtpu.correlator import Correlator
        from fxtpu.fx import FxEngine
        from fxtpu.products import load_products
        from fxtpu.runtime.stager import Batch
        extra = {}

        def mesh(t, f):
            from fxtpu.parallel import make_correlator_mesh
            return make_correlator_mesh(t, f)
    else:
        from fxtpu_torch import sources
        from fxtpu_torch.cli import main
        from fxtpu_torch.config import CorrelatorConfig
        from fxtpu_torch.correlator import Correlator
        from fxtpu_torch.fx import FxEngine
        from fxtpu_torch.products import load_products
        from fxtpu_torch.runtime.stager import Batch
        extra = {"device": "cpu"}

        def mesh(t, f):
            from fxtpu_torch.parallel import make_correlator_mesh
            return make_correlator_mesh(t, f, [torch.device("cpu")] * (t * f))
    return types.SimpleNamespace(
        name=name, src=sources, cli=main, Correlator=Correlator,
        FxEngine=FxEngine, load_products=load_products, Batch=Batch,
        mesh=mesh, extra=extra,
        config=lambda **kw: CorrelatorConfig(**kw, **extra))


def _run(p, tmp_path, tag, make_src=None, mesh=None, start=None, **kw):
    """One Correlator run of package ``p`` to its end; ``make_src(p)`` makes
    its source, ``start(cor)`` runs before the machine starts."""
    cfg = p.config(**{**BASE, **kw},
                   output_file=str(tmp_path / f"{p.name}_{tag}.csv"))
    cor = p.Correlator(config=cfg,
                       source=None if make_src is None else make_src(p),
                       mesh=None if mesh is None else p.mesh(*mesh))
    if start is not None:
        start(cor)
    cor.run_state_machine()
    return cor


def _rows(p, cor):
    md, data = p.load_products(cor.output_file)
    return md, data


def _header(path, n=2):
    with open(path) as fh:
        return [fh.readline() for _ in range(n)]


def _both(tmp_path, tag, tol=2e-5, **kw):
    """Both packages' runs over the same input: the port's rows, header,
    block count and delays held to fxtpu's.  Returns {package: (cor, md,
    data)}."""
    out = {}
    for name in PKGS:
        p = _pkg(name)
        cor = _run(p, tmp_path, tag, **kw)
        out[name] = (cor, *_rows(p, cor))
    (jc, jmd, jd), (tc, tmd, td) = out["fxtpu"], out["fxtpu_torch"]
    assert tc.blocks_processed == jc.blocks_processed
    assert tmd == jmd
    nhead = 2 if tmd["mode"] == "SPECTRUM" else 1
    assert _header(tc.output_file, nhead) == _header(jc.output_file, nhead)
    assert td.shape == jd.shape and np.isfinite(td).all()
    np.testing.assert_allclose(td, jd, atol=tol * np.abs(jd).max())
    np.testing.assert_allclose(tc.calibrated_delays * BW,
                               jc.calibrated_delays * BW, atol=0.01)
    return out


def _limited(blocks, int8=False, **kw):
    """A LimitedSource of ``blocks`` blocks over a seeded NoiseSource,
    quantized for int8 ingest as ``make_source`` quantizes the synthetic
    source."""
    kw.setdefault("nchan", 2)

    def make(p):
        src = p.src.LimitedSource(p.src.NoiseSource(**kw), blocks)
        return p.src.QuantizedSource(src) if int8 else src
    return make


def _recording(tmp_path, blocks, num_samp=2**14, **kw):
    from fxtpu_torch.sources import NoiseSource, save_recording
    kw.setdefault("nchan", 2)
    return save_recording(NoiseSource(**kw), str(tmp_path / "rec.npy"),
                          num_samp, blocks)


def _replay(rec):
    """Config keywords of a replay run (each package's ``make_source``
    builds it, quantizing under int8 ingest)."""
    return {"source": "replay", "replay_file": rec}


def _flat_phase(data, limit):
    ph = np.angle(np.atleast_2d(data).mean(axis=0)[INNER])
    assert np.std(np.unwrap(ph)) < limit


def _delay_ok(cor, true_delay):
    assert abs(cor.calibrated_delays[1] - true_delay) * BW < 0.5


# --------------------------------------------------------------------------
# runs over a finite source: rows held to fxtpu's
# --------------------------------------------------------------------------

def test_spectrum_run_end_to_end(tmp_path):
    out = _both(tmp_path, "spec", mode="SPECTRUM",
                make_src=_limited(6, delays=[0.0, 2e-6], seed=1))
    cor, md, data = out["fxtpu_torch"]
    assert cor.state == "SHUTDOWN" and md["mode"] == "SPECTRUM"
    assert data.shape == (cor.blocks_processed, 2**10) == (5, 2**10)
    _delay_ok(cor, 2e-6)
    _flat_phase(data, 0.3)


def test_int8_ingest_end_to_end(tmp_path):
    out = _both(tmp_path, "i8", tol=3e-5, mode="SPECTRUM",
                ingest_dtype="int8", blocks_per_dispatch=3,
                make_src=_limited(8, int8=True, delays=[0.0, 2e-6], seed=2))
    cor, _, data = out["fxtpu_torch"]
    assert cor.bufs[0].dtype == np.int8 and cor.stager is not None
    _delay_ok(cor, 2e-6)
    assert data.shape[0] == cor.blocks_processed == 7
    _flat_phase(data, 0.35)


def test_calibrate_window_smaller_than_block(tmp_path):
    out = _both(tmp_path, "win", mode="SPECTRUM", calibrate_samples=2**12,
                make_src=_limited(3, delays=[0.0, 2e-6], seed=3))
    _delay_ok(out["fxtpu_torch"][0], 2e-6)


def test_continuum_run_end_to_end(tmp_path):
    """Correlated channels at snr 10: the block visibilities share one
    phase and a steady amplitude (noise alone would not)."""
    out = _both(tmp_path, "cont", mode="CONTINUUM",
                make_src=_limited(8, seed=4))
    cor, md, data = out["fxtpu_torch"]
    assert md["mode"] == "CONTINUUM"
    assert data.ndim == 1 and len(data) == cor.blocks_processed == 7
    ph = np.angle(data)
    assert np.std(np.angle(np.exp(1j * (ph - ph[0])))) < 0.1
    amps = np.abs(data)
    assert amps.min() > 0.5 * amps.max()


def test_replay_run_matches_defined_length(tmp_path):
    rec = _recording(tmp_path, 6, seed=8)
    out = _both(tmp_path, "rep", **_replay(rec))
    cor, _, data = out["fxtpu_torch"]
    assert cor.blocks_processed == 5 and data.shape[0] == 5


def test_no_calibrate_on_start(tmp_path):
    rec = _recording(tmp_path, 3, seed=8)
    out = _both(tmp_path, "nocal", calibrate_on_start=False, **_replay(rec))
    cor = out["fxtpu_torch"][0]
    assert cor.blocks_processed == 3 and np.all(cor.calibrated_delays == 0)


def test_nchan4_run(tmp_path):
    out = _both(tmp_path, "nch4", nchan=4, mode="SPECTRUM", num_samp=2**13,
                nbins=2**9, make_src=_limited(4, nchan=4, seed=5))
    cor, md, data = out["fxtpu_torch"]
    assert md["nchan"] == "4"
    assert data.shape == (6 * cor.blocks_processed, 2**9)


def test_integration_blocks_accumulation(tmp_path):
    rec = _recording(tmp_path, 7, seed=12)
    out = _both(tmp_path, "integ", mode="SPECTRUM", integration_blocks=3,
                **_replay(rec))
    cor, _, data = out["fxtpu_torch"]
    assert cor.blocks_processed == 6 and data.shape[0] == 2


def test_single_channel_drop_realigns_end_to_end(tmp_path):
    """A one-channel stream gap (drop_channel) through a whole run: the
    aligner discards the siblings' unpairable blocks, the rows stay
    coherent, and a snapshot of the run refuses to resume (no one cursor
    reproduces both channels) in both packages."""
    rec = _recording(tmp_path, 10, seed=23, delays=[0.0, 1e-6])

    def faulted(p):
        return p.src.FaultInjectingSource(p.src.ReplaySource(rec),
                                          drop_every=3, drop_channel=1)
    out = _both(tmp_path, "drop", make_src=faulted)
    for name in PKGS:
        cor, _, data = out[name]
        assert cor.aligner.realigned >= 2
        assert cor.blocks_processed == 7
        assert np.atleast_2d(data).shape[0] == 7
        _delay_ok(cor, 1e-6)
        _flat_phase(data, 0.35)
        p = _pkg(name)
        snap = cor.snapshot(str(tmp_path / f"{name}_div.state.npz"))
        with pytest.raises(ValueError, match="cannot resume"):
            p.Correlator(config=p.config(
                **BASE, calibrate_on_start=False, resume_from=snap,
                output_file=str(tmp_path / f"{name}_r.csv")),
                source=faulted(p))


def test_single_channel_drop_synthetic_no_replay(tmp_path):
    def faulted(p):
        inner = p.src.LimitedSource(
            p.src.NoiseSource(nchan=2, seed=23, delays=[0, 1e-6]), 10)
        return p.src.FaultInjectingSource(inner, drop_every=3,
                                          drop_channel=1)
    out = _both(tmp_path, "dropsyn", make_src=faulted)
    cor, _, data = out["fxtpu_torch"]
    assert cor.aligner.realigned >= 2 and cor.blocks_processed == 7
    assert np.atleast_2d(data).shape[0] == 7
    _delay_ok(cor, 1e-6)
    _flat_phase(data, 0.35)


def test_child_exception_shuts_down(tmp_path):
    """An injected source failure at the third read ends the machine in
    both packages, through SHUTDOWN, within the blocks read before it
    (how many of them were correlated first is the clock's)."""
    def failing(p):
        return p.src.FaultInjectingSource(p.src.NoiseSource(nchan=2, seed=1),
                                          fail_at=3)
    for name in PKGS:
        cor = _run(_pkg(name), tmp_path, "fail", make_src=failing,
                   run_time=10)
        assert cor.blocks_processed <= 3 and cor.state == "SHUTDOWN", name


def test_zero_copy_feeders_are_the_production_path(tmp_path):
    """A replay run feeds each channel from its own zero-copy feeder; one
    feeder for both channels writes the same rows."""
    rec = _recording(tmp_path, 6, seed=17)
    out = _both(tmp_path, "zc", **_replay(rec))
    one = _both(tmp_path, "one", channel_feeders=False, **_replay(rec))
    for name in PKGS:
        cor, cor1 = out[name][0], one[name][0]
        assert len(cor.feeders) == 2 and all(f.zero_copy for f in cor.feeders)
        assert len(cor1.feeders) == 1 and not cor1.feeders[0].zero_copy
        np.testing.assert_allclose(out[name][2], one[name][2], rtol=2e-5,
                                   atol=1e-10)


def test_zero_copy_feeders_int8(tmp_path):
    rec = _recording(tmp_path, 6, seed=18)
    out = _both(tmp_path, "zc8", tol=3e-5, ingest_dtype="int8",
                **_replay(rec))
    cor, _, data = out["fxtpu_torch"]
    assert len(cor.feeders) == 2 and all(f.zero_copy for f in cor.feeders)
    assert cor.bufs[0].dtype == np.int8
    assert np.atleast_2d(data).shape[0] == cor.blocks_processed == 5


def test_zero_copy_feeders_synthetic(tmp_path):
    """A plain synthetic run (the config's source, 1 s) splits into
    per-channel zero-copy feeders; the splits are the same stream, so its
    rows are one feeder's, and fxtpu's, block for block."""
    rows = {}
    for name in PKGS:
        p = _pkg(name)
        cor = _run(p, tmp_path, "zcs", run_time=1, synthetic_delay=1e-6)
        cor1 = _run(p, tmp_path, "ones", run_time=1, synthetic_delay=1e-6,
                    channel_feeders=False)
        assert len(cor.feeders) == 2 and all(f.zero_copy for f in cor.feeders)
        assert len(cor1.feeders) == 1 and not cor1.feeders[0].zero_copy
        zc, one = _rows(p, cor)[1], _rows(p, cor1)[1]
        n = min(len(zc), len(one))   # the clock ends each run
        assert n >= 1
        np.testing.assert_allclose(zc[:n], one[:n], rtol=2e-5, atol=1e-10)
        rows[name] = zc
    n = min(len(rows["fxtpu"]), len(rows["fxtpu_torch"]))
    want = rows["fxtpu"][:n]
    np.testing.assert_allclose(rows["fxtpu_torch"][:n], want,
                               atol=2e-5 * np.abs(want).max())


def test_rtl_u8_capture_end_to_end(tmp_path):
    """A native rtl_sdr capture (raw u8 I, Q, one file a channel) through
    the int8 pipeline: per-channel zero-copy feeders, int8 rings, the
    capture's delay recovered."""
    from fxtpu_torch.sources import NoiseSource
    from fxtpu_torch.sources.base import QuantizedSource
    q = QuantizedSource(NoiseSource(nchan=2, seed=47, delays=[0, 2e-6]))
    arr = np.concatenate([q.read_block(2**14) for _ in range(6)], axis=1)
    paths = []
    for c in range(2):
        path = str(tmp_path / f"ch{c}.iq")
        (arr[c].astype(np.int16) + 128).astype(np.uint8).tofile(path)
        paths.append(path)
    out = _both(tmp_path, "u8", tol=3e-5, ingest_dtype="int8",
                source="replay", replay_file=",".join(paths))
    cor, _, data = out["fxtpu_torch"]
    assert type(cor.source).__name__ == "RtlU8ReplaySource"
    assert len(cor.feeders) == 2 and all(f.zero_copy for f in cor.feeders)
    assert cor.bufs[0].dtype == np.int8
    _delay_ok(cor, 2e-6)
    assert np.atleast_2d(data).shape[0] == cor.blocks_processed == 5
    _flat_phase(data, 0.35)


def test_f32_fused_batched_end_to_end(tmp_path):
    out = _both(tmp_path, "f32k", mode="SPECTRUM", fused=True,
                blocks_per_dispatch=3,
                make_src=_limited(8, delays=[0.0, 2e-6], seed=6))
    cor, _, data = out["fxtpu_torch"]
    assert cor.engine.fused_active and not cor.engine.int8_native
    assert cor.stager is not None and cor.stager.stacked_batches == 2
    _delay_ok(cor, 2e-6)
    assert data.shape[0] == cor.blocks_processed == 7
    _flat_phase(data, 0.35)


def test_int8_native_fused_end_to_end(tmp_path):
    """The int8-native fused route: the raw-tail dict history through the
    machine, the stager and the periodic snapshot."""
    import os
    out = _both(tmp_path, "i8k", tol=3e-5, mode="SPECTRUM",
                ingest_dtype="int8", fused=True, blocks_per_dispatch=2,
                snapshot_every=2,
                make_src=_limited(7, int8=True, delays=[0.0, 2e-6], seed=7))
    cor, _, data = out["fxtpu_torch"]
    assert cor.engine.int8_native and isinstance(cor.history, dict)
    _delay_ok(cor, 2e-6)
    assert data.shape[0] == cor.blocks_processed == 6
    _flat_phase(data, 0.35)
    assert os.path.exists(cor.snapshot_path)


@pytest.mark.parametrize("fused", ["auto", True])
def test_nchan2_with_autos_emits_all_baselines(tmp_path, fused):
    """Two channels with autos: three rows a block (auto 0, auto 1,
    cross), the autos real, the cross complex."""
    out = _both(tmp_path, "autos", mode="SPECTRUM", fused=fused,
                include_autos=True,
                make_src=_limited(4, delays=[0.0, 1e-6], seed=9))
    cor, _, data = out["fxtpu_torch"]
    assert len(cor.engine.pairs) == 3
    assert data.shape == (3 * cor.blocks_processed, 2**10)
    auto0, cross = data[0::3], data[2::3]
    assert np.abs(auto0.imag).max() < 1e-3 * np.abs(auto0.real).max()
    assert np.abs(cross.imag).max() > 1e-3 * np.abs(cross.real).max()


@pytest.mark.parametrize("k", [1, 4])
def test_mesh_sharded_correlator_run(tmp_path, k):
    """The machine over a (4, 2) mesh (fxtpu's 8 virtual CPU devices, the
    port's 8 CPU shards), one block a call and K = 4 staged (the mesh
    batched dispatch case): both packages' rows, and each package's rows
    against its single-device run."""
    rec = _recording(tmp_path, 9 if k > 1 else 5, num_samp=2**16, seed=31)
    kw = dict(num_samp=2**16, blocks_per_dispatch=k, buffer_chunks=16,
              **_replay(rec))
    mesh = _both(tmp_path, f"mesh{k}", mesh=(4, 2), tol=1e-3, **kw)
    for name in PKGS:
        p = _pkg(name)
        cor1 = _run(p, tmp_path, f"one{k}", **kw)
        cor, _, dm = mesh[name]
        _, d1 = _rows(p, cor1)
        assert d1.shape == dm.shape == ((8 if k > 1 else 4), 2**10)
        np.testing.assert_allclose(dm, d1, rtol=1e-3, atol=1e-11)
        assert np.allclose(cor1.calibrated_delays, cor.calibrated_delays,
                           atol=1e-9)
        if k > 1:
            assert cor._dispatch_batch == 4


def test_cli_mesh_run(tmp_path):
    """``--mesh_time 4 --mesh_freq 2`` through both CLIs (fxtpu's 8 virtual
    CPU devices, the port's 8 CPU shards): a 1024-bin product, and the
    first calibration, on the same first block, alike."""
    got = {}
    for name in PKGS:
        p = _pkg(name)
        out = str(tmp_path / f"{name}_cli_mesh.csv")
        argv = ["--time", "1", "--mode", "spectrum", "--num_samp", "65536",
                "--resolution", "1024", "--mesh_time", "4", "--mesh_freq",
                "2", "--omit_plot", "--no_keyboard", "--output", out, "-L",
                "ERROR"]
        if name == "fxtpu_torch":
            argv += ["--device", "cpu", "--local_devices", "8"]
        cor = p.cli(argv)
        assert cor.engine.mesh is not None
        _, data = p.load_products(out)
        assert data.shape[-1] == 1024 and np.isfinite(data).all()
        got[name] = cor.calibrated_delays
    np.testing.assert_allclose(got["fxtpu_torch"] * BW, got["fxtpu"] * BW,
                               atol=0.01)


# --------------------------------------------------------------------------
# engine-level cases
# --------------------------------------------------------------------------

def test_int8_step_matches_dequantized_f32():
    """An int8 block through the int8 engine is the dequantized block
    through the complex64 engine, in the port (within 1e-6 of scale) and
    against fxtpu's int8 engine (3e-5)."""
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.ops.cplx import to_complex
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    step = 1.0 / 32
    kw = dict(mode="SPECTRUM", num_samp=2**13, nbins=256,
              clamp_num_samp=False)
    rng = np.random.default_rng(3)
    q = rng.integers(-127, 128, size=(2, kw["num_samp"], 2)).astype(np.int8)
    deq = ((q[..., 0].astype(np.float32)
            + 1j * q[..., 1].astype(np.float32)) * step).astype(np.complex64)
    eng = FxEngine(CorrelatorConfig(**kw, ingest_dtype="int8",
                                    quant_step=step, device="cpu"))
    eng_f = FxEngine(CorrelatorConfig(**kw, device="cpu"))
    d = torch.tensor([0.0, 1e-7])
    v_q, _ = eng.step(eng.prepare_block(q), d, eng.fresh_history())
    v_f, _ = eng_f.step(eng_f.prepare_block(deq), d, eng_f.fresh_history())
    v_f = v_f.numpy()
    np.testing.assert_allclose(v_q.numpy(), v_f, rtol=0,
                               atol=1e-6 * np.abs(v_f).max())
    jeng = JEngine(JConfig(**kw, ingest_dtype="int8", quant_step=step))
    jv, _ = jeng.step(jeng.prepare_block(q), jnp.asarray([0.0, 1e-7],
                                                         jnp.float32),
                      jeng.fresh_history())
    want = to_complex(jv)
    np.testing.assert_allclose(v_q.numpy(), want,
                               atol=3e-5 * np.abs(want).max())


def test_first_staged_block_every_layout(tmp_path):
    """``_first_staged_block`` returns block 0 of a staged batch in every
    layout (the plain route's stack, the fused route's merged layout, the
    int8 fused route's), and calibrates to fxtpu's delays on it."""
    from fxtpu.correlator import Correlator as JCorrelator
    from fxtpu.config import CorrelatorConfig as JConfig
    rng = np.random.default_rng(5)
    f32 = [(rng.normal(size=(2, 2**13)) + 1j * rng.normal(size=(2, 2**13))
            ).astype(np.complex64) for _ in range(3)]
    i8 = [rng.integers(-127, 128, size=(2, 2**13, 2)).astype(np.int8)
          for _ in range(3)]
    p = _pkg("fxtpu_torch")
    for kw, blks in ((dict(), f32), (dict(fused=True), f32),
                     (dict(fused=True, ingest_dtype="int8"), i8)):
        common = dict(num_samp=2**13, nbins=2**10, run_time=1,
                      clamp_num_samp=False, loglevel="ERROR", **kw)
        cor = p.Correlator(config=p.config(
            **common, output_file=str(tmp_path / "v.csv")))
        batch = p.Batch(cor.engine.prepare_batch(blks), 3, True)
        first = cor._first_staged_block(batch)
        assert torch.equal(first, cor.engine.prepare_block(blks[0])), kw
        jcor = JCorrelator(config=JConfig(
            **common, output_file=str(tmp_path / "j.csv")))
        cor._calibrate_task(first)
        jcor._calibrate_task(jcor._first_staged_block(
            _pkg("fxtpu").Batch(jcor.engine.prepare_batch(blks), 3, True)))
        np.testing.assert_allclose(cor.calibrated_delays * BW,
                                   jcor.calibrated_delays * BW, atol=0.01)
        cor.close()
        jcor.close()


def test_int8_native_calibration_reads_the_samples(tmp_path):
    """fxtpu's ``test_packed_int8_calibration_unpacks_words`` on the
    port's int8-native route, whose blocks are int8 (I, Q) pairs, not
    fxtpu's packed words: ``_calibrate_task`` on the prepared block gives
    exactly the delays of the same integers as complex samples, the
    7-sample delay within 0.5 sample, and fxtpu's delays from its packed
    words within 0.01 sample."""
    cfg_kw = dict(mode="SPECTRUM", num_samp=2**14, nbins=2**10, run_time=1,
                  clamp_num_samp=False, loglevel="ERROR",
                  ingest_dtype="int8", fused=True)
    rng = np.random.default_rng(9)
    n = cfg_kw["num_samp"]
    base = rng.normal(size=(n + 16,)) * 40
    baseq = rng.normal(size=(n + 16,)) * 40
    d = 7
    block = np.zeros((2, n, 2), np.int8)
    for c, off in ((0, 16), (1, 16 - d)):
        block[c, :, 0] = np.clip(np.round(base[off:off + n]), -127, 127)
        block[c, :, 1] = np.clip(np.round(baseq[off:off + n]), -127, 127)
    got = {}
    for name in PKGS:
        p = _pkg(name)
        cor = p.Correlator(config=p.config(
            **cfg_kw, output_file=str(tmp_path / f"{name}.csv")))
        assert cor.engine.int8_native
        cor._calibrate_task(cor.engine.prepare_block(block))
        got[name] = cor.calibrated_delays
        if name == "fxtpu_torch":
            prepared = cor.engine.prepare_block(block)
            assert prepared.dtype == torch.int8   # samples, not words
            ncal = min(cor.config.calibrate_samples, n)
            samples = torch.complex(torch.from_numpy(block[..., 0]).float(),
                                    torch.from_numpy(block[..., 1]).float())
            want = cor.engine.calibrate(samples[:, :ncal]).numpy()
            np.testing.assert_array_equal(got[name],
                                          want.astype(np.float64))
        cor.close()
    assert abs(abs(got["fxtpu_torch"][1]) * BW - d) < 0.5
    np.testing.assert_allclose(got["fxtpu_torch"] * BW, got["fxtpu"] * BW,
                               atol=0.01)


# --------------------------------------------------------------------------
# runs as long as the wall clock's: each held to the reference's oracle
# --------------------------------------------------------------------------

def test_cli_end_to_end(tmp_path):
    """The CONTINUUM CLI for 1 s in both packages: the product loads, the
    delay is recovered, and the first calibration (the seed's first
    block in both) agrees."""
    got = {}
    for name in PKGS:
        p = _pkg(name)
        out = str(tmp_path / f"{name}_cli.csv")
        argv = ["--time", "1", "--mode", "continuum", "--num_samp", "16384",
                "--resolution", "1024", "--true_delay", "1e-6",
                "--omit_plot", "--no_keyboard", "--output", out, "-L",
                "ERROR"]
        cor = p.cli(argv + (["--device", "cpu"] if name == "fxtpu_torch"
                            else []))
        md, data = p.load_products(out)
        assert md["mode"] == "CONTINUUM" and len(np.atleast_1d(data)) >= 1
        _delay_ok(cor, 1e-6)
        got[name] = cor.calibrated_delays
    np.testing.assert_allclose(got["fxtpu_torch"] * BW, got["fxtpu"] * BW,
                               atol=0.01)


def _press_c_when(cor, ready, tries=200, every=0.02):
    def press():
        for _ in range(tries):
            if ready():
                cor.kbd_queue.put("c")
                return
            time.sleep(every)
    threading.Thread(target=press, daemon=True).start()


@pytest.mark.parametrize("fused", ["auto", True])
def test_recalibration_mid_run_staged(tmp_path, fused):
    """'c' mid-run on the staged path (K = 4): the calibration runs on
    the next batch's first block (on the fused route's merged layout,
    its second axis) and the batch is still correlated."""
    for name in PKGS:
        p = _pkg(name)
        cor = _run(p, tmp_path, f"recal{fused}", run_time=1,
                   synthetic_delay=1e-6, blocks_per_dispatch=4, fused=fused,
                   start=lambda c: _press_c_when(
                       c, lambda: c.state == "RUN" and c.blocks_processed))
        assert cor.stager is not None and cor.stager.done
        _delay_ok(cor, 1e-6)
        _, data = _rows(p, cor)
        assert data.shape[0] == cor.blocks_processed >= 4


def test_recalibration_mid_run(tmp_path):
    for name in PKGS:
        p = _pkg(name)
        cor = _run(p, tmp_path, "recal", run_time=1, synthetic_delay=1e-6,
                   start=lambda c: _press_c_when(c, lambda: c.state == "RUN",
                                                 tries=100))
        _delay_ok(cor, 1e-6)


def test_keyboard_thread_requests_recalibration(tmp_path, monkeypatch):
    """The stdin reader thread itself on a fake tty: a typed 'c' drives a
    mid-run recalibration in both packages."""
    import io
    import os

    for name in PKGS:
        r_fd, w_fd = os.pipe()

        class FakeTty(io.TextIOWrapper):
            def isatty(self):
                return True

        monkeypatch.setattr("sys.stdin", FakeTty(os.fdopen(r_fd, "rb",
                                                           buffering=0)))
        p = _pkg(name)

        def start(cor):
            def press():
                for _ in range(200):
                    if cor.state == "RUN" and cor.blocks_processed >= 1:
                        break
                    time.sleep(0.05)
                os.write(w_fd, b"c")
            threading.Thread(target=press, daemon=True).start()

        cor = _run(p, tmp_path, "kbd", run_time=3, keyboard_control=True,
                   start=start)
        os.close(w_fd)
        timer = cor.metrics.timer("calibrate")
        assert timer is not None and timer.count >= 2, name


def test_metrics_report(tmp_path):
    """The run's metrics in both packages, and the one difference kept on
    purpose (ROADMAP, known differences of route): the port's
    ``rates(until=)`` and its report's rates end at the run's 'end'
    mark, where fxtpu's run to the time of the call."""
    for name in PKGS:
        p = _pkg(name)
        cor = _run(p, tmp_path, "met", mode="CONTINUUM",
                   make_src=_limited(4, seed=10))
        r = cor.metrics.rates()
        assert r["samples_per_s"] > 0
        assert cor.metrics.get("blocks") == cor.blocks_processed == 3
        assert "fx_step" in cor.metrics.report()
        if name == "fxtpu":
            with pytest.raises(TypeError):
                cor.metrics.rates(until="end")
            continue
        ended = cor.metrics.rates(until="end")
        time.sleep(0.2)
        assert cor.metrics.rates(until="end") == ended
        assert cor.metrics.rates()["samples_per_s"] < ended["samples_per_s"]


# --------------------------------------------------------------------------
# span mode: the repaired state log under a snapshot and a resume
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["replay", "synthetic"])
def test_span_mode_snapshot_resumes_as_fxtpu(tmp_path, kind):
    """A snapshot taken while a span-mode feeder (a multi-process run's)
    fed the Correlator carries no source stream state in either package;
    a resume from it seeks a replay by the consumed blocks and refuses a
    synthetic source, in both."""
    rec = _recording(tmp_path, 4, num_samp=2**13, seed=14)

    def source(p):
        if kind == "replay":
            return p.src.ReplaySource(rec)
        return p.src.LimitedSource(p.src.NoiseSource(nchan=2, seed=14), 4)

    result = {}
    for name in PKGS:
        p = _pkg(name)
        cfg = dict(BASE, num_samp=2**13, nbins=256,
                   output_file=str(tmp_path / f"{name}_span.csv"))
        cor = p.Correlator(config=p.config(**cfg), source=source(p))
        bufs = [type(cor.bufs[0])(8, (2**12,)) for _ in range(2)]
        from importlib import import_module
        feeder_cls = import_module(f"{name}.runtime").Feeder
        cor.feeder = feeder_cls(cor.source, bufs, 2**13, run_time=30.0,
                                sample_span=(0, 2**12)).start()
        cor.feeder.join(5.0)
        cor._blocks_consumed, cor._consumed_seq = 2, 1
        snap = cor.snapshot(str(tmp_path / f"{name}_span.state.npz"))
        with np.load(snap) as z:
            has_state = "meta_source_state" in z.files
        resumed = dict(cfg, calibrate_on_start=False, resume_from=snap,
                       output_file=str(tmp_path / f"{name}_r.csv"))
        if kind == "replay":
            cor2 = p.Correlator(config=p.config(**resumed), source=source(p))
            result[name] = (has_state, cor2.source._pos,
                            cor2.blocks_processed)
            cor2.close()
        else:
            with pytest.raises(ValueError, match="cannot resume"):
                p.Correlator(config=p.config(**resumed), source=source(p))
            result[name] = (has_state,)
        cor.close()
    assert result["fxtpu_torch"] == result["fxtpu"]
    assert result["fxtpu_torch"][0] is False
    if kind == "replay":
        assert result["fxtpu_torch"][1] == 2 * 2**13
    json.dumps(result)   # plain values only
