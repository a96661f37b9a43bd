"""Checkpoint / resume of the port (``fxtpu_torch.runtime.checkpoint`` and
``Correlator.snapshot`` / ``resume_from``) on the CPU, and its snapshot
files against ``fxtpu``'s in both directions.

Tolerances: a resumed run of one package against its own uninterrupted
run, ``fxtpu``'s own resume bound (rtol 2e-4, atol 1e-9;
tests/test_end_to_end.py:400); across the packages, and K blocks a call
against one, the port's parity bounds, 2e-5 of max|vis| (3e-5 under int8
ingest; tests/test_torch_correlator.py:63,132).  Files load bit for bit.
The JAX package is imported inside the tests that compare with it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.correlator import Correlator  # noqa: E402
from fxtpu_torch.products import load_products  # noqa: E402
from fxtpu_torch.runtime import checkpoint  # noqa: E402
from fxtpu_torch.sources import (FaultInjectingSource,  # noqa: E402
                                 LimitedSource, NoiseSource, ReplaySource,
                                 save_recording)

NSAMP, NBINS, NTAPS, NCH = 2**13, 256, 4, 2
SMALL = dict(num_samp=NSAMP, nbins=NBINS, clamp_num_samp=False, run_time=60,
             startup_duration=0.1, loglevel="WARNING")
TOL = {"complex64": 2e-5, "int8": 3e-5}


def _history(ingest, seed=5):
    """A history that is not zero, in the port's form, from numpy."""
    rng = np.random.default_rng(seed)
    shape = (NCH, NTAPS - 1, NBINS)
    if ingest == "int8":
        return {"tail": torch.as_tensor(rng.integers(
                    -128, 128, size=(*shape, 2)).astype(np.int8)),
                "mu_prev": torch.as_tensor(
                    (rng.normal(size=NCH) + 1j * rng.normal(size=NCH)
                     ).astype(np.complex64))}
    return torch.as_tensor((rng.normal(size=shape) + 1j * rng.normal(
        size=shape)).astype(np.complex64))


def _same_history(got, want):
    if isinstance(want, dict):
        return (np.array_equal(got["tail"], want["tail"].numpy())
                and np.array_equal(got["mu_prev"], want["mu_prev"].numpy()))
    return np.array_equal(got, want.numpy())


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_state_round_trip(tmp_path, ingest, accumulate):
    hist = _history(ingest)
    acc = (torch.as_tensor(np.arange(3 * NBINS, dtype=np.float32).reshape(
        3, NBINS) * (1 - 0.5j)).to(torch.complex64) if accumulate else None)
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, history=hist, delays=[0.0, 1.25e-6],
                          blocks_processed=6, accumulator=acc,
                          accumulated=2 if accumulate else 0,
                          meta={"blocks_consumed": np.int64(7)})
    st = checkpoint.load_state(path)
    assert _same_history(st["history"], hist)
    assert st["delays"].dtype == np.float64
    assert np.array_equal(st["delays"], [0.0, 1.25e-6])
    assert (st["blocks_processed"], st["accumulated"]) == (
        6, 2 if accumulate else 0)
    assert int(st["meta"]["blocks_consumed"]) == 7
    if accumulate:
        assert np.array_equal(st["accumulator"], acc.numpy())
    else:
        assert st["accumulator"] is None
    assert not list(tmp_path.glob("*.tmp"))   # the rename left nothing


def test_wrong_version_raises(tmp_path):
    path = str(tmp_path / "s.npz")
    checkpoint.save_state(path, history=_history("complex64"),
                          delays=[0.0, 0.0], blocks_processed=1)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    payload["version"] = np.int64(checkpoint.STATE_VERSION + 1)
    np.savez(path, **payload)
    with pytest.raises(ValueError, match="version"):
        checkpoint.load_state(path)


def _fxtpu_history(hist):
    """The port's history in ``fxtpu``'s form: Cplx planes, the int8 tail
    as ``pack_int8_planes`` words."""
    from fxtpu.ops.cplx import Cplx, from_complex
    from fxtpu.ops.pfb_pallas import pack_int8_planes
    if isinstance(hist, dict):
        tail = hist["tail"].numpy()
        return {"tail": Cplx(pack_int8_planes(tail[..., 0]),
                             pack_int8_planes(tail[..., 1])),
                "mu_prev": from_complex(hist["mu_prev"].numpy())}
    return from_complex(hist.numpy())


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_fxtpu_file_loads_in_port(tmp_path, ingest):
    pytest.importorskip("jax")
    from fxtpu.runtime import checkpoint as jcheckpoint
    hist = _history(ingest, seed=6)
    path = str(tmp_path / "j.npz")
    jcheckpoint.save_state(path, history=_fxtpu_history(hist),
                           delays=np.array([0.0, 3e-6]), blocks_processed=4,
                           meta={"blocks_consumed": np.int64(5)})
    st = checkpoint.load_state(path)
    assert _same_history(st["history"], hist)
    assert np.array_equal(st["delays"], [0.0, 3e-6])
    assert st["blocks_processed"] == 4 and st["accumulator"] is None


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_port_file_loads_in_fxtpu(tmp_path, ingest):
    pytest.importorskip("jax")
    from fxtpu.runtime import checkpoint as jcheckpoint
    hist = _history(ingest, seed=7)
    path = str(tmp_path / "t.npz")
    acc = torch.full((NBINS,), 2 - 1j, dtype=torch.complex64)
    checkpoint.save_state(path, history=hist, delays=[0.0, -2e-6],
                          blocks_processed=9, accumulator=acc, accumulated=1)
    st = jcheckpoint.load_state(path)
    want = _fxtpu_history(hist)
    if ingest == "int8":
        for got, exp in ((st["history"]["tail"], want["tail"]),
                         (st["history"]["mu_prev"], want["mu_prev"])):
            assert np.array_equal(got.re, exp.re)
            assert np.array_equal(got.im, exp.im)
        assert st["history"]["tail"].re.dtype == np.int32
    else:
        assert np.array_equal(st["history"].re, want.re)
        assert np.array_equal(st["history"].im, want.im)
    assert st["blocks_processed"] == 9 and st["accumulated"] == 1
    assert np.array_equal(st["accumulator"].re, np.full(NBINS, 2.0))


def _run(tmp_path, output, src=None, **kw):
    """The port's Correlator over ``src`` (a Source object; None: the one
    the config names) writing ``output``."""
    cfg = CorrelatorConfig(**{**SMALL, **kw}, device="cpu",
                           output_file=str(tmp_path / output))
    cor = Correlator(config=cfg, source=src)
    cor.run_state_machine()
    return cor


def _rows(cor):
    return np.atleast_2d(load_products(cor.output_file)[1])


def _cut(rec, path, blocks):
    np.save(path, np.load(rec)[:, : blocks * NSAMP])
    return str(path)


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_snapshot_resume_roundtrip(tmp_path, ingest):
    """A resumed run continues the replay where the snapshot was taken:
    its rows are the tail of one uninterrupted run, the delays those of
    the run that took the snapshot."""
    rec = save_recording(NoiseSource(nchan=NCH, seed=13),
                         str(tmp_path / "rec.npy"), NSAMP, 8)
    common = dict(source="replay", ingest_dtype=ingest)
    full = _run(tmp_path, "full.csv", replay_file=rec, **common)
    assert _rows(full).shape[0] == 7          # 8 blocks - 1 calibrate
    # run A: snapshots every 2 blocks over a replay cut after 5 blocks
    cor_a = _run(tmp_path, "a.csv", snapshot_every=2, **common,
                 replay_file=_cut(rec, tmp_path / "a.npy", 5))
    assert cor_a.blocks_processed == 4
    # run B: the snapshot over the whole replay, delays from the snapshot
    cor_b = _run(tmp_path, "b.csv", calibrate_on_start=False,
                 resume_from=cor_a.snapshot_path, replay_file=rec, **common)
    assert cor_b.blocks_processed == 7
    assert np.allclose(cor_b.calibrated_delays, cor_a.calibrated_delays)
    np.testing.assert_allclose(_rows(cor_b), _rows(full)[4:], rtol=2e-4,
                               atol=1e-9)


def test_snapshot_resume_synthetic_source(tmp_path):
    """Resume with a synthetic source regenerates the noise the
    uninterrupted run would have: the snapshot holds the generator's state
    at the last correlated block, from the feeder's log (the source itself
    has read ahead into the rings)."""
    def run(limit, output, **kw):
        src = LimitedSource(NoiseSource(nchan=NCH, seed=31,
                                        delays=[0.0, 1e-6]), limit)
        return _run(tmp_path, output, src=src, **kw)

    full = run(8, "full.csv")
    assert _rows(full).shape[0] == 7
    cor_a = run(5, "a.csv", snapshot_every=2)
    assert cor_a.blocks_processed == 4
    cor_b = run(3, "b.csv", calibrate_on_start=False,
                resume_from=cor_a.snapshot_path)
    assert cor_b.blocks_processed == 7
    assert np.allclose(cor_b.calibrated_delays, cor_a.calibrated_delays)
    np.testing.assert_allclose(_rows(cor_b), _rows(full)[4:], rtol=2e-4,
                               atol=1e-9)


def test_snapshot_resume_with_aligned_drops(tmp_path):
    """Source-reported drops open gaps in the ring seqs, so the consumed
    count is no stream position: the snapshot keys the source's state on
    the last correlated block's seq."""
    rec = save_recording(NoiseSource(nchan=NCH, seed=41),
                         str(tmp_path / "rec.npy"), NSAMP, 10)

    def run(replay, output, **kw):
        src = FaultInjectingSource(ReplaySource(replay), drop_every=3)
        return _run(tmp_path, output, src=src, **kw)

    full = run(rec, "full.csv")        # drops lose blocks 3 and 7
    assert _rows(full).shape[0] == 7
    cor_a = run(_cut(rec, tmp_path / "a.npy", 6), "a.csv", snapshot_every=2)
    assert cor_a.blocks_processed == 4  # kept seqs 0, 1, 3, 4, 5
    cor_b = run(rec, "b.csv", calibrate_on_start=False,
                resume_from=cor_a.snapshot_path)
    assert cor_b.blocks_processed == 7
    np.testing.assert_allclose(_rows(cor_b), _rows(full)[4:], rtol=2e-4,
                               atol=1e-9)


def test_resume_refuses_without_stream_state(tmp_path):
    """A snapshot without the source's stream state, of a source that
    cannot seek, refuses to resume rather than correlate other samples
    against the snapshot's tap history."""
    cor = _run(tmp_path, "a.csv", snapshot_every=2,
               src=LimitedSource(NoiseSource(nchan=NCH, seed=32), 5))
    snap = cor.snapshot_path
    with np.load(snap, allow_pickle=False) as z:
        payload = {k: z[k] for k in z.files if k != "meta_source_state"}
    np.savez(snap, **payload)
    cfg = CorrelatorConfig(**SMALL, device="cpu", calibrate_on_start=False,
                           resume_from=snap,
                           output_file=str(tmp_path / "b.csv"))
    with pytest.raises(ValueError, match="cannot resume"):
        Correlator(config=cfg, source=LimitedSource(
            NoiseSource(nchan=NCH, seed=32), 3))


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("snapshots", ["fxtpu", "fxtpu_torch"])
def test_resume_across_packages(tmp_path, snapshots, ingest):
    """One package snapshots a run cut short, the other resumes it over
    the whole replay: its rows are the snapshotting package's
    uninterrupted run's tail within the port's parity bound.  Both run the
    fused route (fxtpu's kernel in interpret mode, the port's plain
    versions), so int8 ingest carries the raw-tail history in packed
    words."""
    pytest.importorskip("jax")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.correlator import Correlator as JCorrelator

    rec = save_recording(NoiseSource(nchan=NCH, delays=[0.0, 2e-6], seed=17),
                         str(tmp_path / "rec.npy"), NSAMP, 8)
    common = dict(SMALL, source="replay", ingest_dtype=ingest, fused=True)

    def run(pkg, replay, output, **kw):
        out = str(tmp_path / output)
        if pkg == "fxtpu":
            cor = JCorrelator(config=JConfig(**common, replay_file=replay,
                                             output_file=out, **kw))
        else:
            cor = Correlator(config=CorrelatorConfig(
                **common, replay_file=replay, output_file=out, device="cpu",
                **kw))
        cor.run_state_machine()
        return cor

    resumes = "fxtpu_torch" if snapshots == "fxtpu" else "fxtpu"
    full = run(snapshots, rec, "full.csv")
    cor_a = run(snapshots, _cut(rec, tmp_path / "a.npy", 5), "a.csv",
                snapshot_every=2)
    assert cor_a.blocks_processed == 4
    cor_b = run(resumes, rec, "b.csv", calibrate_on_start=False,
                resume_from=cor_a.snapshot_path)
    assert cor_b.blocks_processed == 7
    assert isinstance(cor_b.history, dict) == (ingest == "int8")
    want = _rows(full)[4:]
    got = _rows(cor_b)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=TOL[ingest] * np.abs(want).max())


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_resume_calibrates_as_fxtpu(tmp_path, ingest):
    """A resumed run with calibrate_on_start=True (the default) spends its
    first block on calibration in both packages, as fxtpu's state machine
    does (STARTUP -> CALIBRATE whenever calibrate_on_start is set), and
    correlates the rest with the fresh delays: one snapshot resumed by
    each package over the same replay gives the same rows, within the
    port's parity bound, and the same delays within 1e-9 s."""
    pytest.importorskip("jax")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.correlator import Correlator as JCorrelator

    rec = save_recording(NoiseSource(nchan=NCH, delays=[0.0, 2e-6], seed=29),
                         str(tmp_path / "rec.npy"), NSAMP, 10)
    common = dict(SMALL, source="replay", ingest_dtype=ingest, fused=True)
    cor_a = _run(tmp_path, "a.csv", snapshot_every=2,
                 replay_file=_cut(rec, tmp_path / "a.npy", 5),
                 source="replay", ingest_dtype=ingest, fused=True)
    assert cor_a.blocks_processed == 4
    st = checkpoint.load_state(cor_a.snapshot_path)
    st_delays = np.asarray(st["delays"], np.float64)
    kw = dict(common, replay_file=rec, calibrate_on_start=True,
              resume_from=cor_a.snapshot_path)
    jcor = JCorrelator(config=JConfig(**kw,
                                      output_file=str(tmp_path / "j.csv")))
    jcor.run_state_machine()
    tcor = _run(tmp_path, "t.csv", **kw)
    # the snapshot's 4 blocks, then 5 more: one calibrates, 4 are rows
    assert tcor.blocks_processed == jcor.blocks_processed == 8
    want, got = _rows(jcor), _rows(tcor)
    assert got.shape == want.shape == (4, NBINS) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=TOL[ingest] * np.abs(want).max())
    np.testing.assert_allclose(tcor.calibrated_delays,
                               np.asarray(jcor.calibrated_delays), rtol=0,
                               atol=1e-9)
    # the resumed stream's first block calibrated: the delays are its own
    assert abs(tcor.calibrated_delays[1] - 2e-6) < 0.5 / 2.4e6
    assert not np.array_equal(tcor.calibrated_delays, st_delays)


def test_snapshot_resume_blocks_per_dispatch(tmp_path):
    """K = 4 blocks a call (the staged path) snapshots after each call and
    resumes: its rows are the K = 1 uninterrupted run's tail within the
    parity bound (K blocks a call are K steps within 1e-5 of scale)."""
    rec = save_recording(NoiseSource(nchan=NCH, seed=21),
                         str(tmp_path / "rec.npy"), NSAMP, 10)
    common = dict(source="replay", fused=True)
    full = _run(tmp_path, "full.csv", replay_file=rec, **common)
    assert _rows(full).shape[0] == 9
    # 1 calibrate + one call of 4 blocks, snapshot at 4
    cor_a = _run(tmp_path, "a.csv", snapshot_every=2, blocks_per_dispatch=4,
                 replay_file=_cut(rec, tmp_path / "a.npy", 5), **common)
    assert cor_a.stager is not None and cor_a.blocks_processed == 4
    cor_b = _run(tmp_path, "b.csv", calibrate_on_start=False,
                 blocks_per_dispatch=4, resume_from=cor_a.snapshot_path,
                 replay_file=rec, **common)
    assert cor_b.blocks_processed == 9
    want = _rows(full)[4:]
    np.testing.assert_allclose(_rows(cor_b), want,
                               atol=2e-5 * np.abs(want).max())


def test_snapshot_mid_integration_row(tmp_path):
    """integration_blocks = 3 with snapshots every 2 blocks: the last
    snapshot holds a row that is one block in (its accumulator), and the
    resumed run completes it and the rows after it as the uninterrupted
    run writes them."""
    rec = save_recording(NoiseSource(nchan=NCH, seed=12),
                         str(tmp_path / "rec.npy"), NSAMP, 11)
    common = dict(source="replay", integration_blocks=3)
    full = _run(tmp_path, "full.csv", replay_file=rec, **common)
    assert _rows(full).shape[0] == 3      # 10 blocks: 3 rows, 1 left over
    cor_a = _run(tmp_path, "a.csv", snapshot_every=2, replay_file=_cut(
        rec, tmp_path / "a.npy", 5), **common)
    assert cor_a.blocks_processed == 4 and cor_a._accumulated == 1
    st = checkpoint.load_state(cor_a.snapshot_path)
    assert st["accumulated"] == 1 and st["accumulator"] is not None
    cor_b = _run(tmp_path, "b.csv", calibrate_on_start=False,
                 resume_from=cor_a.snapshot_path, replay_file=rec, **common)
    assert cor_b.blocks_processed == 10
    np.testing.assert_allclose(_rows(cor_b), _rows(full)[1:], rtol=2e-4,
                               atol=1e-9)
