"""The port's Correlator state machine against ``fxtpu``'s: the mutations
that rebuild the engine and the ones it refuses.

``nbins`` may change while no stager runs (the engine is rebuilt at the
new bin count), and not while the device stager runs: its batches are
framed by the old engine's ``prepare_batch`` and would reach the new
step mis-framed (``fxtpu/correlator.py:338-342``).  Each case runs for
both packages; the JAX package is imported inside the case that needs
it, so that this file runs on a machine without JAX."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

SMALL = dict(num_samp=2**13, nbins=256, clamp_num_samp=False, run_time=60,
             startup_duration=0.1, loglevel="WARNING", fused=True,
             blocks_per_dispatch=4)


def _correlator(pkg, tmp_path):
    """A Correlator of ``pkg`` over a noise source, K = 4 blocks a call
    (the staged path), nothing started."""
    if pkg == "fxtpu":
        pytest.importorskip("jax")
        from fxtpu.config import CorrelatorConfig
        from fxtpu.correlator import Correlator
        from fxtpu.sources import NoiseSource
        cfg = CorrelatorConfig(**SMALL, output_file=str(tmp_path / "v.csv"))
    else:
        from fxtpu_torch.config import CorrelatorConfig
        from fxtpu_torch.correlator import Correlator
        from fxtpu_torch.sources import NoiseSource
        cfg = CorrelatorConfig(**SMALL, output_file=str(tmp_path / "v.csv"),
                               device="cpu")
    return Correlator(config=cfg, source=NoiseSource(nchan=2, seed=3))


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_nbins_changes_without_a_stager(pkg, tmp_path):
    cor = _correlator(pkg, tmp_path)
    try:
        assert cor.stager is None
        old = cor.engine
        cor.nbins = 512
        assert cor.engine is not old
        assert cor.config.nbins == cor.engine.cfg.nbins == 512
        assert cor.history is not None
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_nbins_change_refused_while_the_stager_runs(pkg, tmp_path):
    cor = _correlator(pkg, tmp_path)
    try:
        cor._maybe_start_stager()
        assert cor.stager is not None
        engine = cor.engine
        with pytest.raises(RuntimeError, match="nbins cannot change while "
                                               "the async stager is running"):
            cor.nbins = 512
        assert cor.engine is engine
        assert cor.config.nbins == engine.cfg.nbins == 256
    finally:
        cor.close()


# --------------------------------------------------------------------------
# The setters and the mutations that rebuild the engine
# (tests/test_state_machine.py), each for both packages
# --------------------------------------------------------------------------

def _make(pkg, mesh=None, **kw):
    """A Correlator of ``pkg`` at fxtpu's test defaults (2^14 samples,
    1024 bins), on the CPU, optionally over a (t, f) mesh of its own."""
    kw.setdefault("num_samp", 2**14)
    kw.setdefault("nbins", 2**10)
    kw.setdefault("clamp_num_samp", False)
    if pkg == "fxtpu":
        pytest.importorskip("jax")
        from fxtpu.config import CorrelatorConfig
        from fxtpu.correlator import Correlator
        from fxtpu.parallel import make_correlator_mesh
        cfg = CorrelatorConfig(**kw)
    else:
        from fxtpu_torch.config import CorrelatorConfig
        from fxtpu_torch.correlator import Correlator
        from fxtpu_torch.parallel import make_correlator_mesh
        cfg = CorrelatorConfig(**kw, device="cpu")
    if mesh is not None:
        devices = (None if pkg == "fxtpu"
                   else [torch.device("cpu")] * (mesh[0] * mesh[1]))
        mesh = make_correlator_mesh(*mesh, devices=devices)
    return Correlator(config=cfg, mesh=mesh)


def _vis(cor, seed=3, delays=None):
    """One step of the correlator's engine on its example inputs, as
    complex numpy."""
    import numpy as np
    iq, d, history = cor.engine.example_inputs(seed=seed)
    if delays is not None:
        d = delays
    vis, _ = cor.engine.step(iq, d, history)
    if hasattr(vis, "re"):
        return np.asarray(vis.re) + 1j * np.asarray(vis.im)
    return vis.numpy() if hasattr(vis, "numpy") else np.asarray(vis)


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_setters_pass_through_to_the_source(pkg):
    """The reference defaults, and each setter stored and passed to the
    source (test_state_machine.py:36-62)."""
    cor = _make(pkg)
    try:
        assert (cor.state, cor.mode) == ("OFF", "SPECTRUM")
        assert (cor.bandwidth, cor.frequency, cor.gain) == (2.4e6, 1.4204e9,
                                                            49.6)
        cor.bandwidth = 2.3e6
        assert cor.bandwidth == cor.source.sample_rate == 2.3e6
        cor.nbins = 2**11
        assert cor.nbins == cor.engine.cfg.nbins == 2**11
        cor.frequency = 1.419e9
        assert cor.frequency == cor.source.center_freq == 1.419e9
        cor.gain = 29.7
        assert cor.gain == cor.source.gain == 29.7
        for seq in (("STARTUP", "RUN", "CALIBRATE", "RUN", "SHUTDOWN", "OFF"),
                    ("STARTUP", "SHUTDOWN", "OFF")):
            for state in seq:
                cor.state = state
                assert cor.state == state
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_mutations_rebuild_the_engine(pkg):
    """nbins changes the output's shape and the history's; mode switches
    the reduction; frequency the rotation; a no-op keeps the engine
    (test_state_machine.py:208-262)."""
    import numpy as np
    cor = _make(pkg, mode="SPECTRUM")
    try:
        cor.nbins = 2**9
        assert cor.engine.cfg.nbins == 2**9
        assert _vis(cor).shape == (1, 2**9)
        assert tuple(cor.history.shape) == (2, cor.config.ntaps - 1, 2**9)
        eng = cor.engine
        cor.nbins = cor.nbins
        assert cor.engine is eng
        d = np.asarray([0.0, 1e-7], np.float32)
        if pkg == "fxtpu_torch":
            d = torch.from_numpy(d)
        v1 = _vis(cor, delays=d)
        cor.frequency = 1.2e9
        assert not np.allclose(v1, _vis(cor, delays=d))
        cor.mode = "CONTINUUM"
        assert _vis(cor).shape == (1,)
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_num_samp_mutation_resizes_rings_and_clamps(pkg):
    """num_samp resizes the rings before streaming, raises once a feeder
    runs, rejects a block shorter than one PFB window, and is clamped to
    [2^8, 2^18] where the config clamps (the reference's bounds)."""
    cor = _make(pkg)
    try:
        cor.num_samp = 2**13
        assert cor.config.num_samp == 2**13
        assert cor.bufs[0].block_shape == (2**13,)
        iq, _, _ = cor.engine.example_inputs(seed=3)
        width = iq.shape[-1] if hasattr(iq, "shape") else iq.re.shape[-1]
        assert width == 2**13
        cor.feeder = object()            # as if streaming had started
        with pytest.raises(RuntimeError):
            cor.num_samp = 2**12
        cor.feeder = None
        with pytest.raises(ValueError):
            cor.num_samp = 2**10         # below one 4-tap window of 1024
    finally:
        cor.close()
    cor = _make(pkg, clamp_num_samp=True, nbins=256)
    try:
        cor.num_samp = 2**20
        assert cor.num_samp == cor.config.num_samp == 2**18
        assert cor.bufs[0].block_shape == (2**18,)
    finally:
        cor.close()


@pytest.mark.parametrize("pkg", ["fxtpu", "fxtpu_torch"])
def test_mutation_under_a_mesh_keeps_the_mesh(pkg):
    """Under a (2, 2) CPU mesh a rebuilt engine keeps the mesh, the sample
    span is recomputed (one process: none, every sample is its own), and
    the rebuilt step runs sharded at the new shape; the two packages'
    visibilities agree after the same mutations."""
    import numpy as np
    cor = _make(pkg, mesh=(2, 2), nbins=256)
    other = _make("fxtpu_torch" if pkg == "fxtpu" else "fxtpu", mesh=(2, 2),
                  nbins=256)
    try:
        mesh = cor.engine.mesh
        for c in (cor, other):
            c.num_samp = 2**13
            c.nbins = 512
        assert cor.engine.mesh is mesh
        assert cor.sample_span is None
        assert cor.bufs[0].block_shape == (2**13,)
        vis, want = _vis(cor), _vis(other)
        assert vis.shape == (1, 512)
        np.testing.assert_allclose(vis, want, rtol=5e-4, atol=5e-7)
    finally:
        cor.close()
        other.close()
