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
