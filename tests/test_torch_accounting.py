"""The analytic collective-volume model == what the sharded step moves.

Counterpart of tests/test_accounting.py: there fxtpu compiles its sharded
step on 8 virtual devices and parses the collectives out of the HLO;
here every collective of fxtpu_torch.parallel.collectives counts one
shard's payload while the step runs on 8 CPU shards, and the counts must
equal the model (fxtpu_torch.parallel.accounting, a copy of fxtpu's,
held equal to it).  The fused path has no corner turn.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.parallel import make_correlator_mesh  # noqa: E402
from fxtpu_torch.parallel.accounting import (  # noqa: E402
    measured_volume, predicted_collective_time, predicted_scaling_efficiency,
    predicted_volume, predicted_volume_blockdp)

NUM_SAMP, NBINS, NTAPS = 2**14, 256, 4
CPU8 = [torch.device("cpu")] * 8


def _engine(t, f, *, fused, int8=False):
    kw = dict(ingest_dtype="int8") if int8 else {}
    cfg = CorrelatorConfig(num_samp=NUM_SAMP, nbins=NBINS,
                           clamp_num_samp=False, mode="SPECTRUM",
                           device="cpu", **kw)
    return FxEngine(cfg, fused=fused,
                    mesh=make_correlator_mesh(t, f, devices=CPU8))


def _measure(t, f, *, fused, int8=False):
    eng = _engine(t, f, fused=fused, int8=int8)
    assert eng.step.fused_kernel == fused
    iq, _, _ = eng.example_inputs(0)
    delays = torch.tensor([0.0, 3.3e-7])
    return measured_volume(eng.step, iq, delays, eng.fresh_history())


def _predict(t, f, *, fused, int8=False):
    """The port's model, held equal to fxtpu's."""
    from fxtpu.parallel.accounting import predicted_volume as jpredicted
    kw = dict(nch=2, nbl=1, nbins=NBINS, num_samp=NUM_SAMP, ntaps=NTAPS,
              mesh_time=t, mesh_freq=f, fused=fused, int8_native=int8)
    got = predicted_volume(**kw)
    assert got == jpredicted(**kw)
    return got


@pytest.mark.parametrize("t,f", [(4, 2), (8, 1)])
def test_xla_path_volume_matches_model(t, f):
    assert _measure(t, f, fused=False) == _predict(t, f, fused=False)


@pytest.mark.parametrize("t,f", [(4, 2), (8, 1)])
def test_fused_path_volume_matches_model(t, f):
    assert _measure(t, f, fused=True) == _predict(t, f, fused=True)


def test_int8_native_volume_matches_model():
    m = _measure(4, 2, fused=True, int8=True)
    assert m == _predict(4, 2, fused=True, int8=True)
    # the int8 halo is a quarter of the complex64 halo
    f32 = _predict(4, 2, fused=True)
    assert m["collective-permute"] * 4 == f32["collective-permute"]


def test_fused_kills_the_corner_turn():
    """The fused step moves no all_to_all, and in all fewer bytes than the
    plain step's O(num_samp) corner turn, which dominates it."""
    xla = _measure(4, 2, fused=False)
    fused = _measure(4, 2, fused=True)
    assert fused["all-to-all"] == 0
    assert xla["all-to-all"] > 0
    assert sum(fused.values()) < sum(xla.values())
    assert xla["all-to-all"] == 2 * 2 * (NUM_SAMP // NBINS // 8) * NBINS * 4


def test_model_scales_with_problem():
    """The corner turn's bytes scale with num_samp; the fused psums' do
    not."""
    kw = dict(nch=2, nbl=1, nbins=NBINS, ntaps=NTAPS, mesh_time=4,
              mesh_freq=2)
    small = predicted_volume(num_samp=NUM_SAMP, fused=False, **kw)
    big = predicted_volume(num_samp=4 * NUM_SAMP, fused=False, **kw)
    assert big["all-to-all"] == 4 * small["all-to-all"]
    assert (predicted_volume(num_samp=NUM_SAMP, fused=True, **kw)
            == predicted_volume(num_samp=4 * NUM_SAMP, fused=True, **kw))


def _blocks(k, int8, seed):
    rng = np.random.default_rng(seed)
    if int8:
        return [rng.integers(-127, 128, size=(2, NUM_SAMP, 2)).astype(np.int8)
                for _ in range(k)]
    return [(rng.normal(size=(2, NUM_SAMP))
             + 1j * rng.normal(size=(2, NUM_SAMP))).astype(np.complex64)
            for _ in range(k)]


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_blockdp_multi_volume_matches_model(int8):
    """The block-parallel K-block call moves one boundary ppermute and one
    psum of the carried history per K blocks: fxtpu's model, K-fold below
    the per-block step's bytes."""
    from fxtpu.parallel.accounting import (
        predicted_volume_blockdp as jpredicted)
    eng = _engine(4, 2, fused=True, int8=int8)
    k = 8
    iq = eng.prepare_batch(_blocks(k, int8, seed=int(int8)))
    m = measured_volume(eng.multi_step, iq, torch.zeros((k, 2)),
                        eng.fresh_history())
    kw = dict(nch=2, nbins=NBINS, ntaps=NTAPS, n_shards=8, int8_native=int8)
    assert m == predicted_volume_blockdp(**kw) == jpredicted(**kw)
    per_block_step = sum(_predict(4, 2, fused=True, int8=int8).values())
    assert sum(m.values()) / k < per_block_step / 4


def test_collective_time_model_arithmetic():
    """A ring all-reduce moves 2(n-1)/n of its bytes, a permute crosses
    one link, all-to-all (n-1)/n; fxtpu's function gives the same."""
    from fxtpu.parallel.accounting import (
        predicted_collective_time as jtime)
    vols = {"collective-permute": 100, "all-reduce": 800,
            "all-to-all": 400, "all-gather": 0, "reduce-scatter": 0}
    bw = 100.0
    t = predicted_collective_time(vols, 8, bw)
    want = 100 / bw + 2 * (7 / 8) * 800 / bw + (7 / 8) * 400 / bw
    assert abs(t - want) < 1e-12
    assert t == jtime(vols, 8, bw)
    assert predicted_collective_time(vols, 1, bw) == 0.0


def test_scaling_efficiency_prediction_shape():
    """The copy of fxtpu's prediction takes the link rate as an argument
    (fxtpu names a chip): at fxtpu's rate for that chip and its test's
    flagship inputs it returns what fxtpu's returns, for every path."""
    from fxtpu.parallel.accounting import ICI_LINK_BW
    from fxtpu.parallel.accounting import (
        predicted_scaling_efficiency as jpredict)
    kw = dict(samples_per_s_single=23.1e9, nch=2, nbl=1, nbins=4096,
              num_samp=2**21, ntaps=4, n_shards=8)
    for path, extra in (("fused", {}), ("xla", {"mesh_freq": 2}),
                        ("blockdp", {"blocks_per_dispatch": 128}),
                        ("blockdp", {"blocks_per_dispatch": 8})):
        got = predicted_scaling_efficiency(
            path=path, link_bw=ICI_LINK_BW["v5e"], **kw, **extra)
        assert got == jpredict(path=path, chip="v5e", **kw, **extra)
    fused = predicted_scaling_efficiency(path="fused", link_bw=1e10, **kw)
    dp = predicted_scaling_efficiency(path="blockdp", link_bw=1e10,
                                      blocks_per_dispatch=128, **kw)
    assert dp["efficiency"] > fused["efficiency"]
    assert np.isclose(dp["aggregate_samples_per_s"],
                      8 * 23.1e9 * dp["efficiency"], rtol=1e-6)
