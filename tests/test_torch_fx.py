"""fxtpu_torch.fx.FxEngine against fxtpu.fx.FxEngine on the same numpy
blocks (CPU): the step over 3 chained blocks in every mode with packed
delays, on both of the port's routes (the plain torch step, and the fused
route whose wrapper runs the kernel's plain version on CPU tensors), the
calibrator, and the state hand-over between the packages.

Tolerance: 2e-5*scale, fxtpu's fused-against-unfused bound
(tests/test_planes.py:318-321); delays within 0.01 sample."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from fxtpu.config import CorrelatorConfig as JConfig  # noqa: E402
from fxtpu.fx import FxEngine as JEngine  # noqa: E402
from fxtpu.ops.cplx import to_complex  # noqa: E402
from fxtpu.ops.planes import pack_delays  # noqa: E402
from fxtpu.sources import NoiseSource  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine, _resolve_fused, make_fx_step  # noqa: E402

SMALL = dict(num_samp=2**13, nbins=256, clamp_num_samp=False)


def _engines(mode, nchan=2, autos=False):
    kw = dict(SMALL, mode=mode, nchan=nchan, include_autos=autos)
    return JEngine(JConfig(**kw), fused=False), \
        FxEngine(CorrelatorConfig(**kw, device="cpu"))


def _fused_step(eng):
    cfg = eng.cfg
    return make_fx_step(mode=cfg.mode, nbins=cfg.nbins,
                        window2d=eng.window2d, pairs=eng.pairs,
                        bandwidth=cfg.bandwidth, frequency=cfg.frequency,
                        device="cpu", fused=True)


def _blocks(nch, k=3, seed=21):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(nch, SMALL["num_samp"]))
             + 1j * rng.normal(size=(nch, SMALL["num_samp"])) + 0.02j
             ).astype(np.complex64) for _ in range(k)]


@pytest.mark.parametrize("route", ["plain", "fused"])
@pytest.mark.parametrize("mode,nchan,autos", [
    ("SPECTRUM", 2, False), ("SPECTRUM", 3, True), ("CONTINUUM", 2, False),
    ("TEST", 2, False)])
def test_step_matches_fxtpu_three_chained_blocks(route, mode, nchan, autos):
    jeng, teng = _engines(mode, nchan, autos)
    tstep = teng.step if route == "plain" else _fused_step(teng)
    jh, th = jeng.fresh_history(), teng.fresh_history()
    for k, x in enumerate(_blocks(nchan)):
        # per-block delays of microseconds (the TEST sweep's shape),
        # packed so both packages see the same carrier phase
        d = pack_delays(np.r_[0.0, np.linspace(1.1e-6, -2.3e-6, nchan - 1)]
                        + 1e-7 * k, jeng.cfg.frequency)
        jv, jh = jeng.step(jeng.prepare_block(x), jnp.asarray(d), jh)
        iq = torch.from_numpy(x)
        if route == "fused":
            iq = iq.reshape(nchan, -1, teng.cfg.nbins)
        tv, th = tstep(iq, torch.from_numpy(d), th)
        want = to_complex(jv)
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=2e-5 * np.abs(want).max())
        np.testing.assert_allclose(th.numpy(), to_complex(jh), atol=1e-6)


@pytest.mark.parametrize("ncal", [None, 4096])
def test_calibrate_block_matches(ncal):
    jeng, teng = _engines("SPECTRUM", nchan=3)
    blk = NoiseSource(nchan=3, delays=[0.0, 2e-6, -1e-6],
                      seed=4).read_block(SMALL["num_samp"])
    jd = np.asarray(jeng.calibrate_block(jeng.prepare_block(blk), ncal))
    td = teng.calibrate_block(teng.prepare_block(blk), ncal).numpy()
    bw = teng.cfg.bandwidth
    np.testing.assert_allclose(td * bw, jd * bw, atol=0.01)
    assert td[0] == 0.0
    np.testing.assert_allclose(td[1:] * bw, [4.8, -2.4], atol=0.5)


def test_calibrate_block_framed_input_matches_flat():
    _, teng = _engines("SPECTRUM")
    blk = _blocks(2, k=1)[0]
    flat = teng.calibrate_block(torch.from_numpy(blk))
    framed = teng.calibrate_block(torch.from_numpy(blk).reshape(2, -1, 256))
    assert torch.equal(flat, framed)


def test_example_inputs_are_fxtpus():
    jeng, teng = _engines("SPECTRUM")
    jiq, jd, jh = jeng.example_inputs(seed=5)
    tiq, td, th = teng.example_inputs(seed=5)
    np.testing.assert_array_equal(tiq.numpy(), to_complex(jiq))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(th.numpy(), to_complex(jh))


def test_import_fxtpu_state_round_trip():
    jeng, teng = _engines("SPECTRUM")
    b0, b1 = _blocks(2, k=2, seed=8)
    d = pack_delays(np.array([0.0, 3e-7]), jeng.cfg.frequency)
    _, jh = jeng.step(jeng.prepare_block(b0), jnp.asarray(d),
                      jeng.fresh_history())
    th, td = teng.import_fxtpu_state(jeng.window2d, jeng.pairs,
                                     np.asarray(jh.re), np.asarray(jh.im), d)
    np.testing.assert_array_equal(th.real.numpy(), np.asarray(jh.re))
    np.testing.assert_array_equal(th.imag.numpy(), np.asarray(jh.im))
    np.testing.assert_array_equal(td.numpy(), d)
    # both packages continue from the same state
    jv, _ = jeng.step(jeng.prepare_block(b1), jnp.asarray(d), jh)
    tv, _ = teng.step(torch.from_numpy(b1), td, th)
    want = to_complex(jv)
    np.testing.assert_allclose(tv.numpy(), want,
                               atol=2e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="pairs"):
        teng.import_fxtpu_state(jeng.window2d, jeng.pairs[:, ::-1],
                                np.asarray(jh.re), np.asarray(jh.im), d)


def test_route_resolution():
    cpu = torch.device("cpu")
    assert _resolve_fused("auto", cpu, 4096, 4, 2) is False
    assert _resolve_fused(False, torch.device("cuda"), 4096, 4, 2) is False
    assert _resolve_fused("auto", torch.device("cuda"), 4096, 4, 2) is True
    assert _resolve_fused("auto", torch.device("cuda"), 384, 4, 2) is False
    with pytest.raises(ValueError, match="CUDA device"):
        _resolve_fused(True, cpu, 4096, 4, 2)
    with pytest.raises(ValueError, match="does not take"):
        _resolve_fused(True, torch.device("cuda"), 4096, 1, 2)
    with pytest.raises(ValueError, match="fused must be"):
        _resolve_fused("yes", cpu, 4096, 4, 2)
    assert not FxEngine(CorrelatorConfig(**SMALL, device="cpu")).kernel_active


def test_cuda_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        FxEngine(CorrelatorConfig(**SMALL))
