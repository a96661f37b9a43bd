"""fxtpu_torch.fx.FxEngine against fxtpu.fx.FxEngine on the same numpy
blocks (CPU): the step over 3 chained blocks in every mode with packed
delays, on both of the port's routes (the plain torch step, and the fused
route whose wrapper runs the kernel's plain version on CPU tensors), for
complex64 and 8-bit ingest, the calibrator, and the state hand-over
between the packages.

Tolerance: 2e-5*scale, fxtpu's fused-against-unfused bound
(tests/test_planes.py:318-321), and 3e-5*scale on the int8-native fused
route and at deep taps (the SVD-FIR mode), fxtpu's own bounds there
(tests/test_planes.py:558 and :485); delays within 0.01 sample."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

jnp = pytest.importorskip("jax.numpy")   # absent on the card's machine

from fxtpu.config import CorrelatorConfig as JConfig  # noqa: E402
from fxtpu.fx import FxEngine as JEngine  # noqa: E402
from fxtpu.ops.cplx import to_complex  # noqa: E402
from fxtpu.ops.planes import pack_delays  # noqa: E402
from fxtpu.sources import NoiseSource  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import (FxEngine, _resolve_fused, _svd_mode,  # noqa: E402
                            make_fx_step)

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


STEP = 1.0 / 32


def _int8_engines(route):
    kw = dict(SMALL, mode="SPECTRUM", ingest_dtype="int8", quant_step=STEP)
    fused = route == "fused"
    return (JEngine(JConfig(**kw), fused=fused),
            FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=fused))


def _int8_blocks(nch=2, k=3, seed=23):
    """8-bit blocks [nch, num_samp, 2]: noise of ~30 quant units plus a
    per-channel DC offset of a few quant units (ROADMAP.md B)."""
    rng = np.random.default_rng(seed)
    dc = np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None, None]
    return [np.clip(np.rint(30 * rng.normal(size=(nch, SMALL["num_samp"], 2))
                            + dc), -127, 127).astype(np.int8)
            for _ in range(k)]


def _i8_tail(hist):
    """fxtpu's packed raw tail as the port's int8 [nch, halo, nbins, 2]."""
    from fxtpu_torch.fx import _unpack_i8_words
    return np.stack([_unpack_i8_words(hist["tail"].re),
                     _unpack_i8_words(hist["tail"].im)], axis=-1)


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


@pytest.mark.parametrize("route,tol", [("plain", 2e-5), ("fused", 3e-5)])
def test_int8_step_matches_fxtpu_three_chained_blocks(route, tol):
    """Every block from a fresh history is checked: the first block's zero
    tail (mu_prev = 0) and the carried tail are different paths."""
    jeng, teng = _int8_engines(route)
    assert teng.fused_active == jeng.fused_active == (route == "fused")
    assert teng.int8_native == jeng.int8_native == (route == "fused")
    assert not teng.kernel_active
    jh, th = jeng.fresh_history(), teng.fresh_history()
    assert isinstance(th, dict) == (route == "fused")
    for k, x in enumerate(_int8_blocks()):
        d = pack_delays(np.array([0.0, 1.3e-6 + 1e-7 * k]),
                        jeng.cfg.frequency)
        jv, jh = jeng.step(jeng.prepare_block(x), jnp.asarray(d), jh)
        iq = teng.prepare_block(x)
        assert iq.dtype == torch.int8   # shipped as 8-bit samples
        tv, th = teng.step(iq, torch.from_numpy(d), th)
        want = to_complex(jv)
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"block {k}")
        if route == "fused":
            np.testing.assert_array_equal(th["tail"].numpy(), _i8_tail(jh))
            np.testing.assert_allclose(th["mu_prev"].numpy(),
                                       to_complex(jh["mu_prev"]), atol=1e-7)
        else:
            np.testing.assert_allclose(th.numpy(), to_complex(jh),
                                       atol=1e-6)


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_int8_engine_accepts_complex_blocks(route):
    """Complex samples into an int8 engine equal the pre-quantized input
    (fxtpu's tests/test_end_to_end.py:692-719)."""
    from fxtpu_torch.runtime.native import quantize_c64
    _, teng = _int8_engines(route)
    blk = _blocks(2, k=1, seed=4)[0]
    q = quantize_c64(blk, STEP)
    d = torch.as_tensor(pack_delays(np.array([0.0, 1e-7]),
                                    teng.cfg.frequency))
    iq_c, iq_q = teng.prepare_block(blk), teng.prepare_block(q)
    assert torch.equal(iq_c, iq_q)
    v_c, h_c = teng.step(iq_c, d, teng.fresh_history())
    v_q, h_q = teng.step(iq_q, d, teng.fresh_history())
    assert torch.equal(v_c, v_q)


def test_int8_calibrate_block_matches():
    from fxtpu_torch.runtime.native import quantize_c64
    jeng, teng = _int8_engines("fused")
    blk = quantize_c64(NoiseSource(nchan=2, delays=[0.0, 2e-6],
                                   seed=4).read_block(SMALL["num_samp"]),
                       STEP)
    jd = np.asarray(jeng.calibrate_block(jeng.prepare_block(blk), 4096))
    td = teng.calibrate_block(teng.prepare_block(blk), 4096).numpy()
    bw = teng.cfg.bandwidth
    np.testing.assert_allclose(td * bw, jd * bw, atol=0.01)
    np.testing.assert_allclose(td[1] * bw, 4.8, atol=0.5)


@pytest.mark.parametrize("route", ["plain", "fused"])
def test_int8_example_inputs_are_fxtpus(route):
    jeng, teng = _int8_engines(route)
    jiq, jd, jh = jeng.example_inputs(seed=5)
    tiq, td, th = teng.example_inputs(seed=5)
    if route == "fused":   # fxtpu ships packed words, the port int8 pairs
        from fxtpu_torch.fx import _unpack_i8_words
        want = np.stack([_unpack_i8_words(jiq.re), _unpack_i8_words(jiq.im)],
                        axis=-1)
        np.testing.assert_array_equal(th["tail"].numpy(), _i8_tail(jh))
    else:
        want = np.stack([np.asarray(jiq.re), np.asarray(jiq.im)], axis=-1)
        np.testing.assert_array_equal(th.numpy(), to_complex(jh))
    np.testing.assert_array_equal(tiq.numpy(), want)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_import_fxtpu_state_int8_round_trip():
    jeng, teng = _int8_engines("fused")
    b0, b1 = _int8_blocks(k=2, seed=8)
    d = pack_delays(np.array([0.0, 3e-7]), jeng.cfg.frequency)
    _, jh = jeng.step(jeng.prepare_block(b0), jnp.asarray(d),
                      jeng.fresh_history())
    th, td = teng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh, d)
    np.testing.assert_array_equal(th["tail"].numpy(), _i8_tail(jh))
    np.testing.assert_array_equal(th["mu_prev"].numpy(),
                                  to_complex(jh["mu_prev"]))
    # both packages continue from the same state
    jv, _ = jeng.step(jeng.prepare_block(b1), jnp.asarray(d), jh)
    tv, _ = teng.step(teng.prepare_block(b1), td, th)
    want = to_complex(jv)
    np.testing.assert_allclose(tv.numpy(), want,
                               atol=3e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="int8_native"):
        teng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh["tail"], d)


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
    th, td = teng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh, d)
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
        teng.import_fxtpu_state(jeng.window2d, jeng.pairs[:, ::-1], jh, d)


def test_route_resolution():
    """'auto' takes the fused route only on a CUDA device; True takes it
    on any device (the CPU runs the kernels' plain versions, as fxtpu runs
    Pallas in interpret mode there) and raises for a shape the kernel
    does not take; only a CUDA device makes the route a kernel."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert _resolve_fused("auto", cpu, 4096, 4, 2) is False
    assert _resolve_fused(True, cpu, 4096, 4, 2) is True
    assert _resolve_fused(False, cuda, 4096, 4, 2) is False
    assert _resolve_fused("auto", cuda, 4096, 4, 2) is True
    assert _resolve_fused("auto", cuda, 384, 4, 2) is True
    assert _resolve_fused("auto", cuda, 1000, 4, 2) is False
    # int8: a block shorter than the tail takes the plain route
    assert _resolve_fused("auto", cuda, 256, 4, 2, int8=True, s_rows=3)
    assert not _resolve_fused("auto", cuda, 256, 4, 2, int8=True, s_rows=2)
    with pytest.raises(ValueError, match="does not take"):
        _resolve_fused(True, cuda, 4096, 1, 2)
    with pytest.raises(ValueError, match="does not take"):
        _resolve_fused(True, cpu, 256, 4, 2, int8=True, s_rows=2)
    with pytest.raises(ValueError, match="fused must be"):
        _resolve_fused("yes", cpu, 4096, 4, 2)
    plain = FxEngine(CorrelatorConfig(**SMALL, device="cpu"))
    assert not plain.kernel_active and not plain.fused_active
    fused = FxEngine(CorrelatorConfig(**SMALL, device="cpu"), fused=True)
    assert fused.fused_active and not fused.kernel_active


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_deep_tap_step_matches_fxtpu_three_chained_blocks(ingest):
    """32 taps, fused=True in both packages: both run the SVD-FIR mode
    (fxtpu its Pallas kernel in interpret mode, the port the plain
    version), over 3 chained blocks from a fresh history."""
    kw = dict(SMALL, mode="SPECTRUM", ntaps=32, ingest_dtype=ingest,
              quant_step=STEP)
    jeng = JEngine(JConfig(**kw), fused=True)
    teng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=True)
    assert jeng.fused_active and teng.fused_active and not teng.kernel_active
    assert teng.fir_mode == "svd"
    int8 = ingest == "int8"
    assert teng.int8_native == jeng.int8_native == int8
    blocks = (_int8_blocks(seed=29) if int8 else
              [b + (0.02 - 0.01j) for b in _blocks(2, seed=28)])
    jh, th = jeng.fresh_history(), teng.fresh_history()
    for k, x in enumerate(blocks):
        d = pack_delays(np.array([0.0, 1.3e-6 + 1e-7 * k]),
                        jeng.cfg.frequency)
        jv, jh = jeng.step(jeng.prepare_block(x), jnp.asarray(d), jh)
        tv, th = teng.step(teng.prepare_block(x), torch.from_numpy(d), th)
        want = to_complex(jv)
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=3e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        if int8:
            np.testing.assert_array_equal(th["tail"].numpy(), _i8_tail(jh))
            np.testing.assert_allclose(th["mu_prev"].numpy(),
                                       to_complex(jh["mu_prev"]), atol=1e-7)
        else:
            np.testing.assert_allclose(th.numpy(), to_complex(jh),
                                       atol=1e-6)


def test_fir_mode_resolution():
    """SVD where the window factorises (as fxtpu decides), the direct loop
    elsewhere and on the plain route."""
    from fxtpu.fx import _deep_svd_applies
    from fxtpu_torch.ops.window import pfb_window
    windows = {
        "pfb32": (pfb_window(32, 256).reshape(32, 256), True),
        "pfb4": (pfb_window(4, 256).reshape(4, 256), False),
        "random32": (np.random.default_rng(3).normal(size=(32, 256)), False),
    }
    for name, (w, svd) in windows.items():
        assert (_svd_mode(w, 256, "cpu") is not None) == svd, name
        assert _deep_svd_applies(w, 256) == svd, name
    for ntaps, fused, mode in ((32, True, "svd"), (16, True, "svd"),
                               (4, True, "direct"), (32, False, "direct")):
        for ingest in ("complex64", "int8"):
            cfg = CorrelatorConfig(**SMALL, ntaps=ntaps, device="cpu",
                                   ingest_dtype=ingest)
            assert FxEngine(cfg, fused=fused).fir_mode == mode
    # a rank above the kernel's bound: fused=True raises, 'auto' is plain
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="rank=17"):
        _resolve_fused(True, cuda, 256, 32, 2, rank=17)
    assert not _resolve_fused("auto", cuda, 256, 32, 2, rank=17)
    assert _resolve_fused("auto", cuda, 8192, 32, 2, rank=6)
    # 3 channels of 8192 bins: the wide route (the X stage through
    # device memory) takes them
    assert _resolve_fused("auto", cuda, 8192, 32, 3, rank=6)


def _two_pass_step(eng):
    """The fused step's two-pass form for ``eng``'s configuration, as a
    caller composes it: fx_fused_raw / fx_fused_raw_i8 (the mean
    subtracted before the FIR), then the plain finish."""
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops.fx_epilogue import FinishTables, finish
    cfg = eng.cfg
    w = torch.as_tensor(eng.window2d.astype(np.float32))
    pairs = ff.pairs_tensor(eng.pairs, cfg.nchan, "cpu")
    tables = FinishTables(eng.pairs, cfg.nbins, cfg.bandwidth, cfg.frequency,
                          "cpu")

    def step(iq, delays, history):
        if isinstance(history, dict):
            xp, history = ff.fx_fused_raw_i8(iq, history, w, pairs,
                                             cfg.quant_step)
        else:
            xp, history = ff.fx_fused_raw(iq, history, w, pairs)
        return finish(xp, delays, tables, iq.shape[1], cfg.bandwidth,
                      cfg.mode in ("CONTINUUM", "TEST")), history

    return step


@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_single_pass_step_matches_the_two_pass_form(ingest, mode):
    """The engine's fused step (the single pass) against the two-pass
    wrappers with the plain finish, over 3 chained blocks with plain
    (unpacked) sub-cycle delays: within 2e-5 of max|vis|, history 1e-6."""
    kw = dict(SMALL, mode=mode, ingest_dtype=ingest, quant_step=STEP,
              device="cpu", nchan=3, include_autos=True)
    eng = FxEngine(CorrelatorConfig(**kw), fused=True)
    two = _two_pass_step(eng)
    blocks = (_int8_blocks(nch=3, seed=33) if ingest == "int8"
              else _blocks(3, seed=32))
    d = torch.tensor([0.0, 1.1e-10, -2.3e-10])
    h1 = h2 = eng.fresh_history()
    for k, x in enumerate(blocks):
        iq = eng.prepare_block(x)
        v1, h1 = eng.step(iq, d, h1)
        v2, h2 = two(iq, d, h2)
        assert v1.shape == v2.shape == ((6,) if mode == "CONTINUUM"
                                        else (6, 256))
        assert (v1 - v2).abs().max() <= 2e-5 * v2.abs().max(), f"block {k}"
        if ingest == "int8":
            assert torch.equal(h1["tail"], h2["tail"])
            assert (h1["mu_prev"] - h2["mu_prev"]).abs().max() <= 1e-7
        else:
            assert (h1 - h2).abs().max() <= 1e-6


def test_fused_route_is_the_single_pass():
    """The fused route's counters are the single pass's (its frame kernel
    by ingest, then the parts reduce) and the epilogue's; the plain route
    has none.  Its K cap counts the single
    pass's partials (5 rows a CTA for 2 channels and one baseline)."""
    from fxtpu_torch.ops import fx_fused as ff
    cfg = CorrelatorConfig(**SMALL, device="cpu")
    assert list(FxEngine(cfg, fused=True).launch_counts()) == [
        "fx_fused_parts", "parts_reduce", "fx_finish"]
    i8 = CorrelatorConfig(**SMALL, device="cpu", ingest_dtype="int8")
    assert list(FxEngine(i8, fused=True).launch_counts()) == [
        "fx_fused_parts_i8", "parts_reduce", "fx_finish"]
    assert FxEngine(cfg, fused=False).launch_counts() == {}
    big = CorrelatorConfig(num_samp=2**21, nbins=4096, clamp_num_samp=False,
                           device="cpu")
    assert FxEngine(big, fused=True).dispatch_batch_for(64) == (
        ff.max_blocks_parts(512, 4096, 2, 1)) == 25
    assert FxEngine(big, fused=False).dispatch_batch_for(64) == 64


@pytest.mark.parametrize("ingest,tol", [("complex64", 2e-5), ("int8", 3e-5)])
def test_import_fxtpu_state_round_trip_on_the_single_pass(ingest, tol):
    """The history contracts did not change with the single pass: the
    state fxtpu's fused engine leaves after one block is imported as it
    is, and both packages go on for two blocks, each from its own
    carried history."""
    kw = dict(SMALL, mode="SPECTRUM", ingest_dtype=ingest, quant_step=STEP)
    jeng = JEngine(JConfig(**kw), fused=True)
    teng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=True)
    blocks = (_int8_blocks(k=3, seed=35) if ingest == "int8"
              else _blocks(2, k=3, seed=34))
    d = pack_delays(np.array([0.0, 3e-7]), jeng.cfg.frequency)
    _, jh = jeng.step(jeng.prepare_block(blocks[0]), jnp.asarray(d),
                      jeng.fresh_history())
    th, td = teng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh, d)
    for k, x in enumerate(blocks[1:]):
        jv, jh = jeng.step(jeng.prepare_block(x), jnp.asarray(d), jh)
        tv, th = teng.step(teng.prepare_block(x), td, th)
        want = to_complex(jv)
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"block {k + 1}")
    if ingest == "int8":
        np.testing.assert_array_equal(th["tail"].numpy(), _i8_tail(jh))
        np.testing.assert_allclose(th["mu_prev"].numpy(),
                                   to_complex(jh["mu_prev"]), atol=1e-7)
    else:
        np.testing.assert_allclose(th.numpy(), to_complex(jh), atol=1e-6)


def test_cuda_engine_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        FxEngine(CorrelatorConfig(**SMALL))
