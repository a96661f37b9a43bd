"""fxtpu_torch.ops against fxtpu.ops on the same numpy inputs (CPU).

Tolerances are fxtpu's own: spectra 5e-6*scale with history 1e-6
(tests/test_planes.py:300), delay estimates within 0.01 sample of the JAX
estimator and 0.5 sample of the injected delay (the reference oracle)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

jnp = pytest.importorskip("jax.numpy")   # absent on the card's machine

from fxtpu.ops import planes as jpl  # noqa: E402
from fxtpu.ops import window as jwin  # noqa: E402
from fxtpu.ops import xengine as jxe  # noqa: E402
from fxtpu.ops.cplx import from_complex, to_complex  # noqa: E402
from fxtpu.sources import NoiseSource  # noqa: E402
from fxtpu_torch.ops import delay as tdelay  # noqa: E402
from fxtpu_torch.ops import pfb as tpfb  # noqa: E402
from fxtpu_torch.ops import window as twin  # noqa: E402
from fxtpu_torch.ops import xengine as txe  # noqa: E402

NBINS, NSAMP, NTAPS, BW, FC = 256, 2**13, 4, 2.4e6, 1.4204e9


def _blocks(nch=2, k=2, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(nch, NSAMP)) + 1j * rng.normal(size=(nch, NSAMP))
             + 0.25 - 0.5j).astype(np.complex64) for _ in range(k)]


@pytest.mark.parametrize("name", ["hamming", "hann", "blackman",
                                  "blackmanharris", "rectangular"])
def test_window_identical(name):
    np.testing.assert_array_equal(twin.get_window(name, 1024),
                                  jwin.get_window(name, 1024))
    np.testing.assert_array_equal(twin.pfb_window(NTAPS, NBINS, name),
                                  jwin.pfb_window(NTAPS, NBINS, name))


def test_pack_delays_and_pairs_identical():
    d = np.array([[0.0, 2.1e-6, -3.7e-7], [0.0, 1e-9, 5e-6]])
    np.testing.assert_array_equal(txe.pack_delays(d, FC),
                                  jpl.pack_delays(d, FC))
    for nch, autos in ((2, False), (3, True), (8, True)):
        np.testing.assert_array_equal(txe.baseline_pairs(nch, autos),
                                      jxe.baseline_pairs(nch, autos))


def test_spectrometer_two_blocks_chained_history():
    w2d = jwin.pfb_window(NTAPS, NBINS).reshape(NTAPS, NBINS)
    wj = jnp.asarray(w2d, jnp.float32)
    wt = torch.as_tensor(w2d.astype(np.float32))
    hj, ht = None, None
    for x in _blocks():
        sj, hj = jpl.spectrometer_planes(
            jpl.dc_remove_planes(from_complex(x)), wj, NBINS, history=hj)
        st, ht = tpfb.spectrometer(tpfb.dc_remove(torch.from_numpy(x)), wt,
                                   NBINS, history=ht)
        want = to_complex(sj)
        scale = np.abs(want).max()
        np.testing.assert_allclose(st.numpy(), want, atol=5e-6 * scale)
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


@pytest.mark.parametrize("packed", [False, True])
def test_fstc_rotate_matches(packed):
    rng = np.random.default_rng(3)
    spec = (rng.normal(size=(3, 8, NBINS))
            + 1j * rng.normal(size=(3, 8, NBINS))).astype(np.complex64)
    if packed:   # microsecond delays: thousands of carrier cycles
        delays = jpl.pack_delays(np.array([0.0, 2.1e-6, -3.7e-6]), FC)
    else:        # sub-cycle delays keep the plain f32 phase comparable
        delays = np.array([0.0, 1.3e-10, -4.1e-10], np.float32)
    got = txe.fstc_rotate(torch.from_numpy(spec), torch.from_numpy(delays),
                          BW, FC)
    want = to_complex(jpl.fstc_rotate_planes(from_complex(spec),
                                             jnp.asarray(delays), BW, FC))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=2e-6 * np.abs(want).max())


def test_xcorr_and_continuum_match():
    rng = np.random.default_rng(4)
    spec = (rng.normal(size=(3, 16, NBINS))
            + 1j * rng.normal(size=(3, 16, NBINS))).astype(np.complex64)
    pairs = txe.baseline_pairs(3, True)
    got = txe.xcorr_baselines(torch.from_numpy(spec), pairs)
    want = to_complex(jpl.xcorr_baselines_planes(from_complex(spec), pairs))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-6 * np.abs(want).max())
    cont = txe.continuum_reduce(got, BW).numpy()
    np.testing.assert_allclose(cont, np.asarray(jxe.continuum_reduce(
        jnp.asarray(want), BW)), rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("delay", [2e-6, -1.3e-6])
def test_estimate_delay_matches_planes_and_truth(delay):
    blk = NoiseSource(nchan=2, delays=[0.0, delay], seed=11).read_block(NSAMP)
    x = blk - blk.mean(axis=-1, keepdims=True)
    got = float(tdelay.estimate_delay(torch.from_numpy(x[0]),
                                      torch.from_numpy(x[1]), BW))
    want = float(jpl.estimate_delay_planes(from_complex(x[0]),
                                           from_complex(x[1]), BW))
    assert abs(got - want) * BW < 0.01
    assert abs(got - delay) * BW < 0.5


# ---------------------------------------------------------------------------
# fxtpu's own ops tests (tests/test_pfb.py, test_xengine.py, test_delay.py,
# test_window.py), each case through both packages on the same seeded input:
# spectra within 5e-6 of scale of fxtpu's, the reference oracles on the
# port's results, delays within 0.5 sample of fxtpu's estimate.
# ---------------------------------------------------------------------------

from fxtpu.ops import delay as jdelay  # noqa: E402
from fxtpu.ops import pfb as jpfb  # noqa: E402
from fxtpu.sources import synthetic as jsyn  # noqa: E402
from fxtpu_torch.sources import synthetic as tsyn  # noqa: E402


def _spectra_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want,
                               atol=5e-6 * np.abs(want).max())


def _tone(num_samp, rate, freq):
    # the reference generator: linspace(0, T, num) (test_effex.py:31-41)
    t = np.linspace(0, num_samp / rate, num=num_samp)
    return (np.cos(2 * np.pi * freq * t)
            + 1j * np.sin(2 * np.pi * freq * t)).astype(np.complex64)


@pytest.mark.parametrize("num_samp", [3 + 2**12, 2**18])
@pytest.mark.parametrize("rate", [1e6, 2.4e6])
@pytest.mark.parametrize("freq", [2e4, 1e5])
@pytest.mark.parametrize("taps", [4, 32])
@pytest.mark.parametrize("branches", [2048, 4096])
def test_spectrometer_tone_location(num_samp, rate, freq, taps, branches):
    iq = _tone(num_samp, rate, freq)
    window = twin.pfb_window(taps, branches)
    spec = tpfb.spectrometer_poly(torch.from_numpy(iq), window,
                                  branches).numpy()
    _spectra_close(spec, jpfb.spectrometer_poly(
        jnp.asarray(iq), jnp.asarray(jwin.pfb_window(taps, branches)),
        branches))
    psd = np.fft.fftshift(np.real(spec * np.conj(spec)).mean(axis=0))
    freqs = np.fft.fftshift(np.fft.fftfreq(len(psd), d=1 / rate))
    assert 100.0 * abs(freqs[np.argmax(psd)] - freq) / freq < 1.0


def test_framing_counts_and_tail_drop():
    nbins, ntaps = 16, 4
    x = np.arange(16 * 5 + 3).astype(np.complex64)   # not a whole row count
    xp, hist = tpfb.frame_blocks(torch.from_numpy(x), nbins, ntaps)
    jxp, jhist = jpfb.frame_blocks(jnp.asarray(x), nbins, ntaps)
    assert xp.shape == jxp.shape == (5 + ntaps - 1, nbins)
    assert hist.shape == jhist.shape == (ntaps - 1, nbins)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jhist))
    np.testing.assert_array_equal(xp[:ntaps - 1].numpy(), 0)
    spec = tpfb.spectrometer_poly(torch.from_numpy(x),
                                  twin.pfb_window(ntaps, nbins), nbins)
    assert spec.shape == ((16 * 5 + 3) // nbins, nbins)


def test_pfb_fir_matches_direct_sum(rng):
    nbins, ntaps, s = 8, 4, 6
    xp = (rng.normal(size=(s + ntaps - 1, nbins))
          + 1j * rng.normal(size=(s + ntaps - 1, nbins))).astype(np.complex64)
    w = rng.normal(size=(ntaps, nbins)).astype(np.float32)
    got = tpfb.pfb_fir(torch.from_numpy(xp), torch.from_numpy(w)).numpy()
    want = sum(w[t] * xp[t:t + s] for t in range(ntaps))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jpfb.pfb_fir(
        jnp.asarray(xp), jnp.asarray(w))), rtol=1e-5)


def test_streaming_matches_contiguous(rng):
    """Two streamed blocks with carried history give the contiguous
    signal's frames, as fxtpu's do."""
    nbins, ntaps = 64, 4
    window = twin.pfb_window(ntaps, nbins)
    x = (rng.normal(size=4096) + 1j * rng.normal(size=4096)
         ).astype(np.complex64)
    xt = torch.from_numpy(x)
    full, _ = tpfb.spectrometer_poly_stream(xt, window, nbins)
    a, hist = tpfb.spectrometer_poly_stream(xt[:2048], window, nbins)
    b, _ = tpfb.spectrometer_poly_stream(xt[2048:], window, nbins,
                                         history=hist)
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), full.numpy(),
                               rtol=1e-4, atol=1e-6)
    ja, jh = jpfb.spectrometer_poly_stream(jnp.asarray(x[:2048]),
                                           jnp.asarray(window), nbins)
    jb, _ = jpfb.spectrometer_poly_stream(jnp.asarray(x[2048:]),
                                          jnp.asarray(window), nbins,
                                          history=jh)
    _spectra_close(b.numpy(), jb)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jh), atol=1e-6)


def test_batched_channels(rng):
    nbins, ntaps = 32, 4
    window = twin.pfb_window(ntaps, nbins)
    x = (rng.normal(size=(3, 2, 1024))
         + 1j * rng.normal(size=(3, 2, 1024))).astype(np.complex64)
    spec = tpfb.spectrometer_poly(torch.from_numpy(x), window, nbins)
    assert spec.shape == (3, 2, 1024 // nbins, nbins)
    one = tpfb.spectrometer_poly(torch.from_numpy(x[1, 0]), window, nbins)
    np.testing.assert_allclose(spec[1, 0].numpy(), one.numpy(), rtol=1e-5)
    _spectra_close(spec.numpy(), jpfb.spectrometer_poly(
        jnp.asarray(x), jnp.asarray(window), nbins))


def test_phase_continuous_tone_source():
    """The port's sinusoid generator is fxtpu's, bit for bit, and
    phase-continuous across blocks."""
    a = tsyn.complex_sinusoid(64, 1e6, 1.23e4, t0=0.0)
    b = tsyn.complex_sinusoid(64, 1e6, 1.23e4, t0=64 / 1e6)
    c = tsyn.complex_sinusoid(128, 1e6, 1.23e4, t0=0.0)
    np.testing.assert_allclose(np.concatenate([a, b]), c, atol=1e-5)
    np.testing.assert_array_equal(
        c, jsyn.complex_sinusoid(128, 1e6, 1.23e4, t0=0.0))


def test_rf_freqs_matches_reference_formula():
    bw, fc, nbins = 2.4e6, 1.4204e9, 512
    got = txe.rf_freqs(nbins, bw, fc, False, "cpu").numpy()
    want = np.fft.fftfreq(nbins, d=1 / bw) + fc  # effex.py:516
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, np.asarray(jxe.rf_freqs(nbins, bw, fc)),
                               rtol=1e-6)


def test_fstc_reduces_to_reference_expression(rng):
    """G0 conj(G1) with delays [0, d] is the reference's f0 * conj(f1 *
    rot), rot = exp(-2j pi f (-d)) (effex.py:519-520), within fxtpu's
    bound for a float32 phase of ~3.7e3 rad."""
    bw, fc, nbins, s = 2.4e6, 1.4204e9, 64, 3
    d = 4.2e-7
    f = (rng.normal(size=(2, s, nbins)) + 1j * rng.normal(size=(2, s, nbins))
         ).astype(np.complex64)
    g = txe.fstc_rotate(torch.from_numpy(f), torch.tensor([0.0, d]), bw,
                        fc).numpy()
    ours = (g[0] * np.conj(g[1])).mean(axis=0)
    freqs = np.fft.fftfreq(nbins, d=1 / bw) + fc
    rot = np.exp(-2j * np.pi * freqs * (-d))
    ref = (f[0] * np.conj(f[1] * rot)).mean(axis=0)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, atol=5e-3 * scale)
    jg = np.asarray(jxe.fstc_rotate(jnp.asarray(f), jnp.asarray([0.0, d]),
                                    bw, fc))
    theirs = (jg[0] * np.conj(jg[1])).mean(axis=0)
    np.testing.assert_allclose(ours, theirs, atol=5e-3 * scale)


def test_xcorr_pair_is_fftshifted_mean(rng):
    s, nbins = 4, 16
    f0 = (rng.normal(size=(s, nbins))
          + 1j * rng.normal(size=(s, nbins))).astype(np.complex64)
    f1 = (rng.normal(size=(s, nbins))
          + 1j * rng.normal(size=(s, nbins))).astype(np.complex64)
    got = txe.xcorr_pair(torch.from_numpy(f0), torch.from_numpy(f1)).numpy()
    want = np.fft.fftshift((f0 * np.conj(f1)).mean(axis=0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jxe.xcorr_pair(
        jnp.asarray(f0), jnp.asarray(f1))), rtol=1e-5)


def test_baseline_pairs_counts():
    assert txe.baseline_pairs(2).tolist() == [[0, 1]]
    p8 = txe.baseline_pairs(8)
    assert p8.shape == (28, 2)
    p8a = txe.baseline_pairs(8, include_autos=True)
    assert p8a.shape == (36, 2)
    assert all(p < q for p, q in p8.tolist())
    np.testing.assert_array_equal(p8a, jxe.baseline_pairs(8, True))


def test_xcorr_baselines_matches_pairwise(rng):
    nch, s, nbins = 4, 3, 32
    spec = (rng.normal(size=(nch, s, nbins))
            + 1j * rng.normal(size=(nch, s, nbins))).astype(np.complex64)
    pairs = txe.baseline_pairs(nch, include_autos=True)
    st = torch.from_numpy(spec)
    vis = txe.xcorr_baselines(st, pairs).numpy()
    for l, (p, q) in enumerate(pairs.tolist()):
        np.testing.assert_allclose(vis[l], txe.xcorr_pair(st[p], st[q])
                                   .numpy(), rtol=1e-5)
    np.testing.assert_allclose(vis, np.asarray(jxe.xcorr_baselines(
        jnp.asarray(spec), pairs)), rtol=1e-5)


def test_continuum_reduce_matches_reference(rng):
    bw = 2.4e6
    vis = (rng.normal(size=(3, 64))
           + 1j * rng.normal(size=(3, 64))).astype(np.complex64)
    got = txe.continuum_reduce(torch.from_numpy(vis), bw).numpy()
    np.testing.assert_allclose(got, vis.mean(axis=-1) / bw, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jxe.continuum_reduce(
        jnp.asarray(vis), bw)), rtol=1e-5)


def test_delay_phase_closure(rng):
    """A true delay calibrated into the FSTC ramp flattens the
    cross-spectrum phase (the same input through both packages)."""
    bw, fc, nbins, ntaps = 2.4e6, 1.4204e9, 256, 4
    d_true = 3.0 / bw
    x = tsyn.complex_noise(rng, 2**14, scale=1.0)
    iq = np.stack([x, tsyn.fractional_delay(x, d_true * bw)])
    window = twin.pfb_window(ntaps, nbins)
    spec = tpfb.spectrometer_poly(torch.from_numpy(iq), window, nbins)
    _spectra_close(spec.numpy(), jpfb.spectrometer_poly(
        jnp.asarray(iq), jnp.asarray(window), nbins))
    raw = txe.xcorr_pair(spec[0], spec[1]).numpy()
    rot = txe.fstc_rotate(spec, torch.tensor([0.0, d_true]), bw, fc)
    cor = txe.xcorr_pair(rot[0], rot[1]).numpy()
    inner = slice(nbins // 4, 3 * nbins // 4)
    raw_spread = np.std(np.angle(raw[inner] * np.conj(raw[inner][0])))
    cor_spread = np.std(np.angle(cor[inner] * np.conj(cor[inner][0])))
    assert cor_spread < 0.15
    assert cor_spread < raw_spread / 5


OFFSETS = [-2000, -1001, -1, 0, 1, 999, 2000]  # test_effex.py:94


def _delays(fn_t, fn_j, iq_0, iq_1, rate, **kw):
    """The port's and fxtpu's estimate in seconds on the same series."""
    got = float(fn_t(torch.from_numpy(iq_0), torch.from_numpy(iq_1), rate,
                     **kw))
    want = float(fn_j(jnp.asarray(iq_0), jnp.asarray(iq_1), rate, **kw))
    assert abs(got - want) * rate < 0.5
    return got


@pytest.mark.parametrize("num_samp", [3 + 2**12, 2**18])
@pytest.mark.parametrize("samp_offset_int", OFFSETS)
def test_estimate_delay_gaussian(rng, num_samp, samp_offset_int):
    rate = 2.4e6
    iq_0 = tsyn.complex_noise(rng, num_samp)
    iq_1 = np.roll(iq_0, samp_offset_int)
    est = _delays(tdelay.estimate_delay_gaussian,
                  jdelay.estimate_delay_gaussian, iq_0, iq_1, rate)
    assert abs(samp_offset_int - est * rate) < 0.5  # test_effex.py:99,106


@pytest.mark.parametrize("num_samp", [3 + 2**12, 2**18])
@pytest.mark.parametrize("samp_offset_int", OFFSETS)
def test_estimate_delay_wrapper(rng, num_samp, samp_offset_int):
    rate = 2.4e6
    iq_0 = tsyn.complex_noise(rng, num_samp)
    iq_1 = np.roll(iq_0, samp_offset_int)
    est = _delays(tdelay.estimate_delay, jdelay.estimate_delay, iq_0, iq_1,
                  rate)
    assert abs(samp_offset_int / rate - est) < 1e-6  # test_effex.py:114,121


@pytest.mark.parametrize("frac", [-1200.5, -0.25, 0.5, 333.3])
def test_fractional_delay_recovery(rng, frac):
    rate = 2.4e6
    iq_0 = tsyn.complex_noise(rng, 2**16)
    iq_1 = tsyn.fractional_delay(iq_0, frac)
    np.testing.assert_array_equal(iq_1, jsyn.fractional_delay(iq_0, frac))
    est = _delays(tdelay.estimate_delay_gaussian,
                  jdelay.estimate_delay_gaussian, iq_0, iq_1, rate)
    assert abs(frac - est * rate) < 0.3


def test_peak_at_edge_clamps_and_stays_accurate():
    """An argmax at the last correlation bin (2n-1) clamps the 3-point
    stencil into the interior and still recovers the -(n-1) lag."""
    n = 256
    iq_0 = np.zeros(n, np.complex64)
    iq_1 = np.zeros(n, np.complex64)
    iq_0[n - 1] = 1.0
    iq_1[0] = 1.0
    rate = 2.4e6
    assert int(tdelay.xcorr_mag(torch.from_numpy(iq_0),
                                torch.from_numpy(iq_1)).argmax()) == 2 * n - 1
    est = _delays(tdelay.estimate_delay_gaussian,
                  jdelay.estimate_delay_gaussian, iq_0, iq_1, rate)
    assert np.isfinite(est)
    assert abs(est * rate - (-(n - 1))) < 2.5


def test_test_mode_offset_subtraction(rng):
    iq = tsyn.complex_noise(rng, 4096)
    base = _delays(tdelay.estimate_delay, jdelay.estimate_delay, iq, iq,
                   2.4e6)
    off = _delays(tdelay.estimate_delay, jdelay.estimate_delay, iq, iq,
                  2.4e6, test_offset=1e-6)
    np.testing.assert_allclose(base - off, 1e-6, rtol=1e-6)


@pytest.mark.parametrize("fn", ["estimate_delay_gaussian", "xcorr_mag",
                                "estimate_delay"])
def test_mismatched_lengths_raise(fn):
    rate = [1.0] if fn != "xcorr_mag" else []
    a, b = torch.zeros(8, dtype=torch.complex64), torch.zeros(
        9, dtype=torch.complex64)
    with pytest.raises(ValueError):
        getattr(tdelay, fn)(a, b, *rate)
    with pytest.raises(ValueError):
        getattr(jdelay, fn)(jnp.zeros(8, jnp.complex64),
                            jnp.zeros(9, jnp.complex64), *rate)


@pytest.mark.parametrize("name", ["hamming", "hann", "blackman",
                                  "blackmanharris", "boxcar"])
@pytest.mark.parametrize("n", [7, 64, 4096])
def test_get_window_matches_scipy(name, n):
    ss = pytest.importorskip("scipy.signal")
    ours = twin.get_window(name, n)
    np.testing.assert_allclose(ours, ss.get_window(name, n), atol=1e-12)
    np.testing.assert_array_equal(ours, jwin.get_window(name, n))


@pytest.mark.parametrize("numtaps,cutoff", [
    (16384, 1 / 4096), (8192, 1 / 2048), (131072, 1 / 4096), (101, 0.3)])
def test_firwin_matches_scipy(numtaps, cutoff):
    ss = pytest.importorskip("scipy.signal")
    ours = twin.firwin(numtaps, cutoff, window="rectangular")
    np.testing.assert_allclose(
        ours, ss.firwin(numtaps, cutoff, window="rectangular"), atol=1e-12)
    np.testing.assert_array_equal(
        ours, jwin.firwin(numtaps, cutoff, window="rectangular"))


def test_pfb_window_is_reference_composite():
    ss = pytest.importorskip("scipy.signal")
    w = twin.pfb_window(4, 4096)
    expected = (ss.get_window("hamming", 16384)
                * ss.firwin(16384, cutoff=1 / 4096, window="rectangular"))
    np.testing.assert_allclose(w, expected, atol=1e-15)


@pytest.mark.parametrize("call", [
    lambda W: W.firwin(64, 0.0), lambda W: W.firwin(64, 1.5),
    lambda W: W.get_window("nosuch", 8)])
def test_firwin_validates(call):
    for W in (twin, jwin):
        with pytest.raises(ValueError):
            call(W)
