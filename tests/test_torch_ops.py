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
