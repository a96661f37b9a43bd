"""The deep-tap FIR through the window's rank-r factors:
fxtpu_torch.ops.svd_fir against fxtpu's _svd_fir_factors and
_deep_svd_applies, and the SVD-FIR mode of the fused step's plain versions
against fxtpu's fused Pallas kernel in its SVD-FIR mode (interpret mode on
the CPU, as fxtpu's own tests run it), in both ingests.

Tolerances: the factors' product u @ v within 1e-12 of fxtpu's (both take
numpy's float64 SVD of the same window; the factors themselves may differ
in sign on another LAPACK, so they are not compared), rank and ratios
equal; the fused step within 3e-5*scale, fxtpu's deep-tap bound
(tests/test_planes.py:485), with the f32 history within 1e-6, and for
8-bit samples the raw tail exact and mu_prev within 1e-7.

The JAX package is imported inside the tests that need it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops.fx_fused import (fx_fused_raw,  # noqa: E402
                                      fx_fused_raw_i8,
                                      fx_fused_raw_i8_reference,
                                      fx_fused_raw_reference, pairs_tensor,
                                      svd_tensors)
from fxtpu_torch.ops.pfb import pfb_fir, svd_fir  # noqa: E402
from fxtpu_torch.ops.svd_fir import (SVD_FIR_MIN_TAPS,  # noqa: E402
                                     SVD_TOL, deep_svd_applies,
                                     svd_fir_factors)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

NBINS, NSAMP, NTAPS = 256, 2**13, 32
STEP = 1.0 / 32


def _window(ntaps=NTAPS, nbins=NBINS):
    return pfb_window(ntaps, nbins).reshape(ntaps, nbins)


def _graded_window(ntaps=16, nbins=NBINS):
    """A full-size window whose singular values fall from 1 to 1e-6: rank
    below ntaps at tol 1e-5, full rank at 1e-7."""
    rng = np.random.default_rng(7)
    qu, _ = np.linalg.qr(rng.normal(size=(ntaps, ntaps)))
    qv, _ = np.linalg.qr(rng.normal(size=(nbins, ntaps)))
    return (qu * np.logspace(0, -6, ntaps)) @ qv.T


def _svd_blocks(nch, seed, k):
    """``k`` blocks of framed complex64 samples with a small DC offset per
    channel (fxtpu's post-hoc DC bin loses precision as the mean grows,
    ROADMAP.md B)."""
    rng = np.random.default_rng(seed)
    s = NSAMP // NBINS
    return [(rng.normal(size=(nch, s, NBINS))
             + 1j * rng.normal(size=(nch, s, NBINS))
             + (0.04 - 0.03j) * np.arange(1, nch + 1)[:, None, None]
             ).astype(np.complex64) for _ in range(k)]


def _i8_blocks(nch, seed, k):
    rng = np.random.default_rng(seed)
    dc = np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None]
    return [np.clip(np.rint(30 * rng.normal(size=(nch, NSAMP // NBINS, NBINS,
                                                  2))
                            + dc[:, None, None, :]), -127, 127
                    ).astype(np.int8) for _ in range(k)]


@pytest.mark.parametrize("ntaps", [16, 32])
@pytest.mark.parametrize("nbins", [256, 512, 8192])
def test_factors_match_fxtpu(ntaps, nbins):
    pytest.importorskip("jax")
    from fxtpu.ops.pfb_pallas import _svd_fir_factors
    w = _window(ntaps, nbins)
    u, v, ratios = svd_fir_factors(w, nbins)
    ju, jv, jratios = _svd_fir_factors(tuple(w.ravel()), nbins)
    assert u.shape == ju.shape and v.shape == jv.shape
    assert 1 <= u.shape[1] < ntaps
    np.testing.assert_allclose(u @ v, ju @ jv, rtol=0, atol=1e-12)
    np.testing.assert_allclose(ratios, jratios, rtol=1e-12)
    # the product is the window to within the dropped singular values
    assert np.abs(u @ v - w).max() <= SVD_TOL * np.abs(w).max() * ntaps


@pytest.mark.parametrize("window", ["shallow", "random"])
def test_factors_decline_like_fxtpu(window):
    pytest.importorskip("jax")
    from fxtpu.ops.pfb_pallas import _svd_fir_factors
    if window == "shallow":
        w = _window(4, 512)
        assert 4 < SVD_FIR_MIN_TAPS
    else:   # full rank: nothing to gain
        w = np.random.default_rng(1).normal(size=(32, 256))
    nbins = w.shape[1]
    assert svd_fir_factors(w, nbins) is None
    assert _svd_fir_factors(tuple(w.ravel()), nbins) is None
    assert not deep_svd_applies(w, nbins)


@pytest.mark.parametrize("name", ["pfb32", "graded16", "random32"])
def test_deep_svd_applies_matches_fxtpu_at_each_tol(monkeypatch, name):
    """The route decision at the default tol and at 1e-7, where fxtpu
    reads its tolerance from FXTPU_SVD_TOL (set here for fxtpu alone; the
    port takes it as a keyword)."""
    pytest.importorskip("jax")
    from fxtpu.fx import _deep_svd_applies
    w = {"pfb32": _window(),
         "graded16": _graded_window(),
         "random32": np.random.default_rng(2).normal(size=(32, NBINS))}[name]
    monkeypatch.delenv("FXTPU_SVD_TOL", raising=False)
    assert deep_svd_applies(w, NBINS) == _deep_svd_applies(w, NBINS)
    monkeypatch.setenv("FXTPU_SVD_TOL", "1e-7")
    assert (deep_svd_applies(w, NBINS, tol=1e-7)
            == _deep_svd_applies(w, NBINS))
    want = {"pfb32": (True, True), "graded16": (True, False),
            "random32": (False, False)}[name]
    assert (deep_svd_applies(w, NBINS),
            deep_svd_applies(w, NBINS, tol=1e-7)) == want


def test_rank_follows_tol():
    u5, _, _ = svd_fir_factors(_window(), NBINS)
    u7, v7, _ = svd_fir_factors(_window(), NBINS, tol=1e-7)
    assert u5.shape[1] == 6 and u7.shape[1] == 8
    assert np.abs(u7 @ v7 - _window()).max() < 1e-7 * np.abs(_window()).max()


def test_svd_tensors_are_the_float32_windows_factors():
    w = _window()
    u, v = svd_tensors(w, "cpu")
    assert u.dtype == v.dtype == torch.float32
    fu, fv, _ = svd_fir_factors(w.astype(np.float32).astype(np.float64),
                                NBINS)
    np.testing.assert_array_equal(u.numpy(), fu.astype(np.float32))
    np.testing.assert_array_equal(v.numpy(), fv.astype(np.float32))
    assert svd_tensors(_window(4), "cpu") is None


def test_svd_fir_is_the_factorised_sum():
    """svd_fir computes sum_k v_k * (u_k conv x) literally; it agrees with
    the tap loop over the exact window to the dropped singular values."""
    rng = np.random.default_rng(4)
    xp = torch.from_numpy((rng.normal(size=(2, 40, NBINS))
                           + 1j * rng.normal(size=(2, 40, NBINS))
                           ).astype(np.complex64))
    w = _window()
    u, v = svd_tensors(w, "cpu")
    got = svd_fir(xp, u, v)
    want = pfb_fir(xp, torch.as_tensor(w.astype(np.float32)))
    assert got.shape == want.shape == (2, 40 - NTAPS + 1, NBINS)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 3e-5 * scale
    # term by term, in float64
    x64 = xp.numpy().astype(np.complex128)
    u64, v64 = u.numpy().astype(np.float64), v.numpy().astype(np.float64)
    s = 40 - NTAPS + 1
    c = np.stack([sum(u64[t, k] * x64[:, t:t + s] for t in range(NTAPS))
                  for k in range(u64.shape[1])])
    exact = np.einsum("kb,kcfb->cfb", v64, c)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0,
                               atol=1e-6 * np.abs(exact).max())


@pytest.mark.parametrize("nch,autos", [(2, False), (3, True)])
def test_reference_matches_fxtpu_svd_kernel(nch, autos):
    """The f32 SVD-FIR plain version against fxtpu's fused kernel at 32
    taps (its SVD-FIR mode) over 2 chained blocks from a fresh history."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import _svd_fir_factors, fx_pallas_raw
    w2d = _window().astype(np.float32)
    assert _svd_fir_factors(tuple(w2d.astype(np.float64).ravel()),
                            NBINS) is not None   # fxtpu takes its SVD mode
    pairs = baseline_pairs(nch, autos)
    pt = pairs_tensor(pairs, nch, "cpu")
    wt = torch.from_numpy(w2d)
    svd = svd_tensors(w2d, "cpu")
    z = jnp.zeros((nch, NTAPS - 1, NBINS), jnp.float32)
    hj = Cplx(z, z)
    ht = torch.zeros((nch, NTAPS - 1, NBINS), dtype=torch.complex64)
    for k, x in enumerate(_svd_blocks(nch, seed=40 + nch, k=2)):
        xj, hj = fx_pallas_raw(from_complex(x), jnp.asarray(w2d), NBINS, hj,
                               pairs)
        xt, ht = fx_fused_raw_reference(torch.from_numpy(x), ht, wt, pt, svd)
        want = to_complex(xj)
        np.testing.assert_allclose(xt.numpy(), want,
                                   atol=3e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


def test_svd_reference_matches_exact_window_reference():
    nch = 2
    w2d = _window().astype(np.float32)
    pt = pairs_tensor(baseline_pairs(nch, True), nch, "cpu")
    wt = torch.from_numpy(w2d)
    svd = svd_tensors(w2d, "cpu")
    hs = hd = torch.zeros((nch, NTAPS - 1, NBINS), dtype=torch.complex64)
    for x in _svd_blocks(nch, seed=50, k=3):
        xs, hs = fx_fused_raw_reference(torch.from_numpy(x), hs, wt, pt, svd)
        xd, hd = fx_fused_raw_reference(torch.from_numpy(x), hd, wt, pt)
        scale = xd.abs().max().item()
        assert (xs - xd).abs().max().item() <= 3e-5 * scale
        assert torch.equal(hs, hd)   # the history does not pass the FIR


def test_i8_reference_matches_fxtpu_int8_native_svd_kernel():
    """The int8 SVD-FIR plain version against fxtpu's int8-native fused
    kernel at 32 taps (its SVD-FIR branch) over 3 chained blocks from a
    fresh raw tail."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw
    from fxtpu.runtime.native import pack_planes_i8
    from fxtpu_torch.fx import _unpack_i8_words
    nch = 2
    w2d = _window().astype(np.float32)
    pairs = baseline_pairs(nch, False)
    pt = pairs_tensor(pairs, nch, "cpu")
    wt = torch.from_numpy(w2d)
    svd = svd_tensors(w2d, "cpu")
    z = jnp.zeros((nch, NTAPS - 1, NBINS // 4), jnp.int32)
    hj = {"tail": Cplx(z, z),
          "mu_prev": Cplx(jnp.zeros(nch, jnp.float32),
                          jnp.zeros(nch, jnp.float32))}
    ht = {"tail": torch.zeros((nch, NTAPS - 1, NBINS, 2), dtype=torch.int8),
          "mu_prev": torch.zeros((nch,), dtype=torch.complex64)}
    for k, b in enumerate(_i8_blocks(nch, seed=60, k=3)):
        re, im = pack_planes_i8(b.reshape(nch, -1, 2), NBINS)
        xj, hj = fx_pallas_raw(Cplx(jnp.asarray(re), jnp.asarray(im)),
                               jnp.asarray(w2d), NBINS, hj, pairs,
                               quant_step=STEP)
        xt, ht = fx_fused_raw_i8_reference(torch.from_numpy(b), ht, wt, pt,
                                           STEP, svd)
        want = to_complex(xj)
        np.testing.assert_allclose(xt.numpy(), want,
                                   atol=3e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        tail = np.stack([_unpack_i8_words(hj["tail"].re),
                         _unpack_i8_words(hj["tail"].im)], axis=-1)
        np.testing.assert_array_equal(ht["tail"].numpy(), tail)
        np.testing.assert_allclose(ht["mu_prev"].numpy(),
                                   to_complex(hj["mu_prev"]), atol=1e-7)


def test_wrappers_take_svd_plain_versions_on_cpu():
    nch = 2
    w2d = _window().astype(np.float32)
    pt = pairs_tensor(baseline_pairs(nch, False), nch, "cpu")
    wt = torch.from_numpy(w2d)
    svd = svd_tensors(w2d, "cpu")
    x = torch.from_numpy(_svd_blocks(nch, seed=70, k=1)[0])
    h = torch.zeros((nch, NTAPS - 1, NBINS), dtype=torch.complex64)
    b8 = torch.from_numpy(_i8_blocks(nch, seed=71, k=1)[0])
    h8 = {"tail": torch.zeros((nch, NTAPS - 1, NBINS, 2), dtype=torch.int8),
          "mu_prev": torch.zeros((nch,), dtype=torch.complex64)}
    counts = (fx_fused_raw.launches, fx_fused_raw.svd_launches,
              fx_fused_raw_i8.launches, fx_fused_raw_i8.svd_launches)
    got = fx_fused_raw(x, h, wt, pt, svd)
    want = fx_fused_raw_reference(x, h, wt, pt, svd)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got8 = fx_fused_raw_i8(b8, h8, wt, pt, STEP, svd)
    want8 = fx_fused_raw_i8_reference(b8, h8, wt, pt, STEP, svd)
    assert torch.equal(got8[0], want8[0])
    assert counts == (fx_fused_raw.launches, fx_fused_raw.svd_launches,
                      fx_fused_raw_i8.launches, fx_fused_raw_i8.svd_launches)
