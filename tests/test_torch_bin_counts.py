"""Every bin count of fxtpu's Pallas kernels in the port: ``_kernel_factor``
(``fxtpu/ops/pfb_pallas.py:75-81``) takes n = 128 m, 2 <= m <= 128, and
``fxtpu_torch.ops.fx_fused.kernel_bins`` is its copy.  The shape rules
take every such n and no other; the fused route of ``FxEngine`` (the
single pass's plain versions on the CPU, as on the card its kernels) at
counts that are not powers of two against ``fxtpu``'s (its Pallas kernel
in interpret mode, as ``tests/test_planes.py:1210-1233`` runs it), three
chained blocks, both ingests, the SVD-FIR mode, and blocks that are not a
whole number of frames.

Tolerances: ``fxtpu``'s own edge-shape sweep bound, 5e-5 * scale
(tests/test_planes.py:1233); the carried history within 1e-6 (int8: the
raw tail exactly, mu_prev within 1e-7)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

jnp = pytest.importorskip("jax.numpy")   # absent on the card's machine

from fxtpu.config import CorrelatorConfig as JConfig  # noqa: E402
from fxtpu.fx import FxEngine as JEngine  # noqa: E402
from fxtpu.ops.cplx import to_complex  # noqa: E402
from fxtpu.ops.planes import pack_delays  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine, _unpack_i8_words  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.spectrometer import supported_spectrometer  # noqa: E402

COUNTS = [128 * m for m in range(2, 129)]
REFUSED = [128, 1000, 16512]
TOL = 5e-5
STEP = 1.0 / 32


def test_kernel_bins_is_kernel_factor():
    from fxtpu.ops.pfb_pallas import _kernel_factor
    for n in range(1, 17000):
        assert ff.kernel_bins(n) is (_kernel_factor(n) is not None), n


def test_rules_take_every_count_and_no_other():
    """The single pass and the spectrometer take every n at 2 channels and
    4 taps (the shared route where the spectra fit, else the wide one);
    a count outside _kernel_factor's set is refused by every rule."""
    for n in COUNTS:
        assert ff.supported_parts(n, 4, 2, 3), n
        assert supported_spectrometer(n, 4, 2), n
        assert ff.x_route(n, 4, 2) == (
            "shared" if ff.supported(n, 4, 2) else "global")
    for n in REFUSED:
        assert not ff.supported_parts(n, 4, 2, 64)
        assert not ff.supported(n, 4, 2)
        assert not supported_spectrometer(n, 4, 2)


def test_sixteen_thousand_bins_take_the_wide_route():
    """At 16,384 bins a spectrum and a radix-2 work buffer (256 KiB) do not
    fit a CTA; the one-slot launch does (196.7 KB), and its footprint is
    the wide route's rule there, up to 64 channels and the SVD mode.  The
    wide route's scratch and groups are written against bytes: a block
    of 2^18 samples, 16 frames, takes up to 1 GiB of spectra a launch."""
    n = 16384
    assert ff.frame_shared_bytes(n, 2, one_slot=True) == (
        (n + n // 2 + 2) * 8)
    for nch in (1, 2, 8, 64):
        for ntaps, rank in ((4, 0), (32, 6)):
            assert ff.wide_route_bytes(n, nch, ntaps, rank) == \
                ff.frame_shared_bytes(n, nch, ff.PARTS_CHAN_SLOTS,
                                      one_slot=True) + ntaps * rank * 4
            assert ff.wide_route_bytes(n, nch, ntaps, rank) <= \
                ff.MAX_SHARED_BYTES
            assert ff.supported_parts(n, ntaps, nch, ntaps, rank)
            assert ff.x_route(n, ntaps, nch, rank) == "global"
    assert ff.max_blocks_parts(16, n, 2, 1) == (
        ff.MAX_LAUNCH_PARTIAL_BYTES // (2 * 16 * n * 8 + 16 * 2 * 16))
    # the plan of such a block (its shapes alone: meta tensors): one frame
    # a group, and the scratch and sums that max_blocks_parts counts
    meta = dict(device="meta")
    plan = ff.plan_parts(
        torch.empty((2, 1, 16, n), dtype=torch.complex64, **meta),
        torch.empty((2, 3, n), dtype=torch.complex64, **meta),
        torch.empty((4, n), **meta), ff.pairs_tensor([[0, 1]], 2, "meta"),
        None, (None, torch.empty((3, n), dtype=torch.complex64, **meta)))
    assert plan.route == "global" and (plan.n_groups, plan.per) == (16, 1)
    nbytes = {name: np.prod(shape) * dtype.itemsize
              for name, shape, dtype in plan.buffers}
    assert nbytes["scratch"] + nbytes["sums"] == 2 * 16 * n * 8 + 16 * 2 * 16


def _engines(nbins, ntaps, nsamp, nch, ingest):
    kw = dict(mode="SPECTRUM", nchan=nch, num_samp=nsamp, nbins=nbins,
              ntaps=ntaps, clamp_num_samp=False, ingest_dtype=ingest,
              quant_step=STEP)
    jeng = JEngine(JConfig(**kw), fused=True)
    teng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=True)
    assert jeng.fused_active and teng.fused_active
    assert not teng.kernel_active
    assert teng.int8_native == jeng.int8_native == (ingest == "int8")
    return jeng, teng


def _blocks(nch, nsamp, ingest, seed, k=3):
    """k blocks of noise with a small DC offset per channel (the single
    pass removes it after the fact, where it cancels at the DC bin)."""
    rng = np.random.default_rng(seed)
    grade = np.arange(1, nch + 1)[:, None]
    if ingest == "int8":
        dc = np.array([3.0, -2.0]) * grade[..., None]
        return [np.clip(np.rint(30 * rng.normal(size=(nch, nsamp, 2)) + dc),
                        -127, 127).astype(np.int8) for _ in range(k)]
    return [(rng.normal(size=(nch, nsamp)) + 1j * rng.normal(size=(nch, nsamp))
             + (0.02 - 0.01j) * grade).astype(np.complex64)
            for _ in range(k)]


def _chained(nbins, ntaps, nsamp, nch, ingest, seed, fir="direct"):
    """Both engines over 3 chained blocks from a fresh history, with
    packed delays that differ per block; rows within 5e-5 * scale, the
    history as the module docstring says."""
    jeng, teng = _engines(nbins, ntaps, nsamp, nch, ingest)
    assert teng.fir_mode == fir
    jh, th = jeng.fresh_history(), teng.fresh_history()
    for k, x in enumerate(_blocks(nch, nsamp, ingest, seed)):
        d = pack_delays(np.arange(nch) * (1.3e-6 + 1e-7 * k),
                        jeng.cfg.frequency)
        jv, jh = jeng.step(jeng.prepare_block(x), jnp.asarray(d), jh)
        tv, th = teng.step(teng.prepare_block(x), torch.from_numpy(d), th)
        want = to_complex(jv)
        assert tv.shape == want.shape and np.isfinite(tv.numpy()).all()
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=TOL * np.abs(want).max(),
                                   err_msg=f"block {k}")
        if ingest == "int8":
            tail = np.stack([_unpack_i8_words(jh["tail"].re),
                             _unpack_i8_words(jh["tail"].im)], axis=-1)
            np.testing.assert_array_equal(th["tail"].numpy(), tail)
            np.testing.assert_allclose(th["mu_prev"].numpy(),
                                       to_complex(jh["mu_prev"]), atol=1e-7)
        else:
            np.testing.assert_allclose(th.numpy(), to_complex(jh),
                                       atol=1e-6)
    return teng


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("nbins,ntaps,frames,nch", [
    (384, 3, 16, 2),      # 3 x 128: the shortest odd factor
    (640, 4, 16, 2),      # 5 x 128
    (1536, 4, 8, 3),      # 3 x 512, three channels
])
def test_fused_step_matches_fxtpu(nbins, ntaps, frames, nch, ingest):
    teng = _chained(nbins, ntaps, frames * nbins, nch, ingest,
                    seed=nbins + ntaps)
    assert teng.x_stage == "shared"


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_svd_step_matches_fxtpu(ingest):
    """16 taps at 768 bins: the window factorises, so both packages run
    the SVD-FIR mode."""
    from fxtpu.fx import _deep_svd_applies
    from fxtpu_torch.ops.window import pfb_window
    assert _deep_svd_applies(pfb_window(16, 768).reshape(16, 768), 768)
    _chained(768, 16, 32 * 768, 2, ingest, seed=71, fir="svd")


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_blocks_of_a_partial_frame_match_fxtpu(ingest):
    """16 frames and 128 samples a block: both packages frame num_samp //
    nbins rows and drop the rest, the means, the int8 tail and mu_prev
    over the framed samples alone."""
    nbins = 384
    teng = _chained(nbins, 4, 16 * nbins + 128, 2, ingest, seed=88)
    block = _blocks(2, 16 * nbins + 128, ingest, seed=1, k=1)[0]
    assert tuple(teng.prepare_block(block).shape[:3]) == (2, 16, nbins)
