"""Multi-block dispatch: K blocks per call of the fused step, against
fxtpu's fx_pallas_raw_multi(..., merged=True) and FxEngine.multi_step on
the CPU (its Pallas kernel in interpret mode), against K chained single
steps bit for bit, the engine's batch staging, and the CUDA kernels' K-block
launches against their plain versions and against K one-block launches.

Tolerances: xp within 2e-5*scale, fxtpu's fused-against-unfused bound
(tests/test_planes.py:318-321), 3e-5*scale at deep taps (the SVD-FIR mode,
:485); for 8-bit samples 3e-5 of scale, the bound the single-block int8
parity tests hold (tests/test_torch_fx_kernel.py:139; fxtpu's own 1e-5 at
tests/test_planes.py:576 holds its multi-block kernel against its single-
block one, the same post-hoc DC algebra on both sides), with the raw tail
bit-exact and mu_prev within 1e-7; histories within 1e-6. The engine's
visibilities within 2e-5*scale (3e-5 under int8, :558).

The JAX package is imported inside the tests that need it, so that the
card's tests run on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_multi.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.correlator import Correlator  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.ops import fx_fused  # noqa: E402
from fxtpu_torch.ops.fx_fused import (fx_fused_raw,  # noqa: E402
                                      fx_fused_raw_i8, fx_fused_raw_i8_multi,
                                      fx_fused_raw_i8_multi_reference,
                                      fx_fused_raw_i8_reference,
                                      fx_fused_raw_multi,
                                      fx_fused_raw_multi_reference,
                                      fx_fused_raw_reference, pairs_tensor,
                                      svd_tensors)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402
from fxtpu_torch.runtime.stager import Batch  # noqa: E402

NBINS, NSAMP, K = 256, 2**13, 3
STEP = 1.0 / 32
SMALL = dict(num_samp=NSAMP, nbins=NBINS, clamp_num_samp=False)


def _window(ntaps, nbins=NBINS, device="cpu"):
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    svd = svd_tensors(w2d, device) if ntaps >= 16 else None
    return w2d, torch.as_tensor(w2d, device=device), svd


def _c64_batch(nch, k, seed, s=NSAMP // NBINS, nbins=NBINS):
    """Merged ``[nch, k, s, nbins]`` complex64 samples with a small DC
    offset that differs per channel and block (so each block's own mean
    matters; small, since fxtpu's post-hoc DC bin cancels, ROADMAP.md
    B)."""
    rng = np.random.default_rng(seed)
    dc = ((0.04 - 0.03j) * np.arange(1, nch + 1)[:, None]
          * np.arange(1, k + 1)[None, :])
    x = (rng.normal(size=(nch, k, s, nbins))
         + 1j * rng.normal(size=(nch, k, s, nbins)) + dc[..., None, None])
    return x.astype(np.complex64)


def _i8_batch(nch, k, seed, s=NSAMP // NBINS, nbins=NBINS):
    """Merged int8 ``[nch, k, s, nbins, 2]``: noise of ~30 quant units and
    a DC offset of a few units per channel and block."""
    rng = np.random.default_rng(seed)
    dc = (np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None, None]
          * np.arange(1, k + 1)[None, :, None])
    x = 30 * rng.normal(size=(nch, k, s, nbins, 2)) + dc[:, :, None, None]
    return np.clip(np.rint(x), -127, 127).astype(np.int8)


def _fresh(nch, ntaps, int8, nbins=NBINS, device="cpu"):
    if int8:
        return {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                    dtype=torch.int8, device=device),
                "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                       device=device)}
    return torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


# --------------------------------------------------------------------------
# The plain versions against fxtpu's K-block kernel
# --------------------------------------------------------------------------
@pytest.mark.parametrize("ntaps", [4, 32])   # fxtpu: direct taps, SVD-FIR
def test_multi_reference_matches_fxtpu_multi_kernel(ntaps):
    """Two chained K-block calls from a fresh history."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw_multi
    nch = 2
    pairs = baseline_pairs(nch)
    w2d, wt, svd = _window(ntaps)
    assert (svd is not None) == (ntaps == 32)
    z = jnp.zeros((nch, ntaps - 1, NBINS), jnp.float32)
    hj, ht = Cplx(z, z), _fresh(nch, ntaps, False)
    tol = 2e-5 if svd is None else 3e-5
    for call in range(2):
        x = _c64_batch(nch, K, seed=10 * ntaps + call)
        xj, hj = fx_pallas_raw_multi(from_complex(x), jnp.asarray(w2d), NBINS,
                                     hj, pairs, merged=True)
        xt, ht = fx_fused_raw_multi_reference(torch.from_numpy(x), ht, wt,
                                              pairs_tensor(pairs, nch, "cpu"),
                                              svd)
        want = to_complex(xj)
        assert xt.shape == want.shape == (K, len(pairs), NBINS)
        np.testing.assert_allclose(xt.numpy(), want,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"call {call}")
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


@pytest.mark.parametrize("ntaps", [4, 32])
def test_i8_multi_reference_matches_fxtpu_multi_kernel(ntaps):
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw_multi
    from fxtpu.runtime.native import pack_planes_i8
    from fxtpu_torch.fx import _unpack_i8_words
    nch = 2
    pairs = baseline_pairs(nch)
    w2d, wt, svd = _window(ntaps)
    z = jnp.zeros((nch, ntaps - 1, NBINS // 4), jnp.int32)
    hj = {"tail": Cplx(z, z),
          "mu_prev": Cplx(jnp.zeros(nch, jnp.float32),
                          jnp.zeros(nch, jnp.float32))}
    ht = _fresh(nch, ntaps, True)
    for call in range(2):
        x = _i8_batch(nch, K, seed=20 * ntaps + call)
        re, im = pack_planes_i8(x.reshape(nch, K, -1, 2), NBINS)
        xj, hj = fx_pallas_raw_multi(Cplx(jnp.asarray(re), jnp.asarray(im)),
                                     jnp.asarray(w2d), NBINS, hj, pairs,
                                     quant_step=STEP, merged=True)
        xt, ht = fx_fused_raw_i8_multi_reference(
            torch.from_numpy(x), ht, wt, pairs_tensor(pairs, nch, "cpu"),
            STEP, svd)
        want = to_complex(xj)
        scale = np.abs(want).max()
        np.testing.assert_allclose(xt.numpy() / scale, want / scale,
                                   atol=3e-5, err_msg=f"call {call}")
        tail = np.stack([_unpack_i8_words(hj["tail"].re),
                         _unpack_i8_words(hj["tail"].im)], axis=-1)
        np.testing.assert_array_equal(ht["tail"].numpy(), tail)
        np.testing.assert_allclose(ht["mu_prev"].numpy(),
                                   to_complex(hj["mu_prev"]), atol=1e-7)


# --------------------------------------------------------------------------
# The engine's multi_step against fxtpu's, and against chained steps
# --------------------------------------------------------------------------
def _engine_blocks(int8, seed, k=K, nch=2):
    """K host blocks as the rings hold them: complex64 [nch, num_samp], or
    8-bit [nch, num_samp, 2]."""
    if int8:
        return list(_i8_batch(nch, k, seed).reshape(nch, k, -1, 2)
                    .swapaxes(0, 1))
    return list(_c64_batch(nch, k, seed).reshape(nch, k, -1).swapaxes(0, 1))


def _packed_delays(k, frequency, start=0.0):
    """Per-block delays of a sweep, packed: [k, nch=2, 2]."""
    d = np.stack([np.zeros(k), start + 1.1e-6 + 1e-7 * np.arange(k)], axis=1)
    return pack_delays(d, frequency)


@pytest.mark.parametrize("ingest,tol", [("complex64", 2e-5), ("int8", 3e-5)])
def test_engine_multi_step_matches_fxtpu(ingest, tol):
    """FxEngine(cfg, fused=True).multi_step against fxtpu's over two
    chained K-block calls with per-block delays: the first from fresh
    histories, the second from fxtpu's history handed over with
    import_fxtpu_state."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.ops.cplx import to_complex
    kw = dict(SMALL, mode="SPECTRUM", ingest_dtype=ingest, quant_step=STEP)
    jeng = JEngine(JConfig(**kw), fused=True)
    teng = FxEngine(CorrelatorConfig(**kw, device="cpu"), fused=True)
    assert jeng.batch_merged and teng.batch_merged
    assert teng.int8_native == jeng.int8_native == (ingest == "int8")
    int8 = ingest == "int8"
    jh, th = jeng.fresh_history(), teng.fresh_history()
    for call in range(2):
        blocks = _engine_blocks(int8, seed=31 + call)
        d = _packed_delays(K, jeng.cfg.frequency, start=K * 1e-7 * call)
        if call:
            th, _ = teng.import_fxtpu_state(jeng.window2d, jeng.pairs, jh,
                                            d[0])
        jv, jh = jeng.multi_step(jeng.prepare_batch(blocks), jnp.asarray(d),
                                 jh)
        tv, th = teng.multi_step(teng.prepare_batch(blocks),
                                 torch.from_numpy(d), th)
        want = to_complex(jv)
        assert tv.shape == want.shape == (K, 1, NBINS)
        np.testing.assert_allclose(tv.numpy(), want,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"call {call}")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("mode,ntaps", [("SPECTRUM", 4), ("CONTINUUM", 32)])
def test_multi_step_is_chained_steps_bit_for_bit(fused, ingest, mode, ntaps):
    cfg = CorrelatorConfig(**SMALL, mode=mode, ntaps=ntaps,
                           ingest_dtype=ingest,
                           quant_step=STEP, device="cpu")
    eng = FxEngine(cfg, fused=fused)
    assert eng.fused_active == fused
    if fused and ntaps == 32:
        assert eng.fir_mode == "svd"
    blocks = _engine_blocks(ingest == "int8", seed=41)
    d = torch.from_numpy(_packed_delays(K, cfg.frequency))
    vm, hm = eng.multi_step(eng.prepare_batch(blocks), d,
                            eng.fresh_history())
    h = eng.fresh_history()
    for k, b in enumerate(blocks):
        v, h = eng.step(eng.prepare_block(b), d[k], h)
        assert torch.equal(vm[k], v), f"block {k}"
    if isinstance(h, dict):
        assert torch.equal(hm["tail"], h["tail"])
        assert torch.equal(hm["mu_prev"], h["mu_prev"])
    else:
        assert torch.equal(hm, h)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_prepare_batch_layout_and_block_zero(fused, ingest):
    """The fused route stages the merged [nch, K, S, nbins(, 2)] layout,
    the plain route the [K, nch, num_samp(, 2)] stack; block j of either
    is prepare_block's input for block j, and block 0 of a staged batch
    calibrates as the block alone does."""
    cfg = CorrelatorConfig(**SMALL, mode="SPECTRUM", ingest_dtype=ingest,
                           quant_step=STEP, device="cpu", fused=fused)
    cor = Correlator(config=cfg)
    eng = cor.engine
    rng = np.random.default_rng(51)
    blocks = [(rng.normal(size=(2, NSAMP + 5)) + 1j * rng.normal(
        size=(2, NSAMP + 5))).astype(np.complex64) for _ in range(K)]
    blocks = [b[:, :NSAMP] for b in blocks]     # complex: quantized if int8
    iq = eng.prepare_batch(blocks)
    want_shape = ((2, K, NSAMP // NBINS, NBINS) if fused
                  else (K, 2, NSAMP))
    want_shape += (2,) if ingest == "int8" else ()
    assert tuple(iq.shape) == want_shape
    assert iq.dtype == (torch.int8 if ingest == "int8" else torch.complex64)
    for j, b in enumerate(blocks):
        got = iq[:, j] if fused else iq[j]
        assert torch.equal(got, eng.prepare_block(b))
    first = cor._first_staged_block(Batch(iq, K, stacked=True))
    assert torch.equal(first, eng.prepare_block(blocks[0]))
    assert torch.equal(eng.calibrate_block(first, 4096),
                       eng.calibrate_block(eng.prepare_block(blocks[0]),
                                           4096))
    cor.close()


@pytest.mark.parametrize("requested,k", [(0, 1), (1, 1), (2, 2), (8, 8)])
@pytest.mark.parametrize("fused", [False, True])
def test_dispatch_batch_for(requested, k, fused):
    eng = FxEngine(CorrelatorConfig(**SMALL, device="cpu"), fused=fused)
    assert eng.dispatch_batch_for(requested) == k


@pytest.mark.parametrize("fused,k", [(False, 64), (True, 51)])
def test_dispatch_batch_for_caps_k_at_the_launch_limit(fused, k, caplog,
                                                       tmp_path):
    """The largest K <= requested the engine takes (fxtpu's contract): a
    fused launch holds K blocks' partials, so 64 blocks of 4 channels
    with autos at 4096 bins (10 baselines, 20 MiB per block) become 51
    (fx_fused.max_blocks), and the Correlator says so when it is built,
    before any block runs."""
    cfg = CorrelatorConfig(nchan=4, include_autos=True, nbins=4096,
                           num_samp=2**18, fused=fused, device="cpu",
                           blocks_per_dispatch=64, buffer_chunks=2,
                           output_file=str(tmp_path / "k.csv"))
    with caplog.at_level("WARNING", logger="fxtpu_torch.correlator"):
        cor = Correlator(config=cfg)
    try:
        assert cor.engine.dispatch_batch_for(64) == cor._dispatch_batch == k
        assert cor.engine.dispatch_batch_for(k) == k
        assert ("51 blocks per call" in caplog.text) == fused
    finally:
        cor.close()


@pytest.mark.parametrize("s_rows,nbins,ntaps,nch,rank,nbl,most", [
    (512, 4096, 4, 2, 0, 3, 42),      # bench_pipeline with autos
    (512, 4096, 4, 2, 0, 1, 128),     # bench_pipeline
    (32, 256, 4, 2, 0, 1, 16384),     # the CPU shape
    (8, 8192, 32, 2, 6, 1, 2048),     # S < halo in the SVD mode
    (1, 8192, 2300, 2, 0, 1, 2240),   # the blocks' means fill shared memory
])
def test_max_blocks_is_the_launch_check(s_rows, nbins, ntaps, nch, rank,
                                        nbl, most):
    assert fx_fused.max_blocks(s_rows, nbins, ntaps, nch, rank,
                               nbl) == most
    fx_fused._check_blocks(most, s_rows, nbins, ntaps, nch, rank, nbl)
    with pytest.raises(ValueError, match=f"1 to {most} at this shape"):
        fx_fused._check_blocks(most + 1, s_rows, nbins, ntaps, nch, rank,
                               nbl)


def test_multi_wrappers_take_plain_versions_on_cpu():
    nch, ntaps = 2, 4
    pairs = pairs_tensor(baseline_pairs(nch), nch, "cpu")
    _, wt, _ = _window(ntaps)
    x = torch.from_numpy(_c64_batch(nch, K, seed=61))
    x8 = torch.from_numpy(_i8_batch(nch, K, seed=62))
    counts = (fx_fused_raw_multi.launches, fx_fused_raw_i8_multi.launches)
    got = fx_fused_raw_multi(x, _fresh(nch, ntaps, False), wt, pairs)
    want = fx_fused_raw_multi_reference(x, _fresh(nch, ntaps, False), wt,
                                        pairs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got8 = fx_fused_raw_i8_multi(x8, _fresh(nch, ntaps, True), wt, pairs,
                                 STEP)
    want8 = fx_fused_raw_i8_multi_reference(x8, _fresh(nch, ntaps, True), wt,
                                            pairs, STEP)
    assert torch.equal(got8[0], want8[0])
    assert torch.equal(got8[1]["tail"], x8[:, -1, -(ntaps - 1):])
    assert torch.equal(got8[1]["mu_prev"], want8[1]["mu_prev"])
    assert counts == (fx_fused_raw_multi.launches,
                      fx_fused_raw_i8_multi.launches)   # no kernel launched
    meta = torch.empty((nch, K, 32, NBINS), dtype=torch.complex64,
                       device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fx_fused_raw_multi(meta, meta[:, 0, :ntaps - 1], wt, pairs)


@pytest.mark.parametrize("k,s_rows,ntaps,blocks", [
    (1, 32, 4, 1),     # one block per launch: today's shared memory
    (3, 32, 4, 2),     # a block's first frames read the block before
    (3, 2, 4, 3),      # S < ntaps-1: a frame reads rows of 3 blocks
    (8, 2, 4, 3),
    (2, 31, 32, 2),    # S == ntaps-1 (the int8 floor)
    (8, 64, 1, 1),     # no halo (the spectrometer)
])
def test_mean_blocks(k, s_rows, ntaps, blocks):
    assert fx_fused.mean_blocks(k, s_rows, ntaps) == blocks
    assert (fx_fused.shared_bytes(NBINS, 2, ntaps, 0, blocks)
            == fx_fused.shared_bytes(NBINS, 2, ntaps) + 16 * (blocks - 1))


@pytest.mark.parametrize("k,s_rows,nbl,nbins,fits", [
    (8, 512, 1, 4096, True),      # bench_pipeline: 8 x 256 groups, 64 MiB
    (8, 512, 3, 4096, True),      # with autos: 192 MiB
    (2, 256, 1, 8192, True),      # the wideband shape at K = 2
    (64, 512, 3, 4096, False),    # 64 x 24 MiB of partials
])
def test_launch_partials_count_k(k, s_rows, nbl, nbins, fits):
    """A block is grouped as it is alone (bit for bit K one-block
    launches), so a K-block launch holds K blocks' partials: the launch
    check bounds them together."""
    n_groups, per = fx_fused._groups(s_rows, nbl, nbins)
    assert n_groups <= fx_fused.MAX_GROUPS and n_groups * per >= s_rows
    if fits:
        fx_fused._check_blocks(k, s_rows, nbins, 4, 2, 0, nbl)
    else:
        with pytest.raises(ValueError, match="partial cross power"):
            fx_fused._check_blocks(k, s_rows, nbins, 4, 2, 0, nbl)


# --------------------------------------------------------------------------
# The CUDA kernels' K-block launches
# --------------------------------------------------------------------------
def _close(got, want, tol):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("ingest,fir,nbins,s,ntaps,nch,autos,k", [
    ("complex64", "direct", 256, 32, 4, 2, False, 3),   # the CPU shape
    ("complex64", "direct", 256, 32, 4, 3, True, 3),    # autos
    ("complex64", "direct", 256, 2, 4, 2, False, 4),    # S < halo: 3 blocks
    ("complex64", "direct", 1024, 16, 4, 6, True, 3),   # 21 baselines
    ("complex64", "direct", 8192, 8, 4, 2, False, 2),   # odd stages (13)
    ("complex64", "direct", 256, 529, 4, 2, False, 2),  # ragged groups
    ("complex64", "svd", 256, 64, 32, 3, True, 3),
    ("complex64", "svd", 256, 8, 32, 2, False, 5),      # S < halo, SVD
    ("complex64", "svd", 8192, 40, 32, 2, False, 2),
    ("int8", "direct", 256, 32, 4, 2, False, 3),
    ("int8", "direct", 256, 3, 4, 3, True, 4),          # S == halo
    ("int8", "direct", 256, 529, 4, 2, False, 2),
    ("int8", "svd", 256, 64, 32, 3, True, 3),
    ("int8", "svd", 256, 31, 32, 2, False, 3),          # S == halo, SVD
])
def test_cuda_multi_kernel_matches_plain_and_single_launches(
        cuda_device, ingest, fir, nbins, s, ntaps, nch, autos, k):
    """Two chained K-block launches: xp within 2e-5*scale of the plain
    version, 3e-5*scale in the SVD mode (history within 1e-6; int8: tail
    exact, mu_prev within
    1e-6*max|mu|), and bit for bit the K one-block launches; each K-block
    launch counts once on its own wrapper, in its FIR mode."""
    int8 = ingest == "int8"
    multi = fx_fused_raw_i8_multi if int8 else fx_fused_raw_multi
    single = fx_fused_raw_i8 if int8 else fx_fused_raw
    ref = (fx_fused_raw_i8_multi_reference if int8
           else fx_fused_raw_multi_reference)
    _, wt, svd = _window(ntaps, nbins, cuda_device)
    if fir == "direct":
        svd = None
    assert (svd is not None) == (fir == "svd")
    pt = pairs_tensor(baseline_pairs(nch, autos), nch, cuda_device)
    arg = (STEP,) if int8 else ()
    hk = hr = hs = _fresh(nch, ntaps, int8, nbins, cuda_device)
    attr = "svd_launches" if svd is not None else "launches"
    before = getattr(multi, attr), getattr(single, attr)
    for call in range(2):
        make = _i8_batch if int8 else _c64_batch
        x = torch.as_tensor(make(nch, k, seed=70 + call, s=s, nbins=nbins),
                            device=cuda_device)
        xk, hk = multi(x, hk, wt, pt, *arg, svd)
        xr, hr = ref(x, hr, wt, pt, *arg, svd)
        xs = []
        for j in range(k):
            xj, hs = single(x[:, j].contiguous(), hs, wt, pt, *arg, svd)
            xs.append(xj)
        torch.cuda.synchronize()
        assert xk.shape == (k, len(pt), nbins)
        assert _close(xk, xr, 2e-5 if svd is None else 3e-5), f"call {call}"
        assert torch.equal(xk, torch.stack(xs)), f"call {call}"
        if int8:
            assert torch.equal(hk["tail"], hr["tail"])
            assert _close(hk["mu_prev"], hr["mu_prev"], 1e-6)
            assert torch.equal(hk["tail"], hs["tail"])
            assert torch.equal(hk["mu_prev"], hs["mu_prev"])
        else:
            assert (hk - hr).abs().max().item() <= 1e-6
            assert torch.equal(hk, hs)
    assert (getattr(multi, attr), getattr(single, attr)) == (
        before[0] + 2, before[1] + 2 * k)


@pytest.mark.cuda
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_cuda_one_block_multi_is_the_single_launch(cuda_device, ingest):
    int8 = ingest == "int8"
    _, wt, _ = _window(4, NBINS, cuda_device)
    pt = pairs_tensor(baseline_pairs(2), 2, cuda_device)
    h = _fresh(2, 4, int8, NBINS, cuda_device)
    if int8:
        x = torch.as_tensor(_i8_batch(2, 1, seed=81), device=cuda_device)
        xm, hm = fx_fused_raw_i8_multi(x, h, wt, pt, STEP)
        xs, hs = fx_fused_raw_i8(x[:, 0].contiguous(), h, wt, pt, STEP)
        assert torch.equal(hm["mu_prev"], hs["mu_prev"])
    else:
        x = torch.as_tensor(_c64_batch(2, 1, seed=82), device=cuda_device)
        xm, hm = fx_fused_raw_multi(x, h, wt, pt)
        xs, hs = fx_fused_raw(x[:, 0].contiguous(), h, wt, pt)
        assert torch.equal(hm, hs)
    assert torch.equal(xm[0], xs)


@pytest.mark.cuda
def test_cuda_multi_wrappers_reject_bad_input(cuda_device):
    _, wt, _ = _window(4, NBINS, cuda_device)
    pt = pairs_tensor(baseline_pairs(2), 2, cuda_device)
    x = torch.as_tensor(_c64_batch(2, K, seed=83), device=cuda_device)
    h = _fresh(2, 4, False, NBINS, cuda_device)
    with pytest.raises(ValueError, match=r"\[nch, K, S, nbins\]"):
        fx_fused_raw_multi(x[:, 0].contiguous(), h, wt, pt)
    with pytest.raises(ValueError, match="history"):
        fx_fused_raw_multi(x, h[:, :1].contiguous(), wt, pt)
    with pytest.raises(ValueError, match="contiguous"):
        fx_fused_raw_multi(x.transpose(0, 1).contiguous().transpose(0, 1),
                           h, wt, pt)
    x8 = torch.as_tensor(_i8_batch(2, K, seed=84), device=cuda_device)
    h8 = _fresh(2, 4, True, NBINS, cuda_device)
    with pytest.raises(ValueError, match=r"\[nch, K, S, nbins, 2\]"):
        fx_fused_raw_i8_multi(x8[:, 0].contiguous(), h8, wt, pt, STEP)
    with pytest.raises(ValueError, match="does not take"):
        fx_fused_raw_i8_multi(x8[:, :, :2].contiguous(), h8, wt, pt, STEP)
