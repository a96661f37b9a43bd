"""The fused FX step: fxtpu_torch.ops.fx_fused against the JAX package's
fused Pallas kernel, run here as fxtpu's own tests run it (interpret mode
on the CPU), and the CUDA kernels against their plain versions on a card.

Tolerance: fxtpu's fused-against-unfused bound, 2e-5*scale with history
within 1e-6 (tests/test_planes.py:318-321); for 8-bit samples fxtpu's
int8-native bound, 3e-5*scale (tests/test_planes.py:558), with the raw
tail bit-exact and mu_prev within 1e-7.  The SVD-FIR mode's parity with
fxtpu is in tests/test_torch_svd_fir.py; here its CUDA kernels are held
to their plain versions at the same 2e-5*scale as the direct mode.

The JAX package is imported inside the test that needs it, so that the
card's tests run on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_fx_kernel.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops import fx_fused  # noqa: E402
from fxtpu_torch.ops.fx_fused import (fx_fused_raw,  # noqa: E402
                                      fx_fused_raw_i8,
                                      fx_fused_raw_i8_reference,
                                      fx_fused_raw_reference, pairs_tensor,
                                      supported, supported_i8, svd_tensors)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

NBINS, NSAMP, NTAPS = 256, 2**13, 4


def _case(nch, autos, seed, device="cpu", nbins=NBINS, s=NSAMP // NBINS,
          ntaps=NTAPS):
    """Window, pairs and 2 blocks of framed samples with a small DC offset
    per channel: enough to exercise the mean removal, small enough that
    the JAX kernel's post-hoc DC correction (which cancels at the DC bin,
    docs/design.md) stays inside the tolerance."""
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    pairs = baseline_pairs(nch, autos)
    rng = np.random.default_rng(seed)
    blocks = [(rng.normal(size=(nch, s, nbins))
               + 1j * rng.normal(size=(nch, s, nbins))
               + (0.04 - 0.03j) * np.arange(1, nch + 1)[:, None, None]
               ).astype(np.complex64) for _ in range(2)]
    return (w2d, pairs, blocks,
            torch.as_tensor(w2d, device=device),
            pairs_tensor(pairs, nch, device))


def _case_i8(nch, autos, seed, device="cpu", nbins=NBINS, s=NSAMP // NBINS,
             ntaps=NTAPS, k=3):
    """Window, pairs and ``k`` blocks of 8-bit samples ``[nch, s, nbins,
    2]``: noise of ~30 quant units plus a DC offset of a few quant units
    per channel (fxtpu's post-hoc DC bin loses precision as the mean
    grows, ROADMAP.md B)."""
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    pairs = baseline_pairs(nch, autos)
    rng = np.random.default_rng(seed)
    dc = np.array([3.0, -2.0]) * np.arange(1, nch + 1)[:, None]
    blocks = [np.clip(np.rint(30 * rng.normal(size=(nch, s, nbins, 2))
                              + dc[:, None, None, :]), -127, 127
                      ).astype(np.int8) for _ in range(k)]
    return (w2d, pairs, blocks,
            torch.as_tensor(w2d, device=device),
            pairs_tensor(pairs, nch, device))


def _fresh_i8(nch, ntaps, nbins, device="cpu"):
    return {"tail": torch.zeros((nch, ntaps - 1, nbins, 2), dtype=torch.int8,
                                device=device),
            "mu_prev": torch.zeros((nch,), dtype=torch.complex64,
                                   device=device)}


STEP = 1.0 / 32


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("nch,autos,ntaps", [
    (2, False, NTAPS), (3, True, NTAPS),
    (2, False, 32),    # fxtpu's SVD-FIR mode against the port's direct loop
])
def test_reference_matches_fxtpu_fused_kernel(nch, autos, ntaps):
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw
    w2d, pairs, blocks, wt, pt = _case(nch, autos, seed=nch, ntaps=ntaps)
    hj = Cplx(jnp.zeros((nch, ntaps - 1, NBINS), jnp.float32),
              jnp.zeros((nch, ntaps - 1, NBINS), jnp.float32))
    ht = torch.zeros((nch, ntaps - 1, NBINS), dtype=torch.complex64)
    # fxtpu's deep-tap bound (tests/test_planes.py:485) at 32 taps
    tol = 2e-5 if ntaps < 16 else 3e-5
    for x in blocks:
        xj, hj = fx_pallas_raw(from_complex(x), jnp.asarray(w2d), NBINS, hj,
                               pairs)
        xt, ht = fx_fused_raw_reference(torch.from_numpy(x), ht, wt, pt)
        want = to_complex(xj)
        np.testing.assert_allclose(xt.numpy(), want,
                                   atol=tol * np.abs(want).max())
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


@pytest.mark.parametrize("ntaps", [4, 32])   # fxtpu: direct taps, SVD-FIR
def test_i8_reference_matches_fxtpu_int8_native_kernel(ntaps):
    """Three chained blocks from a fresh (all-zero, mu_prev = 0) tail:
    fxtpu's first dispatch and its carried tail are different code paths,
    so every block is checked (tests/test_planes.py:549-559)."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw
    from fxtpu.runtime.native import pack_planes_i8
    from fxtpu_torch.fx import _unpack_i8_words
    nch = 2
    w2d, pairs, blocks, wt, pt = _case_i8(nch, False, seed=ntaps,
                                          ntaps=ntaps)
    z = jnp.zeros((nch, ntaps - 1, NBINS // 4), jnp.int32)
    hj = {"tail": Cplx(z, z),
          "mu_prev": Cplx(jnp.zeros(nch, jnp.float32),
                          jnp.zeros(nch, jnp.float32))}
    ht = _fresh_i8(nch, ntaps, NBINS)
    for k, b in enumerate(blocks):
        re, im = pack_planes_i8(b.reshape(nch, -1, 2), NBINS)
        xj, hj = fx_pallas_raw(Cplx(jnp.asarray(re), jnp.asarray(im)),
                               jnp.asarray(w2d), NBINS, hj, pairs,
                               quant_step=STEP)
        xt, ht = fx_fused_raw_i8_reference(torch.from_numpy(b), ht, wt, pt,
                                           STEP)
        want = to_complex(xj)
        np.testing.assert_allclose(xt.numpy(), want,
                                   atol=3e-5 * np.abs(want).max(),
                                   err_msg=f"block {k}")
        tail = np.stack([_unpack_i8_words(hj["tail"].re),
                         _unpack_i8_words(hj["tail"].im)], axis=-1)
        np.testing.assert_array_equal(ht["tail"].numpy(), tail)
        np.testing.assert_allclose(ht["mu_prev"].numpy(),
                                   to_complex(hj["mu_prev"]), atol=1e-7)


def test_i8_wrapper_takes_plain_version_on_cpu():
    _, _, blocks, wt, pt = _case_i8(2, False, seed=5, k=1)
    x = torch.from_numpy(blocks[0])
    h = _fresh_i8(2, NTAPS, NBINS)
    before = fx_fused_raw_i8.launches
    got = fx_fused_raw_i8(x, h, wt, pt, STEP)
    want = fx_fused_raw_i8_reference(x, h, wt, pt, STEP)
    assert fx_fused_raw_i8.launches == before   # no kernel launched
    assert torch.equal(got[0], want[0])
    for key in ("tail", "mu_prev"):
        assert torch.equal(got[1][key], want[1][key])
    # the new tail is a copy of the block's last ntaps-1 rows
    assert torch.equal(got[1]["tail"], x[:, -(NTAPS - 1):])
    assert got[1]["tail"].data_ptr() != x.data_ptr()


def test_wrapper_takes_plain_version_on_cpu():
    _, _, blocks, wt, pt = _case(2, False, seed=5)
    x = torch.from_numpy(blocks[0])
    h = torch.zeros((2, NTAPS - 1, NBINS), dtype=torch.complex64)
    before = fx_fused_raw.launches
    got = fx_fused_raw(x, h, wt, pt)
    want = fx_fused_raw_reference(x, h, wt, pt)
    assert fx_fused_raw.launches == before   # no kernel launched
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_other_devices():
    _, _, blocks, _, _ = _case(2, False, seed=6)
    x = torch.empty((2, NSAMP // NBINS, NBINS), dtype=torch.complex64,
                    device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fx_fused_raw(x, x[:, :NTAPS - 1], x.real[0, :NTAPS], x.real)


@pytest.mark.parametrize("nbins,ntaps,nch,ok", [
    (256, 4, 2, True), (4096, 4, 2, True), (8192, 4, 2, True),
    (4096, 4, 6, True), (4096, 4, 7, False), (128, 4, 2, False),
    (16384, 4, 2, False), (384, 4, 2, True), (4096, 1, 2, False),
    (8192, 4, 3, False), (1000, 4, 2, False),
])
def test_supported_shapes(nbins, ntaps, nch, ok):
    assert supported(nbins, ntaps, nch) is ok
    assert (fx_fused.shared_route_bytes(nbins, nch)
            <= fx_fused.MAX_SHARED_BYTES) or not ok


@pytest.mark.parametrize("nbins,ntaps,nch,rank,ok", [
    (8192, 32, 2, 6, True),     # the wideband shape: u adds 768 B
    (8192, 32, 2, 16, True), (8192, 32, 2, 17, False), (256, 32, 2, 0, True),
    (8192, 32, 3, 6, False),    # three spectra at 8192 bins do not fit
    (4096, 32, 6, 6, True), (256, 16, 2, -1, False),
])
def test_supported_svd_shapes(nbins, ntaps, nch, rank, ok):
    assert supported(nbins, ntaps, nch, rank) is ok
    assert supported_i8(nbins, ntaps, nch, 64, rank) is ok
    assert (fx_fused.shared_route_bytes(nbins, nch, ntaps, rank)
            == fx_fused.shared_route_bytes(nbins, nch) + 4 * ntaps * rank)


@pytest.mark.parametrize("nbins,ntaps,nch,s_rows,ok", [
    (4096, 4, 2, 64, True), (256, 4, 2, 3, True), (256, 4, 2, 2, False),
    (256, 32, 2, 31, True), (256, 32, 2, 30, False), (4096, 4, 7, 64, False),
    (384, 4, 2, 64, True), (4096, 1, 2, 64, False), (16512, 4, 2, 64, False),
])
def test_supported_i8_shapes(nbins, ntaps, nch, s_rows, ok):
    assert supported_i8(nbins, ntaps, nch, s_rows) is ok


def test_groups_cover_every_frame():
    """The single pass's plan (its shapes alone: meta tensors) splits a
    block into groups that cover every frame, the shared route's partials
    within MAX_PARTIAL_BYTES: 32 channels with autos at 512 bins (592
    rows) reach that cap, 22 groups of 3 frames where the grid would take
    64 groups of one (8 channels of 8192 bins take the wide route)."""
    meta = dict(device="meta")
    for s_rows, nch, autos, nbins, capped in (
            (64, 2, False, 4096, False), (1024, 2, False, 256, False),
            (7, 2, True, 256, False), (64, 32, True, 512, True),
            (64, 8, True, 8192, False)):
        pt = fx_fused.pairs_tensor(baseline_pairs(nch, autos), nch, "meta")
        plan = fx_fused.plan_parts(
            torch.empty((nch, 1, s_rows, nbins), dtype=torch.complex64,
                        **meta),
            torch.empty((nch, 3, nbins), dtype=torch.complex64, **meta),
            torch.empty((4, nbins), **meta), pt, None,
            (None, torch.empty((3, nbins), dtype=torch.complex64, **meta)))
        n, per, rows = plan.n_groups, plan.per, plan.nbl + 2 * nch
        assert plan.route == ("global" if nch == 8 else "shared")
        assert (n - 1) * per < s_rows <= n * per
        # the cap, not the grid's MAX_GROUPS, sets the frames a group
        assert (per > -(-s_rows // min(s_rows, fx_fused.MAX_GROUPS))) == (
            capped)
        if plan.route == "shared":
            assert n * rows * nbins * 8 <= max(fx_fused.MAX_PARTIAL_BYTES,
                                               rows * nbins * 8)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,s,ntaps,nch,autos", [
    (256, 32, 4, 2, False),     # the CPU tests' shape
    (256, 32, 4, 3, True),      # autos, three channels
    (512, 64, 2, 2, False),     # odd stage count (9), two taps
    (2048, 16, 8, 3, True),     # odd stage count (11), deep direct taps
    (8192, 8, 4, 2, False),     # the largest nbins, odd stage count (13)
    (1024, 16, 4, 6, True),     # six channels, 21 baselines
    (256, 1024, 4, 2, False),   # 4 frames per CTA (the grid cap)
    (256, 529, 4, 2, False),    # ragged last frame group
])
def test_cuda_kernel_matches_plain_version(cuda_device, nbins, s, ntaps,
                                           nch, autos):
    _, _, blocks, wt, pt = _case(nch, autos, seed=9, device=cuda_device,
                                 nbins=nbins, s=s, ntaps=ntaps)
    hk = hr = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                          device=cuda_device)
    before = fx_fused_raw.launches
    for x_np in blocks:
        x = torch.as_tensor(x_np, device=cuda_device)
        xk, hk = fx_fused_raw(x, hk, wt, pt)
        xr, hr = fx_fused_raw_reference(x, hr, wt, pt)
        torch.cuda.synchronize()
        scale = xr.abs().max().item()
        assert (xk - xr).abs().max().item() <= 2e-5 * scale
        assert (hk - hr).abs().max().item() <= 1e-6
    assert fx_fused_raw.launches == before + len(blocks)


@pytest.mark.cuda
def test_cuda_kernel_is_repeatable(cuda_device):
    """No atomics: the same input gives bit-identical output."""
    _, _, blocks, wt, pt = _case(2, False, seed=10, device=cuda_device)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = torch.zeros((2, NTAPS - 1, NBINS), dtype=torch.complex64,
                    device=cuda_device)
    a, b = fx_fused_raw(x, h, wt, pt), fx_fused_raw(x, h, wt, pt)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_input(cuda_device):
    _, _, blocks, wt, pt = _case(2, False, seed=11, device=cuda_device)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = torch.zeros((2, NTAPS - 1, NBINS), dtype=torch.complex64,
                    device=cuda_device)
    with pytest.raises(ValueError, match="history"):
        fx_fused_raw(x, h[:, :1], wt, pt)
    with pytest.raises(ValueError, match="contiguous"):
        fx_fused_raw(x.transpose(1, 2).contiguous().transpose(1, 2), h,
                     wt, pt)
    with pytest.raises(ValueError, match="is on"):
        fx_fused_raw(x, h, wt.cpu(), pt)
    with pytest.raises(TypeError):
        fx_fused_raw(x.to(torch.complex128), h, wt, pt)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,s,ntaps,nch,autos", [
    (256, 32, 4, 2, False),     # the CPU tests' shape
    (512, 64, 2, 2, False),     # odd stage count (9), two taps
    (2048, 16, 8, 3, True),     # odd stage count (11), deep direct taps
    (8192, 8, 4, 2, False),     # the largest nbins, odd stage count (13)
    (1024, 16, 4, 6, True),     # six channels, 21 baselines
    (256, 529, 4, 2, False),    # ragged last frame group
    (256, 3, 4, 2, False),      # S == ntaps-1: the whole block is the tail
])
def test_cuda_i8_kernel_matches_plain_version(cuda_device, nbins, s, ntaps,
                                              nch, autos):
    """Three chained blocks from a fresh tail: xp within 2e-5*scale of the
    plain version, the raw tail exact, mu_prev within 1e-6*max|mu|."""
    _, _, blocks, wt, pt = _case_i8(nch, autos, seed=12, device=cuda_device,
                                    nbins=nbins, s=s, ntaps=ntaps)
    hk = hr = _fresh_i8(nch, ntaps, nbins, cuda_device)
    before = fx_fused_raw_i8.launches
    for x_np in blocks:
        x = torch.as_tensor(x_np, device=cuda_device)
        xk, hk = fx_fused_raw_i8(x, hk, wt, pt, STEP)
        xr, hr = fx_fused_raw_i8_reference(x, hr, wt, pt, STEP)
        torch.cuda.synchronize()
        scale = xr.abs().max().item()
        assert (xk - xr).abs().max().item() <= 2e-5 * scale
        assert torch.equal(hk["tail"], hr["tail"])
        mu_scale = hr["mu_prev"].abs().max().item()
        assert ((hk["mu_prev"] - hr["mu_prev"]).abs().max().item()
                <= 1e-6 * mu_scale)
    assert fx_fused_raw_i8.launches == before + len(blocks)


@pytest.mark.cuda
def test_cuda_i8_kernel_is_repeatable(cuda_device):
    """Integer means and no atomics: the same input gives bit-identical
    output."""
    _, _, blocks, wt, pt = _case_i8(2, False, seed=13, device=cuda_device,
                                    k=1)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = _fresh_i8(2, NTAPS, NBINS, cuda_device)
    a = fx_fused_raw_i8(x, h, wt, pt, STEP)
    b = fx_fused_raw_i8(x, h, wt, pt, STEP)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1]["mu_prev"], b[1]["mu_prev"])


@pytest.mark.cuda
def test_cuda_i8_wrapper_rejects_bad_input(cuda_device):
    _, _, blocks, wt, pt = _case_i8(2, False, seed=14, device=cuda_device,
                                    k=1)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = _fresh_i8(2, NTAPS, NBINS, cuda_device)
    with pytest.raises(ValueError, match="tail"):
        fx_fused_raw_i8(x, dict(h, tail=h["tail"][:, :1].contiguous()), wt,
                        pt, STEP)
    with pytest.raises(ValueError, match="does not take"):
        fx_fused_raw_i8(x[:, :2].contiguous(), h, wt, pt, STEP)  # S < halo
    with pytest.raises(ValueError, match="even address"):
        flat = torch.zeros(x.numel() + 1, dtype=torch.int8,
                           device=cuda_device)
        fx_fused_raw_i8(flat[1:].view(x.shape), h, wt, pt, STEP)
    with pytest.raises(ValueError, match="is on"):
        fx_fused_raw_i8(x, h, wt.cpu(), pt, STEP)
    with pytest.raises(ValueError, match="quant_step"):
        fx_fused_raw_i8(x, h, wt, pt, 0.0)
    with pytest.raises(TypeError):
        fx_fused_raw_i8(x.to(torch.int16), h, wt, pt, STEP)
    with pytest.raises(TypeError):
        fx_fused_raw_i8(x, h["tail"], wt, pt, STEP)


def _svd_case(nbins, ntaps, device):
    svd = svd_tensors(pfb_window(ntaps, nbins).reshape(ntaps, nbins), device)
    assert svd is not None and svd[0].shape[1] <= fx_fused.MAX_SVD_RANK
    return svd


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,s,ntaps,nch,autos", [
    (256, 64, 32, 3, True),     # autos, three channels
    (512, 64, 16, 2, False),    # the fewest taps that factorise, odd stages
    (2048, 48, 32, 3, True),    # odd stage count (11)
    (8192, 40, 32, 2, False),   # the wideband bins, odd stage count (13)
    (256, 529, 32, 2, False),   # ragged last frame group
])
def test_cuda_svd_kernel_matches_plain_version(cuda_device, nbins, s, ntaps,
                                               nch, autos):
    """Three chained blocks: xp within 2e-5*scale of the SVD-FIR plain
    version, history within 1e-6; only the SVD mode's count moves."""
    _, _, blocks, wt, pt = _case(nch, autos, seed=15, device=cuda_device,
                                 nbins=nbins, s=s, ntaps=ntaps)
    svd = _svd_case(nbins, ntaps, cuda_device)
    hk = hr = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                          device=cuda_device)
    before = (fx_fused_raw.launches, fx_fused_raw.svd_launches)
    for x_np in blocks + blocks[:1]:
        x = torch.as_tensor(x_np, device=cuda_device)
        xk, hk = fx_fused_raw(x, hk, wt, pt, svd)
        xr, hr = fx_fused_raw_reference(x, hr, wt, pt, svd)
        torch.cuda.synchronize()
        scale = xr.abs().max().item()
        assert (xk - xr).abs().max().item() <= 2e-5 * scale
        assert (hk - hr).abs().max().item() <= 1e-6
    assert (fx_fused_raw.launches, fx_fused_raw.svd_launches) == (
        before[0], before[1] + 3)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,s,ntaps,nch,autos", [
    (256, 64, 32, 3, True),
    (512, 64, 16, 2, False),
    (8192, 40, 32, 2, False),
    (256, 31, 32, 2, False),    # S == ntaps-1: the whole block is the tail
])
def test_cuda_i8_svd_kernel_matches_plain_version(cuda_device, nbins, s,
                                                  ntaps, nch, autos):
    """Three chained blocks from a fresh tail: xp within 2e-5*scale of the
    SVD-FIR plain version, the raw tail exact, mu_prev within
    1e-6*max|mu|."""
    _, _, blocks, wt, pt = _case_i8(nch, autos, seed=16, device=cuda_device,
                                    nbins=nbins, s=s, ntaps=ntaps)
    svd = _svd_case(nbins, ntaps, cuda_device)
    hk = hr = _fresh_i8(nch, ntaps, nbins, cuda_device)
    before = (fx_fused_raw_i8.launches, fx_fused_raw_i8.svd_launches)
    for x_np in blocks:
        x = torch.as_tensor(x_np, device=cuda_device)
        xk, hk = fx_fused_raw_i8(x, hk, wt, pt, STEP, svd)
        xr, hr = fx_fused_raw_i8_reference(x, hr, wt, pt, STEP, svd)
        torch.cuda.synchronize()
        scale = xr.abs().max().item()
        assert (xk - xr).abs().max().item() <= 2e-5 * scale
        assert torch.equal(hk["tail"], hr["tail"])
        mu_scale = hr["mu_prev"].abs().max().item()
        assert ((hk["mu_prev"] - hr["mu_prev"]).abs().max().item()
                <= 1e-6 * mu_scale)
    assert (fx_fused_raw_i8.launches, fx_fused_raw_i8.svd_launches) == (
        before[0], before[1] + len(blocks))


@pytest.mark.cuda
def test_cuda_svd_kernels_are_repeatable(cuda_device):
    _, _, blocks, wt, pt = _case(2, False, seed=17, device=cuda_device,
                                 s=64, ntaps=32)
    svd = _svd_case(NBINS, 32, cuda_device)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = torch.zeros((2, 31, NBINS), dtype=torch.complex64, device=cuda_device)
    a, b = fx_fused_raw(x, h, wt, pt, svd), fx_fused_raw(x, h, wt, pt, svd)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    _, _, blocks8, _, _ = _case_i8(2, False, seed=18, device=cuda_device,
                                   s=64, ntaps=32, k=1)
    x8 = torch.as_tensor(blocks8[0], device=cuda_device)
    h8 = _fresh_i8(2, 32, NBINS, cuda_device)
    a = fx_fused_raw_i8(x8, h8, wt, pt, STEP, svd)
    b = fx_fused_raw_i8(x8, h8, wt, pt, STEP, svd)
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1]["mu_prev"], b[1]["mu_prev"])


@pytest.mark.cuda
def test_cuda_svd_wrappers_reject_bad_factors(cuda_device):
    _, _, blocks, wt, pt = _case(2, False, seed=19, device=cuda_device,
                                 s=64, ntaps=32)
    u, v = _svd_case(NBINS, 32, cuda_device)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = torch.zeros((2, 31, NBINS), dtype=torch.complex64, device=cuda_device)
    _, _, blocks8, _, _ = _case_i8(2, False, seed=20, device=cuda_device,
                                   s=64, ntaps=32, k=1)
    x8 = torch.as_tensor(blocks8[0], device=cuda_device)
    h8 = _fresh_i8(2, 32, NBINS, cuda_device)
    big = (torch.zeros((32, 17), device=cuda_device),
           torch.zeros((17, NBINS), device=cuda_device))
    calls = (lambda svd: fx_fused_raw(x, h, wt, pt, svd),
             lambda svd: fx_fused_raw_i8(x8, h8, wt, pt, STEP, svd))
    for call in calls:
        with pytest.raises(ValueError, match="rank 17"):
            call(big)
        with pytest.raises(ValueError, match="svd factors"):
            call((u[:-1].contiguous(), v))
        with pytest.raises(ValueError, match="svd factors"):
            call((u, v[:, :-1].contiguous()))
        with pytest.raises(ValueError, match="is on"):
            call((u.cpu(), v))
        with pytest.raises(TypeError):
            call((u.double(), v))


# --- the stage ablation (every stage: tests/test_torch_probes.py) ---------

@pytest.mark.parametrize("nch,autos", [(2, False), (3, True)])
def test_ablate_full_is_the_reference_step(nch, autos):
    """Stage ``full`` of the ablation over one block is
    fx_fused_raw_reference, exactly; a truncated stage is not."""
    _, _, blocks, wt, pt = _case(nch, autos, seed=40 + nch)
    x = torch.from_numpy(blocks[0])
    h = torch.from_numpy(blocks[1][:, :NTAPS - 1].copy())
    want, _ = fx_fused_raw_reference(x, h, wt, pt)
    got = fx_fused.fx_fused_ablate(x[:, None], h, wt, pt, "full")
    assert torch.equal(got[0], want)
    fir = fx_fused.fx_fused_ablate(x[:, None], h, wt, pt, "fir")
    assert fir.shape == got.shape and not torch.allclose(fir, got)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,s,ntaps", [(256, 32, 4), (512, 16, 2),
                                           (8192, 8, 4)])
def test_cuda_ablate_full_is_the_one_block_launch(nbins, s, ntaps,
                                                  cuda_device):
    """The ablation's ``full`` stage launches the production
    instantiation: its output is the one-block wrapper's, bit for bit."""
    _, _, blocks, wt, pt = _case(2, False, seed=50, device=cuda_device,
                                 nbins=nbins, s=s, ntaps=ntaps)
    x = torch.as_tensor(blocks[0], device=cuda_device)
    h = torch.zeros((2, ntaps - 1, nbins), dtype=torch.complex64,
                    device=cuda_device)
    want, _ = fx_fused_raw(x, h, wt, pt)
    got = fx_fused.fx_fused_ablate(x[:, None].contiguous(), h, wt, pt, "full")
    assert torch.equal(got[0], want)


# --- the single pass: parts, epilogue, step (parity with fxtpu's
# fx_pallas_parts: tests/test_torch_dc_posthoc.py) --------------------------

def _parts_inputs(nch, autos, k, s, nbins, ntaps, int8, fir, device, seed):
    """The merged blocks (a DC offset that differs per channel and block),
    a random history, window, pairs, FIR factors and DC constants."""
    from fxtpu_torch.ops.dc_posthoc import dc_constants
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    rng = np.random.default_rng(seed)
    grade = np.arange(1, nch + 1)[:, None] + 0.5 * np.arange(k)[None, :]
    if int8:
        dc = np.array([3.0, -2.0]) * grade[..., None, None, None]
        x = np.clip(np.rint(30 * rng.normal(size=(nch, k, s, nbins, 2)) + dc),
                    -127, 127).astype(np.int8)
        hist = np.clip(np.rint(30 * rng.normal(
            size=(nch, ntaps - 1, nbins, 2))), -127, 127).astype(np.int8)
    else:
        x = (rng.normal(size=(nch, k, s, nbins))
             + 1j * rng.normal(size=(nch, k, s, nbins))
             + (0.04 - 0.03j) * grade[..., None, None]).astype(np.complex64)
        hist = (rng.normal(size=(nch, ntaps - 1, nbins)) + 1j * rng.normal(
            size=(nch, ntaps - 1, nbins))).astype(np.complex64)
    svd = svd_tensors(w2d, device) if fir == "svd" else None
    assert (svd is not None) == (fir == "svd")
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(hist, device=device),
            torch.as_tensor(w2d, device=device),
            pairs_tensor(baseline_pairs(nch, autos), nch, device), svd,
            dc_constants(w2d, nbins, s, device))


def _assert_parts_close(got, want, tol):
    """xp and T off the DC bin and at it, each on its own scale (the raw DC
    bin towers above the rest); GJ on one scale; mu and the tail 1e-6
    (8-bit: mu 1e-6 of max|mu|, the raw tail exact)."""
    for name, g, r in zip(("xp", "T"), got, want):
        assert g.shape == r.shape
        for sl in (slice(1, None), slice(0, 1)):
            err = (g[..., sl] - r[..., sl]).abs().max().item()
            assert err <= tol * r[..., sl].abs().max().item(), (name, sl)
    assert (got[2] - want[2]).abs().max() <= tol * want[2].abs().max()
    assert (got[3] - want[3]).abs().max() <= 1e-6 * max(
        1.0, want[3].abs().max().item())
    if got[4].dtype == torch.int8:
        assert torch.equal(got[4], want[4])
    else:
        assert (got[4] - want[4]).abs().max() <= 1e-6


PARTS_SHAPES = [
    # nbins, s, ntaps, nch, autos, k, fir
    (256, 32, 4, 2, False, 1, "direct"),    # the CPU tests' shape
    (256, 32, 4, 3, True, 3, "direct"),     # autos, three blocks
    (512, 64, 2, 2, False, 2, "direct"),    # odd stage count, one halo frame
    (256, 1024, 4, 2, False, 2, "direct"),  # 4 frames per CTA: halo frames
                                            # share a CTA with a later one
    (256, 529, 4, 2, False, 1, "direct"),   # ragged last frame group
    (256, 3, 4, 2, False, 3, "direct"),     # S == ntaps-1: every frame halo
    (1024, 16, 4, 6, True, 2, "direct"),    # six channels, 21 baselines
    (256, 64, 32, 3, True, 3, "svd"),       # deep taps, the SVD-FIR mode
    (256, 31, 32, 2, False, 2, "direct"),   # S == ntaps-1 at deep taps
    (8192, 32, 32, 2, False, 2, "svd"),     # the CLI's deep-tap block
]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nbins,s,ntaps,nch,autos,k,fir", PARTS_SHAPES)
def test_cuda_parts_kernel_matches_plain_version(cuda_device, nbins, s, ntaps,
                                                 nch, autos, k, fir, int8):
    from fxtpu_torch.ops.fx_fused import (fx_fused_parts, fx_fused_parts_i8,
                                          fx_fused_parts_i8_reference,
                                          fx_fused_parts_reference)
    x, hist, wt, pt, svd, consts = _parts_inputs(
        nch, autos, k, s, nbins, ntaps, int8, fir, cuda_device, seed=60)
    fn, ref, arg = ((fx_fused_parts_i8, fx_fused_parts_i8_reference, (STEP,))
                    if int8 else
                    (fx_fused_parts, fx_fused_parts_reference, ()))
    before = (fn.launches, fn.svd_launches)
    got = fn(x, hist, wt, pt, *arg, svd, consts)
    want = ref(x, hist, wt, pt, *arg, svd, consts)
    torch.cuda.synchronize()
    assert (fn.launches, fn.svd_launches) == (
        before[0] + (fir == "direct"), before[1] + (fir == "svd"))
    _assert_parts_close(got, want, 3e-5 if (int8 or ntaps >= 16) else 2e-5)
    again = fn(x, hist, wt, pt, *arg, svd, consts)   # no atomics
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("continuum", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("int8,k,nbins", [(False, 1, 256), (False, 3, 256),
                                          (True, 3, 256), (True, 8, 4096)])
def test_cuda_fx_finish_matches_plain_version(cuda_device, int8, k, nbins,
                                              packed, continuum):
    """The epilogue kernel against dc_correct + finish on the same parts:
    every bin within 1e-6 of max|vis| plus 2e-6 of the raw cross power per
    frame that the correction cancels at that bin (at the DC bin |mu|^2
    |Abar(0)|^2; the continuum value takes the bins' mean of it)."""
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops.fx_fused import fx_fused_parts, fx_fused_parts_i8
    from fxtpu_torch.ops.xengine import pack_delays
    nch, s, bw, freq = 3, 32, 2.4e6, 1.4204e9
    x, hist, wt, pt, _, consts = _parts_inputs(
        nch, True, k, s, nbins, 4, int8, "direct", cuda_device, seed=61)
    if int8:
        parts = fx_fused_parts_i8(x, hist, wt, pt, STEP, None, consts)
        mu_prev = torch.tensor([0.05 - 0.02j, -0.03j, 0.01 + 0j],
                               dtype=torch.complex64, device=cuda_device)
    else:
        parts, mu_prev = fx_fused_parts(x, hist, wt, pt, None, consts), None
    tables = fe.FinishTables(baseline_pairs(nch, True), nbins, bw, freq,
                             cuda_device)
    d = np.tile([0.0, 2e-6, -1.3e-6], (k, 1)) + 1e-7 * np.arange(k)[:, None]
    delays = torch.as_tensor(
        pack_delays(d, freq) if packed else d.astype(np.float32),
        device=cuda_device)
    before = fe.fx_finish.launches
    got = fe.fx_finish(*parts[:4], pt, consts, delays, tables, s, bw,
                       continuum, mu_prev)
    want = fe.fx_finish_reference(*parts[:4], pt, consts, delays, tables, s,
                                  bw, continuum, mu_prev)
    torch.cuda.synchronize()
    assert fe.fx_finish.launches == before + 1
    assert got.shape == want.shape == ((k, 6) if continuum
                                       else (k, 6, nbins))
    scale = want.abs().max().item()
    raw = parts[0].abs() / s
    err = (got - want).abs()
    if continuum:
        assert bool((err <= 1e-6 * scale + 2e-6 * raw.mean(dim=-1) / bw
                     ).all())
    else:
        assert bool((err <= 1e-6 * scale + 2e-6 * torch.fft.fftshift(
            raw, dim=-1)).all())


@pytest.mark.cuda
def test_cuda_parts_wrappers_reject_bad_input(cuda_device):
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops.fx_fused import fx_fused_parts, fx_fused_parts_i8
    x, hist, wt, pt, _, consts = _parts_inputs(
        2, False, 2, 32, NBINS, NTAPS, False, "direct", cuda_device, seed=62)
    with pytest.raises(ValueError, match="history"):
        fx_fused_parts(x, hist[:, :1], wt, pt, None, consts)
    with pytest.raises(ValueError, match="supported_parts"):
        fx_fused_parts(x[:, :, :2].contiguous(), hist, wt, pt, None, consts)
    with pytest.raises(ValueError, match="dc_constants"):
        fx_fused_parts(x, hist, wt, pt, None,
                       tuple(c.cpu() for c in consts))
    with pytest.raises(ValueError, match="framed"):
        fx_fused_parts(x[:, 0], hist, wt, pt, None, consts)
    x8, h8, _, _, _, _ = _parts_inputs(
        2, False, 2, 32, NBINS, NTAPS, True, "direct", cuda_device, seed=63)
    with pytest.raises(ValueError, match="quant_step"):
        fx_fused_parts_i8(x8, h8, wt, pt, 0.0, None, consts)
    with pytest.raises(TypeError):
        fx_fused_parts_i8(x8, hist, wt, pt, STEP, None, consts)
    parts = fx_fused_parts(x, hist, wt, pt, None, consts)
    tables = fe.FinishTables(baseline_pairs(2), NBINS, 2.4e6, 1.4e9,
                             cuda_device)
    d = torch.zeros((2, 2), device=cuda_device)
    with pytest.raises(ValueError, match="delays"):
        fe.fx_finish(*parts[:4], pt, consts, d[:1], tables, 32, 2.4e6, False)
    with pytest.raises(ValueError, match="contiguous rows"):
        fe.fx_finish(parts[0][..., ::2], *parts[1:4], pt, consts, d, tables,
                     32, 2.4e6, False)
    with pytest.raises(ValueError, match="is on"):
        fe.fx_finish(*parts[:3], parts[3].cpu(), pt, consts, d, tables, 32,
                     2.4e6, False)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["SPECTRUM", "CONTINUUM"])
@pytest.mark.parametrize("ingest,ntaps", [("complex64", 4), ("int8", 4),
                                          ("complex64", 32), ("int8", 32)])
def test_cuda_engine_step_is_the_single_pass(cuda_device, ingest, ntaps,
                                             mode):
    """FxEngine.step on the card: the single pass (its frame kernel and
    reduce; at deep taps its FIR launch) and the epilogue launch once a
    block each, the two-pass wrappers not at all, and three
    chained steps agree with the plain route within 2e-5 of max|vis| (3e-5
    for 8-bit samples and at deep taps)."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    from fxtpu_torch.ops.xengine import pack_delays
    cfg = CorrelatorConfig(num_samp=2**14, nbins=NBINS, ntaps=ntaps,
                           clamp_num_samp=False, mode=mode,
                           ingest_dtype=ingest, quant_step=STEP,
                           device="cuda")
    one, plain = FxEngine(cfg), FxEngine(cfg, fused=False)
    assert one.kernel_active and not plain.fused_active
    rng = np.random.default_rng(64)
    d = torch.as_tensor(pack_delays([0.0, 2e-6], cfg.frequency),
                        device=cuda_device)
    h1, h2 = one.fresh_history(), plain.fresh_history()
    before = one.launch_counts()

    def two_pass_counts():
        return [fn.launches + fn.svd_launches for fn in (
            fx_fused_raw, fx_fused_raw_i8, fx_fused.fx_fused_raw_multi,
            fx_fused.fx_fused_raw_i8_multi)]

    old = two_pass_counts()
    tol = 3e-5 if (ingest == "int8" or ntaps >= 16) else 2e-5
    for k in range(3):
        blk = (rng.normal(size=(2, 2**14, 2)) @ np.array([1.0, 1j])
               + (0.03 - 0.02j)).astype(np.complex64)
        v1, h1 = one.step(one.prepare_block(blk), d, h1)
        v2, h2 = plain.step(plain.prepare_block(blk), d, h2)
        assert v1.shape == v2.shape
        assert (v1 - v2).abs().max() <= tol * v2.abs().max(), f"block {k}"
    after = one.launch_counts()
    assert [after[n] - before[n] for n in after] == [3] * len(after)
    assert list(after)[1:] == ["parts_reduce", *(["fir_rows"] if ntaps >= 16
                                                 else []), "fx_finish"]
    assert two_pass_counts() == old


def test_fx_finish_takes_plain_version_on_cpu():
    from fxtpu_torch.ops import fx_epilogue as fe
    from fxtpu_torch.ops.dc_posthoc import block_mu_prev, dc_correct
    from fxtpu_torch.ops.fx_fused import fx_fused_parts_reference
    x, hist, wt, pt, _, consts = _parts_inputs(
        2, True, 3, 32, NBINS, NTAPS, False, "direct", "cpu", seed=65)
    parts = fx_fused_parts_reference(x, hist, wt, pt, None, consts)
    tables = fe.FinishTables(baseline_pairs(2, True), NBINS, 2.4e6, 1.4e9,
                             "cpu")
    d = torch.tensor([[0.0, 1e-10]] * 3)
    before = fe.fx_finish.launches
    got = fe.fx_finish(*parts[:4], pt, consts, d, tables, 32, 2.4e6, False)
    assert fe.fx_finish.launches == before    # no kernel launched
    want = fe.finish(dc_correct(*parts[:4], pt, consts,
                                mu_prev=block_mu_prev(parts[3])),
                     d, tables, 32, 2.4e6, False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("int8", [False, True])
def test_fx_fused_step_on_cpu_agrees_with_the_two_pass_wrappers(int8):
    """fx_fused_step (plain versions on the CPU) over K = 3 merged blocks
    against fx_fused_raw*_multi_reference + finish, within 2e-5 of
    max|vis| (3e-5 for 8-bit samples); the history in the same contract."""
    from fxtpu_torch.ops import fx_epilogue as fe
    x, hist, wt, pt, _, consts = _parts_inputs(
        2, True, 3, 32, NBINS, NTAPS, int8, "direct", "cpu", seed=66)
    tables = fe.FinishTables(baseline_pairs(2, True), NBINS, 2.4e6, 1.4e9,
                             "cpu")
    d = torch.tensor([[0.0, 1e-10]] * 3)
    if int8:
        h = {"tail": hist, "mu_prev": torch.tensor(
            [0.02 + 0.01j, -0.01j], dtype=torch.complex64)}
        xr, hr = fx_fused.fx_fused_raw_i8_multi_reference(x, h, wt, pt, STEP)
    else:
        h = hist
        xr, hr = fx_fused.fx_fused_raw_multi_reference(x, h, wt, pt)
    want = fe.finish(xr, d, tables, 32, 2.4e6, False)
    got, hn = fe.fx_fused_step(x, h, wt, pt, consts, d, tables, 2.4e6, False,
                               STEP if int8 else None)
    assert (got - want).abs().max() <= (3e-5 if int8 else 2e-5) * want.abs(
        ).max()
    if int8:
        assert torch.equal(hn["tail"], hr["tail"])
        assert (hn["mu_prev"] - hr["mu_prev"]).abs().max() <= 1e-7
    else:
        assert (hn - hr).abs().max() <= 1e-6


# --- the frame kernel's split: a frame group's channels over a cluster of
# two CTAs (spectra shared through distributed shared memory) -------------

SPLIT_SHAPES = [
    # nbins, s, ntaps, nch, autos, k
    (256, 32, 4, 3, True, 1),     # odd: CTA 1 of a cluster has one fewer
    (256, 32, 4, 5, True, 2),     # odd, five channels, two blocks
    (4096, 8, 4, 6, True, 1),     # six at 4096 bins: the shared route's most
    (256, 16, 4, 2, False, 8),    # K = 8 blocks in one launch
    (8192, 8, 4, 2, False, 2),    # the largest bin count (16 x 16 x 32)
    (256, 8, 4, 1, True, 2),      # one channel: a cluster of one CTA
]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nbins,s,ntaps,nch,autos,k", SPLIT_SHAPES)
def test_cuda_cluster_split_matches_plain_version(cuda_device, nbins, s,
                                                  ntaps, nch, autos, k,
                                                  int8):
    """The two-pass K-block entries, whose frame groups run on clusters of
    two CTAs, against their plain versions (2e-5 of scale, 3e-5 for 8-bit
    samples; the history 1e-6, the int8 tail exact), bit for bit from run
    to run."""
    from fxtpu_torch.ops.fx_fused import (fx_fused_raw_i8_multi,
                                          fx_fused_raw_i8_multi_reference,
                                          fx_fused_raw_multi,
                                          fx_fused_raw_multi_reference)
    x, hist, wt, pt, _, _ = _parts_inputs(
        nch, autos, k, s, nbins, ntaps, int8, "direct", cuda_device,
        seed=70 + nch)
    if int8:
        hist = {"tail": hist, "mu_prev": torch.full(
            (nch,), 0.05 - 0.02j, dtype=torch.complex64, device=cuda_device)}
        fn, ref, arg = (fx_fused_raw_i8_multi,
                        fx_fused_raw_i8_multi_reference, (STEP,))
    else:
        fn, ref, arg = fx_fused_raw_multi, fx_fused_raw_multi_reference, ()
    got = fn(x, hist, wt, pt, *arg)
    want = ref(x, hist, wt, pt, *arg)
    again = fn(x, hist, wt, pt, *arg)
    torch.cuda.synchronize()
    scale = want[0].abs().max().item()
    assert got[0].shape == (k, len(pt), nbins)
    assert (got[0] - want[0]).abs().max().item() <= (
        (3e-5 if int8 else 2e-5) * scale)
    assert torch.equal(got[0], again[0])
    if int8:
        assert torch.equal(got[1]["tail"], want[1]["tail"])
        assert (got[1]["mu_prev"] - want[1]["mu_prev"]).abs().max() <= 1e-6
    else:
        assert (got[1] - want[1]).abs().max() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_refused_launch_raises(cuda_device, int8):
    """A launch the card refuses (here: eight spectra of 8192 bins on the
    cluster route, more shared memory than a CTA has) returns its error
    and the wrapper raises; nothing else is launched in its place."""
    nch, nbins, ntaps = 8, 8192, 4
    x, hist, wt, pt, _, _ = _parts_inputs(
        nch, False, 1, 4, nbins, ntaps, int8, "direct", cuda_device, seed=79)
    assert fx_fused.frame_shared_bytes(nbins, nch) > fx_fused.MAX_SHARED_BYTES
    with pytest.raises(RuntimeError, match="CUDA error"):
        if int8:
            hist = {"tail": hist, "mu_prev": torch.zeros(
                (nch,), dtype=torch.complex64, device=cuda_device)}
            fx_fused._launch_i8(x, hist, wt, pt, STEP, None, "refused",
                                merged=True)
        else:
            fx_fused._launch(x, hist, wt, pt, None, "refused", merged=True)
        torch.cuda.synchronize()
