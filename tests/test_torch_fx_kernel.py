"""The fused FX step: fxtpu_torch.ops.fx_fused against the JAX package's
fused Pallas kernel, run here as fxtpu's own tests run it (interpret mode
on the CPU), and the CUDA kernels against their plain versions on a card.

Tolerance: fxtpu's fused-against-unfused bound, 2e-5*scale with history
within 1e-6 (tests/test_planes.py:318-321); for 8-bit samples fxtpu's
int8-native bound, 3e-5*scale (tests/test_planes.py:558), with the raw
tail bit-exact and mu_prev within 1e-7.

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
                                      supported, supported_i8)
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


@pytest.mark.parametrize("nch,autos", [(2, False), (3, True)])
def test_reference_matches_fxtpu_fused_kernel(nch, autos):
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_raw
    w2d, pairs, blocks, wt, pt = _case(nch, autos, seed=nch)
    hj = Cplx(jnp.zeros((nch, NTAPS - 1, NBINS), jnp.float32),
              jnp.zeros((nch, NTAPS - 1, NBINS), jnp.float32))
    ht = torch.zeros((nch, NTAPS - 1, NBINS), dtype=torch.complex64)
    for x in blocks:
        xj, hj = fx_pallas_raw(from_complex(x), jnp.asarray(w2d), NBINS, hj,
                               pairs)
        xt, ht = fx_fused_raw_reference(torch.from_numpy(x), ht, wt, pt)
        want = to_complex(xj)
        np.testing.assert_allclose(xt.numpy(), want,
                                   atol=2e-5 * np.abs(want).max())
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
    (16384, 4, 2, False), (384, 4, 2, False), (4096, 1, 2, False),
    (8192, 4, 3, False),
])
def test_supported_shapes(nbins, ntaps, nch, ok):
    assert supported(nbins, ntaps, nch) is ok
    assert (fx_fused.shared_bytes(nbins, nch)
            <= fx_fused.MAX_SHARED_BYTES) or not ok


@pytest.mark.parametrize("nbins,ntaps,nch,s_rows,ok", [
    (4096, 4, 2, 64, True), (256, 4, 2, 3, True), (256, 4, 2, 2, False),
    (256, 32, 2, 31, True), (256, 32, 2, 30, False), (4096, 4, 7, 64, False),
    (384, 4, 2, 64, False), (4096, 1, 2, 64, False),
])
def test_supported_i8_shapes(nbins, ntaps, nch, s_rows, ok):
    assert supported_i8(nbins, ntaps, nch, s_rows) is ok


def test_groups_cover_every_frame():
    for s_rows, nbl, nbins in ((64, 1, 4096), (1024, 1, 256), (7, 3, 256),
                               (64, 36, 8192)):
        n, per = fx_fused._groups(s_rows, nbl, nbins)
        assert (n - 1) * per < s_rows <= n * per
        assert n * nbl * nbins * 8 <= max(fx_fused.MAX_PARTIAL_BYTES,
                                          nbl * nbins * 8)


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
