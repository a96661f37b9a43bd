"""The fused FX step: fxtpu_torch.ops.fx_fused against the JAX package's
fused Pallas kernel, run here as fxtpu's own tests run it (interpret mode
on the CPU), and the CUDA kernel against its plain version on a card.

Tolerance: fxtpu's fused-against-unfused bound, 2e-5*scale with history
within 1e-6 (tests/test_planes.py:318-321).

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
                                      fx_fused_raw_reference, pairs_tensor,
                                      supported)
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
