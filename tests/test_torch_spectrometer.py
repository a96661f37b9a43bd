"""The F-stage spectrometer: fxtpu_torch.ops.spectrometer against the JAX
package's spectrometer_pallas (its Pallas kernel _kernel, run in interpret
mode on the CPU, as fxtpu's own tests run it), and the CUDA kernel against
its plain version on a card.

Tolerances are fxtpu's own for this kernel: spectra within 3e-6*scale at 4
taps and 5e-6*scale at 32 taps (tests/test_planes.py:280,301), the
carried history within 1e-6.

The JAX package is imported inside the tests that need it, so that the
card's tests run on a machine without JAX:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_spectrometer.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops.spectrometer import (spectrometer_fused,  # noqa: E402
                                          spectrometer_fused_reference,
                                          supported_spectrometer)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402


def _case(nch, nsamp, nbins, ntaps, seed, k=2):
    """Window and ``k`` blocks [nch, nsamp] with a DC offset per channel
    (the spectrometer removes it before the FIR)."""
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    rng = np.random.default_rng(seed)
    blocks = [(rng.normal(size=(nch, nsamp))
               + 1j * rng.normal(size=(nch, nsamp))
               + (0.3 - 0.2j) * np.arange(1, nch + 1)[:, None]
               ).astype(np.complex64) for _ in range(k)]
    return w2d, blocks


def _zero_hist(nch, ntaps, nbins, device="cpu"):
    return torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64,
                       device=device)


@pytest.mark.parametrize("nbins,nsamp,ntaps,tol,k", [
    (256, 2**13, 4, 3e-6, 2),         # two chained blocks (test_planes:265)
    (512, 512 * 64, 32, 5e-6, 2),     # wideband taps (test_planes:289)
    (256, 2**12, 1, 3e-6, 2),         # ntaps=1: empty history
    (256, 2**13 + 100, 4, 3e-6, 2),   # the mean covers the ragged tail
])
def test_reference_matches_spectrometer_pallas(nbins, nsamp, ntaps, tol, k):
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import from_complex, to_complex
    from fxtpu.ops.pfb_pallas import spectrometer_pallas
    nch = 2
    w2d, blocks = _case(nch, nsamp, nbins, ntaps, seed=ntaps + nsamp % 7,
                        k=k)
    hj = from_complex(np.zeros((nch, ntaps - 1, nbins), np.complex64))
    ht = _zero_hist(nch, ntaps, nbins)
    wt = torch.from_numpy(w2d)
    for b, x in enumerate(blocks):
        sj, hj = spectrometer_pallas(from_complex(x), jnp.asarray(w2d), nbins,
                                     hj)
        st, ht = spectrometer_fused_reference(torch.from_numpy(x), wt, nbins,
                                              ht)
        want = to_complex(sj)
        assert st.shape == want.shape == (nch, nsamp // nbins, nbins)
        np.testing.assert_allclose(st.numpy(), want,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=f"block {b}")
        assert ht.shape == (nch, ntaps - 1, nbins)
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


def test_mean_covers_every_sample():
    """A DC step in the tail beyond the last full row moves the mean, and
    so every spectrum's DC bin (spectrometer_pallas takes the mean over
    all nsamp samples)."""
    nbins, ntaps = 256, 4
    w2d, (x,) = _case(1, 2**12 + 128, nbins, ntaps, seed=3, k=1)
    wt = torch.from_numpy(w2d)
    h = _zero_hist(1, ntaps, nbins)
    a, _ = spectrometer_fused(torch.from_numpy(x), wt, nbins, h)
    y = x.copy()
    y[:, 2**12:] += 5.0
    b, _ = spectrometer_fused(torch.from_numpy(y), wt, nbins, h)
    shift = 5.0 * 128 / (2**12 + 128)
    want = -shift * w2d.sum(axis=0).sum()     # DC bin of frames past the halo
    np.testing.assert_allclose((b - a)[0, ntaps:, 0].numpy(),
                               np.full(2**12 // nbins - ntaps, want),
                               rtol=1e-4)


def test_wrapper_takes_plain_version_on_cpu():
    w2d, (x,) = _case(2, 2**13, 256, 4, seed=5, k=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w2d)
    h = _zero_hist(2, 4, 256)
    before = spectrometer_fused.launches
    got = spectrometer_fused(xt, wt, 256, h)
    want = spectrometer_fused_reference(xt, wt, 256, h)
    assert spectrometer_fused.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_refuses_other_devices():
    x = torch.empty((2, 2**13), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        spectrometer_fused(x, x.real[:, :256], 256, x[:, None, :256])


@pytest.mark.parametrize("nbins,ntaps,nch,ok", [
    (256, 1, 2, True), (8192, 32, 2, True), (8192, 4, 64, True),
    (128, 4, 2, False), (16384, 4, 2, False), (384, 4, 2, False),
    (256, 0, 2, False),
])
def test_supported_shapes(nbins, ntaps, nch, ok):
    assert supported_spectrometer(nbins, ntaps, nch) is ok


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("nbins,nsamp,ntaps,nch", [
    (256, 2**13, 4, 2),               # the CPU tests' shape
    (256, 2**13 + 100, 1, 3),         # one tap, ragged tail
    (512, 512 * 64, 32, 2),           # wideband taps
    (8192, 8192 * 8 + 17, 4, 3),      # the largest nbins, ragged tail
    (4096, 2**18, 4, 2),              # the flagship block
    (256, 256 * 529, 4, 2),           # more frames than CTAs
])
def test_cuda_kernel_matches_plain_version(cuda_device, nbins, nsamp, ntaps,
                                           nch):
    """Two chained blocks: spectra within 5e-6*scale of the plain
    version, history within 1e-6."""
    w2d, blocks = _case(nch, nsamp, nbins, ntaps, seed=17)
    wt = torch.as_tensor(w2d, device=cuda_device)
    hk = hr = _zero_hist(nch, ntaps, nbins, cuda_device)
    before = spectrometer_fused.launches
    for x_np in blocks:
        x = torch.as_tensor(x_np, device=cuda_device)
        sk, hk = spectrometer_fused(x, wt, nbins, hk)
        sr, hr = spectrometer_fused_reference(x, wt, nbins, hr)
        torch.cuda.synchronize()
        scale = sr.abs().max().item()
        assert sk.shape == sr.shape and hk.shape == hr.shape
        assert (sk - sr).abs().max().item() <= 5e-6 * scale
        if ntaps > 1:
            assert (hk - hr).abs().max().item() <= 1e-6
    assert spectrometer_fused.launches == before + len(blocks)


@pytest.mark.cuda
def test_cuda_kernel_is_repeatable(cuda_device):
    w2d, (x_np,) = _case(2, 2**13, 256, 4, seed=18, k=1)
    x = torch.as_tensor(x_np, device=cuda_device)
    wt = torch.as_tensor(w2d, device=cuda_device)
    h = _zero_hist(2, 4, 256, cuda_device)
    a = spectrometer_fused(x, wt, 256, h)
    b = spectrometer_fused(x, wt, 256, h)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_input(cuda_device):
    w2d, (x_np,) = _case(2, 2**13, 256, 4, seed=19, k=1)
    x = torch.as_tensor(x_np, device=cuda_device)
    wt = torch.as_tensor(w2d, device=cuda_device)
    h = _zero_hist(2, 4, 256, cuda_device)
    with pytest.raises(ValueError, match="history"):
        spectrometer_fused(x, wt, 256, h[:, :1])
    with pytest.raises(ValueError, match="shorter"):
        spectrometer_fused(x[:, :100].contiguous(), wt, 256, h)
    with pytest.raises(ValueError, match="is on"):
        spectrometer_fused(x, wt.cpu(), 256, h)
    with pytest.raises(ValueError, match="contiguous"):
        spectrometer_fused(x[:, ::2], wt, 256, h)
    with pytest.raises(TypeError):
        spectrometer_fused(x.to(torch.complex128), wt, 256, h)
