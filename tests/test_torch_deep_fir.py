"""The frame kernel's deep-tap FIR and the mixed-radix FFT's last odd-prime
pass in the port (``fxtpu_torch.ops.fx_fused``).

At deep taps (``fx_fused.deep_fir``: 16 taps and more) the kernels run the
FIR as a launch of its own, ``fir_rows_kernel`` (``fx_fused.fir_rows``
alone), which reads each row once and writes every frame's FIR output,
and the SVD mode's factors are folded into one table (``fir_table``: ``u
v`` formed in float64, rounded once).  The mixed-radix FFT's last pass, at
an odd prime p, runs pre-twiddled p-point DFTs by their roots' real
symmetry (``fft_pass_prime_last``; its mirror ``_prime_dft``).

On the CPU: the mirror of that pass against numpy's DFT at every odd prime
a bin count of ``kernel_bins`` holds (up to 127); the folded table against
the factors' U-then-V sum (``ops.pfb.svd_fir``) within 1e-6 of scale on
random rows; ``fir_rows`` on CPU tensors is its plain version and launches
nothing; the rule ``deep_fir`` against the kernel's limits; the single
pass's plain SVD version against the same step through the folded table
within 3e-5 of scale (``DEEP_TOL``, tests/test_planes.py:485).  On the card
(``cuda`` marker): ``fir_rows`` against its plain version within 1e-6 of
max|fir| (the same table, the same tap order), the single pass at deep taps
and at odd-prime bin counts against its plain version (3e-5 deep, 2e-5 of
max|xp| otherwise), K blocks a call against K one-block steps (block 0 bit
for bit), one FIR launch counted a deep call.  No JAX here: the file runs
on the card's machine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.pfb import dequantize, pfb_fir, svd_fir  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

DEEP_TOL = 3e-5
FIR_TOL = 1e-6
STEP = 1.0 / 32
# every odd prime that divides some n = 128 m, 2 <= m <= 128
PRIMES = [p for p in range(3, 128, 2)
          if all(p % q for q in range(3, int(p ** 0.5) + 1, 2))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _window(ntaps, nbins):
    return pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)


def _rows(rng, nch, k, s, nbins, int8):
    """Merged blocks [nch, K, S, nbins] (int8: [.., 2]) with a DC offset."""
    if int8:
        return torch.as_tensor(np.clip(np.rint(
            30 * rng.normal(size=(nch, k, s, nbins, 2)) + 3), -127,
            127).astype(np.int8))
    return torch.as_tensor((rng.normal(size=(nch, k, s, nbins))
                            + 1j * rng.normal(size=(nch, k, s, nbins))
                            + (0.04 - 0.03j)).astype(np.complex64))


def _history(rng, nch, ntaps, nbins, int8):
    if int8:
        return torch.as_tensor(np.clip(np.rint(30 * rng.normal(
            size=(nch, ntaps - 1, nbins, 2))), -127, 127).astype(np.int8))
    return torch.as_tensor((rng.normal(size=(nch, ntaps - 1, nbins))
                            + 1j * rng.normal(size=(nch, ntaps - 1, nbins))
                            ).astype(np.complex64))


@pytest.mark.parametrize("p", PRIMES)
def test_prime_dft_is_the_dft(p):
    """The last odd-prime pass's arithmetic (pure p-point DFTs by the
    roots' real symmetry, each root read from the FFT's table folded to m
    <= (p - 1) / 2) against numpy's DFT, within 1e-6 of scale: the table
    of n = 2 p points, whose roots of p are every second entry."""
    rng = np.random.default_rng(p)
    v = (rng.normal(size=(5, p)) + 1j * rng.normal(size=(5, p)))
    tw = ff._twiddles(2 * p, torch.device("cpu"))
    got = ff._prime_dft(torch.as_tensor(v.astype(np.complex64)), tw, 2)
    want = np.fft.fft(v, axis=-1)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max(), (p, err)


@pytest.mark.parametrize("ntaps,nbins", [(16, 256), (32, 256), (32, 384),
                                         (32, 1024)])
def test_folded_table_matches_the_factors(ntaps, nbins):
    """``fir_table`` in the SVD mode, ``u v`` formed in float64 and rounded
    once, gives the FIR of the factors' U-then-V sum (``svd_fir``, the
    plain version's association) within 1e-6 of scale on random rows; in
    the direct mode it is the window itself."""
    w = _window(ntaps, nbins)
    svd = ff.svd_tensors(w, "cpu")
    assert svd is not None
    wt = torch.as_tensor(w)
    assert ff.fir_table(wt) is wt
    table = ff.fir_table(wt, svd)
    assert table.dtype == torch.float32 and table.shape == (ntaps, nbins)
    assert table.is_contiguous()
    rng = np.random.default_rng(ntaps + nbins)
    rows = torch.as_tensor((rng.normal(size=(2, ntaps + 40, nbins))
                            + 1j * rng.normal(size=(2, ntaps + 40, nbins))
                            ).astype(np.complex64))
    got = pfb_fir(rows, table)
    want = svd_fir(rows, *svd)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    # the same table object on every step of an engine's factors
    assert ff.fir_table(wt, svd) is table


@pytest.mark.parametrize("int8", [False, True])
def test_fir_rows_on_cpu_is_its_plain_version(int8):
    """``fir_rows`` on CPU tensors is ``fir_rows_reference``: the FIR over
    the merged raw rows ``[history; x]`` (8-bit samples times the step),
    row g the output of frame g; nothing is launched."""
    rng = np.random.default_rng(5)
    nch, k, s, nbins, ntaps = 2, 3, 20, 256, 16
    x = _rows(rng, nch, k, s, nbins, int8)
    hist = _history(rng, nch, ntaps, nbins, int8)
    table = torch.as_tensor(_window(ntaps, nbins))
    step = STEP if int8 else None
    before = ff.fir_rows.launches
    got = ff.fir_rows(x, hist, table, step)
    assert ff.fir_rows.launches == before
    assert got.shape == (nch, k * s, nbins) and got.dtype == torch.complex64
    rows = dequantize(x, STEP) if int8 else x
    h = dequantize(hist, STEP) if int8 else hist
    merged = torch.cat([h, rows.reshape(nch, k * s, nbins)], dim=1)
    want = pfb_fir(merged, table)
    assert torch.equal(got, want)
    # frame g is sum_t table[t] row[g + t]
    g = 7
    frame = (table[:, None, :] * merged[:, g:g + ntaps].transpose(0, 1)
             ).sum(dim=0)
    assert (got[:, g] - frame).abs().max() <= 1e-5 * frame.abs().max()


def test_deep_fir_rule_is_the_kernels_limits():
    """``deep_fir`` holds from DEEP_FIR_TAPS taps where a CTA of the FIR
    launch stages the means of every block its rows lie in (the kernel's
    kFirMaxMeans, its launch check), and not below 16 taps."""
    assert ff.DEEP_FIR_TAPS == 16
    for ntaps in (2, 4, 8, 15):
        assert not ff.deep_fir(ntaps, 64)
    for ntaps, s in ((16, 15), (32, 32), (32, 1), (64, 4), (128, 1)):
        assert ff.deep_fir(ntaps, s)
        assert (ff.FIR_FRAMES + ntaps - 2) // s + 2 <= ff.FIR_MAX_MEANS
    assert not ff.deep_fir(255, 1)
    assert ff._fir_scratch(2, 3, 32, 256, 4, "cpu") is None
    t = ff._fir_scratch(2, 3, 32, 256, 32, "cpu")
    assert t.shape == (2, 96, 256) and t.dtype == torch.complex64


@pytest.mark.parametrize("int8", [False, True])
def test_single_pass_through_the_folded_table(int8):
    """The single pass's plain version in the SVD mode (the U-then-V sum)
    against the same step through the folded table (what the kernels run),
    within 3e-5 of scale, both ingests, K = 2."""
    nch, k, s, nbins, ntaps = 2, 2, 40, 256, 32
    w = _window(ntaps, nbins)
    svd = ff.svd_tensors(w, "cpu")
    wt = torch.as_tensor(w)
    pairs = ff.pairs_tensor(baseline_pairs(nch, True), nch, "cpu")
    rng = np.random.default_rng(9)
    x = _rows(rng, nch, k, s, nbins, int8)
    hist = _history(rng, nch, ntaps, nbins, int8)
    table = ff.fir_table(wt, svd)
    if int8:
        want = ff.fx_fused_parts_i8_reference(x, hist, wt, pairs, STEP, svd)
        got = ff.fx_fused_parts_i8_reference(x, hist, table, pairs, STEP)
    else:
        want = ff.fx_fused_parts_reference(x, hist, wt, pairs, svd)
        got = ff.fx_fused_parts_reference(x, hist, table, pairs)
    for g, r in zip(got[:3], want[:3]):
        assert (g - r).abs().max() <= DEEP_TOL * r.abs().max()


# ------------------------------------------------------------ on the card


@pytest.mark.cuda
@pytest.mark.parametrize("fir", ["direct", "svd"])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_cuda_fir_rows_matches_plain(cuda_device, fir, int8, k):
    """The FIR launch alone against its plain version: within 1e-6 of
    max|fir| at 32 taps (the window or the folded factors), frames that do
    not fill the launch's last chunk of 16 included (S = 37)."""
    nch, s, nbins, ntaps = 2, 37, 1024, 32
    w = _window(ntaps, nbins)
    svd = ff.svd_tensors(w, cuda_device) if fir == "svd" else None
    table = ff.fir_table(torch.as_tensor(w, device=cuda_device), svd)
    rng = np.random.default_rng(k)
    x = _rows(rng, nch, k, s, nbins, int8).to(cuda_device)
    hist = _history(rng, nch, ntaps, nbins, int8).to(cuda_device)
    step = STEP if int8 else None
    before = ff.fir_rows.launches
    got = ff.fir_rows(x, hist, table, step)
    want = ff.fir_rows_reference(x, hist, table, step)
    torch.cuda.synchronize()
    assert ff.fir_rows.launches == before + 1
    assert (got - want).abs().max() <= FIR_TOL * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("x_stage", ["shared", "global"])
def test_cuda_deep_single_pass_matches_plain(cuda_device, int8, x_stage):
    """The single pass at 32 taps in the SVD mode (the FIR launch, then
    the frame kernel over its rows) against its plain version, the U-then-V
    sum, within 3e-5 of max|xp| on either X stage, K = 3; one FIR launch
    a call; mu within 1e-6."""
    nch, k, s, nbins, ntaps = 2, 3, 40, 1024, 32
    dev = cuda_device
    w = torch.as_tensor(_window(ntaps, nbins), device=dev)
    svd = ff.svd_tensors(w.cpu().numpy(), dev)
    pairs = ff.pairs_tensor(baseline_pairs(nch, True), nch, dev)
    rng = np.random.default_rng(17)
    x = _rows(rng, nch, k, s, nbins, int8).to(dev)
    hist = _history(rng, nch, ntaps, nbins, int8).to(dev)
    before = ff.fir_rows.launches
    if int8:
        got = ff.fx_fused_parts_i8(x, hist, w, pairs, STEP, svd,
                                   x_stage=x_stage)
        ref = (ff.fx_fused_parts_i8_wide_reference if x_stage == "global"
               else ff.fx_fused_parts_i8_reference)
        want = ref(x.cpu(), hist.cpu(), w.cpu(), pairs.cpu(), STEP,
                   tuple(t.cpu() for t in svd))
    else:
        got = ff.fx_fused_parts(x, hist, w, pairs, svd, x_stage=x_stage)
        ref = (ff.fx_fused_parts_wide_reference if x_stage == "global"
               else ff.fx_fused_parts_reference)
        want = ref(x.cpu(), hist.cpu(), w.cpu(), pairs.cpu(),
                   tuple(t.cpu() for t in svd))
    torch.cuda.synchronize()
    assert ff.fir_rows.launches == before + 1
    scale = want[0][..., 1:].abs().max()
    for g, r in zip(got[:3], want[:3]):
        assert (g.cpu()[..., 1:] - r[..., 1:]).abs().max() <= DEEP_TOL * max(
            scale, r[..., 1:].abs().max())
    assert (got[3].cpu() - want[3]).abs().max() <= 1e-6 * max(
        1.0, want[3].abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", [384, 640, 1152, 3072, 9856, 12288, 16256])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_odd_prime_counts_match_plain(cuda_device, nbins, int8):
    """The single pass at bin counts whose FFT ends in an odd prime (3, 5,
    3 x 3, 3, 7 x 11, 3 and 127: the last pass ``fft_pass_prime_last``, a
    smaller prime before it ``fft_pass_direct``) against its plain
    version, within 2e-5 of max|xp| off the DC bin, 8 frames."""
    nch, k, s, ntaps = 2, 1, 8, 4
    dev = cuda_device
    w = torch.as_tensor(_window(ntaps, nbins), device=dev)
    pairs = ff.pairs_tensor(baseline_pairs(nch, True), nch, dev)
    rng = np.random.default_rng(nbins)
    x = _rows(rng, nch, k, s, nbins, int8).to(dev)
    hist = _history(rng, nch, ntaps, nbins, int8).to(dev)
    wide = ff.x_route(nbins, ntaps, nch) == "global"
    if int8:
        got = ff.fx_fused_parts_i8(x, hist, w, pairs, STEP)
        want = (ff.fx_fused_parts_i8_wide_reference if wide
                else ff.fx_fused_parts_i8_reference)(
            x.cpu(), hist.cpu(), w.cpu(), pairs.cpu(), STEP)
    else:
        got = ff.fx_fused_parts(x, hist, w, pairs)
        want = (ff.fx_fused_parts_wide_reference if wide
                else ff.fx_fused_parts_reference)(
            x.cpu(), hist.cpu(), w.cpu(), pairs.cpu())
    torch.cuda.synchronize()
    for g, r in zip(got[:3], want[:3]):
        assert (g.cpu()[..., 1:] - r[..., 1:]).abs().max() <= 2e-5 * r[
            ..., 1:].abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_deep_k_blocks_match_steps(cuda_device, int8):
    """K = 4 blocks of a deep-tap single pass in one call against 4
    one-block calls chained through their history: block 0 bit for bit
    (each frame's FIR output is formed alike; the later blocks read the
    rows before them raw, which the post-hoc correction takes up); the
    call is repeatable bit for bit."""
    nch, k, s, nbins, ntaps = 2, 4, 40, 1024, 32
    dev = cuda_device
    w = torch.as_tensor(_window(ntaps, nbins), device=dev)
    svd = ff.svd_tensors(w.cpu().numpy(), dev)
    pairs = ff.pairs_tensor(baseline_pairs(nch, False), nch, dev)
    rng = np.random.default_rng(23)
    x = _rows(rng, nch, k, s, nbins, int8).to(dev)
    hist = _history(rng, nch, ntaps, nbins, int8).to(dev)

    def call(xx, hh):
        if int8:
            return ff.fx_fused_parts_i8(xx, hh, w, pairs, STEP, svd)
        return ff.fx_fused_parts(xx, hh, w, pairs, svd)

    whole = call(x, hist)
    again = call(x, hist)
    h, xp = hist, []
    for j in range(k):
        out = call(x[:, j:j + 1].contiguous(), h)
        xp.append(out[0][0])
        h = out[4]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(whole, again))
    assert torch.equal(whole[0][0], xp[0])
