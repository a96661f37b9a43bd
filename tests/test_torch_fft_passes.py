"""The frame kernel's FFT and CTA split, by their plain mirrors in
fxtpu_torch.ops.fx_fused, at every bin count the kernel takes (n = 128 m,
2 <= m <= 128): the radix passes' index arithmetic
(``fft_passes``, the same loads, twiddles and stores as
``csrc/fx_fft.cuh``'s ``fft_pass``), the stage ablation's ``fft_half``,
the split of a frame group's channels and bins over a cluster
(``frame_ctas``), and the shared-memory sizes a launch asks for against
the routes' rules, which must not move.

Tolerance: the passes against ``torch.fft.fft`` (in float64) within 1e-5
of the spectrum's largest magnitude, the spectra's bound being 5e-6·scale
on the card and the mirror's R-point DFTs rounding in float32; anything
that repeats the same arithmetic, bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.pfb import pfb_fir  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

SIZES = [256, 512, 1024, 2048, 4096, 8192]


def _noise(n, rows=3, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(rows, n))
                             + 1j * rng.normal(size=(rows, n))
                             ).astype(np.complex64))


@pytest.mark.parametrize("n", SIZES)
def test_all_passes_are_the_dft(n):
    x = _noise(n, seed=n)
    radices = ff.fft_radices(n)
    assert int(np.prod(radices)) == n and radices[:2] == (16, 16)
    got = ff.fft_passes(x, len(radices)).to(torch.complex128)
    want = torch.fft.fft(x.to(torch.complex128))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("n", SIZES)
def test_passes_resume_where_they_stopped(n):
    """A slot left after some passes (the ablation's ``fft_half``: the
    first floor(passes / 2)) is finished by the rest, bit for bit."""
    x = _noise(n, seed=n + 1)
    passes = len(ff.fft_radices(n))
    half = ff.fft_passes(x, passes // 2)
    assert passes // 2 == 1
    assert torch.equal(ff.fft_passes(half, passes, start=passes // 2),
                       ff.fft_passes(x, passes))
    assert torch.equal(ff.fft_passes(x, 0), x)


def test_first_pass_is_stored_swizzled():
    """After pass 0 the slot is in the order pass 1 reads: point L at L ^
    ((L >> 4) & 15), the 16-point DFTs of the stride-16 columns."""
    n = 256
    x = _noise(n, rows=1, seed=5)[0]
    got = ff.fft_passes(x, 1)
    cols = torch.fft.fft(x.reshape(16, 16).T, dim=-1)   # [j, r]: j + 16 r
    logical = cols.reshape(-1)                         # at 16 j + r
    idx = torch.arange(n)
    assert torch.allclose(got[idx ^ ((idx >> 4) & 15)], logical, atol=1e-5)


@pytest.mark.parametrize("n", [128 * m for m in range(2, 129)])
def test_every_kernel_bin_count_is_the_dft(n):
    """Every bin count of fxtpu's kernels (``_kernel_factor``): the FIR's
    output as the kernel stores it (``fft_slot``), then every pass, is
    the DFT in natural order; passes stopped halfway (the powers of two:
    after the first) resume bit for bit; the radices multiply to n, the
    powers of two's as before."""
    x = _noise(n, rows=2, seed=n)
    radices = ff.fft_radices(n)
    assert int(np.prod(radices)) == n and radices[0] == 16
    if n in SIZES:
        assert radices == ((16, 16) if n == 256 else (16, 16, n >> 8))
    slot = ff.fft_slot(x)
    got = ff.fft_passes(slot, len(radices))
    want = torch.fft.fft(x.to(torch.complex128))
    assert (got.to(torch.complex128) - want).abs().max() <= (
        1e-5 * want.abs().max())
    half = len(radices) // 2
    assert torch.equal(ff.fft_passes(ff.fft_passes(slot, half),
                                     len(radices), start=half), got)


@pytest.mark.parametrize("n", [128, 1000, 16512])
def test_radices_reject_other_sizes(n):
    with pytest.raises(ValueError, match="256 to 16384"):
        ff.fft_radices(n)
    with pytest.raises(ValueError, match="passes"):
        ff.fft_passes(_noise(256), 3)


@pytest.mark.parametrize("nbins", [256, 512])
def test_fft_half_stage_is_the_first_pass(nbins):
    """``fx_fused_ablate_reference('fft_half')`` is the cross power of
    what the first pass leaves in each channel's slot."""
    nch, k, s, ntaps = 2, 2, 8, 4
    rng = np.random.default_rng(nbins)
    x = torch.from_numpy((rng.normal(size=(nch, k, s, nbins))
                          + 1j * rng.normal(size=(nch, k, s, nbins))
                          ).astype(np.complex64))
    hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64)
    w = torch.from_numpy(pfb_window(ntaps, nbins).reshape(
        ntaps, nbins).astype(np.float32))
    pairs = ff.pairs_tensor(baseline_pairs(nch, True), nch, "cpu")
    got = ff.fx_fused_ablate_reference(x, hist, w, pairs, "fft_half")
    rows = x - x.mean(dim=(-2, -1), keepdim=True)
    y = pfb_fir(torch.cat([hist, rows.reshape(nch, k * s, nbins)], dim=1), w)
    half = ff.fft_passes(y, len(ff.fft_radices(nbins)) // 2).reshape(
        nch, k, s, nbins)
    idx = pairs.long()
    want = (half[idx[:, 0]] * half[idx[:, 1]].conj()).sum(dim=-2)
    assert torch.equal(got, want.permute(1, 0, 2))


@pytest.mark.parametrize("nbins", [384, 16384])
def test_ablation_at_other_counts(nbins):
    """Away from the radix-16 FFT's sizes the ablation runs the stages of
    ``MIXED_STAGES``: ``fir`` is the cross power over the FIR's output in
    the slot order the kernel stores it (``fft_slot``), ``fft`` the DFT
    of the FIR's frames, the stage's first bins summed over frames and
    channels; the others are refused."""
    nch, k, s, ntaps = 2, 1, 4, 4
    rng = np.random.default_rng(nbins)
    x = torch.from_numpy((rng.normal(size=(nch, k, s, nbins))
                          + 1j * rng.normal(size=(nch, k, s, nbins))
                          ).astype(np.complex64))
    hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64)
    w = torch.from_numpy(pfb_window(ntaps, nbins).reshape(
        ntaps, nbins).astype(np.float32))
    pairs = ff.pairs_tensor(baseline_pairs(nch), nch, "cpu")
    rows = x - x.mean(dim=(-2, -1), keepdim=True)
    y = pfb_fir(torch.cat([hist, rows.reshape(nch, k * s, nbins)], dim=1), w)
    slot = ff.fft_slot(y)
    got = ff.fx_fused_ablate(x, hist, w, pairs, "fir")
    want = (slot[0] * slot[1].conj()).sum(dim=-2)
    assert torch.allclose(got[0, 0], want, rtol=1e-5, atol=1e-5)
    got = ff.fx_fused_ablate(x, hist, w, pairs, "fft")
    spec = torch.fft.fft(y.to(torch.complex128))
    want = spec[..., :ff.FFT_STAGE_BINS].sum(dim=-2).sum(dim=0)
    assert (got[0, 0] - want).abs().max() <= 1e-5 * spec.abs().max() * s
    assert ff.MIXED_STAGES == ("full", "fir", "fft")
    for stage in ("load", "load_raw", "fft_half"):
        with pytest.raises(ValueError, match=stage):
            ff.fx_fused_ablate(x, hist, w, pairs, stage)


@pytest.mark.parametrize("one_slot", [False, True])
@pytest.mark.parametrize("nch", [1, 2, 3, 4, 5, 6, 7, 8, 64])
def test_split_covers_every_frame_channel_and_bin_once(nch, one_slot):
    """Every (frame, channel) runs its FIR and FFT on one CTA; on a
    cluster policy every bin of every pair is formed once, by a CTA of
    the group that holds the frame, and a cluster holds at most
    CLUSTER_CTAS CTAs, each with its share of the channels."""
    nbins, s_rows = 256, 7
    n_groups, per = 3, 3                  # groups 0..2, the last ragged
    ctas = ff.frame_ctas(nch, nbins, n_groups, per, s_rows,
                         one_slot=one_slot)
    ran = {}
    for g, rank, chans, frames, _ in ctas:
        for f in frames:
            for c in chans:
                ran[(f, c)] = ran.get((f, c), 0) + 1
    assert ran == {(f, c): 1 for f in range(s_rows) for c in range(nch)}
    pairs = [tuple(p) for p in baseline_pairs(nch, True)]
    for g in range(n_groups):
        group = [c for c in ctas if c[0] == g]
        if one_slot:
            assert [c[2] for c in group] == [(c,) for c in range(nch)]
            assert all(len(c[4]) == 0 for c in group)
            continue
        cs = ff.cluster_size(nch)
        assert len(group) == cs <= ff.CLUSTER_CTAS
        assert sorted(r for _, r, *_ in group) == list(range(cs))
        counts = [len(c[2]) for c in group]
        assert max(counts) - min(counts) <= 1
        formed = {}
        for _, _, _, _, bins in group:
            for p in pairs:
                for b in bins:
                    formed[(p, b)] = formed.get((p, b), 0) + 1
        assert formed == {(p, b): 1 for p in pairs for b in range(nbins)}


@pytest.mark.parametrize("nch", [1, 2, 3, 8])
@pytest.mark.parametrize("nbins", [384, 640, 16256])
def test_split_covers_every_bin_at_other_counts(nbins, nch):
    """At bin counts that are not powers of two the cluster's halves of a
    frame's bins (192 of 384, 8128 of 16256) still cover every bin of
    every pair once, and the one-slot split every (frame, channel)."""
    s_rows, n_groups, per = 5, 2, 3
    for one_slot in (False, True):
        ctas = ff.frame_ctas(nch, nbins, n_groups, per, s_rows,
                             one_slot=one_slot)
        ran = {}
        for _, _, chans, frames, _ in ctas:
            for f in frames:
                for c in chans:
                    ran[(f, c)] = ran.get((f, c), 0) + 1
        assert ran == {(f, c): 1 for f in range(s_rows) for c in range(nch)}
        if one_slot:
            continue
        for g in range(n_groups):
            bins = sorted(b for c in ctas if c[0] == g for b in c[4])
            assert bins == list(range(nbins))
            assert {len(c[4]) for c in ctas if c[0] == g} == {
                nbins // ff.cluster_size(nch)}


def _radix2_route_rule(nbins, nch, ntaps=0, rank=0, mean_blocks=1):
    """The shared route's footprint as the radix-2 kernel defined it."""
    return ((nch + 1) * nbins + nch * mean_blocks) * 8 + ntaps * rank * 4


@pytest.mark.parametrize("nbins", SIZES)
def test_routes_do_not_move(nbins):
    """supported, supported_parts and x_route give the radix-2 kernel's
    answers: the route's rule is its footprint, whatever a launch asks."""
    for nch in (1, 2, 3, 5, 6, 7, 8, 64):
        for ntaps, rank in ((4, 0), (32, 6)):
            fits = (_radix2_route_rule(nbins, nch, ntaps, rank,
                                       ff.PARTS_CHAN_SLOTS)
                    <= ff.MAX_SHARED_BYTES)
            assert ff.supported(nbins, ntaps, nch, rank) is fits
            assert ff.x_route(nbins, ntaps, nch, rank) == (
                "shared" if fits else "global")
            assert ff.supported_parts(nbins, ntaps, nch, 64, rank) is True


@pytest.mark.parametrize("nbins", SIZES)
def test_launch_asks_less_than_the_route_rule(nbins):
    """Where a route takes a shape, its launch's shared memory (the
    cluster's share of the spectra, the twiddle table, the sums) is
    within the rule that admitted it, and within the card's limit."""
    for nch in range(1, 65):
        for ntaps, rank in ((4, 0), (32, 6)):
            if ff.supported(nbins, ntaps, nch, rank):
                got = ff.frame_shared_bytes(nbins, nch, ff.PARTS_CHAN_SLOTS)
                assert got <= ff.shared_route_bytes(
                    nbins, nch, ntaps, rank, ff.PARTS_CHAN_SLOTS)
            wide = ff.frame_shared_bytes(nbins, nch, ff.PARTS_CHAN_SLOTS,
                                         one_slot=True)
            assert wide <= ff.wide_route_bytes(nbins, nch, ntaps, rank)
            assert wide <= ff.MAX_SHARED_BYTES
