"""The X kernel's register-tiled instance (fxtpu_torch/csrc/fx_xstage.cu
``fx_xstage_kernel_tiled``), which ``fx_xstage.xstage_plan`` takes from
``XSTAGE_TILED_NCH`` channels on.

On the CPU: the choice of instance by shape; each tiled plan's entry
checks, ring and shared memory; the row map against the pair list (the
full triangle with and without autos, permuted, sparse, both orders of a
pair); a plain mirror of the tiled kernel's assignment of tiles, tail
units and T and GJ sums to threads and CTAs, which writes every row of
every pair list once and agrees with ``fx_xstage_reference``.  On a card
(marked ``cuda``): the kernel against its plain version at 48, 64, 65,
96 and 128 channels over permuted and sparse pair lists, K = 1 and 3, the
autos' imaginary parts exactly 0 and the launch counted on
``fx_xstage.tiled``; with ``x`` set, mu and the new history equal to the
row instance's, in both ingests.

Tolerances: the mirror against the plain version 1e-6 of each row's
scale (float32 sums of the same products in frame order against torch's
sum); the kernel 2e-5 of each row's scale, as chip_smoke.py holds it (its
FFMA chains round otherwise than the row instance's products, so the two
agree within tolerance, not bit for bit); mu and the history bit for bit
(the same fold code).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops.fx_fused import (MAX_SHARED_BYTES,  # noqa: E402
                                      pairs_tensor)
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

xs = importlib.import_module("fxtpu_torch.ops.fx_xstage")
G = xs.XSTAGE_GROUP


def _triangle(nch, autos=True):
    return np.asarray(baseline_pairs(nch, autos),
                      dtype=np.int32).reshape(-1, 2)


def _lists(nch, seed):
    """(name, pairs) of the pair lists a row map must take: the triangle
    with and without autos, permuted, a sparse third with half its pairs
    flipped, and every ordered pair (both orders of each cross pair)."""
    rng = np.random.default_rng(seed)
    full = _triangle(nch)
    sparse = full[rng.choice(len(full), max(1, len(full) // 3),
                             replace=False)]
    flip = rng.random(len(sparse)) < 0.5
    sparse[flip] = sparse[flip][:, ::-1]
    ordered = np.stack(np.meshgrid(np.arange(nch), np.arange(nch),
                                   indexing="ij"), -1).reshape(-1, 2)
    return (("full", full), ("noautos", _triangle(nch, False)),
            ("permuted", full[rng.permutation(len(full))]),
            ("sparse", sparse), ("ordered", ordered.astype(np.int32)))


def _entry_takes(p, nch, s, nbins, k):
    """``launch_xstage``'s and ``launch_tiled``'s checks of a tiled plan
    (True: the kernel launches), and the instance's kU (tail units and T
    sums a thread)."""
    ng = -(-nch // G)
    halves = ng % 2 == 0 and ng >= 8
    tiles = ng * ng // 2 if halves else ng * (ng + 1) // 2
    split = tiles // p.slots
    units = ng // 2 * 16 * p.tile // split if halves else 0
    need = -(-max(units, -(-nch // split) * p.tile) // p.threads)
    ok = (1 <= k <= 65535 and s >= 1 and 1 <= nch <= 255
          and 2 <= p.tile <= xs.XSTAGE_TILED_TILE
          and p.tile & (p.tile - 1) == 0 and nbins % p.tile == 0
          and p.frames >= 1 and p.frames & (p.frames - 1) == 0
          and p.threads % 32 == 0 and p.tile * p.slots <= p.threads
          <= xs.XSTAGE_TILED_THREADS and 2 <= p.stages <= 8
          and split in (1, 2) and split * p.slots == tiles
          and split == p.split and need <= xs.XSTAGE_MAX_UNITS)
    return ok, need


def _threads(p, nch):
    """The kernel's assignment, thread by thread of each CTA of a bin
    tile: ``(z, t, l, tile or None, [tail units], [T channels])`` with a
    tile ``(d, gp, gq)`` and a unit ``(tt, sub)``."""
    ng = -(-nch // G)
    half = ng // 2
    tail = p.slots * p.split * 2 < ng * (ng + 1)
    units = (half * 16 * p.tile) // p.split if tail else 0
    cs = -(-nch // p.split)
    _, ku = _entry_takes(p, nch, 1, p.tile, 1)
    out = []
    for z in range(p.split):
        for t in range(p.threads):
            l, own = t % p.tile, t // p.tile < p.slots
            slot = t // p.tile + z * p.slots
            d, gp = divmod(slot, ng)
            tile = (d, gp, (gp + d) % ng) if own else None
            unit, chans = [], []
            for m in range(ku):
                v = t + m * p.threads
                if v < units:
                    rest = (z * units + v) // p.tile
                    unit.append((rest % half, rest // half))
                c = z * cs + v // p.tile
                if c < min(nch, (z + 1) * cs):
                    chans.append(c)
            out.append((z, t, l, tile, unit, chans))
    return out


def _writes(p, nch):
    """Every product the kernel writes: ``(l, pc, qc, conj)`` (the bin in
    the tile, the pair as formed, whether the row takes its conjugate)
    and every T and GJ channel ``(l, c)``."""
    pairs, sums = [], []
    for _, _, l, tile, units, chans in _threads(p, nch):
        if tile is not None:
            d, gp, gq = tile
            for i in range(G):
                for j in range(G):
                    pc, qc = gp * G + i, gq * G + j
                    if d > 0 or i <= j:
                        pairs.append((l, pc, qc, False))
                    if d > 0 or i < j:
                        pairs.append((l, pc, qc, True))
        half = -(-nch // G) // 2
        for tt, sub in units:
            for u in range(4):
                pc = tt * G + 2 * (sub % 4) + u // 2
                qc = (tt + half) * G + 2 * (sub // 4) + u % 2
                pairs += [(l, pc, qc, False), (l, pc, qc, True)]
        sums += [(l, c) for c in chans]
    return pairs, sums


# --- the plan ------------------------------------------------------------------

@pytest.mark.parametrize("nch", range(1, xs.XSTAGE_TILED_MAX_NCH + 1))
def test_xstage_plan_picks_the_instance_by_shape(nch):
    """The tiled instance from XSTAGE_TILED_NCH channels on and wherever
    the rows pass what one CTA of the row instance holds; a row instance
    below, 8 channels (array8's) among them; the two planners behind
    xstage_plan."""
    tri = nch * (nch + 1) // 2
    for nbins, s, k in ((4096, 64, 3), (256, 16, 1), (8192, 32, 2)):
        p = xs.xstage_plan(nch, tri, s, nbins, k)
        assert p.tiled == (nch >= xs.XSTAGE_TILED_NCH), p
        want = (xs.tiled_plan(nch, s, nbins, k) if p.tiled
                else xs.row_plan(nch, tri, s, nbins, k))
        assert p == want
        if not p.tiled:
            assert p.rows in xs.XSTAGE_ROW_THREADS and p.split == 1
    assert not xs.xstage_plan(8, 36, 64, 4096, 3).tiled
    # a list longer than the row instance holds takes the tiled one
    many = xs.XSTAGE_ROW_CAPACITY
    assert xs.xstage_plan(min(nch, 40), many, 64, 4096, 1).tiled


@pytest.mark.parametrize("nch", range(9, xs.XSTAGE_TILED_MAX_NCH + 1))
def test_tiled_plan_is_taken_by_its_entry_and_fits(nch):
    """Every tiled plan at the bin counts, frames and blocks the wide
    route takes: the entry's checks hold, the ring of at least 2 stages
    and the block's means fit a CTA, and its chunks cover every frame."""
    ng = -(-nch // G)
    for nbins in (256, 512, 1024, 4096, 8192, 16384):
        for s in (3, 20, 64, 256):
            for k in (1, 3, 8):
                p = xs.tiled_plan(nch, s, nbins, k)
                what = f"{p} for nch={nch} S={s} nbins={nbins} K={k}"
                ok, _ = _entry_takes(p, nch, s, nbins, k)
                assert ok, what
                frame = ng * p.tile * xs.XSTAGE_BIN_STRIDE * 8
                assert p.shared_bytes == p.stages * p.frames * frame \
                    + nch * 8, what
                assert p.shared_bytes <= MAX_SHARED_BYTES, what
                chunks = -(-s // p.frames)
                assert (chunks - 1) * p.frames < s <= chunks * p.frames
                assert p.ctas(nbins, k) == nbins // p.tile * k * p.split
    with pytest.raises(ValueError, match="tiled instance"):
        xs.tiled_plan(137, 64, 4096, 1)


def test_tiled_plan_at_meerkat_and_64_channels():
    """MeerKAT's block (128 channels, 64 frames of 4096 bins, K = 3): 8
    warps, the 64 whole-diagonal tiles of each half of the 16 groups' 128
    on each of two CTAs at a tile of 4 bins, the half diagonal's 8 tiles
    in the tail, one unit and one T sum a thread; 64 channels: one CTA of
    32 tiles at 8 bins, two units and sums a thread."""
    p = xs.xstage_plan(128, 8256, 64, 4096, 3)
    assert (p.tile, p.slots, p.rows, p.threads, p.split) == (4, 64, 64, 256,
                                                             2)
    assert _entry_takes(p, 128, 64, 4096, 3) == (True, 1)
    assert p.ctas(4096, 3) == 6144
    p = xs.xstage_plan(64, 2080, 64, 4096, 3)
    assert (p.tile, p.slots, p.threads, p.split) == (8, 32, 256, 1)
    assert _entry_takes(p, 64, 64, 4096, 3) == (True, 2)


@pytest.mark.parametrize("nch", [36, 40, 47, 48, 64, 65, 72, 96, 100, 127,
                                 128])
def test_tiled_assignment_covers_every_pair_and_sum_once(nch):
    """Over a bin tile's CTAs, every ordered pair (p, q) of channels below
    nch gets one write at every bin of the tile, the channels past nch
    none that lands in a row, and every channel one T and GJ sum a bin."""
    for nbins, k in ((4096, 3), (256, 1)):
        p = xs.tiled_plan(nch, 64, nbins, k)
        pairs, sums = _writes(p, nch)
        got = np.zeros((p.tile, nch, nch), int)
        for l, pc, qc, conj in pairs:
            if pc < nch and qc < nch:
                if conj:
                    got[l, qc, pc] += 1
                else:
                    got[l, pc, qc] += 1
        assert (got == 1).all(), (p, np.argwhere(got != 1)[:4])
        t = np.zeros((p.tile, nch), int)
        for l, c in sums:
            t[l, c] += 1
        assert (t == 1).all(), p


# --- the row map ----------------------------------------------------------------

@pytest.mark.parametrize("nch", [1, 8, 36, 65, 128])
def test_row_map_is_the_inverse_of_the_pair_list(nch):
    """Entry [p, q] is the row of (p, q) and -1 where the list has none,
    padded to whole groups of 8; kept on the pair tensor and built again
    after the tensor changes in place."""
    side = -(-nch // G) * G
    for name, pairs in _lists(nch, nch):
        pt = torch.from_numpy(pairs.copy())
        m = xs.row_map(pt, nch)
        assert m.dtype == torch.int32 and m.shape == (side, side), name
        want = np.full((side, side), -1, np.int32)
        want[pairs[:, 0], pairs[:, 1]] = np.arange(len(pairs))
        np.testing.assert_array_equal(m.numpy(), want, err_msg=name)
        assert xs.row_map(pt, nch) is m
    if nch > 1:
        pt = torch.from_numpy(_triangle(nch, False))
        m = xs.row_map(pt, nch)
        pt[0] = torch.tensor([1, 0], dtype=torch.int32)
        m2 = xs.row_map(pt, nch)
        assert m2 is not m and m2[1, 0].item() == 0 and m2[0, 1] == -1


def test_row_map_refuses_a_pair_listed_twice():
    pairs = torch.tensor([[0, 1], [1, 1], [0, 1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="twice"):
        xs.row_map(pairs, 2)
    # both orders of a pair are two pairs
    pairs = torch.tensor([[0, 1], [1, 0]], dtype=torch.int32)
    assert xs.row_map(pairs, 2).tolist()[:2] == [[-1, 0, -1, -1, -1, -1,
                                                  -1, -1],
                                                 [1, -1, -1, -1, -1, -1,
                                                  -1, -1]]


# --- a plain mirror of the tiled kernel ----------------------------------------

def _mirror(spec, pairs, da, p):
    """The tiled kernel's sums and writes in numpy: each thread's tile,
    tail units and T and GJ sums at its bin of every bin tile, products
    summed over the frames in order, written through the row map (direct,
    conjugated, autos with no imaginary part); every output element
    written once (a row or bin written twice or never is NaN)."""
    k, nch, s, nbins = spec.shape
    ng = -(-nch // G)
    side, half = ng * G, ng // 2
    nbl, halo = pairs.shape[0], da.shape[0]
    rmap = xs.row_map(torch.from_numpy(pairs), nch).numpy()
    pad = np.zeros((k, side, s, nbins), np.complex64)
    pad[:, :nch] = spec
    out = np.zeros((k, nbl + 2 * nch, nbins), np.complex64)
    seen = np.zeros((nbl + 2 * nch, nbins), int)

    def put(row, l, val):
        out[:, row, l::p.tile] = val
        seen[row, l::p.tile] += 1

    def sums(pc, qc, l):
        a = pad[:, pc][..., l::p.tile]          # [K, len(pc), S, tiles]
        b = pad[:, qc][..., l::p.tile]
        acc = np.zeros((k, len(pc), len(qc), a.shape[-1]), np.complex64)
        for f in range(s):
            acc += a[:, :, None, f] * np.conj(b[:, None, :, f])
        return acc

    for _, _, l, tile, units, chans in _threads(p, nch):
        if tile is not None:
            d, gp, gq = tile
            pc, qc = np.arange(gp * G, gp * G + G), np.arange(gq * G,
                                                              gq * G + G)
            acc = sums(pc, qc, l)
            for i in range(G):
                for j in range(G):
                    v = acc[:, i, j]
                    if (d > 0 or i <= j) and rmap[pc[i], qc[j]] >= 0:
                        put(rmap[pc[i], qc[j]], l,
                            v.real if pc[i] == qc[j] else v)
                    if (d > 0 or i < j) and rmap[qc[j], pc[i]] >= 0:
                        put(rmap[qc[j], pc[i]], l, np.conj(v))
        for tt, sub in units:
            pc = tt * G + 2 * (sub % 4) + np.arange(2)
            qc = (tt + half) * G + 2 * (sub // 4) + np.arange(2)
            acc = sums(pc, qc, l)
            for i in range(2):
                for j in range(2):
                    if rmap[pc[i], qc[j]] >= 0:
                        put(rmap[pc[i], qc[j]], l, acc[:, i, j])
                    if rmap[qc[j], pc[i]] >= 0:
                        put(rmap[qc[j], pc[i]], l, np.conj(acc[:, i, j]))
        for c in chans:
            x = pad[:, c, :, l::p.tile]
            put(nbl + c, l, x.sum(axis=1, dtype=np.complex64))
            put(nbl + nch + c, l, (x[:, :halo] * np.conj(
                da[:, l::p.tile])).sum(axis=1, dtype=np.complex64))
    out[:, seen != 1] = np.nan
    return out


@pytest.mark.parametrize("nch,k,nbins", [(36, 1, 256), (48, 2, 512),
                                         (64, 1, 256), (65, 2, 256),
                                         (128, 1, 512)])
def test_tiled_mirror_matches_plain_version(nch, k, nbins):
    """The mirror walked by the plan at 36 to 128 channels, over every
    pair list the row map takes: each row within 1e-6 of its scale of
    fx_xstage_reference, the autos' imaginary parts 0."""
    s = 6
    rng = np.random.default_rng(nch + k)
    spec = (rng.normal(size=(k, nch, s, nbins))
            + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    da = (rng.normal(size=(3, nbins))
          + 1j * rng.normal(size=(3, nbins))).astype(np.complex64)
    p = xs.tiled_plan(nch, s, nbins, k)
    for name, pairs in _lists(nch, nch):
        if name == "ordered" and nch > 64:
            continue
        got = _mirror(spec, pairs, da, p)
        want = xs.fx_xstage_reference(torch.from_numpy(spec),
                                      torch.from_numpy(pairs),
                                      torch.from_numpy(da)).numpy()
        assert np.isfinite(got).all(), name
        err = np.abs(got - want).max(axis=-1)
        scale = np.abs(want).max(axis=-1)
        assert (err <= 1e-6 * scale).all(), (name, (err / scale).max())
        autos = pairs[:, 0] == pairs[:, 1]
        assert (got[:, :len(pairs)][:, autos].imag == 0).all(), name


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _held(got, want, what):
    g = got.reshape(-1, got.shape[-1])
    w = want.reshape(-1, want.shape[-1])
    scale = w.abs().amax(dim=-1).clamp_min(1e-30)
    err = ((g - w).abs().amax(dim=-1) / scale).max().item()
    assert err <= 2e-5, f"{what}: {err:.3g} of scale > 2e-5"


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("kind", ["permuted", "sparse"])
@pytest.mark.parametrize("nch", [48, 64, 65, 96, 128])
def test_cuda_tiled_kernel_on_pair_lists(cuda_device, nch, kind, k):
    """fx_xstage on the tiled instance against its plain version: 2e-5 of
    each row's scale, the autos' imaginary parts exactly 0, one launch
    counted on ``fx_xstage`` and ``fx_xstage.tiled`` with the plan's
    CTAs."""
    s, nbins = 20, 512
    rng = np.random.default_rng(nch * k)
    pairs = dict(_lists(nch, nch))[kind]
    spec = torch.from_numpy(
        (rng.normal(size=(k, nch, s, nbins))
         + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    ).to(cuda_device)
    da = torch.from_numpy((rng.normal(size=(3, nbins)) + 1j * rng.normal(
        size=(3, nbins))).astype(np.complex64)).to(cuda_device)
    pt = pairs_tensor(pairs, nch, cuda_device)
    plan = xs.xstage_plan(nch, len(pairs), s, nbins, k)
    assert plan.tiled
    before = (xs.fx_xstage.launches, xs.fx_xstage.tiled, xs.fx_xstage.ctas)
    got = xs.fx_xstage(spec, pt, da)
    want = xs.fx_xstage_reference(spec, pt, da)
    torch.cuda.synchronize()
    assert (xs.fx_xstage.launches, xs.fx_xstage.tiled,
            xs.fx_xstage.ctas) == (before[0] + 1, before[1] + 1,
                                   before[2] + plan.ctas(nbins, k))
    _held(got, want, f"{kind} K={k}")
    autos = torch.from_numpy(pairs[:, 0] == pairs[:, 1]).to(cuda_device)
    assert not bool((got[:, :len(pairs)][:, autos].imag != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nch", [48, 64])
def test_cuda_tiled_fold_equals_the_row_instance(cuda_device, nch, int8):
    """With ``x`` set (the wide route's step), the tiled and the row
    instance over the same spectra and sample sums: mu and the new history
    bit for bit, the parts within 2e-5 of each row's scale."""
    from fxtpu_torch.cuda_build import check, load_kernels
    lib = load_kernels()
    k, s, nbins, halo, n_groups = 2, 16, 256, 3, 4
    rng = np.random.default_rng(nch + 7)
    pt = pairs_tensor(_triangle(nch), nch, cuda_device)
    nbl = pt.shape[0]
    spec = torch.from_numpy(
        (rng.normal(size=(k, nch, s, nbins))
         + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    ).to(cuda_device)
    da = torch.from_numpy((rng.normal(size=(halo, nbins)) + 1j * rng.normal(
        size=(halo, nbins))).astype(np.complex64)).to(cuda_device)
    if int8:
        x = torch.from_numpy(rng.integers(-100, 100, size=(
            nch, k, s, nbins, 2)).astype(np.int8)).to(cuda_device)
        sums = torch.from_numpy(rng.integers(-10**6, 10**6, size=(
            k, n_groups, nch, 2))).to(cuda_device)
        hist = torch.empty((nch, halo, nbins, 2), dtype=torch.int8,
                           device=cuda_device)
    else:
        x = torch.from_numpy((rng.normal(size=(nch, k, s, nbins)) + 1j
                              * rng.normal(size=(nch, k, s, nbins))).astype(
            np.complex64)).to(cuda_device)
        sums = torch.from_numpy(rng.normal(size=(k, n_groups, nch, 2))).to(
            cuda_device)
        hist = torch.empty((nch, halo, nbins), dtype=torch.complex64,
                           device=cuda_device)
    outs = {}
    for name, plan, rmap in (
            ("row", xs.row_plan(nch, nbl, s, nbins, k), None),
            ("tiled", xs.tiled_plan(nch, s, nbins, k),
             xs.row_map(pt, nch))):
        parts = torch.empty((k, nbl + 2 * nch, nbins),
                            dtype=torch.complex64, device=cuda_device)
        mu = torch.empty((k, nch), dtype=torch.complex64, device=cuda_device)
        new = torch.empty_like(hist)
        entry = lib.fxt_xstage_i8 if int8 else lib.fxt_xstage
        extra = (1.0 / 32,) if int8 else ()
        rc = entry(spec.data_ptr(), pt.data_ptr(),
                   None if rmap is None else rmap.data_ptr(), da.data_ptr(),
                   parts.data_ptr(), x.data_ptr(), sums.data_ptr(),
                   mu.data_ptr(), new.data_ptr(), nch, k, s, nbins, nbl,
                   halo, n_groups, *plan.args(), *extra,
                   torch.cuda.current_stream().cuda_stream)
        check(lib, rc, f"fxt_xstage ({name})")
        outs[name] = (parts, mu, new)
    torch.cuda.synchronize()
    (pr, mr, hr), (pg, mg, hg) = outs["row"], outs["tiled"]
    assert torch.equal(mg, mr) and torch.equal(hg, hr)
    _held(pg, pr, "parts")
