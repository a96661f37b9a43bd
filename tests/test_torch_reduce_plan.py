"""The single pass's parts reduce and the X kernel's launch plan:
fxtpu_torch.ops.fx_fused.parts_reduce (and its plain version
parts_reduce_reference) over the per-group partials the frame kernel
leaves, against the one-call plain version of the single pass and against
fxtpu.ops.pfb_pallas.fx_pallas_parts (interpret mode, as fxtpu's own tests
run it); fxtpu_torch.ops.fx_xstage.xstage_plan for every shape the port
takes, and a plain mirror of the X kernel's ring of stages walked by that
plan; chip_smoke.parts_reduce_bound against a count by hand; the CUDA
kernels against their plain versions on a card (marked ``cuda``).

Tolerances: the reduce against the one-call plain version 1e-6 of each
part's scale (the same float32 sums of the same spectra, grouped as the
frame kernel groups the frames), mu and the tail 1e-6 (the int8 tail
exact); against fxtpu 2e-5 of scale (fxtpu's bound,
tests/test_planes.py:318), its GJ as tests/test_torch_dc_posthoc.py holds
it; the kernel against the plain version bit for bit (the same additions
in the same order).  The X kernel's mirror against fx_xstage_reference
1e-6 of scale (frames summed in order against torch's sum); the kernel
against its plain version 2e-5 of each part's scale, as chip_smoke.py
holds it, the autos' imaginary parts exactly 0.
"""

import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.ops import fx_fused  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.fx_fused import (MAX_FUSED_NCHAN,  # noqa: E402
                                      MAX_SHARED_BYTES,
                                      fx_fused_parts_i8_reference,
                                      fx_fused_parts_reference, pairs_tensor,
                                      parts_reduce, parts_reduce_reference,
                                      supported_parts)
from fxtpu_torch.ops.fx_xstage import (fx_xstage,  # noqa: E402
                                       fx_xstage_reference, xstage_plan)
from fxtpu_torch.ops.pfb import dequantize  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402

# the module (fxtpu_torch.ops exports its wrapper under the same name)
xs = importlib.import_module("fxtpu_torch.ops.fx_xstage")
STEP = 1.0 / 32
ROOT = Path(__file__).resolve().parent.parent


def _window(ntaps, nbins):
    return pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)


def _blocks(nch, k, s, nbins, seed, int8):
    """K merged blocks with a small DC offset per channel and block."""
    rng = np.random.default_rng(seed)
    grade = np.arange(1, nch + 1)[:, None] + 0.5 * np.arange(k)[None, :]
    if int8:
        dc = np.array([3.0, -2.0]) * grade[..., None, None, None]
        return np.clip(np.rint(30 * rng.normal(size=(nch, k, s, nbins, 2))
                               + dc), -127, 127).astype(np.int8)
    return (rng.normal(size=(nch, k, s, nbins))
            + 1j * rng.normal(size=(nch, k, s, nbins))
            + (0.04 - 0.03j) * grade[..., None, None]).astype(np.complex64)


def _group_partials(x, hist, wt, pt, consts, int8):
    """What the frame kernel leaves for the reduce, in plain torch: the
    partials ``[K, n_groups, nbl + 2 nch, nbins]`` of each group of the
    single pass's plan (``fx_fused.plan_parts``): its frames' cross power
    and T, and GJ over its frames j < halo (the GJ rows of groups past the
    halo are NaN, as never written), and each group's sample sums ``[K,
    n_groups, nch, 2]``.  Returns (partial, sums, n_gj)."""
    nch, k, s, nbins = x.shape[:4]
    halo = wt.shape[0] - 1
    rows = dequantize(x, STEP) if int8 else x
    spec = fx_fused._raw_spectra(rows.reshape(nch, k * s, nbins),
                                 dequantize(hist, STEP) if int8 else hist,
                                 x.shape[:4], wt, None)
    nbl = pt.shape[0]
    plan = fx_fused.plan_parts(x, hist, wt, pt, None, consts,
                               STEP if int8 else None, "shared")
    n_groups, per = plan.n_groups, plan.per
    idx = pt.long()
    da = consts[1]
    partial = torch.full((k, n_groups, nbl + 2 * nch, nbins), float("nan"),
                         dtype=torch.complex64)
    sums = []
    xs_ = x.long() if int8 else torch.view_as_real(x).double()
    for g in range(n_groups):
        f = slice(g * per, min((g + 1) * per, s))
        sp = spec[:, :, f]
        partial[:, g, :nbl] = (sp[idx[:, 0]] * sp[idx[:, 1]].conj()).sum(
            dim=2).transpose(0, 1)
        partial[:, g, nbl:nbl + nch] = sp.sum(dim=2).transpose(0, 1)
        if g * per < halo:
            j = slice(g * per, min((g + 1) * per, halo))
            partial[:, g, nbl + nch:] = (spec[:, :, j] * da[j].conj()).sum(
                dim=2).transpose(0, 1)
        sums.append(xs_[:, :, f].sum(dim=(2, 3)))          # [nch, K, 2]
    sums = torch.stack(sums, dim=2).permute(1, 2, 0, 3).contiguous()
    return partial, sums, min(n_groups, -(-halo // per))


def _inputs(nch, autos, k, s, nbins, ntaps, int8, seed):
    w2d = _window(ntaps, nbins)
    wt = torch.from_numpy(w2d)
    pt = pairs_tensor(baseline_pairs(nch, autos), nch, "cpu")
    x = torch.from_numpy(_blocks(nch, k, s, nbins, seed, int8))
    hist = torch.from_numpy(
        _blocks(nch, 1, ntaps - 1, nbins, seed + 1, int8)[:, 0])
    return x, hist, wt, pt, dc_constants(w2d, nbins, s)


def _held(got, want, tol, what):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= tol * scale, f"{what}: {err / scale:.3g} of scale > {tol}"


# --- the parts reduce on the CPU -----------------------------------------------

@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nch,autos,k,s,ntaps", [
    (2, False, 2, 32, 4),     # one frame a group: 32 groups, GJ over 3
    (3, True, 1, 530, 4),     # 3 frames a group, the last one ragged
    (2, False, 1, 64, 16),    # 15 halo frames: GJ over 15 groups of 64
])
def test_reduce_reference_matches_parts_reference(nch, autos, k, s, ntaps,
                                                  int8):
    """The per-group partials of the plain frame version, in the frame
    kernel's grouping, through parts_reduce_reference give what the
    one-call plain version of the single pass gives."""
    nbins = 256
    x, hist, wt, pt, consts = _inputs(nch, autos, k, s, nbins, ntaps, int8,
                                      seed=10 * nch + s)
    partial, sums, n_gj = _group_partials(x, hist, wt, pt, consts, int8)
    assert n_gj < partial.shape[1]
    halo = ntaps - 1
    parts, mu, tail = parts_reduce_reference(partial, sums, x, n_gj, halo,
                                             STEP if int8 else None)
    if int8:
        want = fx_fused_parts_i8_reference(x, hist, wt, pt, STEP, None,
                                           consts)
    else:
        want = fx_fused_parts_reference(x, hist, wt, pt, None, consts)
    nbl = pt.shape[0]
    assert torch.isfinite(torch.view_as_real(parts)).all()
    for name, rows, w in (("xp", slice(0, nbl), want[0]),
                          ("T", slice(nbl, nbl + nch), want[1]),
                          ("GJ", slice(nbl + nch, None), want[2])):
        _held(parts[:, rows], w, 1e-6, name)
    assert (mu - want[3]).abs().max() <= 1e-6 * max(
        1.0, want[3].abs().max().item())
    if int8:
        assert torch.equal(tail, want[4])
    else:
        assert (tail - want[4]).abs().max() <= 1e-6


def test_reduce_reference_matches_fx_pallas_parts():
    """The reduce's parts over the plain frame version's partials against
    fxtpu's single pass, two chained complex64 blocks."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.ops.cplx import Cplx, from_complex, to_complex
    from fxtpu.ops.pfb_pallas import fx_pallas_parts
    nch, s, nbins, ntaps = 2, 32, 256, 4
    x, _, wt, pt, consts = _inputs(nch, False, 2, s, nbins, ntaps, False, 3)
    z = jnp.zeros((nch, ntaps - 1, nbins), jnp.float32)
    hj = Cplx(z, z)
    ht = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64)
    for blk in range(2):
        xb = x[:, blk:blk + 1].contiguous()
        jx, jt, jg, jmu, hj, _ = fx_pallas_parts(
            from_complex(xb[:, 0].numpy()[None]), jnp.asarray(wt.numpy()),
            nbins, hj, baseline_pairs(nch))
        partial, sums, n_gj = _group_partials(xb, ht, wt, pt, consts, False)
        parts, mu, ht = parts_reduce_reference(partial, sums, xb, n_gj,
                                               ntaps - 1)
        np.testing.assert_allclose(
            parts[:, :1].numpy(), to_complex(jx), rtol=0,
            atol=2e-5 * np.abs(to_complex(jx)).max())
        np.testing.assert_allclose(
            parts[:, 1:1 + nch].numpy()[..., 1:], to_complex(jt)[..., 1:],
            rtol=0, atol=2e-5 * np.abs(to_complex(jt)[..., 1:]).max())
        np.testing.assert_allclose(mu.numpy(), to_complex(jmu), atol=1e-6)
        np.testing.assert_allclose(ht.numpy(), to_complex(hj), atol=1e-6)


@pytest.mark.parametrize("int8", [False, True])
def test_parts_reduce_takes_plain_version_on_cpu(int8):
    x, hist, wt, pt, consts = _inputs(2, True, 2, 16, 256, 4, int8, 5)
    partial, sums, n_gj = _group_partials(x, hist, wt, pt, consts, int8)
    step = STEP if int8 else None
    n = parts_reduce.launches
    got = parts_reduce(partial, sums, x, n_gj, 3, step)
    want = parts_reduce_reference(partial, sums, x, n_gj, 3, step)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert parts_reduce.launches == n


def test_reduce_reference_adds_in_group_order():
    """The plain version's sums are the left fold over the groups, not
    another order: with values whose sum depends on the order, it gives
    ((a + b) + c) in float32."""
    x = torch.zeros((1, 1, 4, 2), dtype=torch.complex64)
    partial = torch.zeros((1, 3, 3, 2), dtype=torch.complex64)
    vals = torch.tensor([1.0, 1e8, -1e8], dtype=torch.float32)
    partial[0, :, 0, 0] = vals.to(torch.complex64)
    sums = torch.zeros((1, 3, 1, 2), dtype=torch.float64)
    parts, _, _ = parts_reduce_reference(partial, sums, x, 1, 1)
    assert parts[0, 0, 0].real.item() == ((vals[0] + vals[1]) + vals[2])
    assert parts[0, 0, 0].real.item() == 0.0


# --- the X kernel's plan -----------------------------------------------------

BIN_COUNTS = [1 << e for e in range(8, 14)]     # what supported_parts takes


def _entry_takes(p, nch, nbl, s, nbins, k, halo=3):
    """The checks ``launch_xstage`` and ``launch_rows`` in
    ``csrc/fx_xstage.cu`` make of a plan before they launch the plan's
    kernel instance (True: it launches)."""
    rows = nbl + 2 * nch
    return (1 <= k <= 65535 and s >= 1 and 1 <= nch <= 255 and nbl >= 0
            and 0 <= halo <= s and p.tile >= 2 and p.tile & (p.tile - 1) == 0
            and nbins % p.tile == 0 and p.frames >= 1
            and p.frames & (p.frames - 1) == 0 and p.slots >= 1
            and p.slots * p.rows >= rows and p.threads % 32 == 0
            and p.threads >= p.tile * p.slots and 2 <= p.stages <= 8
            and p.rows in xs.XSTAGE_ROW_THREADS
            and p.threads <= xs.XSTAGE_ROW_THREADS[p.rows])


def _check_tiled_plan(p, nch, s, nbins, k, what):
    """A plan of the register-tiled instance (from XSTAGE_TILED_NCH
    channels on): its tiles of 8 x 8 pairs cover the triangle of groups
    on 1 or 2 CTAs a bin tile, its threads within the instance's, its ring
    and means within a CTA, its chunks every frame
    (tests/test_torch_xstage_tiled.py holds its assignment to threads)."""
    ng = -(-nch // xs.XSTAGE_GROUP)
    tiles = (ng * ng // 2 if ng % 2 == 0 and ng >= 8
             else ng * (ng + 1) // 2)
    assert p.rows == xs.XSTAGE_TILED_ROWS and p.split in (1, 2), what
    assert p.slots * p.split == tiles, what
    assert p.tile * p.slots <= p.threads <= xs.XSTAGE_TILED_THREADS, what
    assert p.threads % 32 == 0 and nbins % p.tile == 0, what
    assert 2 <= p.tile <= xs.XSTAGE_TILED_TILE, what
    assert p.tile & (p.tile - 1) == 0 and p.frames & (p.frames - 1) == 0
    assert 2 <= p.stages <= 8, what
    assert p.shared_bytes == p.stages * p.frames * ng * p.tile * (
        xs.XSTAGE_BIN_STRIDE * 8) + nch * 8, what
    assert p.shared_bytes <= MAX_SHARED_BYTES, what
    chunks = -(-s // p.frames)
    assert (chunks - 1) * p.frames < s <= chunks * p.frames, what
    return p


def _check_plan(nch, nbl, s, nbins, k):
    p = xstage_plan(nch, nbl, s, nbins, k)
    rows = nbl + 2 * nch
    what = f"plan {p} for nch={nch} nbl={nbl} S={s} nbins={nbins} K={k}"
    if nch >= xs.XSTAGE_TILED_NCH:
        return _check_tiled_plan(p, nch, s, nbins, k, what)
    assert _entry_takes(p, nch, nbl, s, nbins, k, min(3, s)), what
    assert p.shared_bytes <= MAX_SHARED_BYTES, what
    assert p.shared_bytes == (p.stages * p.frames * p.tile + 1) * nch * 8, (
        what)                                    # the ring, the block's means
    assert 2 <= p.stages <= 8 and p.frames >= 1, what
    assert p.frames & (p.frames - 1) == 0, what
    # every bin: tiles of a power of two of at least 2 bins (16-byte
    # copies) that divide nbins
    assert p.tile >= 2 and p.tile & (p.tile - 1) == 0, what
    assert nbins % p.tile == 0, what
    # every frame, once: the last chunk holds the last frame
    chunks = -(-s // p.frames)
    assert (chunks - 1) * p.frames < s <= chunks * p.frames, what
    # every row, once, and every slot has a row; the instance is the
    # fewest rows a thread that hold them
    assert p.slots <= rows, what
    owned = (np.arange(p.slots)[:, None]
             + p.slots * np.arange(p.rows)[None, :]).ravel()
    assert np.array_equal(np.sort(owned[owned < rows]), np.arange(rows)), what
    assert p.rows == min(n for n, top in xs.XSTAGE_ROW_THREADS.items()
                         if n * p.slots >= rows and p.threads <= top), what
    assert p.threads - p.tile * p.slots < 32, what
    return p


@pytest.mark.parametrize("nch", range(1, MAX_FUSED_NCHAN + 1))
def test_xstage_plan_covers_and_fits(nch):
    """For every channel count and bin count the single pass takes, short
    and long blocks, one, two and many blocks, with and without autos: the
    entry takes the plan (the kernel instance it names takes its threads),
    the plan's ring fits a CTA with at least 2 stages, and its tiles,
    chunks and row slots (from XSTAGE_TILED_NCH channels on, the tiled
    instance's tiles of the triangle) cover every bin, frame and row
    once."""
    for nbins in BIN_COUNTS:
        for s in (3, 20, 64, 256, 1024):
            for k in (1, 2, 8):
                for autos in (False, True):
                    nbl = nch * (nch - 1) // 2 + (nch if autos else 0)
                    _check_plan(nch, nbl, s, nbins, k)


def test_xstage_plan_fills_the_card():
    """At the wide route's main-path shapes (the CLI at --nchan 8, 28
    pairs; bench.py's nchan8, 36 with autos) and the flagship block the
    grid reaches 256 CTAs (two an SM), 3 stages of at least 16 frames, 4
    rows a thread or fewer on 256 threads; 55 channels at 512 bins (1,540
    pairs with autos) and 64 channels with autos at 256 bins take the
    tiled instance at a tile of 2 bins: 28 and 32 tiles of 8 x 8 pairs,
    the grid's 256 and 128 CTAs as many as the bins allow."""
    for nch, nbl, s in ((8, 28, 64), (8, 36, 256), (2, 1, 64), (2, 1, 512)):
        p = _check_plan(nch, nbl, s, 4096, 1)
        assert 4096 // p.tile == 256, p
        assert p.stages == 3 and p.frames >= 16, p
        assert p.rows <= 4 and p.threads <= 256, p
    for nch, nbins, slots in ((55, 512, 28), (64, 256, 32)):
        p = _check_plan(nch, nch * (nch + 1) // 2, 8, nbins, 1)
        assert p.tiled and p.tile == 2 and p.slots == slots, p
        assert p.split == 1 and p.ctas(nbins, 1) == nbins // 2, p


def test_supported_parts_takes_the_plan_at_every_width():
    for nch in range(1, MAX_FUSED_NCHAN + 1):
        assert supported_parts(4096, 4, nch, 64)


def _mirror(spec, pairs, da, plan):
    """The X kernel walked by its plan in numpy: each chunk copied into
    its stage of the ring (a stage emptied to NaN first, so a frame read
    from a stage that was not filled shows) ``stages - 1`` chunks ahead,
    then every row summed over the chunk's frames in order."""
    k, nch, s, nbins = spec.shape
    tiles, tile, frames, stages = (nbins // plan.tile, plan.tile,
                                   plan.frames, plan.stages)
    nbl, halo = pairs.shape[0], da.shape[0]
    p, q = pairs[:, 0], pairs[:, 1]
    autos = p == q
    src = spec.reshape(k, nch, s, tiles, tile).transpose(0, 3, 1, 2, 4)
    ring = np.zeros((k, tiles, stages, nch, frames, tile), np.complex64)
    chunks = -(-s // frames)

    def issue(i):
        if i < chunks:
            f0 = i * frames
            nf = min(frames, s - f0)
            ring[:, :, i % stages] = np.nan
            ring[:, :, i % stages, :, :nf] = src[:, :, :, f0:f0 + nf]

    acc = np.zeros((k, nbl + 2 * nch, tiles, tile), np.complex64)
    dat = np.conj(da.reshape(halo, tiles, tile))
    for i in range(stages - 1):
        issue(i)
    for i in range(chunks):
        issue(i + stages - 1)
        at = ring[:, :, i % stages].transpose(0, 2, 3, 1, 4)
        for ff in range(min(frames, s - i * frames)):
            f = i * frames + ff
            v = at[:, :, ff]                                # [K, nch, tiles, tile]
            xp = v[:, p] * np.conj(v[:, q])
            xp[:, autos] = xp[:, autos].real
            acc[:, :nbl] += xp
            acc[:, nbl:nbl + nch] += v
            if f < halo:
                acc[:, nbl + nch:] += v * dat[f]
    return acc.reshape(k, nbl + 2 * nch, nbins)


@pytest.mark.parametrize("nch,autos,k,s,nbins", [
    (2, False, 1, 64, 4096),     # the flagship block, forced wide
    (2, True, 2, 20, 512),       # a ragged last chunk
    (8, False, 1, 64, 4096),     # the CLI at --nchan 8: 64 frames in 6 chunks
    (8, True, 2, 20, 512),
    (32, True, 1, 8, 256),       # 592 rows: a tile of 2 bins, 8 rows a thread
    (35, True, 1, 8, 512),       # 700 rows: the widest row instance
])
def test_xstage_mirror_matches_plain_version(nch, autos, k, s, nbins):
    rng = np.random.default_rng(nch + s)
    spec = (rng.normal(size=(k, nch, s, nbins))
            + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    da = (rng.normal(size=(3, nbins))
          + 1j * rng.normal(size=(3, nbins))).astype(np.complex64)
    pairs = np.asarray(baseline_pairs(nch, autos), dtype=np.int32)
    plan = xstage_plan(nch, pairs.shape[0], s, nbins, k)
    assert not plan.tiled
    got = torch.from_numpy(_mirror(spec, pairs, da, plan))
    want = fx_xstage_reference(torch.from_numpy(spec),
                               torch.from_numpy(pairs), torch.from_numpy(da))
    nbl = pairs.shape[0]
    assert torch.isfinite(torch.view_as_real(got)).all()
    for name, rows in (("xp", slice(0, nbl)), ("T", slice(nbl, nbl + nch)),
                       ("GJ", slice(nbl + nch, None))):
        _held(got[:, rows], want[:, rows], 1e-6, name)


# --- the smoke's bound ---------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_parts_reduce_bound_by_hand():
    """The flagship block: xp and T of 64 groups 3 x 4096 x 64 x 8 B, GJ of
    3 groups 2 x 4096 x 3 x 8, the sums 64 x 2 x 16, the history 2 x 3 x
    4096 x 8 in and out, the parts 5 x 4096 x 8 and mu 16 out: 7,047,184
    bytes.  bench_pipeline's block: 256 groups of 2 frames, GJ over 2:
    25,862,160 bytes.  Over 3.35 TB/s; 8-bit samples move 2 bytes a
    history sample."""
    cs = _chip_smoke()
    for case, k, int8, nbytes in (
            (cs.FLAGSHIP, 1, False, 6291456 + 196608 + 2048 + 393216
             + 163840 + 16),
            (cs.PIPELINE_BLOCK, 1, False, 25165824 + 131072 + 8192 + 393216
             + 163840 + 16),
            (cs.FLAGSHIP, 1, True, 6291456 + 196608 + 2048 + 98304
             + 163840 + 16),
            (cs.FLAGSHIP, 8, False, 8 * (6291456 + 196608 + 2048 + 163840
                                         + 16) + 393216)):
        ms, by = cs.parts_reduce_bound(case, k, int8)
        assert by == "bytes"
        assert ms == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert cs.parts_reduce_bound(cs.FLAGSHIP, 1)[0] == pytest.approx(
        2.1036e-3, rel=1e-4)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("s,n_groups", [(64, 64), (512, 256)])
def test_cuda_reduce_is_its_plain_version(cuda_device, s, n_groups, k, int8):
    """The reduce alone (fxt_parts_reduce, _i8) bit for bit against its
    plain version over the plain frame version's partials, 64 groups of
    one frame and 256 of two, the GJ rows of groups past the halo NaN
    (never written by the frame kernel, never read by the reduce)."""
    x, hist, wt, pt, consts = _inputs(2, False, k, s, 256, 4, int8, 60 + k)
    partial, sums, n_gj = _group_partials(x, hist, wt, pt, consts, int8)
    assert partial.shape[1] == n_groups
    args = [t.to(cuda_device) for t in (partial, sums, x)]
    step = STEP if int8 else None
    n = parts_reduce.launches
    got = parts_reduce(*args, n_gj, 3, step)
    want = parts_reduce_reference(*args, n_gj, 3, step)
    torch.cuda.synchronize()
    assert parts_reduce.launches == n + 1
    assert torch.isfinite(torch.view_as_real(got[0])).all()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("nch,autos,s,nbins", [
    (2, False, 64, 4096), (2, True, 20, 512), (8, False, 64, 4096),
    (8, True, 20, 512), (64, True, 64, 256), (64, False, 20, 256),
    (55, True, 20, 512), (48, False, 20, 256),
])
def test_cuda_xstage_kernel_on_its_plan(cuda_device, nch, autos, s, nbins):
    """The X kernel against its plain version at 2, 8 and 64 channels, 64
    frames and 20 (a ragged last chunk), two blocks; at 55 and 48
    channels; from XSTAGE_TILED_NCH channels on the tiled instance."""
    rng = np.random.default_rng(nch * s)
    k = 2
    spec = torch.from_numpy(
        (rng.normal(size=(k, nch, s, nbins))
         + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    ).to(cuda_device)
    da = torch.from_numpy((rng.normal(size=(3, nbins)) + 1j * rng.normal(
        size=(3, nbins))).astype(np.complex64)).to(cuda_device)
    pt = pairs_tensor(baseline_pairs(nch, autos), nch, cuda_device)
    got = fx_xstage(spec, pt, da)
    want = fx_xstage_reference(spec, pt, da)
    torch.cuda.synchronize()
    nbl = pt.shape[0]
    for name, rows in (("xp", slice(0, nbl)), ("T", slice(nbl, nbl + nch)),
                       ("GJ", slice(nbl + nch, None))):
        _held(got[:, rows], want[:, rows], 2e-5, name)
    auto = pt[:, 0] == pt[:, 1]
    assert not bool((got[:, :nbl][:, auto].imag != 0).any())


@pytest.mark.cuda
def test_cuda_xstage_refused_plan_raises(cuda_device, monkeypatch):
    """A plan the kernel does not take (one stage) is refused by the
    entry, and the wrapper raises: no other launch, no plain version."""
    good = xs.xstage_plan

    def one_stage(*args, **kw):
        p = good(*args, **kw)
        return xs.XStagePlan(p.tile, p.slots, p.rows, p.frames, 1,
                             p.threads, p.shared_bytes)

    monkeypatch.setattr(xs, "xstage_plan", one_stage)
    spec = torch.zeros((1, 2, 8, 256), dtype=torch.complex64,
                       device=cuda_device)
    da = torch.zeros((3, 256), dtype=torch.complex64, device=cuda_device)
    pt = pairs_tensor(baseline_pairs(2), 2, cuda_device)
    n = fx_xstage.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        fx_xstage(spec, pt, da)
    assert fx_xstage.launches == n
