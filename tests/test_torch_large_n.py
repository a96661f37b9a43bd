"""The single pass past 128 channels: the wide route to
fxtpu_torch.ops.fx_fused.MAX_WIDE_NCHAN = 512 inputs (LEDA's 256
dual-polarisation antennas, 131,328 pairs with autos).  The X kernel's
band instance (fx_xstage.band_plan: a CTA a pair of bands of 64 channels)
takes the pairs past 128 channels, the epilogue's narrow pair-tiled
instance (16 bins a tile) past 433, its one-bin-a-thread instance
(CONTINUUM) is refused past 65,535 rows, and a launch takes one block
where one block passes the caps on K.

On the CPU: FxEngine on the fused route's plain versions at 136 and 160
channels, in both ingests, against the benchmark's tiled float64
reference (fxbench.reference.fx_tiled); the plans at 129 to 512 channels
against the card's limits; a plain mirror of the band instance's
assignment of tiles and T and GJ sums to threads and CTAs, which writes
every row once and agrees with fx_xstage_reference; and the plans of the
benchmark's four cells as they were before the band instance.  On a card
(marked ``cuda``): the X kernel, the epilogue and the engine at 256 and
512 channels against their plain versions, and one launch of each whose
last pair lies past 2^31 float elements.

Shapes on the CPU: 256 bins (the smallest bin count the kernels take),
2^12-sample blocks.  Tolerances, as tests/test_torch_many_inputs.py's:
2e-5 of each spectrum's scale (3e-5 for 8-bit samples), fxtpu's bound
(tests/test_planes.py:318); the kernels 2e-5 of each row's scale against
their plain versions, as tests/test_torch_xstage_tiled.py and
tests/test_torch_finish_tiled.py hold them; the mirror 1e-6 (float32 sums
of the same products in frame order against torch's sum).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxbench.reference import fx as ref_fx  # noqa: E402
from fxbench.reference import fx_tiled  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.ops import fx_epilogue as fe  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402

xs = importlib.import_module("fxtpu_torch.ops.fx_xstage")
G, B = xs.XSTAGE_GROUP, xs.XSTAGE_BAND

NBINS, NSAMP = 256, 2**12
STEP = 1.0 / 32
#: LEDA's block (fxbench/configs/leda512.json): 512 inputs with autos, 64
#: frames of 4096 bins, 4 taps.
LEDA = dict(nch=512, nbl=131328, s=64, nbins=4096, ntaps=4)


def _engine(nch, ingest, device="cpu", nbins=NBINS, num_samp=NSAMP):
    cfg = CorrelatorConfig(nchan=nch, include_autos=True, nbins=nbins,
                           num_samp=num_samp, clamp_num_samp=False,
                           mode="SPECTRUM", ingest_dtype=ingest,
                           quant_step=STEP, device=device)
    return FxEngine(cfg, fused=True if device == "cpu" else None)


def _stream(nch, nblocks, seed, nsamp=NSAMP):
    """``[nblocks, nch, nsamp]`` complex64 with a DC offset per channel."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(nblocks, nch, nsamp))
         + 1j * rng.normal(size=(nblocks, nch, nsamp))) * 0.5
    x += (0.03 - 0.02j) * (1 + np.arange(nch) % 5)[None, :, None]
    return x.astype(np.complex64)


def _quantized(x):
    planes = np.stack([x.real, x.imag], axis=-1) / STEP
    return np.clip(np.rint(planes), -127, 127).astype(np.int8)


def _held(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max(axis=-1)
    assert err.max() <= tol, f"{what}: {err.max()}"


# --- the engine on the CPU ---------------------------------------------------

@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("nch", [136, 160])
def test_engine_past_128_channels_matches_the_tiled_reference(nch, ingest):
    """Two chained blocks through the fused route's plain versions on the
    wide route (every pair with autos), each against the tiled reference
    in float64 from the block and the one before it."""
    eng = _engine(nch, ingest)
    assert eng.fused_active and eng.x_stage == "global"
    assert eng.int8_native == (ingest == "int8")
    assert len(eng.pairs) == nch * (nch + 1) // 2
    w2d = ref_fx.prototype(4, NBINS)
    pairs = ref_fx.baselines(nch, True)
    np.testing.assert_array_equal(pairs, eng.pairs)
    delays = 1e-7 * (np.arange(nch) % 7 - 3)
    packed = torch.as_tensor(pack_delays(delays, eng.cfg.frequency))
    x = _stream(nch, 2, seed=nch)
    blocks = _quantized(x) if ingest == "int8" else x
    ref = [ref_fx.dequantize(torch.from_numpy(b), STEP)
           if ingest == "int8" else torch.from_numpy(b) for b in blocks]
    hist = eng.fresh_history()
    tol = 3e-5 if ingest == "int8" else 2e-5
    for j, blk in enumerate(blocks):
        vis, hist = eng.step(eng.prepare_block(blk), packed, hist)
        want = fx_tiled.fx_block(ref[j], ref[j - 1] if j else None, w2d,
                                 pairs, delays, eng.cfg.bandwidth,
                                 eng.cfg.frequency,
                                 tile_bytes=16 << 20).numpy()
        _held(vis.numpy(), want, tol, f"block {j}")


def test_engine_counts_the_x_stage_s_spectra_reads():
    """Past 128 channels the wide route's counters name the X stage's
    launches, CTAs, spectra reads and register-tiled launches, and the
    epilogue's; on the CPU the plain versions count none."""
    eng = _engine(136, "int8")
    counts = eng.launch_counts()
    assert list(counts) == ["fx_fused_parts_i8.wide_launches", "fx_xstage",
                            "fx_xstage.ctas", "fx_xstage.spectra_reads",
                            "fx_xstage.tiled", "fx_finish",
                            "fx_finish.tiled"]
    blk = _quantized(_stream(136, 1, seed=3))[0]
    eng.step(eng.prepare_block(blk), torch.zeros(136), eng.fresh_history())
    assert eng.launch_counts() == counts


# --- the plans past 128 channels ---------------------------------------------

def _band_pair(z, nb):
    """Band pair z -> (P, Q), P <= Q, row by row of the triangle (the
    kernel's decode)."""
    bp, bq = 0, z
    while bq >= nb - bp:
        bq -= nb - bp
        bp += 1
    return bp, bq + bp


def _bands_take(p, nch, s, nbins, k):
    """``launch_xstage``'s and ``launch_bands``' checks of a band plan
    (True: the kernel launches)."""
    return (1 <= k <= 65535 and s >= 1 and nch >= 1
            and p.rows == xs.XSTAGE_BAND_ROWS and p.tile in (2, 4)
            and nbins % p.tile == 0 and nbins // p.tile <= 65535
            and p.frames >= 1 and p.frames & (p.frames - 1) == 0
            and p.slots == xs.XSTAGE_BAND_SLOTS
            and p.threads == p.tile * p.slots and p.threads % 32 == 0
            and p.threads <= xs.XSTAGE_TILED_THREADS
            and 2 <= p.stages <= 8)


@pytest.mark.parametrize("nch", [129, 256, 433, 434, 512])
def test_plans_fit_the_card_past_128_channels(nch):
    """At LEDA's block shape (64 frames of 4096 bins, 4 taps), with autos:
    the X kernel's band plan within 8 warps, a CTA's shared memory and the
    entry's checks, its CTAs the band pairs' times the bin tiles, each
    spectrum byte read by the bands' count; the epilogue's plan within a
    CTA's shared memory, every pair in its chunks; K = 1 (past the caps)
    with the block's buffers under MAX_BLOCK_BYTES."""
    s, nbins, ntaps = LEDA["s"], LEDA["nbins"], LEDA["ntaps"]
    nbl = nch * (nch + 1) // 2
    assert ff.supported_parts(nbins, ntaps, nch, s)
    assert ff.x_route(nbins, ntaps, nch) == "global"
    k = ff.max_blocks_parts(s, nbins, nch, nbl, ntaps=ntaps)
    assert k >= 1
    p = xs.xstage_plan(nch, nbl, s, nbins, k)
    ng = -(-nch // G)
    nb = -(-ng // B)
    assert p.bands and p.tiled and p == xs.band_plan(nch, s, nbins, k)
    assert _bands_take(p, nch, s, nbins, k), p
    assert p.tile == 4 and p.threads == 256
    assert p.split == nb * (nb + 1) // 2 and p.reads == nb
    frame = 2 * B * p.tile * xs.XSTAGE_BIN_STRIDE * 8
    assert p.shared_bytes == p.stages * p.frames * frame + nch * 8
    assert p.shared_bytes <= ff.MAX_SHARED_BYTES
    assert p.ctas(nbins, k) == nbins // p.tile * k * p.split
    f = fe.finish_plan(nch, nbl, nbins, k)
    assert f.tiled and f.tile == fe.finish_tile(nch)
    assert f.tile == (fe.FINISH_TILE if nch <= 433 else fe.FINISH_NARROW_TILE)
    assert nch * (2 * f.tile + 3) * 8 <= ff.MAX_SHARED_BYTES
    chunks = -(-nbl // f.chunk)
    assert (chunks - 1) * f.chunk < nbl <= chunks * f.chunk
    assert chunks <= 65535
    layout = ff._layout("global", k, nch, s, nbins, ntaps, nbl, True)[2]
    assert sum(np.prod(shape) * dt.itemsize
               for _, shape, dt in layout) <= ff.MAX_BLOCK_BYTES


def test_leda_block_is_one_launch_of_one_block():
    """LEDA's block passes both caps on K (131,328 pairs > 65,535; 1 GiB
    of spectra and its sums > 1 GiB) and takes one block a launch: 36 CTAs
    a bin tile of 4 bins, each spectrum byte read 8 times; the narrow
    epilogue, every pair in one chunk.  A block whose buffers would pass
    MAX_BLOCK_BYTES is refused (0)."""
    nch, nbl, s, nbins = LEDA["nch"], LEDA["nbl"], LEDA["s"], LEDA["nbins"]
    assert nbl > ff.MAX_BLOCKS
    assert nch * s * nbins * 8 >= ff.MAX_LAUNCH_PARTIAL_BYTES
    assert ff.max_blocks_parts(s, nbins, nch, nbl, ntaps=4) == 1
    p = xs.xstage_plan(nch, nbl, s, nbins, 1)
    assert (p.tile, p.slots, p.rows, p.frames, p.stages, p.threads,
            p.split, p.reads) == (4, 64, xs.XSTAGE_BAND_ROWS, 8, 3, 256, 36,
                                  8)
    assert p.ctas(nbins, 1) == 36 * 1024
    assert fe.finish_plan(nch, nbl, nbins, 1) == fe.FinishPlan(
        nbl, fe.FINISH_NARROW_TILE)
    # 2^14 frames of 4096 bins: 32 GiB of spectra alone
    assert ff.max_blocks_parts(2**14, nbins, nch, nbl, ntaps=4) == 0


@pytest.mark.parametrize("nch,autos,k,takes", [
    (361, True, 1, True),       # 65,341 rows
    (362, True, 1, False),      # 65,703
    (362, False, 1, True),      # 65,341
    (256, True, 2, False),      # 2 x 32,896
    (512, True, 1, False),      # LEDA's 131,328
])
def test_continuum_is_refused_past_the_one_bin_rows(nch, autos, k, takes):
    """CONTINUUM takes the one-bin-a-thread instance, whose K nbl rows are
    at most MAX_FINISH_ROWS: past them the epilogue's check refuses the
    launch, where SPECTRUM's pair-tiled plan takes the same shape."""
    nbl = nch * (nch - 1) // 2 + (nch if autos else 0)
    plan = fe.finish_plan(nch, nbl, 4096, k, continuum=True)
    assert plan == fe.BIN_PLAN
    assert (k * nbl <= fe.MAX_FINISH_ROWS) == takes
    if takes:
        fe._check_rows(plan, k, nbl)
    else:
        with pytest.raises(ValueError, match="MAX_FINISH_ROWS"):
            fe._check_rows(plan, k, nbl)
    spectrum = fe.finish_plan(nch, nbl, 4096, k)
    assert spectrum.tiled
    fe._check_rows(spectrum, k, nbl)


@pytest.mark.parametrize("nch", [129, 136, 200, 256, 433, 512])
def test_band_assignment_covers_every_pair_and_sum_once(nch):
    """Over a bin tile's CTAs, every ordered pair (p, q) of channels below
    nch gets one write at every bin of the tile, and every channel one T
    and GJ sum a bin (the kernel's assignment, walked in Python)."""
    for nbins, k in ((4096, 1), (256, 1)):
        p = xs.band_plan(nch, 64, nbins, k)
        pairs, sums = _band_writes(p, nch)
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


def _band_threads(p, nch):
    """The band kernel's assignment, thread by thread of each CTA of a bin
    tile: ``(l, tile or None, T channel or None)``, a tile ``(d, gp,
    gq)``."""
    ng = -(-nch // G)
    nb = -(-ng // B)
    out = []
    for z in range(p.split):
        bp, bq = _band_pair(z, nb)
        diag = bp == bq
        ncp = min(B * G, nch - bp * B * G)
        for t in range(p.threads):
            l, slot = t % p.tile, t // p.tile
            ti, tj = divmod(slot, B)
            gp, gq = bp * B + ti, bq * B + tj
            own = gp < ng and gq < ng and (not diag or ti <= tj)
            chan = bp * B * G + slot if diag and slot < ncp else None
            out.append((l, (gq - gp, gp, gq) if own else None, chan))
    return out


def _band_writes(p, nch):
    """Every product the kernel writes, ``(l, pc, qc, conj)``, and every T
    and GJ channel ``(l, c)``."""
    pairs, sums = [], []
    for l, tile, chan in _band_threads(p, nch):
        if tile is not None:
            d, gp, gq = tile
            for i in range(G):
                for j in range(G):
                    pc, qc = gp * G + i, gq * G + j
                    if d > 0 or i <= j:
                        pairs.append((l, pc, qc, False))
                    if d > 0 or i < j:
                        pairs.append((l, pc, qc, True))
        if chan is not None:
            sums.append((l, chan))
    return pairs, sums


def _band_mirror(spec, pairs, da, p):
    """The band kernel's sums and writes in numpy: each thread's tile and
    T and GJ sum at its bin of every bin tile, products summed over the
    frames in order, written through the row map (direct, conjugated,
    autos with no imaginary part); an element written twice or never is
    NaN."""
    k, nch, s, nbins = spec.shape
    side = -(-nch // G) * G
    nbl, halo = pairs.shape[0], da.shape[0]
    rmap = xs.row_map(torch.from_numpy(pairs), nch).numpy()
    pad = np.zeros((k, side, s, nbins), np.complex64)
    pad[:, :nch] = spec
    out = np.zeros((k, nbl + 2 * nch, nbins), np.complex64)
    seen = np.zeros((nbl + 2 * nch, nbins), int)

    def put(row, l, val):
        out[:, row, l::p.tile] = val
        seen[row, l::p.tile] += 1

    for l, tile, chan in _band_threads(p, nch):
        if tile is not None:
            d, gp, gq = tile
            pc, qc = np.arange(gp * G, gp * G + G), np.arange(gq * G,
                                                              gq * G + G)
            a = pad[:, pc][..., l::p.tile]
            b = pad[:, qc][..., l::p.tile]
            acc = np.zeros((k, G, G, a.shape[-1]), np.complex64)
            for f in range(s):
                acc += a[:, :, None, f] * np.conj(b[:, None, :, f])
            for i in range(G):
                for j in range(G):
                    v = acc[:, i, j]
                    if (d > 0 or i <= j) and rmap[pc[i], qc[j]] >= 0:
                        put(rmap[pc[i], qc[j]], l,
                            v.real if pc[i] == qc[j] else v)
                    if (d > 0 or i < j) and rmap[qc[j], pc[i]] >= 0:
                        put(rmap[qc[j], pc[i]], l, np.conj(v))
        if chan is not None:
            x = pad[:, chan, :, l::p.tile]
            put(nbl + chan, l, x.sum(axis=1, dtype=np.complex64))
            put(nbl + nch + chan, l, (x[:, :halo] * np.conj(
                da[:, l::p.tile])).sum(axis=1, dtype=np.complex64))
    out[:, seen != 1] = np.nan
    return out


@pytest.mark.parametrize("kind", ["full", "sparse"])
def test_band_mirror_matches_plain_version(kind):
    """The mirror walked by the band plan at 136 channels (3 bands, the
    last ragged, and a ragged group), over the full triangle and a
    permuted sparse third with half its pairs flipped: each row within
    1e-6 of its scale of fx_xstage_reference, the autos' imaginary parts
    0."""
    nch, k, s, nbins = 136, 1, 3, 8
    rng = np.random.default_rng(nch)
    spec = (rng.normal(size=(k, nch, s, nbins))
            + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    da = (rng.normal(size=(3, nbins))
          + 1j * rng.normal(size=(3, nbins))).astype(np.complex64)
    pairs = np.asarray(baseline_pairs(nch, True), np.int32).reshape(-1, 2)
    if kind == "sparse":
        pairs = pairs[rng.choice(len(pairs), len(pairs) // 3,
                                 replace=False)]
        flip = rng.random(len(pairs)) < 0.5
        pairs[flip] = pairs[flip][:, ::-1]
    p = xs.band_plan(nch, s, nbins, k)
    got = _band_mirror(spec, pairs, da, p)
    want = xs.fx_xstage_reference(torch.from_numpy(spec),
                                  torch.from_numpy(pairs),
                                  torch.from_numpy(da)).numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    assert (err <= 1e-6 * scale).all(), (err / scale).max()
    autos = pairs[:, 0] == pairs[:, 1]
    assert (got[:, :len(pairs)][:, autos].imag == 0).all()


def test_kernel_constants_are_the_plan_s():
    """The band instance's constants in csrc/fx_xstage.cu are the plan's."""
    import re
    from pathlib import Path
    src = (Path(xs.__file__).resolve().parent.parent / "csrc"
           / "fx_xstage.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src)[1]

    assert int(const("kBand")) == B
    assert const("kBandSlots") == "kBand * kBand"
    assert const("kBandRows") == "2 * kTiledRows"
    assert xs.XSTAGE_BAND_ROWS == 2 * xs.XSTAGE_TILED_ROWS
    assert "case kBandRows: return launch_bands<T>" in src


# --- the benchmark's cells keep their plans ------------------------------------

#: cell -> (nch, autos, K, ingest, X plan (tile, slots, rows, frames,
#: stages, threads, split, reads) or None, the epilogue's (tiled, tile,
#: chunk), the route, n_groups, per): the plans of BENCHMARK.json's four
#: cells (64 frames of 4096 bins, 4 taps) as they were before the band
#: instance and the narrow epilogue.
CELL_PLANS = {
    "array8.engine_int8": (8, True, 32, "int8", (32, 8, 8, 16, 3, 256, 1, 1),
                           (True, 32, 36), "global", 64, 1),
    "meerkat_l4k.engine128_int8": (128, True, 3, "int8",
                                   (4, 64, 64, 8, 3, 256, 2, 2),
                                   (True, 32, 8256), "global", 64, 1),
    "effex2.engine": (2, False, 64, "complex64", None, (False, 256, 0),
                      "shared", 64, 1),
    "effex2.live_spectrum": (2, False, 1, "complex64", None,
                             (False, 256, 0), "shared", 64, 1),
}


@pytest.mark.parametrize("cell", list(CELL_PLANS))
def test_the_cells_plans_are_unchanged(cell):
    """Each cell's single-pass plan (route, K, groups), X plan and
    epilogue plan as recorded, and its K the one its engine takes
    (``dispatch_batch_for`` of the mix's blocks)."""
    nch, autos, k, ingest, xplan, fplan, route, n_groups, per = \
        CELL_PLANS[cell]
    s, nbins, ntaps = 64, 4096, 4
    w2d = pfb_window(ntaps, nbins, "hamming").reshape(ntaps, nbins)
    pairs_np = baseline_pairs(nch, autos)
    pt = ff.pairs_tensor(pairs_np, nch, "cpu")
    if ingest == "int8":
        x = torch.empty((nch, k, s, nbins, 2), dtype=torch.int8)
        hist = {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                    dtype=torch.int8),
                "mu_prev": torch.zeros(nch, dtype=torch.complex64)}
    else:
        x = torch.empty((nch, k, s, nbins), dtype=torch.complex64)
        hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64)
    plan = fe.check_step(
        x, hist, torch.as_tensor(np.asarray(w2d, np.float32)), pt,
        dc_constants(w2d, nbins, s, "cpu"),
        torch.as_tensor(pack_delays(np.zeros((k, nch)), 1.4204e9)),
        fe.FinishTables(pairs_np, nbins, 2.4e6, 1.4204e9, "cpu"), 2.4e6,
        False, STEP if ingest == "int8" else None)
    assert (plan.route, plan.k, plan.n_groups, plan.per) == (
        route, k, n_groups, per)
    got = None if plan.xplan is None else (
        *plan.xplan.args(), plan.xplan.split, plan.xplan.reads)
    assert got == xplan
    assert not (plan.xplan is not None and plan.xplan.bands)
    f = plan.finish_plan
    assert (f.tiled, f.tile, f.chunk) == fplan
    most = ff.max_blocks_parts(s, nbins, nch, len(pairs_np), ntaps=ntaps)
    assert k <= most


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _rand(shape, device, gen):
    return torch.view_as_complex(torch.randn((*shape, 2), generator=gen,
                                             device=device))


def _plain_x(spec, pairs, da, per=4096):
    """fx_xstage_reference with the pairs in chunks of ``per`` (its gather
    of every pair at once would take 17 GB at 512 channels and 4096
    bins)."""
    nbl = pairs.shape[0]
    rows = [xs.fx_xstage_reference(spec, pairs[i:i + per], da)[:, :len(
        pairs[i:i + per])] for i in range(0, nbl, per)]
    tail = xs.fx_xstage_reference(spec, pairs[:1], da)[:, 1:]
    return torch.cat(rows + [tail], dim=1)


def _row_error(got, want):
    scale = want.abs().amax(dim=-1).clamp_min(1e-30)
    return ((got - want).abs().amax(dim=-1) / scale).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("nch,k,s,nbins", [
    (256, 1, 16, 4096), (512, 1, 8, 256), (512, 2, 4, 4096),
    (200, 3, 20, 512)])
def test_cuda_band_kernel(cuda_device, nch, k, s, nbins):
    """The X kernel's band instance alone against its plain version over
    every pair with autos: 2e-5 of each row's scale, the autos' imaginary
    parts exactly 0; one launch, its CTAs, its spectra reads and one
    register-tiled launch counted."""
    gen = torch.Generator(device=cuda_device).manual_seed(nch + k)
    spec = _rand((k, nch, s, nbins), cuda_device, gen)
    da = _rand((3, nbins), cuda_device, gen)
    pairs = baseline_pairs(nch, True)
    pt = ff.pairs_tensor(pairs, nch, cuda_device)
    plan = xs.xstage_plan(nch, len(pairs), s, nbins, k)
    assert plan.bands
    f = xs.fx_xstage
    before = (f.launches, f.ctas, f.spectra_reads, f.tiled)
    got = xs.fx_xstage(spec, pt, da)
    want = _plain_x(spec, pt, da)
    torch.cuda.synchronize()
    assert (f.launches, f.ctas, f.spectra_reads, f.tiled) == (
        before[0] + 1, before[1] + plan.ctas(nbins, k),
        before[2] + plan.reads, before[3] + 1)
    err = _row_error(got, want)
    assert err <= 2e-5, err
    autos = torch.from_numpy(pairs[:, 0] == pairs[:, 1]).to(cuda_device)
    assert not bool((got[:, :len(pairs)][:, autos].imag != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("continuum", [False, True])
@pytest.mark.parametrize("nch", [256, 512])
def test_cuda_epilogue_past_433_channels(cuda_device, nch, continuum):
    """The epilogue at 256 and 512 channels against its plain version, 2e-5
    of each row's scale: SPECTRUM at K = 3 on the pair-tiled instance (its
    narrow tile at 512), through its entry and launched alone; CONTINUUM
    at K = 1 on the one-bin-a-thread instance at 256 channels (32,896
    rows), and refused at 512 (131,328 rows, past MAX_FINISH_ROWS)."""
    k, s, nbins = (1 if continuum else 3), 16, 256
    gen = torch.Generator(device=cuda_device).manual_seed(nch)
    pairs_np = baseline_pairs(nch, True)
    nbl = len(pairs_np)
    parts = _rand((k, nbl + 2 * nch, nbins), cuda_device, gen) * s
    rng = np.random.default_rng(nch)
    w2d = pfb_window(4, nbins, "hamming").reshape(4, nbins)
    a = dict(xp=parts[:, :nbl], T=parts[:, nbl:nbl + nch],
             GJ=parts[:, nbl + nch:],
             mu=0.1 * _rand((k, nch), cuda_device, gen),
             pairs=ff.pairs_tensor(pairs_np, nch, cuda_device),
             consts=dc_constants(w2d, nbins, s, cuda_device),
             delays=torch.as_tensor(pack_delays(
                 rng.uniform(-8, 8, (k, nch)) / 98.304e6, 49.152e6),
                 dtype=torch.float32, device=cuda_device),
             tables=fe.FinishTables(pairs_np, nbins, 98.304e6, 49.152e6,
                                    cuda_device),
             n_frames=s, bandwidth=98.304e6, continuum=continuum,
             mu_prev=0.1 * _rand((nch,), cuda_device, gen))
    plan = fe.finish_plan(nch, nbl, nbins, k, continuum)
    if continuum and k * nbl > fe.MAX_FINISH_ROWS:
        with pytest.raises(ValueError, match="MAX_FINISH_ROWS"):
            fe.fx_finish(**a)
        return
    want = fe.fx_finish_reference(**a)
    assert plan.tiled != continuum
    if not continuum:
        assert plan.tile == fe.finish_tile(nch)
    for got in (fe.fx_finish(**a), fe.finish_launch(plan, **a)):
        torch.cuda.synchronize()
        if continuum:
            scale = (want.abs().max().clamp_min(1e-30)).item()
            err = ((got - want).abs().max() / scale).item()
        else:
            err = _row_error(got, want)
        assert err <= 2e-5, (plan, err)


@pytest.mark.cuda
def test_cuda_last_pair_past_2_31_floats(cuda_device):
    """LEDA's shape at K = 2 (512 channels, 64 frames of 4096 bins): the X
    kernel's parts and the epilogue's visibilities hold 2 x 132,352 and 2
    x 131,328 rows of 4096 complex64, past 2^31 floats; the last pair's
    row of the last block, its T and GJ rows, and its visibilities agree
    with their plain versions over that pair alone (2e-5 of scale)."""
    nch, nbl, s, nbins, k = 512, 131328, 64, 4096, 2
    gen = torch.Generator(device=cuda_device).manual_seed(26)
    spec = _rand((k, nch, s, nbins), cuda_device, gen)
    da = _rand((3, nbins), cuda_device, gen)
    pairs_np = baseline_pairs(nch, True)
    pt = ff.pairs_tensor(pairs_np, nch, cuda_device)
    parts = xs.fx_xstage(spec, pt, da)
    last = pt[-1:]
    assert 2 * (k * (nbl + 2 * nch) - 1) * nbins > 2**31
    want = xs.fx_xstage_reference(spec, last, da)
    torch.cuda.synchronize()
    got = torch.cat([parts[:, nbl - 1:nbl], parts[:, nbl:]], dim=1)
    assert _row_error(got, want) <= 2e-5
    del spec, want, got
    w2d = pfb_window(4, nbins, "hamming").reshape(4, nbins)
    common = dict(T=parts[:, nbl:nbl + nch], GJ=parts[:, nbl + nch:],
                  mu=0.1 * _rand((k, nch), cuda_device, gen),
                  consts=dc_constants(w2d, nbins, s, cuda_device),
                  delays=torch.zeros((k, nch), device=cuda_device),
                  n_frames=s, bandwidth=98.304e6, continuum=False,
                  mu_prev=0.1 * _rand((nch,), cuda_device, gen))
    plan = fe.finish_plan(nch, nbl, nbins, k)
    assert plan.tile == fe.FINISH_NARROW_TILE
    vis = fe.finish_launch(
        plan, xp=parts[:, :nbl], pairs=pt,
        tables=fe.FinishTables(pairs_np, nbins, 98.304e6, 49.152e6,
                               cuda_device), **common)
    one = fe.fx_finish_reference(
        xp=parts[:, nbl - 1:nbl], pairs=last,
        tables=fe.FinishTables(pairs_np[-1:], nbins, 98.304e6, 49.152e6,
                               cuda_device), **common)
    torch.cuda.synchronize()
    assert 2 * (k * nbl - 1) * nbins > 2**31
    assert _row_error(vis[:, -1:], one) <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [256, 512])
def test_cuda_engine_past_128_channels(cuda_device, nch):
    """FxEngine with 'auto' on the card: the wide route with int8-native
    ingest and the kernels; K = 1 (K nbl would pass 65,535); each of two
    chained multi_step calls is one launch of each kernel (the band X
    instance, its spectra reads, the epilogue's pair-tiled instance) and
    agrees with the tiled reference within 3e-5 of scale."""
    eng = _engine(nch, "int8", device="cuda")
    assert eng.kernel_active and eng.int8_native and eng.x_stage == "global"
    blocks = _quantized(_stream(nch, 2, seed=nch))
    assert eng.dispatch_batch_for(2) == 1
    d = torch.zeros((1, nch), device=cuda_device)
    plan = xs.xstage_plan(nch, len(eng.pairs), NSAMP // NBINS, NBINS, 1)
    assert plan.bands
    w2d = ref_fx.prototype(4, NBINS)
    pairs = ref_fx.baselines(nch, True)
    ref = [ref_fx.dequantize(torch.from_numpy(b).to(cuda_device), STEP)
           for b in blocks]
    hist = eng.fresh_history()
    for j, blk in enumerate(blocks):
        before = eng.launch_counts()
        vis, hist = eng.multi_step(eng.prepare_batch([blk]), d, hist)
        torch.cuda.synchronize()
        after = eng.launch_counts()
        moved = {n: after[n] - before[n] for n in after}
        assert moved == {"fx_fused_parts_i8.wide_launches": 1,
                         "fx_xstage": 1,
                         "fx_xstage.ctas": plan.ctas(NBINS, 1),
                         "fx_xstage.spectra_reads": plan.reads,
                         "fx_xstage.tiled": 1, "fx_finish": 1,
                         "fx_finish.tiled": 1}
        want = fx_tiled.fx_block(ref[j], ref[j - 1] if j else None, w2d,
                                 pairs, [0.0] * nch, eng.cfg.bandwidth,
                                 eng.cfg.frequency)
        _held(vis[0].cpu().numpy(), want.cpu().numpy(), 3e-5, f"block {j}")
