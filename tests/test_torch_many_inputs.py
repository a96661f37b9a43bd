"""The single pass past 64 channels: the wide route to 128 inputs
(MeerKAT's 64 dual-polarisation dishes, 8,256 pairs with autos), whose
pairs the X kernel's register-tiled instance takes (fx_xstage.xstage_plan,
from XSTAGE_TILED_NCH channels to XSTAGE_TILED_MAX_NCH; past it, to
fxtpu_torch.ops.fx_fused.MAX_WIDE_NCHAN = 512, tests/test_torch_large_n.py).

On the CPU: FxEngine on the fused route's plain versions at 65 and 96
channels, in both ingests, against the benchmark's tiled float64
reference (fxbench.reference.fx_tiled) and against fxtpu's plain step;
xstage_plan's row instance unchanged below XSTAGE_TILED_NCH channels and
its tiled instance from there, past 64 channels too; the routes, the K
cap and the counters.  On a card (marked
``cuda``): the X kernel, the wide route's kernels and the engine at 65,
96 and 128 channels against their plain versions.

Shapes: 256 bins (the smallest bin count the kernels take,
fx_fused.kernel_bins), 2^12-sample blocks.  Tolerances, as the rest of
the suite: 2e-5 of each spectrum's scale (3e-5 for 8-bit samples),
fxtpu's bound (tests/test_planes.py:318); the kernels against their plain
versions as tests/test_torch_fx_wide.py holds them.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxbench.reference import fx as ref_fx  # noqa: E402
from fxbench.reference import fx_tiled  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine, _resolve_fused  # noqa: E402
from fxtpu_torch.ops import fx_fused  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.fx_fused import (MAX_FUSED_NCHAN,  # noqa: E402
                                      MAX_SHARED_BYTES, MAX_WIDE_NCHAN,
                                      max_blocks_parts, pairs_tensor,
                                      supported_parts, x_route)
from fxtpu_torch.ops.fx_xstage import (XSTAGE_TILED_MAX_NCH,  # noqa: E402
                                       XSTAGE_TILED_NCH, XSTAGE_TILED_ROWS,
                                       XSTAGE_TILED_THREADS, fx_xstage,
                                       fx_xstage_reference, xstage_plan)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402

NBINS, NSAMP = 256, 2**12
STEP = 1.0 / 32


def _engine(nch, ingest, device="cpu"):
    cfg = CorrelatorConfig(nchan=nch, include_autos=True, nbins=NBINS,
                           num_samp=NSAMP, clamp_num_samp=False,
                           mode="SPECTRUM", ingest_dtype=ingest,
                           quant_step=STEP, device=device)
    return FxEngine(cfg, fused=True if device == "cpu" else None)


def _stream(nch, nblocks, seed):
    """``[nblocks, nch, NSAMP]`` complex64 with a DC offset per channel."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(nblocks, nch, NSAMP))
         + 1j * rng.normal(size=(nblocks, nch, NSAMP))) * 0.5
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
@pytest.mark.parametrize("nch", [65, 96])
def test_engine_past_64_channels_matches_the_tiled_reference(nch, ingest):
    """Three chained blocks through the fused route's plain versions on
    the wide route (every pair with autos), each against the tiled
    reference in float64 from the block and the one before it."""
    eng = _engine(nch, ingest)
    assert eng.fused_active and eng.x_stage == "global"
    assert eng.int8_native == (ingest == "int8")
    assert len(eng.pairs) == nch * (nch + 1) // 2
    w2d = ref_fx.prototype(4, NBINS)
    pairs = ref_fx.baselines(nch, True)
    np.testing.assert_array_equal(pairs, eng.pairs)
    delays = 1e-7 * (np.arange(nch) % 7 - 3)
    packed = torch.as_tensor(pack_delays(delays, eng.cfg.frequency))
    x = _stream(nch, 3, seed=nch)
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
                                 tile_bytes=4 << 20).numpy()
        _held(vis.numpy(), want, tol, f"block {j}")


def test_engine_at_65_channels_matches_fxtpu_plain_step():
    """The same shape against fxtpu's plain step (its fused route stops at
    64 channels): three chained complex64 blocks."""
    jnp = pytest.importorskip("jax.numpy")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.fx import FxEngine as JEngine
    from fxtpu.ops.cplx import to_complex
    from fxtpu.ops.planes import pack_delays as jpack
    nch = 65
    kw = dict(num_samp=NSAMP, nbins=NBINS, clamp_num_samp=False,
              mode="SPECTRUM", nchan=nch, include_autos=True)
    jeng = JEngine(JConfig(**kw), fused=False)
    teng = _engine(nch, "complex64")
    assert teng.x_stage == "global"
    np.testing.assert_array_equal(np.asarray(jeng.pairs), teng.pairs)
    d = jpack(1e-7 * (np.arange(nch) % 7 - 3), jeng.cfg.frequency)
    jh, th = jeng.fresh_history(), teng.fresh_history()
    for j, blk in enumerate(_stream(nch, 3, seed=7)):
        jv, jh = jeng.step(jeng.prepare_block(blk), jnp.asarray(d), jh)
        tv, th = teng.step(teng.prepare_block(blk), torch.from_numpy(d), th)
        _held(tv.numpy(), to_complex(jv), 2e-5, f"block {j}")


# --- the X kernel's plan -----------------------------------------------------

#: xstage_plan's plans up to 64 channels: (nch, nbl, S, nbins, K) ->
#: (tile, slots, rows, frames, stages, threads, shared_bytes, split); the
#: row instance's at 8 channels, as before the tiled instance, which 36
#: and 64 channels take (rows 64: 15 and 32 tiles of 8 x 8 pairs).
PLANS_TO_64 = {
    (8, 28, 64, 4096, 1): (16, 16, 4, 16, 3, 256, 49216, 1),
    (8, 28, 64, 4096, 3): (32, 8, 8, 16, 3, 256, 98368, 1),
    (8, 28, 256, 4096, 63): (32, 8, 8, 16, 3, 256, 98368, 1),
    (8, 28, 32, 8192, 1): (32, 8, 8, 8, 3, 256, 49216, 1),
    (8, 28, 8, 256, 1): (2, 36, 2, 2, 3, 96, 832, 1),
    (8, 28, 1024, 512, 2): (4, 36, 2, 128, 3, 160, 98368, 1),
    (8, 36, 64, 4096, 1): (16, 16, 4, 16, 3, 256, 49216, 1),
    (8, 36, 64, 4096, 3): (32, 8, 8, 16, 3, 256, 98368, 1),
    (8, 36, 256, 4096, 63): (32, 8, 8, 16, 3, 256, 98368, 1),
    (8, 36, 32, 8192, 1): (32, 8, 8, 8, 3, 256, 49216, 1),
    (8, 36, 8, 256, 1): (2, 44, 2, 2, 3, 96, 832, 1),
    (8, 36, 1024, 512, 2): (4, 44, 2, 128, 3, 192, 98368, 1),
    (36, 630, 64, 4096, 1): (8, 15, 64, 16, 3, 160, 153888, 1),
    (36, 630, 64, 4096, 3): (8, 15, 64, 16, 3, 160, 153888, 1),
    (36, 630, 256, 4096, 63): (8, 15, 64, 16, 3, 160, 153888, 1),
    (36, 630, 32, 8192, 1): (8, 15, 64, 8, 3, 160, 77088, 1),
    (36, 630, 8, 256, 1): (2, 15, 64, 2, 3, 64, 5088, 1),
    (36, 630, 1024, 512, 2): (4, 15, 64, 32, 3, 96, 153888, 1),
    (36, 666, 64, 4096, 1): (8, 15, 64, 16, 3, 160, 153888, 1),
    (36, 666, 64, 4096, 3): (8, 15, 64, 16, 3, 160, 153888, 1),
    (36, 666, 256, 4096, 63): (8, 15, 64, 16, 3, 160, 153888, 1),
    (36, 666, 32, 8192, 1): (8, 15, 64, 8, 3, 160, 77088, 1),
    (36, 666, 8, 256, 1): (2, 15, 64, 2, 3, 64, 5088, 1),
    (36, 666, 1024, 512, 2): (4, 15, 64, 32, 3, 96, 153888, 1),
    (64, 2016, 64, 4096, 1): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2016, 64, 4096, 3): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2016, 256, 4096, 63): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2016, 32, 8192, 1): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2016, 8, 256, 1): (2, 32, 64, 2, 3, 64, 8192, 1),
    (64, 2016, 1024, 512, 2): (4, 32, 64, 16, 3, 128, 123392, 1),
    (64, 2080, 64, 4096, 1): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2080, 64, 4096, 3): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2080, 256, 4096, 63): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2080, 32, 8192, 1): (8, 32, 64, 8, 3, 256, 123392, 1),
    (64, 2080, 8, 256, 1): (2, 32, 64, 2, 3, 64, 8192, 1),
    (64, 2080, 1024, 512, 2): (4, 32, 64, 16, 3, 128, 123392, 1),
}


def test_xstage_plan_is_unchanged_up_to_64_channels():
    """8, 36 and 64 channels, with and without autos: below
    XSTAGE_TILED_NCH the row instance and launch shape the port took
    before the tiled instance; from it the tiled instance's plan, the
    same with and without autos (it covers the triangle of groups)."""
    for shape, want in PLANS_TO_64.items():
        p = xstage_plan(*shape)
        assert (p.tile, p.slots, p.rows, p.frames, p.stages, p.threads,
                p.shared_bytes, p.split) == want, shape
        assert p.args() == want[:6], shape
        assert p.tiled == (shape[0] >= XSTAGE_TILED_NCH), shape


@pytest.mark.parametrize("nch", [65, 66, 80, 96, 127, XSTAGE_TILED_MAX_NCH])
def test_xstage_plan_tiles_the_rows_past_one_cta(nch):
    """Past 64 channels, with and without autos, the tiled instance: the
    triangle of ceil(nch / 8) groups' tiles of 8 x 8 pairs over one or two
    CTAs a bin tile (the half diagonal's tiles in the tail where the
    groups are even and at least 8), 8 warps at most, the ring within a
    CTA, the grid's CTAs the bin tiles' times the split
    (tests/test_torch_xstage_tiled.py holds every pair's write once).  At
    128 channels with autos: 16 groups, 128 whole-diagonal tiles on two
    CTAs of 64 at a tile of 4 bins, 256 threads."""
    ng = -(-nch // 8)
    tiles = ng * ng // 2 if ng % 2 == 0 and ng >= 8 else ng * (ng + 1) // 2
    for autos in (False, True):
        nbl = nch * (nch - 1) // 2 + (nch if autos else 0)
        for s, nbins, k in ((64, 4096, 3), (16, 256, 2), (3, 512, 1),
                            (256, 16384, 1)):
            p = xstage_plan(nch, nbl, s, nbins, k)
            what = f"{p} for nch={nch} nbl={nbl} S={s} nbins={nbins}"
            assert p.tiled and p.rows == XSTAGE_TILED_ROWS, what
            assert p.shared_bytes <= MAX_SHARED_BYTES, what
            assert p.threads <= XSTAGE_TILED_THREADS, what
            assert p.threads % 32 == 0 and p.threads >= p.tile * p.slots
            assert p.split in (1, 2) and p.slots * p.split == tiles, what
            assert p.ctas(nbins, k) == nbins // p.tile * k * p.split
    p = xstage_plan(128, 8256, 64, 4096, 3)
    assert (p.tile, p.slots, p.rows, p.threads, p.split) == (
        4, 64, XSTAGE_TILED_ROWS, 256, 2)


# --- routes, caps and counters -----------------------------------------------

def test_routes_and_caps_past_64_channels():
    """The shared route stops at 64 channels even where its bytes would
    fit (100 channels of 256 bins); the wide route takes up to 512 (past
    128 on the X kernel's band instance).  K is capped by the spectra
    scratch (3 blocks of 2^18 samples at 128 channels) and by K nbl <=
    65535 (7 blocks at 128 channels where the scratch would take more);
    past either cap (LEDA's 512 channels: 131,328 pairs, 1 GiB of spectra
    a block) a launch takes one block."""
    assert fx_fused.supported(256, 4, 100)
    assert x_route(256, 4, 100) == "global"
    with pytest.raises(ValueError, match="nch > 64"):
        x_route(256, 4, MAX_FUSED_NCHAN + 1, x_stage="shared")
    for nch in (65, 96, 128):
        assert supported_parts(4096, 4, nch, 64)
        assert x_route(4096, 4, nch) == "global"
    assert supported_parts(4096, 4, 129, 64)
    assert supported_parts(4096, 4, MAX_WIDE_NCHAN, 64)
    assert not supported_parts(4096, 4, MAX_WIDE_NCHAN + 1, 64)
    assert max_blocks_parts(64, 4096, 128, 8256, ntaps=4) == 3
    assert max_blocks_parts(64, 4096, 512, 131328, ntaps=4) == 1
    assert max_blocks_parts(16, 256, 128, 8256, ntaps=4) == 65535 // 8256
    assert max_blocks_parts(64, 4096, 8, 36, ntaps=4) == 63     # array8
    cuda = torch.device("cuda")
    assert _resolve_fused("auto", cuda, 4096, 4, 128, int8=True, s_rows=64)


def test_engine_counts_the_x_stage_s_row_tiles():
    """The wide route's counters name the X stage's launches, CTAs and
    launches of the tiled instance, and the epilogue's and its pair-tiled
    instance's (2,145 pairs); on the CPU the plain versions count none."""
    eng = _engine(65, "int8")
    counts = eng.launch_counts()
    assert list(counts) == ["fx_fused_parts_i8.wide_launches", "fx_xstage",
                            "fx_xstage.ctas", "fx_xstage.spectra_reads",
                            "fx_xstage.tiled", "fx_finish",
                            "fx_finish.tiled"]
    blk = _quantized(_stream(65, 1, seed=3))[0]
    eng.step(eng.prepare_block(blk), torch.zeros(65), eng.fresh_history())
    assert eng.launch_counts() == counts


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _spectra(k, nch, s, nbins, halo, device, seed):
    rng = np.random.default_rng(seed)
    spec = (rng.normal(size=(k, nch, s, nbins))
            + 1j * rng.normal(size=(k, nch, s, nbins))).astype(np.complex64)
    da = (rng.normal(size=(halo, nbins))
          + 1j * rng.normal(size=(halo, nbins))).astype(np.complex64)
    return torch.from_numpy(spec).to(device), torch.from_numpy(da).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("nch,k,s,nbins", [
    (65, 2, 20, 512), (96, 1, 16, 256), (128, 2, 8, 4096), (128, 1, 64, 256)])
def test_cuda_xstage_kernel_past_64_channels(cuda_device, nch, k, s, nbins):
    """The X kernel alone against its plain version on the tiled
    instance: 2e-5 of each row's scale, the autos' imaginary parts exactly
    0; one launch, its plan's CTAs and one tiled launch counted."""
    spec, da = _spectra(k, nch, s, nbins, 3, cuda_device, seed=nch + s)
    pairs = baseline_pairs(nch, True)
    pt = pairs_tensor(pairs, nch, cuda_device)
    plan = xstage_plan(nch, len(pairs), s, nbins, k)
    before = (fx_xstage.launches, fx_xstage.tiled, fx_xstage.ctas)
    got = fx_xstage(spec, pt, da)
    want = fx_xstage_reference(spec, pt, da)
    torch.cuda.synchronize()
    assert (fx_xstage.launches, fx_xstage.tiled, fx_xstage.ctas) == (
        before[0] + 1, before[1] + 1, before[2] + plan.ctas(nbins, k))
    g, w = got.cpu().numpy(), want.cpu().numpy()
    _held(g.reshape(-1, nbins), w.reshape(-1, nbins), 2e-5, "parts")
    autos = pairs[:, 0] == pairs[:, 1]
    np.testing.assert_array_equal(g[:, :len(pairs)][:, autos].imag, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("nch", [65, 96, 128])
def test_cuda_wide_parts_past_64_channels(cuda_device, nch, int8):
    """The wide route's frame kernel and X kernel (mu and the new history
    folded in by a bin tile's first CTA) against their plain version over
    two blocks:
    xp and T 2e-5 of scale (3e-5 for 8-bit samples), mu 1e-6, the int8
    tail exact, the complex64 tail 1e-6."""
    k, s, nbins, ntaps = 2, 16, 512, 4
    rng = np.random.default_rng(nch)
    w2d = pfb_window(ntaps, nbins).reshape(ntaps, nbins).astype(np.float32)
    wt = torch.from_numpy(w2d).to(cuda_device)
    pt = pairs_tensor(baseline_pairs(nch, True), nch, cuda_device)
    consts = dc_constants(w2d, nbins, s, cuda_device)
    if int8:
        x = torch.from_numpy(np.clip(np.rint(
            30 * rng.normal(size=(nch, k, s, nbins, 2)) + 2), -127, 127
        ).astype(np.int8)).to(cuda_device)
        hist = torch.from_numpy(np.clip(np.rint(
            30 * rng.normal(size=(nch, ntaps - 1, nbins, 2))), -127, 127
        ).astype(np.int8)).to(cuda_device)
        args = (x, hist, wt, pt, STEP, None, consts)
        fn, ref = (fx_fused.fx_fused_parts_i8,
                   fx_fused.fx_fused_parts_i8_wide_reference)
    else:
        x = torch.from_numpy((rng.normal(size=(nch, k, s, nbins))
                              + 1j * rng.normal(size=(nch, k, s, nbins))
                              + 0.03).astype(np.complex64)).to(cuda_device)
        hist = torch.from_numpy((rng.normal(size=(nch, ntaps - 1, nbins))
                                 + 0j).astype(np.complex64)).to(cuda_device)
        args = (x, hist, wt, pt, None, consts)
        fn, ref = (fx_fused.fx_fused_parts,
                   fx_fused.fx_fused_parts_wide_reference)
    got = fn(*args)
    want = ref(*args)
    torch.cuda.synchronize()
    tol = 3e-5 if int8 else 2e-5
    for name, g, w in zip(("xp", "T"), got, want):
        _held(g.cpu().numpy().reshape(-1, nbins),
              w.cpu().numpy().reshape(-1, nbins), tol, name)
    assert (got[3] - want[3]).abs().max() <= 1e-6 * max(
        1.0, want[3].abs().max().item())
    if int8:
        assert torch.equal(got[4], want[4])
    else:
        assert (got[4] - want[4]).abs().max() <= 1e-6


@pytest.mark.cuda
def test_cuda_engine_at_128_channels(cuda_device):
    """MeerKAT's width on the card: FxEngine with 'auto' takes the wide
    route with int8-native ingest; a 3-block multi_step call is one
    launch of each kernel, its X stage on the tiled instance and its
    epilogue on the pair-tiled one, and agrees with the tiled reference
    within 3e-5 of scale."""
    nch = 128
    eng = _engine(nch, "int8", device="cuda")
    assert eng.kernel_active and eng.int8_native and eng.x_stage == "global"
    x = _stream(nch, 3, seed=128)
    blocks = _quantized(x)
    k = eng.dispatch_batch_for(3)
    assert k == 3
    d = torch.zeros((k, nch), device=cuda_device)
    before = eng.launch_counts()
    vis, _ = eng.multi_step(eng.prepare_batch(list(blocks)), d,
                            eng.fresh_history())
    torch.cuda.synchronize()
    after = eng.launch_counts()
    moved = {n: after[n] - before[n] for n in after}
    plan = xstage_plan(nch, len(eng.pairs), NSAMP // NBINS, NBINS, k)
    assert moved == {"fx_fused_parts_i8.wide_launches": 1, "fx_xstage": 1,
                     "fx_xstage.ctas": plan.ctas(NBINS, k),
                     "fx_xstage.spectra_reads": plan.reads,
                     "fx_xstage.tiled": 1, "fx_finish": 1,
                     "fx_finish.tiled": 1}
    assert plan.tiled
    w2d = ref_fx.prototype(4, NBINS)
    pairs = ref_fx.baselines(nch, True)
    ref = [ref_fx.dequantize(torch.from_numpy(b).to(cuda_device), STEP)
           for b in blocks]
    for j in range(k):
        want = fx_tiled.fx_block(ref[j], ref[j - 1] if j else None, w2d,
                                 pairs, [0.0] * nch, eng.cfg.bandwidth,
                                 eng.cfg.frequency)
        _held(vis[j].cpu().numpy(), want.cpu().numpy(), 3e-5, f"block {j}")
