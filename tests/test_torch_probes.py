"""The measurement path of the port, fxtpu_torch.probes, and the stage
ablation of the fused step (ops.fx_fused.fx_fused_ablate).

What is held against fxtpu and what is not.  fxtpu asserts of its ablated
kernels only that they build and give finite numbers
(tests/test_planes.py:797-816): a truncated TPU kernel is "wrong by
design" and has no reference.  The port defines every truncated result,
so here each stage's plain version is held to the port's own pieces:
``full`` to fx_fused_raw_reference exactly, ``fir`` to the X stage over
ops/pfb.py's FIR output (which tests/test_torch_ops.py holds against
fxtpu), the FFT stages to torch.fft.  The copy, overlap and layout probes
time hardware; of fxtpu's scripts they keep the byte accounting, which is
checked against each script's own formula at the script's constants, and,
for the one script whose output is a function of its input,
scripts/retile_probe.py, the checksum: the script is loaded as it stands,
run in interpret mode, and the port's plain checksum is held to its
output within 2e-5 of max|out| (both cast the samples to bf16 at the same
place and sum in float32; only the order of the sums differs).

The CUDA kernels are held to their plain versions on a card (the ``cuda``
marker): ``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_probes.py``.  JAX is imported only inside the tests that
need it."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch import probes  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.pfb import dequantize, pfb_fir, svd_fir  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs  # noqa: E402
from fxtpu_torch.probes import (common, copy_rate,  # noqa: E402
                                overlap, retile)

NBINS, NSAMP = 256, 2**13
STEP = 1.0 / 32
SCRIPTS = Path(__file__).resolve().parent.parent / "scripts"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _load_script(name):
    """One of fxtpu's measurement scripts, loaded as it stands."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        f"_fxtpu_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _merged_case(ingest, ntaps, k, fir, nch=2, seed=0, device="cpu"):
    """(x, history, window2d, pairs, quant_step, svd) of one K-block call,
    made with numpy from a seed: the merged batch with a DC offset per
    channel and block, and a non-zero history."""
    s = NSAMP // NBINS
    rng = np.random.default_rng(seed)
    w = pfb_window(ntaps, NBINS).reshape(ntaps, NBINS).astype(np.float32)
    svd = ff.svd_tensors(w, device) if fir == "svd" else None
    assert (svd is not None) == (fir == "svd")
    pairs = ff.pairs_tensor(baseline_pairs(nch, True), nch, device)
    grade = np.arange(1, nch + 1)[:, None] * np.arange(1, k + 1)[None, :]
    if ingest == "int8":
        x = np.clip(np.rint(30 * rng.normal(size=(nch, k, s, NBINS, 2))
                            + 3 * grade[..., None, None, None]), -127, 127)
        hist = {"tail": torch.as_tensor(rng.integers(
                    -90, 90, size=(nch, ntaps - 1, NBINS, 2)).astype(np.int8),
                    device=device),
                "mu_prev": torch.as_tensor(
                    np.array([0.1 - 0.05j, -0.02 + 0.07j], np.complex64)[:nch],
                    device=device)}
        return (torch.as_tensor(x.astype(np.int8), device=device), hist,
                torch.as_tensor(w, device=device), pairs, STEP, svd)
    x = (rng.normal(size=(nch, k, s, NBINS))
         + 1j * rng.normal(size=(nch, k, s, NBINS))
         + (0.3 - 0.2j) * grade[..., None, None])
    hist = (rng.normal(size=(nch, ntaps - 1, NBINS))
            + 1j * rng.normal(size=(nch, ntaps - 1, NBINS)))
    return (torch.as_tensor(x.astype(np.complex64), device=device),
            torch.as_tensor(hist.astype(np.complex64), device=device),
            torch.as_tensor(w, device=device), pairs, None, svd)


def _corrected_rows(x, hist, step):
    """[history; x] with every block's own mean removed (8-bit samples
    dequantized), as the frame kernel's rows: [nch, halo + K S, nbins]."""
    nch, k, s = x.shape[:3]
    if x.dtype == torch.int8:
        mu = torch.stack([ff.block_mean_i8(x[:, j], step) for j in range(k)],
                         dim=1)
        rows = dequantize(x, step) - mu[:, :, None, None]
        h = dequantize(hist["tail"], step) - hist["mu_prev"][:, None, None]
    else:
        rows = x - x.mean(dim=(-2, -1), keepdim=True)
        h = hist
    return torch.cat([h, rows.reshape(nch, k * s, NBINS)], dim=1)


def _cross(y, pairs, k):
    """The X stage over frames y [nch, K S, nbins] -> [K, nbl, nbins]."""
    nch = y.shape[0]
    y = y.reshape(nch, k, -1, y.shape[-1])
    idx = pairs.long()
    return (y[idx[:, 0]] * y[idx[:, 1]].conj()).sum(dim=-2).permute(1, 0, 2)


# --- the stage ablation's plain versions ---------------------------------

@pytest.mark.parametrize("n", [256, 512, 4096])   # even and odd stage counts
def test_all_stockham_stages_are_the_dft(n):
    rng = np.random.default_rng(n)
    x = torch.as_tensor((rng.normal(size=(3, n)) + 1j * rng.normal(size=(3, n))
                         ).astype(np.complex64))
    got = ff.stockham_stages(x, n.bit_length() - 1)
    want = torch.fft.fft(x.to(torch.complex128))
    # float32 butterflies against a float64 DFT
    assert (got - want).abs().max() <= 5e-6 * want.abs().max()
    assert torch.equal(ff.stockham_stages(x, 0), x)
    with pytest.raises(ValueError):
        ff.stockham_stages(x, n.bit_length())


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("ntaps,fir", [(4, "direct"), (32, "svd")])
def test_stage_full_is_the_fused_step_exactly(ingest, ntaps, fir):
    x, h, w, pairs, step, svd = _merged_case(ingest, ntaps, 1, fir)
    got = ff.fx_fused_ablate(x, h, w, pairs, "full", step, svd)
    if ingest == "int8":
        want, _ = ff.fx_fused_raw_i8_reference(x[:, 0].contiguous(), h, w,
                                               pairs, step, svd)
    else:
        want, _ = ff.fx_fused_raw_reference(x[:, 0].contiguous(), h, w,
                                            pairs, svd)
    assert got.shape == (1, len(pairs), NBINS)
    assert torch.equal(got[0], want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("ntaps,fir", [(4, "direct"), (32, "direct"),
                                       (32, "svd")])
def test_stage_fir_is_the_x_stage_over_the_pfb_fir(k, ingest, ntaps, fir):
    x, h, w, pairs, step, svd = _merged_case(ingest, ntaps, k, fir, seed=k)
    rows = _corrected_rows(x, h, step)
    y = pfb_fir(rows, w) if svd is None else svd_fir(rows, *svd)
    want = _cross(y, pairs, k)
    got = ff.fx_fused_ablate(x, h, w, pairs, "fir", step, svd)
    assert got.shape == (k, len(pairs), NBINS)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_load_stages_sum_the_tap_rows(k, ingest):
    """``load``: the unit-weight tap sum over the corrected rows;
    ``load_raw``: over the samples as they arrived, for 8-bit samples
    whole numbers, so the cross power is exact in float32."""
    ntaps = 4
    x, h, w, pairs, step, _ = _merged_case(ingest, ntaps, k, "direct", seed=7)
    s = NSAMP // NBINS
    rows = _corrected_rows(x, h, step)
    y = sum(rows[:, t:t + k * s] for t in range(ntaps))
    got = ff.fx_fused_ablate(x, h, w, pairs, "load", step)
    want = _cross(y, pairs, k)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    raw = ff.fx_fused_ablate(x, h, w, pairs, "load_raw", step)
    if ingest == "int8":
        q = np.concatenate([h["tail"].numpy(), x.numpy().reshape(
            x.shape[0], -1, NBINS, 2)], axis=1).astype(np.int64)
        z = q[..., 0] + 1j * q[..., 1]
        yq = sum(z[:, t:t + k * s] for t in range(ntaps))
        want_raw = _cross(torch.as_tensor(yq), pairs, k)
        assert torch.equal(raw.to(torch.complex128), want_raw)
    else:
        merged = torch.cat([h, x.reshape(x.shape[0], -1, NBINS)], dim=1)
        yr = sum(merged[:, t:t + k * s] for t in range(ntaps))
        assert (raw - _cross(yr, pairs, k)).abs().max() <= (
            1e-6 * raw.abs().max())


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("ntaps,fir", [(4, "direct"), (32, "svd")])
def test_fft_stages_against_torch_fft(ingest, ntaps, fir):
    """``fft``: every channel's spectrum (torch.fft of the FIR output)
    summed over the block's frames at the first bins; ``fft_half``: what
    the first of the FFT's radix passes leaves in the slot, which the
    remaining pass turns into that spectrum."""
    k = 2
    x, h, w, pairs, step, svd = _merged_case(ingest, ntaps, k, fir, seed=3)
    rows = _corrected_rows(x, h, step)
    y = pfb_fir(rows, w) if svd is None else svd_fir(rows, *svd)
    spec = torch.fft.fft(y).reshape(y.shape[0], k, -1, NBINS)
    want = spec[..., :ff.FFT_STAGE_BINS].sum(dim=(0, 2))[:, None]
    got = ff.fx_fused_ablate(x, h, w, pairs, "fft", step, svd)
    assert got.shape == (k, 1, ff.FFT_STAGE_BINS)
    assert (got - want).abs().max() <= 2e-5 * want.abs().max()
    assert ff.fft_radices(NBINS) == (16, 16)  # floor(2 / 2) = 1 pass
    half = ff.fft_passes(y, 1)
    want_half = _cross(half, pairs, k)
    got_half = ff.fx_fused_ablate(x, h, w, pairs, "fft_half", step, svd)
    assert torch.equal(got_half, want_half)
    # the other pass finishes the transform
    a = ff.fft_passes(half, 2, start=1)
    assert (a - torch.fft.fft(y)).abs().max() <= 2e-5 * spec.abs().max()


@pytest.mark.parametrize("stage", ff.STAGES)
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("ntaps,fir", [(4, "direct"), (32, "svd")])
def test_every_stage_block_by_block(stage, ingest, ntaps, fir):
    """K = 3 against K = 1: a block's frames read only the history and the
    blocks before it, so block 0 of a 3-block call is the 1-block call,
    bit for bit, in every stage, ingest and FIR mode."""
    x, h, w, pairs, step, svd = _merged_case(ingest, ntaps, 3, fir, seed=11)
    xp3 = ff.fx_fused_ablate(x, h, w, pairs, stage, step, svd)
    xp1 = ff.fx_fused_ablate(x[:, :1].contiguous(), h, w, pairs, stage, step,
                             svd)
    shape = ((1, ff.FFT_STAGE_BINS) if stage == "fft"
             else (len(pairs), NBINS))
    assert xp3.shape == (3, *shape) and xp1.shape == (1, *shape)
    assert torch.isfinite(torch.view_as_real(xp3)).all()
    assert torch.equal(xp3[0], xp1[0])
    assert not torch.equal(xp3[1], xp3[0])


def test_ablate_rejects_bad_arguments():
    x, h, w, pairs, step, _ = _merged_case("int8", 4, 1, "direct")
    with pytest.raises(ValueError, match="stage"):
        ff.fx_fused_ablate(x, h, w, pairs, "dma", step)
    with pytest.raises(ValueError, match="quant_step"):
        ff.fx_fused_ablate(x, h, w, pairs, "fir")
    with pytest.raises(ValueError, match="stage"):
        ff.fx_fused_ablate_reference(x, h, w, pairs, "nox", step)


# --- byte accounting against the scripts' own formulas --------------------

def test_width_plan_walks_the_scripts_bytes_at_every_width():
    """dma_width_probe.py:135: bytes per repeat, the same at every r."""
    sc = _load_script("dma_width_probe")
    want = sc.NT * 2 * sc.ROWS * sc.W * 4
    for r in (1, 2, 4, 8, 16, 32):
        plan = copy_rate.width_plan(sc.W // r * 4, want)
        assert plan.bytes_per_rep == want == plan.src_bytes
        assert plan.tile_bytes == copy_rate.TILE_BYTES
    assert {sc.W // r * 4 for r in (1, 2, 4, 8, 16, 32)} <= set(
        copy_rate.WIDTHS)


@pytest.mark.parametrize("mode", copy_rate.SHAPE_MODES)
def test_shape_plan_walks_the_scripts_bytes(mode):
    """dma_shape_probe.py:147: NT tiles of two arrays of two channels of
    ROWS rows of L words; here one array holds both planes interleaved."""
    sc = _load_script("dma_shape_probe")
    plan = copy_rate.shape_plan(mode, row_bytes=2 * sc.L * 4, rows=sc.ROWS,
                                nch=2, k_blocks=sc.KB,
                                s_rows=sc.NTILE * sc.ROWS)
    assert plan.ntiles == sc.NT
    assert plan.bytes_per_rep == sc.NT * 2 * 2 * sc.ROWS * sc.L * 4


def test_overlap_copy_bytes_is_the_scripts_formula():
    """dma_overlap_probe.py:309, per repeat: a tile of two arrays of two
    planes of ROWS rows of L int32 words is a frame of ROWS rows of 2 x 2 x
    L x 4 / 8 complex64 bins."""
    sc = _load_script("dma_overlap_probe")
    n = 2 * 2 * sc.L * 4 // 8
    assert overlap.copy_bytes(sc.NT, 1, sc.ROWS, n) == (
        sc.NT * 2 * 2 * sc.ROWS * sc.L * 4)


def test_overlap_shared_memory_budget():
    """The flagship's budget (n = 4096, 4 taps), with the rows read once:
    the pipelined ring of ntaps + 2 whole rows (two teams, a row in
    flight) beside the twiddle table is one CTA an SM; two CTAs an SM take
    the chunked ring and its work slot; at 8192 bins whole rows fit only at
    two taps, with one team."""
    bars = overlap.BARRIER_BYTES
    assert overlap.shared_bytes(4096, 512, 4, 2, rows_once=True, teams=2) \
        == bars + (6 * 4096 + 2048) * 8 == 213504
    assert overlap.shared_bytes(4096, 512, 4, 1, rows_once=True) == (
        bars + (5 * 4096 + 2048) * 8)
    assert overlap.shared_bytes(4096, 512, 4, 1) == (
        bars + (4 * 512 + 4096 + 2048) * 8) == 66048
    assert overlap.plan(4096, 512, 4, 2) == overlap.Layout(True, 2, 6, 213504)
    assert overlap.plan(4096, 512, 4, 2).threads == 2 * 256 + 32
    assert overlap.plan(4096, 512, 4, 1) == overlap.Layout(True, 1, 5, 180736)
    assert overlap.plan(4096, 512, 4, 1, ctas_per_sm=2) == overlap.Layout(
        False, 1, 1, 66048)
    assert overlap.fits(4096, 512, 4, 1, ctas_per_sm=2)
    assert overlap.fits(4096, 512, 4, 2) and overlap.fits(4096, 512, 4, 8)
    assert not overlap.fits(4096, 512, 4, 2, ctas_per_sm=3)
    assert not overlap.fits(4096, 4096, 4, 2)
    assert not overlap.fits(256, 256, 4, 2)      # one chunk, two slots
    assert overlap.plan(8192, 512, 2, 2) == overlap.Layout(True, 1, 3, 229888)
    assert not overlap.plan(8192, 512, 4, 1).rows_once
    assert not overlap.plan(4096, 512, 8, 2).rows_once
    # the kernel decides by the shared memory it is given: the structures'
    # requests (a lone CTA asks for more than half an SM) give the plans
    for nbuf, per_sm in overlap.STRUCTURES.values():
        lay = overlap.plan(4096, 512, 4, nbuf, per_sm)
        smem = (lay.shared_bytes if per_sm > 1
                else max(lay.shared_bytes, overlap.ONE_CTA_BYTES))
        assert overlap.layout(4096, 512, 4, nbuf, smem) == lay
    assert overlap.layout(4096, 512, 4, 1, 4096) is None


#: (n, ntaps, nbuf, frames) of the ring's schedule: chunks of 256 bins
ROW_CASES = [(n, ntaps, nbuf, frames) for n in (256, 1024, 4096)
             for ntaps in (2, 4, 8) for nbuf in (1, 2, 4)
             for frames in (1, 3, 8) if nbuf <= n // 256]


@pytest.mark.parametrize("n,ntaps,nbuf,frames", ROW_CASES)
def test_overlap_row_schedule(n, ntaps, nbuf, frames):
    """The rows-once ring's schedule (overlap.row_schedule, the kernel's
    rules), with the teams the leg's layout has (one where the rows do not
    fit and the leg streams chunks): each row of a repeat is copied once,
    every frame's ntaps rows are resident when it reads them, and no slot
    is overwritten while a frame's FIR output is in it."""
    lay = overlap.plan(n, 256, ntaps, nbuf)
    teams = lay.teams if lay.rows_once else 1
    reps = 2
    S = ntaps + teams + nbuf - 2
    if lay.rows_once:
        assert lay.slots >= S
    holds, held, copies, reads, frees = {}, {}, [], set(), 0
    for ev in overlap.row_schedule(ntaps, nbuf, frames, teams, reps):
        if ev[0] == "copy":
            _, g, rep, row, slot = ev
            assert slot == g % S and slot not in held, ev
            holds[slot] = (rep, row)
            copies.append((rep, row))
        elif ev[0] == "read":
            _, u, rows = ev
            rep, f = divmod(u, frames)
            assert [(rp, row) for rp, row, _ in rows] == [
                (rep, f + t) for t in range(ntaps)]
            for rp, row, slot in rows:
                assert holds.get(slot) == (rp, row), (ev, holds)
            reads.add(u)
        elif ev[0] == "write":
            _, u, slot = ev
            assert u in reads
            holds[slot], held[slot] = ("fir", u), u
        else:
            _, u, slot = ev
            held.pop(slot, None)
            frees += 1
    per_rep = frames + ntaps - 1
    assert sorted(copies) == [(rp, row) for rp in range(reps)
                              for row in range(per_rep)]
    assert reads == set(range(reps * frames)) and not held
    assert frees == len(copies)


def test_overlap_device_bytes_at_the_defaults():
    """python -m fxtpu_torch.probes overlap on 132 SMs: the pipelined
    leg's 132 CTAs of 64 frames read their 67 rows each once a repeat,
    where the chunks read every frame's 4 rows."""
    assert overlap.plan(4096, 512, 4, 2).rows_once
    assert overlap.device_bytes(132, 64, 4, 4096, True) == (
        132 * 67 * 4096 * 8) == 289800192
    assert overlap.device_bytes(132, 64, 4, 4096, False) == (
        overlap.copy_bytes(132, 64, 4, 4096)) == 1107296256


# --- the copy probe's plain version ---------------------------------------

def _bytes(n, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, size=n, dtype=np.uint8))


@pytest.mark.parametrize("width", [512, 2048, 32768])
def test_copy_reference_width_sweep(width):
    total = 2**22
    src = _bytes(total)
    plan = copy_rate.width_plan(width, total)
    got = copy_rate.copy_probe(src, plan, "bulk", reps=3)
    words = src.numpy().view("<u4").astype(np.int64).reshape(-1, 32768 // 4)
    want = []
    for t in range(plan.ntiles):
        blk, col = divmod(t, plan.tpb)
        tile = words[blk * plan.rows:(blk + 1) * plan.rows,
                     col * width // 4:(col + 1) * width // 4]
        want.append(3 * int(tile.sum()) % 2**32)
    assert got.dtype == torch.int64 and got.tolist() == want
    # every width walks every byte once: the same total
    assert int(got.sum()) % 2**32 == 3 * int(words.sum()) % 2**32


@pytest.mark.parametrize("mode", copy_rate.SHAPE_MODES)
def test_copy_reference_shape_sweep(mode):
    nch, k, s, rows, row = 2, 3, 8, 2, 512
    src = _bytes(nch * k * s * row, seed=1)
    plan = copy_rate.shape_plan(mode, row_bytes=row, rows=rows, nch=nch,
                                k_blocks=k, s_rows=s)
    got = copy_rate.copy_probe(src, plan, "ldg8")
    words = src.numpy().view("<u4").astype(np.int64)
    if mode in ("prodsrc", "prod"):
        arr = words.reshape(k, nch, s, row // 4).transpose(1, 0, 2, 3)
    else:
        arr = words.reshape(nch, k, s, row // 4)
    tiles = arr.reshape(nch, k * s // rows, rows, row // 4)
    want = tiles.sum(axis=(0, 2, 3)) % 2**32
    assert got.tolist() == want.tolist()
    assert plan.tile_bytes == nch * rows * row
    # the destination strides tile the CTA's shared memory exactly
    offs = sorted(c * plan.dst_chan_stride + i * plan.dst_row_stride
                  for c in range(nch) for i in range(rows))
    assert offs == [j * row for j in range(nch * rows)]


def test_copy_probe_rejects_bad_plans():
    src = _bytes(2**20)
    with pytest.raises(ValueError):
        copy_rate.width_plan(768, 2**20)
    with pytest.raises(ValueError):
        copy_rate.shape_plan("chan", row_bytes=512, rows=3, nch=2,
                             k_blocks=1, s_rows=8)
    plan = copy_rate.width_plan(512, 2**22)
    with pytest.raises(ValueError, match="holds"):
        copy_rate.copy_probe(src, plan)
    with pytest.raises(ValueError, match="mech"):
        copy_rate.copy_probe(src, copy_rate.width_plan(32768, 2**20), "dma")


# --- the overlap probe's plain version ------------------------------------

def _overlap_src(rows, n, seed=5):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((rng.normal(size=(rows, n))
                            + 1j * rng.normal(size=(rows, n))
                            ).astype(np.complex64))


@pytest.mark.parametrize("nbuf", [1, 2])
def test_overlap_reference_fx_body(nbuf):
    n, cb, ntaps, frames, grid, reps = 512, 256, 4, 3, 2, 2
    src = _overlap_src(grid * frames + ntaps - 1, n)
    got = overlap.overlap_probe(src, cb=cb, ntaps=ntaps, frames=frames,
                                reps=reps, nbuf=nbuf, copy=True, body="fx",
                                grid=grid)
    taps = [np.float32(0.25) + np.float32(0.01) * np.float32(t)
            for t in range(ntaps)]
    for b in range(grid):
        want = 0
        for f in range(frames):
            r0 = b * frames + f
            fir = sum(float(taps[t]) * src[r0 + t].to(torch.complex128)
                      for t in range(ntaps))
            want = want + torch.fft.fft(fir)
        want = want * reps
        assert (got[b] - want).abs().max() <= 2e-5 * want.abs().max()
    # without the copy every frame is the CTA's resident chunks
    res = overlap.overlap_probe(src, cb=cb, ntaps=ntaps, frames=frames,
                                reps=reps, nbuf=nbuf, copy=False, body="fx",
                                grid=grid)
    for b in range(grid):
        rows = src[b * frames:b * frames + ntaps].to(torch.complex128)
        if nbuf == 1:       # one slot: every chunk is the frame's first
            rows = rows[:, :cb].repeat(1, n // cb)
        fir = sum(float(taps[t]) * rows[t] for t in range(ntaps))
        want = torch.fft.fft(fir) * (reps * frames)
        assert (res[b] - want).abs().max() <= 2e-5 * want.abs().max()


def test_overlap_reference_touch_and_fma_bodies():
    n, cb, ntaps, frames, grid = 512, 256, 2, 2, 3
    src = _overlap_src(grid * frames + ntaps - 1, n, seed=6)
    kw = dict(cb=cb, ntaps=ntaps, frames=frames, reps=1, nbuf=2, grid=grid)
    touch = overlap.overlap_probe(src, copy=True, body="touch", **kw)
    for b in range(grid):
        first = src[b * frames:(b + 1) * frames]            # row 0 of each
        want = first.reshape(frames, n // cb, cb)[..., :256].sum(dim=(0, 1))
        assert torch.allclose(touch[b, :256], want, atol=1e-5)
        assert not touch[b, 256:].any()
    fma = overlap.overlap_probe(src, copy=True, body="fma", **kw)
    x = src[0].clone()
    y = src[1].clone()
    for _ in range(overlap.FMA_PASSES):
        x = x * np.float32(1.0000001) + y
        y = y * np.float32(0.9999999) + x
    x1, y1 = src[1].clone(), src[2].clone()
    for _ in range(overlap.FMA_PASSES):
        x1 = x1 * np.float32(1.0000001) + y1
        y1 = y1 * np.float32(0.9999999) + x1
    assert torch.allclose(fma[0], x + x1, rtol=1e-5, atol=1e-5)


def test_overlap_probe_rejects_bad_arguments():
    src = _overlap_src(16, 512)
    kw = dict(ntaps=4, frames=2, reps=1, copy=True, body="fx", grid=2)
    with pytest.raises(ValueError, match="cb"):
        overlap.overlap_probe(src, cb=384, nbuf=1, **kw)
    with pytest.raises(ValueError, match="nbuf"):
        overlap.overlap_probe(src, cb=256, nbuf=4, **kw)
    with pytest.raises(ValueError, match="rows"):
        overlap.overlap_probe(src, cb=256, nbuf=1, **{**kw, "grid": 8})
    with pytest.raises(ValueError, match="mech"):
        overlap.overlap_probe(src, cb=256, nbuf=1, mech="ldg", **kw)


# --- the retile probe's plain version -------------------------------------

def test_retile_reference_is_the_sum_of_the_dots():
    x, xt, m = retile.make_inputs("cpu")
    assert x.shape == (retile.NSRC * retile.TILE, retile.NBINS)
    # the pre-tiled copy holds each frame's [n1, n2] matrix transposed
    assert torch.equal(xt.reshape(-1, retile.N2, retile.N1).transpose(1, 2),
                       x.reshape(-1, retile.N1, retile.N2))
    assert torch.equal(m, m.bfloat16().float())
    nt, reps = 3, 2
    want = torch.zeros(retile.N1, retile.N2, dtype=torch.float64)
    for g in range(reps * nt * retile.TILE):
        x2 = x[g % x.shape[0]].bfloat16().double().reshape(retile.N1,
                                                           retile.N2)
        want += m.double() @ x2
    for form in ("control", "transpose", "transpose_pad", "gather"):
        got = retile.retile_probe(x, xt, m, form, nt, reps)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_stockham_leg_reference_is_the_fft_of_the_frames():
    x, xt, m = retile.make_inputs("cpu")
    got = retile.retile_probe(x, xt, m, "stockham", nt=retile.NSRC, reps=1)
    pts = torch.view_as_complex(x.reshape(-1, retile.STOCKHAM_POINTS, 2)
                                .contiguous())
    total = torch.fft.fft(pts.to(torch.complex128)).sum(dim=0)    # [2048]
    want = torch.zeros(retile.N1, retile.N2, dtype=torch.float64)
    for j in range(retile.N1 // 2):
        seg = total[j * retile.N2:(j + 1) * retile.N2]
        want[2 * j], want[2 * j + 1] = seg.real, seg.imag
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("form", retile.LAYOUT_FORMS)
def test_retile_fragment_checksum_is_the_reference(form):
    """The layout legs' index arithmetic on the CPU (loads, staging,
    ldmatrix, the mma's fragment layouts, the columns written back) forms
    retile_reference's checksum, within 1e-5 of max|plain|."""
    x, xt, m = retile.make_inputs("cpu")
    for nt, reps in ((3, 2), (retile.NT, 1)):
        want = retile.retile_reference(x, m, nt, reps)
        got = retile.fragment_checksum(x, xt, m, form, nt, reps)
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("sms", [114, 128, 132])
def test_retile_grid_rotates_the_sources(sms):
    """No grid is a multiple of the source frames: a CTA meets more than
    one source."""
    for form in retile.FORMS:
        for slots in (512, 4096, 131072):
            grid = retile.launch_grid(form, slots, retile.NSRC * retile.TILE,
                                      sms)
            assert 1 <= grid <= min(slots, 8 * sms)
            assert grid % (retile.NSRC * retile.TILE) != 0


@pytest.mark.parametrize("form", ["control", "reshape", "stack", "gather"])
def test_retile_checksum_matches_the_script_in_interpret_mode(form,
                                                               monkeypatch):
    """scripts/retile_probe.py make_fn(form, 1), run as it stands in
    interpret mode, against the port's plain checksum on the port's own
    draw of the same inputs.  Tolerance 2e-5 of max|out|: both cast the
    samples to bf16 before the dot and sum in float32, in another order."""
    monkeypatch.setenv("RETILE_PROBE_INTERPRET", "1")
    sc = _load_script("retile_probe")
    assert (sc.NBINS, sc.TILE, sc.N1, sc.N2, sc.NT, sc.NSRC) == (
        retile.NBINS, retile.TILE, retile.N1, retile.N2, retile.NT,
        retile.NSRC)
    fn, args = sc.make_fn(form, 1)
    theirs = np.asarray(fn(*args), np.float32)
    x, xt, m = retile.make_inputs("cpu")
    np.testing.assert_array_equal(np.asarray(args[0]), x.numpy())
    np.testing.assert_array_equal(np.asarray(args[1]),
                                  x.numpy().reshape(args[1].shape))
    np.testing.assert_array_equal(np.asarray(args[2], np.float32), m.numpy())
    ours = retile.retile_reference(x, m, nt=retile.NT, reps=1).numpy()
    np.testing.assert_allclose(ours, theirs,
                               atol=2e-5 * np.abs(theirs).max(), rtol=0)


# --- the entry points ------------------------------------------------------

SMALL_ARGS = {
    "ablate": ["--nbins", "256", "--num_samp", "8192", "--k", "2"],
    "copy_rate": ["--cold_bytes", "0", "--hot_bytes", str(2**22),
                  "--nbins", "256"],
    "overlap": ["--n", "512", "--cb", "256", "--frames", "2"],
    "retile": ["--nt", "2", "--reps", "1,2"],
    "breakdown": ["--num_samp", "8192", "--nbins", "256", "--k", "2"],
}


@pytest.mark.parametrize("name", probes.PROBES)
def test_main_on_the_cpu_prints_json_lines(name, capsys):
    records = probes.main([name, "--device", "cpu", *SMALL_ARGS[name]])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    assert len(lines) == len(records) >= 2
    parsed = [json.loads(ln) for ln in lines]
    assert parsed == json.loads(json.dumps(records))
    for rec in parsed:
        assert rec["probe"] == name
        # a CPU run names no device metric: no time, no rate, no card
        assert rec.get("card") is None
        for key, val in rec.items():
            timed = key.startswith("ms") or key.endswith(
                ("_ms", "gbps", "per_s"))
            if timed and key != "hbm_gbps":   # the published rate, a constant
                assert val is None, (key, val)


def test_ablate_main_on_the_cpu_runs_int8_deep_taps(capsys):
    records = probes.main(["ablate", "--device", "cpu", "--ingest", "int8",
                           "--ntaps", "32", "--stage", "fir",
                           *SMALL_ARGS["ablate"]])
    capsys.readouterr()
    assert [r["stage"] for r in records] == ["fir"]
    assert records[0]["fir_mode"] == "svd" and records[0]["rank"] > 0
    assert records[0]["finite"] is True


def test_breakdown_is_within_the_precision_contract(capsys):
    """Both routes against the float64 oracle: within 3.1e-5 of max|vis|
    (docs/design.md's "HIGH" contract), the DC bins no worse."""
    records = probes.main(["breakdown", "--device", "cpu",
                           *SMALL_ARGS["breakdown"]])
    capsys.readouterr()
    assert [r["route"] for r in records] == ["plain", "fused"]
    for rec in records:
        assert rec["max_rel_err"] <= 3.1e-5
        assert rec["max_rel_err_dc"] <= 3.1e-5
        assert rec["multi_step_block0_is_step"] is True


def test_probe_names_and_usage():
    assert probes.PROBES == ("ablate", "copy_rate", "overlap", "retile",
                             "breakdown")
    with pytest.raises(SystemExit):
        probes.main([])
    with pytest.raises(SystemExit):
        probes.main(["dma"])


def test_the_default_device_is_the_card():
    """``--device`` defaults to cuda and raises without a card; nothing
    falls back to the CPU by itself."""
    if torch.cuda.is_available():
        assert common.resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="--device cpu"):
            common.resolve_device("cuda")
        with pytest.raises(RuntimeError, match="--device cpu"):
            probes.main(["retile"])
    assert common.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        common.resolve_device("meta")


def _trace(per_call, calls, lost=(), launcher="cudaLaunchKernel"):
    """A trace's events of ``calls`` calls of ``per_call`` launches each:
    a host record per launch and its device record, but for the launches
    whose index is in ``lost``; two host records that launch nothing."""
    events = [{"cat": "cuda_runtime", "name": "cudaFuncSetAttribute",
               "ts": -1.0, "args": {"correlation": 900}},
              {"cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
               "ts": 1e6, "args": {"correlation": 901}}]
    for i in range(per_call * calls):
        events.append({"cat": "cuda_runtime", "name": launcher,
                       "ts": float(10 * i), "args": {"correlation": i}})
        if i not in lost:
            events.append({"cat": "kernel", "name": f"k{i % per_call}",
                           "ts": 10 * i + 3.0, "dur": 1.0 + i,
                           "args": {"correlation": i}})
    return events[::-1]     # in no order: the host records' ts sorts them


@pytest.mark.parametrize("lost,complete", [
    ((), True), ((0,), True), ((0, 1, 2, 5), True),      # lost in the lead
    ((6,), False), ((14,), False), (tuple(range(15)), False)])
def test_counted_device_events_holds_each_launch_to_its_record(lost,
                                                               complete):
    """3 launches a call, 2 lead calls and 3 counted ones: a record lost
    in the lead calls does not matter, one lost in a counted call makes
    the trace unusable."""
    got = common.counted_device_events(_trace(3, 5, lost), calls=3, lead=2)
    if not complete:
        assert got is None
        return
    assert [e["name"] for e in got] == ["k0", "k1", "k2"] * 3
    assert [e["dur"] for e in got] == [1.0 + i for i in range(6, 15)]


@pytest.mark.parametrize("lost,complete", [
    ((15, 16, 17), True), ((20,), True),                 # lost in the tail
    ((14,), False), ((6,), False)])
def test_counted_device_events_skip_the_tail(lost, complete):
    """2 lead calls, 3 counted and 2 tail calls of 3 launches each: a
    record lost in the tail calls does not matter either."""
    got = common.counted_device_events(_trace(3, 7, lost), calls=3, lead=2,
                                       tail=2)
    if not complete:
        assert got is None
        return
    assert [e["dur"] for e in got] == [1.0 + i for i in range(6, 15)]


def test_counted_device_events_rejects_what_it_cannot_count():
    with pytest.raises(RuntimeError, match="launching calls"):
        common.counted_device_events(_trace(3, 5)[2:], calls=3, lead=2)
    with pytest.raises(RuntimeError, match="launching calls"):
        common.counted_device_events([], calls=3, lead=2)
    with pytest.raises(RuntimeError, match="cudaGraphLaunch"):
        common.counted_device_events(
            _trace(3, 5, launcher="cudaGraphLaunch"), calls=3, lead=2)
    # copies and memsets count as launches, driver-API names too
    for name in ("cudaMemcpyAsync", "cudaMemsetAsync", "cuLaunchKernel"):
        assert len(common.counted_device_events(
            _trace(2, 4, launcher=name), calls=3, lead=1)) == 6


def test_the_probes_import_nothing_of_jax():
    root = Path(probes.__file__).resolve().parent
    for path in sorted(root.glob("*.py")):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert words[1].split(".")[0] not in ("jax", "fxtpu"), (
                    path.name, line)


def test_step_exposed_us_reads_each_call():
    """The epilogue's end less its predecessor's end, and the call's span,
    per call of three kernels, their medians; a call whose last kernel is
    not the epilogue raises."""
    def call(t0, finish_start):
        # frames 0-20, reduce 18-27 (a dependent starts early), epilogue
        return [{"name": "fx_frames_kernel", "ts": t0, "dur": 20.0},
                {"name": "fx_parts_reduce_kernel", "ts": t0 + 18.0,
                 "dur": 9.0},
                {"name": "fx_finish_kernel", "ts": t0 + finish_start,
                 "dur": 30.0 - finish_start}]
    events = call(0.0, 20.0) + call(100.0, 25.0) + call(200.0, 22.0)
    exposed, span = common.step_exposed_us(events)
    assert exposed == pytest.approx(3.0) and span == pytest.approx(30.0)
    with pytest.raises(RuntimeError, match="last kernel"):
        common.step_exposed_us(events[:2] + events[3:5] + events[2:3]
                               + events[5:])


# --- on the card: every kernel against its plain version ------------------

@pytest.mark.cuda
@pytest.mark.parametrize("stage", ff.STAGES)
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("ntaps,fir", [(4, "direct"), (32, "direct"),
                                       (32, "svd")])
def test_cuda_ablate_stage_matches_plain(stage, ingest, ntaps, fir,
                                         cuda_device):
    x, h, w, pairs, step, svd = _merged_case(ingest, ntaps, 3, fir, nch=2,
                                             seed=21, device=cuda_device)
    before = ff.fx_fused_ablate.launches
    got = ff.fx_fused_ablate(x, h, w, pairs, stage, step, svd)
    want = ff.fx_fused_ablate_reference(x, h, w, pairs, stage, step, svd)
    torch.cuda.synchronize()
    assert ff.fx_fused_ablate.launches == before + 1
    assert got.shape == want.shape
    # the fused-against-unfused bound (3e-5 at deep taps)
    tol = 2e-5 if ntaps < 16 else 3e-5
    assert (got - want).abs().max() <= tol * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_cuda_ablate_full_is_the_production_launch(ingest, cuda_device):
    """Stage ``full`` is the instantiation the FX entry points launch: the
    same bits."""
    x, h, w, pairs, step, _ = _merged_case(ingest, 4, 3, "direct", seed=22,
                                           device=cuda_device)
    got = ff.fx_fused_ablate(x, h, w, pairs, "full", step)
    if ingest == "int8":
        want, _ = ff.fx_fused_raw_i8_multi(x, h, w, pairs, step)
    else:
        want, _ = ff.fx_fused_raw_multi(x, h, w, pairs)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mech", list(copy_rate.MECHS))
@pytest.mark.parametrize("width", [512, 4096, 32768])
def test_cuda_copy_probe_width(mech, width, cuda_device):
    src = _bytes(2**23, seed=2).to(cuda_device)
    plan = copy_rate.width_plan(width, 2**23)
    before = copy_rate.copy_probe.launches
    got = copy_rate.copy_probe(src, plan, mech, reps=3)
    assert copy_rate.copy_probe.launches == before + 1
    assert torch.equal(got, copy_rate.copy_probe_reference(src, plan, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("mech", list(copy_rate.MECHS))
@pytest.mark.parametrize("mode", copy_rate.SHAPE_MODES)
def test_cuda_copy_probe_shape(mech, mode, cuda_device):
    nch, k, s, rows, row = 2, 4, 16, 4, 8192
    src = _bytes(nch * k * s * row, seed=3).to(cuda_device)
    plan = copy_rate.shape_plan(mode, row_bytes=row, rows=rows, nch=nch,
                                k_blocks=k, s_rows=s)
    got = copy_rate.copy_probe(src, plan, mech, reps=2)
    assert torch.equal(got, copy_rate.copy_probe_reference(src, plan, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("mech", list(overlap.MECHS))
@pytest.mark.parametrize("nbuf,copy,body", [
    (1, True, "touch"), (2, True, "touch"), (1, False, "fma"),
    (2, False, "fx"), (1, True, "fx"), (2, True, "fx"), (4, True, "fx"),
    (2, True, "fma"), (4, False, "fx")])
def test_cuda_overlap_probe(mech, nbuf, copy, body, cuda_device):
    n, cb, ntaps, frames, grid = 1024, 256, 4, 3, 5
    src = _overlap_src(grid * frames + ntaps - 1, n, seed=8).to(cuda_device)
    kw = dict(cb=cb, ntaps=ntaps, frames=frames, reps=2, nbuf=nbuf,
              copy=copy, body=body, grid=grid)
    before = overlap.overlap_probe.launches
    err = overlap.check_leg(src, mech=mech, **kw)
    assert overlap.overlap_probe.launches == before + 1
    assert err <= 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("form", retile.FORMS)
def test_cuda_retile_probe(form, cuda_device):
    x, xt, m = retile.make_inputs(cuda_device)
    before = retile.retile_probe.launches
    assert retile.check_form(x, xt, m, form, nt=4, reps=3) <= 1e-5
    assert retile.retile_probe.launches == before + 1


#: (n, ntaps, leg, structure): every leg of every structure that fits
OVERLAP_LEGS = {"copy": (True, "touch"), "comp_fma": (False, "fma"),
                "comp_fx": (False, "fx"), "body_fma": (True, "fma"),
                "body_fx": (True, "fx")}
OVERLAP_CARD_CASES = [
    (n, ntaps, leg, structure) for n in (256, 1024, 4096, 8192)
    for ntaps in (2, 4, 8) for leg in OVERLAP_LEGS
    for structure, (nbuf, per_sm) in overlap.STRUCTURES.items()
    if overlap.plan(n, 256 if n < 4096 else 512, ntaps,
                    min(nbuf, n // (256 if n < 4096 else 512)), per_sm)]


@pytest.mark.cuda
@pytest.mark.parametrize("mech", list(overlap.MECHS))
@pytest.mark.parametrize("n,ntaps,leg,structure", OVERLAP_CARD_CASES)
def test_cuda_overlap_leg(n, ntaps, leg, structure, mech, cuda_device):
    """Every leg as the probe runs it in each structure (the structure's
    shared memory decides the layout: rows once or chunks, one team or
    two), within 2e-5 of max|plain|; the kernel takes the module's plan,
    and its copies ask for the schedule's bytes (a leg without the copy:
    the resident rows or chunks, once a launch)."""
    copy, body = OVERLAP_LEGS[leg]
    nbuf, per_sm = overlap.STRUCTURES[structure]
    cb = 256 if n < 4096 else 512
    nbuf = min(nbuf, n // cb)
    lay = overlap.plan(n, cb, ntaps, nbuf, per_sm)
    smem = (lay.shared_bytes if per_sm > 1
            else max(lay.shared_bytes, overlap.ONE_CTA_BYTES))
    assert overlap.kernel_layout(n, cb, ntaps, nbuf, smem) == lay
    grid, frames, reps = 3, 5, 2
    src = _overlap_src(grid * frames + ntaps - 1, n, seed=9).to(cuda_device)
    before = overlap.overlap_probe.launches
    overlap.copied_bytes(cuda_device)
    err = overlap.check_leg(src, mech=mech, cb=cb, ntaps=ntaps,
                            frames=frames, reps=reps, nbuf=nbuf, copy=copy,
                            body=body, grid=grid, smem=smem)
    copied = overlap.copied_bytes(cuda_device)
    assert overlap.overlap_probe.launches == before + 1
    assert err <= 2e-5
    if copy:
        assert copied == reps * overlap.device_bytes(grid, frames, ntaps, n,
                                                     lay.rows_once)
    else:
        assert copied == grid * ntaps * 8 * (n if lay.rows_once
                                             else nbuf * cb)


#: (n, cb, ntaps, nbuf) of the layout rule's comparison: every accepted
#: shape of the probe's structures and beyond, each at the shared memory
#: of each layout, a byte below it, a lone CTA's request and the most
LAYOUT_CASES = [(n, cb, ntaps, nbuf) for n in (256, 1024, 4096, 8192)
                for cb in (256, 512) for ntaps in (2, 3, 4, 8, 16, 32)
                for nbuf in (1, 2, 4, 8) if cb <= n and nbuf <= n // cb]


@pytest.mark.cuda
def test_cuda_overlap_layout_is_the_kernels(cuda_device):
    """overlap.layout, the module's copy of the rule by which a CTA lays out
    its shared memory, against the kernel's own (fxt_overlap_layout)."""
    checked = 0
    for n, cb, ntaps, nbuf in LAYOUT_CASES:
        sizes = {4096, overlap.ONE_CTA_BYTES, common.MAX_SHARED_BYTES}
        for rows_once, teams in ((True, 2), (True, 1), (False, 1)):
            need = overlap.shared_bytes(n, cb, ntaps, nbuf, rows_once, teams)
            sizes |= {need - 1, need}
        for smem in sorted(sizes):
            assert overlap.kernel_layout(n, cb, ntaps, nbuf, smem) == (
                overlap.layout(n, cb, ntaps, nbuf, smem)), (n, cb, ntaps,
                                                            nbuf, smem)
            checked += 1
    assert checked > 1000


@pytest.mark.cuda
@pytest.mark.parametrize("form", retile.FORMS)
def test_cuda_retile_probe_at_the_probes_shape(form, cuda_device):
    """Every leg at the probe's own shape (512 slots a repeat over 4 CTAs an
    SM) against its plain version, and the layout legs against the CPU
    mirror of their fragments."""
    x, xt, m = retile.make_inputs(cuda_device)
    assert retile.check_form(x, xt, m, form, nt=retile.NT, reps=3) <= 1e-5
    if form in retile.LAYOUT_FORMS:
        got = retile.retile_probe(x, xt, m, form, retile.NT, 3).cpu()
        mirror = retile.fragment_checksum(x.cpu(), xt.cpu(), m.cpu(), form,
                                          retile.NT, 3)
        assert (got - mirror).abs().max() <= 1e-5 * mirror.abs().max()


@pytest.mark.cuda
def test_cuda_probe_wrappers_reject_bad_input(cuda_device):
    src = _bytes(2**22).to(cuda_device)
    plan = copy_rate.width_plan(512, 2**22)
    with pytest.raises(ValueError, match="shared"):     # a 256 KB tile
        copy_rate.copy_probe(
            src, copy_rate.width_plan(32768, 2**22, tile_bytes=2**18), "ldg")
    with pytest.raises(TypeError):
        copy_rate.copy_probe(src.view(torch.int32), plan)
    x, xt, m = retile.make_inputs(cuda_device)
    with pytest.raises(ValueError):
        retile.retile_probe(x[:, :2048].contiguous(), xt, m, "control")
    with pytest.raises(TypeError):
        retile.retile_probe(x.double(), xt, m, "gather")
    osrc = _overlap_src(16, 512).to(cuda_device)
    with pytest.raises(ValueError, match="shared"):
        overlap.overlap_probe(osrc, cb=256, ntaps=4, frames=2, reps=1,
                              nbuf=1, copy=True, body="fx", grid=2,
                              smem=4096)

