"""The epilogue's pair-tiled instance (``fx_finish_kernel_tiled``,
``csrc/fx_finish.cu``) and the plan that picks it
(``fxtpu_torch.ops.fx_epilogue.finish_plan``).

On the CPU: the plan's instance, tile and chunk at the benchmark's cells
and at its edges (the pairs' threshold, CONTINUUM, shared memory, the
grid's fill), its constants against the kernel's, and the engine cells' K
(``dispatch_batch_for``), which the plan leaves as it was.  On a card
(marked ``cuda``): both instances launched on the same raw parts, each
against the plain version (``fx_finish_reference``) and against each
other within 2e-5 of each row's scale, at 8 (36 pairs), 65 and 128
channels with autos, K 1 and 3, 4096 bins, 384 and 400 (a row the tile
does not divide, and a tile across the fftshift's half), plain and
packed delays, with and without a carried mean; and the wrapper's
counters.
"""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.ops import fx_epilogue as fe  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.fx_fused import (MAX_SHARED_BYTES,  # noqa: E402
                                      pairs_tensor)
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402

SOURCE = Path(fe.__file__).resolve().parent.parent / "csrc" / "fx_finish.cu"

#: the benchmark's cells -> ((nch, nbl, nbins, K), (pair-tiled, tile,
#: chunk))
CELLS = {
    "effex2.engine": ((2, 1, 4096, 64), (False, 256, 0)),
    "effex2.live_spectrum": ((2, 1, 4096, 1), (False, 256, 0)),
    "array8.engine_int8": ((8, 36, 4096, 32), (True, 32, 36)),
    "meerkat_l4k.engine128_int8": ((128, 8256, 4096, 3), (True, 32, 8256)),
}


@pytest.mark.parametrize("cell", list(CELLS))
def test_plan_at_the_cells(cell):
    shape, want = CELLS[cell]
    plan = fe.finish_plan(*shape)
    assert (plan.tiled, plan.tile, plan.chunk) == want
    assert fe.finish_plan(*shape, continuum=True) == fe.BIN_PLAN


def test_plan_edges():
    """The threshold in pairs, K leaving the instance as it is, the chunks
    filling the grid, the shared memory a channel: past what a CTA holds at
    32 bins (433 channels) the narrow tile of 16 bins, past what it holds
    there (830) the one-bin-a-thread instance."""
    n = fe.FINISH_TILED_PAIRS
    assert fe.finish_plan(64, n - 1, 4096, 3) == fe.BIN_PLAN
    assert fe.finish_plan(64, n, 4096, 3).tiled
    for k in (1, 2, 3, 7):
        assert fe.finish_plan(128, 8256, 4096, k).tiled
    one = fe.finish_plan(128, 8256, 4096, 1)       # 128 tiles
    chunks = -(-8256 // one.chunk)
    assert chunks == 3 and 128 * chunks <= fe.FINISH_FILL_CTAS
    small = fe.finish_plan(8, 36, 384, 3)          # 12 tiles x 3 blocks
    assert 36 * -(-36 // small.chunk) <= fe.FINISH_FILL_CTAS
    wide = MAX_SHARED_BYTES // fe.FINISH_CHANNEL_BYTES
    assert fe.finish_plan(wide, 8256, 4096, 1).tile == fe.FINISH_TILE
    narrow = fe.finish_plan(wide + 1, 8256, 4096, 1)
    assert narrow.tiled and narrow.tile == fe.FINISH_NARROW_TILE
    assert fe.finish_tile(wide + 1) == fe.FINISH_NARROW_TILE
    most = MAX_SHARED_BYTES // ((2 * fe.FINISH_NARROW_TILE + 3) * 8)
    assert most == 830 and fe.finish_plan(most, 8256, 4096, 1).tiled
    assert fe.finish_plan(most + 1, 8256, 4096, 1) == fe.BIN_PLAN


def test_plan_constants_are_the_kernel_s():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kThreads") == fe.FINISH_THREADS
    assert const("kTileBins") == fe.FINISH_TILE
    assert const("kNarrowBins") == fe.FINISH_NARROW_TILE
    assert "(2 * bins + 3) * sizeof(float2)" in src
    assert f"constexpr size_t kMaxShared = {MAX_SHARED_BYTES};" in src
    assert fe.FINISH_CHANNEL_BYTES == (2 * fe.FINISH_TILE + 3) * 8


@pytest.mark.parametrize("nch,autos,ingest,blocks,want", [
    (128, True, "int8", 24, 3),          # meerkat_l4k.engine128_int8
    (8, True, "int8", 64, 63),           # array8.engine_int8
    (2, False, "complex64", 64, 64),     # effex2.engine
])
def test_engine_cells_keep_their_k(nch, autos, ingest, blocks, want):
    cfg = CorrelatorConfig(nchan=nch, include_autos=autos, nbins=4096,
                           num_samp=2**18, ntaps=4, ingest_dtype=ingest,
                           quant_step=1 / 32, device="cpu")
    assert FxEngine(cfg, fused=True).dispatch_batch_for(blocks) == want


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _inputs(nch, k, nbins, packed, carried, device, seed, s=32):
    """Raw parts laid out as a step's (xp, T and GJ rows of one tensor),
    block means near 0.1, delays within 8 samples at 856 MS/s."""
    rng = np.random.default_rng(seed)
    pairs_np = baseline_pairs(nch, True)
    nbl = len(pairs_np)
    parts = torch.from_numpy(
        (rng.normal(size=(k, nbl + 2 * nch, nbins))
         + 1j * rng.normal(size=(k, nbl + 2 * nch, nbins))).astype(
            np.complex64) * s).to(device)
    mu = torch.from_numpy((0.1 * (rng.normal(size=(k, nch))
                                  + 1j * rng.normal(size=(k, nch)))).astype(
        np.complex64)).to(device)
    mu_prev = torch.from_numpy((0.1 * (rng.normal(size=nch) + 1j * rng.normal(
        size=nch))).astype(np.complex64)).to(device) if carried else None
    d = rng.uniform(-8, 8, (k, nch)) / 856e6
    delays = torch.as_tensor(pack_delays(d, 1284e6) if packed else d,
                             dtype=torch.float32, device=device)
    w2d = pfb_window(4, nbins, "hamming").reshape(4, nbins)
    return dict(xp=parts[:, :nbl], T=parts[:, nbl:nbl + nch],
                GJ=parts[:, nbl + nch:], mu=mu,
                pairs=pairs_tensor(pairs_np, nch, device),
                consts=dc_constants(w2d, nbins, s, device), delays=delays,
                tables=fe.FinishTables(pairs_np, nbins, 856e6, 1284e6,
                                       device),
                n_frames=s, bandwidth=856e6, continuum=False,
                mu_prev=mu_prev)


def _held(got, want, tol, what):
    scale = want.abs().amax(dim=-1, keepdim=True)
    err = ((got - want).abs() / scale).max().item()
    assert err <= tol, f"{what}: {err:.3g} of a row's scale"


@pytest.mark.cuda
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("nbins", [4096, 384, 400])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("nch", [8, 65, 128])
def test_cuda_tiled_epilogue_matches_plain_version(cuda_device, nch, k, nbins,
                                                   packed, carried):
    """The pair-tiled instance and the one-bin-a-thread one on the same
    parts: each within 2e-5 of each row's scale of the plain version, and
    of each other."""
    a = _inputs(nch, k, nbins, packed, carried, cuda_device,
                seed=nch + 10 * k + nbins + 2 * packed + carried)
    nbl = a["pairs"].shape[0]
    tiled = fe.finish_launch(fe.tiled_plan(nbl, nbins, k), **a)
    bins = fe.finish_launch(fe.BIN_PLAN, **a)
    want = fe.fx_finish_reference(**a)
    torch.cuda.synchronize()
    assert tiled.shape == want.shape == (k, nbl, nbins)
    _held(tiled, want, 2e-5, "pair-tiled against the plain version")
    _held(bins, want, 2e-5, "one bin a thread against the plain version")
    _held(tiled, bins, 2e-5, "the two instances")


@pytest.mark.cuda
def test_cuda_wrapper_counts_the_tiled_instance(cuda_device):
    """``fx_finish`` at 128 channels takes the pair-tiled instance: one
    launch moves ``fx_finish.launches`` and ``fx_finish.tiled`` by one
    each; at 2 channels the one-bin-a-thread one, ``tiled`` unmoved."""
    for nch, tiled in ((128, 1), (2, 0)):
        a = _inputs(nch, 3, 4096, True, True, cuda_device, seed=nch)
        before = (fe.fx_finish.launches, fe.fx_finish.tiled)
        got = fe.fx_finish(**a)
        want = fe.fx_finish_reference(**a)
        torch.cuda.synchronize()
        assert (fe.fx_finish.launches, fe.fx_finish.tiled) == (
            before[0] + 1, before[1] + tiled)
        _held(got, want, 2e-5, f"fx_finish at {nch} channels")
