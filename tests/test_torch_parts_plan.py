"""The single pass's launch plan (``fxtpu_torch.ops.fx_fused.plan_parts``)
at the benchmark's cells and the deep-tap SVD block, in both ingests.

The plan's integers, the step entry's integer arguments
(``cuda_build.StepArgs``) and every buffer's shape are held to the values
the step planned before the plan was one function (recorded from
``fx_epilogue.check_step`` / ``step_buffers`` / ``step_args``), and the
engine's step (``check_step``) and the parts wrappers (``fx_fused_parts``,
``fx_fused_parts_i8``) plan alike.  Only shapes are planned: the samples
are ``torch.empty`` (never written or read), so MeerKAT's 128 inputs take
no memory here."""

import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fxtpu_torch.cuda_build import StepArgs  # noqa: E402
from fxtpu_torch.ops import fx_epilogue as fe  # noqa: E402
from fxtpu_torch.ops import fx_fused as ff  # noqa: E402
from fxtpu_torch.ops.dc_posthoc import dc_constants  # noqa: E402
from fxtpu_torch.ops.window import pfb_window  # noqa: E402
from fxtpu_torch.ops.xengine import baseline_pairs, pack_delays  # noqa: E402

STEP = 1.0 / 32
#: case -> (nch, autos, K, S, nbins, ntaps, SVD-FIR mode): the cells of
#: BENCHMARK.json (their configurations and mixes' K) and the CLI's
#: deep-tap block (--resolution 8192 --ntaps 32)
CASES = {
    "effex2.engine": (2, False, 64, 64, 4096, 4, False),
    "array8.engine_int8": (8, True, 32, 64, 4096, 4, False),
    "meerkat_l4k.engine128_int8": (128, True, 3, 64, 4096, 4, False),
    "effex2.live_spectrum": (2, False, 1, 64, 4096, 4, False),
    "deep_svd": (2, False, 1, 32, 8192, 32, True),
}
#: case -> (route, rank, nbl, n_groups, per, the X kernel's plan (tile,
#: slots, rows, frames, stages, threads, split) or None, the row map's
#: side or None), as recorded
PLANS = {
    "effex2.engine": ("shared", 0, 1, 64, 1, None, None),
    "array8.engine_int8": ("global", 0, 36, 64, 1,
                           (32, 8, 8, 16, 3, 256, 1), None),
    "meerkat_l4k.engine128_int8": ("global", 0, 8256, 64, 1,
                                   (4, 64, 64, 8, 3, 256, 2), 128),
    "effex2.live_spectrum": ("shared", 0, 1, 64, 1, None, None),
    "deep_svd": ("shared", 6, 1, 32, 1, None, None),
}
#: case -> the epilogue's plan (fx_epilogue.finish_plan): (pair-tiled
#: instance, tile, chunk); MeerKAT's 8,256 pairs and array8's 36 on the
#: pair-tiled one, a CTA's chunk every pair (the grid 384 and 4096 CTAs
#: already), the single pair on the one-bin-a-thread instance
FINISH = {
    "effex2.engine": (False, 256, 0),
    "array8.engine_int8": (True, 32, 36),
    "meerkat_l4k.engine128_int8": (True, 32, 8256),
    "effex2.live_spectrum": (False, 256, 0),
    "deep_svd": (False, 256, 0),
}
#: case -> buffer -> shape, as recorded (new_hist: the history's, complex64
#: [nch, ntaps-1, nbins] or int8 [..., 2]; sums float64, int64 for 8 bits)
BUFFERS = {
    "effex2.engine": dict(
        sums=(64, 64, 2, 2), scratch=(64, 64, 5, 4096), parts=(64, 5, 4096),
        mu=(64, 2), vis=(64, 1, 4096)),
    "array8.engine_int8": dict(
        sums=(32, 64, 8, 2), scratch=(32, 8, 64, 4096),
        parts=(32, 52, 4096), mu=(32, 8), vis=(32, 36, 4096)),
    "meerkat_l4k.engine128_int8": dict(
        sums=(3, 64, 128, 2), scratch=(3, 128, 64, 4096),
        parts=(3, 8512, 4096), mu=(3, 128), vis=(3, 8256, 4096)),
    "effex2.live_spectrum": dict(
        sums=(1, 64, 2, 2), scratch=(1, 64, 5, 4096), parts=(1, 5, 4096),
        mu=(1, 2), vis=(1, 1, 4096)),
    "deep_svd": dict(
        sums=(1, 32, 2, 2), scratch=(1, 32, 5, 8192), parts=(1, 5, 8192),
        fir=(2, 32, 8192), mu=(1, 2), vis=(1, 1, 8192)),
}


def _step_args(case, ingest):
    """``check_step``'s arguments at ``case``: the samples empty, the
    history zero, packed delays, SPECTRUM."""
    nch, autos, k, s, nbins, ntaps, svd_on = CASES[case]
    w2d = pfb_window(ntaps, nbins, "hamming").reshape(ntaps, nbins)
    w = torch.as_tensor(np.asarray(w2d, np.float32))
    svd = ff.svd_tensors(w2d, "cpu") if svd_on else None
    pairs_np = baseline_pairs(nch, autos)
    tables = fe.FinishTables(pairs_np, nbins, 2.4e6, 1.4204e9, "cpu")
    delays = torch.as_tensor(pack_delays(np.zeros((k, nch)), 1.4204e9))
    if ingest == "int8":
        x = torch.empty((nch, k, s, nbins, 2), dtype=torch.int8)
        hist = {"tail": torch.zeros((nch, ntaps - 1, nbins, 2),
                                    dtype=torch.int8),
                "mu_prev": torch.zeros(nch, dtype=torch.complex64)}
    else:
        x = torch.empty((nch, k, s, nbins), dtype=torch.complex64)
        hist = torch.zeros((nch, ntaps - 1, nbins), dtype=torch.complex64)
    return (x, hist, w, ff.pairs_tensor(pairs_np, nch, "cpu"),
            dc_constants(w2d, nbins, s, "cpu", svd), delays, tables, 2.4e6,
            False, STEP if ingest == "int8" else None, svd)


def _same(a, b):
    """Two plan fields alike: the same tensor (or tuple of them), or
    equal values."""
    if isinstance(a, torch.Tensor) or (isinstance(a, tuple) and a
                                       and isinstance(a[0], torch.Tensor)):
        return a is b
    return a == b


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_plan_is_the_recorded_one(case, ingest, monkeypatch):
    nch, autos, k, s, nbins, ntaps, _ = CASES[case]
    route, rank, nbl, n_groups, per, xplan, side = PLANS[case]
    args = _step_args(case, ingest)
    plan = fe.check_step(*args)
    got_xplan = (None if plan.xplan is None
                 else (*plan.xplan.args(), plan.xplan.split))
    assert (plan.route, plan.rank, plan.k, plan.nch, plan.s_rows,
            plan.nbins, plan.ntaps, plan.nbl, plan.n_groups, plan.per,
            got_xplan) == (route, rank, k, nch, s, nbins, ntaps, nbl,
                           n_groups, per, xplan)
    assert (None if plan.rowmap is None
            else tuple(plan.rowmap.shape)) == (None if side is None
                                               else (side, side))
    assert plan.fir == ("fir" in BUFFERS[case])
    fplan = plan.finish_plan
    assert (fplan.tiled, fplan.tile, fplan.chunk) == FINISH[case]

    bufs = fe.step_buffers(plan)
    int8 = ingest == "int8"
    hist = args[1]["tail"] if int8 else args[1]
    want = dict(BUFFERS[case], new_hist=tuple(hist.shape))
    assert {n: tuple(t.shape) for n, t in bufs.items()} == want
    assert list(bufs) == ["sums", "scratch", "parts",
                          *(["fir"] if "fir" in want else []), "mu",
                          "new_hist", "vis"]
    assert bufs["sums"].dtype == (torch.int64 if int8 else torch.float64)
    assert bufs["new_hist"].dtype == hist.dtype

    sargs = fe.step_args(plan, bufs)
    ints = {n: getattr(sargs, n) for n, t in StepArgs._fields_
            if t is ctypes.c_int}
    plan_ints = xplan[:6] if xplan is not None else (0,) * 6
    assert ints == dict(
        nch=nch, K=k, S=s, nbins=nbins, ntaps=ntaps, nbl=nbl,
        n_groups=n_groups, frames_per_group=per,
        wide=int(route == "global"), packed=1, continuum=0,
        **dict(zip(("tile", "slots", "rows", "frames", "stages", "threads"),
                   plan_ints)), finish_chunk=FINISH[case][2])

    # the parts wrapper plans alike: its card path, up to the launch
    seen = {}

    def launch(p, b):
        seen.update(plan=p, bufs=b)
        return ()

    monkeypatch.setattr(ff, "on_card", lambda x, name: True)
    monkeypatch.setattr(ff, "launch_parts", launch)
    x, _, w, pairs, consts, *_, step, svd = args
    if int8:
        ff.fx_fused_parts_i8(x, hist, w, pairs, step, svd, consts)
    else:
        ff.fx_fused_parts(x, hist, w, pairs, svd, consts)
    parts = seen["plan"]
    assert type(parts) is ff.PartsPlan
    for field in dataclasses.fields(ff.PartsPlan):
        assert _same(getattr(parts, field.name),
                     getattr(plan, field.name)), field.name
    assert {n: tuple(t.shape) for n, t in seen["bufs"].items()} == {
        n: v for n, v in want.items() if n != "vis"}


def _counters() -> dict:
    """Every launch counter of the single pass, the kernels it launches
    and the two-pass wrappers, by ``wrapper.attribute``."""
    from fxtpu_torch.ops.fx_xstage import fx_xstage
    out = {}
    for fn in (ff.fx_fused_parts, ff.fx_fused_parts_i8, ff.fx_fused_raw,
               ff.fx_fused_raw_i8, ff.fx_fused_raw_multi,
               ff.fx_fused_raw_i8_multi, ff.parts_reduce, ff.fir_rows,
               fx_xstage, fe.fx_finish):
        for attr in ("launches", "svd_launches", "wide_launches",
                     "wide_svd_launches", "ctas", "spectra_reads",
                     "tiled"):
            if hasattr(fn, attr):
                out[f"{fn.__name__}.{attr}"] = getattr(fn, attr)
    return out


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("case", list(CASES))
def test_one_count_moves_what_the_engine_reports(case, ingest):
    """``count_launches`` over a step's plan and the epilogue's count (as
    ``launch_step`` counts a step) moves each counter that
    ``FxEngine.launch_counts()`` reports at the same shape, by what it
    reports, and no other: the frame kernel's by route and FIR mode, the
    reduce or X (its launches, CTAs and tiled launches), the deep-tap FIR
    and the epilogue (and its pair-tiled instance's where the plan takes
    it), once each."""
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.fx import FxEngine
    nch, autos, k, s, nbins, ntaps, _ = CASES[case]
    eng = FxEngine(CorrelatorConfig(
        nchan=nch, include_autos=autos, num_samp=s * nbins, nbins=nbins,
        ntaps=ntaps, clamp_num_samp=False, ingest_dtype=ingest,
        device="cpu"), fused=True)
    plan = fe.check_step(*_step_args(case, ingest))
    assert eng.x_stage == plan.route and eng.fir_mode == (
        "svd" if plan.rank else "direct")
    before, reported = _counters(), eng.launch_counts()
    ff.count_launches(plan, fe.count_finish)
    moved = {n: v - before[n] for n, v in _counters().items()
             if v != before[n]}
    now = eng.launch_counts()
    delta = {n: now[n] - reported[n] for n in now}
    tiled = FINISH[case][0]
    assert list(now)[-2 if tiled else -1] == "fx_finish"
    assert ("fx_finish.tiled" in now) == tiled
    assert moved.get("fx_finish.tiled") == (1 if tiled else None)
    assert sorted(v for v in delta.values() if v) == sorted(moved.values())
    ctas = plan.xplan.ctas(nbins, k) if plan.xplan is not None else None
    reads = plan.xplan.reads if plan.xplan is not None else None
    assert all(v == 1 for n, v in moved.items()
               if n not in ("fx_xstage.ctas", "fx_xstage.spectra_reads"))
    assert moved.get("fx_xstage.ctas") == ctas
    assert moved.get("fx_xstage.spectra_reads") == reads
    # the one counter the engine reports that a launch may leave: the
    # tiled X instance's, which the row instance does not move
    assert [n for n, v in delta.items() if not v] == (
        ["fx_xstage.tiled"] if ctas and not plan.xplan.tiled else [])
