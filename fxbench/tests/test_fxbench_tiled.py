"""The tiled reference, the ``engine_any`` driver and the X stage's
readers: ``reference.fx_tiled`` equals ``reference.fx.fx_block`` bit for
bit at any tiling, in float64 and as the bfloat16 control; the driver
refuses a route its mix does not name before it stages anything, and its
cells run correct at the CPU's size, where the control fails them; the
X stage's work and metrics by hand."""

import numpy as np
import pytest
import torch

from fxbench import streams, xstage_work
from fxbench.cells import Record, metric_reader
from fxbench.reference import fx, fx_tiled
from fxbench.run import result_line
from fxbench.tests.conftest import tiny_cell


@pytest.mark.parametrize("rnd", [fx.exact, fx.bf16], ids=["exact", "bf16"])
def test_tiled_reference_is_fx_block_bit_for_bit(rnd):
    """12 channels with autos (78 pairs), 8-bit samples, a block and the
    one before it; tiles of one pair, of 5 and 7 pairs (a ragged last
    tile) and of every pair."""
    nch, s, nbins = 12, 16, 256
    x = streams.stream(2**33 + 5, nch, 2 * s * nbins,
                       list(np.linspace(-3, 3, nch)), 10.0, 0.5, "cpu")
    q = streams.quantize(x, 1 / 32).reshape(nch, 2, s * nbins, 2)
    cur = fx.dequantize(q[:, 1], 1 / 32, rnd)
    prev = fx.dequantize(q[:, 0], 1 / 32, rnd)
    w2d, pairs = fx.prototype(4, nbins), fx.baselines(nch, True)
    delays = list(np.linspace(-1e-6, 1e-6, nch))
    want = fx.fx_block(cur, prev, w2d, pairs, delays, 2.4e6, 1.42e9,
                       rnd=rnd)
    pair_bytes = s * nbins * want.element_size()
    for per in (1, 5, 7, len(pairs)):
        got = fx_tiled.fx_block(cur, prev, w2d, pairs, delays, 2.4e6,
                                1.42e9, rnd=rnd, tile_bytes=per * pair_bytes)
        assert torch.equal(got, want), per
    first = fx_tiled.fx_block(cur, None, w2d, pairs, delays, 2.4e6, 1.42e9,
                              rnd=rnd, tile_bytes=5 * pair_bytes)
    assert torch.equal(first, fx.fx_block(cur, None, w2d, pairs, delays,
                                          2.4e6, 1.42e9, rnd=rnd))


@pytest.mark.parametrize("change", [{"x_stage": "global"},
                                    {"ingest": "int8"}])
def test_engine_any_refuses_another_route_before_staging(change,
                                                         monkeypatch):
    """The flagship cell's engine takes the shared route on complex64
    samples; a mix that names another X stage or ingest is refused before
    the stream is made."""
    def staged(*a, **k):
        raise AssertionError("the driver staged samples")

    monkeypatch.setattr(streams, "stream", staged)
    cell = tiny_cell("effex2.engine")
    cell.mix.update(change)
    with pytest.raises(RuntimeError, match="the engine took the route"):
        cell.driver.run(cell, seed=2**31 + 5, seconds=0.5, trace=False,
                        device="cpu")


def test_meerkat_cell_refuses_a_shared_route():
    cell = tiny_cell("meerkat_l4k.engine128_int8")
    cell.mix["x_stage"] = "shared"
    with pytest.raises(RuntimeError, match="x_stage=global"):
        cell.driver.engine_for(cell, "cpu")


def _narrow(cell, nch):
    """The cell at ``nch`` of its inputs (the CPU's cut of the width)."""
    cell.config["correlator"]["nchan"] = nch
    cell.mix["delays_s"] = cell.mix["delays_s"][:nch]
    cell.mix["blocks"] = 3
    return cell


@pytest.mark.parametrize("workload,nch", [("effex2.engine", None),
                                          ("meerkat_l4k.engine128_int8", 66)])
def test_engine_any_cells_pass_and_their_control_fails(workload, nch):
    """Each cell at the CPU's size (the meerkat cell at 66 inputs, past
    one CTA's rows): correct, on the route its mix names, and the
    bfloat16 control's readings past every limit."""
    cell = tiny_cell(workload)
    if nch is not None:
        _narrow(cell, nch)
    out = cell.driver.run(cell, seed=2**33 + 7, seconds=0.5, trace=True,
                          device="cpu", control=True)
    line = result_line(cell, out, False, {}, 1.0)
    assert line["correct"], line["checks"]
    assert out.attempted > 0
    for name, limit in cell.limits.items():
        assert out.control[name] > limit, (name, out.control)


def test_xstage_work_by_hand():
    """MeerKAT's block: 8 x 8,256 pairs x 64 frames x 4096 bins = 17.3
    GFLOP; 128 channels' spectra (268 MB) read and 8,512 rows of parts
    (279 MB) written."""
    ops, nbytes = xstage_work.xstage_work(nchan=128, n_baselines=8256,
                                          num_samp=2**18, nbins=4096, k=1)
    assert ops == 8 * 8256 * 64 * 4096 == pytest.approx(17.31e9, rel=1e-3)
    assert nbytes == 8 * 128 * 64 * 4096 + 8 * 8512 * 4096
    ops3, bytes3 = xstage_work.xstage_work(nchan=128, n_baselines=8256,
                                           num_samp=2**18, nbins=4096, k=3)
    assert (ops3, bytes3) == (3 * ops, 3 * nbytes)
    assert xstage_work.xstage_seconds(None) is None
    assert xstage_work.xstage_seconds([["fx_frames_kernel", 1.0]]) is None
    assert xstage_work.xstage_seconds(
        [["void (anonymous namespace)::fx_xstage_kernel<char2, 8>", 2.0],
         ["fx_frames_kernel", 1.0],
         ["void (anonymous namespace)::fx_xstage_kernel<float2, 8>", 0.5]]
    ) == 2.5


def test_xstage_readers():
    share = metric_reader("kernels.xstage_share")
    roof = metric_reader("kernels.xstage_roofline")
    empty = Record(spans={}, counters={}, trace=None)
    assert share(empty) is None and roof(empty) is None
    no_x = Record(spans={}, counters={},
                  trace={"kernel_s": 1.0, "xstage_s": None,
                         "xstage_least_s": None})
    assert share(no_x) is None and roof(no_x) is None
    rec = Record(spans={}, counters={},
                 trace={"kernel_s": 2.0, "xstage_s": 1.5,
                        "xstage_least_s": 0.06})
    assert share(rec) == pytest.approx(75.0)
    assert roof(rec) == pytest.approx(4.0)
