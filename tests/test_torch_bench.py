"""``python -m fxtpu_torch.bench`` on the CPU, the port of ``bench.py``:
the same configurations, metric names and JSON line (each flag
combination against ``bench.py``'s own line, both measurements stubbed),
the device step's result keys at a small shape against ``bench.py``'s
``bench``, the split of K blocks into calls that one launch takes, held
to one call on the fused route's plain versions, both pipelines, the
roofline's count against ``chip_smoke.py``'s bound, the smoke's kernel
checks at each configuration's largest call, and the error line
without a card.  The rates on the CPU are no measurement of any device."""

import functools
import importlib.util
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch import bench as port  # noqa: E402
from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(block_pow=13, nbins=256)
#: The roofline's keys in each package (the port's model is the card's).
REF_ROOFLINE = {"model_mxu_flops_per_sample", "model_vpu_flops_per_sample",
                "mxu_tflops", "mfu", "hbm_frac"}
PORT_ROOFLINE = {"model_flops_per_sample", "tflops", "flop_frac", "hbm_frac",
                 "blocks_per_dispatch"}
#: The K cap of one launch at each configuration's shape on the fused
#: route (ops.fx_fused.max_blocks_parts) and the calls it makes of K.
CAPS = {"default": (25, [22, 22, 21, 21, 21, 21]),
        "default_int8": (25, [22, 22, 21, 21, 21, 21]),
        "wideband": (25, [22, 21, 21]),
        "wideband_int8": (25, [16, 16]),
        "nchan8": (15, [13, 13, 13, 13, 12])}


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """``bench.py``, loaded by its path as tests/test_runtime.py loads it
    (its module body imports no JAX)."""
    return _load("bench", os.path.join(REPO, "bench.py"))


def _line(capsys):
    out = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    assert len(out) == 1, out
    return json.loads(out[0])


def test_configs_are_bench_py_s(ref):
    assert port.CONFIGS == ref.CONFIGS
    assert (port.REFERENCE_AGGREGATE_SAMPLES_PER_S
            == ref.REFERENCE_AGGREGATE_SAMPLES_PER_S)


def _fakes(bpd):
    step = {"samples_per_s": 3.2e9, "spectra_per_s": 1.5e5,
            "block_seconds": 1e-4, "num_samp": 2 ** 21, "nbins": 4096,
            "nchan": 2, "blocks_per_dispatch": bpd}
    pipe = {"samples_per_s": 2.1e8, "blocks": 99, "blocks_per_dispatch": 8}
    host = {"samples_per_s": 5.0e8, "blocks": 120, "bytes_per_s": 4.0e9,
            "drops": 0}
    return (lambda **kw: dict(step), lambda **kw: dict(pipe),
            lambda **kw: dict(host))


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
@pytest.mark.parametrize("host_pipeline", [False, True])
@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("config", sorted(port.CONFIGS))
def test_metric_and_keys_are_bench_py_s(ref, monkeypatch, capsys, config,
                                        pipeline, host_pipeline, ingest):
    """Every flag combination: the metric is bench.py's letter for letter,
    and the line's keys are bench.py's but for the roofline's own and
    ``blocks_per_dispatch`` (each measurement stubbed in both modules)."""
    pytest.importorskip("jax")
    argv = ["--config", config, "--ingest", ingest]
    argv += ["--pipeline"] * pipeline + ["--host_pipeline"] * host_pipeline
    for mod in (ref, port):
        step, pipe, host = _fakes(3)
        monkeypatch.setattr(mod, "bench", step)
        monkeypatch.setattr(mod, "bench_pipeline", pipe)
        monkeypatch.setattr(mod, "bench_host_pipeline", host)
    monkeypatch.setattr(ref, "_wait_for_backend", lambda: None)
    capsys.readouterr()
    ref.main(argv)
    theirs = _line(capsys)
    assert port.main(["--cpu", *argv]) == 0
    ours = _line(capsys)
    assert ours["metric"] == theirs["metric"] == port.metric_name(
        config, pipeline, host_pipeline, ingest)
    assert set(ours) - set(theirs) <= PORT_ROOFLINE
    assert set(theirs) - set(ours) <= REF_ROOFLINE
    assert ours["value"] == theirs["value"]
    assert ours["vs_baseline"] == theirs["vs_baseline"]
    if not (pipeline or host_pipeline):
        assert ours["blocks_per_dispatch"] == 3
        assert ours["precision"] == "high"


@pytest.mark.parametrize("k, ingest", [(1, "complex64"), (3, "complex64"),
                                       (3, "int8")])
def test_bench_keys_are_bench_py_s(ref, k, ingest):
    """``bench`` at a small shape on the CPU: bench.py's ``bench``'s keys
    and ``blocks_per_dispatch``, a positive rate, K blocks in one call on
    the plain route."""
    pytest.importorskip("jax")
    kw = dict(SMALL, blocks_per_call=k, iters=1, warmup=1, ingest=ingest)
    theirs = ref.bench(**kw)
    ours = port.bench(device="cpu", **kw)
    assert set(ours) == set(theirs) | {"blocks_per_dispatch"}
    assert ours["samples_per_s"] > 0 and ours["spectra_per_s"] > 0
    assert ours["blocks_per_dispatch"] == k
    for key in ("num_samp", "nbins", "nchan"):
        assert ours[key] == theirs[key]


@pytest.mark.parametrize("k, most", [(128, 25), (64, 25), (32, 25), (64, 15),
                                     (5, 2), (8, 8), (7, 100), (1, 1)])
def test_dispatch_sizes(k, most):
    sizes = port.dispatch_sizes(k, most)
    assert sum(sizes) == k and len(sizes) == -(-k // most)
    assert max(sizes) <= most and max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)


@pytest.mark.parametrize("config", sorted(port.CONFIGS))
def test_caps_at_the_configs(config):
    """The fused route's K cap at each configuration's full shape, and the
    calls ``bench`` makes of its K (engines only: no block is made)."""
    kw = port.CONFIGS[config]
    cfg = CorrelatorConfig(
        mode="SPECTRUM", nchan=kw["nchan"], num_samp=2 ** kw["block_pow"],
        nbins=kw["nbins"], ntaps=kw.get("ntaps", 4),
        include_autos=kw.get("include_autos", False), clamp_num_samp=False,
        ingest_dtype=kw.get("ingest", "complex64"), device="cpu")
    eng = FxEngine(cfg, fused=True)
    k = kw.get("blocks_per_call", 128)
    most, sizes = CAPS[config]
    assert eng.dispatch_batch_for(k) == most
    assert port.dispatch_sizes(k, most) == sizes


def _history_err(a, b):
    if isinstance(a, dict):
        return max(float((a[key].to(torch.complex64)
                          - b[key].to(torch.complex64)).abs().max())
                   for key in a)
    return float((a - b).abs().max())


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_k_split_matches_one_call(ingest):
    """K = 5 blocks as calls of 2, 2 and 1 (the cap forced to 2) on the
    fused route's plain versions against one 5-block call: vis within
    1e-5 of max|vis| (tests/test_planes.py:576), history within 1e-6."""
    cfg = CorrelatorConfig(mode="SPECTRUM", nchan=2, num_samp=2 ** 13,
                           nbins=256, ntaps=4, clamp_num_samp=False,
                           ingest_dtype=ingest, device="cpu")
    eng = FxEngine(cfg, fused=True)
    assert eng.fused_active and not eng.kernel_active
    k = 5
    blocks = list(port._blocks(5, k, 2, 2 ** 13, ingest))
    vis1, hist1 = eng.multi_step(eng.prepare_batch(blocks),
                                 torch.zeros((k, 2)), eng.fresh_history())
    eng.dispatch_batch_for = lambda requested: 2
    calls = port.stage_calls(eng, blocks, k)
    assert [d.shape[0] for _, d in calls] == [2, 2, 1]
    vis, hist = port.run_calls(eng.multi_step, calls, eng.fresh_history())
    vis = torch.cat(vis)
    scale = float(vis1.abs().max())
    assert vis.shape == vis1.shape
    assert float((vis - vis1).abs().max()) <= 1e-5 * scale
    assert _history_err(hist, hist1) <= 1e-6


@pytest.mark.parametrize("k", [1, 2])
def test_bench_pipeline(tmp_path, monkeypatch, k):
    """The Correlator over the looping replay for 1 s: blocks correlated
    at a positive steady rate, K as asked."""
    monkeypatch.chdir(tmp_path)   # the Correlator's log file
    res = port.bench_pipeline(nchan=2, seconds=1, blocks_per_dispatch=k,
                              device="cpu", **SMALL)
    assert set(res) == {"samples_per_s", "blocks", "blocks_per_dispatch"}
    assert res["samples_per_s"] > 0 and res["blocks"] >= 2
    assert res["blocks_per_dispatch"] == k


@pytest.mark.parametrize("channel_feeders", [True, False])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_host_pipeline_bench_smoke(ingest, channel_feeders):
    """tests/test_runtime.py::test_host_pipeline_bench_smoke on the port:
    the host data plane with the device stubbed runs above 1e6 samples/s
    and drops nothing."""
    res = port.bench_host_pipeline(block_pow=16, seconds=0.5, ingest=ingest,
                                   channel_feeders=channel_feeders,
                                   device="cpu")
    assert set(res) == {"samples_per_s", "blocks", "bytes_per_s", "drops"}
    assert res["samples_per_s"] > 1e6
    assert res["drops"] == 0
    assert res["bytes_per_s"] == res["samples_per_s"] * (
        2 if ingest == "int8" else 8)


@pytest.fixture(scope="module")
def smoke():
    return _load("chip_smoke_for_bench", os.path.join(REPO, "chip_smoke.py"))


@pytest.mark.parametrize("config", sorted(port.CONFIGS))
def test_roofline_count_is_fx_bound_s(smoke, monkeypatch, config):
    """The roofline's float32 operations per sample equal those of
    chip_smoke.py's ``fx_bound`` for one block of the configuration."""
    kw = port.CONFIGS[config]
    nchan, nbins = kw["nchan"], kw["nbins"]
    ntaps, autos = kw.get("ntaps", 4), kw.get("include_autos", False)
    case = dict(nch=nchan, nsamp=2 ** kw["block_pow"], nbins=nbins,
                ntaps=ntaps, autos=autos)
    monkeypatch.setattr(smoke, "HBM_BYTES_PER_S", float("inf"))
    ms, by = smoke.fx_bound(case, 1, kw.get("ingest") == "int8", 0)
    assert by == "operations"
    per_sample = ms / 1e3 * smoke.FP32_FLOPS / (nchan * case["nsamp"])
    nbl = nchan * (nchan - 1) // 2 + (nchan if autos else 0)
    got = port.roofline(1e9, nbins=nbins, ntaps=ntaps, nchan=nchan,
                        n_baselines=nbl, device_kind="cpu")
    assert got["model_flops_per_sample"] == pytest.approx(per_sample,
                                                          rel=1e-12)
    assert set(got) == {"precision", "model_flops_per_sample", "tflops",
                        "hbm_gbps"}


@pytest.mark.parametrize("config", sorted(port.CONFIGS))
def test_smoke_checks_the_largest_call(smoke, config):
    """chip_smoke.py holds each configuration's kernels against their plain
    versions at its largest call: the configuration's shape, the largest
    of the calls ``bench`` makes of its K, and the single pass's route and
    FIR mode at that shape."""
    from fxtpu_torch.ops import fx_fused as ff
    from fxtpu_torch.ops import pfb_window, svd_tensors
    cases = {name: rest for name, *rest in smoke.bench_cases()}
    case, k, fir, int8 = cases[config]
    kw = port.CONFIGS[config]
    assert case == dict(nch=kw["nchan"], nsamp=2 ** kw["block_pow"],
                        nbins=kw["nbins"], ntaps=kw.get("ntaps", 4),
                        autos=kw.get("include_autos", False))
    _, sizes = CAPS[config]
    entry, deep, per_iter, largest = smoke.BENCH_ROUTES[config]
    assert k == largest == max(sizes) and per_iter == len(sizes)
    assert int8 == (kw.get("ingest") == "int8") == ("_i8" in entry)
    w = pfb_window(case["ntaps"], case["nbins"]).reshape(
        case["ntaps"], case["nbins"])
    svd = svd_tensors(w, "cpu") if case["ntaps"] >= 16 else None
    assert fir == ("direct" if svd is None else "svd") and deep == (
        svd is not None)
    rank = 0 if svd is None else svd[0].shape[1]
    route = ff.x_route(case["nbins"], case["ntaps"], case["nch"], rank,
                       "auto")
    assert (route == "global") == ("wide" in entry)


def test_roofline_shares_on_the_card():
    """On an H100 the shares of its peaks are reported; one above 1.05
    raises (a wrong count or timing window, not a reading)."""
    kind = "NVIDIA H100 80GB HBM3"
    kw = dict(nbins=4096, ntaps=4, nchan=2, n_baselines=1, device_kind=kind)
    got = port.roofline(3.35e10, **kw)
    assert got["hbm_frac"] == 0.08
    flops = 2 + 16 + 5 * 12 + 4
    assert got["flop_frac"] == round(3.35e10 * flops / 67e12, 3)
    assert port.roofline(4.1e11, **kw)["hbm_frac"] == pytest.approx(0.979)
    with pytest.raises(ValueError, match="hbm_frac"):
        port.roofline(4.5e11, **kw)


def _tiny_configs():
    return {name: dict(kw, **SMALL,
                       blocks_per_call=min(kw.get("blocks_per_call", 128), 3))
            for name, kw in port.CONFIGS.items()}


@pytest.mark.parametrize("config", sorted(port.CONFIGS))
def test_main_cpu_every_config(monkeypatch, capsys, config):
    """``main(["--cpu", "--config", c])`` with the configurations cut to
    2^13 samples, 256 bins and 3 blocks: one JSON line, the config's
    metric, a positive rate, the roofline without the card's shares."""
    monkeypatch.setattr(port, "CONFIGS", _tiny_configs())
    assert port.main(["--cpu", "--config", config, "--iters", "1"]) == 0
    line = _line(capsys)
    assert line["metric"] == port.metric_name(config)
    assert line["value"] > 0 and line["device"] == "cpu"
    assert "error" not in line and "flop_frac" not in line
    assert line["blocks_per_dispatch"] == 3


@pytest.mark.parametrize("flags", [["--pipeline"],
                                   ["--pipeline", "--ingest", "int8"],
                                   ["--host_pipeline"],
                                   ["--host_pipeline", "--single_feeder",
                                    "--ingest", "int8"]])
def test_main_cpu_pipelines(tmp_path, monkeypatch, capsys, flags):
    """Both pipelines through ``main`` on the CPU at a small block for 1
    s (``--seconds``): one line with bench.py's metric."""
    monkeypatch.chdir(tmp_path)
    pipe = "--pipeline" in flags
    name = "bench_pipeline" if pipe else "bench_host_pipeline"
    small = SMALL if pipe else dict(block_pow=16)
    monkeypatch.setattr(port, name,
                        functools.partial(getattr(port, name), **small))
    assert port.main(["--cpu", "--seconds", "1", *flags]) == 0
    line = _line(capsys)
    ingest = "int8" if "int8" in flags else "complex64"
    assert line["metric"] == port.metric_name(
        pipeline=pipe, host_pipeline=not pipe, ingest=ingest)
    assert line["value"] > 0 and "error" not in line
    if not pipe:
        assert line["drops"] == 0


@pytest.mark.parametrize("flags", [[], ["--config", "nchan8"],
                                   ["--pipeline", "--ingest", "int8"],
                                   ["--host_pipeline"]])
def test_no_card_prints_the_error_line(monkeypatch, capsys, flags):
    """Without a card and without --cpu: the error line under the flags'
    metric, exit status 1, and nothing measured on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_measurement(**kw):
        raise AssertionError("measured without a card")
    for name in ("bench", "bench_pipeline", "bench_host_pipeline"):
        monkeypatch.setattr(port, name, no_measurement)
    assert port.main(flags) == 1
    line = _line(capsys)
    args = port._parser().parse_args(flags)
    assert line == {"metric": port.metric_name(
        args.config, args.pipeline, args.host_pipeline, args.ingest),
        "value": 0, "unit": "samples/s", "vs_baseline": 0.0,
        "error": "backend_unavailable: no CUDA device"}


def test_a_failed_measurement_prints_the_error_line(monkeypatch, capsys):
    def broken(**kw):
        raise RuntimeError("launch failed")
    monkeypatch.setattr(port, "bench", broken)
    assert port.main(["--cpu", "--config", "wideband"]) == 1
    line = _line(capsys)
    assert line["metric"] == "wideband_pfb_fft_x_aggregate_throughput"
    assert line["error"] == "RuntimeError: launch failed"
    assert line["value"] == 0


def test_module_without_a_card_exits_1():
    """``python -m fxtpu_torch.bench`` in a process with no card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench runs")
    res = subprocess.run(
        [sys.executable, "-m", "fxtpu_torch.bench", "--pipeline"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 1
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["metric"] == "2ch_end_to_end_pipeline_throughput"
    assert line["error"] == "backend_unavailable: no CUDA device"
