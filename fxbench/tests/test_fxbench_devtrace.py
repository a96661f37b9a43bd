"""The device's busy union, lost records and labelled idle gaps on a
recorded trace snippet."""

import pytest

from fxbench.devtrace import gaps, summarise, union

BASE_US = 1_000_000.0          # baseTimeNanoseconds / 1e3
OFFSET = 5.0                   # wall clock less host clock, seconds


def _at(host_s: float) -> float:
    """A host time as a trace ``ts``."""
    return (host_s + OFFSET) * 1e6 - BASE_US


def _ev(cat, name, host_s, dur_us, corr):
    return {"ph": "X", "cat": cat, "name": name, "ts": _at(host_s),
            "dur": dur_us, "args": {"correlation": corr}}


SNIPPET = [
    _ev("cuda_runtime", "cudaLaunchKernel", 1.000, 5, 1),
    _ev("kernel", "frames", 1.010, 20_000, 1),          # 1.010 - 1.030
    _ev("cuda_runtime", "cudaLaunchKernel", 1.001, 5, 2),
    _ev("kernel", "reduce", 1.020, 20_000, 2),          # overlaps: - 1.040
    _ev("cuda_runtime", "cudaMemcpyAsync", 1.050, 5, 3),
    _ev("gpu_memcpy", "Memcpy HtoD", 1.100, 50_000, 3),  # 1.100 - 1.150
    _ev("cuda_runtime", "cudaLaunchKernel", 1.160, 5, 4),  # record lost
    _ev("cuda_runtime", "cudaStreamSynchronize", 1.170, 5, 5),
    _ev("kernel", "frames", 1.950, 100_000, 6),         # clipped at 2.0
    _ev("cuda_runtime", "cudaLaunchKernel", 1.949, 5, 6),
    _ev("kernel", "frames", 2.500, 1_000, 7),           # outside
]


def test_union_and_gaps():
    busy = union([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (-1.0, -0.5)], 0.0, 3.5)
    assert busy == [(0.0, 2.0), (3.0, 3.5)]
    assert gaps(busy, 0.0, 4.0) == [(2.0, 3.0), (3.5, 4.0)]
    assert gaps([], 1.0, 2.0) == [(1.0, 2.0)]


def test_summary_of_a_snippet():
    spans = {"products.append_visibility": [(1.040, 1.100)],
             "runtime.BlockAligner.get": [(1.200, 1.900)]}
    out = summarise(SNIPPET, BASE_US, OFFSET, 1.0, 2.0, spans)
    assert out["window_s"] == pytest.approx(1.0)
    # 1.010-1.040, 1.100-1.150, 1.950-2.000
    assert out["busy_s"] == pytest.approx(0.030 + 0.050 + 0.050)
    assert out["kernel_s"] == pytest.approx(0.020 + 0.020 + 0.050)
    assert out["copy_s"] == pytest.approx(0.050)
    assert out["launches"] == 5 and out["lost_records"] == 1
    assert out["device_ops"][0][0] == "frames"
    assert out["device_ops"][0][1] == pytest.approx(0.070)
    longest = out["idle_gaps"][0]
    assert longest[0] == "runtime.BlockAligner.get"
    assert longest[1] == pytest.approx(0.800)
    labels = {g[0] for g in out["idle_gaps"]}
    assert "products.append_visibility" in labels and "host idle" in labels
