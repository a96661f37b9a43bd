"""The port's host data plane on the CPU: its own C++ library
(``fxtpu_torch/csrc/host``, built at first use by
``fxtpu_torch.host_build``), the native int8 loops against their numpy
expressions and ``fxtpu``'s, and a Correlator run on native rings,
zero-copy feeders and view gathers against the same run on Python rings
and against ``fxtpu``'s run.

Small sizes: 2^13 samples a block, 256 bins, 2 channels.  Tolerances: the
loops bit for bit; the Correlator's CSV byte for byte between the two
kinds of ring, and its rows within 2e-5 of scale (3e-5 under int8 ingest)
of ``fxtpu``'s (tests/test_torch_correlator.py's bounds)."""

import functools
import gc
import os
import shutil
import stat
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch import host_build  # noqa: E402
from fxtpu_torch.runtime import native  # noqa: E402
from fxtpu_torch.runtime.ringbuffer import RingBuffer  # noqa: E402

NSAMP, NBINS = 2**13, 256
STEP = 1.0 / 32
TOL = {"complex64": 2e-5, "int8": 3e-5}

needs_cxx = pytest.mark.skipif(host_build.compiler() is None,
                               reason="no C++ compiler ($CXX or g++)")


def _fresh(monkeypatch):
    """Forget the loaded library in this process (restored afterwards)."""
    monkeypatch.setattr(host_build, "loaded_path", host_build.loaded_path)
    monkeypatch.setattr(host_build, "_lib", None)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(host_build, "build_seconds", 0.0)
    monkeypatch.setattr(host_build, "build_log", "")


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

@needs_cxx
def test_builds_at_first_use_and_a_second_load_reuses_it(tmp_path,
                                                        monkeypatch):
    repo = host_build.HOST_CSRC.parents[2]
    assert host_build.BUILD_DIR == repo / "build" / "fxtpu_torch"
    monkeypatch.setattr(host_build, "BUILD_DIR",
                        tmp_path / "build" / "fxtpu_torch")
    _fresh(monkeypatch)
    assert native.native_available()
    path = host_build.loaded_path
    assert path.parent == host_build.BUILD_DIR and path.exists()
    assert path == host_build.library_path(host_build.compiler())
    assert host_build.build_seconds > 0.0
    assert [p.name for p in path.parent.iterdir()] == [path.name]
    _fresh(monkeypatch)
    assert native.native_available()
    # the second load compiled nothing: no seconds, no compiler output
    assert host_build.loaded_path == path and host_build.build_seconds == 0.0
    assert host_build.build_log == ""
    for name in ("rb_create", "rb_reserve", "rb_commit", "rb_peek",
                 "fx_quant_c64_i8", "fx_split_i8"):
        assert hasattr(native._load(), name)


@needs_cxx
def test_a_changed_source_gets_a_new_name(tmp_path):
    cxx = host_build.compiler()
    src = tmp_path / "host"
    shutil.copytree(host_build.HOST_CSRC, src)
    assert (host_build.library_path(cxx, src)
            == host_build.library_path(cxx))
    code = (src / "dataplane.cpp").read_bytes()
    at = code.index(b"half to even")
    (src / "dataplane.cpp").write_bytes(code[:at] + b"H" + code[at + 1:])
    path = host_build.library_path(cxx, src, tmp_path / "build")
    assert path.name != host_build.library_path(cxx).name
    host_build.build_library(path, host_build.sources(src), cxx)
    assert path.exists() and not list(path.parent.glob("*.tmp"))


def _failing_cxx(tmp_path):
    script = tmp_path / "cxx"
    script.write_text("#!/bin/sh\necho 'cxx: refusing to compile' >&2\n"
                      "exit 3\n")
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.mark.parametrize("kind", ["fails", "missing"])
def test_a_failed_compile_raises_with_its_output(tmp_path, monkeypatch,
                                                 kind):
    cxx = (_failing_cxx(tmp_path) if kind == "fails"
           else str(tmp_path / "no_such_compiler"))
    monkeypatch.setenv("CXX", cxx)
    _fresh(monkeypatch)
    want = "refusing to compile" if kind == "fails" else "no_such_compiler"
    with pytest.raises(RuntimeError, match=want):
        native.make_ring(2, (8,))
    with pytest.raises(RuntimeError, match=want):
        native.native_available()
    assert not list(host_build.BUILD_DIR.glob(f"*.{os.getpid()}.*.tmp"))


def test_no_compiler_keeps_the_python_ring_on_the_cpu_only(monkeypatch):
    monkeypatch.setattr(host_build, "compiler", lambda: None)
    _fresh(monkeypatch)
    assert not native.native_available()
    assert type(native.make_ring(2, (8,))) is RingBuffer
    native.require_native("cpu", "a CPU run")
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        native.require_native("cuda", "the Correlator's rings")
    block = np.array([0.26 + 9j, -5 - 0.01j], np.complex64)
    np.testing.assert_array_equal(native.quantize_c64(block, STEP),
                                  native.quantize_c64_numpy(block, STEP))


@needs_cxx
def test_a_view_keeps_its_ring_alive():
    rb = native.NativeRingBuffer(2, (16,), np.complex64)
    rb.put(np.arange(16, dtype=np.complex64))
    seq, view = rb.get_view(timeout=0.5)
    slot = rb.reserve(timeout=0.5)
    gone = weakref.ref(rb)
    del rb
    gc.collect()
    assert gone() is not None          # the views hold the ring
    slot[:] = 7
    assert seq == 0 and view[3] == 3
    del view, slot
    gc.collect()
    assert gone() is None              # then it is freed


# ---------------------------------------------------------------------------
# the int8 loops, bit for bit
# ---------------------------------------------------------------------------

def _samples(kind):
    rng = np.random.default_rng(1717)
    if kind == "noise":
        x = rng.normal(size=(2, NSAMP)) * 3.0
        y = rng.normal(size=(2, NSAMP)) * 3.0
    elif kind == "ties":
        # every value half a step from two integers, inside and beyond
        # +-127 steps: half to even decides each
        k = np.arange(-300, 300) + 0.5
        x, y = k * STEP, -k[::-1] * STEP
    else:   # "clip": far beyond +-127 steps, and exact integers
        x = rng.uniform(-40, 40, size=4096)
        y = np.round(rng.uniform(-200, 200, size=4096)) * STEP
    return (x.astype(np.float32) + 1j * y.astype(np.float32)
            ).astype(np.complex64)


@needs_cxx
@pytest.mark.parametrize("kind", ["noise", "ties", "clip"])
def test_quantize_is_bit_equal_to_numpy_and_fxtpu(kind):
    pytest.importorskip("jax")   # fxtpu, the reference
    from fxtpu.runtime import native as jnative
    block = _samples(kind)
    assert native.native_available()
    got = native.quantize_c64(block, STEP)
    want = np.empty((*block.shape, 2), np.int8)
    np.clip(np.rint(block.real * (1.0 / STEP)), -127, 127,
            out=want[..., 0], casting="unsafe")
    np.clip(np.rint(block.imag * (1.0 / STEP)), -127, 127,
            out=want[..., 1], casting="unsafe")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, native.quantize_c64_numpy(block, STEP))
    np.testing.assert_array_equal(got, jnative.quantize_c64(block, STEP))
    out = np.full((*block.shape, 2), 99, np.int8)
    assert native.quantize_c64(block, STEP, out=out) is out
    np.testing.assert_array_equal(out, want)
    if kind == "ties":
        assert set(np.unique(np.abs(got))) >= {0, 2, 126, 127}
    if kind == "clip":
        assert got.min() == -127 and got.max() == 127


@needs_cxx
def test_split_planes_is_bit_equal_to_numpy_and_fxtpu():
    pytest.importorskip("jax")   # fxtpu, the reference
    from fxtpu.runtime import native as jnative
    q = native.quantize_c64(_samples("noise"), STEP)
    re, im = native.split_planes_i8(q)
    assert re.flags.c_contiguous and re.shape == q.shape[:-1]
    for a, b in zip((re, im), native.split_planes_i8_numpy(q)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip((re, im), jnative.split_planes_i8(q)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the Correlator's host plane
# ---------------------------------------------------------------------------

def _config(rec, out, ingest):
    return dict(num_samp=NSAMP, nbins=NBINS, clamp_num_samp=False,
                run_time=5, startup_duration=0.1, loglevel="WARNING",
                mode="SPECTRUM", source="replay", replay_file=rec,
                ingest_dtype=ingest, quant_step=STEP, output_file=out)


@needs_cxx
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_correlator_runs_on_the_native_plane(tmp_path, monkeypatch, ingest):
    pytest.importorskip("jax")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.correlator import Correlator as JCorrelator
    from fxtpu_torch import correlator as tcorrelator
    from fxtpu_torch.config import CorrelatorConfig
    from fxtpu_torch.products import load_products
    from fxtpu_torch.sources import NoiseSource, save_recording
    rec = save_recording(NoiseSource(nchan=2, delays=[0.0, 2e-6], seed=41),
                         str(tmp_path / "rec.npy"), NSAMP, 6)

    def run(name):
        cor = tcorrelator.Correlator(config=CorrelatorConfig(
            **_config(rec, str(tmp_path / f"{name}.csv"), ingest),
            device="cpu"))
        cor.run_state_machine()
        return cor

    nat = run("native")
    assert all(type(b) is native.NativeRingBuffer for b in nat.bufs)
    assert len(nat.feeders) == 2 and all(f.zero_copy for f in nat.feeders)
    assert nat.aligner._views and nat.blocks_processed == 5
    if ingest == "int8":
        assert all(b.dtype == np.int8 for b in nat.bufs)

    monkeypatch.setattr(tcorrelator, "make_ring", functools.partial(
        native.make_ring, prefer_native=False))
    py = run("python")
    assert all(type(b) is RingBuffer for b in py.bufs)
    assert not any(f.zero_copy for f in py.feeders)
    assert py.blocks_processed == 5
    with open(nat.output_file, "rb") as a, open(py.output_file, "rb") as b:
        assert a.read() == b.read()

    jcor = JCorrelator(config=JConfig(**_config(
        rec, str(tmp_path / "jax.csv"), ingest)))
    jcor.run_state_machine()
    _, want = load_products(jcor.output_file)
    _, got = load_products(nat.output_file)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want,
                               atol=TOL[ingest] * np.abs(want).max())
