"""The port's sources against ``fxtpu``'s: each case of
``tests/test_sources.py`` on both packages' sources at the same seed and
settings.  The samples are the same bit for bit (the port's sources are
copies of ``fxtpu``'s), and the reference's assertions hold on the
port's: splits, snapshot and resume, fault injection, u8 replays,
``make_source`` routing and the gated ``rtlsdr`` import."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference; absent on the card's machine


def _pkg(name):
    if name == "fxtpu":
        from fxtpu import sources as src
        from fxtpu.config import CorrelatorConfig
        from fxtpu.sources import replay, rtlsdr, synthetic
        from fxtpu.sources.base import QuantizedSource
        extra = {}
    else:
        from fxtpu_torch import sources as src
        from fxtpu_torch.config import CorrelatorConfig
        from fxtpu_torch.sources import replay, rtlsdr, synthetic
        from fxtpu_torch.sources.base import QuantizedSource
        extra = {"device": "cpu"}
    return types.SimpleNamespace(
        src=src, replay=replay, rtlsdr=rtlsdr, synthetic=synthetic,
        QuantizedSource=QuantizedSource,
        config=lambda **kw: CorrelatorConfig(**kw, **extra))


PKGS = ("fxtpu", "fxtpu_torch")


def _both(scenario, *args):
    """``scenario(pkg, *args)`` for each package; the port's result is
    ``fxtpu``'s, array for array; returns the port's."""
    got = {name: scenario(_pkg(name), *args) for name in PKGS}
    _same(got["fxtpu_torch"], got["fxtpu"])
    return got["fxtpu_torch"]


def _same(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


def test_noise_source_shapes_and_determinism():
    def run(p):
        return (p.src.NoiseSource(nchan=3, seed=9).read_block(1024),
                p.src.NoiseSource(nchan=3, seed=9).read_block(1024))
    a, b = _both(run)
    assert a.shape == (3, 1024) and a.dtype == np.complex64
    np.testing.assert_array_equal(a, b)


def test_noise_source_injected_delay_is_recoverable():
    def run(p):
        return p.src.NoiseSource(nchan=2, sample_rate=2.4e6,
                                 delays=[0.0, 5.0 / 2.4e6], snr=1000,
                                 seed=2).read_block(2**14)
    blk = _both(run)
    x = np.correlate(blk[1], blk[0], mode="full")
    assert np.argmax(np.abs(x)) - (len(blk[0]) - 1) == 5


def test_noise_source_snr_scaling():
    def run(p):
        return (p.src.NoiseSource(nchan=2, snr=1e6, seed=3).read_block(4096),
                p.src.NoiseSource(nchan=2, snr=0.01, seed=3).read_block(4096))

    def corr(b):
        return np.abs(np.vdot(b[0], b[1])) / (np.linalg.norm(b[0])
                                              * np.linalg.norm(b[1]))
    hi, lo = _both(run)
    assert corr(hi) > 0.99 and corr(lo) < 0.2


def test_sinusoid_source_tone_and_delay_phase():
    f0 = 1e5

    def run(p):
        return p.src.SinusoidSource(nchan=2, sample_rate=1e6, tone_freq=f0,
                                    delays=[0.0, 2e-6]).read_block(4096)
    blk = _both(run)
    peak = np.fft.fftfreq(4096, d=1e-6)[np.argmax(np.abs(np.fft.fft(blk[0])))]
    assert abs(peak - f0) < 1e6 / 4096
    ph = np.angle(np.vdot(blk[1], blk[0]))
    expect = 2 * np.pi * f0 * 2e-6 % (2 * np.pi)
    assert abs((ph - expect + np.pi) % (2 * np.pi) - np.pi) < 0.01


def test_fractional_delay_integer_matches_roll(rng):
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(np.complex64)
    got = _both(lambda p: p.synthetic.fractional_delay(x, 3))
    np.testing.assert_allclose(got, np.roll(x, 3), atol=1e-4)


def test_replay_roundtrip(tmp_path):
    def run(p):
        path = p.src.save_recording(p.src.NoiseSource(nchan=2, seed=4),
                                    str(tmp_path / f"{p.src.__name__}.npy"),
                                    256, 3)
        rep = p.src.ReplaySource(path)
        blocks = [rep.read_block(256) for _ in range(3)]
        loop = p.src.ReplaySource(path, loop=True)
        return (rep.nchan, rep.total_samples, blocks, rep.read_block(256),
                [loop.read_block(256) for _ in range(5)])
    nchan, total, blocks, after, looped = _both(run)
    assert nchan == 2 and total == 768
    assert all(b is not None for b in blocks) and after is None
    assert all(b is not None for b in looped)


def test_replay_raw_c64(tmp_path):
    data = (np.arange(512) + 1j).astype(np.complex64)
    p0, p1 = str(tmp_path / "ch0.c64"), str(tmp_path / "ch1.c64")
    data.tofile(p0)
    (data * 2).tofile(p1)
    blk = _both(lambda p: p.src.ReplaySource([p0, p1]).read_block(512))
    assert blk.shape == (2, 512)
    np.testing.assert_array_equal(blk[1], blk[0] * 2)


def test_replay_is_memory_mapped(tmp_path):
    def mapped(a):
        return isinstance(a, np.memmap) or isinstance(a.base, np.memmap)

    def run(p):
        path = p.src.save_recording(p.src.NoiseSource(nchan=2, seed=6),
                                    str(tmp_path / f"{p.src.__name__}.npy"),
                                    256, 3)
        rep = p.src.ReplaySource(path)
        mem = p.src.ReplaySource(path, mmap=False)
        flags = [isinstance(rep._data, np.memmap),
                 not isinstance(mem._data, np.memmap)]
        pairs = [(rep.read_block(256), mem.read_block(256))
                 for _ in range(3)]
        split = p.src.ReplaySource(path).split_channels()
        sel = p.src.ReplaySource(path).select_channels([1])
        flags += [all(mapped(s._data) for s in split), mapped(sel._data)]
        return flags, pairs, sel.read_block(256), split[1].read_block(256)
    flags, pairs, sel, split1 = _both(run)
    assert all(flags)
    for a, b in pairs:
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(sel, split1)


def test_fault_injection_short_and_fail():
    def run(p):
        src = p.src.FaultInjectingSource(p.src.NoiseSource(nchan=2, seed=1),
                                         short_every=2)
        shapes = [src.read_block(128).shape, src.read_block(128).shape]
        failing = p.src.FaultInjectingSource(
            p.src.NoiseSource(nchan=2, seed=1), fail_at=1)
        try:
            failing.read_block(128)
            exc = None
        except RuntimeError as e:
            exc = str(e)
        return shapes, exc
    shapes, exc = _both(run)
    assert shapes == [(2, 128), (2, 64)] and exc is not None


def test_quantized_source_int8_roundtrip():
    step = 1.0 / 32

    def run(p):
        q = p.QuantizedSource(p.src.NoiseSource(nchan=2, seed=4, scale=0.5),
                              quant_step=step)
        return (q.read_block(4096),
                p.src.NoiseSource(nchan=2, seed=4, scale=0.5).read_block(4096))
    blk, want = _both(run)
    assert blk.dtype == np.int8 and blk.shape == (2, 4096, 2)
    deq = (blk[..., 0].astype(np.float32)
           + 1j * blk[..., 1].astype(np.float32)) * step
    unclipped = ((np.abs(want.real) < 126 * step)
                 & (np.abs(want.imag) < 126 * step))
    assert np.abs(deq - want)[unclipped].max() <= step


def test_quantized_source_tuning_passthrough():
    def run(p):
        inner = p.src.NoiseSource(nchan=2, seed=4)
        q = p.QuantizedSource(inner)
        q.sample_rate = 1.2e6
        q.center_freq = 1.0e9
        return inner.sample_rate, inner.center_freq
    assert _both(run) == (1.2e6, 1.0e9)


def test_make_source_from_config():
    def run(p):
        src = p.src.make_source(p.config(source="synthetic", nchan=4,
                                         synthetic_delay=1e-6))
        try:
            p.src.make_source(p.config(source="replay"))
            exc = None
        except ValueError:
            exc = "ValueError"
        return (type(src).__name__, src.nchan, list(src.delays),
                src.read_block(256), exc)
    kind, nchan, delays, _, exc = _both(run)
    assert kind == "NoiseSource" and nchan == 4
    assert delays[0] == 0 and delays[1] == 1e-6 and exc == "ValueError"


def test_rtlsdr_plugin_gated_import():
    def run(p):
        r = p.rtlsdr
        if r.HAVE_RTLSDR:
            return True, None
        try:
            r.RtlSdrSource()
        except ImportError:
            return False, "ImportError"
        return False, None
    have, exc = _both(run)
    assert have or exc == "ImportError"


def test_noise_source_split_equals_unsplit():
    kw = dict(nchan=3, seed=42, delays=[0, 1e-6, 2e-6], snr=5.0)

    def run(p):
        full = p.src.NoiseSource(**kw)
        ref = [full.read_block(2048) for _ in range(4)]
        splits = p.src.NoiseSource(**kw).split_channels()
        got = [[s.read_block(2048)[0] for s in splits] for _ in range(4)]
        mid = p.src.NoiseSource(**kw)
        mid.read_block(2048)
        mid.read_block(2048)
        return (ref, [s.nchan for s in splits], got,
                [s.read_block(2048)[0] for s in mid.split_channels()])
    ref, nchans, got, mid = _both(run)
    assert nchans == [1, 1, 1]
    for k in range(4):
        for c in range(3):
            np.testing.assert_array_equal(got[k][c], ref[k][c])
    for c in range(3):
        np.testing.assert_array_equal(mid[c], ref[2][c])


def test_sinusoid_source_split_equals_unsplit():
    kw = dict(nchan=2, seed=7, delays=[0, 5e-7], noise_scale=0.05)

    def run(p):
        full = p.src.SinusoidSource(**kw)
        ref = [full.read_block(1024) for _ in range(3)]
        splits = p.src.SinusoidSource(**kw).split_channels()
        return ref, [[s.read_block(1024)[0] for s in splits]
                     for _ in range(3)]
    ref, got = _both(run)
    for k in range(3):
        for c in range(2):
            np.testing.assert_array_equal(got[k][c], ref[k][c])


def test_synthetic_split_snapshot_resume():
    """A split's snapshot restores onto a fresh parent, in either package
    and across them."""
    def run(p):
        split = p.src.NoiseSource(nchan=2, seed=3).split_channels()[1]
        split.read_block(512)
        split.read_block(512)
        state = split.snapshot_state()
        parent = p.src.NoiseSource(nchan=2, seed=3)
        parent.restore_state(state)
        return state, split.read_block(512)[0], parent.read_block(512)[1]
    state, want, got = _both(run)
    np.testing.assert_array_equal(got, want)
    from fxtpu.sources import NoiseSource as JNoise
    theirs = JNoise(nchan=2, seed=3)
    theirs.restore_state(state)
    np.testing.assert_array_equal(theirs.read_block(512)[1], want)


def test_fault_split_fail_at_fires_once():
    def run(p):
        splits = p.src.FaultInjectingSource(
            p.src.NoiseSource(nchan=3, seed=11), fail_at=2).split_channels()
        fd = p.src.FaultInjectingSource(
            p.src.NoiseSource(nchan=3, seed=11), fail_at=2, short_every=2,
            drop_every=2, drop_channel=2).split_channels()
        return ([s.fail_at for s in splits], [s.fail_at for s in fd],
                [s.short_every for s in fd], [s.drop_every for s in fd])
    assert _both(run) == ([2, -1, -1], [-1, -1, 2], [0, 0, 2], [0, 0, 2])


def _write_u8_capture(tmp_path, int8_blocks):
    """int8 [nch, n, 2] -> one raw u8 interleaved file a channel (the
    rtl_sdr byte stream: int8 + 128)."""
    arr = np.concatenate(int8_blocks, axis=1)
    paths = []
    for c in range(arr.shape[0]):
        p = str(tmp_path / f"cap{c}.iq")
        (arr[c].astype(np.int16) + 128).astype(np.uint8).tofile(p)
        paths.append(p)
    return paths


def _quantized_blocks(seed, n, k, delays=None):
    from fxtpu_torch.sources import NoiseSource
    from fxtpu_torch.sources.base import QuantizedSource
    q = QuantizedSource(NoiseSource(nchan=2, seed=seed, delays=delays))
    return q, [q.read_block(n) for _ in range(k)]


def test_rtl_u8_replay_roundtrip(tmp_path):
    q, blocks = _quantized_blocks(44, 2048, 3, delays=[0, 1e-6])
    paths = _write_u8_capture(tmp_path, blocks)

    def run(p):
        src = p.replay.RtlU8ReplaySource(paths)
        got = [src.read_block(2048) for _ in range(3)]
        csrc = p.replay.RtlU8ReplaySource(paths, as_complex=True,
                                          quant_step=q.quant_step)
        return (src.nchan, src.total_samples, got, src.read_block(2048),
                csrc.read_block(2048))
    nchan, total, got, after, cplx = _both(run)
    assert nchan == 2 and total == 3 * 2048 and after is None
    for g, want in zip(got, blocks):
        assert g.dtype == np.int8
        np.testing.assert_array_equal(g, want)
    want = (blocks[0][..., 0].astype(np.float32)
            + 1j * blocks[0][..., 1].astype(np.float32)) * q.quant_step
    np.testing.assert_array_equal(cplx, want.astype(np.complex64))


def test_rtl_u8_replay_splits_and_resumes(tmp_path):
    _, blocks = _quantized_blocks(45, 1024, 4)
    paths = _write_u8_capture(tmp_path, blocks)

    def run(p):
        src = p.replay.RtlU8ReplaySource(paths)
        src.read_block(1024)
        splits = src.split_channels()
        got = []
        for s in splits:
            out = np.empty((1024, 2), np.int8)
            got.append((s.read_block(1024)[0], s.read_block_into(out, 1024),
                        out))
        state = splits[0].snapshot_state()
        fresh = p.replay.RtlU8ReplaySource(paths)
        fresh.restore_state(state)
        return got, state, fresh.read_block(1024)
    got, _, resumed = _both(run)
    for c, (first, ok, into) in enumerate(got):
        np.testing.assert_array_equal(first, blocks[1][c])
        assert ok
        np.testing.assert_array_equal(into, blocks[2][c])
    np.testing.assert_array_equal(resumed, blocks[3])


def test_make_source_routes_u8_extension(tmp_path):
    _, blocks = _quantized_blocks(46, 1024, 1)
    paths = ",".join(_write_u8_capture(tmp_path, blocks))

    def run(p):
        src = p.src.make_source(p.config(source="replay", replay_file=paths,
                                         ingest_dtype="int8", nchan=2))
        srcc = p.src.make_source(p.config(source="replay",
                                          replay_file=paths, nchan=2))
        return (type(src).__name__, src.as_complex, type(srcc).__name__,
                srcc.as_complex, src.read_block(1024), srcc.read_block(1024))
    kind, cplx, kindc, cplxc, _, _ = _both(run)
    assert kind == kindc == "RtlU8ReplaySource" and not cplx and cplxc
