"""The port's host runtime against ``fxtpu``'s: the Python and native ring
buffers, the aligner, the feeders, reserve/commit, the zero-copy
producers, the stager's end of stream and ``quantize_c64``.

Each case of ``tests/test_runtime.py`` runs its operation sequence on
both packages' objects: what the sequence observes (sequence numbers,
drops, the bytes of every block, the exceptions by name) is recorded
for each, the reference's assertions hold on the port's record, and the
two records are equal.  Cases that run a feeder for a wall-clock time
compare what does not depend on the clock (shapes, counts against
their own feeder, closed rings).  The span-mode state log at the end is
the repair of ``fxtpu_torch/runtime/feeder.py`` to ``fxtpu``'s rule: a
feeder that reads sample spans records no stream state."""

import threading
import time
import types
from queue import Queue

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)
pytest.importorskip("jax")   # the reference; absent on the card's machine


def _pkg(name):
    """The runtime and source names of package ``name``."""
    if name == "fxtpu":
        from fxtpu import runtime as rt
        from fxtpu import sources as src
        from fxtpu.runtime import native
        from fxtpu.runtime.stager import DeviceStager
        from fxtpu.sources.base import QuantizedSource
    else:
        from fxtpu_torch import runtime as rt
        from fxtpu_torch import sources as src
        from fxtpu_torch.runtime import native
        from fxtpu_torch.runtime.stager import DeviceStager
        from fxtpu_torch.sources.base import QuantizedSource
    return types.SimpleNamespace(
        RingBuffer=rt.RingBuffer, BufferFull=rt.BufferFull,
        BlockAligner=rt.BlockAligner, Feeder=rt.Feeder, native=native,
        DeviceStager=DeviceStager, QuantizedSource=QuantizedSource,
        NoiseSource=src.NoiseSource, ReplaySource=src.ReplaySource,
        FaultInjectingSource=src.FaultInjectingSource,
        save_recording=src.save_recording)


PKGS = ("fxtpu", "fxtpu_torch")


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` for each package; assert the records
    are equal and return the port's."""
    got = {name: scenario(_pkg(name), *args) for name in PKGS}
    _assert_same(got["fxtpu_torch"], got["fxtpu"])
    return got["fxtpu_torch"]


def _assert_same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (a, b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), (a, b)
        for k in a:
            _assert_same(a[k], b[k])
    else:
        assert a == b, (a, b)


def _raises(fn):
    """The name of the exception ``fn()`` raises, or None."""
    try:
        fn()
    except Exception as e:   # noqa: BLE001 (the name is what is compared)
        return type(e).__name__
    return None


#: The packages whose native host library is there: fxtpu's where its
#: native/libfxring.so was built (make -C native), the port's wherever a
#: C++ compiler builds it from fxtpu_torch/csrc/host at first use.
NATIVE_PKGS = tuple(name for name in PKGS
                    if _pkg(name).native.native_available())

native_only = pytest.mark.skipif(
    "fxtpu_torch" not in NATIVE_PKGS,
    reason="no C++ compiler to build the port's host library")


def _native_both(scenario, *args):
    """:func:`_both` over the packages of NATIVE_PKGS: each package's half
    runs where its own library is there, the records are compared where
    both ran, and the port's is returned."""
    got = {name: scenario(_pkg(name), *args) for name in NATIVE_PKGS}
    if "fxtpu" in got:
        _assert_same(got["fxtpu_torch"], got["fxtpu"])
    return got["fxtpu_torch"]


# ---------------------------------------------------------------------------
# the Python ring and the aligner
# ---------------------------------------------------------------------------

def test_ring_fifo_and_seq():
    def run(p):
        rb = p.RingBuffer(4, (8,), dtype=np.float32)
        seqs = [rb.put(np.full(8, i, np.float32)) for i in range(3)]
        n = rb.qsize()
        got = [rb.get() for _ in range(3)]
        return seqs, n, got, rb.get(timeout=0.01)
    seqs, n, got, last = _both(run)
    assert n == 3 and last is None
    for i, (seq, blk) in enumerate(got):
        assert seq == i and blk[0] == i


def test_ring_raise_policy():
    def run(p):
        rb = p.RingBuffer(2, (4,), policy="raise")
        rb.put(np.zeros(4)), rb.put(np.zeros(4))
        return _raises(lambda: rb.put(np.zeros(4), timeout=0.05))
    assert _both(run) == "BufferFull"


def test_ring_drop_policy_counts():
    def run(p):
        rb = p.RingBuffer(2, (4,), policy="drop")
        seqs = [rb.put(np.zeros(4)), rb.put(np.zeros(4)), rb.put(np.ones(4))]
        return seqs, rb.drops, rb.qsize()
    assert _both(run) == ([0, 1, -1], 1, 2)


def test_ring_overwrite_policy():
    def run(p):
        rb = p.RingBuffer(2, (4,), policy="overwrite")
        for v in (0.0, 1.0, 2.0):
            rb.put(np.full(4, v))
        return rb.drops, rb.get(), rb.get()
    drops, (seq, blk), _ = _both(run)
    assert drops == 1 and seq == 1 and blk[0] == 1.0


def test_ring_short_block_zero_padded():
    def run(p):
        rb = p.RingBuffer(2, (8,))
        rb.put(np.ones(5, np.complex64))
        return rb.get()[1]
    blk = _both(run)
    assert np.all(blk[:5] == 1) and np.all(blk[5:] == 0)


def test_ring_blocking_put_get_across_threads():
    def run(p):
        rb = p.RingBuffer(1, (4,))
        rb.put(np.zeros(4))
        got = []

        def consumer():
            time.sleep(0.05)
            got.append(rb.get(timeout=1))
            got.append(rb.get(timeout=1))

        t = threading.Thread(target=consumer)
        t.start()
        seq = rb.put(np.ones(4), timeout=1)   # blocks until a slot frees
        t.join()
        return seq, got
    seq, got = _both(run)
    assert seq == 1 and len(got) == 2 and got[1][1][0] == 1


def test_aligner_realigns_after_drop():
    def run(p):
        b0, b1 = p.RingBuffer(8, (4,)), p.RingBuffer(8, (4,))
        for seq in (0, 1, 2):
            b0.put(np.full(4, seq), seq=seq)
        for seq in (0, 2):
            b1.put(np.full(4, 10 + seq), seq=seq)
        al = p.BlockAligner([b0, b1])
        return al.get(timeout=0.5), al.get(timeout=0.5), al.realigned
    first, second, realigned = _both(run)
    assert first[0][0] == 0 and first[1][0] == 10
    assert second[0][0] == 2 and second[1][0] == 12
    assert realigned == 1


def test_ring_get_copies_out_of_slot():
    """get() returns a copy: the producer blocked on the full ring reuses
    the freed slot at once."""
    def run(p):
        rb = p.RingBuffer(1, (4,))
        rb.put(np.zeros(4))
        t = threading.Thread(target=lambda: rb.put(np.ones(4), timeout=1))
        t.start()
        time.sleep(0.05)
        got = rb.get(timeout=1)
        t.join()
        return got
    seq, blk = _both(run)
    assert seq == 0 and np.all(blk == 0)


def test_ring_get_view_owns_slot_until_release():
    def run(p):
        rb = p.RingBuffer(1, (4,))
        rb.put(np.zeros(4))
        seq, view = rb.get_view(timeout=0.5)
        exc = _raises(lambda: rb.put(np.ones(4), timeout=0.05))
        held = view.copy()
        rb.release()
        return seq, exc, held, rb.put(np.full(4, 2.0), timeout=0.5)
    seq, exc, held, nxt = _both(run)
    assert seq == 0 and exc == "BufferFull" and np.all(held == 0)
    assert nxt == 1


def test_aligner_single_copy_path_on_python_rings():
    def run(p):
        bufs = [p.RingBuffer(4, (4,)) for _ in range(2)]
        al = p.BlockAligner(bufs)
        bufs[0].put(np.zeros(4), seq=0)
        bufs[1].put(np.ones(4), seq=0)
        return al._views, al.get(timeout=0.5), [b.empty() for b in bufs]
    views, blk, empty = _both(run)
    assert views and blk.shape == (2, 4)
    assert blk[0][0] == 0 and blk[1][0] == 1 and all(empty)


def test_stager_ends_despite_unpairable_residual():
    """A seq dropped in one ring leaves an unpairable block in its
    sibling; with the feeder done each package's stager still ends."""
    def run(p):
        b0, b1 = p.RingBuffer(8, (4,)), p.RingBuffer(8, (4,))
        b0.put(np.zeros(4), seq=0)
        b1.put(np.full(4, 10.0), seq=0)
        b1.put(np.full(4, 11.0), seq=1)
        st = p.DeviceStager(p.BlockAligner([b0, b1]),
                            prepare_block=lambda b: b, batch=1,
                            feeding=lambda: False).start()
        got = []
        deadline = time.time() + 10
        while time.time() < deadline and not st.done:
            item = st.get(timeout=0.1)
            if item is not None:
                got.append(np.asarray(item.iq))
        return st.done, got
    done, got = _both(run)
    assert done and len(got) == 1


# ---------------------------------------------------------------------------
# feeders
# ---------------------------------------------------------------------------

def test_feeder_streams_and_closes_buffers():
    """A 0.2 s run: every aligned block is [2, 1024], the count equals the
    feeder's own, every ring ends closed, and each package's blocks are
    the same seeded noise, block for block."""
    def run(p):
        bufs = [p.RingBuffer(64, (1024,)) for _ in range(2)]
        f = p.Feeder(p.NoiseSource(nchan=2, seed=1), bufs, 1024,
                     start_time=0.0, run_time=0.2).start()
        al = p.BlockAligner(bufs)
        blocks = []
        while True:
            blk = al.get(timeout=1.0)
            if blk is None:
                break
            blocks.append(blk)
        f.join(2.0)
        return blocks, f.blocks_fed, all(b.closed for b in bufs)
    got = {name: run(_pkg(name)) for name in PKGS}
    blocks, fed, closed = got["fxtpu_torch"]
    assert blocks and len(blocks) == fed and closed
    assert all(b.shape == (2, 1024) for b in blocks)
    n = min(len(blocks), len(got["fxtpu"][0]))   # the clock ends each run
    _assert_same(blocks[:n], got["fxtpu"][0][:n])


def test_feeder_reports_child_exception():
    def run(p):
        src = p.FaultInjectingSource(p.NoiseSource(nchan=2, seed=1),
                                     fail_at=3)
        bufs = [p.RingBuffer(64, (512,)) for _ in range(2)]
        excq = Queue()
        f = p.Feeder(src, bufs, 512, start_time=0.0, run_time=5.0,
                     exc_queue=excq).start()
        f.join(5.0)
        return (not excq.empty()
                and "injected source failure" in excq.get()), f.blocks_fed
    reported, fed = _both(run)
    assert reported and fed == 2   # the third read fails


def test_feeder_backpressure_nonrealtime_survives_full_ring():
    """A non-realtime source waits on a full ring past the put timeout
    and every block still arrives, undropped."""
    def run(p):
        src = p.NoiseSource(nchan=1, seed=2)
        bufs = [p.RingBuffer(2, (256,))]
        f = p.Feeder(src, bufs, 256, start_time=0.0, run_time=0.5,
                     put_timeout=0.05).start()
        time.sleep(0.3)
        alive = f.alive
        got = []
        while True:
            item = bufs[0].get(timeout=0.5)
            if item is None:
                break
            got.append(item)
        f.join(2.0)
        return src.realtime, alive, got, f.blocks_fed, bufs[0].drops
    got = {name: run(_pkg(name)) for name in PKGS}
    realtime, alive, items, fed, drops = got["fxtpu_torch"]
    assert not realtime and alive and len(items) == fed and drops == 0
    n = min(len(items), len(got["fxtpu"][2]))
    _assert_same(items[:n], got["fxtpu"][2][:n])
    assert got["fxtpu"][:2] == (realtime, alive) and got["fxtpu"][4] == 0


def test_feeder_realtime_full_ring_raises():
    def run(p):
        src = p.NoiseSource(nchan=1, seed=3)
        src.realtime = True
        excq = Queue()
        f = p.Feeder(src, [p.RingBuffer(2, (256,))], 256, start_time=0.0,
                     run_time=5.0, exc_queue=excq, put_timeout=0.05).start()
        f.join(5.0)
        return (f.alive, not excq.empty() and "BufferFull" in excq.get(),
                f.blocks_fed)
    assert _both(run) == (False, True, 2)


def test_feeder_source_exhaustion_ends_stream(tmp_path):
    def run(p):
        path = p.save_recording(p.NoiseSource(nchan=2, seed=5),
                                str(tmp_path / f"{id(p)}.npy"), 512, 4)
        bufs = [p.RingBuffer(16, (512,)) for _ in range(2)]
        f = p.Feeder(p.ReplaySource(path), bufs, 512, start_time=0.0,
                     run_time=30.0).start()
        f.join(5.0)
        return f.blocks_fed, [[b.get(timeout=0.5) for _ in range(4)]
                              for b in bufs]
    fed, _ = _both(run)
    assert fed == 4


def test_feeder_stop_wakes_blocked_put():
    """stop() closes the rings, so a put blocked on a full ring wakes at
    once and the stop is not reported as a failure."""
    def run(p):
        class RealtimeNoise(p.NoiseSource):
            realtime = True

        bufs = [p.RingBuffer(1, (256,))]
        excq = Queue()
        f = p.Feeder(RealtimeNoise(nchan=1, seed=1), bufs, 256,
                     start_time=0.0, run_time=30.0, exc_queue=excq,
                     put_timeout=30.0).start()
        deadline = time.time() + 5
        while not bufs[0].full() and time.time() < deadline:
            time.sleep(0.01)
        time.sleep(0.1)
        t0 = time.time()
        f.stop()
        f.join(5.0)
        return f.alive, time.time() - t0 < 5.0, excq.empty()
    assert _both(run) == (False, True, True)


def test_feeder_span_mode_logs_no_stream_state(tmp_path):
    """A feeder that reads sample spans (a multi-process run's) records
    no source stream state in either package: ``source_state_at`` is
    None at every seq boundary (``fxtpu/runtime/feeder.py:124-125``),
    while the same feeder reading whole blocks records one."""
    def run(p):
        path = p.save_recording(p.NoiseSource(nchan=2, seed=7),
                                str(tmp_path / f"{id(p)}.npy"), 1024, 4)
        out = {}
        for span in ((256, 768), None):
            bufs = [p.RingBuffer(8, ((768 - 256) if span else 1024,))
                    for _ in range(2)]
            f = p.Feeder(p.ReplaySource(path), bufs, 1024, run_time=30.0,
                         sample_span=span).start()
            f.join(5.0)
            out[str(span)] = (f.blocks_fed,
                              [f.source_state_at(k) for k in range(5)],
                              bufs[0].get(timeout=0.5))
        return out
    got = _both(run)
    fed, states, (seq, first) = got["(256, 768)"]
    assert fed == 4 and states == [None] * 5 and seq == 0
    assert first.shape == (512,)
    fed, states, _ = got["None"]
    assert fed == 4 and all(s is not None for s in states)


# ---------------------------------------------------------------------------
# the native ring (each package binds its own library: fxtpu native/,
# the port fxtpu_torch/csrc/host)
# ---------------------------------------------------------------------------

@native_only
class TestNativeRing:
    def test_fifo_seq_and_drops(self):
        def run(p):
            rb = p.native.NativeRingBuffer(4, (8,), np.complex64,
                                           policy="drop")
            seqs = [rb.put(np.full(8, i, np.complex64)) for i in range(4)]
            seqs.append(rb.put(np.zeros(8, np.complex64), timeout=0.01))
            got = [rb.get(timeout=0.5) for _ in range(4)]
            drops = rb.drops
            rb.close()
            return seqs, drops, got
        seqs, drops, got = _native_both(run)
        assert seqs == [0, 1, 2, 3, -1] and drops == 1
        assert all(s == i and b[0] == i for i, (s, b) in enumerate(got))

    def test_raise_policy_and_close(self):
        def run(p):
            rb = p.native.NativeRingBuffer(2, (4,))
            rb.put(np.zeros(4, np.complex64))
            rb.put(np.zeros(4, np.complex64))
            exc = _raises(lambda: rb.put(np.zeros(4, np.complex64),
                                         timeout=0.02))
            rb.close()
            return exc, [rb.get(timeout=0.1) for _ in range(3)]
        exc, got = _native_both(run)
        assert exc == "BufferFull"
        assert got[0] is not None and got[1] is not None and got[2] is None

    def test_short_block_zero_padded(self):
        def run(p):
            rb = p.native.NativeRingBuffer(2, (8,))
            rb.put(np.ones(5, np.complex64))
            return rb.get(timeout=0.5)[1]
        blk = _native_both(run)
        assert np.all(blk[:5] == 1) and np.all(blk[5:] == 0)

    def test_zero_copy_view(self):
        def run(p):
            rb = p.native.NativeRingBuffer(2, (16,))
            rb.put(np.arange(16, dtype=np.complex64))
            seq, view = rb.get_view(timeout=0.5)
            held = view.copy()
            rb.release()
            return seq, held, rb.qsize()
        seq, view, n = _native_both(run)
        assert seq == 0 and view[3] == 3 and n == 0

    def test_reserve_commit_matches_put(self):
        def run(p):
            rb = p.native.NativeRingBuffer(4, (16,))
            assert rb.can_reserve
            for i in range(3):
                rb.reserve(timeout=0.5)[:] = (np.arange(16, dtype=np.complex64)
                                              + i)
                rb.commit()
            got = [rb.get(timeout=0.5) for _ in range(3)]
            rb.close()
            return got
        for i, (seq, blk) in enumerate(_native_both(run)):
            assert seq == i
            np.testing.assert_array_equal(
                blk, np.arange(16, dtype=np.complex64) + i)

    def test_reserve_timeout_policies(self):
        def run(p):
            rb = p.native.NativeRingBuffer(1, (4,), policy="drop")
            rb.reserve(timeout=0.5)[:] = 1
            rb.commit()
            full = rb.reserve(timeout=0.02)
            rb2 = p.native.NativeRingBuffer(1, (4,), policy="raise")
            rb2.reserve(timeout=0.5)[:] = 1
            rb2.commit()
            exc = _raises(lambda: rb2.reserve(timeout=0.02))
            drops = rb.drops
            rb.close(), rb2.close()
            return full, drops, exc
        assert _native_both(run) == (None, 1, "BufferFull")

    def test_feeder_zero_copy_single_channel_replay(self, tmp_path):
        def run(p):
            rec = p.save_recording(p.NoiseSource(nchan=2, seed=3),
                                   str(tmp_path / f"{id(p)}.npy"), 256, 4)
            src = p.ReplaySource(rec).select_channels([1])
            want = np.array(src._data)
            buf = p.native.NativeRingBuffer(8, (256,))
            f = p.Feeder(src, [buf], 256, run_time=10.0).start()
            got = []
            while True:
                item = buf.get(timeout=1.0)
                if item is None:
                    break
                got.append(item[1])
            f.join(2.0)
            return f.zero_copy, got, want[0]
        zero_copy, got, want = _native_both(run)
        assert zero_copy and len(got) == 4
        np.testing.assert_array_equal(np.concatenate(got), want)

    def test_feeder_zero_copy_int8_quantized(self, tmp_path):
        def run(p):
            rec = p.save_recording(p.NoiseSource(nchan=1, seed=9),
                                   str(tmp_path / f"{id(p)}.npy"), 128, 2)
            src = p.QuantizedSource(p.ReplaySource(rec))
            want = p.QuantizedSource(p.ReplaySource(rec)).read_block(128)
            buf = p.native.NativeRingBuffer(8, (128, 2), dtype=np.int8)
            f = p.Feeder(src, [buf], 128).start()
            seq, blk = buf.get(timeout=1.0)
            f.join(2.0)
            return f.zero_copy, seq, blk, want[0]
        zero_copy, seq, blk, want = _native_both(run)
        assert zero_copy and seq == 0 and blk.dtype == np.int8
        np.testing.assert_array_equal(blk, want)

    def test_feeder_end_to_end_with_native_rings(self):
        def run(p):
            bufs = [p.native.NativeRingBuffer(32, (1024,)) for _ in range(2)]
            f = p.Feeder(p.NoiseSource(nchan=2, seed=6), bufs, 1024,
                         start_time=0.0, run_time=0.2).start()
            al = p.BlockAligner(bufs)
            blocks = []
            while True:
                blk = al.get(timeout=1.0)
                if blk is None:
                    break
                blocks.append(blk)
            f.join(2.0)
            return blocks, f.blocks_fed
        got = {name: run(_pkg(name)) for name in NATIVE_PKGS}
        blocks, fed = got["fxtpu_torch"]
        assert len(blocks) == fed > 0
        assert all(b.shape == (2, 1024) for b in blocks)
        if "fxtpu" in got:
            n = min(len(blocks), len(got["fxtpu"][0]))
            _assert_same(blocks[:n], got["fxtpu"][0][:n])


@native_only
def test_aligner_view_path_realigns_with_native_rings():
    def run(p):
        b0 = p.native.NativeRingBuffer(8, (4,), np.complex64)
        b1 = p.native.NativeRingBuffer(8, (4,), np.complex64)
        for seq in (0, 1, 2):
            b0.put(np.full(4, seq, np.complex64), seq=seq)
        for seq in (0, 2):
            b1.put(np.full(4, 10 + seq, np.complex64), seq=seq)
        al = p.BlockAligner([b0, b1])
        out = [al._views, al.get(timeout=0.5), al.get(timeout=0.5),
               al.realigned, al.get(timeout=0.05)]
        b0.put(np.full(4, 3, np.complex64), seq=3)
        b1.put(np.full(4, 13, np.complex64), seq=3)
        return out + [al.get(timeout=0.5)]
    views, first, second, realigned, none, last = _native_both(run)
    assert views and realigned == 1 and none is None
    assert first[0][0] == 0 and first[1][0] == 10
    assert second[0][0] == 2 and second[1][0] == 12
    assert last[0][0] == 3 and last[1][0] == 13


@native_only
def test_native_put_timeout_none_blocks():
    """timeout=None waits for a slot on the native ring."""
    def run(p):
        rb = p.native.NativeRingBuffer(1, (4,), np.float32)
        rb.put(np.zeros(4, np.float32))

        def consumer():
            time.sleep(0.2)
            rb.get(timeout=1)

        t = threading.Thread(target=consumer)
        t.start()
        seq = rb.put(np.ones(4, np.float32))
        t.join()
        return seq
    assert _native_both(run) == 1


# ---------------------------------------------------------------------------
# the int8 data plane (native loop or its numpy fallback, identically)
# ---------------------------------------------------------------------------

def _block(shape, rng):
    return (rng.normal(size=shape).astype(np.float32)
            + 1j * rng.normal(size=shape).astype(np.float32)
            ).astype(np.complex64)


def test_quantize_c64_matches_numpy():
    def run(p):
        block = _block((2, 4097), np.random.default_rng(7)) * 3.0
        hot = np.full(16, 99.0 + 99.0j, np.complex64)
        return (block, p.native.quantize_c64(block, 1.0 / 32),
                p.native.quantize_c64(hot, 1.0 / 32),
                p.native.quantize_c64(-hot, 1.0 / 32))
    block, q, qh, qn = _both(run)
    ref = np.empty((*block.shape, 2), np.int8)
    np.clip(np.rint(block.real * 32.0), -127, 127, out=ref[..., 0],
            casting="unsafe")
    np.clip(np.rint(block.imag * 32.0), -127, 127, out=ref[..., 1],
            casting="unsafe")
    assert np.array_equal(q, ref)
    assert np.all(qh == 127) and np.all(qn == -127)


def test_quantize_c64_into_out_matches_alloc():
    def run(p):
        block = _block((513,), np.random.default_rng(11)) * 2.0
        want = p.native.quantize_c64(block, 1.0 / 32)
        out = np.empty((513, 2), np.int8)
        got = p.native.quantize_c64(block, 1.0 / 32, out=out)
        return got is out, got, want
    same, got, want = _both(run)
    assert same
    np.testing.assert_array_equal(got, want)
