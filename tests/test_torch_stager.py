"""The staged multi-block path: the port's DeviceStager, and the
Correlator at blocks_per_dispatch K > 1 against K = 1 and against fxtpu's
Correlator at the same K over one replay recording; on the card, the
stager's pool of pinned host buffers and its copy stream against a host
that rewrites its blocks once handed over and copies held back on the
stream.

Tolerances: on the CPU a run at K > 1 writes the rows of the run at K = 1
exactly (its multi step is K chained single steps bit for bit); the TEST
sweep under K = 4 within 2e-5*scale (the sweep's delays are summed in
another order, ``fxtpu/correlator.py:682-698``); against fxtpu's
Correlator within 2e-5*scale, fxtpu's fused-against-unfused bound
(tests/test_planes.py:318-321), and 3e-5*scale under int8 ingest
(tests/test_planes.py:558).

The card's test runs without JAX:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_stager.py``."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from fxtpu_torch.config import CorrelatorConfig  # noqa: E402
from fxtpu_torch.correlator import Correlator  # noqa: E402
from fxtpu_torch.fx import FxEngine  # noqa: E402
from fxtpu_torch.products import load_products  # noqa: E402
from fxtpu_torch.runtime.feeder import BlockAligner  # noqa: E402
from fxtpu_torch.runtime.ringbuffer import RingBuffer  # noqa: E402
from fxtpu_torch.runtime.stager import DeviceStager  # noqa: E402
from fxtpu_torch.sources import NoiseSource, save_recording  # noqa: E402

SMALL = dict(num_samp=2**13, nbins=256, clamp_num_samp=False, run_time=1,
             startup_duration=0.1, loglevel="WARNING")


def _drain(stager, deadline_s=10.0):
    """Every batch the stager emits until its end-of-stream sentinel."""
    got = []
    deadline = time.time() + deadline_s
    while time.time() < deadline and not stager.done:
        item = stager.get(timeout=0.1)
        if item is not None:
            got.append(item)
    assert stager.done
    return got


def test_stager_ends_despite_unpairable_residual():
    """A seq dropped in one ring leaves a block in its sibling that can
    never pair; with the feeder done the stager still ends the stream
    (tests/test_runtime.py:518)."""
    b0, b1 = RingBuffer(8, (4,)), RingBuffer(8, (4,))
    b0.put(np.zeros(4), seq=0)
    b1.put(np.full(4, 10.0), seq=0)
    b1.put(np.full(4, 11.0), seq=1)   # ch0's seq 1 was dropped upstream
    st = DeviceStager(BlockAligner([b0, b1]), prepare_block=lambda b: b,
                      batch=1, feeding=lambda: False).start()
    got = _drain(st)
    assert len(got) == 1 and not got[0].stacked
    np.testing.assert_array_equal(got[0].take(), [np.zeros(4),
                                                  np.full(4, 10.0)])


def test_stager_full_batches_then_tail_singles():
    """7 aligned blocks at K = 3: two stacked batches of 3 in order, then
    the tail as one unstacked single-block Batch."""
    bufs = [RingBuffer(8, (4,)) for _ in range(2)]
    for seq in range(7):
        for c, b in enumerate(bufs):
            b.put(np.full(4, 10.0 * seq + c), seq=seq)
    st = DeviceStager(BlockAligner(bufs), prepare_block=lambda b: b,
                      batch=3, feeding=lambda: False).start()
    got = _drain(st)
    assert [(b.k, b.stacked, b.last_seq) for b in got] == [
        (3, True, 2), (3, True, 5), (1, False, 6)]
    assert st.staged_blocks == 7
    assert got[0].take().shape == (3, 2, 4)
    np.testing.assert_array_equal(got[1].take()[:, 1, 0], [31.0, 41.0, 51.0])
    np.testing.assert_array_equal(got[2].take()[:, 0], [60.0, 61.0])


def _replay(tmp_path, nblocks, seed=21, **src_kw):
    src = NoiseSource(nchan=2, delays=[0.0, 2e-6], seed=seed, **src_kw)
    return save_recording(src, str(tmp_path / "rec.npy"), SMALL["num_samp"],
                          nblocks)


def _run(tmp_path, name, **kw):
    cor = Correlator(config=CorrelatorConfig(
        **SMALL, output_file=str(tmp_path / f"{name}.csv"), device="cpu",
        **kw))
    cor.run_state_machine()
    _, data = load_products(cor.output_file)
    return cor, data


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_staged_run_writes_the_rows_of_one_block_dispatch(tmp_path, fused,
                                                          ingest):
    """10 recorded blocks: 1 calibrates on the unstaged path, then two
    staged batches of 4 and one tail single at K = 4; the rows are those
    of the K = 1 run (tests/test_end_to_end.py:561)."""
    kw = dict(source="replay", replay_file=_replay(tmp_path, 10),
              mode="SPECTRUM", fused=fused, ingest_dtype=ingest)
    cor1, d1 = _run(tmp_path, "one", **kw)
    corK, dK = _run(tmp_path, "k", blocks_per_dispatch=4, **kw)
    assert cor1.stager is None and corK.stager is not None
    assert corK.stager.staged_blocks == corK.blocks_processed == 9
    assert corK.engine.fused_active == fused
    assert isinstance(corK.history, dict) == (fused and ingest == "int8")
    assert d1.shape == dK.shape == (9, SMALL["nbins"])
    np.testing.assert_array_equal(dK, d1)
    np.testing.assert_array_equal(corK.calibrated_delays,
                                  cor1.calibrated_delays)


def test_staged_test_mode_sweep(tmp_path):
    """The TEST-mode sweep advances one step per block inside a K-block
    call as it does per block (tests/test_end_to_end.py:577)."""
    kw = dict(source="replay", replay_file=_replay(tmp_path, 10, snr=100),
              mode="TEST", test_sweep_step=1e-7, test_offset_steps=4)
    cor1, d1 = _run(tmp_path, "one", **kw)
    corK, dK = _run(tmp_path, "k", blocks_per_dispatch=4, **kw)
    assert corK.blocks_processed == cor1.blocks_processed == 9
    np.testing.assert_allclose(corK.calibrated_delays,
                               cor1.calibrated_delays, rtol=0, atol=1e-15)
    assert dK.shape == d1.shape == (9,)
    np.testing.assert_allclose(dK, d1, rtol=0,
                               atol=2e-5 * np.abs(d1).max())


@pytest.mark.parametrize("ingest,tol", [("complex64", 2e-5), ("int8", 3e-5)])
def test_staged_run_matches_fxtpu_at_the_same_k(tmp_path, ingest, tol):
    """Both Correlators at K = 4 on the fused route over one recording:
    fxtpu's stager feeds its Pallas kernel (interpret mode), the port's
    its kernel's plain version."""
    pytest.importorskip("jax")
    from fxtpu.config import CorrelatorConfig as JConfig
    from fxtpu.correlator import Correlator as JCorrelator
    common = dict(SMALL, source="replay", replay_file=_replay(tmp_path, 6),
                  mode="SPECTRUM", fused=True, ingest_dtype=ingest,
                  blocks_per_dispatch=4)
    jcor = JCorrelator(config=JConfig(
        **common, output_file=str(tmp_path / "jax.csv")))
    jcor.run_state_machine()
    tcor = Correlator(config=CorrelatorConfig(
        **common, output_file=str(tmp_path / "torch.csv"), device="cpu"))
    tcor.run_state_machine()
    assert jcor.stager is not None and tcor.stager is not None
    assert tcor.blocks_processed == jcor.blocks_processed == 5
    _, want = load_products(jcor.output_file)
    _, got = load_products(tcor.output_file)
    assert got.shape == want.shape == (5, SMALL["nbins"])
    np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max())
    bw = tcor.bandwidth
    np.testing.assert_allclose(tcor.calibrated_delays * bw,
                               jcor.calibrated_delays * bw, atol=0.01)


@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_fused_staged_run_recovers_the_delay(tmp_path, ingest):
    """A synthetic run on the fused route at K = 3: calibration recovers
    the injected 2 us and the calibrated phase is flat
    (tests/test_end_to_end.py:631, :647)."""
    cor, data = _run(tmp_path, "vis", mode="SPECTRUM", synthetic_delay=2e-6,
                     fused=True, ingest_dtype=ingest, blocks_per_dispatch=3)
    assert cor.engine.fused_active
    assert cor.engine.int8_native == (ingest == "int8")
    assert cor.stager is not None and cor.stager.staged_blocks >= 3
    assert abs(cor.calibrated_delays[1] - 2e-6) * 2.4e6 < 0.5
    assert data.shape == (cor.blocks_processed, SMALL["nbins"])
    assert cor.blocks_processed >= 3 and np.isfinite(data).all()
    inner = slice(SMALL["nbins"] // 4, 3 * SMALL["nbins"] // 4)
    assert np.std(np.unwrap(np.angle(data.mean(axis=0)[inner]))) < 0.35


# --------------------------------------------------------------------------
# On the card: the pinned pool, the copy stream and the allocator
# --------------------------------------------------------------------------
class _RewritingAligner:
    """Serves ``blocks`` in order, like BlockAligner, and rewrites every
    block of a full batch with junk once the stager asks for the next
    block after it: a block is the stager's only until it has staged it,
    as a ring slot is."""

    def __init__(self, blocks, k):
        self.blocks = [b.copy() for b in blocks]
        self.k = k
        self.bufs = []        # nothing left behind: a miss means drained
        self.last_seq = -1

    def get(self, timeout=0.05):
        n = self.last_seq + 1
        if n % self.k == 0:
            for b in self.blocks[max(0, n - self.k):n]:
                b[...] = 77 if b.dtype == np.int8 else 77 + 77j
        if n >= len(self.blocks):
            return None
        self.last_seq = n
        return self.blocks[n]


@pytest.mark.cuda
@pytest.mark.parametrize("held", ["copy", "read"])
@pytest.mark.parametrize("ingest", ["complex64", "int8"])
def test_cuda_stager_never_reads_a_buffer_mid_copy(ingest, held):
    """25 blocks at K = 3 through a stager whose aligner rewrites each
    block once the stager has moved past it; one of the two streams is
    held back (a sleep queued before each copy on the stager's stream, or
    before each read on the consumer's, which then drops the batch):
    every staged batch equals the blocks as handed over.  Holding the
    copies back catches a pinned buffer rewritten before its copy ran and
    a batch read before its copy landed; holding the reads back catches
    the allocator handing a batch's memory to the next copy while the
    consumer still reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the stager's copy stream)")
    cfg = CorrelatorConfig(**SMALL, device="cuda", ingest_dtype=ingest)
    eng = FxEngine(cfg, fused=True)
    k, n = 3, 25
    rng = np.random.default_rng(5)
    shape = (cfg.nchan, cfg.num_samp)
    if ingest == "int8":
        blocks = [rng.integers(-127, 128, size=(*shape, 2)).astype(np.int8)
                  for _ in range(n)]
    else:
        blocks = [(rng.normal(size=shape) + 1j * rng.normal(size=shape))
                  .astype(np.complex64) for _ in range(n)]
    cycles = 4_000_000          # ~2 ms at the H100's clock
    copy_wait, read_wait = ((5 * cycles, 0) if held == "copy"
                            else (0, cycles))

    def held_back(batch, host=None):
        if copy_wait:
            torch.cuda._sleep(copy_wait)   # on the stager's stream
        return eng.prepare_batch(batch, host)

    st = DeviceStager(_RewritingAligner(blocks, k), eng.prepare_block,
                      batch=k, feeding=lambda: False,
                      prepare_batch=held_back,
                      host_buffer=eng.batch_host_buffer,
                      device=eng.device).start()
    got = []
    deadline = time.time() + 60
    while time.time() < deadline and not st.done:
        b = st.get(timeout=0.5)
        if b is None:
            continue
        iq = b.take()
        if read_wait:
            torch.cuda._sleep(read_wait)   # on the consumer's stream
        got.append((b.k, b.stacked, iq.clone()))
        del iq, b
    torch.cuda.synchronize()
    assert st.done
    assert [(kk, s) for kk, s, _ in got] == [(k, True)] * (n // k) + [
        (1, False)] * (n % k)
    assert len(st._slots) == 3 and all(s is not None for s in st._slots)
    cpu = FxEngine(CorrelatorConfig(**SMALL, device="cpu",
                                    ingest_dtype=ingest), fused=True)
    for i, (kk, stacked, t) in enumerate(got):
        first = i * k
        if stacked:
            want = cpu.prepare_batch(blocks[first:first + kk])
        else:
            want = cpu.prepare_block(blocks[(n // k) * k + i - n // k])
        assert torch.equal(t.cpu(), want), f"batch {i}"
