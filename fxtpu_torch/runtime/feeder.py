"""Host-side feeder: source → per-channel ring buffers → aligned device blocks.

This is the reference's L4 concurrency runtime, a copy of
``fxtpu.runtime.feeder`` without its JAX package import.  The reference runs one daemon *process* per SDR pushing pickled arrays
into ``multiprocessing.Queue``s, synchronized only by a common start epoch
(``effex/effex.py:420-474,630-664``); misaligned drops would
desynchronize the channels forever.  Here:

  * one :class:`Feeder` thread per source streams aligned multi-channel
    blocks and fans each channel's slice into its own sequence-numbered
    :class:`~fxtpu_torch.runtime.ringbuffer.RingBuffer` (USB-I/O-per-channel
    sources do their own per-device reading inside ``read_block``);
  * a :class:`BlockAligner` re-pairs channels **by sequence number**, so a
    drop in one channel discards only the matching blocks in the others and
    alignment is restored — the explicit-seq discipline from SURVEY.md §5.2;
  * the common start-time barrier is preserved (``effex.py:426,649-650``) for
    real-time sources;
  * child exceptions are reported through an exception queue exactly like
    the reference's supervision channel (``effex.py:73-74,656-659``).
"""

from __future__ import annotations

import logging
import threading
import time
import traceback
from queue import Queue
from typing import List, Optional

import numpy as np

from fxtpu_torch.runtime.ringbuffer import BufferClosed, BufferFull, RingBuffer
from fxtpu_torch.sources.base import Source

logger = logging.getLogger(__name__)


class Feeder:
    """Streams blocks from a source into per-channel ring buffers."""

    def __init__(self, source: Source, bufs: List[RingBuffer], num_samp: int,
                 start_time: float = 0.0, run_time: float = float("inf"),
                 exc_queue: Optional[Queue] = None,
                 put_timeout: float = 30.0):
        if len(bufs) != source.nchan:
            raise ValueError("need one ring buffer per channel")
        self.source = source
        self.bufs = bufs
        self.num_samp = int(num_samp)
        self.start_time = start_time
        self.run_time = run_time
        self.exc_queue = exc_queue
        self.put_timeout = put_timeout
        self.blocks_fed = 0
        # Per-block source stream-state log for checkpoint/resume: the
        # feeder reads AHEAD of the consumer (rings hold unprocessed
        # blocks), so the source's *current* state at snapshot time can
        # be several blocks past what the consumer processed.
        # _state_log[s+1] is the stream state after the read that
        # produced ring seq s (log[0] = the initial state) — the consumer
        # snapshots the entry at its last PROCESSED seq + 1 and a resumed
        # run regenerates the first unprocessed block.  Keyed by SEQ, not
        # read count: source-reported drops (take_dropped) gap the seqs.
        # Disabled for sources that return None (live radios cannot
        # reproduce their stream).
        self._state_log: dict = {}
        self._state_lock = threading.Lock()
        #: True once _run selected the reserve/commit producer loop —
        #: lets tests and the pipeline bench assert the zero-copy path is
        #: actually active instead of silently falling back to put().
        self.zero_copy = False
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fxtpu_torch-feeder")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        self.source.stop()
        # Wake a put()/reserve() blocked on a full ring: without this the
        # feeder thread sits out the remaining put_timeout (up to 30 s)
        # and then reports a spurious BufferFull for a user-initiated
        # stop.  Closing is drain-friendly — consumers still empty the
        # ring, then see None.  _stop is already set, so the woken
        # BufferClosed is treated as a clean exit in _run.
        for buf in self.bufs:
            buf.close()

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    _STATE_LOG_FLOOR = 1024  # entries are tiny dicts

    @property
    def _state_log_depth(self) -> int:
        """Log window, sized from the ACTUAL ring capacity: the feeder
        reads at most ``capacity`` blocks ahead of the consumer, so 2x
        that (floor 1024) guarantees the consumer's last-processed seq
        boundary is never evicted — ``buffer_chunks`` is user-
        configurable, so a fixed constant could silently lose stream
        state on huge rings (r3 advisor finding)."""
        cap = max((b.capacity for b in self.bufs), default=0)
        return max(self._STATE_LOG_FLOOR, 2 * cap)

    def _log_source_state(self, key: int):
        """Record the source's current stream state at seq boundary
        ``key`` (see ``_state_log``'s keying note in __init__)."""
        state = self.source.snapshot_state()
        if state is None:
            return
        with self._state_lock:
            self._state_log[key] = state
            if len(self._state_log) > self._state_log_depth:
                self._state_log.pop(min(self._state_log))

    def source_state_at(self, seq_boundary: int) -> Optional[dict]:
        """Stream state at ``seq_boundary`` = last processed seq + 1 (for
        a snapshot), or None when unknown — a live source, or an entry
        older than the log window."""
        with self._state_lock:
            return self._state_log.get(seq_boundary)

    def _run(self):
        try:
            # Start barrier: common epoch for all feeders (effex.py:649-650).
            while time.time() < self.start_time and not self._stop.is_set():
                time.sleep(min(1e-3, max(self.start_time - time.time(), 0)))
            t0 = time.time()
            # Live sources lose data on a stalled consumer, so a full ring
            # times out and raises (reference contract, effex.py:653-659);
            # on-demand sources (synthetic/replay) get backpressure instead
            # — retry until space or stop, surviving e.g. a multi-minute
            # XLA first-compile stall without killing the run.
            realtime = getattr(self.source, "realtime", True)
            # Zero-copy producer: a single-channel source paired with one
            # native ring writes each block DIRECTLY into the reserved
            # ring slot (ReplaySource copies once; QuantizedSource
            # quantizes into the slot) — the per-channel parallel feeder
            # configuration the >=100 MS/s pipeline runs.
            if (len(self.bufs) == 1
                    and getattr(self.bufs[0], "can_reserve", False)
                    and hasattr(self.source, "read_block_into")
                    and getattr(self.source, "nchan", 0) == 1):
                self.zero_copy = True
                self._log_source_state(0)
                self._run_zero_copy(t0, realtime)
                logger.info("Buffering ended at %s",
                            time.strftime("%a, %d %b %Y %H:%M:%S"))
                return
            self._log_source_state(0)
            while not self._stop.is_set():
                block = self.source.read_block(self.num_samp)
                if block is None:
                    logger.info("Source exhausted; feeder stopping.")
                    break
                # source-level losses (USB gap / injected fault) become
                # ring-level SEQUENCE GAPS — the aligner's realign path —
                # instead of silently shifting this channel's stream
                # against its siblings
                dropped = getattr(self.source, "take_dropped", None)
                if dropped is not None:
                    self.blocks_fed += dropped()
                self._log_source_state(self.blocks_fed + 1)
                if not realtime:
                    # wait for space in EVERY ring WITHOUT attempting puts
                    # (a timed-out put counts as a drop — these blocks are
                    # never lost); checked before the channel loop so a
                    # stop mid-wait skips the whole block atomically and
                    # never leaves channel seqs misaligned
                    while (any(b.full() for b in self.bufs)
                           and not self._stop.is_set()):
                        time.sleep(0.002)
                if self._stop.is_set():
                    break
                for c, buf in enumerate(self.bufs):
                    buf.put(block[c], timeout=self.put_timeout,
                            seq=self.blocks_fed)
                self.blocks_fed += 1
                if time.time() - t0 > self.run_time:
                    break
            logger.info("Buffering ended at %s",
                        time.strftime("%a, %d %b %Y %H:%M:%S"))
        except BufferClosed:
            if self._stop.is_set():
                # consumer-initiated stop woke a blocked put — clean exit
                logger.info("Buffering stopped (ring closed).")
            else:
                logger.exception("feeder thread failed: ring closed "
                                 "underneath a live feeder")
                if self.exc_queue is not None:
                    self.exc_queue.put(traceback.format_exc())
        except BufferFull:
            # Report-and-return: this runs in a daemon thread, so the
            # supervision queue IS the error channel (re-raising here would
            # only produce unraisable-exception noise; the reference's
            # re-raise lives in a child process where it kills the
            # producer, effex.py:656-659 — the report already did that).
            logger.exception("feeder filled a ring buffer and it was not "
                             "emptied before timeout occurred.")
            if self.exc_queue is not None:
                self.exc_queue.put(traceback.format_exc())
        except Exception:
            logger.exception("feeder thread failed")
            if self.exc_queue is not None:
                self.exc_queue.put(traceback.format_exc())
        finally:
            for buf in self.bufs:
                buf.close()

    def _run_zero_copy(self, t0: float, realtime: bool):
        """Single-ring hot loop: reserve slot -> source writes it -> commit.
        Same drop/backpressure/run_time semantics as the copy loop."""
        buf, src = self.bufs[0], self.source
        while not self._stop.is_set():
            if not realtime:
                while buf.full() and not self._stop.is_set():
                    time.sleep(0.002)
                if self._stop.is_set():
                    return
            view = buf.reserve(timeout=self.put_timeout)  # raises on
            if view is None:                              # realtime overrun
                continue        # drop-policy timeout: counted, try again
            if not src.read_block_into(view, self.num_samp):
                logger.info("Source exhausted; feeder stopping.")
                return
            self._log_source_state(self.blocks_fed + 1)
            buf.commit(seq=self.blocks_fed)
            self.blocks_fed += 1
            if time.time() - t0 > self.run_time:
                return


class StreamDrainTracker:
    """End-of-stream detector shared by the async stager and the unstaged
    main loop.  Once the feeder is done the rings are STATIC, so one
    retry absorbs the race with its final puts, and a second consecutive
    aligner miss means any remaining blocks are an UNPAIRABLE residual
    (a seq dropped in a sibling ring) that can never align — waiting on
    ``not empty()`` would spin forever."""

    def __init__(self):
        self._dry = 0

    def got_block(self):
        self._dry = 0

    def miss(self, feeding: bool, bufs) -> bool:
        """Record an aligner miss.  True when the stream is DONE: drained,
        or permanently stuck on an unpairable residual."""
        if feeding:
            self._dry = 0
            return False
        self._dry += 1
        if not any(not b.empty() for b in bufs):
            return True  # drained
        if self._dry >= 2:
            logger.info("end of stream: discarding unpairable residual "
                        "ring blocks")
            return True
        return False     # one retry to absorb the final-put race


class BlockAligner:
    """Re-pairs per-channel blocks by sequence number.

    ``get()`` returns an aligned ``[nchan, num_samp]`` array (copied out of
    the ring slots) or None if no aligned set arrived within the timeout.
    Misaligned blocks (a channel missing a seq the others have) are discarded
    and counted in ``realigned``.
    """

    def __init__(self, bufs: List[RingBuffer]):
        self.bufs = bufs
        self.realigned = 0
        #: Sequence number of the block get() last returned.  Seqs can
        #: have GAPS (ring drops, source-reported losses), so consumers
        #: that need a stream position — Correlator.snapshot's source
        #: state lookup — must use this, not their own consumed COUNT.
        self.last_seq = -1
        # zero-copy alignment: native rings expose peek/release views, so
        # the aligned [nchan, num_samp] block is gathered in ONE copy per
        # channel (slot -> output row) instead of two (slot -> per-channel
        # array -> np.stack row)
        self._views = all(hasattr(b, "get_view") and hasattr(b, "release")
                          for b in bufs)

    def get(self, timeout: float = 1.0) -> Optional[np.ndarray]:
        if self._views:
            return self._get_via_views(timeout)
        deadline = time.time() + timeout
        items = []
        for buf in self.bufs:
            item = buf.get(timeout=max(deadline - time.time(), 1e-3))
            if item is None:
                return None
            items.append(item)
        while True:
            target = max(seq for seq, _ in items)
            if all(seq == target for seq, _ in items):
                self.last_seq = target
                return np.stack([blk for _, blk in items])
            # Some channel is behind: advance laggards to the target seq.
            self.realigned += 1
            for c, (seq, _) in enumerate(items):
                while seq < target:
                    nxt = self.bufs[c].get(timeout=max(deadline - time.time(),
                                                       1e-3))
                    if nxt is None:
                        return None
                    seq, blk = nxt
                    items[c] = (seq, blk)

    def _get_via_views(self, timeout: float) -> Optional[np.ndarray]:
        """Single-copy alignment path.  Peeked-but-unconsumed slots stay in
        their rings on timeout (release() is only called to CONSUME a slot:
        either a laggard being discarded — counted in ``realigned`` — or a
        row that has been copied into the output block)."""
        deadline = time.time() + timeout
        items: List = []   # (seq, view) per channel, all peeked
        for buf in self.bufs:
            item = buf.get_view(timeout=max(deadline - time.time(), 1e-3))
            if item is None:
                return None
            items.append(item)
        while True:
            target = max(seq for seq, _ in items)
            if all(seq == target for seq, _ in items):
                break
            self.realigned += 1
            for c, (seq, _) in enumerate(items):
                while seq < target:
                    self.bufs[c].release()   # discard the laggard slot
                    nxt = self.bufs[c].get_view(
                        timeout=max(deadline - time.time(), 1e-3))
                    if nxt is None:
                        return None
                    seq, _view = nxt
                    items[c] = (seq, _view)
        out = np.empty((len(self.bufs), *items[0][1].shape),
                       items[0][1].dtype)
        for c, (_seq, view) in enumerate(items):
            np.copyto(out[c], view)
            self.bufs[c].release()
        self.last_seq = items[0][0]
        return out
