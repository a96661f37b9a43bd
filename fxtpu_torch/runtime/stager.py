"""Async device stager: overlaps the host's gather, staging and copy to
the card with the device's work.

Counterpart of ``fxtpu.runtime.stager``:

    feeder threads:  source -> per-channel ring buffers
    stager thread:   aligner -> K aligned blocks -> prepare_batch (framed
                     into a pinned host buffer, one non_blocking copy on the
                     stager's own CUDA stream) -> bounded queue of batches
    main loop:       pop a batch -> Batch.take -> one multi_step call

JAX's backend makes the copy's asynchrony implicit; here, for a CUDA
device, it is explicit:

  * the stager copies on its own ``torch.cuda.Stream`` and records an
    event after each copy; :meth:`Batch.take` makes the consumer's stream
    wait on that event, so the step never reads a batch mid-copy;
  * :meth:`Batch.take` also ``record_stream``-s the batch on the
    consumer's stream, so the caching allocator does not hand its memory
    to a later copy while the step still reads it;
  * ``depth + 1`` pinned host buffers are reused in turn, each only after
    the event of its previous copy has completed.

A queue depth of 2 double-buffers the copies; deeper holds more device
memory (K * nch * num_samp samples per staged batch) for no throughput.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import traceback
from queue import Empty, Full, Queue
from typing import List, Optional

import numpy as np
import torch

from fxtpu_torch.runtime.feeder import StreamDrainTracker

logger = logging.getLogger(__name__)


class Batch:
    """One staged unit of work.

    ``iq`` is the device input: for a full batch whatever
    ``prepare_batch`` staged (the merged ``[nch, k, S, nbins(, 2)]``
    layout on the fused route, a stacked ``[k, nch, num_samp(, 2)]``
    otherwise); for a tail block (``k == 1``, ``stacked`` False) a
    single-block ``prepare_block`` input.  ``ready`` is the CUDA event
    recorded after its copy (None on the CPU)."""

    __slots__ = ("iq", "k", "stacked", "last_seq", "ready")

    def __init__(self, iq, k: int, stacked: bool, last_seq: int = -1,
                 ready: Optional[torch.cuda.Event] = None):
        self.iq = iq
        self.k = k
        self.stacked = stacked
        #: Ring seq of this batch's last block (seqs can have gaps)
        self.last_seq = last_seq
        self.ready = ready

    def take(self) -> torch.Tensor:
        """``iq``, safe to use on the current stream: the stream waits for
        the copy and the allocator keeps ``iq`` until the stream's work
        queued so far is done."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.iq.device)
            stream.wait_event(self.ready)
            self.iq.record_stream(stream)
        return self.iq


class _HostSlot:
    """A pinned host buffer and the event of the copy that last read it."""

    __slots__ = ("host", "copied")

    def __init__(self, host: torch.Tensor):
        self.host = host
        self.copied: Optional[torch.cuda.Event] = None


class DeviceStager:
    """Thread that turns aligned host blocks into device-resident batches."""

    def __init__(self, aligner, prepare_block, batch: int, depth: int = 2,
                 exc_queue: Optional[Queue] = None,
                 feeding=lambda: False, prepare_batch=None,
                 host_buffer=None, device=None, metrics=None):
        """``aligner``: BlockAligner to pull from; ``prepare_block``: host
        block -> device input (FxEngine.prepare_block); ``prepare_batch``:
        ``(blocks, host)`` -> one multi_step input (FxEngine.prepare_batch;
        defaults to prepare_block over an np.stack); ``host_buffer``: k ->
        an empty pinned host batch (FxEngine.batch_host_buffer), pooled
        ``depth + 1`` deep on a CUDA ``device``; ``batch``: blocks per
        staged batch (K); ``feeding``: callable, True while the upstream
        feeder may still produce blocks; ``metrics``: a Metrics whose
        ``stage`` timer takes the host time of each staging."""
        self.aligner = aligner
        self.prepare_block = prepare_block
        self.prepare_batch = (prepare_batch if prepare_batch is not None
                              else lambda blocks, host=None:
                              prepare_block(np.stack(blocks)))
        self.host_buffer = host_buffer
        self.batch = int(batch)
        self.exc_queue = exc_queue
        self.feeding = feeding
        self.metrics = metrics
        self.device = torch.device(device) if device is not None else None
        self.on_card = self.device is not None and self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self._slots: List[Optional[_HostSlot]] = [None] * (depth + 1)
        self._turn = 0
        self.out: Queue = Queue(maxsize=depth)
        self.staged_blocks = 0
        self.done = False  # end-of-stream sentinel observed by the consumer
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DeviceStager":
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fxtpu_torch-stager")
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        # unblock a full queue so the thread can observe the stop flag
        try:
            self.out.get_nowait()
        except Empty:
            pass

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def get(self, timeout: float = 0.1) -> Optional[Batch]:
        """Next staged batch, or None on timeout or end of stream (after
        which ``self.done`` is True: that is how the consumer tells a
        drained stream from a not-ready one)."""
        if self.done:
            return None
        try:
            item = self.out.get(timeout=timeout)
        except Empty:
            return None
        if item is None:
            self.done = True
            return None
        return item

    def _gather(self):
        """Collect up to ``batch`` aligned (seq, block) pairs; a short list
        at stream end (StreamDrainTracker decides when a miss means
        done)."""
        blocks: List = []
        drain = StreamDrainTracker()
        while len(blocks) < self.batch and not self._stop.is_set():
            blk = self.aligner.get(timeout=0.05)
            if blk is None:
                if drain.miss(self.feeding(), self.aligner.bufs):
                    break  # drained (or unpairable residual) and done
            else:
                drain.got_block()
                blocks.append((self.aligner.last_seq, blk))
        return blocks

    def _copied(self) -> Optional[torch.cuda.Event]:
        """An event after the copies queued so far on the stager's
        stream, or None on the CPU."""
        if not self.on_card:
            return None
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    def _stage(self, blocks):
        """One full batch -> (device input, its copy's event), through the
        next pinned host buffer of the pool once its last copy is done."""
        if not (self.on_card and self.host_buffer is not None):
            return self.prepare_batch(blocks), self._copied()
        i = self._turn % len(self._slots)
        self._turn += 1
        slot = self._slots[i]
        if slot is None:
            slot = self._slots[i] = _HostSlot(self.host_buffer(len(blocks)))
        elif slot.copied is not None:
            slot.copied.synchronize()
        iq = self.prepare_batch(blocks, host=slot.host)
        slot.copied = self._copied()
        return iq, slot.copied

    def _timed(self):
        return (self.metrics.stage("stage") if self.metrics is not None
                else contextlib.nullcontext())

    def _run(self):
        try:
            stream = (torch.cuda.stream(self.stream) if self.on_card
                      else contextlib.nullcontext())
            with stream:
                while not self._stop.is_set():
                    blocks = self._gather()
                    if not blocks:
                        break
                    if len(blocks) == self.batch and self.batch > 1:
                        with self._timed():
                            iq, ready = self._stage([b for _, b in blocks])
                        self.staged_blocks += self.batch
                        self._put(Batch(iq, self.batch, stacked=True,
                                        last_seq=blocks[-1][0], ready=ready))
                    else:
                        # tail (or batch == 1): single-block units for the
                        # single-block step
                        for seq, b in blocks:
                            iq = self.prepare_block(b)
                            self.staged_blocks += 1
                            self._put(Batch(iq, 1, stacked=False,
                                            last_seq=seq,
                                            ready=self._copied()))
        except Exception:
            logger.exception("stager thread failed")
            if self.exc_queue is not None:
                self.exc_queue.put(traceback.format_exc())
        finally:
            self.out.put(None)  # end-of-stream sentinel

    def _put(self, item: Batch):
        while not self._stop.is_set():
            try:
                self.out.put(item, timeout=0.1)
                return
            except Full:
                continue
