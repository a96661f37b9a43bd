"""Sequence-numbered bounded ring buffer for host-side IQ staging.

Replaces the reference's pickled-array ``multiprocessing.Queue`` transport
(``effex/effex.py:105-106``) with an in-process,
preallocated, single-owner ring: blocks are copied once into fixed slots
(the pinned-staging analog of ``cusignal.get_shared_mem``, ``effex.py:109-110``)
and handed to the consumer zero-copy.  Every block carries a sequence number
and drops are *counted*, not silently lost — the discipline SURVEY.md §5.2
calls for (the reference can only warn "data may have been lost",
``effex.py:338-342``).

A C++ implementation of the same layout lives in ``native/ringbuffer.cpp``
(bound via ctypes in ``fxtpu_torch.runtime.native``) for ingest rates where the
Python lock becomes the bottleneck; this class is the portable fallback and
the semantic reference.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np


class RingBuffer:
    """Bounded SPSC block queue with sequence numbers and drop accounting.

    Policies on full-at-timeout (reference behavior is a 30 s blocking put
    that kills the producer on ``queue.Full``, ``effex.py:653-659``):

      * ``"raise"``  — raise :class:`BufferFull` (parity),
      * ``"drop"``   — count the drop and discard the new block,
      * ``"overwrite"`` — count the drop and overwrite the oldest block.
    """

    def __init__(self, capacity: int, block_shape, dtype=np.complex64,
                 policy: str = "raise"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if policy not in ("raise", "drop", "overwrite"):
            raise ValueError(f"unknown policy {policy}")
        self.capacity = int(capacity)
        self.block_shape = tuple(block_shape)
        self._slots = np.zeros((self.capacity, *self.block_shape), dtype=dtype)
        self._seqs = np.full(self.capacity, -1, dtype=np.int64)
        self._head = 0  # next slot to write
        self._tail = 0  # next slot to read
        self._count = 0
        self._next_seq = 0
        self.drops = 0
        self.total_put = 0
        self.policy = policy
        self._pending_seq: Optional[int] = None
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    # ------------------------------------------------------------------
    def qsize(self) -> int:
        with self._lock:
            return self._count

    def full(self) -> bool:
        with self._lock:
            return self._count == self.capacity

    def empty(self) -> bool:
        with self._lock:
            return self._count == 0

    def close(self):
        """Wake all waiters; further puts fail, gets drain then return None."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------------
    def put(self, block: np.ndarray, timeout: Optional[float] = None,
            seq: Optional[int] = None) -> int:
        """Copy ``block`` into the next slot.  Returns the sequence number
        assigned, or -1 if the block was dropped (policy 'drop').

        ``seq`` lets the producer stamp a *global* block index so that a
        drop in one channel's buffer cannot silently desynchronize the
        sequence spaces across channels (the aligner matches on these).
        """
        self._pending_seq = seq
        with self._not_full:
            if self._closed:
                raise BufferClosed("put on closed ring buffer")
            if self._count == self.capacity:
                if self.policy == "raise" or timeout:
                    if not self._not_full.wait_for(
                            lambda: self._count < self.capacity or self._closed,
                            timeout=timeout):
                        if self.policy == "raise":
                            # count the lost block first — same accounting
                            # as the native ring (rb_put counts every
                            # timeout): drops = blocks that never entered
                            # the ring, whatever the policy does next
                            self.drops += 1
                            raise BufferFull(
                                f"ring buffer full for {timeout} s "
                                f"({self.drops} drops so far)")
                        return self._note_drop(block)
                    if self._closed:
                        raise BufferClosed("put on closed ring buffer")
                else:
                    return self._note_drop(block)
            seq = self._write(block)
            self._not_empty.notify()
            return seq

    def _note_drop(self, block) -> int:
        self.drops += 1
        if self.policy == "overwrite":
            # advance tail (discard oldest) and write
            self._tail = (self._tail + 1) % self.capacity
            self._count -= 1
            seq = self._write(block)
            self._not_empty.notify()
            return seq
        return -1

    def _write(self, block) -> int:
        slot = self._head
        dst = self._slots[slot]
        src = np.asarray(block)
        if src.shape != self.block_shape:
            # short block (fault injection / tail): zero-pad into the slot
            dst[:] = 0
            sl = tuple(slice(0, min(s, d)) for s, d in
                       zip(src.shape, self.block_shape))
            dst[sl] = src[sl]
        else:
            dst[:] = src
        seq = self._next_seq if self._pending_seq is None else self._pending_seq
        self._seqs[slot] = seq
        self._next_seq = seq + 1
        self._head = (self._head + 1) % self.capacity
        self._count += 1
        self.total_put += 1
        return seq

    # ------------------------------------------------------------------
    def get(self, timeout: Optional[float] = None
            ) -> Optional[Tuple[int, np.ndarray]]:
        """Pop the oldest block.  Returns ``(seq, copy)`` or None on
        timeout / closed-and-drained.

        The block is COPIED out: popping frees the slot, and when the ring
        was full the producer's very next put targets exactly that slot —
        a returned view would race it (a blocked producer wakes on the
        ``not_full`` notify below).  Zero-copy consumption is the explicit
        :meth:`get_view` / :meth:`release` pair, which keeps the slot
        owned until released."""
        with self._not_empty:
            if self._count == 0:
                if not self._not_empty.wait_for(
                        lambda: self._count > 0 or self._closed,
                        timeout=timeout):
                    return None
                if self._count == 0:  # closed and drained
                    return None
            slot = self._tail
            seq = int(self._seqs[slot])
            block = self._slots[slot].copy()
            self._tail = (self._tail + 1) % self.capacity
            self._count -= 1
            self._not_full.notify()
            return seq, block

    def get_view(self, timeout: Optional[float] = None
                 ) -> Optional[Tuple[int, np.ndarray]]:
        """Peek the oldest block WITHOUT consuming it: ``(seq, view)`` of
        the slot, or None on timeout / closed-and-drained.  The slot stays
        owned by the consumer — the producer cannot overwrite it — until
        :meth:`release` consumes it (same contract as the native ring's
        rb_peek/rb_release)."""
        with self._not_empty:
            if self._count == 0:
                if not self._not_empty.wait_for(
                        lambda: self._count > 0 or self._closed,
                        timeout=timeout):
                    return None
                if self._count == 0:  # closed and drained
                    return None
            slot = self._tail
            return int(self._seqs[slot]), self._slots[slot]

    def release(self):
        """Consume the slot last returned by :meth:`get_view`."""
        with self._lock:
            if self._count == 0:
                return
            self._tail = (self._tail + 1) % self.capacity
            self._count -= 1
            self._not_full.notify()


class BufferFull(Exception):
    """Producer-side overflow (reference: ``queue.Full`` after 30 s,
    ``effex.py:656-659``)."""


class BufferClosed(Exception):
    pass
