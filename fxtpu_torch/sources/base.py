"""Signal-source abstraction (the reference's L1 layer, generalized).

The reference hard-codes two pyrtlsdr USB receivers
(``effex/effex.py:81-82``) and streams each from a dedicated
child process (``effex.py:630-664``).  Here the hardware boundary is a
protocol: a :class:`Source` produces aligned multi-channel complex IQ blocks,
and synthetic, replay, and (optional) live-SDR implementations are
interchangeable — which also makes the whole test suite hardware-free
(the reference suite requires two physical SDRs plugged in; SURVEY.md §4).
"""

from __future__ import annotations

import abc
import asyncio
from typing import AsyncIterator, Optional

import numpy as np


class Source(abc.ABC):
    """Produces aligned ``[nchan, num_samp]`` complex64 IQ blocks.

    The tuning attributes mirror the reference's hardware pass-through
    properties (``effex.py:250-306``): setting them on the correlator
    forwards here; synthetic sources use them to parameterize generation,
    the SDR plugin writes them to the tuner.
    """

    #: Per-channel bandwidth above which this source becomes unreliable,
    #: or None.  RTL-SDRs declare 2.8e6 (``effex.py:252-254``).
    max_stable_bandwidth: Optional[float] = None

    #: True for sources whose samples are lost if not consumed in time
    #: (live radios).  Non-realtime sources (synthetic, replay) produce on
    #: demand, so the feeder applies backpressure — blocking on a full ring
    #: instead of timing out and dying (the reference's 30 s put-timeout
    #: death at ``effex.py:653-659`` only makes sense for live hardware).
    realtime: bool = False

    def __init__(self, nchan: int, sample_rate: float = 2.4e6,
                 center_freq: float = 1.4204e9, gain: float = 49.6):
        self.nchan = int(nchan)
        self._sample_rate = float(sample_rate)
        self._center_freq = float(center_freq)
        self._gain = float(gain)
        self._stopped = False

    # -- tuning pass-through (effex.py:256-257,268-269,305-306) -----------
    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    @sample_rate.setter
    def sample_rate(self, value: float):
        self._sample_rate = float(value)

    @property
    def center_freq(self) -> float:
        return self._center_freq

    @center_freq.setter
    def center_freq(self, value: float):
        self._center_freq = float(value)

    @property
    def gain(self) -> float:
        return self._gain

    @gain.setter
    def gain(self, value: float):
        self._gain = float(value)

    # -- data ---------------------------------------------------------------
    @abc.abstractmethod
    def read_block(self, num_samp: int) -> Optional[np.ndarray]:
        """Produce the next aligned block, shape ``[nchan, num_samp]``
        complex64, or None when the source is exhausted (replay end)."""

    async def stream(self, num_samp: int) -> AsyncIterator[np.ndarray]:
        """Async block iterator, shaped like the reference's
        ``sdr.stream(format='samples', num_samples_or_bytes=N)``
        (``effex.py:652``)."""
        while not self._stopped:
            block = self.read_block(num_samp)
            if block is None:
                return
            yield block
            await asyncio.sleep(0)

    # -- checkpoint/resume ---------------------------------------------------
    def snapshot_state(self) -> Optional[dict]:
        """JSON-serializable stream state for checkpoint/resume, or None
        when this source cannot reproduce its stream (live radios — their
        samples exist once; SURVEY.md §5.4 resume contract: a resumed run
        must produce the SAME samples the uninterrupted run would have).
        Synthetic sources snapshot their RNG/phase state, replay sources
        their cursor; wrappers delegate to the wrapped source."""
        return None

    def restore_state(self, state: dict) -> None:
        """Restore a :meth:`snapshot_state` snapshot.  Raises for sources
        that cannot resume (the Correlator surfaces this at --resume_from
        time rather than silently regenerating DIFFERENT samples)."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot restore stream state — resume "
            "is only possible for sources that can reproduce their stream "
            "(replay/synthetic)")

    # -- per-channel parallel ingest ------------------------------------------
    def split_channels(self) -> Optional[list]:
        """Split into N independent single-channel sources over the same
        stream, or None when the channels cannot be read independently
        (synthetic correlated noise shares one generator; a live radio is
        one USB device).  This is what activates the zero-copy
        reserve/commit producer in production: the Correlator spawns one
        Feeder per split, each pairing a 1-channel source with 1 native
        ring — the configuration the reference gets from one process per
        SDR (``effex.py:630-650``), minus its pickle+queue copies."""
        return None

    def stop(self):
        """Stop streaming (``sdr.stop()`` analog, ``effex.py:661``)."""
        self._stopped = True

    def close(self):
        """Release resources (``sdr.close()`` analog, ``effex.py:176-180``)."""
        self._stopped = True


class LimitedSource(Source):
    """Wraps a source and exhausts after ``limit`` blocks — turns an
    endless synthetic generator into a deterministic fixed-length stream
    (run length in BLOCKS instead of the reference's wall-clock
    ``run_time``, ``effex.py:713``), which snapshot/resume tests and
    reproducible benchmarks need."""

    def __init__(self, inner: Source, limit: int):
        super().__init__(inner.nchan, inner.sample_rate, inner.center_freq,
                         inner.gain)
        self.inner = inner
        self.limit = int(limit)
        self._read = 0
        self.realtime = getattr(inner, "realtime", False)
        self.max_stable_bandwidth = inner.max_stable_bandwidth

    def read_block(self, num_samp: int):
        if self._read >= self.limit:
            return None
        self._read += 1
        return self.inner.read_block(num_samp)

    # the limit is run-local (run B's budget is fresh), so only the inner
    # stream state is snapshotted
    def snapshot_state(self):
        return self.inner.snapshot_state()

    def restore_state(self, state: dict) -> None:
        self.inner.restore_state(state)

    def split_channels(self):
        """Per-channel limited splits: feeders advance their channels in
        lockstep, so giving each split this source's REMAINING budget is
        equivalent to one shared countdown."""
        inners = self.inner.split_channels()
        if inners is None:
            return None
        outs = [LimitedSource(s, self.limit) for s in inners]
        for o in outs:
            o._read = self._read
        return outs

    def stop(self):
        super().stop()
        self.inner.stop()

    def close(self):
        super().close()
        self.inner.close()
