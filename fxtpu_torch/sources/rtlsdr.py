"""Optional live RTL-SDR source plugin (host-side hardware I/O).

Kept API-shape compatible with the reference's pyrtlsdr usage
(``effex/effex.py:81-82,256-269,305-306,652-661``): N
clock-locked dongles (PLL dithering disabled, per the keenerd librtlsdr fork
the reference requires — ``README.md:32-35``), each streamed by an asyncio
reader; blocks are aligned by a common start-time barrier plus sequence
numbers.  Import is gated: this module is importable without pyrtlsdr; only
constructing the source requires it.  Note: bias-tee power (the reference's
``run.sh`` rtl_biast wrapper) is hardware-side and out of scope here.
"""

from __future__ import annotations

import asyncio
import threading
import time
from queue import Empty, Full, Queue
from typing import Optional

import numpy as np

from fxtpu_torch.sources.base import Source

try:  # pragma: no cover - hardware path
    from rtlsdr import RtlSdr  # type: ignore
    HAVE_RTLSDR = True
except Exception:  # pragma: no cover
    RtlSdr = None
    HAVE_RTLSDR = False


class RtlSdrSource(Source):  # pragma: no cover - requires hardware
    """N-dongle live source.  Requires the pyrtlsdr fork with
    ``dithering_enabled`` support for clock-coherent channels."""

    max_stable_bandwidth = 2.8e6  # effex.py:252-254
    realtime = True  # USB stream: unconsumed samples are lost (no backpressure)

    def __init__(self, nchan: int = 2, sample_rate: float = 2.4e6,
                 center_freq: float = 1.4204e9, gain: float = 49.6,
                 startup_delay: float = 1.0):
        if not HAVE_RTLSDR:
            raise ImportError(
                "pyrtlsdr (evanmayer fork with dithering_enabled) is required "
                "for the live SDR source; use source='synthetic' or 'replay'.")
        super().__init__(nchan, sample_rate, center_freq, gain)
        self._sdrs = []
        for idx in range(nchan):
            sdr = RtlSdr(device_index=idx, dithering_enabled=False)
            sdr.rs = sample_rate
            sdr.fc = center_freq
            sdr.gain = gain
            self._sdrs.append(sdr)
        # Bounded queues: a stalled consumer (e.g. a minutes-long first
        # XLA compile) must DROP — seq-tagged, so read_block re-pairs
        # after a drop instead of desynchronizing forever.  An unbounded
        # queue on a realtime source just trades data loss for memory
        # exhaustion.
        self._queues = [Queue(maxsize=8) for _ in range(nchan)]
        self._threads = []
        self._startup_delay = startup_delay
        self._started = False
        self.drops = [0] * nchan
        self.realigned = 0

    # tuning pass-through writes straight to the tuners (effex.py:256-306)
    @Source.sample_rate.setter
    def sample_rate(self, value):
        self._sample_rate = float(value)
        for sdr in self._sdrs:
            sdr.rs = self._sample_rate

    @Source.center_freq.setter
    def center_freq(self, value):
        self._center_freq = float(value)
        for sdr in self._sdrs:
            sdr.fc = self._center_freq

    @Source.gain.setter
    def gain(self, value):
        self._gain = float(value)
        for sdr in self._sdrs:
            sdr.gain = self._gain

    def _start(self, num_samp: int):
        # Common-epoch barrier, as in the reference (effex.py:426,649-650).
        start_time = time.time() + self._startup_delay

        def reader(sdr, q, chan):
            async def run():
                seq = 0
                while time.time() < start_time:
                    await asyncio.sleep(1e-4)
                async for samples in sdr.stream(format="samples",
                                                num_samples_or_bytes=num_samp):
                    if self._stopped:
                        break
                    blk = np.asarray(samples, dtype=np.complex64)
                    try:
                        q.put_nowait((seq, blk))
                    except Full:
                        # consumer stalled: drop the OLDEST queued block
                        # (counted) and enqueue the fresh one — the seq
                        # tags let read_block re-pair across the gap
                        self.drops[chan] += 1
                        try:
                            q.get_nowait()
                        except Empty:
                            pass
                        try:
                            q.put_nowait((seq, blk))
                        except Full:
                            pass
                    seq += 1
                await sdr.stop()
            asyncio.run(run())

        for chan, (sdr, q) in enumerate(zip(self._sdrs, self._queues)):
            t = threading.Thread(target=reader, args=(sdr, q, chan),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        self._started = True

    def read_block(self, num_samp: int) -> Optional[np.ndarray]:
        """One aligned ``[nchan, num_samp]`` block, paired BY SEQUENCE
        NUMBER: a drop in one dongle's stream discards only the matching
        seqs in the others (counted in ``realigned``) instead of pairing
        channel c's block k with channel c+1's block k+1 forever after."""
        if not self._started:
            self._start(num_samp)
        items = []
        for q in self._queues:
            try:
                items.append(q.get(timeout=30))
            except Empty:
                return None
        while True:
            target = max(seq for seq, _ in items)
            if all(seq == target for seq, _ in items):
                break
            self.realigned += 1
            for c, (seq, _) in enumerate(items):
                while seq < target:
                    try:
                        seq, blk = self._queues[c].get(timeout=30)
                    except Empty:
                        return None
                    items[c] = (seq, blk)
        out = np.empty((self.nchan, num_samp), dtype=np.complex64)
        for c, (_seq, blk) in enumerate(items):
            n = min(num_samp, len(blk))
            out[c, :n] = blk[:n]
            if n < num_samp:  # short USB read: zero-pad, never misalign
                out[c, n:] = 0
        return out

    def close(self):
        super().close()
        for sdr in self._sdrs:
            try:
                sdr.close()
            except Exception:
                pass
