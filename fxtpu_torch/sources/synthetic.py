"""Synthetic IQ sources: correlated noise and tones with injectable delay.

Replaces the live USB receivers for development, testing, and benchmarking
(BASELINE.json config 1).  The generators mirror the reference test-suite's
synthetic signals (``effex/tests/test_effex.py:31-49``) and add the
one thing the reference never had: a *correlated* multi-channel source with a
known, injectable inter-channel delay — the ground truth the calibration and
TEST-mode fringe oracles check against.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from fxtpu_torch.sources.base import Source


def complex_noise(rng: np.random.Generator, num_samp: int,
                  scale: float = 0.1) -> np.ndarray:
    """Complex Gaussian noise (``test_effex.py:44-49``)."""
    return (rng.normal(size=num_samp, scale=scale)
            + 1j * rng.normal(size=num_samp, scale=scale)).astype(np.complex64)


def complex_sinusoid(num_samp: int, rate: float, freq: float,
                     phase: float = 0.0, t0: float = 0.0) -> np.ndarray:
    """Complex tone (``test_effex.py:31-41``), with a start-time offset so
    consecutive blocks are phase-continuous."""
    t = t0 + np.arange(num_samp) / rate
    ph = 2.0 * np.pi * freq * t + phase
    return (np.cos(ph) + 1j * np.sin(ph)).astype(np.complex64)


def fractional_delay(x: np.ndarray, delay_samples: float) -> np.ndarray:
    """Apply a (possibly fractional) circular delay via an FFT phase ramp.

    Positive delay shifts the signal later in time (``roll(x, +k)`` for
    integer k), the same convention the reference tests use
    (``test_effex.py:101``).
    """
    if delay_samples == 0:
        return x
    n = len(x)
    f = np.fft.fftfreq(n)
    return np.fft.ifft(np.fft.fft(x)
                       * np.exp(-2j * np.pi * f * delay_samples)).astype(x.dtype)


def _block_rng(seed: int, block: int, lane: int) -> np.random.Generator:
    """Counter-keyed generator: the randomness of (block, lane) is a pure
    function of the key — independent of read history.  This is the
    jax-style key-derivation discipline applied to the host generators,
    and it is what makes synthetic sources SPLITTABLE (a per-channel
    split regenerates exactly the unsplit source's channel slice) and
    their snapshots O(1) (a block counter instead of generator innards).
    Lane 0 is the shared correlated signal, lane 1+c channel c's noise."""
    return np.random.default_rng([seed, block, lane])


class NoiseSource(Source):
    """Correlated wideband noise across N channels.

    Each channel sees a common flat-PSD noise signal (the reference's
    calibration assumes exactly this input — ``effex.py:480-481``) delayed by
    ``delays[c]`` seconds, plus independent per-channel noise at
    ``1/snr`` of the common power.

    Generation is counter-keyed per (block, lane) — see :func:`_block_rng`
    — so :meth:`split_channels` yields independent single-channel sources
    whose streams are bit-identical to the unsplit source's channel
    slices: the default synthetic run uses the same per-channel zero-copy
    feeders and fault-injection paths as production replay ingest
    (r3 VERDICT missing #3).
    """

    def __init__(self, nchan: int = 2, sample_rate: float = 2.4e6,
                 center_freq: float = 1.4204e9, gain: float = 49.6,
                 delays: Optional[Sequence[float]] = None,
                 snr: float = 10.0, seed: int = 77777, scale: float = 0.1):
        super().__init__(nchan, sample_rate, center_freq, gain)
        self.delays = np.zeros(nchan) if delays is None else np.asarray(
            delays, dtype=np.float64)
        if len(self.delays) != nchan:
            raise ValueError("need one delay per channel")
        self.snr = float(snr)
        self.scale = float(scale)
        self.seed = int(seed)
        #: global channel ids this instance emits (splits narrow it)
        self._channels = list(range(nchan))
        self._block = 0

    def read_block(self, num_samp: int) -> np.ndarray:
        k = self._block
        self._block += 1
        common = complex_noise(_block_rng(self.seed, k, 0), num_samp,
                               self.scale)
        noise_scale = self.scale / np.sqrt(self.snr)
        out = np.empty((self.nchan, num_samp), dtype=np.complex64)
        for i, c in enumerate(self._channels):
            d_samp = self.delays[c] * self.sample_rate
            sig = fractional_delay(common, d_samp)
            out[i] = sig + complex_noise(_block_rng(self.seed, k, 1 + c),
                                         num_samp, noise_scale)
        return out

    def read_block_into(self, out: np.ndarray, num_samp: int) -> bool:
        """Zero-copy-producer read (single-channel splits): generate the
        next block directly into ``out`` (a complex64 ring-slot view)."""
        if self.nchan != 1:
            raise ValueError("read_block_into requires a 1-channel source")
        out[:] = self.read_block(num_samp)[0]
        return True

    def split_channels(self) -> list:
        """Independent single-channel sources over the same keyed stream,
        each starting at THIS source's current block counter.  Channel
        c's split regenerates the identical common signal (lane 0) plus
        its own noise lane, so split output == unsplit output channel
        slice, bit-exact."""
        outs = []
        for c in self._channels:
            s = NoiseSource.__new__(NoiseSource)
            Source.__init__(s, 1, self.sample_rate, self.center_freq,
                            self.gain)
            s.delays = self.delays
            s.snr, s.scale, s.seed = self.snr, self.scale, self.seed
            s._channels = [c]
            s._block = self._block
            outs.append(s)
        return outs

    def snapshot_state(self) -> dict:
        # the whole stream position is one counter (see _block_rng)
        return {"block": self._block}

    def restore_state(self, state: dict) -> None:
        if "block" not in state:
            raise ValueError(
                "incompatible NoiseSource snapshot (pre-counter-keyed "
                "schema); re-record the checkpoint with this version")
        self._block = int(state["block"])


class SinusoidSource(Source):
    """Correlated complex tone across N channels (phase-continuous between
    blocks), with optional additive noise — the spectrometer oracle input."""

    def __init__(self, nchan: int = 2, sample_rate: float = 2.4e6,
                 center_freq: float = 1.4204e9, gain: float = 49.6,
                 tone_freq: float = 1e5, delays: Optional[Sequence[float]] = None,
                 noise_scale: float = 0.0, seed: int = 77777):
        super().__init__(nchan, sample_rate, center_freq, gain)
        self.tone_freq = float(tone_freq)
        self.delays = np.zeros(nchan) if delays is None else np.asarray(
            delays, dtype=np.float64)
        self.noise_scale = float(noise_scale)
        self.seed = int(seed)
        self._channels = list(range(nchan))
        self._block = 0
        self._t0 = 0.0

    def read_block(self, num_samp: int) -> np.ndarray:
        k = self._block
        self._block += 1
        out = np.empty((self.nchan, num_samp), dtype=np.complex64)
        for i, c in enumerate(self._channels):
            out[i] = complex_sinusoid(num_samp, self.sample_rate,
                                      self.tone_freq,
                                      t0=self._t0 - self.delays[c])
            if self.noise_scale:
                out[i] += complex_noise(_block_rng(self.seed, k, 1 + c),
                                        num_samp, self.noise_scale)
        self._t0 += num_samp / self.sample_rate
        return out

    def read_block_into(self, out: np.ndarray, num_samp: int) -> bool:
        """Zero-copy-producer read (single-channel splits)."""
        if self.nchan != 1:
            raise ValueError("read_block_into requires a 1-channel source")
        out[:] = self.read_block(num_samp)[0]
        return True

    def split_channels(self) -> list:
        """Independent single-channel splits; noise is counter-keyed per
        channel lane (see :func:`_block_rng`), the tone is a pure function
        of (t0, delays[c]) — split output == unsplit channel slice."""
        outs = []
        for c in self._channels:
            s = SinusoidSource.__new__(SinusoidSource)
            Source.__init__(s, 1, self.sample_rate, self.center_freq,
                            self.gain)
            s.tone_freq, s.delays = self.tone_freq, self.delays
            s.noise_scale, s.seed = self.noise_scale, self.seed
            s._channels = [c]
            s._block, s._t0 = self._block, self._t0
            outs.append(s)
        return outs

    def snapshot_state(self) -> dict:
        return {"block": self._block, "t0": self._t0}

    def restore_state(self, state: dict) -> None:
        if "block" not in state:
            raise ValueError(
                "incompatible SinusoidSource snapshot (pre-counter-keyed "
                "schema); re-record the checkpoint with this version")
        self._block = int(state["block"])
        self._t0 = float(state["t0"])


class FaultInjectingSource(Source):
    """Wraps another source and injects faults (dropped or short blocks) on
    a schedule — the fault-injection hook SURVEY.md §5.3 calls for.

    A drop is a REAL stream gap: the skipped block's sequence number is
    skipped too (the feeder reads :meth:`take_dropped` and advances its
    seq counter), so downstream ring blocks carry the gap exactly like a
    live radio losing a USB transfer.  ``drop_channel`` confines the drop
    schedule to one channel — via :meth:`split_channels`, so it requires
    per-channel feeders — which is what actually exercises the
    :class:`~fxtpu_torch.runtime.feeder.BlockAligner`'s seq-realign path end to
    end (an all-channel drop stays aligned)."""

    def __init__(self, inner: Source, drop_every: int = 0,
                 short_every: int = 0, fail_at: int = -1,
                 drop_channel: Optional[int] = None):
        super().__init__(inner.nchan, inner.sample_rate, inner.center_freq,
                         inner.gain)
        self.inner = inner
        self.drop_every = drop_every
        self.short_every = short_every
        self.fail_at = fail_at
        self.drop_channel = drop_channel
        self._count = 0
        self._dropped = 0
        # transparent wrapper: keep the inner source's feeder discipline
        # (realtime drop-vs-backpressure) and bandwidth ceiling, like
        # QuantizedSource
        self.realtime = getattr(inner, "realtime", False)
        self.max_stable_bandwidth = inner.max_stable_bandwidth

    def read_block(self, num_samp: int) -> Optional[np.ndarray]:
        self._count += 1
        if self._count == self.fail_at:
            raise RuntimeError(f"injected source failure at block {self._count}")
        if self.drop_channel is not None and self.nchan > 1:
            # a multi-channel read cannot represent a one-channel gap —
            # the schedule only takes effect through split_channels()
            # (per-channel feeders); reading unsplit would silently
            # inject NOTHING, vacuously passing whatever test used it
            raise RuntimeError(
                "drop_channel requires per-channel feeders: this source "
                "must be consumed via split_channels() (Correlator default"
                " channel_feeders=True with a splittable inner source)")
        block = self.inner.read_block(num_samp)
        if block is None:
            return None
        if self.drop_every and self._count % self.drop_every == 0:
            block = self.inner.read_block(num_samp)  # skip one (a drop)
            self._dropped += 1
        if self.short_every and self._count % self.short_every == 0 and block is not None:
            block = block[:, : num_samp // 2]  # short read
        return block

    def take_dropped(self) -> int:
        """Number of blocks lost since the last call (feeder protocol:
        the feeder advances its seq counter by this, turning the loss
        into a ring-level sequence gap)."""
        n = self._dropped
        self._dropped = 0
        return n

    def split_channels(self):
        """Split the wrapped source; the drop/short schedules ride ONLY
        ``drop_channel``'s split (every split when drop_channel is None,
        matching the unsplit read's all-channel shorts), so one channel's
        feeder sees stream gaps its siblings don't.  ``fail_at`` is a
        once-per-STREAM event, so it rides exactly ONE split
        (drop_channel's, else channel 0) — fanning it out would fire the
        injected failure once per feeder (r3 advisor finding).  EVERY
        split keeps the FaultInjectingSource wrapper — snapshots taken
        from any per-channel feeder then carry the same state schema
        this (parent) source restores."""
        inners = self.inner.split_channels()
        if inners is None:
            return None
        fail_chan = 0 if self.drop_channel is None else self.drop_channel
        outs = [
            FaultInjectingSource(
                s,
                drop_every=(self.drop_every
                            if self.drop_channel in (None, c) else 0),
                short_every=(self.short_every
                             if self.drop_channel in (None, c) else 0),
                fail_at=(self.fail_at if c == fail_chan else -1))
            for c, s in enumerate(inners)]
        for w in outs:
            # a resumed (restore_state'd) parent splits mid-schedule
            w._count = self._count
            if self.drop_channel is not None:
                w._divergent = True  # see snapshot_state
        return outs

    #: True on splits of a drop_channel source: the channels' stream
    #: positions diverge, so no single cursor can reproduce the run.
    _divergent = False

    def snapshot_state(self):
        if self.drop_channel is not None or self._divergent:
            # resume must refuse (no stream state in the snapshot) rather
            # than restore one channel's cursor over diverged siblings
            return None
        inner = self.inner.snapshot_state()
        if inner is None:
            return None
        return {"inner": inner, "count": self._count}

    def restore_state(self, state: dict) -> None:
        self.inner.restore_state(state["inner"])
        self._count = int(state["count"])

    def stop(self):
        super().stop()
        self.inner.stop()

    def close(self):
        super().close()
        self.inner.close()
