"""Recorded-IQ replay source (BASELINE.json config 3).

Plays back captured IQ (e.g. from RTL-SDRs) as aligned multi-channel blocks.
Formats:
  * ``.npy`` — a ``[nchan, nsamp]`` (or ``[nsamp]`` single-channel) complex array,
  * ``.c64`` / ``.bin`` / ``.raw`` — raw interleaved complex64 (one channel per
    file; pass a list of paths, one per channel).

Also provides :func:`save_recording` so any :class:`~fxtpu_torch.sources.base.Source`
(including the live SDR plugin) can be captured for later replay.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

import numpy as np

from fxtpu_torch.sources.base import Source


def _load_one(path: str, mmap: bool = True) -> np.ndarray:
    """Open one recording, MEMORY-MAPPED by default: a bench-scale capture
    is GBs (60 s of 2-ch complex64 at 2.4 MS/s is already 2.3 GB; GS/s
    replays are far larger), and the feeder only ever touches one block
    at a time — read_block's copy-out pulls pages through the OS cache
    on demand instead of stalling startup on a full load.  Non-c64 .npy
    recordings fall back to an in-memory convert (a mapped array can't
    be reinterpreted in place)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path, mmap_mode="r" if mmap else None)
        if arr.dtype == np.complex64:
            return arr
    elif ext in (".c64", ".bin", ".raw"):
        if mmap:
            return np.memmap(path, dtype=np.complex64, mode="r")
        arr = np.fromfile(path, dtype=np.complex64)
    else:
        raise ValueError(f"unsupported replay format: {path}")
    return np.asarray(arr, dtype=np.complex64)


class ReplaySource(Source):
    """Sequential block replay of recorded IQ, optionally looping.

    When not looping, :meth:`read_block` returns None at end-of-data, which
    ends the feeder stream — the replay analog of the reference's
    run-time-bounded SDR stream (``effex.py:652-655``).
    """

    def __init__(self, paths: Union[str, Sequence[str]], nchan: Optional[int] = None,
                 sample_rate: float = 2.4e6, center_freq: float = 1.4204e9,
                 gain: float = 49.6, loop: bool = False, mmap: bool = True):
        if isinstance(paths, str):
            data = _load_one(paths, mmap)
            if data.ndim == 1:
                data = data[None, :]
        else:
            # per-channel files: stacking would materialize the maps, so
            # multi-file recordings load in memory (pass one .npy for the
            # mapped path)
            chans = [_load_one(p, mmap=False) for p in paths]
            n = min(len(c) for c in chans)
            data = np.stack([c[:n] for c in chans])
        if nchan is not None and data.shape[0] != nchan:
            raise ValueError(
                f"recording has {data.shape[0]} channels, expected {nchan}")
        super().__init__(data.shape[0], sample_rate, center_freq, gain)
        self._data = data
        self._pos = 0
        self.loop = loop

    @property
    def total_samples(self) -> int:
        return self._data.shape[1]

    def select_channels(self, channels: Sequence[int]) -> "ReplaySource":
        """Restrict this source to a subset of channels (zero-copy view).
        Used by per-channel parallel feeders: each feeder thread owns an
        independent single-channel ReplaySource over the same recording,
        so channel reads run concurrently (numpy copies release the GIL)."""
        channels = list(channels)
        if len(channels) == 1:
            # basic slicing keeps a memory-mapped recording mapped; a
            # fancy-index would materialize the whole channel
            c = channels[0]
            self._data = self._data[c: c + 1]
        else:
            self._data = self._data[channels]
        self.nchan = self._data.shape[0]
        return self

    def split_channels(self) -> list:
        """Independent single-channel ReplaySources over zero-copy views of
        the same recording, each starting at THIS source's current cursor
        (so a resume-restored position carries into the splits).  Channel
        reads then run concurrently — numpy copies release the GIL — and
        each split satisfies the zero-copy producer's 1-channel
        requirement (`runtime/feeder.py` reserve/commit loop)."""
        outs = []
        for c in range(self.nchan):
            s = ReplaySource.__new__(ReplaySource)
            Source.__init__(s, 1, self.sample_rate, self.center_freq,
                            self.gain)
            s._data = self._data[c: c + 1]
            s._pos = self._pos
            s.loop = self.loop
            outs.append(s)
        return outs

    def read_block(self, num_samp: int) -> Optional[np.ndarray]:
        n = self._data.shape[1]
        if self._pos + num_samp > n:
            if not self.loop:
                return None
            self._pos = 0
            if num_samp > n:
                raise ValueError("block longer than recording")
        block = self._data[:, self._pos: self._pos + num_samp]
        self._pos += num_samp
        return np.ascontiguousarray(block)

    def read_block_into(self, out: np.ndarray, num_samp: int) -> bool:
        """Zero-copy-producer read: copy the next block of a SINGLE-channel
        replay straight into ``out`` (a ring slot view, shape
        ``[num_samp]``) — one pass instead of read_block's
        ascontiguousarray staging copy + put memcpy.  False = exhausted."""
        if self.nchan != 1:
            raise ValueError("read_block_into requires a 1-channel source")
        n = self._data.shape[1]
        if self._pos + num_samp > n:
            if not self.loop:
                return False
            self._pos = 0
            if num_samp > n:
                raise ValueError("block longer than recording")
        np.copyto(out, self._data[0, self._pos: self._pos + num_samp])
        self._pos += num_samp
        return True

    def snapshot_state(self) -> dict:
        return {"pos": self._pos}

    def restore_state(self, state: dict) -> None:
        self._pos = int(state["pos"])


#: Extensions recognized as raw rtl_sdr captures (interleaved u8 I,Q)
RTL_U8_EXTS = (".u8", ".iq8", ".rtl", ".iq")


class RtlU8ReplaySource(Source):
    """Replay of NATIVE rtl_sdr captures: raw interleaved unsigned-8-bit
    I,Q pairs, one channel per file — the byte stream ``rtl_sdr out.iq``
    writes (the tool dumps the tuner's 8-bit ADC words unmodified).

    The samples are re-biased u8 → int8 (``x ^ 0x80`` == x − 128, the
    RTL2832's 127.5-centered convention — the QuantizedSource docstring's
    point at ``sources/base.py:190-195``) and emitted as ``[nch,
    num_samp, 2]`` int8 blocks, the int8-ingest form: a native capture
    replays straight into the int8 rings and the packed-word kernel with
    NO float detour anywhere (the reference converts u8 → complex128 at
    the USB boundary, quadrupling every byte before transport —
    ``effex/effex.py`` via pyrtlsdr).  With
    ``as_complex=True`` (a complex64-ingest run) blocks are dequantized
    on the host at ``quant_step`` instead.

    Files stay memory-mapped (captures are GBs); reads copy one block
    through the OS page cache like :class:`ReplaySource`.
    """

    def __init__(self, paths: Union[str, Sequence[str]],
                 nchan: Optional[int] = None, sample_rate: float = 2.4e6,
                 center_freq: float = 1.4204e9, gain: float = 49.6,
                 loop: bool = False, as_complex: bool = False,
                 quant_step: float = 1.0 / 32, mmap: bool = True):
        if isinstance(paths, str):
            paths = [paths]
        maps = []
        for p in paths:
            m = (np.memmap(p, dtype=np.uint8, mode="r") if mmap
                 else np.fromfile(p, dtype=np.uint8))
            if m.size % 2:
                m = m[: m.size - 1]  # trailing odd byte: truncated pair
            maps.append(m.reshape(-1, 2))
        n = min(m.shape[0] for m in maps)
        #: per-channel u8 views [nsamp, 2]; kept as a LIST so each stays
        #: an independent map (stacking would materialize them)
        self._chans = [m[:n] for m in maps]
        if nchan is not None and len(self._chans) != nchan:
            raise ValueError(
                f"capture has {len(self._chans)} channels, expected {nchan}")
        super().__init__(len(self._chans), sample_rate, center_freq, gain)
        self._pos = 0
        self.loop = loop
        self.as_complex = as_complex
        self.quant_step = float(quant_step)

    @property
    def total_samples(self) -> int:
        return self._chans[0].shape[0]

    def _advance(self, num_samp: int) -> Optional[int]:
        n = self.total_samples
        if self._pos + num_samp > n:
            if not self.loop:
                return None
            self._pos = 0
            if num_samp > n:
                raise ValueError("block longer than capture")
        pos = self._pos
        self._pos += num_samp
        return pos

    def read_block(self, num_samp: int) -> Optional[np.ndarray]:
        pos = self._advance(num_samp)
        if pos is None:
            return None
        out = np.empty((self.nchan, num_samp, 2), np.int8)
        for c, ch in enumerate(self._chans):
            # u8 ^ 0x80 == u8 - 128 reinterpreted as int8: one SIMD pass
            np.bitwise_xor(ch[pos: pos + num_samp], 0x80,
                           out=out[c].view(np.uint8))
        if not self.as_complex:
            return out
        f = out.astype(np.float32) * self.quant_step
        return (f[..., 0] + 1j * f[..., 1]).astype(np.complex64)

    def read_block_into(self, out: np.ndarray, num_samp: int) -> bool:
        """Zero-copy-producer read (int8 form only): re-bias the next
        block straight into ``out`` (an int8 ``[num_samp, 2]`` ring-slot
        view) — one pass, no staging array."""
        if self.nchan != 1:
            raise ValueError("read_block_into requires a 1-channel source")
        if self.as_complex:
            raise ValueError("read_block_into is the int8-ingest path")
        pos = self._advance(num_samp)
        if pos is None:
            return False
        np.bitwise_xor(self._chans[0][pos: pos + num_samp], 0x80,
                       out=out.view(np.uint8))
        return True

    def split_channels(self) -> list:
        outs = []
        for ch in self._chans:
            s = RtlU8ReplaySource.__new__(RtlU8ReplaySource)
            Source.__init__(s, 1, self.sample_rate, self.center_freq,
                            self.gain)
            s._chans = [ch]
            s._pos = self._pos
            s.loop = self.loop
            s.as_complex = self.as_complex
            s.quant_step = self.quant_step
            outs.append(s)
        return outs

    def snapshot_state(self) -> dict:
        return {"pos": self._pos}

    def restore_state(self, state: dict) -> None:
        self._pos = int(state["pos"])


def save_recording(source: Source, path: str, num_samp: int, nblocks: int):
    """Capture ``nblocks`` aligned blocks from any source into a replayable
    ``.npy`` file."""
    blocks = []
    for _ in range(nblocks):
        b = source.read_block(num_samp)
        if b is None:
            break
        blocks.append(b)
    if not blocks:
        raise ValueError("source produced no data")
    np.save(path, np.concatenate(blocks, axis=1))
    return path
