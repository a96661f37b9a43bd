"""Single validated configuration object for the correlator.

A copy of ``fxtpu.config`` without its JAX package import, plus the
``device`` field that places the port's tensors.  It replaces the
reference's split between argparse defaults and property-setter validation
(``effex/effex.py:45-53`` vs ``:703-770``), which
duplicated every default in two places.  One dataclass, validated once, and
serialized verbatim into the CSV product header (see ``fxtpu_torch.products``).

Defaults mirror the reference CLI defaults (``effex.py:706-770``).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)

STATES = ("OFF", "STARTUP", "RUN", "CALIBRATE", "SHUTDOWN")
MODES = ("SPECTRUM", "CONTINUUM", "TEST")

#: Practical RTL-SDR per-channel bandwidth ceiling (``effex.py:252-254``).
SDR_STABLE_BANDWIDTH = 2.8e6

#: Reference num_samp clamp bounds (``effex.py:277-284``).
MIN_NUM_SAMP = 2**8
MAX_NUM_SAMP = 2**18


@dataclasses.dataclass
class CorrelatorConfig:
    """All knobs for one correlator run.

    Mirrors the reference ``Correlator(...)`` kwargs (``effex.py:45-53``)
    and generalizes them: N channels instead of 2, configurable PFB taps,
    a pluggable signal source, and explicit dtype / sharding controls.
    """

    # --- reference-parity knobs (effex.py:45-53, :703-770) -----------------
    run_time: float = 1.0          # seconds; must be >= 1 (effex.py:236-242)
    bandwidth: float = 2.4e6       # Hz == sample rate (effex.py:250-257)
    frequency: float = 1.4204e9    # Hz center tuning (effex.py:265-269)
    num_samp: int = 2**18          # samples per block (effex.py:277-284)
    nbins: int = 2**12             # PFB branches / FFT bins (effex.py:292-294)
    gain: float = 49.6             # dB tuner gain (effex.py:302-306)
    mode: str = "SPECTRUM"         # SPECTRUM | CONTINUUM | TEST (effex.py:314-320)
    loglevel: str = "INFO"

    # --- generalizations ----------------------------------------------------
    nchan: int = 2                 # N-element generalization (reference: fixed 2)
    ntaps: int = 4                 # PFB taps (reference constant, effex.py:115)
    window: str = "hamming"        # PFB window family (effex.py:126-127)
    include_autos: bool = False    # include autocorrelation baselines
    calibrate_on_start: bool = True  # reference: first chunk always calibrates
                                     # (STARTUP -> CALIBRATE, effex.py:351-353)
    calibrate_samples: int = 2**18   # delay-cal window (leading samples of the
                                     # block; the reference calibrates on its
                                     # whole 2^18 chunk, effex.py:484).  A
                                     # fixed window bounds the cal FFT
                                     # size.  Clamped to num_samp.
    dtype: str = "complex64"       # in-graph dtype; only complex64 is
                                   # implemented (the reference is
                                   # complex128 end-to-end, effex.py:109-110)
    clamp_num_samp: bool = True    # clamp to [2^8, 2^18] like effex.py:277-284
    fused: object = "auto"         # the hand-written CUDA FX kernel:
                                   # 'auto' (on a CUDA device, for shapes
                                   # it supports), True (required: raise
                                   # if it cannot run), False (plain torch)
    device: str = "cuda"           # torch device the FX step runs on:
                                   # "cuda" (the card) or "cpu"

    # --- source selection ----------------------------------------------------
    source: str = "synthetic"      # synthetic | replay | rtlsdr
    ingest_dtype: str = "complex64"  # complex64 | int8: int8 streams 8-bit
                                     # quantized IQ through the rings and
                                     # the host-to-device copy (4x fewer
                                     # bytes; radio ADCs are 8-bit), and
                                     # the device dequantizes it
    quant_step: float = 1.0 / 32     # LSB size of 8-bit samples (x ~ q*step)
    replay_file: Optional[str] = None
    seed: int = 77777              # test-suite RNG seed parity (test_effex.py:10)
    synthetic_delay: float = 0.0   # true injected inter-channel delay (seconds)
    synthetic_snr: float = 10.0    # common-signal to noise ratio for synthetic src

    # --- runtime / output -----------------------------------------------------
    output_file: Optional[str] = None   # default: timestamped CSV like effex.py:136
    omit_plot: bool = False
    buffer_chunks: Optional[int] = None  # ring-buffer capacity per channel
    startup_duration: float = 1.0        # common-epoch barrier (effex.py:39-40)
    keyboard_control: bool = False       # stdin 'c' -> recalibrate (effex.py:158-162)
    channel_feeders: bool = True         # one feeder per channel when the
                                         # source can split (zero-copy
                                         # reserve/commit producer path);
                                         # False = single multi-channel feeder

    # --- sharding -----------------------------------------------------------
    mesh_time: int = 1             # time-block shards (DP analog)
    mesh_freq: int = 1             # frequency-bin shards (TP analog)

    # --- TEST-mode sweep overrides (None -> reference formulas) -------------
    test_sweep_step: Optional[float] = None   # default (1/fc)/2, effex.py:154
    test_offset_steps: int = 1600             # offset = step*1600, effex.py:155

    # --- dispatch batching ---------------------------------------------------
    # Blocks correlated per device call.  1 is the reference's per-block
    # dispatch; K > 1 stages K blocks at a time (runtime/stager.py) for
    # one FxEngine.multi_step call.  The mesh knobs above and the snapshot
    # knobs below are kept for field parity with fxtpu.config and raise
    # NotImplementedError naming their ROADMAP.md item.
    blocks_per_dispatch: int = 1

    # --- long-integration / durability (SURVEY.md §5.4; none in reference) --
    integration_blocks: int = 1        # blocks averaged per output row
    snapshot_every: int = 0            # blocks between state snapshots (0=off)
    resume_from: Optional[str] = None  # snapshot to restore before running
    profile_dir: Optional[str] = None  # torch.profiler trace directory

    def __post_init__(self):
        self.mode = str(self.mode).upper()
        if self.mode not in MODES:
            raise ValueError(
                f"Mode input {self.mode} is not in known modes: {MODES}")
        if self.run_time < 1:
            raise ValueError(
                f"run time {self.run_time} is not allowed; "
                "run times must be >= 1 second.")
        if self.clamp_num_samp:
            # Silent clamp, matching effex.py:277-284.
            self.num_samp = int(min(max(int(round(self.num_samp)),
                                        MIN_NUM_SAMP), MAX_NUM_SAMP))
        if self.nchan < 2:
            raise ValueError(f"nchan must be >= 2, got {self.nchan}")
        if self.ntaps < 1:
            raise ValueError(f"ntaps must be >= 1, got {self.ntaps}")
        if self.nbins < 2:
            raise ValueError(f"nbins must be >= 2, got {self.nbins}")
        # Reference constraint: at least one full PFB window per block
        # (effex.py:118-124).
        n_int = self.num_samp // self.ntaps // self.nbins
        if n_int < 1:
            raise ValueError(
                "there must be at least 1 window of length n_branches*ntaps "
                f"in each input timeseries. timeseries len: {self.num_samp} "
                f"n_branches: {self.nbins} ntaps: {self.ntaps} "
                f"n_branches*ntaps: {self.nbins * self.ntaps}")
        if self.dtype != "complex64":
            raise ValueError(
                f"dtype must be 'complex64', got {self.dtype!r}: the FX "
                "step, its CUDA kernel and the CSV products are built for "
                "complex64 samples only")
        if self.device != "cpu" and not self.device.startswith("cuda"):
            raise ValueError(
                f"device must be 'cuda' (or 'cuda:N') or 'cpu', got "
                f"{self.device!r}")
        if self.ingest_dtype not in ("complex64", "int8"):
            raise ValueError(f"ingest_dtype must be 'complex64' or 'int8', "
                             f"got {self.ingest_dtype!r}")
        if self.source not in ("synthetic", "replay", "rtlsdr"):
            raise ValueError(f"unknown source kind: {self.source}")
        if self.buffer_chunks is None:
            # Same sizing LAW as the reference — fit ~1 GB of ring slots
            # split over two channels (effex.py:37-38), floored at 4 —
            # but computed from the ACTUAL ring itemsize (complex64 = 8 B,
            # int8 planes = 2 B/sample), so int8 runs buffer the same
            # wall-clock span of signal, not 8x less.
            itemsize = 2 if self.ingest_dtype == "int8" else 8
            self.buffer_chunks = max(
                4, int(1e9 // (self.num_samp * itemsize) // 2))
        if self.output_file is None:
            self.output_file = time.strftime("visibilities_%Y%m%d-%H%M%S") + ".csv"

    # ------------------------------------------------------------------
    @property
    def n_frames(self) -> int:
        """PFB output frames per block (floor framing; tail samples dropped).

        The reference's cuSignal channelizer emits ``num_samp // nbins``
        windows per chunk with zero history at the chunk start
        (``effex.py:553``); we reproduce that framing (see fxtpu_torch.ops.pfb).
        """
        return self.num_samp // self.nbins

    @property
    def n_baselines(self) -> int:
        n = self.nchan
        cross = n * (n - 1) // 2
        return cross + (n if self.include_autos else 0)

    @property
    def test_delay_sweep_step(self) -> float:
        """TEST-mode delay sweep step: half the critical delay 1/fc
        (``effex.py:151-154``), unless overridden."""
        if self.test_sweep_step is not None:
            return self.test_sweep_step
        return (1.0 / self.frequency) / 2.0

    @property
    def test_delay_offset(self) -> float:
        """TEST-mode sweep start offset (``effex.py:155``)."""
        return self.test_delay_sweep_step * self.test_offset_steps

    def metadata(self) -> dict:
        """Key/value metadata persisted in the CSV header.

        Superset of the reference header fields (``effex.py:671-678``),
        adding ``sweep_step`` so the standalone post-processor no longer
        has to reconstruct it (fixes the (1/fc)/10 vs (1/fc)/2 mismatch,
        ``post_process.py:213-215`` vs ``effex.py:154``).
        """
        md = {
            "run_time": self.run_time,
            "bandwidth": self.bandwidth,
            "frequency": self.frequency,
            "num_samp": self.num_samp,
            "resolution": self.nbins,
            "gain": self.gain,
            "mode": self.mode,
        }
        if self.mode == "TEST":
            md["sweep_step"] = self.test_delay_sweep_step
        if self.nchan != 2:
            md["nchan"] = self.nchan
        return md
