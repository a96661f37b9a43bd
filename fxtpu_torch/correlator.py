"""The Correlator: state machine, orchestration, and the host hot loop.

Counterpart of ``fxtpu.correlator``.  Behavioural
contract from the reference ``Correlator`` (``effex/effex.py:23-696``):

  * five states with guarded transitions and :class:`StateTransitionError`
    on illegal edges (``effex.py:204-228``);
  * three modes (SPECTRUM / CONTINUUM / TEST);
  * calibrate-on-start: the first data block is consumed by CALIBRATE
    (``effex.py:351-353``), re-triggerable live with the 'c' key;
  * property setters with validation and source pass-through
    (``effex.py:231-320``);
  * supervision: child exceptions arrive on a queue and force SHUTDOWN;
    buffer-full warnings; a graceful end-of-run drain.

The FX step runs on ``config.device`` through :class:`~fxtpu_torch.fx.
FxEngine`; PyTorch launches asynchronously, so the host loop prepares
block k+1 while the device works on block k and the writer thread forces
block k-1's transfer.  With ``blocks_per_dispatch`` K > 1 the RUN state
takes its blocks from :class:`~fxtpu_torch.runtime.stager.DeviceStager`,
which stages K blocks at a time (pinned, copied on its own stream) for
one ``multi_step`` call, in ``fxtpu``'s order: the first block is
calibrated on the unstaged path and the stager starts on the RUN
transition.  With ``snapshot_every`` N the streaming state is written
every N blocks (:meth:`Correlator.snapshot`, in ``fxtpu``'s snapshot
format: ``runtime.checkpoint``), and ``resume_from`` restores it before
the run, so an integration survives a restart; each package resumes the
other's snapshots.  A resumed run keeps the snapshot's delays and
starts in RUN with ``calibrate_on_start=False``; with it set (the
default) it calibrates its first block, as ``fxtpu``'s does.  With a
``mesh`` (:mod:`fxtpu_torch.parallel`) the step is sharded over its
shards; under several processes each process feeds only the sample span
its shards own (``sample_span``) and only process 0 (``_is_primary``)
writes products.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import threading
import time
from queue import Queue
from typing import Optional

import numpy as np
import torch

from fxtpu_torch import products
from fxtpu_torch.config import (MAX_NUM_SAMP, MIN_NUM_SAMP, MODES, STATES,
                                CorrelatorConfig)
from fxtpu_torch.fx import FxEngine
from fxtpu_torch.ops.xengine import pack_delays
from fxtpu_torch.runtime import checkpoint
from fxtpu_torch.runtime.feeder import BlockAligner, Feeder, StreamDrainTracker
from fxtpu_torch.runtime.metrics import Metrics, profiler_trace
from fxtpu_torch.runtime.native import make_ring, require_native
from fxtpu_torch.runtime.stager import DeviceStager
from fxtpu_torch.sources import make_source
from fxtpu_torch.sources.base import Source

LINESEP = "-" * 80


class StateTransitionError(Exception):
    """Illegal state-machine edge (``effex.py:186-193`` parity)."""

    def __init__(self, prev, next):
        self.prev = prev
        self.next = next
        self.message = (f"Transition from {self.prev} to {self.next} "
                        "is not permitted.")

    def __str__(self):
        return repr(self.message)


#: Legal edges (``effex.py:210-224``): value = allowed next states.
_ALLOWED = {
    "OFF": ("STARTUP",),
    "STARTUP": ("CALIBRATE", "RUN", "SHUTDOWN"),
    "RUN": ("CALIBRATE", "SHUTDOWN"),
    "CALIBRATE": ("RUN", "SHUTDOWN"),
    "SHUTDOWN": ("OFF",),
}


class Correlator:
    """N-channel streaming FX correlator on one torch device, or sharded
    over a :class:`~fxtpu_torch.parallel.mesh.CorrelatorMesh` (``mesh``;
    the config's ``mesh_time`` / ``mesh_freq`` are what the CLI builds it
    from, as in ``fxtpu``).

    Accepts either a :class:`~fxtpu_torch.config.CorrelatorConfig` or the
    reference's keyword arguments (``effex.py:45-53``)."""

    _states = STATES
    _modes = MODES
    StateTransitionError = StateTransitionError  # reference exposes it nested

    def __init__(self, config: Optional[CorrelatorConfig] = None,
                 source: Optional[Source] = None, mesh=None, **kwargs):
        if config is None:
            config = CorrelatorConfig(**kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        self.config = config

        # --- logging (effex.py:55-72) ----------------------------------
        level = getattr(logging, config.loglevel)
        self.logger = logging.getLogger("fxtpu_torch.correlator")
        self.logger.setLevel(level)
        if not self.logger.handlers:
            fmt = logging.Formatter(
                "{asctime} - {name} - {levelname:<8} - {message}", style="{")
            fh = logging.FileHandler("log_fxtpu.log")
            ch = logging.StreamHandler()
            for h in (fh, ch):
                h.setFormatter(fmt)
                self.logger.addHandler(h)
        for h in self.logger.handlers:
            h.setLevel(level)

        # --- supervision channel (effex.py:73-74) -----------------------
        self.exc_queue: Queue = Queue()

        # --- source (replaces the 2 fixed SDRs, effex.py:81-82) ---------
        self.source = source if source is not None else make_source(config)
        if self.source.nchan != config.nchan:
            raise ValueError(
                f"source has {self.source.nchan} channels, config says "
                f"{config.nchan}")

        # Validated pass-through properties (effex.py:84-89).
        self.run_time = config.run_time
        self.bandwidth = config.bandwidth
        self.frequency = config.frequency
        self.num_samp = config.num_samp
        self.nbins = config.nbins
        self.gain = config.gain

        # --- state machine (effex.py:94-99) ------------------------------
        self._state = "OFF"
        self.mode = config.mode
        self.start_time = -1.0

        # --- multi-process: each process feeds only the sample span its
        # mesh shards own (fxtpu_torch.parallel.ingest) -------------------
        self._is_primary = mesh is None or mesh.process_index == 0
        self.sample_span = None
        if mesh is not None and mesh.process_count > 1:
            from fxtpu_torch.parallel.ingest import local_sample_span
            self.sample_span = local_sample_span(mesh, config.num_samp,
                                                 config.nbins)
            self.logger.info(
                "multi-process run: process %d/%d feeds samples [%d, %d) "
                "of each block", mesh.process_index, mesh.process_count,
                *self.sample_span)

        # --- metrics and the run's trace (SURVEY.md §5.1): every stage's
        # span is keyed by its block's ring seq, from the feeders' read to
        # the row's flush -------------------------------------------------
        self.metrics = Metrics()

        # --- host buffering (effex.py:105-110): the native C++ ring, built
        # from csrc/host at first use (on the card it must be) -----------
        self._make_rings()
        self.feeders: list = []

        # --- compute engine (F+X, device side) ---------------------------
        self.engine = FxEngine(config, mesh=mesh)
        self.history = self.engine.fresh_history()
        self.stager: Optional[DeviceStager] = None
        if self._dispatch_batch < config.blocks_per_dispatch:
            self.logger.warning(
                "blocks_per_dispatch=%d is more than one kernel launch "
                "takes at this shape: %d blocks per call "
                "(fxtpu_torch.ops.fx_fused.max_blocks_parts)",
                config.blocks_per_dispatch, self._dispatch_batch)

        # --- science data (effex.py:129-141) ------------------------------
        self.calibrated_delays = np.zeros(config.nchan, dtype=np.float64)
        self._delays_dev = None   # (host delays, packed device tensor)
        #: Rows for the writer: ``(seq, vis)``, the ring seq of the row's
        #: block (``(first, last)`` under integration_blocks > 1)
        self.vis_out: Queue = Queue()
        self.output_file = config.output_file
        self.kbd_queue: Queue = Queue(1)
        self.writer: Optional[products.VisibilityWriter] = None
        self.blocks_processed = 0
        #: Blocks taken from the rings, the calibration blocks included,
        #: and the ring seq of the last one: the stream position a
        #: snapshot keys the source's state on (seqs gap where the source
        #: dropped blocks, so the count alone is not a position).
        self._blocks_consumed = 0
        self._consumed_seq = -1

        # --- TEST mode sweep (effex.py:144-155) ---------------------------
        self.test_delay_sweep_step = config.test_delay_sweep_step
        self.test_delay_offset = config.test_delay_offset

        # --- long-integration state (SURVEY.md §5.4) ------------------------
        self._accumulator = None
        self._accumulated = 0
        self._row_first: Optional[int] = None   # seq of the row's 1st block
        self.snapshot_path = (config.snapshot_path
                              or self.output_file + ".state.npz")
        if config.resume_from:
            self._restore(config.resume_from)

    def _make_rings(self):
        cfg = self.config
        local = (cfg.num_samp if self.sample_span is None
                 else self.sample_span[1] - self.sample_span[0])
        # int8 ingest keeps the rings 8-bit: (I, Q) byte pairs
        if cfg.ingest_dtype == "int8":
            shape, dtype = (local, 2), np.int8
        else:
            shape, dtype = (local,), np.complex64
        require_native(cfg.device, "the Correlator's rings")
        self.bufs = [make_ring(cfg.buffer_chunks, shape, dtype=dtype)
                     for _ in range(cfg.nchan)]
        self.aligner = BlockAligner(self.bufs, metrics=self.metrics)

    # ------------------------------------------------------------------
    # Properties with validation + source pass-through (effex.py:231-320)
    # ------------------------------------------------------------------
    @property
    def feeder(self) -> Optional[Feeder]:
        """Primary feeder (None before streaming starts); one feeder per
        channel runs when the source can split (``self.feeders``)."""
        return self.feeders[0] if self.feeders else None

    @feeder.setter
    def feeder(self, value):
        self.feeders = [] if value is None else [value]

    @property
    def _feeding(self) -> bool:
        return any(f.alive for f in self.feeders)

    @property
    def state(self):
        """The current state in the correlator's internal state machine."""
        return self._state

    @state.setter
    def state(self, input_state):
        self.logger.debug("State transition: %s to %s", self._state,
                          input_state)
        if input_state not in self._states:
            self.close()
            raise ValueError(
                f"State {input_state} is not in known states: {self._states}")
        if input_state not in _ALLOWED[self._state]:
            self.close()
            raise StateTransitionError(self._state, input_state)
        self._state = input_state

    @property
    def run_time(self):
        return self._run_time

    @run_time.setter
    def run_time(self, value):
        if value < 1:
            self.close()
            raise ValueError(f"run time {value} is not allowed; "
                             "run times must be >= 1 second.")
        self._run_time = value

    @property
    def bandwidth(self):
        return self._bandwidth

    @bandwidth.setter
    def bandwidth(self, value):
        ceiling = getattr(self.source, "max_stable_bandwidth", None)
        if ceiling and value > ceiling:
            self.logger.warning(
                "Bandwidth value %s is greater than %s, and the source "
                "may not be stable.", value, ceiling)
        self._bandwidth = value
        self.source.sample_rate = value
        self._sync_engine(bandwidth=value)

    @property
    def frequency(self):
        return self._frequency

    @frequency.setter
    def frequency(self, value):
        self._frequency = value
        self.source.center_freq = value
        self._sync_engine(frequency=value)

    @property
    def num_samp(self):
        return self._num_samp

    @num_samp.setter
    def num_samp(self, value):
        value = int(round(value))
        if self.config.clamp_num_samp:
            value = min(max(value, MIN_NUM_SAMP), MAX_NUM_SAMP)
        self._num_samp = value
        self._sync_engine(num_samp=value)

    @property
    def nbins(self):
        return self._nbins

    @nbins.setter
    def nbins(self, value):
        self._nbins = value
        self._sync_engine(nbins=value)

    @property
    def gain(self):
        return self._gain

    @gain.setter
    def gain(self, value):
        self._gain = value
        self.source.gain = value

    @property
    def mode(self):
        return self._mode

    @mode.setter
    def mode(self, input_mode):
        input_mode = str(input_mode).upper()
        if input_mode not in self._modes:
            raise ValueError(
                f"Mode input {input_mode} is not in known modes: {self._modes}")
        self._mode = input_mode
        self._sync_engine(mode=input_mode)

    def _sync_engine(self, **changes):
        """Rebuild the compute engine after a compute-relevant property
        mutation, so a mutated correlator correlates at the new shape (the
        reference read these properties live in every ``_pfb_xcorr``
        call, ``effex.py:497-527``).  ``num_samp`` also resizes the rings,
        which is only legal before streaming starts."""
        if getattr(self, "engine", None) is None:
            return  # still inside __init__: engine not built yet
        if all(getattr(self.config, k) == v for k, v in changes.items()):
            return
        if "num_samp" in changes and self.feeder is not None:
            raise RuntimeError(
                "num_samp cannot change after streaming has started: the "
                "ring buffers are sized per block and owned by the feeder")
        if "nbins" in changes and self.stager is not None:
            raise RuntimeError(
                "nbins cannot change while the async stager is running: "
                "staged batches are framed by the OLD engine's "
                "prepare_batch and would reach the new step mis-framed")
        self.config = dataclasses.replace(self.config, **changes)
        self.engine = FxEngine(self.config, mesh=self.engine.mesh)
        self.history = self.engine.fresh_history()
        self._delays_dev = None
        self._accumulator = None
        self._accumulated = 0
        self.test_delay_sweep_step = self.config.test_delay_sweep_step
        self.test_delay_offset = self.config.test_delay_offset
        if "num_samp" in changes:
            if self.sample_span is not None:
                # the rings hold this process's span of each block: the
                # span of the new block length
                from fxtpu_torch.parallel.ingest import local_sample_span
                self.sample_span = local_sample_span(
                    self.engine.mesh, self.config.num_samp, self.config.nbins)
            self._make_rings()
        self.logger.debug("engine rebuilt after property mutation: %s",
                          changes)

    # ------------------------------------------------------------------
    # Supervision helpers (effex.py:158-180)
    # ------------------------------------------------------------------
    def _get_kbd(self, queue):
        while self.state in ("STARTUP", "RUN", "CALIBRATE"):
            queue.put(sys.stdin.read(1))

    def _child_threw_exception(self) -> bool:
        if not self.exc_queue.empty():
            exc_formatted = self.exc_queue.get_nowait()
            self.logger.error("Parent caught child exception:\n%s",
                              exc_formatted)
            return True
        return False

    def close(self):
        """Stop the stager and the feeders and release the source
        (``sdr.close()`` analog, ``effex.py:176-180``)."""
        stager = getattr(self, "stager", None)
        if stager is not None:
            stager.stop()
        for feeder in getattr(self, "feeders", []):
            feeder.stop()
        source = getattr(self, "source", None)
        if source is not None:
            source.close()
            self.logger.info("Source closed.")

    # ------------------------------------------------------------------
    # Main loop (effex.py:326-417)
    # ------------------------------------------------------------------
    def run_state_machine(self):
        """Run the machine to completion: OFF -> STARTUP -> (CALIBRATE <->
        RUN) -> SHUTDOWN -> done.  With ``profile_dir`` the run's trace is
        on (``self.metrics.trace``) and each span is a range of the
        profile too."""
        own_trace = bool(self.config.profile_dir) and not self.metrics.tracing
        with profiler_trace(self.config.profile_dir):
            if own_trace:
                self.metrics.start_trace(ranges=True)
            self._run_machine()
        if own_trace:
            self.metrics.stop_trace()
        self.metrics.mark_once("end")
        self.logger.info("%s", self.metrics.report())
        if self.engine.kernel_active:
            self.logger.info("kernel launches (%s FIR): %s",
                             self.engine.fir_mode,
                             self.engine.launch_counts())
        for c, buf in enumerate(self.bufs):
            if buf.drops:
                self.logger.warning("channel %d dropped %d blocks", c,
                                    buf.drops)

    def _run_machine(self):
        warned_full = [False] * self.config.nchan
        drain = StreamDrainTracker()
        while True:
            # user input: 'c' requests recalibration (effex.py:332-336)
            if not self.kbd_queue.empty():
                kbd_in = self.kbd_queue.get_nowait()
                if kbd_in == "c":
                    self.logger.info("Calibration requested.")
                    self.state = "CALIBRATE"

            # buffer-full warnings with drop accounting (effex.py:338-342)
            for c, buf in enumerate(self.bufs):
                if buf.full() and not warned_full[c]:
                    self.logger.warning(
                        "Channel %d ring buffer filled up. "
                        "Data may have been lost! (drops so far: %d)",
                        c, buf.drops)
                    warned_full[c] = True
                elif not buf.full():
                    warned_full[c] = False

            if self._child_threw_exception():
                self.logger.debug("Shutting down: child threw exception.")
                self.state = "SHUTDOWN"

            if self.state == "OFF":
                self.state = "STARTUP"
            elif self.state == "STARTUP":
                self._startup_task()
                # fxtpu's condition: a resumed run calibrates too when
                # calibrate_on_start is set (it then keeps the snapshot's
                # delays only with calibrate_on_start=False)
                if self.config.calibrate_on_start:
                    self.state = "CALIBRATE"
                else:
                    self.state = "RUN"
                    self._maybe_start_stager()
            elif self.state in ("CALIBRATE", "RUN"):
                if time.time() < self.start_time:
                    continue
                if self.stager is not None:
                    if not self._staged_iteration():
                        break
                    continue
                block = self.aligner.get(timeout=1.0)
                if block is None:
                    if not drain.miss(self._feeding, self.bufs):
                        self.logger.debug("Buffers empty, waiting")
                        continue
                    # Feeder done and buffers drained: wait for the output
                    # drain, then shut down (effex.py:375-385).
                    if self.vis_out.empty():
                        self.logger.info(
                            "IQ processing complete, buffers drained. "
                            "Shutting down.")
                        self.state = "SHUTDOWN"
                    else:
                        self.logger.debug(
                            "Time up, waiting for output buffer to drain.")
                        time.sleep(0.05)
                    continue

                drain.got_block()
                seq = self.aligner.last_seq
                self._blocks_consumed += 1
                self._consumed_seq = seq
                self.metrics.count("samples_in",
                                   self.config.nchan * self.num_samp, seq)
                if self.state == "CALIBRATE":
                    with self.metrics.stage("correlator.h2d", seq):
                        iq = self.engine.prepare_block(block)
                    with self.metrics.stage("correlator.calibrate", seq):
                        self._calibrate_task(iq)
                    self.state = "RUN"
                    self._maybe_start_stager()
                else:
                    self._run_block(block, seq)
                    self.metrics.mark_once("steady")
                    self._maybe_snapshot()
            elif self.state == "SHUTDOWN":
                self.close()
                break
        if self.writer is not None:
            self.writer.join(timeout=5.0)

    # ------------------------------------------------------------------
    # Tasks (effex.py:420-494)
    # ------------------------------------------------------------------
    def _startup_task(self):
        """Write the CSV header and start feeder/writer/keyboard threads
        (``effex.py:420-474``).  In a multi-process run only process 0
        writes products; every process feeds its own sample span and runs
        the same collectives in step."""
        if self._is_primary:
            products.write_metadata(self.output_file, self.config)

        self.start_time = time.time() + self.config.startup_duration
        self.logger.info(
            "Cross-correlation will begin at %s",
            time.strftime("%a, %d %b %Y %H:%M:%S",
                          time.localtime(self.start_time)))

        # One feeder per channel whenever the source can split (each pairs
        # a 1-channel source with its own ring: the zero-copy producer's
        # condition); otherwise one multi-channel feeder.
        splits = (self.source.split_channels()
                  if self.config.channel_feeders and self.sample_span is None
                  else None)
        if splits is not None:
            self.feeders = [
                Feeder(src, [buf], self.num_samp,
                       start_time=self.start_time, run_time=self.run_time,
                       exc_queue=self.exc_queue,
                       metrics=self.metrics).start()
                for src, buf in zip(splits, self.bufs)]
            self.logger.debug("Started %d per-channel feeder threads.",
                              len(self.feeders))
        else:
            self.feeder = Feeder(self.source, self.bufs, self.num_samp,
                                 start_time=self.start_time,
                                 run_time=self.run_time,
                                 exc_queue=self.exc_queue,
                                 sample_span=self.sample_span,
                                 metrics=self.metrics).start()
            self.logger.debug("Started feeder thread.")

        if self._is_primary:
            self.writer = products.VisibilityWriter(
                self.output_file, self.vis_out,
                active_fn=lambda: self.state in ("STARTUP", "RUN",
                                                 "CALIBRATE"),
                metrics=self.metrics,
            ).start()
            self.logger.debug("Started output buffering thread.")

        if self.config.keyboard_control and sys.stdin.isatty():
            threading.Thread(target=self._get_kbd, args=(self.kbd_queue,),
                             daemon=True).start()
            print(LINESEP)
            print("Listening for user input. Input a character & return:")
            print(LINESEP)
            print("c : request delay recalibration")
            print(LINESEP)

    def _calibrate_task(self, iq: torch.Tensor):
        """Estimate per-channel delays from the current block
        (``effex.py:476-487``) over its leading ``calibrate_samples``.
        Assumes a flat-PSD noise-like input."""
        self.logger.debug("Starting calibration")
        ncal = min(self.config.calibrate_samples, self.num_samp)
        delays = self.engine.calibrate_block(iq, ncal).cpu().numpy()
        delays = delays.astype(np.float64)
        if self.mode == "TEST":
            delays[1:] -= self.test_delay_offset  # effex.py:578-579
        self.calibrated_delays = delays
        self.logger.info("Estimated delay (us): %s",
                         1e6 * self.calibrated_delays[1:])

    def _device_delays(self, host: Optional[np.ndarray] = None
                       ) -> torch.Tensor:
        """Delays (the calibrated ones, or ``host`` ``[K, nch]`` of a
        K-block call) in the packed ``(delay, frac(fc*d))`` form on the
        device: the carrier cycles are reduced in float64 on the host
        (``pack_delays``), and the copy is made again only when the delays
        changed (every block in TEST mode, else only at calibration)."""
        if host is None:
            host = self.calibrated_delays
        if self._delays_dev is None or not np.array_equal(
                self._delays_dev[0], host):
            packed = pack_delays(host, self.frequency)
            self._delays_dev = (host.copy(), torch.as_tensor(
                packed, device=self.engine.device))
        return self._delays_dev[1]

    def _run_task(self, iq: torch.Tensor) -> torch.Tensor:
        """One F+X step on the device; returns the visibility, still on
        the device (the writer thread forces the transfer)."""
        vis, self.history = self.engine.step(iq, self._device_delays(),
                                             self.history)
        if len(self.engine.pairs) == 1:
            # reference parity: one row per block, only with exactly one
            # baseline (autos come first in baseline_pairs)
            vis = vis[0]
        return vis

    @property
    def _dispatch_batch(self) -> int:
        """Blocks per device call (``FxEngine.dispatch_batch_for``)."""
        return self.engine.dispatch_batch_for(
            self.config.blocks_per_dispatch)

    def _run_block(self, block, seq: int):
        """Correlate one aligned host block, ring seq ``seq``, on the
        unstaged path (K-block calls run only on the stager's batches,
        :meth:`_staged_iteration`)."""
        if self.mode == "TEST":
            # artificial delay sweep (effex.py:403-404)
            self.calibrated_delays[1:] += self.test_delay_sweep_step
        with self.metrics.stage("correlator.h2d", seq):
            iq = self.engine.prepare_block(block)
        with self.metrics.stage("correlator.fx_step", seq):
            self._emit(self._run_task(iq), seq)

    def _dispatch_multi(self, iq: torch.Tensor, seqs: tuple):
        """One K-block call on a prepared batch of the blocks ``seqs``,
        with per-block delays: TEST mode advances the sweep one step per
        block inside the call."""
        k = len(seqs)
        delays_k = np.repeat(self.calibrated_delays[None], k, axis=0)
        if self.mode == "TEST":
            steps = np.arange(1, k + 1) * self.test_delay_sweep_step
            delays_k[:, 1:] += steps[:, None]
            self.calibrated_delays[1:] += k * self.test_delay_sweep_step
        vis, self.history = self.engine.multi_step(
            iq, self._device_delays(delays_k), self.history)
        for i in range(k):
            v = vis[i]
            if len(self.engine.pairs) == 1:
                v = v[0]  # single-baseline squeeze (see _run_task)
            self._emit(v, seqs[i])

    # ------------------------------------------------------------------
    # Staged ingest (runtime/stager.py): overlaps the host's gather, the
    # staging and the copy with the device's work; active when
    # blocks_per_dispatch > 1.
    # ------------------------------------------------------------------
    def _maybe_start_stager(self):
        if self.stager is not None or self._dispatch_batch <= 1:
            return
        self.stager = DeviceStager(
            self.aligner, self.engine.prepare_block,
            batch=self._dispatch_batch, exc_queue=self.exc_queue,
            feeding=lambda: self._feeding,
            prepare_batch=self.engine.prepare_batch,
            host_buffer=self.engine.batch_host_buffer,
            device=self.engine.device, metrics=self.metrics).start()
        self.logger.debug("Started device stager (batch=%d).",
                          self._dispatch_batch)

    def _staged_iteration(self) -> bool:
        """One main-loop iteration on the staged path.  Returns False when
        the machine should stop (SHUTDOWN handled here)."""
        batch = self.stager.get(timeout=0.1)
        if batch is None:
            if not self.stager.done:
                return True  # nothing staged yet
            if self.vis_out.empty():
                self.logger.info(
                    "IQ processing complete, buffers drained. Shutting down.")
                self.state = "SHUTDOWN"
                self.close()
                return False
            time.sleep(0.05)
            return True

        seqs = batch.seqs
        call_seq = seqs[0] if len(seqs) == 1 else (seqs[0], seqs[-1])
        self._blocks_consumed += batch.k
        self._consumed_seq = batch.last_seq
        self.metrics.count("samples_in",
                           batch.k * self.config.nchan * self.num_samp,
                           call_seq)
        iq = batch.take()
        if self.state == "CALIBRATE":
            # Mid-run recalibration ('c'): estimate from the first staged
            # block, then correlate the whole batch with the fresh delays
            # (no samples are dropped: the cal block is correlated too).
            with self.metrics.stage("correlator.calibrate", seqs[0]):
                self._calibrate_task(self._first_staged_block(batch))
            self.state = "RUN"
        with self.metrics.stage("correlator.fx_step", call_seq):
            if batch.stacked:
                self._dispatch_multi(iq, seqs)
            else:
                if self.mode == "TEST":
                    self.calibrated_delays[1:] += self.test_delay_sweep_step
                self._emit(self._run_task(iq), seqs[0])
        self.metrics.mark_once("steady")
        self._maybe_snapshot()
        return True

    def _first_staged_block(self, batch) -> torch.Tensor:
        """Block 0 of a staged batch in single-block input form: the
        second axis of the fused route's merged layout, the first of the
        plain route's stack; on a mesh the fused route's block 0 is whole
        on shard 0, the plain route's spread over every shard."""
        if not batch.stacked:
            return batch.iq
        if isinstance(batch.iq, dict):
            if self.engine.batch_merged:
                return batch.iq[0][:, 0]
            return {i: x[0] for i, x in batch.iq.items()}
        if self.engine.batch_merged:
            return batch.iq[:, 0]
        return batch.iq[0]

    def _emit(self, vis, seq: int):
        self.blocks_processed += 1
        self.metrics.count("blocks", 1, seq)
        if self._integrate(vis, seq):
            self.metrics.count("spectra_out", 1, seq)

    # ------------------------------------------------------------------
    # Long integration (SURVEY.md §5.4)
    # ------------------------------------------------------------------
    def _integrate(self, vis, seq: int) -> bool:
        """Accumulate ``integration_blocks`` block visibilities per output
        row (default 1 = reference parity: every block is written); block
        ``seq`` is the row's last.  Returns True when a row was emitted."""
        m = self.config.integration_blocks
        if m <= 1:
            self._queue_row(seq, vis)
            return True
        if self._accumulator is None:
            self._row_first = seq
        self._accumulator = (vis if self._accumulator is None
                             else self._accumulator + vis)
        self._accumulated += 1
        if self._accumulated >= m:
            # a row resumed from a snapshot began before this run: its
            # first block's seq is unknown (None)
            self._queue_row((self._row_first, seq), self._accumulator / m)
            self._accumulator = None
            self._accumulated = 0
            self._row_first = None
            return True
        return False

    def _queue_row(self, seq, vis):
        """Hand the writer row ``(seq, vis)``; the gauge
        ``products.queued`` reads the writer's backlog with this row: the
        depth the row joins, itself counted, read before the put (after
        it, a writer woken by the put may already have taken the row)."""
        if self._is_primary:
            self.metrics.hand_off("products.queue", seq)
            depth = self.vis_out.qsize() + 1
            self.vis_out.put((seq, vis))
            self.metrics.gauge("products.queued", depth, seq)

    # ------------------------------------------------------------------
    # Snapshots (SURVEY.md §5.4): fxtpu's format, runtime/checkpoint.py
    # ------------------------------------------------------------------
    def _maybe_snapshot(self):
        if (self.config.snapshot_every and
                self.blocks_processed % self.config.snapshot_every == 0):
            with self.metrics.stage("correlator.snapshot",
                                    self._consumed_seq):
                self.snapshot()

    def snapshot(self, path: Optional[str] = None) -> str:
        """Write a resumable snapshot (history, delays, accumulator, block
        counters and the source's stream state) to ``path`` (default
        :attr:`snapshot_path`); returns the path."""
        path = path or self.snapshot_path
        meta = {"blocks_consumed": np.int64(self._blocks_consumed)}
        # The feeder reads ahead of the consumer, so the source's current
        # state is past what was correlated: take the feeder's logged state
        # at the last correlated block's seq + 1.  The source's own state
        # is right only before the feeder starts.
        if self.feeder is not None:
            src_state = self.feeder.source_state_at(self._consumed_seq + 1)
        else:
            src_state = self.source.snapshot_state()
        if src_state is not None:
            meta["source_state"] = json.dumps(src_state)
        checkpoint.save_state(
            path, history=self.history, delays=self.calibrated_delays,
            blocks_processed=self.blocks_processed,
            accumulator=self._accumulator, accumulated=self._accumulated,
            meta=meta)
        self.logger.debug("state snapshot -> %s", path)
        return path

    def _restore(self, path: str):
        """Restore a snapshot (this package's or ``fxtpu``'s) before the
        run: the history in this engine's form on its device, the delays,
        the counters, the accumulator and the source's stream state.
        Raises FileNotFoundError for a missing file and ValueError where
        the source cannot be put back at the snapshot's position."""
        state = checkpoint.load_state(path)
        self.history = self.engine.restore_history(state["history"])
        self.calibrated_delays = np.asarray(state["delays"], np.float64)
        self.blocks_processed = state["blocks_processed"]
        acc = state["accumulator"]
        self._accumulator = (None if acc is None else
                             torch.from_numpy(acc).to(self.engine.device))
        self._accumulated = state["accumulated"]
        self._blocks_consumed = int(state["meta"].get(
            "blocks_consumed", self.blocks_processed))
        src_state = state["meta"].get("source_state")
        if src_state is not None:
            # the generator's or cursor's exact state (replay position,
            # synthetic RNG, sinusoid phase), through the Source protocol
            self.source.restore_state(json.loads(str(src_state)))
        elif hasattr(self.source, "_pos"):
            # a snapshot from before the source state was kept, of a
            # seekable replay: seek by the consumed blocks
            self.source._pos = self._blocks_consumed * self.num_samp
        else:
            # correlating other samples against the snapshot's tap history
            # would be silently wrong: live sources cannot reproduce their
            # stream, and such a snapshot of a synthetic source carries no
            # generator state
            raise ValueError(
                f"cannot resume from {path}: no source stream state in "
                f"the snapshot and {type(self.source).__name__} is not "
                "seekable (snapshot/resume requires a replay or "
                "synthetic source; live streams cannot be reproduced)")
        self.logger.info("resumed from %s at block %d", path,
                         self.blocks_processed)
