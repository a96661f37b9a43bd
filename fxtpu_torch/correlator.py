"""The Correlator: state machine, orchestration, and the host hot loop.

Counterpart of ``fxtpu.correlator`` for one device.  Behavioural
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
transition.  Options of ``fxtpu`` that are not ported yet raise
``NotImplementedError`` naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import dataclasses
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
from fxtpu_torch.runtime.feeder import BlockAligner, Feeder, StreamDrainTracker
from fxtpu_torch.runtime.metrics import Metrics, profiler_trace
from fxtpu_torch.runtime.native import make_ring
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


def reject_unported(cfg: CorrelatorConfig):
    """Raise NotImplementedError for the options of ``fxtpu`` this port
    does not carry yet, naming the ROADMAP.md item that ports each."""
    checks = [
        (cfg.mesh_time * cfg.mesh_freq > 1,
         f"a device mesh (mesh_time={cfg.mesh_time}, mesh_freq="
         f"{cfg.mesh_freq})", "A.9, scale-out"),
        (bool(cfg.snapshot_every), f"snapshot_every={cfg.snapshot_every}",
         "A.8, checkpoint/resume"),
        (bool(cfg.resume_from), f"resume_from={cfg.resume_from!r}",
         "A.8, checkpoint/resume"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to fxtpu_torch yet (ROADMAP.md "
                f"{item})")


class Correlator:
    """N-channel streaming FX correlator on one torch device.

    Accepts either a :class:`~fxtpu_torch.config.CorrelatorConfig` or the
    reference's keyword arguments (``effex.py:45-53``)."""

    _states = STATES
    _modes = MODES
    StateTransitionError = StateTransitionError  # reference exposes it nested

    def __init__(self, config: Optional[CorrelatorConfig] = None,
                 source: Optional[Source] = None, **kwargs):
        if config is None:
            config = CorrelatorConfig(**kwargs)
        elif kwargs:
            config = dataclasses.replace(config, **kwargs)
        reject_unported(config)
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

        # --- host buffering (effex.py:105-110): native C++ ring when the
        # shared library is built, Python fallback otherwise -------------
        self._make_rings()
        self.feeders: list = []

        # --- compute engine (F+X, device side) ---------------------------
        self.engine = FxEngine(config)
        self.history = self.engine.fresh_history()
        self.stager: Optional[DeviceStager] = None
        if self._dispatch_batch < config.blocks_per_dispatch:
            self.logger.warning(
                "blocks_per_dispatch=%d is more than one kernel launch "
                "takes at this shape: %d blocks per call "
                "(fxtpu_torch.ops.fx_fused.max_blocks)",
                config.blocks_per_dispatch, self._dispatch_batch)

        # --- science data (effex.py:129-141) ------------------------------
        self.calibrated_delays = np.zeros(config.nchan, dtype=np.float64)
        self._delays_dev = None   # (host delays, packed device tensor)
        self.vis_out: Queue = Queue()
        self.output_file = config.output_file
        self.kbd_queue: Queue = Queue(1)
        self.writer: Optional[products.VisibilityWriter] = None
        self.blocks_processed = 0

        # --- TEST mode sweep (effex.py:144-155) ---------------------------
        self.test_delay_sweep_step = config.test_delay_sweep_step
        self.test_delay_offset = config.test_delay_offset

        # --- metrics + long-integration state (SURVEY.md §5.1/§5.4) --------
        self.metrics = Metrics()
        self._accumulator = None
        self._accumulated = 0

    def _make_rings(self):
        cfg = self.config
        # int8 ingest keeps the rings 8-bit: (I, Q) byte pairs
        if cfg.ingest_dtype == "int8":
            shape, dtype = (cfg.num_samp, 2), np.int8
        else:
            shape, dtype = (cfg.num_samp,), np.complex64
        self.bufs = [make_ring(cfg.buffer_chunks, shape, dtype=dtype)
                     for _ in range(cfg.nchan)]
        self.aligner = BlockAligner(self.bufs)

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
        self.config = dataclasses.replace(self.config, **changes)
        self.engine = FxEngine(self.config)
        self.history = self.engine.fresh_history()
        self._delays_dev = None
        self._accumulator = None
        self._accumulated = 0
        self.test_delay_sweep_step = self.config.test_delay_sweep_step
        self.test_delay_offset = self.config.test_delay_offset
        if "num_samp" in changes:
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
        RUN) -> SHUTDOWN -> done."""
        with profiler_trace(self.config.profile_dir):
            self._run_machine()
        self.metrics.mark_once("end")
        self.logger.info("%s", self.metrics.report())
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
                self.metrics.count("samples_in",
                                   self.config.nchan * self.num_samp)
                if self.state == "CALIBRATE":
                    with self.metrics.stage("h2d"):
                        iq = self.engine.prepare_block(block)
                    with self.metrics.stage("calibrate"):
                        self._calibrate_task(iq)
                    self.state = "RUN"
                    self._maybe_start_stager()
                else:
                    self._run_block(block)
                    self.metrics.mark_once("steady")
            elif self.state == "SHUTDOWN":
                self.close()
                break

            self.logger.debug("ring buffer sizes: %s; vis_out: %d",
                              [b.qsize() for b in self.bufs],
                              self.vis_out.qsize())
        if self.writer is not None:
            self.writer.join(timeout=5.0)

    # ------------------------------------------------------------------
    # Tasks (effex.py:420-494)
    # ------------------------------------------------------------------
    def _startup_task(self):
        """Write the CSV header and start feeder/writer/keyboard threads
        (``effex.py:420-474``)."""
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
                  if self.config.channel_feeders else None)
        if splits is not None:
            self.feeders = [
                Feeder(src, [buf], self.num_samp,
                       start_time=self.start_time, run_time=self.run_time,
                       exc_queue=self.exc_queue).start()
                for src, buf in zip(splits, self.bufs)]
            self.logger.debug("Started %d per-channel feeder threads.",
                              len(self.feeders))
        else:
            self.feeder = Feeder(self.source, self.bufs, self.num_samp,
                                 start_time=self.start_time,
                                 run_time=self.run_time,
                                 exc_queue=self.exc_queue).start()
            self.logger.debug("Started feeder thread.")

        self.writer = products.VisibilityWriter(
            self.output_file, self.vis_out,
            active_fn=lambda: self.state in ("STARTUP", "RUN", "CALIBRATE"),
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

    def _run_block(self, block):
        """Correlate one aligned host block on the unstaged path (K-block
        calls run only on the stager's batches, :meth:`_staged_iteration`)."""
        if self.mode == "TEST":
            # artificial delay sweep (effex.py:403-404)
            self.calibrated_delays[1:] += self.test_delay_sweep_step
        with self.metrics.stage("h2d"):
            iq = self.engine.prepare_block(block)
        with self.metrics.stage("fx_step"):
            self._emit(self._run_task(iq))

    def _dispatch_multi(self, iq: torch.Tensor, k: int):
        """One K-block call on a prepared batch, with per-block delays:
        TEST mode advances the sweep one step per block inside the call."""
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
            self._emit(v)

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

        self.metrics.count("samples_in",
                           batch.k * self.config.nchan * self.num_samp)
        iq = batch.take()
        if self.state == "CALIBRATE":
            # Mid-run recalibration ('c'): estimate from the first staged
            # block, then correlate the whole batch with the fresh delays
            # (no samples are dropped: the cal block is correlated too).
            with self.metrics.stage("calibrate"):
                self._calibrate_task(self._first_staged_block(batch))
            self.state = "RUN"
        with self.metrics.stage("fx_step"):
            if batch.stacked:
                self._dispatch_multi(iq, batch.k)
            else:
                if self.mode == "TEST":
                    self.calibrated_delays[1:] += self.test_delay_sweep_step
                self._emit(self._run_task(iq))
        self.metrics.mark_once("steady")
        return True

    def _first_staged_block(self, batch) -> torch.Tensor:
        """Block 0 of a staged batch in single-block input form: the
        second axis of the fused route's merged layout, the first of the
        plain route's stack."""
        if not batch.stacked:
            return batch.iq
        if self.engine.batch_merged:
            return batch.iq[:, 0]
        return batch.iq[0]

    def _emit(self, vis):
        self.blocks_processed += 1
        self.metrics.count("blocks")
        if self._integrate(vis):
            self.metrics.count("spectra_out")

    # ------------------------------------------------------------------
    # Long integration (SURVEY.md §5.4)
    # ------------------------------------------------------------------
    def _integrate(self, vis) -> bool:
        """Accumulate ``integration_blocks`` block visibilities per output
        row (default 1 = reference parity: every block is written).
        Returns True when a row was emitted."""
        m = self.config.integration_blocks
        if m <= 1:
            self.vis_out.put(vis)
            return True
        self._accumulator = (vis if self._accumulator is None
                             else self._accumulator + vis)
        self._accumulated += 1
        if self._accumulated >= m:
            self.vis_out.put(self._accumulator / m)
            self._accumulator = None
            self._accumulated = 0
            return True
        return False
