"""Drives the Correlator as ``cli.main`` builds it, over a source the
driver hands it, and measures it from the product CSV users read.

The program is ``Correlator(config, source=...)`` and its
``run_state_machine``, run on a thread of the harness.  A
:class:`~fxbench.follower.RowFollower` stamps each row as the writer
flushes it; the window opens at the first data row (the first correlated
block's) and lasts ``--seconds``.  Blocks reach rows in the order the
source delivered them, the first delivered block calibrating and writing
none.  The run ends soon after the window: it never waits on the writer's
backlog, which has no bound.  With ``--trace 1`` the harness's spans wrap
``BlockAligner.get`` and ``products.append_visibility``, and a CUDA-only
profile covers the window."""

from __future__ import annotations

import gc
import queue
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fxbench.cells import Cell, Record
from fxbench.devtrace import DeviceTrace
from fxbench.follower import RowFollower
from fxbench.reference import calibrate as ref_cal
from fxbench.reference import fx as ref_fx
from fxbench.reference import judge
from fxbench.reference.rows import read_rows
from fxbench.spans import SpanRecorder

__all__ = ["RUN_TIME", "correlator_config", "sync", "release", "warm",
           "CorrelatorRun", "check_rows", "sample_rows", "note"]

#: The Correlator's ``run_time``: longer than any run, which the harness
#: ends itself.
RUN_TIME = 86400.0
#: Longest wait for the first data row after the Correlator starts.
FIRST_ROW_TIMEOUT = 300.0
#: Longest wait for the program to stop once the harness asked it to.
STOP_TIMEOUT = 120.0


def correlator_config(cell: Cell, *, output_file: str, device: str,
                      **fields):
    """The cell's CorrelatorConfig (configuration, then the mix's fields,
    then ``fields``), writing to ``output_file`` on ``device``."""
    from fxtpu_torch.config import CorrelatorConfig
    merged = {**cell.correlator_fields(), **fields}
    return CorrelatorConfig(**merged, run_time=RUN_TIME,
                            output_file=output_file, device=device,
                            keyboard_control=False)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release(device):
    """Free what the program left once its objects are gone, so that the
    reference that follows runs in the memory the window used."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def warm(cfg):
    """One K-block call where the Correlator makes them, one step and one
    calibration on a throwaway engine of ``cfg``, with the layouts and
    packed delays the Correlator hands them: every kernel the run launches
    is loaded, and every shape planned, before the window."""
    from fxtpu_torch.fx import FxEngine
    eng = FxEngine(cfg)
    k = eng.dispatch_batch_for(cfg.blocks_per_dispatch)
    if cfg.ingest_dtype == "int8":
        blk = np.zeros((cfg.nchan, cfg.num_samp, 2), np.int8)
    else:
        blk = np.zeros((cfg.nchan, cfg.num_samp), np.complex64)
    hist = eng.fresh_history()
    if k > 1:
        eng.multi_step(eng.prepare_batch([blk] * k),
                       torch.zeros((k, cfg.nchan, 2), device=eng.device),
                       hist)
    eng.step(eng.prepare_block(blk),
             torch.zeros((cfg.nchan, 2), device=eng.device), hist)
    eng.calibrate_block(eng.prepare_block(blk),
                        min(cfg.calibrate_samples, cfg.num_samp))
    sync(eng.device)


class CorrelatorRun:
    """One Correlator on its thread, the CSV follower, and in a traced run
    the spans and the device trace."""

    def __init__(self, cfg, source, *, trace: bool, tmpdir: str,
                 row_poll: float):
        from fxtpu_torch import products
        from fxtpu_torch.correlator import Correlator
        from fxtpu_torch.runtime import feeder
        self.cfg = cfg
        nbl = cfg.nchan * (cfg.nchan - 1) // 2 + (
            cfg.nchan if cfg.include_autos else 0)
        self.spectrum = cfg.mode == "SPECTRUM"
        #: CSV lines a block writes: a spectrum a baseline, or one line of
        #: a value a baseline in CONTINUUM
        self.lines_per_block = nbl if self.spectrum else 1
        self.spans: Optional[SpanRecorder] = None
        self.device_trace: Optional[DeviceTrace] = None
        if trace:
            self.spans = SpanRecorder()
            self.spans.wrap(feeder.BlockAligner, "get",
                            "runtime.BlockAligner.get", skip_none=True)
            self.spans.wrap(products, "append_visibility",
                            "products.append_visibility")
            if torch.device(cfg.device).type == "cuda":
                self.device_trace = DeviceTrace(tmpdir)
        self.cor = Correlator(config=cfg, source=source)
        self.follower = RowFollower(cfg.output_file,
                                    2 if self.spectrum else 1, row_poll)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._main,
                                        name="fxbench-correlator",
                                        daemon=True)

    def _main(self):
        try:
            self.cor.run_state_machine()
        except BaseException as exc:
            self._error = exc

    def start(self) -> "CorrelatorRun":
        self.follower.start()
        if self.device_trace is not None:
            self.device_trace.start()
        self._thread.start()
        return self

    def wait_first_row(self) -> float:
        """The time the first correlated block's row appeared."""
        t = self.follower.wait_rows(self.lines_per_block, FIRST_ROW_TIMEOUT)
        if t is None:
            self._raise_if_failed()
            raise RuntimeError("no product row within "
                               f"{FIRST_ROW_TIMEOUT:.0f} s of the start")
        return t

    def _raise_if_failed(self):
        if self._error is not None:
            raise RuntimeError("the Correlator failed") from self._error

    def sleep_until(self, t: float):
        """Wait until host time ``t``, raising if the Correlator fails."""
        while time.perf_counter() < t:
            if not self._thread.is_alive():
                self._raise_if_failed()
                raise RuntimeError("the Correlator stopped inside the window")
            time.sleep(min(0.05, max(t - time.perf_counter(), 0.0)))

    def stop(self, *, wait: float = 0.0) -> float:
        """End the run: wait up to ``wait`` seconds for the source to end
        it, then stop the feeders and the stager (``Correlator.close``)
        and discard the rows still queued for the writer.  Then stop the
        profile, the follower and the spans.  Returns the host time at
        which the program had stopped."""
        self._thread.join(timeout=wait)
        if self._thread.is_alive():
            self.cor.close()
        deadline = time.perf_counter() + STOP_TIMEOUT
        while self._thread.is_alive() and time.perf_counter() < deadline:
            try:
                while True:
                    self.cor.vis_out.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.01)
        stopped = time.perf_counter()
        if self._thread.is_alive():
            raise RuntimeError(f"the Correlator did not stop within "
                               f"{STOP_TIMEOUT:.0f} s")
        if self.cor.writer is not None:
            self.cor.writer.join(timeout=STOP_TIMEOUT)
        if self.device_trace is not None:
            sync(self.cor.engine.device)
            self.device_trace.stop()
        self.follower.stop()
        if self.spans is not None:
            self.spans.restore()
        self._raise_if_failed()
        drops = [b.drops for b in self.cor.bufs]
        if any(drops) or self.cor.aligner.realigned:
            raise RuntimeError(f"rings dropped {drops} blocks and the "
                               f"aligner realigned "
                               f"{self.cor.aligner.realigned}: rows no "
                               "longer follow the source's order")
        return stopped

    def block_rows(self) -> List[tuple]:
        """(start byte, end byte, time) of each block's rows, the time
        that of its last line."""
        rows, n = self.follower.rows, self.lines_per_block
        return [(rows[i * n][0], rows[i * n + n - 1][1], rows[i * n + n - 1][2])
                for i in range(len(rows) // n)]

    def record(self, lo: float, hi: float, counters: dict) -> Record:
        """The per-layer readers' material over the window ``[lo, hi]``."""
        spans: Dict[str, list] = {}
        if self.spans is not None:
            spans = {name: self.spans.between(name, lo, hi)
                     for name in self.spans.spans}
        trace = None
        if self.device_trace is not None:
            trace = self.device_trace.read(
                lo, hi, self.spans.spans if self.spans else {})
        return Record(spans=spans, counters=counters, trace=trace)


def check_rows(*, cfg, path: str, block_spans: Sequence[tuple],
               sample: Sequence[int], delivered: Callable[[int], int],
               block: Callable[[int], np.ndarray], delays: np.ndarray,
               device, control: bool) -> tuple:
    """The numbers that decide ``correct`` for a Correlator cell.

    ``delays``: the program's calibrated delays; ``delivered(i)``: the
    recording index of the i-th block the source delivered (block 0
    calibrates, block r+1 writes row r); ``block(j)``: recording block j
    as ``[nch, num_samp]`` complex64; ``sample``: the row numbers
    compared, with their byte spans in ``block_spans``.

    ``delay_gap_samples``: the program's delays against the reference's
    calibration of the same block.  ``row_gap``: each sampled row against
    the reference's visibilities of its block, with the history of the
    block before it, rotated by the program's delays (the reference
    follows the program from its calibrated state, which the first number
    judges by itself).  Returns (program readings, control readings or
    None); the control is the reference in bfloat16 put in the program's
    place, judged the same way."""
    dev = torch.device(device)
    w2d = ref_fx.prototype(cfg.ntaps, cfg.nbins, cfg.window)
    pairs = ref_fx.baselines(cfg.nchan, cfg.include_autos)
    ncal = min(cfg.calibrate_samples, cfg.num_samp)

    def dev_block(j):
        return torch.from_numpy(np.ascontiguousarray(block(j))).to(dev)

    cal_block = dev_block(delivered(0))
    want_delays = ref_cal.estimate_delays(cal_block, cfg.bandwidth, ncal)
    readings = {"delay_gap_samples": judge.delay_gap_samples(
        delays, want_delays, cfg.bandwidth)}
    ctl = None
    if control:
        ctl_delays = ref_cal.estimate_delays(cal_block, cfg.bandwidth, ncal,
                                             ref_fx.bf16)
        ctl = {"delay_gap_samples": judge.delay_gap_samples(
            ctl_delays, want_delays, cfg.bandwidth)}
    del cal_block
    got_rows = read_rows(path, [block_spans[r][:2] for r in sample])
    gaps, ctl_gaps = [], []
    for r, got in zip(sample, got_rows):
        cur = dev_block(delivered(r + 1))
        prev = dev_block(delivered(r)) if r >= 1 else None
        args = (w2d, pairs)
        kw = dict(bandwidth=cfg.bandwidth, frequency=cfg.frequency)
        gaps.append(_row_gap(cfg, got, ref_fx.fx_block(
            cur, prev, *args, delays=delays, **kw)))
        if control:
            want = ref_fx.fx_block(cur, prev, *args, delays=ctl_delays, **kw)
            out = ref_fx.fx_block(cur, prev, *args, delays=ctl_delays,
                                  rnd=ref_fx.bf16, **kw)
            if cfg.mode != "SPECTRUM":
                out = ref_fx.continuum(out, cfg.bandwidth, ref_fx.bf16)
            ctl_gaps.append(_row_gap(cfg, out.cpu().numpy(), want))
        del cur, prev
    readings["row_gap"] = max(gaps) if gaps else float("inf")
    if control:
        ctl["row_gap"] = max(ctl_gaps) if ctl_gaps else float("inf")
    return readings, ctl


def _row_gap(cfg, got, want_spectrum: torch.Tensor) -> float:
    """A row (or, from the control, its values) against the reference
    spectrum of its block."""
    want = want_spectrum.cpu().numpy()
    if cfg.mode == "SPECTRUM":
        return judge.spectrum_gap(np.reshape(got, want.shape), want)
    return judge.continuum_gap(
        np.reshape(got, -1), want.mean(axis=-1) / cfg.bandwidth,
        np.abs(want).mean(axis=-1) / cfg.bandwidth)


def sample_rows(n: int, count: int, seed: int) -> List[int]:
    """``count`` of rows ``0 .. n-1`` drawn from ``seed`` (all when fewer),
    in order."""
    rng = np.random.default_rng(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    if n <= count:
        return list(range(n))
    return sorted(int(i) for i in rng.choice(n, size=count, replace=False))


def note(msg: str):
    print(f"fxbench: {msg}", file=sys.stderr, flush=True)
