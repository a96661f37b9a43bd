"""A live observation, open loop, at the pace the mix fixes.

The source is the harness's own (:class:`PacedSource`): the receivers
deliver block i when its last sample has arrived, ``(i + 1) /
blocks_per_s`` seconds after the stream starts, whatever the program
does; like the radio plugin (``sources/rtlsdr.py``) it is ``realtime``
and holds the newest ``radio_queue`` blocks, so a block the feeder is too
late for is lost.  The pace is the offered load; nothing the program
computes depends on it (the configuration's ``bandwidth`` still sets the
rotation and the calibration's rate).  Its samples loop over ``recording_blocks`` blocks of the harness's
stream from the seed.

``live_latency_p95_ms``: the 95th percentile, over every block due inside
the window, of the time from its due time to its row being readable in
the product CSV; a block with no row by the end of the wait is ``failed``
and counts with the time it has waited so far.  ``failed_blocks`` is
among the numbers compared, with the limit 0: a run that leaves a block
without its row is not correct."""

from __future__ import annotations

import math
import os
import tempfile
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from fxtpu_torch.sources.base import Source

from fxbench import streams
from fxbench.cells import Cell, Outcome
from fxbench.pipeline import (CorrelatorRun, check_rows, correlator_config,
                              note, release, sample_rows, warm)

#: How long past the window the run waits for the rows of its blocks.
ROW_WAIT_S = 60.0


class PacedSource(Source):
    """Receivers that deliver one aligned block of ``recording [nch, n]``
    (looped) every ``num_samp / sample_rate`` seconds and never wait: block
    i is due ``(i + 1)`` periods after the first read, and a block more
    than ``queue_blocks`` behind the newest due is lost."""

    max_stable_bandwidth = 2.8e6
    realtime = True

    def __init__(self, recording: np.ndarray, num_samp: int,
                 sample_rate: float, center_freq: float, gain: float,
                 queue_blocks: int):
        super().__init__(recording.shape[0], sample_rate, center_freq, gain)
        self.recording = recording
        self.num_samp = num_samp
        self.queue_blocks = queue_blocks
        self.period = num_samp / sample_rate
        self.t_start: Optional[float] = None
        #: no block due after this host time is delivered
        self.end_time = math.inf
        #: indices of the blocks delivered, in order, and when
        self.delivered: List[int] = []
        self.returned: List[float] = []
        #: indices of the blocks lost in the receivers' queue
        self.lost: List[int] = []
        self._next = 0
        self._wake = threading.Event()

    def due(self, i: int) -> float:
        return self.t_start + (i + 1) * self.period

    def read_block(self, num_samp: int):
        if num_samp != self.num_samp:
            raise ValueError(f"blocks of {num_samp} samples, paced for "
                             f"{self.num_samp}")
        now = time.perf_counter()
        if self.t_start is None:
            self.t_start = now
        arrived = int((now - self.t_start) // self.period)
        i = self._next
        while i < arrived - self.queue_blocks:   # overwritten in the queue
            self.lost.append(i)
            i += 1
        due = self.due(i)
        if due > self.end_time:
            return None
        while not self._stopped and time.perf_counter() < due:
            self._wake.wait(min(0.05, max(due - time.perf_counter(), 0.0)))
        if self._stopped:
            return None
        self._next = i + 1
        self.delivered.append(i)
        self.returned.append(time.perf_counter())
        j = i % (self.recording.shape[1] // num_samp)
        return np.ascontiguousarray(
            self.recording[:, j * num_samp:(j + 1) * num_samp])

    def stop(self):
        super().stop()
        self._wake.set()

    def close(self):
        super().close()
        self._wake.set()


def block_latencies(offered, delivered, row_times, due, stopped: float):
    """(latency of each block of ``offered``, how many got no row, the
    rows of those that did): row r is the (r + 1)-th delivered block's,
    the first delivered block calibrating; a block without a row (lost in
    the receivers' queue, or not written by ``stopped``) counts with the
    time it waited until then."""
    row_of = {b: r for r, b in enumerate(delivered[1:len(row_times) + 1])}
    latency, failed, rows = [], 0, []
    for i in offered:
        if i in row_of:
            latency.append(row_times[row_of[i]] - due(i))
            rows.append(row_of[i])
        else:
            failed += 1
            latency.append(stopped - due(i))
    return latency, failed, rows


def run(cell: Cell, *, seed: int, seconds: float, trace: bool, device: str,
        control: bool = False) -> Outcome:
    on_card = torch.device(device).type == "cuda"
    fields, mix = cell.correlator_fields(), cell.mix
    num = fields["num_samp"]
    with tempfile.TemporaryDirectory(prefix="fxbench-") as tmp:
        out_path = os.path.join(tmp, "vis.csv")
        nb = mix["recording_blocks"]
        delays_in = [d * fields["bandwidth"] for d in mix["delays_s"]]
        x = streams.stream(seed, fields["nchan"], nb * num, delays_in,
                           mix["snr"], mix["rms"], device)
        rec = x.cpu().numpy()
        del x
        cfg = correlator_config(cell, output_file=out_path, device=device)
        t_setup = time.perf_counter()
        warm(cfg)
        note(f"warmed in {time.perf_counter() - t_setup:.3f} s")
        source = PacedSource(rec, num, mix["blocks_per_s"] * num,
                             cfg.frequency, cfg.gain, mix["radio_queue"])
        prog = CorrelatorRun(cfg, source, trace=trace, tmpdir=tmp,
                             row_poll=cell.mix["row_poll_s"]).start()
        t0 = prog.wait_first_row()
        t1 = t0 + seconds
        source.end_time = t1
        prog.sleep_until(t1)
        stopped = prog.stop(wait=ROW_WAIT_S)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        rows = prog.block_rows()
        first = math.ceil((t0 - source.t_start) / source.period - 1)
        last = math.floor((t1 - source.t_start) / source.period - 1)
        offered = [i for i in range(max(first, 0), last + 1)
                   if t0 <= source.due(i) <= t1]
        latency, failed, window_rows = block_latencies(
            offered, source.delivered, [t for _, _, t in rows], source.due,
            stopped)
        p95 = float(np.percentile(np.asarray(latency), 95)) * 1e3
        note("latency of each block due in the window, ms: "
             + " ".join(f"{v * 1e3:.1f}" for v in latency))
        late = max((r - source.due(i) for i, r in
                    zip(source.delivered, source.returned)), default=0.0)
        note(f"{len(offered)} blocks due in the window, {failed} without a "
             f"row, {len(source.lost)} lost in the receivers' queue; the "
             f"source handed blocks over at most {late * 1e3:.3f} ms after "
             f"they were due")
        counters = {"rows": len(window_rows)}
        if trace:
            gets = prog.spans.spans.get("runtime.BlockAligner.get", [])
            puts = prog.spans.spans.get("products.append_visibility", [])
            counters["row_waits_s"] = [
                puts[r][0] - gets[r + 1][1] for r in window_rows
                if r < len(puts) and r + 1 < len(gets)]
        record = prog.record(t0, t1, counters) if trace else None
        delays = prog.cor.calibrated_delays.copy()
        delivered = list(source.delivered)
        del prog, source
        release(device)
        sample = [window_rows[i] for i in sample_rows(
            len(window_rows), mix["check_rows"], seed)]
        readings, ctl = check_rows(
            cfg=cfg, path=out_path, block_spans=rows, sample=sample,
            delivered=lambda i: delivered[i] % nb,
            block=lambda j: rec[:, j * num:(j + 1) * num], delays=delays,
            device=device, control=control)
        readings["failed_blocks"] = float(failed)
    return Outcome(end_to_end={"live_latency_p95_ms": p95}, window_start=t0,
                   attempted=len(offered), failed=failed,
                   memory_peak_bytes=peak, checks=readings, record=record,
                   control=ctl)
