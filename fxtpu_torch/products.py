"""Science-data products: the streamed visibility CSV.

A copy of ``fxtpu.products`` without its JAX package import; visibilities
arrive as torch tensors and move to the host in the writer thread.

Byte-format parity with the reference (``effex/effex.py:667-696``)
so the reference's own ``post_process.py`` can read our files unmodified:

  * line 1 — one comma-joined ``key:value`` metadata header
    (``effex.py:671-678``), extended with ``sweep_step`` in TEST mode (fixes
    the reconstruction mismatch noted in SURVEY.md §2.4) and ``nchan`` when
    generalized beyond 2 inputs;
  * line 2 (SPECTRUM only) — the fftshifted RF bin frequencies
    (``effex.py:679-682``);
  * data — one ``np.savetxt`` complex row per visibility (``effex.py:687-696``);
    for nchan > 2 each block contributes ``n_baselines`` consecutive rows in
    ``fxtpu_torch.ops.xengine.baseline_pairs`` order.
"""

from __future__ import annotations

import contextlib
import logging
import threading
from queue import Empty, Queue
from typing import Callable, Optional

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.runtime.metrics import Metrics, Seq

logger = logging.getLogger(__name__)


def metadata_line(md: dict) -> str:
    return ",".join(f"{k}:{v}" for k, v in md.items()) + "\n"


def shifted_rf_freqs(nbins: int, bandwidth: float, frequency: float) -> np.ndarray:
    """RF frequency labels for the SPECTRUM header row (``effex.py:681``)."""
    return np.fft.fftshift(np.fft.fftfreq(nbins, d=1 / bandwidth)) + frequency


def write_metadata(path: str, cfg: CorrelatorConfig):
    """Write the CSV header (``Correlator._write_metadata``, ``effex.py:667-684``)."""
    logger.info("Data will be saved to %s.", path)
    with open(path, "w") as fh:
        fh.write(metadata_line(cfg.metadata()))
        if cfg.mode == "SPECTRUM":
            freqs = shifted_rf_freqs(cfg.nbins, cfg.bandwidth, cfg.frequency)
            np.savetxt(fh, [freqs], delimiter=",")
        else:
            np.savetxt(fh, [])


def _untimed(name: str, seq: Seq = None):
    return contextlib.nullcontext()


def append_visibility(fh, vis, *, metrics: Optional[Metrics] = None,
                      seq: Seq = None):
    """Append one block's visibilities: accepts a scalar (continuum, one
    baseline), a vector (one spectrum row or continuum baselines), or a
    ``[nbl, nbins]`` matrix (one row per baseline), as a numpy array or a
    torch tensor on any device (moved to the host here).  ``metrics``
    takes the copy to the host as span ``products.d2h`` (it waits for the
    kernels that make ``vis``) and the text as ``products.text``, keyed
    by the row's ``seq``."""
    stage = _untimed if metrics is None else metrics.stage
    if isinstance(vis, torch.Tensor):
        with stage("products.d2h", seq):
            vis = vis.detach().cpu().numpy()
    with stage("products.text", seq):
        arr = np.atleast_1d(np.asarray(vis)).astype(np.complex128)
        if arr.ndim == 1:
            np.savetxt(fh, [arr], delimiter=",")
        else:
            np.savetxt(fh, arr, delimiter=",")


def parse_metadata(path: str) -> dict:
    """Parse the key:value header line (``post_process.py:201-204`` parity)."""
    with open(path) as fh:
        line = fh.readline().strip()
    md = {}
    for item in line.split(","):
        key, val = item.split(":", 1)
        md[key] = val
    return md


def skiprows_for_mode(mode: str) -> int:
    """1 for continuum/test, 2 for spectrum (``effex.py:785-788``)."""
    return 1 if mode.upper() in ("CONTINUUM", "TEST") else 2


def load_products(path: str):
    """Load (metadata, visibilities) from a product CSV — works on files
    written by this package or by the reference."""
    md = parse_metadata(path)
    data = np.loadtxt(path, dtype=np.complex128, delimiter=",",
                      skiprows=skiprows_for_mode(md["mode"]))
    return md, data


class VisibilityWriter:
    """Background CSV appender (``Correlator._write_data``, ``effex.py:687-696``):
    it blocks on the output queue, so a row's put wakes it at once; it
    writes that row, then whatever else is already queued, then blocks
    again.  A blocking get gives up after 0.1 s; the writer then ends if
    ``active_fn`` no longer holds, after a last drain.  So it stops
    within 0.1 s of the run once the queue is empty, without a marker in
    the queue (another thread may empty the queue on stop).  Forcing the
    device->host transfer here keeps the main loop's launches
    asynchronous.

    The queue's items are ``(seq, vis)``: the ring seq of the row's block
    (``(first, last)`` of an integrated row) and its visibilities.  Each
    row is flushed on its own.  ``metrics`` takes each row's spans keyed
    by ``seq``: ``products.queue`` (from the producer's
    :meth:`~Metrics.hand_off` to the get), ``products.d2h`` and
    ``products.text`` (:func:`append_visibility`), ``products.flush``,
    and the count ``products.rows_written``; and the count
    ``products.wakes``, 1 keyed by the row a blocking get returned.
    ``rows_written / wakes`` is the rows written a wake: 1 while the
    writer keeps up with the rows, above 1 only when a backlog builds
    (rows arriving faster than their text is written)."""

    def __init__(self, path: str, vis_queue: Queue,
                 active_fn: Callable[[], bool],
                 metrics: Optional[Metrics] = None):
        self.path = path
        self.vis_queue = vis_queue
        self.active_fn = active_fn
        self.metrics = metrics if metrics is not None else Metrics()
        self.rows_written = 0
        self._thread: Optional[threading.Thread] = None

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fxtpu_torch-writer")
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None):
        if self._thread is not None:
            self._thread.join(timeout)

    def _write(self, fh, seq, vis):
        self.metrics.pick_up("products.queue", seq)
        append_visibility(fh, vis, metrics=self.metrics, seq=seq)
        self.rows_written += 1
        with self.metrics.stage("products.flush", seq):
            fh.flush()
        self.metrics.count("products.rows_written", 1, seq)

    def _drain(self, fh):
        while True:
            try:
                seq, vis = self.vis_queue.get_nowait()
            except Empty:
                return
            self._write(fh, seq, vis)

    def _run(self):
        with open(self.path, "a") as fh:
            while True:
                try:
                    seq, vis = self.vis_queue.get(timeout=0.1)
                except Empty:
                    # the stop is looked at only after a get that waited
                    # its whole 0.1 s, so the thread outlives a run's last
                    # row by that much: fxbench's live driver ends its
                    # source at the window's end and counts a Correlator
                    # that ends before it as failed
                    if self.active_fn():
                        continue
                    break
                self.metrics.count("products.wakes", 1, seq)
                self._write(fh, seq, vis)
                self._drain(fh)
            self._drain(fh)  # final drain after shutdown
