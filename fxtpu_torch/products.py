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

import logging
import threading
import time
from queue import Empty, Queue
from typing import Callable, Optional

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig

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


def append_visibility(fh, vis):
    """Append one block's visibilities: accepts a scalar (continuum, one
    baseline), a vector (one spectrum row or continuum baselines), or a
    ``[nbl, nbins]`` matrix (one row per baseline), as a numpy array or a
    torch tensor on any device (moved to the host here)."""
    if isinstance(vis, torch.Tensor):
        vis = vis.detach().cpu().numpy()
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
    polls the output queue every 0.1 s while the correlator is active, then
    drains on stop.  Forcing the device->host transfer here keeps the main
    loop's launches asynchronous."""

    def __init__(self, path: str, vis_queue: Queue,
                 active_fn: Callable[[], bool]):
        self.path = path
        self.vis_queue = vis_queue
        self.active_fn = active_fn
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

    def _drain(self, fh):
        while True:
            try:
                data = self.vis_queue.get_nowait()
            except Empty:
                return
            append_visibility(fh, data)
            self.rows_written += 1
            fh.flush()

    def _run(self):
        with open(self.path, "a") as fh:
            while self.active_fn():
                self._drain(fh)
                time.sleep(0.1)
            self._drain(fh)  # final drain after shutdown
