"""Checkpoint / resume for long integrations.

Counterpart of ``fxtpu.runtime.checkpoint``, in its file format, so that
each package resumes the other's snapshots.  A snapshot holds the
correlator's streaming state -- the PFB tap history, the calibrated
delays, the visibility accumulator and the block counters -- and the
source's stream state (in ``meta``), so a long integration resumes where
it stopped.

Format: one ``.npz``, written to a temporary file beside the target and
renamed over it (``os.replace``), so a reader never sees half a snapshot.
Fields:

  * ``version`` (:data:`STATE_VERSION`), ``delays`` float64 ``[nch]``,
    ``blocks_processed`` and ``accumulated`` int64, ``accumulator``
    complex64 (present while a row is being integrated), ``meta_<key>``;
  * the history, either ``history`` complex64 ``[nch, ntaps-1, nbins]``
    (the DC-corrected tail), or for the int8-native route's raw tail
    ``history_tail_re`` / ``history_tail_im`` int32 words ``[nch,
    ntaps-1, nbins//4]`` -- byte k of word L (low byte first) is bin
    ``k * nbins/4 + L``, ``fxtpu``'s ``pack_int8_planes`` -- and
    ``history_mu_prev`` complex64 ``[nch]``, the mean that tail carries.

Device tensors come to the host once a snapshot; :func:`load_state`
returns numpy arrays, which ``FxEngine.restore_history`` moves to the
engine's device.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np

STATE_VERSION = 1


def _host(x) -> np.ndarray:
    """A torch tensor (any device) or array-like -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pack_i8_words(plane: np.ndarray) -> np.ndarray:
    """int8 ``[..., nbins]`` -> int32 words ``[..., nbins//4]``, byte k of
    word L (low byte first) = bin ``k * (nbins//4) + L``: the inverse of
    ``fxtpu_torch.fx._unpack_i8_words``."""
    plane = np.ascontiguousarray(plane, np.int8)
    nbins = plane.shape[-1]
    if nbins % 4:
        raise ValueError(f"{nbins} bins do not pack 4 to a word")
    q = plane.reshape(*plane.shape[:-1], 4, nbins // 4)
    q = np.ascontiguousarray(np.swapaxes(q, -1, -2))     # [..., L, k]
    return q.view("<i4")[..., 0].astype(np.int32)


def save_state(path: str, *, history, delays, blocks_processed: int,
               accumulator=None, accumulated: int = 0,
               meta: Optional[dict] = None):
    """Write a snapshot to ``path`` atomically.  ``history`` is the
    engine's: a complex64 tensor ``[nch, ntaps-1, nbins]``, or the
    int8-native dict ``{"tail": int8 [nch, ntaps-1, nbins, 2], "mu_prev":
    complex64 [nch]}``; ``accumulator`` the running sum of a row being
    integrated (or None)."""
    payload = {
        "version": STATE_VERSION,
        "delays": np.asarray(delays, dtype=np.float64),
        "blocks_processed": np.int64(blocks_processed),
        "accumulated": np.int64(accumulated),
    }
    if isinstance(history, dict):
        tail = _host(history["tail"])
        payload["history_tail_re"] = _pack_i8_words(tail[..., 0])
        payload["history_tail_im"] = _pack_i8_words(tail[..., 1])
        payload["history_mu_prev"] = _host(history["mu_prev"]).astype(
            np.complex64)
    else:
        payload["history"] = _host(history).astype(np.complex64)
    if accumulator is not None:
        payload["accumulator"] = _host(accumulator).astype(np.complex64)
    for key, value in (meta or {}).items():
        payload[f"meta_{key}"] = value
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        # an open handle: np.savez would append '.npz' to a file name
        with os.fdopen(fd, "wb") as fh:
            np.savez(fh, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str) -> dict:
    """Read a snapshot (this package's or ``fxtpu``'s) -> ``{"history",
    "delays", "blocks_processed", "accumulated", "accumulator", "meta"}``,
    numpy arrays on the host: ``history`` complex64 ``[nch, ntaps-1,
    nbins]``, or ``{"tail": int8 [nch, ntaps-1, nbins, 2], "mu_prev":
    complex64 [nch]}`` (the words unpacked); ``accumulator`` complex64 or
    None.  Raises ValueError for another format version."""
    from fxtpu_torch.fx import _unpack_i8_words
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != STATE_VERSION:
            raise ValueError(f"unknown checkpoint version {z['version']} in "
                             f"{path} (this package reads {STATE_VERSION})")
        if "history_tail_re" in z:
            history = {
                "tail": np.stack([_unpack_i8_words(z["history_tail_re"]),
                                  _unpack_i8_words(z["history_tail_im"])],
                                 axis=-1),
                "mu_prev": np.ascontiguousarray(z["history_mu_prev"],
                                                np.complex64),
            }
        else:
            history = np.ascontiguousarray(z["history"], np.complex64)
        return {
            "history": history,
            "delays": np.asarray(z["delays"], np.float64),
            "blocks_processed": int(z["blocks_processed"]),
            "accumulated": int(z["accumulated"]),
            "accumulator": (np.ascontiguousarray(z["accumulator"],
                                                 np.complex64)
                            if "accumulator" in z else None),
            "meta": {k[5:]: z[k] for k in z.files if k.startswith("meta_")},
        }
