"""The numbers that decide ``correct``: each compares what the program
produced with what the reference works out from the same inputs."""

from __future__ import annotations

import numpy as np

__all__ = ["spectrum_gap", "continuum_gap", "delay_gap_samples",
           "mean_gap"]


def spectrum_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The widest gap of a visibility spectrum ``[..., nbins]`` (one per
    baseline), as a share of the reference spectrum's largest magnitude:
    max over rows of max|got - want| / max|want|."""
    got = np.atleast_2d(got)
    want = np.atleast_2d(want)
    if got.shape != want.shape:
        return float("inf")
    err = np.abs(got - want).max(axis=-1)
    scale = np.abs(want).max(axis=-1)
    return float((err / scale).max())


def continuum_gap(got: np.ndarray, want: np.ndarray,
                  scale: np.ndarray) -> float:
    """The gap of CONTINUUM values (one per baseline) as a share of
    ``scale``, the mean magnitude of each baseline's spectrum over
    bandwidth: the size of the terms the bin average sums, so a value
    that cancels to near zero is not judged by its own size."""
    got = np.atleast_1d(got)
    want = np.atleast_1d(want)
    if got.shape != want.shape:
        return float("inf")
    return float((np.abs(got - want) / np.atleast_1d(scale)).max())


def delay_gap_samples(got_s: np.ndarray, want_s: np.ndarray,
                      rate: float) -> float:
    """The largest difference of calibrated delays, in samples."""
    return float(np.abs(np.asarray(got_s) - np.asarray(want_s)).max() * rate)


def mean_gap(got: np.ndarray, want: np.ndarray) -> float:
    """The largest relative gap of per-channel block means."""
    return float((np.abs(got - want) / np.abs(want)).max())
