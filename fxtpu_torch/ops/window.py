"""PFB prototype-filter design: window functions and windowed-sinc FIR.

The reference builds its polyphase filter prototype as
``get_window("hamming", ntaps*nbins) * firwin(ntaps*nbins, cutoff=1/nbins,
window='rectangular')`` through cuSignal (``effex/effex.py:126-127``).
Filter design is a one-time host-side computation, so these are pure NumPy
(float64) implementations with scipy.signal-compatible semantics; tests assert
parity against scipy.signal directly.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_window", "firwin", "pfb_window"]


def _cosine_window(n: int, coeffs, periodic: bool) -> np.ndarray:
    m = n if periodic else n - 1
    if m <= 0:
        return np.ones(n, dtype=np.float64)
    k = np.arange(n, dtype=np.float64)
    w = np.zeros(n, dtype=np.float64)
    for j, a in enumerate(coeffs):
        w += ((-1) ** j) * a * np.cos(2.0 * np.pi * j * k / m)
    return w


def get_window(name: str, n: int, periodic: bool = True) -> np.ndarray:
    """scipy.signal.get_window-compatible windows (fftbins=True default).

    Supports the families plausibly used for PFB prototypes; 'hamming' is
    what the reference uses (``effex.py:126``).
    """
    name = name.lower()
    if n < 1:
        raise ValueError("window length must be >= 1")
    if name in ("rectangular", "boxcar", "rect", "ones"):
        return np.ones(n, dtype=np.float64)
    if name == "hamming":
        return _cosine_window(n, (0.54, 0.46), periodic)
    if name in ("hann", "hanning"):
        return _cosine_window(n, (0.5, 0.5), periodic)
    if name == "blackman":
        return _cosine_window(n, (0.42, 0.5, 0.08), periodic)
    if name == "blackmanharris":
        return _cosine_window(
            n, (0.35875, 0.48829, 0.14128, 0.01168), periodic)
    raise ValueError(f"unknown window: {name}")


def firwin(numtaps: int, cutoff: float, window: str = "rectangular") -> np.ndarray:
    """Lowpass windowed-sinc FIR, scipy.signal.firwin-compatible.

    ``cutoff`` is in Nyquist units (fs/2 == 1.0), like scipy's default
    ``fs=2``.  The response is normalized to unit gain at DC, matching
    scipy's ``scale=True``.  The reference calls this with
    ``cutoff=1/nbins, window='rectangular'`` (``effex.py:127``).
    """
    if numtaps < 1:
        raise ValueError("numtaps must be >= 1")
    if not 0 < cutoff < 1:
        raise ValueError(f"cutoff must be in (0, 1) Nyquist units, got {cutoff}")
    alpha = 0.5 * (numtaps - 1)
    m = np.arange(numtaps, dtype=np.float64) - alpha
    h = cutoff * np.sinc(cutoff * m)
    h *= get_window(window, numtaps, periodic=False)
    h /= np.sum(h)  # unit DC gain
    return h


def pfb_window(ntaps: int, nbins: int, window: str = "hamming") -> np.ndarray:
    """The reference's composite PFB prototype filter (``effex.py:126-127``):
    a length ``ntaps*nbins`` window times a rectangular-windowed sinc lowpass
    with cutoff at one bin width."""
    n = ntaps * nbins
    return get_window(window, n) * firwin(n, cutoff=1.0 / nbins,
                                          window="rectangular")
