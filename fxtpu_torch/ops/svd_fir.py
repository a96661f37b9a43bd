"""The deep-tap FIR as a rank-r factorisation of the PFB window.

Counterpart of ``fxtpu.ops.pfb_pallas._svd_fir_factors`` and
``fxtpu.fx._deep_svd_applies``, in numpy float64 as ``fxtpu`` writes it.
A PFB window ``w [ntaps, nbins]`` is a smooth windowed sinc sampled on a
grid, so its SVD collapses: keeping the singular vectors down to ``tol``
of the largest gives ``w ~= u @ v`` with rank 6 at 32 taps (8 at
``tol=1e-7``), and the FIR becomes

    fir[f, b] = sum_k v[k, b] * (sum_t u[t, k] * x[f+t, b]),

a scalar-tap convolution per rank and a per-bin combine.  The factors are
configuration derived from the window; the tolerance is a keyword, not an
environment variable.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["SVD_FIR_MIN_TAPS", "SVD_TOL", "svd_fir_factors",
           "deep_svd_applies"]

#: The SVD form is used at or above this many taps (``pfb_pallas.py:330``).
SVD_FIR_MIN_TAPS = 16
#: Singular vectors are kept down to this relative magnitude
#: (``pfb_pallas.py:339``).
SVD_TOL = 1e-5


def svd_fir_factors(window2d, nbins: int, tol: float = SVD_TOL
                    ) -> Optional[Tuple[np.ndarray, np.ndarray, tuple]]:
    """``(u [ntaps, r], v [r, nbins], ratios)`` in float64 with ``u @ v ~=
    window2d`` to ``tol`` (``ratios[k] = sigma_k / sigma_1``), or None when
    the window has fewer than :data:`SVD_FIR_MIN_TAPS` taps or does not
    factorise below full rank."""
    w2d = np.asarray(window2d, np.float64).reshape(-1, nbins)
    ntaps = w2d.shape[0]
    if ntaps < SVD_FIR_MIN_TAPS:
        return None
    uu, ss, vt = np.linalg.svd(w2d, full_matrices=False)
    r = max(int(np.sum(ss > tol * ss[0])), 1)
    if r >= ntaps:
        return None
    return uu[:, :r] * ss[:r], vt[:r], tuple((ss[:r] / ss[0]).tolist())


def deep_svd_applies(window2d, nbins: int, tol: float = SVD_TOL) -> bool:
    """True when the deep-tap FIR factorises for this window: at least
    :data:`SVD_FIR_MIN_TAPS` taps and rank below ``ntaps`` at ``tol``."""
    return svd_fir_factors(window2d, nbins, tol) is not None
