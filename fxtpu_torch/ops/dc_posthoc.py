"""The post-hoc DC correction of the single-pass fused FX step.

PyTorch counterpart of ``fxtpu.ops.pfb_pallas._dc_constants`` and
``_dc_correct``.  The single-pass kernel runs the FIR and the FFT over the
samples as they arrived and gathers, per block and channel, what the mean
removal would have changed (:func:`~fxtpu_torch.ops.fx_fused.fx_fused_parts`):

  xp_raw [K, nbl, nbins]  the frame-summed cross power of the raw spectra;
  T      [K, nch, nbins]  sum over frames of spec_c;
  GJ     [K, nch, nbins]  sum over the first ntaps-1 frames j of
                          spec_c[j] * conj(dA[j]);
  mu     [K, nch]         the block's mean per channel.

Removing the mean mu_c from a block's samples changes frame f's spectrum
by ``mu_c A[f]``, where ``A[f]`` is the FFT of the sum of the window taps
whose row lies in the block: the whole column sum (``Abar``) for interior
frames, a partial one (``A_j``) for the first ntaps-1 frames, whose other
taps read the carried history.  :func:`dc_constants` forms the window's
constants in float64 on the host; :func:`dc_correct` applies the algebra
to the parts, on complex64 tensors of ``[K, ..., nbins]``: tiny next to
the block.  The parts are sums over frames, so partial sums over disjoint
sets of frames (CTAs of one launch, ranks of a frame-sharded step) add up
before one correction.

Precision: at the DC bin ``xp_raw`` holds ``|mu|^2 |Abar(0)|^2 S`` and the
correction subtracts it again, so that bin loses precision as the mean
grows (``docs/design.md``); every other bin is corrected by little.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["dc_constants", "dc_correct", "block_mu_prev"]


@functools.lru_cache(maxsize=32)
def _constants(w_bytes: bytes, ntaps: int, nbins: int, s_rows: int):
    """:func:`dc_constants` on the host, cached per window: float64
    arithmetic, complex64 / float32 numpy results."""
    w2d = np.frombuffer(w_bytes, np.float64).reshape(ntaps, nbins)
    halo = ntaps - 1
    abar = np.fft.fft(w2d.sum(axis=0))
    a_j = np.array([np.fft.fft(w2d[ntaps - 1 - j:].sum(axis=0))
                    for j in range(halo)]).reshape(halo, nbins)
    cs = (s_rows - halo) * np.abs(abar) ** 2 + (np.abs(a_j) ** 2).sum(0)
    b_j = abar - a_j                            # the raw history's weights
    cab = (a_j * np.conj(b_j)).sum(0)
    cbb = (np.abs(b_j) ** 2).sum(0)
    return (abar.astype(np.complex64), (a_j - abar).astype(np.complex64),
            cs.astype(np.float32), cab.astype(np.complex64),
            cbb.astype(np.float32))


def dc_constants(window2d, nbins: int, s_rows: int, device="cpu",
                 svd=None):
    """The window's constants for :func:`dc_correct`, natural bin order,
    on ``device``: ``(abar [nbins] c64, dA [ntaps-1, nbins] c64 = A_j -
    Abar, cs [nbins] f32 = sum_f |A[f]|^2, cab [nbins] c64 = sum_j A_j
    conj(Abar - A_j), cbb [nbins] f32 = sum_j |Abar - A_j|^2)`` for blocks
    of ``s_rows >= ntaps-1`` frames.  ``cs`` serves the corrected-tail
    history contract; ``cab`` and ``cbb`` the raw-tail one, where the
    first frames also carry ``mu_prev (Abar - A_j)`` from the previous
    block's uncorrected rows.

    ``svd``: the SVD-FIR mode's factors ``(u [ntaps, r], v [r, nbins])``.
    That FIR applies the window ``u v``, not ``window2d``, so the
    constants are taken of ``u v`` (in float64): the correction then
    removes what the FIR made of the mean, whatever the mean.  Constants
    of ``window2d`` would leave ``mu (A(u v) - A(window2d))`` in every
    frame, a residue that grows with the mean."""
    if svd is not None:
        u, v = (np.asarray(torch.as_tensor(a).detach().cpu(), np.float64)
                for a in svd)
        window2d = u @ v
    w = np.ascontiguousarray(np.asarray(window2d, np.float64))
    ntaps = w.size // nbins
    if w.size != ntaps * nbins or s_rows < ntaps - 1:
        raise ValueError(
            f"a window of {w.size} taps over nbins={nbins} and blocks of "
            f"S={s_rows} rows: the post-hoc DC correction needs whole tap "
            "rows and S >= ntaps-1")
    # copies: a tensor made by from_numpy shares the cached arrays, so an
    # in-place write by one caller would change every later caller's
    return tuple(torch.from_numpy(a.copy()).to(device)
                 for a in _constants(w.tobytes(), ntaps, nbins, s_rows))


def block_mu_prev(mu: torch.Tensor, first=None) -> torch.Tensor:
    """The mean the rows before each block of one launch still carry,
    ``[K, nch]``: block k >= 1 reads block k-1's raw rows (``mu[k-1]``);
    block 0 reads the stream history, whose mean is ``first`` (the carried
    ``mu_prev`` of a raw tail; None for a DC-corrected tail: zero)."""
    head = (torch.zeros_like(mu[:1]) if first is None
            else first.to(mu.dtype).reshape(1, -1))
    return torch.cat([head, mu[:-1]])


def dc_correct(xp: torch.Tensor, T: torch.Tensor, GJ: torch.Tensor,
               mu: torch.Tensor, pairs: torch.Tensor, consts,
               mu_prev=None) -> torch.Tensor:
    """The DC-corrected frame-summed cross power ``[K, nbl, nbins]`` from
    the raw parts (module docstring) and ``consts`` of
    :func:`dc_constants`.

    Corrected-tail history (``mu_prev`` None), with ``s'_c[f] = s_c[f] -
    mu_c A[f]`` and ``G_c = conj(Abar) T_c + GJ_c``::

        sum_f s'_p conj(s'_q) = xp - conj(mu_q) G_p - mu_p conj(G_q)
                                + mu_p conj(mu_q) cs

    Raw-tail history (``mu_prev [K, nch]``, the mean the rows before each
    block still carry): the first frames lose ``mu_prev_c (Abar - A_j)``
    as well, with ``H_c = conj(Abar) T_c - G_c``::

        ... - conj(mu_prev_q) H_p - mu_prev_p conj(H_q)
            + mu_p conj(mu_prev_q) cab + mu_prev_p conj(mu_q) conj(cab)
            + mu_prev_p conj(mu_prev_q) cbb
    """
    abar, _, cs, cab, cbb = consts
    idx = pairs.to(device=xp.device, dtype=torch.long)
    p, q = idx[:, 0], idx[:, 1]
    ta = T * abar.conj()
    g = ta + GJ
    mu_p, mu_q = mu[:, p, None], mu[:, q, None]
    out = (xp - g[:, p] * mu_q.conj() - (g[:, q] * mu_p.conj()).conj()
           + (mu_p * mu_q.conj()) * cs)
    if mu_prev is None:
        return out
    h = ta - g
    mv_p, mv_q = mu_prev[:, p, None], mu_prev[:, q, None]
    return (out - h[:, p] * mv_q.conj() - (h[:, q] * mv_p.conj()).conj()
            + (mu_p * mv_q.conj()) * cab + (mv_p * mu_q.conj()) * cab.conj()
            + (mv_p * mv_q.conj()) * cbb)
