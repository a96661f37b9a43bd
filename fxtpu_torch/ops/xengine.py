"""X-stage: fractional-sample delay correction, conjugate multiply, integrate.

PyTorch counterpart of ``fxtpu.ops.xengine`` and of the rotation and
cross-power halves of ``fxtpu.ops.planes``, on complex64 tensors (the TPU's
dual-plane ``Cplx`` form has no counterpart here).  Math contract
(reference parity for nchan=2, delays=[0, d], ``effex.py:516-524``):

  freqs = fftfreq(nbins, 1/bandwidth) + frequency
  G_c   = F_c * exp(+2j*pi*freqs*d_c)
  vis   = fftshift(mean over frames of G_p conj(G_q))
  continuum: vis = mean over bins / bandwidth
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "baseline_pairs", "pack_delays", "rf_freqs", "unit_phasor",
    "fstc_rotate", "xcorr_pair", "xcorr_baselines", "continuum_reduce",
]


def baseline_pairs(nchan: int, include_autos: bool = False) -> np.ndarray:
    """Upper-triangular baseline map: ``[n_baselines, 2]`` int32 array.
    Autos, if included, come first; cross pairs (p < q) row-major
    (``fxtpu.ops.xengine.baseline_pairs``)."""
    pairs = []
    if include_autos:
        pairs += [(c, c) for c in range(nchan)]
    pairs += [(p, q) for p in range(nchan) for q in range(p + 1, nchan)]
    return np.asarray(pairs, dtype=np.int32)


def pack_delays(delays, frequency) -> np.ndarray:
    """Host-side float64 packing of per-channel delays for full-precision
    FSTC: ``[..., nch]`` seconds -> ``[..., nch, 2]`` float32 of
    ``(delay, frac(frequency * delay))`` (``fxtpu.ops.planes.pack_delays``).

    The carrier phase ``2 pi f_RF d`` reaches thousands of cycles; reduced
    modulo 1 in float64 here, the on-device argument is O(1) cycles and
    float32 trig stays accurate to ~1e-6 rad."""
    d = np.asarray(delays, np.float64)
    frac = np.mod(frequency * d, 1.0)
    return np.stack([d.astype(np.float32), frac.astype(np.float32)],
                    axis=-1)


def split_delays(delays: torch.Tensor, nch_ndim: int):
    """(d, frac or None): accepts plain ``[..., nch]`` or packed
    ``[..., nch, 2]`` delays (``nch_ndim`` = the plain form's ndim)."""
    if delays.ndim == nch_ndim + 1 and delays.shape[-1] == 2:
        return delays[..., 0], delays[..., 1]
    return delays, None


def rf_freqs(nbins: int, bandwidth: float, frequency: float,
             packed: bool, device) -> torch.Tensor:
    """float32 frequency per (unshifted) FFT bin, built in float64: the
    baseband offsets for packed delays, RF (``+ frequency``) otherwise
    (``fxtpu.ops.xengine.rf_freqs``)."""
    f = np.fft.fftfreq(nbins, d=1.0 / bandwidth)
    if not packed:
        f = f + frequency
    return torch.from_numpy(f.astype(np.float32)).to(device)


def rotation_phase(freqs: torch.Tensor, d: torch.Tensor, frac) -> torch.Tensor:
    """``2 pi (f d + frac)`` (packed) or ``2 pi f d`` (plain) for
    ``d [..., m]`` against ``freqs [nbins]`` -> ``[..., m, nbins]``, in the
    JAX package's evaluation order."""
    if frac is not None:
        return (2.0 * math.pi) * (freqs * d[..., None] + frac[..., None])
    return (2.0 * math.pi) * freqs * d[..., None]


def unit_phasor(phase: torch.Tensor) -> torch.Tensor:
    """``exp(j phase)`` as complex64 on ``phase``'s device.

    On the CPU the cosine and sine are taken by numpy in float64 on the
    calling thread and rounded once to float32.  torch's CPU ``cos`` of a
    large float32 tensor splits it over the intra-op threads, and on its
    first call in a process under load it returned one contiguous chunk
    (40,960 of 147,456 elements, at 8 channels with autos and 4096 bins)
    with 1.5e-4 absolute error, from the same input that gave 3.6e-8 on
    every later call: the 8-channel engine test's unsteady failures
    (``tests/test_torch_fx_wide.py``)."""
    if phase.device.type == "cpu":
        p = phase.detach().numpy().astype(np.float64)
        return torch.complex(torch.from_numpy(np.cos(p).astype(np.float32)),
                             torch.from_numpy(np.sin(p).astype(np.float32)))
    return torch.complex(torch.cos(phase), torch.sin(phase))


def fstc_rotate(spectra: torch.Tensor, delays, bandwidth: float,
                frequency: float) -> torch.Tensor:
    """Apply the per-channel FSTC phase ramp ``exp(+2 pi j f_RF d_c)``.

    ``spectra``: ``[nch, S, nbins]`` complex64; ``delays``: ``[nch]``
    seconds, or the packed ``[nch, 2]`` form from :func:`pack_delays`."""
    delays = torch.as_tensor(delays, dtype=torch.float32,
                             device=spectra.device)
    d, frac = split_delays(delays, 1)
    freqs = rf_freqs(spectra.shape[-1], bandwidth, frequency,
                     frac is not None, spectra.device)
    rot = unit_phasor(rotation_phase(freqs, d, frac))    # [nch, nbins]
    return spectra * rot[:, None, :]


def xcorr_pair(f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """One pair's frame-averaged cross power, fftshifted:
    ``f0, f1 [..., S, nbins]`` -> ``[..., nbins]``
    (``fxtpu.ops.xengine.xcorr_pair``)."""
    return torch.fft.fftshift((f0 * f1.conj()).mean(dim=-2), dim=-1)


def xcorr_baselines(spectra: torch.Tensor, pairs) -> torch.Tensor:
    """All-baseline frame-averaged cross power, fftshifted:
    ``V[l] = mean_k G[p_l] conj(G[q_l])``.  ``spectra [nch, S, nbins]``,
    ``pairs [nbl, 2]`` -> ``[nbl, nbins]``."""
    pairs = torch.as_tensor(pairs, dtype=torch.long, device=spectra.device)
    gp = spectra[pairs[:, 0]]
    gq = spectra[pairs[:, 1]]
    xps = (gp * gq.conj()).mean(dim=-2)
    return torch.fft.fftshift(xps, dim=-1)


def continuum_reduce(vis: torch.Tensor, bandwidth: float) -> torch.Tensor:
    """CONTINUUM/TEST reduction: average over frequency, normalize by
    bandwidth (``effex.py:523-524``).  ``vis [..., nbins] -> [...]``."""
    return vis.mean(dim=-1) / bandwidth
