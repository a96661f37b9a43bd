"""The harness's own signal generator: the inputs of every cell, made on
the device from ``--seed``.

A stream is a common complex noise signal, delayed per channel by a
fractional number of samples (a phase ramp over the whole stream's FFT, so
the delay is circular and a looped recording has no seam), plus
independent noise on each channel at the mix's signal-to-noise ratio,
scaled to ``rms`` per real component.  The same seed on the same kind of
device gives the same samples."""

from __future__ import annotations

import math

import torch

__all__ = ["generator", "stream", "quantize"]


def generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (any whole
    number; folded into 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def _complex_normal(g: torch.Generator, n: int, device) -> torch.Tensor:
    """``n`` complex normal samples of unit power."""
    re_im = torch.randn((n, 2), generator=g, device=device,
                        dtype=torch.float32)
    return torch.view_as_complex(re_im) / math.sqrt(2.0)


def stream(seed: int, nchan: int, nsamp: int, delays_samples, snr: float,
           rms: float, device) -> torch.Tensor:
    """``[nchan, nsamp]`` complex64 on ``device``: channel ``c`` is the
    common signal delayed by ``delays_samples[c]`` samples plus its own
    noise (common power over noise power = ``snr``), scaled so that each
    real component has standard deviation ``rms``."""
    if len(delays_samples) != nchan:
        raise ValueError(f"{len(delays_samples)} delays for {nchan} channels")
    g = generator(seed, device)
    spec = torch.fft.fft(_complex_normal(g, nsamp, device))
    f = torch.fft.fftfreq(nsamp, device=device, dtype=torch.float64)
    scale = rms * math.sqrt(2.0) / math.sqrt(1.0 + 1.0 / snr)
    out = torch.empty((nchan, nsamp), dtype=torch.complex64, device=device)
    for c, tau in enumerate(delays_samples):
        phase = torch.remainder(-f * float(tau), 1.0) * (2.0 * math.pi)
        ramp = torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
        common = torch.fft.ifft(spec * ramp)
        noise = _complex_normal(g, nsamp, device) / math.sqrt(snr)
        out[c] = (common + noise) * scale
        del phase, ramp, common, noise
    return out


def quantize(x: torch.Tensor, step: float) -> torch.Tensor:
    """Complex samples -> 8-bit ``[..., 2]`` (I, Q) integers
    ``round(x / step)`` clipped to [-127, 127], as an 8-bit receiver
    delivers them."""
    planes = torch.view_as_real(x) / step
    return torch.clamp(torch.round(planes), -127, 127).to(torch.int8)
