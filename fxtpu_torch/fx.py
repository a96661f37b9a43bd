"""The per-block FX step and the delay calibrator, in PyTorch.

Counterpart of ``fxtpu.fx``.  Two routes with one contract, chosen once
per engine (``_resolve_fused``, like ``fxtpu.fx._resolve_fused``):

  * the fused route: the block arrives pre-framed ``[nch, S, nbins]``, the
    hand-written CUDA kernel (:func:`~fxtpu_torch.ops.fx_fused.fx_fused_raw`)
    returns the raw frame-summed cross power, and :func:`_finish` applies
    the FSTC rotation, ``1/n_frames``, the fftshift and the continuum
    reduction on the tiny ``[nbl, nbins]`` result (the rotation commutes
    with the frame sum);
  * the plain route: DC removal, the streaming spectrometer
    (``torch.fft``), the rotation per frame, the frame mean and the
    shift, all in plain torch (``fxtpu``'s ``fused=False`` path).

``step(iq, delays, history) -> (vis, new_history)``: ``vis`` is
``[nbl, nbins]`` fftshifted cross-power spectra (SPECTRUM) or ``[nbl]``
scalars (CONTINUUM/TEST); ``delays`` is ``[nch]`` seconds or the packed
``[nch, 2]`` form of :func:`~fxtpu_torch.ops.xengine.pack_delays`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.ops.delay import estimate_delay
from fxtpu_torch.ops.fx_fused import fx_fused_raw, pairs_tensor, supported
from fxtpu_torch.ops.pfb import dc_remove, spectrometer, zero_history
from fxtpu_torch.ops.window import pfb_window
from fxtpu_torch.ops.xengine import (baseline_pairs, continuum_reduce,
                                     fstc_rotate, rf_freqs, rotation_phase,
                                     split_delays, xcorr_baselines)

__all__ = ["make_fx_step", "make_calibrator", "dc_remove", "FxEngine"]


def _resolve_fused(fused, device: torch.device, nbins: int, ntaps: int,
                   nch: int) -> bool:
    """'auto' -> the kernel on a CUDA device for every shape it supports;
    True -> the kernel, raising when it cannot run here; False -> plain
    torch."""
    if fused == "auto":
        return device.type == "cuda" and supported(nbins, ntaps, nch)
    if fused is True:
        if device.type != "cuda":
            raise ValueError(
                f"fused=True needs a CUDA device, got {device}; use "
                "fused='auto' or False to run plain torch")
        if not supported(nbins, ntaps, nch):
            raise ValueError(
                f"fused=True: the CUDA FX kernel does not take nbins="
                f"{nbins}, ntaps={ntaps}, nch={nch} (see "
                "fxtpu_torch.ops.fx_fused.supported)")
        return True
    if fused is False:
        return False
    raise ValueError(f"fused must be 'auto', True or False, got {fused!r}")


class _FinishTables:
    """Device-resident constants of :func:`_finish`, built once per step
    so the per-block finish makes no host-to-device copy."""

    def __init__(self, pairs: np.ndarray, nbins: int, bandwidth: float,
                 frequency: float, device):
        self.p = torch.as_tensor(pairs[:, 0], dtype=torch.long, device=device)
        self.q = torch.as_tensor(pairs[:, 1], dtype=torch.long, device=device)
        self.fbase = rf_freqs(nbins, bandwidth, frequency, True, device)
        self.frf = rf_freqs(nbins, bandwidth, frequency, False, device)


def _finish(xp: torch.Tensor, delays: torch.Tensor, tables: _FinishTables,
            n_frames: int, bandwidth: float, continuum: bool):
    """Raw frame-summed cross power ``[nbl, nbins]`` -> the visibility
    (``fxtpu.fx._finish_fused``): ``vis[p,q] = xp[p,q] rot_p conj(rot_q) /
    n_frames`` with ``rot_c = exp(+2 pi j f d_c)``, fftshift, and the
    continuum reduction."""
    d, frac = split_delays(delays, 1)
    dd = d[tables.p] - d[tables.q]                           # [nbl]
    if frac is not None:
        phase = rotation_phase(tables.fbase, dd,
                               frac[tables.p] - frac[tables.q])
    else:
        phase = rotation_phase(tables.frf, dd, None)
    rot = torch.complex(torch.cos(phase), torch.sin(phase))
    vis = torch.fft.fftshift(xp * rot / n_frames, dim=-1)
    return continuum_reduce(vis, bandwidth) if continuum else vis


def make_fx_step(*, mode: str, nbins: int, window2d: np.ndarray,
                 pairs: np.ndarray, bandwidth: float, frequency: float,
                 device, fused: bool):
    """Build the per-block step on ``device``.  ``fused=True`` takes the
    fused route (framed ``[nch, S, nbins]`` input through
    :func:`fx_fused_raw`: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors); ``fused=False`` the plain route on
    ``[nch, num_samp]`` samples."""
    device = torch.device(device)
    continuum = mode in ("CONTINUUM", "TEST")
    w = torch.as_tensor(np.asarray(window2d, np.float32), device=device)
    nch = int(np.asarray(pairs).max()) + 1

    if fused:
        pairs_dev = pairs_tensor(pairs, nch, device)
        tables = _FinishTables(np.asarray(pairs), nbins, bandwidth,
                               frequency, device)

        def fused_step(iq, delays, history):
            xp, new_history = fx_fused_raw(iq, history, w, pairs_dev)
            vis = _finish(xp, delays, tables, iq.shape[-2], bandwidth,
                          continuum)
            return vis, new_history

        return fused_step

    pairs_idx = torch.as_tensor(np.asarray(pairs), dtype=torch.long,
                                device=device)

    def step(iq, delays, history):
        spec, new_history = spectrometer(dc_remove(iq), w, nbins, history)
        spec = fstc_rotate(spec, delays, bandwidth, frequency)
        vis = xcorr_baselines(spec, pairs_idx)
        if continuum:
            vis = continuum_reduce(vis, bandwidth)
        return vis, new_history

    return step


def make_calibrator(*, bandwidth: float):
    """All-channel delay calibration against channel 0: ``cal(iq [nch, n])
    -> delays [nch]`` seconds (float32), ``delays[0] == 0``.  Blocks are
    DC-removed first, as the reference calibrates on DC-removed buffers
    (``effex.py:391-395`` then ``:484``)."""

    def cal(iq: torch.Tensor) -> torch.Tensor:
        iq = dc_remove(iq)
        est = estimate_delay(iq[:1].expand_as(iq[1:]), iq[1:], bandwidth)
        return torch.cat([torch.zeros(1, dtype=est.dtype, device=est.device),
                          est])

    return cal


class FxEngine:
    """Window + pairs + step + calibrator for one config, on
    ``cfg.device``.  The route (CUDA kernel or plain torch) is decided
    once, here; :attr:`kernel_active` reports it."""

    def __init__(self, cfg: CorrelatorConfig, fused=None):
        if cfg.ingest_dtype != "complex64":
            raise NotImplementedError(
                f"ingest_dtype={cfg.ingest_dtype!r} is not ported yet "
                "(ROADMAP.md A.7, int8 ingest)")
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {cfg.device!r} requested but torch.cuda."
                "is_available() is False; ask for device='cpu' "
                "(--device cpu) to run on the CPU")
        self.fused = cfg.fused if fused is None else fused
        self.window = pfb_window(cfg.ntaps, cfg.nbins, cfg.window)
        self.window2d = self.window.reshape(cfg.ntaps, cfg.nbins)
        self.pairs = baseline_pairs(cfg.nchan, cfg.include_autos)
        self._kernel = _resolve_fused(self.fused, self.device, cfg.nbins,
                                      cfg.ntaps, cfg.nchan)
        self.step = make_fx_step(
            mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
            pairs=self.pairs, bandwidth=cfg.bandwidth,
            frequency=cfg.frequency, device=self.device,
            fused=self._kernel)
        self.calibrate = make_calibrator(bandwidth=cfg.bandwidth)

    @property
    def kernel_active(self) -> bool:
        """True when :attr:`step` runs the hand-written CUDA kernel."""
        return self._kernel

    def fresh_history(self) -> torch.Tensor:
        return zero_history((self.cfg.nchan,), self.cfg.nbins,
                            self.cfg.ntaps, self.device)

    def prepare_block(self, block: np.ndarray) -> torch.Tensor:
        """Host block ``[nch, num_samp]`` complex64 -> the step's device
        input.  The kernel route frames it on the host (a free reshape)
        into ``[nch, S, nbins]`` rows, dropping the tail samples."""
        block = np.ascontiguousarray(block, dtype=np.complex64)
        if self._kernel:
            s = block.shape[-1] // self.cfg.nbins
            block = block[..., : s * self.cfg.nbins].reshape(
                *block.shape[:-1], s, self.cfg.nbins)
        return torch.from_numpy(block).to(self.device)

    def calibrate_block(self, iq: torch.Tensor,
                        ncal: Optional[int] = None) -> torch.Tensor:
        """Delay calibration from a prepared single-block input: framed
        rows are flattened back to a sample axis and the leading ``ncal``
        samples feed the calibrator."""
        iq = iq.reshape(iq.shape[0], -1)
        if ncal:
            iq = iq[:, : min(ncal, iq.shape[-1])]
        return self.calibrate(iq)

    def example_inputs(self, seed: int = 0):
        """Representative ``(iq, delays, history)`` step inputs, made with
        numpy from ``seed`` exactly as ``fxtpu.fx.FxEngine.example_inputs``
        makes its complex64 ones."""
        rng = np.random.default_rng(seed)
        shape = (self.cfg.nchan, self.cfg.num_samp)
        iq = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
              ).astype(np.complex64)
        delays = torch.zeros(self.cfg.nchan, dtype=torch.float32,
                             device=self.device)
        return self.prepare_block(iq), delays, self.fresh_history()

    def import_fxtpu_state(self, window2d, pairs, history_re, history_im,
                           delays):
        """The JAX engine's parameters and state, as numpy arrays, in this
        engine's form: returns ``(history, delays)`` tensors on
        :attr:`device` so both packages can run from the same state.
        ``window2d`` and ``pairs`` must be the ones this engine built
        (checked): they are configuration, not state."""
        if not np.array_equal(np.asarray(pairs), self.pairs):
            raise ValueError("pairs differ from this engine's baselines")
        if not np.allclose(np.asarray(window2d, np.float64), self.window2d,
                           rtol=1e-6, atol=0.0):
            raise ValueError("window2d differs from this engine's window")
        hist = (np.asarray(history_re, np.float32)
                + 1j * np.asarray(history_im, np.float32)).astype(np.complex64)
        want = (self.cfg.nchan, self.cfg.ntaps - 1, self.cfg.nbins)
        if hist.shape != want:
            raise ValueError(f"history shape {hist.shape}, expected {want}")
        return (torch.from_numpy(hist).to(self.device),
                torch.as_tensor(np.asarray(delays, np.float32),
                                device=self.device))
