"""The per-block FX step and the delay calibrator, in PyTorch.

Counterpart of ``fxtpu.fx``.  Two routes with one contract, chosen once
per engine (``_resolve_fused``, like ``fxtpu.fx._resolve_fused``):

  * the fused route: the block arrives pre-framed, ``[nch, S, nbins]``
    complex64 or ``[nch, S, nbins, 2]`` int8; the fused step
    (:func:`~fxtpu_torch.ops.fx_fused.fx_fused_raw`, or
    :func:`~fxtpu_torch.ops.fx_fused.fx_fused_raw_i8` with the raw-tail
    history of 8-bit ingest) returns the raw frame-summed cross power,
    and :func:`_finish` applies the FSTC rotation, ``1/n_frames``, the
    fftshift and the continuum reduction on the tiny ``[nbl, nbins]``
    result (the rotation commutes with the frame sum).  On a CUDA device
    the fused step is the hand-written kernel; on the CPU its plain
    version, as ``fxtpu`` runs its Pallas kernel in interpret mode there.
    Its FIR runs in one of two modes, chosen once with the route: through
    the window's rank-r factors where the window factorises
    (``ops.svd_fir.deep_svd_applies``: 16 taps or more, as
    ``fxtpu.fx.make_fx_step`` chooses its SVD-FIR kernel), the direct tap
    loop everywhere else;
  * the plain route: dequantization of 8-bit samples, DC removal, the
    streaming spectrometer (``torch.fft``), the rotation per frame, the
    frame mean and the shift, all in plain torch (``fxtpu``'s
    ``fused=False`` path).

``step(iq, delays, history) -> (vis, new_history)``: ``vis`` is
``[nbl, nbins]`` fftshifted cross-power spectra (SPECTRUM) or ``[nbl]``
scalars (CONTINUUM/TEST); ``delays`` is ``[nch]`` seconds or the packed
``[nch, 2]`` form of :func:`~fxtpu_torch.ops.xengine.pack_delays`.

``multi_step(iq, delays, history) -> (vis [K, ...], new_history)`` takes
K blocks per call (``fxtpu.fx.make_fx_multi_step``), as
:meth:`FxEngine.prepare_batch` stages them, with per-block delays ``[K,
nch]`` or ``[K, nch, 2]``: on the fused route one K-block launch of the
fused step, on the plain route the plain step over the blocks in turn;
either way K chained single steps bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.ops.delay import estimate_delay
from fxtpu_torch.ops.fx_fused import (fx_fused_raw, fx_fused_raw_i8,
                                      fx_fused_raw_i8_multi,
                                      fx_fused_raw_multi, max_blocks,
                                      pairs_tensor, supported, supported_i8,
                                      svd_tensors)
from fxtpu_torch.ops.pfb import (dc_remove, dequantize, spectrometer,
                                 zero_history)
from fxtpu_torch.ops.svd_fir import deep_svd_applies
from fxtpu_torch.ops.window import pfb_window
from fxtpu_torch.ops.xengine import (baseline_pairs, continuum_reduce,
                                     fstc_rotate, rf_freqs, rotation_phase,
                                     split_delays, xcorr_baselines)
from fxtpu_torch.runtime.native import quantize_c64

__all__ = ["make_fx_step", "make_fx_multi_step", "make_calibrator",
           "dc_remove", "FxEngine"]


def _resolve_fused(fused, device: torch.device, nbins: int, ntaps: int,
                   nch: int, *, int8: bool = False, s_rows: int = 0,
                   rank: int = 0) -> bool:
    """The route, decided once per engine.  'auto' -> the fused route on a
    CUDA device for every shape its kernel takes, plain torch otherwise;
    True -> the fused route on any device (the kernel on a CUDA device,
    its plain version on the CPU), raising for a shape the kernel does
    not take; False -> plain torch.  ``int8`` asks about the int8 kernel,
    which also needs ``s_rows`` (see ``fx_fused.supported_i8``); ``rank``
    is the SVD-FIR mode's rank (0: the direct tap loop)."""
    shape = f"nbins={nbins}, ntaps={ntaps}, nch={nch}, rank={rank}"
    if int8:
        takes = supported_i8(nbins, ntaps, nch, s_rows, rank)
        check = "supported_i8"
        shape += f", S={s_rows}"
    else:
        takes, check = supported(nbins, ntaps, nch, rank), "supported"
    if fused == "auto":
        return device.type == "cuda" and takes
    if fused is True:
        if not takes:
            raise ValueError(
                f"fused=True: the CUDA FX kernel does not take {shape} "
                f"(see fxtpu_torch.ops.fx_fused.{check})")
        return True
    if fused is False:
        return False
    raise ValueError(f"fused must be 'auto', True or False, got {fused!r}")


def _svd_mode(window2d, nbins: int, device):
    """The fused step's FIR mode for this window, in both ingests: its
    factors ``(u, v)`` on ``device`` where it factorises
    (``deep_svd_applies``, the choice ``fxtpu.fx.make_fx_step`` makes), or
    None for the direct tap loop."""
    if not deep_svd_applies(window2d, nbins):
        return None
    return svd_tensors(window2d, device)


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
    """Raw frame-summed cross power ``[nbl, nbins]``, or ``[K, nbl,
    nbins]`` with delays ``[K, nch(, 2)]`` per block -> the visibility
    (``fxtpu.fx._finish_fused``): ``vis[p,q] = xp[p,q] rot_p conj(rot_q) /
    n_frames`` with ``rot_c = exp(+2 pi j f d_c)``, fftshift, and the
    continuum reduction."""
    d, frac = split_delays(delays, xp.ndim - 1)
    dd = d[..., tables.p] - d[..., tables.q]                 # [..., nbl]
    if frac is not None:
        phase = rotation_phase(tables.fbase, dd,
                               frac[..., tables.p] - frac[..., tables.q])
    else:
        phase = rotation_phase(tables.frf, dd, None)
    rot = torch.complex(torch.cos(phase), torch.sin(phase))
    vis = torch.fft.fftshift(xp * rot / n_frames, dim=-1)
    return continuum_reduce(vis, bandwidth) if continuum else vis


def make_fx_step(*, mode: str, nbins: int, window2d: np.ndarray,
                 pairs: np.ndarray, bandwidth: float, frequency: float,
                 device, fused: bool, quant_step: float = 1.0 / 32,
                 svd=None):
    """Build the per-block step on ``device``.  ``fused=True`` takes the
    fused route on framed input: :func:`fx_fused_raw` for complex64
    ``[nch, S, nbins]`` blocks with a tensor history,
    :func:`fx_fused_raw_i8` for int8 ``[nch, S, nbins, 2]`` blocks with
    the raw-tail dict history (each the CUDA kernel for CUDA tensors, its
    plain version for CPU tensors), in the FIR mode ``svd``: None for the
    direct tap loop, or the window's factors ``(u, v)`` on ``device``
    (``fx_fused.svd_tensors``).  ``fused=False`` takes the plain route
    on ``[nch, num_samp]`` complex64 or ``[nch, num_samp, 2]`` int8
    samples.  8-bit samples are ``q * quant_step`` in real units."""
    device = torch.device(device)
    continuum = mode in ("CONTINUUM", "TEST")
    w = torch.as_tensor(np.asarray(window2d, np.float32), device=device)

    if fused:
        pairs_dev, tables = _fused_tables(pairs, nbins, bandwidth, frequency,
                                          device)

        def fused_step(iq, delays, history):
            if isinstance(history, dict):
                xp, new_history = fx_fused_raw_i8(iq, history, w, pairs_dev,
                                                  quant_step, svd)
            else:
                xp, new_history = fx_fused_raw(iq, history, w, pairs_dev,
                                               svd)
            vis = _finish(xp, delays, tables, iq.shape[1], bandwidth,
                          continuum)
            return vis, new_history

        return fused_step

    pairs_idx = torch.as_tensor(np.asarray(pairs), dtype=torch.long,
                                device=device)

    def step(iq, delays, history):
        if iq.dtype == torch.int8:
            iq = dequantize(iq, quant_step)
        spec, new_history = spectrometer(dc_remove(iq), w, nbins, history)
        spec = fstc_rotate(spec, delays, bandwidth, frequency)
        vis = xcorr_baselines(spec, pairs_idx)
        if continuum:
            vis = continuum_reduce(vis, bandwidth)
        return vis, new_history

    return step


def _fused_tables(pairs, nbins: int, bandwidth: float, frequency: float,
                  device):
    """The fused route's pairs on ``device`` and :class:`_FinishTables`."""
    pairs = np.asarray(pairs)
    return (pairs_tensor(pairs, int(pairs.max()) + 1, device),
            _FinishTables(pairs, nbins, bandwidth, frequency, device))


def make_fx_multi_step(*, mode: str, nbins: int, window2d: np.ndarray,
                       pairs: np.ndarray, bandwidth: float, frequency: float,
                       device, fused: bool, quant_step: float = 1.0 / 32,
                       svd=None):
    """Build the K-blocks-per-call step on ``device`` (``fxtpu.fx.
    make_fx_multi_step``): ``multi(iq, delays [K, nch(, 2)], history) ->
    (vis [K, ...], new_history)``, identical to K chained steps of
    :func:`make_fx_step` with the same arguments.  ``fused=True``: ``iq``
    is the merged ``[nch, K, S, nbins]`` complex64 or ``[nch, K, S, nbins,
    2]`` int8 batch and the K blocks go through one
    :func:`fx_fused_raw_multi` / :func:`fx_fused_raw_i8_multi` call, then
    one :func:`_finish` over all K; ``fused=False``: ``iq`` is the stacked
    ``[K, nch, num_samp(, 2)]`` batch and the plain step runs over the
    blocks in turn (the counterpart of ``fxtpu``'s ``lax.scan``)."""
    if not fused:
        step = make_fx_step(mode=mode, nbins=nbins, window2d=window2d,
                            pairs=pairs, bandwidth=bandwidth,
                            frequency=frequency, device=device, fused=False,
                            quant_step=quant_step)

        def multi(iq, delays, history):
            vis = []
            for k in range(iq.shape[0]):
                v, history = step(iq[k], delays[k], history)
                vis.append(v)
            return torch.stack(vis), history

        return multi

    device = torch.device(device)
    continuum = mode in ("CONTINUUM", "TEST")
    w = torch.as_tensor(np.asarray(window2d, np.float32), device=device)
    pairs_dev, tables = _fused_tables(pairs, nbins, bandwidth, frequency,
                                      device)

    def multi_fused(iq, delays, history):
        if isinstance(history, dict):
            xp, new_history = fx_fused_raw_i8_multi(iq, history, w, pairs_dev,
                                                    quant_step, svd)
        else:
            xp, new_history = fx_fused_raw_multi(iq, history, w, pairs_dev,
                                                 svd)
        vis = _finish(xp, delays, tables, iq.shape[2], bandwidth, continuum)
        return vis, new_history

    return multi_fused


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


def _complex64(pair) -> np.ndarray:
    """``fxtpu``'s ``(re, im)`` float32 planes -> complex64."""
    re, im = (np.asarray(p, np.float32) for p in pair)
    return (re + 1j * im).astype(np.complex64)


def _unpack_i8_words(words) -> np.ndarray:
    """``fxtpu``'s packed int32 words ``[..., nbins//4]`` -> int8
    ``[..., nbins]``: byte k of word L (low byte first) is bin
    ``k*(nbins//4) + L``, the inverse of ``pack_int8_planes``."""
    w = np.ascontiguousarray(np.asarray(words), dtype="<i4")
    b = w.view(np.int8).reshape(*w.shape, 4)           # [..., L, k]
    return np.ascontiguousarray(np.swapaxes(b, -1, -2)).reshape(
        *w.shape[:-1], 4 * w.shape[-1])


class FxEngine:
    """Window + pairs + step + calibrator for one config, on
    ``cfg.device``.  The route is decided once, here: :attr:`fused_active`
    reports it, :attr:`kernel_active` whether it runs a CUDA kernel,
    :attr:`int8_native` whether 8-bit samples reach the fused step as
    they are, and :attr:`fir_mode` which FIR the step runs."""

    def __init__(self, cfg: CorrelatorConfig, fused=None):
        self.cfg = cfg
        self.device = torch.device(cfg.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {cfg.device!r} requested but torch.cuda."
                "is_available() is False; ask for device='cpu' "
                "(--device cpu) to run on the CPU")
        self.fused = cfg.fused if fused is None else fused
        self._int8 = cfg.ingest_dtype == "int8"
        self.window = pfb_window(cfg.ntaps, cfg.nbins, cfg.window)
        self.window2d = self.window.reshape(cfg.ntaps, cfg.nbins)
        self.pairs = baseline_pairs(cfg.nchan, cfg.include_autos)
        svd = _svd_mode(self.window2d, cfg.nbins, self.device)
        self._fused = _resolve_fused(
            self.fused, self.device, cfg.nbins, cfg.ntaps, cfg.nchan,
            int8=self._int8, s_rows=cfg.num_samp // cfg.nbins,
            rank=0 if svd is None else svd[0].shape[1])
        self._svd = svd if self._fused else None
        self.step = make_fx_step(
            mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
            pairs=self.pairs, bandwidth=cfg.bandwidth,
            frequency=cfg.frequency, device=self.device,
            fused=self._fused, quant_step=cfg.quant_step, svd=self._svd)
        self.calibrate = make_calibrator(bandwidth=cfg.bandwidth)
        self._multi_step = None

    @property
    def multi_step(self):
        """The K-blocks-per-call step (:func:`make_fx_multi_step` on this
        engine's route and FIR mode), built at first use: feed it what
        :meth:`prepare_batch` returns."""
        if self._multi_step is None:
            cfg = self.cfg
            self._multi_step = make_fx_multi_step(
                mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
                pairs=self.pairs, bandwidth=cfg.bandwidth,
                frequency=cfg.frequency, device=self.device,
                fused=self._fused, quant_step=cfg.quant_step, svd=self._svd)
        return self._multi_step

    @property
    def batch_merged(self) -> bool:
        """True when :meth:`prepare_batch` stages the merged ``[nch, K, S,
        nbins(, 2)]`` layout (block 0 on the second axis), the fused
        route's; the plain route stacks ``[K, nch, ...]``."""
        return self._fused

    def dispatch_batch_for(self, requested: int) -> int:
        """The largest K <= ``requested`` blocks per :attr:`multi_step`
        call this engine takes (``fxtpu.fx.FxEngine.dispatch_batch_for``
        without a mesh), 1 for ``requested <= 1``: any K on the plain
        route; on the fused route at most what one kernel launch takes at
        this shape (``ops.fx_fused.max_blocks``)."""
        if requested <= 1:
            return 1
        if not self._fused:
            return requested
        cfg = self.cfg
        most = max_blocks(
            cfg.num_samp // cfg.nbins, cfg.nbins, cfg.ntaps, cfg.nchan,
            0 if self._svd is None else self._svd[0].shape[1],
            len(self.pairs))
        return max(1, min(requested, most))

    @property
    def fused_active(self) -> bool:
        """True when :attr:`step` takes the fused route."""
        return self._fused

    @property
    def kernel_active(self) -> bool:
        """True when :attr:`step` launches a hand-written CUDA kernel: the
        fused route on a CUDA device."""
        return self._fused and self.device.type == "cuda"

    @property
    def fir_mode(self) -> str:
        """``"svd"`` when the fused step runs its FIR through the window's
        rank-r factors, ``"direct"`` when it runs the tap loop over the
        window (the plain route always does)."""
        return "direct" if self._svd is None else "svd"

    @property
    def int8_native(self) -> bool:
        """True when 8-bit samples reach the fused step as they arrived,
        with the raw-tail history ``{"tail", "mu_prev"}``
        (``fxtpu.fx.FxEngine.int8_native``)."""
        return self._int8 and self._fused

    def fresh_history(self):
        """The history at stream start: on the int8-native route a raw
        tail of zeros and ``mu_prev = 0``, otherwise the zero DC-corrected
        tail ``[nch, ntaps-1, nbins]``."""
        cfg = self.cfg
        if self.int8_native:
            return {
                "tail": torch.zeros((cfg.nchan, cfg.ntaps - 1, cfg.nbins, 2),
                                    dtype=torch.int8, device=self.device),
                "mu_prev": torch.zeros((cfg.nchan,), dtype=torch.complex64,
                                       device=self.device),
            }
        return zero_history((cfg.nchan,), cfg.nbins, cfg.ntaps, self.device)

    def prepare_block(self, block: np.ndarray) -> torch.Tensor:
        """Host block -> the step's device input: complex64 ``[nch,
        num_samp]``, or int8 ``[nch, num_samp, 2]`` (I, Q) shipped as it
        is (a quarter of the bytes; the plain route dequantizes on the
        device).  An int8 engine handed complex samples quantizes them
        here at ``quant_step`` first.  The fused route frames the block on
        the host (a free reshape) into ``[nch, S, nbins]`` rows (``[nch,
        S, nbins, 2]`` for int8), dropping the tail samples."""
        if self._int8 and np.iscomplexobj(block):
            block = quantize_c64(np.ascontiguousarray(block, np.complex64),
                                 self.cfg.quant_step)
        block = np.ascontiguousarray(
            block, np.int8 if block.dtype == np.int8 else np.complex64)
        if self._fused:
            nch, nbins = block.shape[0], self.cfg.nbins
            s = block.shape[1] // nbins
            block = block[:, : s * nbins].reshape(nch, s, nbins,
                                                  *block.shape[2:])
        return torch.from_numpy(block).to(self.device)

    def batch_host_buffer(self, k: int) -> torch.Tensor:
        """An empty host tensor that holds a batch of ``k`` blocks in
        :meth:`prepare_batch`'s layout: pinned on a CUDA engine (raising
        if the memory cannot be pinned), plain memory otherwise."""
        cfg = self.cfg
        iq = (2,) if self._int8 else ()
        if self._fused:
            shape = (cfg.nchan, k, cfg.num_samp // cfg.nbins, cfg.nbins, *iq)
        else:
            shape = (k, cfg.nchan, cfg.num_samp, *iq)
        dtype = torch.int8 if self._int8 else torch.complex64
        if self.device.type != "cuda":
            return torch.empty(shape, dtype=dtype)
        host = torch.empty(shape, dtype=dtype, pin_memory=True)
        if not host.is_pinned():
            raise RuntimeError("the batch's host buffer could not be pinned")
        return host

    def prepare_batch(self, blocks, host: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
        """K host blocks -> the input of one :attr:`multi_step` call
        (``fxtpu.fx.FxEngine.prepare_batch``).  ``blocks``: K arrays
        ``[nch, num_samp]`` complex64, or int8 ``[nch, num_samp, 2]`` for
        an int8 engine (complex ones are quantized at ``quant_step``
        first).  The fused route stages the merged ``[nch, K, S, nbins(,
        2)]`` layout, each block framed with its tail samples dropped; the
        plain route stacks ``[K, nch, num_samp(, 2)]``.

        The blocks are copied into ``host`` (from
        :meth:`batch_host_buffer`; a new one when None).  On a CUDA engine
        that buffer is pinned and goes to the card with one
        ``non_blocking`` copy on the current stream: the caller keeps
        ``host`` untouched until that copy has completed (``runtime.
        stager`` records an event after it).  On the CPU the buffer is
        the batch."""
        blocks = list(blocks)
        if host is None:
            host = self.batch_host_buffer(len(blocks))
        out = host.numpy()
        cfg = self.cfg
        s_rows = cfg.num_samp // cfg.nbins
        for j, block in enumerate(blocks):
            if self._int8 and np.iscomplexobj(block):
                block = quantize_c64(np.ascontiguousarray(block, np.complex64),
                                     cfg.quant_step)
            if self._fused:
                block = block[:, : s_rows * cfg.nbins].reshape(
                    cfg.nchan, s_rows, cfg.nbins, *block.shape[2:])
                np.copyto(out[:, j], block)
            else:
                np.copyto(out[j], block)
        if self.device.type != "cuda":
            return host
        return host.to(self.device, non_blocking=True)

    def calibrate_block(self, iq: torch.Tensor,
                        ncal: Optional[int] = None) -> torch.Tensor:
        """Delay calibration from a prepared single-block input: 8-bit
        samples become complex64 with no scale (the estimator is
        scale-invariant), framed rows are flattened back to a sample axis
        and the leading ``ncal`` samples feed the calibrator."""
        if iq.dtype == torch.int8:
            iq = torch.view_as_complex(iq.float())
        iq = iq.reshape(iq.shape[0], -1)
        if ncal:
            iq = iq[:, : min(ncal, iq.shape[-1])]
        return self.calibrate(iq)

    def example_inputs(self, seed: int = 0):
        """Representative ``(iq, delays, history)`` step inputs, made with
        numpy from ``seed`` exactly as ``fxtpu.fx.FxEngine.example_inputs``
        makes them: int8 blocks for an int8 engine, complex64 otherwise."""
        rng = np.random.default_rng(seed)
        shape = (self.cfg.nchan, self.cfg.num_samp)
        if self._int8:
            iq = rng.integers(-127, 128, size=(*shape, 2)).astype(np.int8)
        else:
            iq = (rng.normal(size=shape) + 1j * rng.normal(size=shape)
                  ).astype(np.complex64)
        delays = torch.zeros(self.cfg.nchan, dtype=torch.float32,
                             device=self.device)
        return self.prepare_block(iq), delays, self.fresh_history()

    def import_fxtpu_state(self, window2d, pairs, history, delays):
        """The JAX engine's parameters and state, as numpy arrays, in this
        engine's form: returns ``(history, delays)`` on :attr:`device` so
        both packages can run from the same state.  ``history`` is
        ``fxtpu``'s, a ``(re, im)`` pair (its ``Cplx``) of the corrected
        tail, or on the int8-native route its dict ``{"tail": (re, im)
        packed int32 words, "mu_prev": (re, im)}``, whose words are
        unpacked into this engine's int8 ``[nch, ntaps-1, nbins, 2]``
        tail.  ``window2d`` and ``pairs`` must be the ones this engine
        built (checked): they are configuration, not state."""
        if not np.array_equal(np.asarray(pairs), self.pairs):
            raise ValueError("pairs differ from this engine's baselines")
        if not np.allclose(np.asarray(window2d, np.float64), self.window2d,
                           rtol=1e-6, atol=0.0):
            raise ValueError("window2d differs from this engine's window")
        cfg = self.cfg
        tail_shape = (cfg.nchan, cfg.ntaps - 1, cfg.nbins)
        if isinstance(history, dict) != self.int8_native:
            raise ValueError(
                "the raw-tail dict history belongs to the int8-native "
                "route, a (re, im) history to every other "
                f"(this engine: int8_native={self.int8_native})")
        if self.int8_native:
            tail = np.stack([_unpack_i8_words(p) for p in history["tail"]],
                            axis=-1)
            if tail.shape != (*tail_shape, 2):
                raise ValueError(f"tail shape {tail.shape[:-1]}, expected "
                                 f"{tail_shape}")
            mu = _complex64(history["mu_prev"])
            if mu.shape != (cfg.nchan,):
                raise ValueError(f"mu_prev shape {mu.shape}, expected "
                                 f"{(cfg.nchan,)}")
            hist = {"tail": torch.from_numpy(tail).to(self.device),
                    "mu_prev": torch.from_numpy(mu).to(self.device)}
        else:
            h = _complex64(history)
            if h.shape != tail_shape:
                raise ValueError(f"history shape {h.shape}, expected "
                                 f"{tail_shape}")
            hist = torch.from_numpy(h).to(self.device)
        return hist, torch.as_tensor(np.asarray(delays, np.float32),
                                     device=self.device)
