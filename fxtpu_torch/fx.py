"""The per-block FX step and the delay calibrator, in PyTorch.

Counterpart of ``fxtpu.fx``.  Two routes with one contract, chosen once
per engine (``_resolve_fused``, like ``fxtpu.fx._resolve_fused``):

  * the fused route: the block arrives pre-framed, ``[nch, S, nbins]``
    complex64 or ``[nch, S, nbins, 2]`` int8, and goes through
    :func:`~fxtpu_torch.ops.fx_epilogue.fx_fused_step`, the single pass
    ``fxtpu``'s fused route takes: the kernel reads the samples once as
    they arrived and returns the raw frame-summed cross power with the
    DC accumulators (``ops.fx_fused.fx_fused_parts`` /
    ``fx_fused_parts_i8``, the latter with the raw-tail history of 8-bit
    ingest), and one epilogue (``ops.fx_epilogue.fx_finish``) removes the
    means after the fact and applies the FSTC rotation, ``1/n_frames``,
    the fftshift and the continuum reduction on the tiny ``[nbl, nbins]``
    result (the rotation commutes with the frame sum): three kernel
    launches a step, for 2 to 512 channels (where a frame's spectra of
    all channels do not fit in one cluster's shared memory, and always
    past 64 channels, the single pass takes its wide route,
    ``FxEngine.x_stage`` ``"global"``).  (The
    two-pass wrappers ``ops.fx_fused.fx_fused_raw*`` with
    ``ops.fx_epilogue.finish`` compute the same step with a mean pre-pass
    and an exact DC bin; nothing here calls them.)  On a CUDA device
    each step is hand-written kernels; on the CPU their plain versions,
    as ``fxtpu`` runs its Pallas kernel in interpret mode there.
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

With a mesh (``FxEngine(cfg, mesh=...)``) the step and the K-block call
are ``parallel.sharded``'s over the mesh's shards, on the same routes.

``multi_step(iq, delays, history) -> (vis [K, ...], new_history)`` takes
K blocks per call (``fxtpu.fx.make_fx_multi_step``), as
:meth:`FxEngine.prepare_batch` stages them, with per-block delays ``[K,
nch]`` or ``[K, nch, 2]``: on the fused route one K-block launch of the
fused step, on the plain route the plain step over the blocks in turn.
The plain route is K chained single steps bit for bit; the fused route
corrects blocks after the first for the raw rows of the block before
(``dc_correct``'s ``mu_prev`` terms) and agrees with K chained steps
within ``fxtpu``'s own bound for that, 1e-5 of max|vis|.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

import numpy as np
import torch

from fxtpu_torch.config import CorrelatorConfig
from fxtpu_torch.ops import fx_epilogue, fx_fused
from fxtpu_torch.ops.dc_posthoc import dc_constants
from fxtpu_torch.ops.delay import estimate_delay
from fxtpu_torch.ops.fx_epilogue import FinishTables, fx_fused_step
from fxtpu_torch.ops.fx_fused import (max_blocks_parts, pairs_tensor,
                                      supported_parts, svd_tensors, x_route)
from fxtpu_torch.ops.fx_xstage import fx_xstage
from fxtpu_torch.ops.pfb import (dc_remove, dequantize, spectrometer,
                                 zero_history)
from fxtpu_torch.ops.svd_fir import deep_svd_applies
from fxtpu_torch.ops.window import pfb_window
from fxtpu_torch.ops.xengine import (baseline_pairs, continuum_reduce,
                                     fstc_rotate, xcorr_baselines)
from fxtpu_torch.runtime.native import quantize_c64, require_native

__all__ = ["make_fx_step", "make_fx_multi_step", "make_calibrator",
           "dc_remove", "FxEngine"]

logger = logging.getLogger(__name__)


def _resolve_fused(fused, device: torch.device, nbins: int, ntaps: int,
                   nch: int, *, int8: bool = False,
                   s_rows: Optional[int] = None, rank: int = 0) -> bool:
    """The route, decided once per engine.  'auto' -> the fused route on a
    CUDA device for every shape its single pass takes
    (``fx_fused.supported_parts``: up to 512 channels, the X stage in
    shared memory up to 64 or through device memory), plain torch
    otherwise, with
    a warning on a CUDA device; True -> the fused route on any device (the
    kernels on a CUDA device, their plain versions on the CPU), raising
    for a shape the kernels do not take; False -> plain torch.  ``int8``
    names the ingest in the messages; ``s_rows`` is the block's rows
    (None: at least the ntaps-1 the single pass needs, which a complex64
    engine's blocks always hold, the config's bound); ``rank`` is the
    SVD-FIR mode's rank (0: the direct tap loop)."""
    rows = ntaps - 1 if s_rows is None else s_rows
    shape = (f"nbins={nbins}, ntaps={ntaps}, nch={nch}, S={rows}, "
             f"rank={rank}")
    takes = supported_parts(nbins, ntaps, nch, rows, rank)
    check = "fxtpu_torch.ops.fx_fused.supported_parts"
    if fused == "auto":
        if device.type == "cuda" and not takes:
            logger.warning(
                "fused='auto' takes the plain torch route on %s: the "
                "%s single-pass kernels do not take %s (%s: nbins a "
                "multiple of 128 from 256 to 16384, fxtpu's _kernel_factor "
                "rule, where fxtpu runs XLA too; up to 512 channels; a "
                "block of at least ntaps-1 rows)", device,
                "int8" if int8 else "complex64", shape, check)
        return device.type == "cuda" and takes
    if fused is True:
        if not takes:
            raise ValueError(
                f"fused=True: the CUDA FX kernel does not take {shape} "
                f"(see {check})")
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


def make_fx_step(*, mode: str, nbins: int, window2d: np.ndarray,
                 pairs: np.ndarray, bandwidth: float, frequency: float,
                 device, fused: bool, quant_step: float = 1.0 / 32,
                 svd=None):
    """Build the per-block step on ``device``.  ``fused=True`` takes the
    fused route on framed input, complex64 ``[nch, S, nbins]`` blocks
    with a tensor history or int8 ``[nch, S, nbins, 2]`` blocks with the
    raw-tail dict history, through :func:`fx_fused_step` (the single pass
    and its epilogue: the CUDA kernels for CUDA tensors, the plain
    versions for CPU tensors; blocks of S >= ntaps-1 rows), in the FIR
    mode ``svd``: None for the direct tap loop, or the window's factors
    ``(u, v)`` on ``device`` (``fx_fused.svd_tensors``).  ``fused=False``
    takes the plain route on ``[nch, num_samp]`` complex64 or ``[nch,
    num_samp, 2]`` int8 samples.  8-bit samples are ``q * quant_step`` in
    real units."""
    if fused:
        multi = make_fx_multi_step(
            mode=mode, nbins=nbins, window2d=window2d, pairs=pairs,
            bandwidth=bandwidth, frequency=frequency, device=device,
            fused=True, quant_step=quant_step, svd=svd)

        def fused_step(iq, delays, history):
            vis, new_history = multi(iq[:, None], delays[None], history)
            return vis[0], new_history

        return fused_step

    device = torch.device(device)
    continuum = mode in ("CONTINUUM", "TEST")
    w = torch.as_tensor(np.asarray(window2d, np.float32), device=device)
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


def make_fx_multi_step(*, mode: str, nbins: int, window2d: np.ndarray,
                       pairs: np.ndarray, bandwidth: float, frequency: float,
                       device, fused: bool, quant_step: float = 1.0 / 32,
                       svd=None):
    """Build the K-blocks-per-call step on ``device`` (``fxtpu.fx.
    make_fx_multi_step``): ``multi(iq, delays [K, nch(, 2)], history) ->
    (vis [K, ...], new_history)``, K chained steps of :func:`make_fx_step`
    with the same arguments (the fused route within rounding, see the
    module docstring).  ``fused=True``: ``iq`` is the merged ``[nch, K,
    S, nbins]`` complex64 or ``[nch, K, S, nbins, 2]`` int8 batch and the
    K blocks go through one :func:`fx_fused_step` call, with the window's
    DC constants formed once per block length S and kept on the device,
    and the step's scratch kept across calls (its ``pool``);
    ``fused=False``: ``iq`` is the stacked ``[K, nch, num_samp(, 2)]``
    batch and the plain step runs over the blocks in turn (the
    counterpart of ``fxtpu``'s ``lax.scan``)."""
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
    pairs = np.asarray(pairs)
    pairs_dev = pairs_tensor(pairs, int(pairs.max()) + 1, device)
    tables = FinishTables(pairs, nbins, bandwidth, frequency, device)
    consts, pool = {}, {}

    def multi_fused(iq, delays, history):
        s_rows = iq.shape[2]
        if s_rows not in consts:
            consts[s_rows] = dc_constants(window2d, nbins, s_rows, device,
                                          svd)
        return fx_fused_step(iq, history, w, pairs_dev, consts[s_rows],
                             delays, tables, bandwidth, continuum,
                             quant_step, svd, pool=pool)

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


class _PinnedBlocks:
    """Pinned host buffers for single blocks on their way to the card:
    ``depth`` per block shape, handed out in turn, each written again only
    after the copy that last read it has completed (its event), the
    discipline of ``runtime.stager``.  One staging at a time: the main
    loop and the stager's thread (its tail blocks) may both come here."""

    def __init__(self, depth: int = 3):
        self.depth = depth
        self._pools = {}
        self._lock = threading.Lock()

    def stage(self, block: np.ndarray, device: torch.device) -> torch.Tensor:
        """``block`` on ``device``, through the next pinned buffer of its
        shape, by one ``non_blocking`` copy on the current stream."""
        with self._lock:
            slots, turn = self._pools.setdefault(
                (block.shape, block.dtype.str), ([], [0]))
            if len(slots) < self.depth:
                host = torch.empty(
                    block.shape, pin_memory=True,
                    dtype=torch.from_numpy(block[:0].reshape(-1)).dtype)
                if not host.is_pinned():
                    raise RuntimeError(
                        "the block's host buffer could not be pinned")
                slots.append([host, None])
            host, copied = slot = slots[turn[0] % self.depth]
            turn[0] += 1
            if copied is not None:
                copied.synchronize()
            # torch's copy runs on its intra-op threads; numpy's copyto on
            # one, several times slower for a block of tens of MiB
            # (chip_smoke.py times both; PERF.md)
            host.copy_(torch.from_numpy(block))
            dev = host.to(device, non_blocking=True)
            slot[1] = torch.cuda.Event()
            slot[1].record(torch.cuda.current_stream(device))
            return dev


class FxEngine:
    """Window + pairs + step + calibrator for one config, on
    ``cfg.device``.  The route is decided once, here: :attr:`fused_active`
    reports it, :attr:`kernel_active` whether it runs a CUDA kernel,
    :attr:`int8_native` whether 8-bit samples reach the fused step as
    they are, :attr:`fir_mode` which FIR the step runs and
    :attr:`x_stage` where its single pass forms the cross power (the
    shared-memory route where the spectra of all channels fit, the wide
    route elsewhere: ``fx_fused.x_route``)."""

    def __init__(self, cfg: CorrelatorConfig, fused=None, mesh=None):
        self.cfg = cfg
        #: The :class:`~fxtpu_torch.parallel.mesh.CorrelatorMesh` the step
        #: is sharded over (None: one device); then :attr:`device` is the
        #: mesh's home device, where history, delays and visibilities live.
        self.mesh = mesh
        self.device = torch.device(cfg.device) if mesh is None else mesh.home
        if self.device.type != torch.device(cfg.device).type:
            raise ValueError(f"the mesh's shards are on {self.device}, the "
                             f"config asks for device {cfg.device!r}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {cfg.device!r} requested but torch.cuda."
                "is_available() is False; ask for device='cpu' "
                "(--device cpu) to run on the CPU")
        self.fused = cfg.fused if fused is None else fused
        self._int8 = cfg.ingest_dtype == "int8"
        if self._int8:
            require_native(self.device, "the int8 engine's quantizer")
        self.window = pfb_window(cfg.ntaps, cfg.nbins, cfg.window)
        self.window2d = self.window.reshape(cfg.ntaps, cfg.nbins)
        self.pairs = baseline_pairs(cfg.nchan, cfg.include_autos)
        svd = _svd_mode(self.window2d, cfg.nbins, self.device)
        self._pinned = _PinnedBlocks()
        if mesh is None:
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
        else:
            from fxtpu_torch.parallel.sharded import make_sharded_fx_step
            self.step = make_sharded_fx_step(
                **self._sharded_kw(), fused=self.fused)
            self._fused = self.step.fused_kernel
            self._svd = svd if self._fused else None
        self._x_stage = (x_route(cfg.nbins, cfg.ntaps, cfg.nchan,
                                 self._rank())
                         if self._fused else None)
        self.calibrate = make_calibrator(bandwidth=cfg.bandwidth)
        self._multi_step = None

    def _sharded_kw(self) -> dict:
        cfg = self.cfg
        return dict(mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
                    pairs=self.pairs, bandwidth=cfg.bandwidth,
                    frequency=cfg.frequency, mesh=self.mesh,
                    num_samp=cfg.num_samp, quant_step=cfg.quant_step,
                    int8_ingest=self._int8)

    @property
    def multi_step(self):
        """The K-blocks-per-call step (:func:`make_fx_multi_step` on this
        engine's route and FIR mode; with a mesh ``parallel.sharded.
        make_sharded_fx_multi_step``), built at first use: feed it what
        :meth:`prepare_batch` returns."""
        if self._multi_step is None:
            cfg = self.cfg
            if self.mesh is not None:
                from fxtpu_torch.parallel.sharded import (
                    make_sharded_fx_multi_step)
                self._multi_step = make_sharded_fx_multi_step(
                    **self._sharded_kw(), fused=self._fused)
            else:
                self._multi_step = make_fx_multi_step(
                    mode=cfg.mode, nbins=cfg.nbins, window2d=self.window2d,
                    pairs=self.pairs, bandwidth=cfg.bandwidth,
                    frequency=cfg.frequency, device=self.device,
                    fused=self._fused, quant_step=cfg.quant_step,
                    svd=self._svd)
        return self._multi_step

    def _rank(self) -> int:
        """The fused step's SVD rank (0: the direct tap loop)."""
        return 0 if self._svd is None else self._svd[0].shape[1]

    @property
    def batch_merged(self) -> bool:
        """True when :meth:`prepare_batch` stages the merged ``[nch, K, S,
        nbins(, 2)]`` layout (block 0 on the second axis), the fused
        route's; the plain route stacks ``[K, nch, ...]``."""
        return self._fused

    def dispatch_batch_for(self, requested: int) -> int:
        """The largest K <= ``requested`` blocks per :attr:`multi_step`
        call this engine takes (``fxtpu.fx.FxEngine.dispatch_batch_for``),
        1 for ``requested <= 1``: any K on the plain route; on the fused
        route at most what one kernel launch takes at this shape on its X
        stage (``ops.fx_fused.max_blocks_parts``: the partials, or on the
        wide route the spectra scratch).  With a mesh: 1 under several
        processes (their feeders read per-block sample spans); on the
        fused route a multiple of the shard count (each shard takes K/n
        whole blocks), 1 below one block a shard."""
        if requested <= 1:
            return 1
        if self.mesh is not None and self.mesh.process_count > 1:
            return 1
        if not self._fused:
            return requested
        cfg = self.cfg
        most = max_blocks_parts(cfg.num_samp // cfg.nbins, cfg.nbins,
                                cfg.nchan, len(self.pairs), ntaps=cfg.ntaps,
                                rank=self._rank(), x_stage=self._x_stage)
        if self.mesh is None:
            return max(1, min(requested, most))
        n = self.mesh.size
        k = min(requested, most * n) // n * n
        return k if k > 1 else 1

    @property
    def fused_active(self) -> bool:
        """True when :attr:`step` takes the fused route."""
        return self._fused

    @property
    def kernel_active(self) -> bool:
        """True when :attr:`step` launches a hand-written CUDA kernel: the
        fused route on a CUDA device."""
        return self._fused and self.device.type == "cuda"

    def launch_counts(self) -> dict:
        """Every launch counter this engine's fused route moves
        (``fx_fused.count_launches``; process-wide since import or the last
        reset; empty on the plain route): the single pass's frame kernel
        in this engine's ingest and FIR mode (on the wide route
        ``name.wide_launches`` or ``.wide_svd_launches``), the reduce
        ``parts_reduce`` or the X kernel's ``fx_xstage``, ``.ctas``,
        ``.spectra_reads`` (the CTAs that stage each bin tile's spectra,
        summed over launches) and ``.tiled`` (launches of its register-tiled
        instances), at deep taps
        ``fir_rows`` and last the epilogue ``fx_finish``, with
        ``fx_finish.tiled`` where the epilogue's plan takes its pair-tiled
        instance at this engine's shape and mode
        (``fx_epilogue.finish_plan``)."""
        if not self._fused:
            return {}
        name = "fx_fused_parts_i8" if self._int8 else "fx_fused_parts"
        frames = getattr(fx_fused, name)
        attr = "launches" if self._svd is None else "svd_launches"
        if self._x_stage == "global":
            attr = "wide_" + attr
            counts = {f"{name}.{attr}": getattr(frames, attr),
                      "fx_xstage": fx_xstage.launches,
                      "fx_xstage.ctas": fx_xstage.ctas,
                      "fx_xstage.spectra_reads": fx_xstage.spectra_reads,
                      "fx_xstage.tiled": fx_xstage.tiled}
        else:
            counts = {name: getattr(frames, attr),
                      "parts_reduce": fx_fused.parts_reduce.launches}
        if fx_fused.deep_fir(self.cfg.ntaps,
                             self.cfg.num_samp // self.cfg.nbins):
            counts["fir_rows"] = fx_fused.fir_rows.launches
        counts["fx_finish"] = fx_epilogue.fx_finish.launches
        if fx_epilogue.finish_plan(
                self.cfg.nchan, len(self.pairs), self.cfg.nbins, 1,
                self.cfg.mode in ("CONTINUUM", "TEST")).tiled:
            counts["fx_finish.tiled"] = fx_epilogue.fx_finish.tiled
        return counts

    @property
    def x_stage(self) -> Optional[str]:
        """Where the fused step's single pass forms the cross power:
        ``"shared"`` (every channel's spectrum of a frame in one cluster's
        shared memory), ``"global"`` (the wide route: the spectra through
        device memory to the X kernel), None on the plain route."""
        return self._x_stage

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
        S, nbins, 2]`` for int8), dropping the tail samples.  On a CUDA
        engine the block goes through a pooled pinned buffer and one
        ``non_blocking`` copy on the current stream (raising if the
        memory cannot be pinned), so the host does not wait for the card;
        work queued on that stream afterwards sees the whole block.

        With a mesh the block is placed on its shards (``parallel.ingest``:
        ``put_frames`` on the fused route, ``put_block`` on the plain one;
        ``{shard: tensor}``), after one copy to the home device; under
        several processes ``block`` is this process's sample span."""
        if self._int8 and np.iscomplexobj(block):
            block = quantize_c64(np.ascontiguousarray(block, np.complex64),
                                 self.cfg.quant_step)
        block = np.ascontiguousarray(
            block, np.int8 if block.dtype == np.int8 else np.complex64)
        if self.mesh is not None:
            from fxtpu_torch.parallel.ingest import put_block, put_frames
            stage = (self._pinned.stage if self.device.type == "cuda"
                     else None)
            total = (self.cfg.num_samp if self.mesh.process_count > 1
                     else None)
            if self._fused:
                return put_frames(block, self.mesh, self.cfg.nbins, total,
                                  stage=stage)
            return put_block(block, self.mesh, total, nbins=self.cfg.nbins,
                             stage=stage)
        if self._fused:
            nch, nbins = block.shape[0], self.cfg.nbins
            s = block.shape[1] // nbins
            block = block[:, : s * nbins].reshape(nch, s, nbins,
                                                  *block.shape[2:])
        if self.device.type != "cuda":
            return torch.from_numpy(block)
        return self._pinned.stage(block, self.device)

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
        the batch.  With a mesh the batch is then split on the home
        device, ``{shard: tensor}``: on the fused route K/n whole blocks a
        shard (K a multiple of the shard count), on the plain route the
        sample axis (``parallel.ingest.split``)."""
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
        if self.device.type == "cuda":
            host = host.to(self.device, non_blocking=True)
        if self.mesh is None:
            return host
        return self._split_batch(host, len(blocks))

    def _split_batch(self, x: torch.Tensor, k: int) -> dict:
        """A whole batch on the home device -> its shards."""
        from fxtpu_torch.parallel.ingest import block_sharding, split
        mesh = self.mesh
        if mesh.process_count > 1:
            raise ValueError("a K-block batch needs the whole blocks in one "
                             "process (dispatch_batch_for is 1 under "
                             "several processes)")
        if not self._fused:
            spans = block_sharding(mesh, self.cfg.num_samp, self.cfg.nbins)
            return split(mesh, x, 2, spans)
        n = mesh.size
        if k % n:
            raise ValueError(
                f"the sharded multi_step needs K % {n} == 0, got K={k} "
                "(FxEngine.dispatch_batch_for rounds the batch down)")
        per = k // n
        return split(mesh, x, 1, [(i * per, (i + 1) * per) for i in range(n)])

    def calibrate_block(self, iq: torch.Tensor,
                        ncal: Optional[int] = None) -> torch.Tensor:
        """Delay calibration from a prepared single-block input: 8-bit
        samples become complex64 with no scale (the estimator is
        scale-invariant), framed rows are flattened back to a sample axis
        and the leading ``ncal`` samples feed the calibrator.  A mesh
        engine's block is first gathered from the shards that hold those
        samples (from other processes too), so every process calibrates
        on the same samples and gets the same delays."""
        if isinstance(iq, dict):
            iq = self._gather_leading(iq, ncal)
        if iq.dtype == torch.int8:
            iq = torch.view_as_complex(iq.float())
        iq = iq.reshape(iq.shape[0], -1)
        if ncal:
            iq = iq[:, : min(ncal, iq.shape[-1])]
        return self.calibrate(iq)

    def _gather_leading(self, iq: dict, ncal: Optional[int]) -> torch.Tensor:
        """The leading samples of a sharded block, whole shards up to the
        first that holds sample ``ncal``, each shard's whole rows only
        (every shard's piece then has one shape)."""
        from fxtpu_torch.parallel.collectives import gather
        from fxtpu_torch.parallel.mesh import block_sharding
        cfg = self.cfg
        spans = block_sharding(self.mesh, cfg.num_samp, cfg.nbins)
        per = spans[0][1]
        tail = (2,) if self._int8 else ()
        rows = {i: x.reshape(x.shape[0], -1, *tail)[:, :per]
                for i, x in iq.items()}
        need = len(spans) if not ncal else min(len(spans), -(-ncal // per))
        return torch.cat(gather(self.mesh, rows, range(need)), dim=1)

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

    def restore_history(self, history):
        """A history on the host in this engine's layout (a snapshot's,
        ``runtime.checkpoint.load_state``) -> this engine's history on
        :attr:`device`: complex64 ``[nch, ntaps-1, nbins]`` (the corrected
        tail), or on the int8-native route ``{"tail": int8 [nch, ntaps-1,
        nbins, 2], "mu_prev": complex64 [nch]}``.  Raises when its form or
        shape is not this engine's."""
        cfg = self.cfg
        tail_shape = (cfg.nchan, cfg.ntaps - 1, cfg.nbins)
        if isinstance(history, dict) != self.int8_native:
            raise ValueError(
                "the raw-tail dict history belongs to the int8-native "
                "route, a complex history to every other "
                f"(this engine: int8_native={self.int8_native})")
        if self.int8_native:
            tail = np.ascontiguousarray(history["tail"], np.int8)
            mu = np.ascontiguousarray(history["mu_prev"], np.complex64)
            if tail.shape != (*tail_shape, 2) or mu.shape != (cfg.nchan,):
                raise ValueError(
                    f"tail {tail.shape} and mu_prev {mu.shape}, expected "
                    f"{(*tail_shape, 2)} and {(cfg.nchan,)}")
            return {"tail": torch.from_numpy(tail).to(self.device),
                    "mu_prev": torch.from_numpy(mu).to(self.device)}
        h = np.ascontiguousarray(history, np.complex64)
        if h.shape != tail_shape:
            raise ValueError(f"history shape {h.shape}, expected "
                             f"{tail_shape}")
        return torch.from_numpy(h).to(self.device)

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
        if isinstance(history, dict):
            history = {"tail": np.stack([_unpack_i8_words(p)
                                         for p in history["tail"]], axis=-1),
                       "mu_prev": _complex64(history["mu_prev"])}
        else:
            history = _complex64(history)
        hist = self.restore_history(history)
        return hist, torch.as_tensor(np.asarray(delays, np.float32),
                                     device=self.device)
