"""The mesh-sharded FX step.

Counterpart of ``fxtpu.parallel.sharded`` on the shards of a
:class:`~fxtpu_torch.parallel.mesh.CorrelatorMesh`, with the collectives
of :mod:`~fxtpu_torch.parallel.collectives`.  A block arrives placed
(:mod:`~fxtpu_torch.parallel.ingest`: ``{shard: tensor}``); the history,
the delays and the visibilities are whole tensors on every process's
home device (``fxtpu``'s replicated arrays).  Three steps:

  * **the fused frame-sharded step** (:func:`_make_fused_sharded_step`):
    each shard runs the single pass (``ops.fx_fused.fx_fused_parts`` or
    ``fx_fused_parts_i8``, the X stage the shape takes) on its local
    frames, behind the raw halo its left neighbour sends (shard 0 behind
    the stream's history); the parts are summed over the mesh, GJ from
    shard 0 alone (only its first frames reach into the previous block),
    the means averaged; one ``fx_finish`` corrects and rotates the sums
    with the window's constants for the whole block.  No corner turn;
  * **the block-parallel K-block step** (:func:`_make_fused_sharded_multi`):
    each shard takes K/n whole blocks of a merged batch and runs the
    single-device engine's K-block entry on them; its history is the
    previous shard's last block's rows (computed from the raw input, so
    no shard waits on another), and the last shard's history is the
    batch's;
  * **the plain step** (:func:`make_sharded_fx_step` with the fused route
    off): DC removal over the block's mean, the FIR and FFT (``torch.fft``)
    on the local frames behind the halo, the rotation, the corner turn
    (``all_to_all`` over ``freq`` to bin-sharded spectra), the X stage
    and a ``psum`` over ``time``, in plain torch as ``fxtpu``'s XLA path.

Every shard's single pass launches the kernels the single-device engine
launches (on the CPU their plain versions), each counted on its wrapper.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from fxtpu_torch.fx import _resolve_fused, _svd_mode, make_fx_multi_step
from fxtpu_torch.ops.dc_posthoc import dc_constants
from fxtpu_torch.ops.fx_epilogue import FinishTables, fx_finish
from fxtpu_torch.ops.fx_fused import (block_mean_i8, fx_fused_parts,
                                      fx_fused_parts_i8, pairs_tensor,
                                      x_route)
from fxtpu_torch.ops.pfb import dequantize, spectrometer_rows
from fxtpu_torch.ops.xengine import continuum_reduce, fstc_rotate
from fxtpu_torch.parallel.collectives import (all_to_all, chain, gather,
                                              groups, ppermute, psum)
from fxtpu_torch.parallel.mesh import (FREQ_AXIS, TIME_AXIS,
                                       CorrelatorMesh, validate_shapes)

__all__ = ["make_sharded_fx_step", "make_sharded_fx_multi_step"]


class _OnDevice:
    """The step's constants on each device its shards use, made at the
    first use of the device."""

    def __init__(self, build):
        self._build = build
        self._made = {}

    def __call__(self, device):
        device = torch.device(device)
        if device not in self._made:
            self._made[device] = self._build(device)
        return self._made[device]


def _constants(window2d, pairs, nbins: int, s_rows: int, svd_applies):
    """Per-device window, pairs, the DC constants for blocks of ``s_rows``
    frames and the SVD factors (None for the direct tap loop)."""
    nch = int(pairs.max()) + 1

    def build(device):
        svd = _svd_mode(window2d, nbins, device) if svd_applies else None
        return types.SimpleNamespace(
            w=torch.as_tensor(np.asarray(window2d, np.float32),
                              device=device),
            pairs=pairs_tensor(pairs, nch, device),
            dc=dc_constants(window2d, nbins, s_rows, device, svd), svd=svd)

    return _OnDevice(build)


def _home(mesh: CorrelatorMesh, values: dict) -> torch.Tensor:
    """A collective's result at this process's home shard."""
    return values[mesh.local[0]].to(mesh.home)


def _last_only(mesh: CorrelatorMesh, values: dict) -> dict:
    """The last shard's tensor, zeros on every other shard: summed over
    the mesh, the last shard's tensor on every process."""
    last = mesh.size - 1
    return {i: v if i == last else torch.zeros_like(v)
            for i, v in values.items()}


def _make_fused_sharded_step(*, mode: str, nbins: int, window2d, pairs,
                             bandwidth: float, frequency: float,
                             mesh: CorrelatorMesh, num_samp: int,
                             quant_step: float, int8: bool, svd_applies,
                             rank: int):
    """The frame-sharded fused step (module docstring): ``step(iq
    {shard: [nch, S/n, nbins(, 2)]}, delays [nch(, 2)], history) ->
    (vis, new_history)`` with the single-device fused step's history
    contract: the DC-corrected tail, or for 8-bit samples the raw tail
    ``{"tail", "mu_prev"}``.

    The window's constants are those of the whole block (``S`` frames):
    the parts' ``dA`` does not depend on S, and the one correction after
    the sums needs the block's ``cs``.  The new history is the last
    shard's raw rows less the block's mean (the mean of the shards'
    equal-sized means), or under 8 bits those rows as they are and the
    mean."""
    n = mesh.size
    s_rows = num_samp // nbins
    ntaps = window2d.shape[0]
    halo = ntaps - 1
    continuum = mode in ("CONTINUUM", "TEST")
    pairs = np.asarray(pairs)
    nch = int(pairs.max()) + 1
    consts = _constants(window2d, pairs, nbins, s_rows, svd_applies)
    route = x_route(nbins, ntaps, nch, rank)
    tables = FinishTables(pairs, nbins, bandwidth, frequency, mesh.home)

    def step(iq: dict, delays, history):
        tails = {i: x[:, -halo:] for i, x in iq.items()}
        recv = ppermute(mesh, tails, chain(n))
        first = history["tail"] if int8 else history
        xp, t, gj, mu = {}, {}, {}, {}
        for i, x in iq.items():
            c = consts(x.device)
            prev = first.to(x.device) if i == 0 else recv[i]
            if int8:
                out = fx_fused_parts_i8(x[:, None], prev, c.w, c.pairs,
                                        quant_step, c.svd, c.dc,
                                        x_stage=route)
            else:
                out = fx_fused_parts(x[:, None], prev, c.w, c.pairs, c.svd,
                                     c.dc, x_stage=route)
            xp[i], t[i], g, mu[i], _ = out
            gj[i] = g if i == 0 else torch.zeros_like(g)
        xp_g, t_g, gj_g, mu_g, tail = (
            _home(mesh, psum(mesh, v))
            for v in (xp, t, gj, mu, _last_only(mesh, tails)))
        mu_g = mu_g / n
        c = consts(mesh.home)
        delays = torch.as_tensor(delays, device=mesh.home)
        vis = fx_finish(xp_g, t_g, gj_g, mu_g, c.pairs, c.dc, delays[None],
                        tables, s_rows, bandwidth, continuum,
                        history["mu_prev"] if int8 else None)
        if int8:
            # a copy: on a mesh of one shard the sum is the block's own rows
            tail = tail.clone(memory_format=torch.contiguous_format)
            return vis[0], {"tail": tail, "mu_prev": mu_g[0]}
        return vis[0], tail - mu_g[0][:, None, None]

    step.fused_kernel = True
    step.int8_native = int8
    step.mesh = mesh
    return step


def _make_fused_sharded_multi(*, mode: str, nbins: int, window2d, pairs,
                              bandwidth: float, frequency: float,
                              mesh: CorrelatorMesh, num_samp: int,
                              quant_step: float, int8: bool, svd_applies):
    """The block-parallel K-block step (module docstring): ``multi(iq
    {shard: [nch, K/n, S, nbins(, 2)]}, delays [K, nch(, 2)], history) ->
    (vis [K, ...], new_history)``, the history contract of the per-block
    step, so whole batches and single steps mix in one run."""
    n = mesh.size
    halo = window2d.shape[0] - 1
    consts = _constants(window2d, np.asarray(pairs), nbins,
                        num_samp // nbins, svd_applies)
    per_shard = {
        i: make_fx_multi_step(
            mode=mode, nbins=nbins, window2d=window2d, pairs=pairs,
            bandwidth=bandwidth, frequency=frequency,
            device=mesh.shards[i].device, fused=True, quant_step=quant_step,
            svd=consts(mesh.shards[i].device).svd)
        for i in mesh.local}

    def multi(iq: dict, delays, history):
        k_loc = next(iter(iq.values())).shape[1]
        if int8:
            tails = {i: x[:, -1, -halo:] for i, x in iq.items()}
            mus = {i: block_mean_i8(x[:, -1], quant_step)
                   for i, x in iq.items()}
            recv_mu = ppermute(mesh, mus, chain(n))
        else:
            tails = {i: x[:, -1, -halo:]
                     - x[:, -1].mean(dim=(-2, -1))[:, None, None]
                     for i, x in iq.items()}
        recv = ppermute(mesh, tails, chain(n))
        delays = torch.as_tensor(delays, device=mesh.home)
        vis, hist = {}, {}
        for i, x in iq.items():
            dev = x.device
            if i == 0:
                prev = ({k: v.to(dev) for k, v in history.items()} if int8
                        else history.to(dev))
            else:
                prev = ({"tail": recv[i], "mu_prev": recv_mu[i]} if int8
                        else recv[i])
            vis[i], hist[i] = per_shard[i](
                x, delays[i * k_loc:(i + 1) * k_loc].to(dev), prev)
        if int8:
            new = {k: _home(mesh, psum(mesh, _last_only(
                mesh, {i: h[k] for i, h in hist.items()})))
                for k in ("tail", "mu_prev")}
        else:
            new = _home(mesh, psum(mesh, _last_only(mesh, hist)))
        return torch.cat(gather(mesh, vis, range(n))), new

    multi.fused_kernel = True
    multi.int8_native = int8
    multi.merged_input = True
    multi.mesh = mesh
    return multi


def _make_plain_sharded_step(*, mode: str, nbins: int, window2d, pairs,
                             bandwidth: float, frequency: float,
                             mesh: CorrelatorMesh, num_samp: int,
                             quant_step: float):
    """The plain step with the corner turn (module docstring): ``step(iq
    {shard: [nch, span(, 2)]}, delays, history) -> (vis, new_history)``,
    the single-device plain step's contract."""
    t_sz, f_sz = mesh.shape[TIME_AXIS], mesh.shape[FREQ_AXIS]
    n = mesh.size
    s_loc = num_samp // nbins // n
    halo = window2d.shape[0] - 1
    continuum = mode in ("CONTINUUM", "TEST")
    pairs = np.asarray(pairs)
    index = _OnDevice(lambda d: torch.as_tensor(pairs.T, dtype=torch.long,
                                                device=d))
    window = _OnDevice(lambda d: torch.as_tensor(
        np.asarray(window2d, np.float32), device=d))
    # the shift of the bin-sharded output: with an even number of freq
    # shards, shard f takes shard f + F/2's bins as they are
    shift = [(row[(j + f_sz // 2) % f_sz], row[j])
             for row in groups(mesh, FREQ_AXIS) for j in range(f_sz)]
    shift_sharded = f_sz > 1 and f_sz % 2 == 0

    def step(iq: dict, delays, history):
        x = {i: dequantize(v, quant_step) if v.dtype == torch.int8 else v
             for i, v in iq.items()}
        total = psum(mesh, {i: v.sum(dim=-1) for i, v in x.items()})
        rows = {i: (v[:, : s_loc * nbins] - total[i][:, None] / num_samp
                    ).reshape(v.shape[0], s_loc, nbins)
                for i, v in x.items()}
        if halo > 0:
            tails = {i: r[:, -halo:] for i, r in rows.items()}
            recv = ppermute(mesh, tails, chain(n))
            new_hist = _home(mesh, psum(mesh, _last_only(mesh, tails)))
        else:
            recv, new_hist = {}, history
        spec = {}
        for i, r in rows.items():
            prev = history.to(r.device) if i == 0 else recv.get(i)
            s, _ = spectrometer_rows(r, window(r.device), prev)
            spec[i] = fstc_rotate(s, delays, bandwidth, frequency)
        if f_sz > 1:
            spec = all_to_all(mesh, spec, split_dim=2, concat_dim=1)
        acc = {}
        for i, s in spec.items():
            p, q = index(s.device)
            acc[i] = (s[p] * s[q].conj()).mean(dim=-2)
        if t_sz > 1:
            acc = {i: v / t_sz for i, v in psum(mesh, acc, TIME_AXIS).items()}
        if shift_sharded and not continuum:
            acc = ppermute(mesh, acc, shift)
        vis = torch.cat(gather(mesh, acc, groups(mesh, FREQ_AXIS)[0]), dim=-1)
        if continuum:
            return continuum_reduce(vis, bandwidth), new_hist
        if not shift_sharded:
            vis = torch.fft.fftshift(vis, dim=-1)
        return vis, new_hist

    step.fused_kernel = False
    step.int8_native = False
    step.mesh = mesh
    return step


def _route(*, nbins, window2d, pairs, mesh, num_samp, fused, int8_ingest):
    """(fused, svd applies, rank) of a sharded engine, decided on the
    shard's own block of S/n frames (``fxtpu``'s ``_resolve_fused`` on
    the local shape)."""
    ntaps = int(window2d.shape[0])
    validate_shapes(num_samp, nbins, mesh, ntaps)
    s_loc = num_samp // nbins // mesh.size
    nch = int(np.asarray(pairs).max()) + 1
    svd = _svd_mode(window2d, nbins, "cpu")
    rank = 0 if svd is None else svd[0].shape[1]
    use = _resolve_fused(fused, mesh.home, nbins, ntaps, nch,
                         int8=int8_ingest, s_rows=s_loc, rank=rank)
    return use, svd is not None, rank if use else 0


def make_sharded_fx_step(*, mode: str, nbins: int, window2d: np.ndarray,
                         pairs: np.ndarray, bandwidth: float,
                         frequency: float, mesh: CorrelatorMesh,
                         num_samp: int, fused="auto",
                         quant_step: float = 1.0 / 32,
                         int8_ingest: bool = False):
    """The sharded per-block step ``(iq, delays [nch(, 2)], history) ->
    (vis, new_history)``; ``vis`` is ``[nbl, nbins]`` (SPECTRUM) or
    ``[nbl]`` (CONTINUUM/TEST), fftshifted, as the single-device step's.

    ``fused`` as for :class:`~fxtpu_torch.fx.FxEngine`, decided on the
    shard's S/n frames: the fused frame-sharded step where the single
    pass takes that shape (``iq`` from ``ingest.put_frames``; 8-bit
    samples reach it as they are), the plain step with the corner turn
    otherwise (``iq`` from ``ingest.put_block``).  The step's
    ``fused_kernel`` and ``int8_native`` report the route."""
    use, svd_applies, rank = _route(
        nbins=nbins, window2d=window2d, pairs=pairs, mesh=mesh,
        num_samp=num_samp, fused=fused, int8_ingest=int8_ingest)
    kw = dict(mode=mode, nbins=nbins, window2d=window2d, pairs=pairs,
              bandwidth=bandwidth, frequency=frequency, mesh=mesh,
              num_samp=num_samp, quant_step=quant_step)
    if use:
        return _make_fused_sharded_step(int8=int8_ingest,
                                        svd_applies=svd_applies, rank=rank,
                                        **kw)
    return _make_plain_sharded_step(**kw)


def make_sharded_fx_multi_step(*, mode: str, nbins: int,
                               window2d: np.ndarray, pairs: np.ndarray,
                               bandwidth: float, frequency: float,
                               mesh: CorrelatorMesh, num_samp: int,
                               fused="auto", quant_step: float = 1.0 / 32,
                               int8_ingest: bool = False):
    """The sharded K-blocks-per-call step ``multi(iq, delays [K, nch(,
    2)], history) -> (vis [K, ...], new_history)``, on the route the
    per-block step takes (their histories must agree: whole batches and
    single steps mix in one run).  Fused: the block-parallel dispatch of
    :func:`_make_fused_sharded_multi` (``iq`` the merged batch split by
    blocks, K a multiple of the shard count); plain: the per-block step
    over the stacked ``[K, nch, span]`` shards in turn (any K)."""
    use, svd_applies, _ = _route(
        nbins=nbins, window2d=window2d, pairs=pairs, mesh=mesh,
        num_samp=num_samp, fused=fused, int8_ingest=int8_ingest)
    kw = dict(mode=mode, nbins=nbins, window2d=window2d, pairs=pairs,
              bandwidth=bandwidth, frequency=frequency, mesh=mesh,
              num_samp=num_samp, quant_step=quant_step)
    if use:
        return _make_fused_sharded_multi(int8=int8_ingest,
                                         svd_applies=svd_applies, **kw)
    step = _make_plain_sharded_step(**kw)

    def multi(iq: dict, delays, history):
        vis = []
        for k in range(next(iter(iq.values())).shape[0]):
            v, history = step({i: x[k] for i, x in iq.items()}, delays[k],
                              history)
            vis.append(v)
        return torch.stack(vis), history

    multi.fused_kernel = False
    multi.int8_native = False
    multi.merged_input = False
    multi.mesh = mesh
    return multi
