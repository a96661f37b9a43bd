"""Collectives over the shards of a :class:`~fxtpu_torch.parallel.mesh.
CorrelatorMesh`: the port's counterparts of ``lax.ppermute``,
``lax.psum``, ``lax.all_to_all`` and the replication of ``fxtpu``'s
``_replicate_out`` (an all-gather).

A collective takes the values of this process's shards as a dict
``{shard index: tensor}`` (every shard's tensor of one shape and type,
as under ``shard_map``) and returns the same for the result.  Within a
process the local shards' tensors are combined by explicit torch ops in
a fixed order (shard index, then rank), so a result does not depend on
which process ran first; across processes the pieces travel by
``torch.distributed`` point-to-point messages.  Under ``gloo``, which
takes CPU tensors only, a CUDA tensor is staged through pinned host
memory in explicit code here, and the staged bytes are counted on the
mesh (:attr:`CorrelatorMesh.staged_bytes`).

Every call adds its payload to ``mesh.volume`` under ``fxtpu``'s HLO op
names (``fxtpu.parallel.accounting``): the bytes of one shard's result,
as ``fxtpu`` counts a collective's result shape in the per-device
program.  A collective over groups of one shard moves nothing and counts
nothing, as XLA elides it.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from fxtpu_torch.parallel.mesh import (AXES, FREQ_AXIS, OPS, TIME_AXIS,
                                       CorrelatorMesh)

__all__ = ["OPS", "groups", "ppermute", "psum", "all_to_all", "gather",
           "chain"]

Values = Dict[int, torch.Tensor]


def groups(mesh: CorrelatorMesh, axis) -> List[List[int]]:
    """The shard groups a collective over ``axis`` runs within: one group
    of every shard for the linearized :data:`AXES`, a column of equal
    ``freq`` index for ``time``, a row of equal ``time`` index for
    ``freq``."""
    t, f = mesh.shape[TIME_AXIS], mesh.shape[FREQ_AXIS]
    if axis == AXES:
        return [list(range(t * f))]
    if axis == TIME_AXIS:
        return [[ti * f + fi for ti in range(t)] for fi in range(f)]
    if axis == FREQ_AXIS:
        return [[ti * f + fi for fi in range(f)] for ti in range(t)]
    raise ValueError(f"unknown mesh axis {axis!r}")


def chain(n: int) -> List[Tuple[int, int]]:
    """The halo's permutation, shard i to shard i+1."""
    return [(i, i + 1) for i in range(n - 1)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _any(values: Values) -> torch.Tensor:
    """One local shard's tensor: every shard's has the same shape and
    type."""
    return next(iter(values.values()))


def _exchange(mesh: CorrelatorMesh, sends, recvs) -> list:
    """Point-to-point messages between processes: ``sends`` of
    ``(tensor, dst rank, tag)``, ``recvs`` of ``(shape, dtype, src rank,
    tag, device)``; returns the received tensors in order, each on its
    device.  Under ``gloo`` CUDA tensors go through pinned host buffers."""
    stage = mesh.backend == "gloo"
    ops, wires, out = [], [], []
    for t, dst, tag in sends:
        t = t.contiguous()
        if stage and t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            mesh.staged_bytes += _nbytes(t)
            t = host
        wires.append(t)
        ops.append(dist.isend(t, dst, tag=tag))
    for shape, dtype, src, tag, device in recvs:
        on_card = torch.device(device).type == "cuda"
        if stage and on_card:
            buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        else:
            buf = torch.empty(shape, dtype=dtype, device=device)
        ops.append(dist.irecv(buf, src, tag=tag))
        out.append(buf)
    for op in ops:
        op.wait()
    for j, (shape, dtype, src, tag, device) in enumerate(recvs):
        if out[j].device != torch.device(device):
            mesh.staged_bytes += _nbytes(out[j])
            out[j] = out[j].to(device)
    return out


def _tag(mesh: CorrelatorMesh, src: int, dst: int) -> int:
    return src * mesh.size + dst


def ppermute(mesh: CorrelatorMesh, values: Values,
             perm: Sequence[Tuple[int, int]]) -> Values:
    """Send shard ``src``'s tensor to shard ``dst`` for each ``(src,
    dst)`` of ``perm``; returns ``{dst: tensor}`` for this process's
    destinations (contiguous, on the destination's device).  Counted as
    ``collective-permute``."""
    perm = list(perm)
    if not perm:
        return {}
    ref = _any(values)
    mesh.volume["collective-permute"] += _nbytes(ref)
    me = mesh.process_index
    out, sends, recvs, dsts = {}, [], [], []
    for src, dst in perm:
        s_rank, d_rank = mesh.shards[src].rank, mesh.shards[dst].rank
        if s_rank == me and d_rank == me:
            out[dst] = values[src].to(mesh.shards[dst].device).contiguous()
        elif s_rank == me:
            sends.append((values[src], d_rank, _tag(mesh, src, dst)))
        elif d_rank == me:
            recvs.append((ref.shape, ref.dtype, s_rank, _tag(mesh, src, dst),
                          mesh.shards[dst].device))
            dsts.append(dst)
    if sends or recvs:
        for dst, t in zip(dsts, _exchange(mesh, sends, recvs)):
            out[dst] = t
    return out


def psum(mesh: CorrelatorMesh, values: Values, axis=AXES) -> Values:
    """The sum over each group of ``axis`` (:func:`groups`), handed to
    every local shard of the group on its device.  The local shards'
    tensors are added in shard order; where a group spans processes each
    sends its partial sum to the others and every process adds the
    partials in rank order, so all hold the same bits.  Counted as
    ``all-reduce``."""
    ref = _any(values)
    me = mesh.process_index
    out = {}
    for group in groups(mesh, axis):
        mine = [i for i in group if i in values]
        if not mine:
            continue
        acc = values[mine[0]]
        for i in mine[1:]:
            acc = acc + values[i].to(acc.device)
        ranks = sorted({mesh.shards[i].rank for i in group})
        if len(ranks) > 1:
            others = [r for r in ranks if r != me]
            tag = _tag(mesh, group[0], group[-1])
            got = _exchange(
                mesh, [(acc, r, tag) for r in others],
                [(ref.shape, ref.dtype, r, tag, acc.device)
                 for r in others])
            parts = dict(zip(others, got))
            parts[me] = acc
            acc = parts[ranks[0]]
            for r in ranks[1:]:
                acc = acc + parts[r]
        for i in mine:
            out[i] = acc.to(mesh.shards[i].device)
    if len(groups(mesh, axis)[0]) > 1:
        mesh.volume["all-reduce"] += _nbytes(ref)
    return out


def all_to_all(mesh: CorrelatorMesh, values: Values, split_dim: int,
               concat_dim: int) -> Values:
    """``lax.all_to_all`` over ``freq``, tiled: shard ``(t, f)`` splits
    its tensor into ``mesh_freq`` chunks along ``split_dim`` and sends
    chunk g to shard ``(t, g)``, which concatenates what it receives
    along ``concat_dim`` in the senders' ``freq`` order.  Counted as
    ``all-to-all`` (one shard's result, as large as its input)."""
    f = mesh.shape[FREQ_AXIS]
    ref = _any(values)
    mesh.volume["all-to-all"] += _nbytes(ref)
    me = mesh.process_index
    chunks = {i: torch.chunk(v, f, dim=split_dim) for i, v in values.items()}
    shape = list(ref.shape)
    shape[split_dim] //= f
    pieces, sends, recvs, keys = {}, [], [], []
    for row in groups(mesh, FREQ_AXIS):
        for g, dst in enumerate(row):
            for s, src in enumerate(row):
                s_rank, d_rank = mesh.shards[src].rank, mesh.shards[dst].rank
                if s_rank == me and d_rank == me:
                    pieces[dst, s] = chunks[src][g].to(
                        mesh.shards[dst].device)
                elif s_rank == me:
                    sends.append((chunks[src][g], d_rank,
                                  _tag(mesh, src, dst)))
                elif d_rank == me:
                    recvs.append((tuple(shape), ref.dtype, s_rank,
                                  _tag(mesh, src, dst),
                                  mesh.shards[dst].device))
                    keys.append((dst, s))
    if sends or recvs:
        for key, t in zip(keys, _exchange(mesh, sends, recvs)):
            pieces[key] = t
    return {i: torch.cat([pieces[i, s] for s in range(f)], dim=concat_dim)
            for i in values}


def gather(mesh: CorrelatorMesh, values: Values,
           which: Sequence[int]) -> List[torch.Tensor]:
    """The tensors of the shards ``which`` (any process's), in that order,
    on every process at its :attr:`~CorrelatorMesh.home` device: local
    ones moved there, others sent by their owners to every other process.
    Counted as ``all-gather`` (the gathered bytes) where a piece crosses
    processes; within one process it moves nothing between processes and
    counts nothing."""
    ref = _any(values)
    me, home = mesh.process_index, mesh.home
    out, sends, recvs, slots = [None] * len(which), [], [], []
    for j, i in enumerate(which):
        owner = mesh.shards[i].rank
        tag = _tag(mesh, i, i)
        if owner == me:
            out[j] = values[i].to(home)
            sends += [(values[i], r, tag) for r in range(mesh.process_count)
                      if r != me]
        else:
            recvs.append((ref.shape, ref.dtype, owner, tag, home))
            slots.append(j)
    if mesh.process_count > 1:
        mesh.volume["all-gather"] += _nbytes(ref) * len(which)
        for j, t in zip(slots, _exchange(mesh, sends, recvs)):
            out[j] = t
    return out
