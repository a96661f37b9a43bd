"""Host -> mesh ingest: a block's samples split onto the shards.

Counterpart of ``fxtpu.parallel.ingest``.  A placed block is the dict
``{shard index: tensor}`` of this process's shards
(:mod:`~fxtpu_torch.parallel.collectives`), each shard's piece contiguous
on its device:

  * :func:`put_block`: the sample axis split by :func:`~fxtpu_torch.
    parallel.mesh.block_sharding` (the plain step's input); a leading K
    axis (a stacked batch ``[K, nch, ...]``) keeps the sample axis the
    split one;
  * :func:`put_frames`: the block framed into rows of ``nbins`` samples
    and the rows split (the fused step's input, ``[nch, S/n, nbins]``
    complex64 or ``[nch, S/n, nbins, 2]`` int8): the counterpart of
    ``fxtpu``'s ``put_packed`` for the port's 8-bit form, which is not
    packed.

The local block goes to this process's first device in one copy
(``stage``: the engine's pooled pinned buffers on a card) and is split
there, so shards on one card cost no host copy each.  Under several
processes ``block`` is this process's span of the global block
(:func:`local_sample_span`, what its feeder reads), and the shards of the
other processes are theirs to place.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from fxtpu_torch.parallel.mesh import CorrelatorMesh, block_sharding

__all__ = ["block_sharding", "put_block", "put_frames", "split",
           "local_sample_span"]


def _stage_plain(block: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(block).to(device)


def split(mesh: CorrelatorMesh, x: torch.Tensor, axis: int, spans,
          offset: int = 0) -> Dict[int, torch.Tensor]:
    """This process's shards of ``x`` along ``axis`` (``spans``: each
    shard's global ``[start, stop)``; ``x`` this process's part, starting
    at global position ``offset``), each a contiguous copy on its
    device."""
    out = {}
    for i in mesh.local:
        a, b = spans[i]
        piece = x.narrow(axis, a - offset, b - a)
        out[i] = piece.to(mesh.shards[i].device).contiguous()
    return out


def _local(block: np.ndarray) -> np.ndarray:
    if block.dtype == np.int8:
        return np.ascontiguousarray(block)
    return np.ascontiguousarray(block, dtype=np.complex64)


def put_block(block: np.ndarray, mesh: CorrelatorMesh,
              global_num_samp: Optional[int] = None, *, nbins: int = 1,
              stage: Optional[Callable] = None) -> Dict[int, torch.Tensor]:
    """Place one host block onto the mesh, its sample axis split into
    rows of ``nbins`` samples each shard (:func:`block_sharding`).

    ``block``: ``[nch, num_samp]`` complex64, or 8-bit ``[nch, num_samp,
    2]`` int8 (shipped as it is, a quarter of the bytes), with an optional
    leading K axis.  Under several processes it is this process's local
    span and ``global_num_samp`` names the global block length."""
    block = _local(block)
    axis = block.ndim - (2 if block.dtype == np.int8 else 1)
    num_samp = global_num_samp or block.shape[axis]
    spans = block_sharding(mesh, num_samp, nbins)
    offset = spans[mesh.local[0]][0] if mesh.process_count > 1 else 0
    x = (stage or _stage_plain)(block, mesh.home)
    return split(mesh, x, axis, spans, offset)


def put_frames(block: np.ndarray, mesh: CorrelatorMesh, nbins: int,
               global_num_samp: Optional[int] = None, *,
               stage: Optional[Callable] = None) -> Dict[int, torch.Tensor]:
    """Place one host block onto the mesh framed and frame-sharded: each
    shard gets its rows ``[nch, S/n, nbins]`` (``[nch, S/n, nbins, 2]``
    int8), the samples after the last whole row dropped, as the fused
    route frames a block.  Multi-process: ``block`` is the local span and
    ``global_num_samp`` the global length."""
    block = _local(block)
    num_samp = global_num_samp or block.shape[1]
    spans = block_sharding(mesh, num_samp, nbins)
    offset = spans[mesh.local[0]][0] if mesh.process_count > 1 else 0
    s = spans[mesh.local[-1]][1] // nbins - offset // nbins
    rows = block[:, : s * nbins].reshape(block.shape[0], s, nbins,
                                         *block.shape[2:])
    x = (stage or _stage_plain)(rows, mesh.home)
    row_spans = [(a // nbins, a // nbins + (spans[0][1] // nbins))
                 for a, _ in spans]
    return split(mesh, x, 1, row_spans, offset // nbins)


def local_sample_span(mesh: CorrelatorMesh, num_samp: int, nbins: int = 1):
    """The ``[start, stop)`` span of the global sample axis this process's
    shards own: what a multi-process feeder reads from its source.

    Requires this process's shards to be CONTIGUOUS in the linearized
    (time, freq) order (:func:`~fxtpu_torch.parallel.mesh.all_shards`
    lays them out so); raises otherwise, since a non-contiguous span
    cannot be expressed as one ``[start, stop)`` read."""
    idxs = mesh.local
    if idxs != list(range(idxs[0], idxs[-1] + 1)):
        raise ValueError(
            "this process's devices are not contiguous in the mesh's "
            f"linearized (time, freq) order: {idxs}; lay the mesh out so "
            "each host owns a contiguous run of shards")
    spans = block_sharding(mesh, num_samp, nbins)
    return spans[idxs[0]][0], spans[idxs[-1]][1]
