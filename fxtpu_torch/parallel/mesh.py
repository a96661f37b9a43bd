"""The correlator's ``(time, freq)`` mesh of shards, on ``torch.distributed``.

Counterpart of ``fxtpu.parallel.mesh``.  ``fxtpu``'s mesh is a grid of
JAX devices; here it is a grid of **shards**, each a ``(process rank,
torch.device)`` pair (:class:`Shard`).  Devices may repeat: eight shards
on ``cpu`` are what the tests use in place of ``fxtpu``'s eight virtual
CPU devices, four on ``cuda:0`` a four-shard mesh on one card.  The two
axes keep their meaning:

  * ``time``: frame sharding, the data-parallel analog; the integration
    across time shards is a ``psum``;
  * ``freq``: bin sharding, the tensor-parallel analog; the plain step
    turns its spectra from frame-sharded to bin-sharded with an
    ``all_to_all`` over ``freq`` (the corner turn).

Shards are numbered in the linearized ``(time, freq)`` order; the halo of
``ntaps-1`` rows travels from shard i to shard i+1
(:mod:`fxtpu_torch.parallel.collectives`).  Several processes each own a
contiguous run of shards: :func:`init_distributed` joins them
(``torch.distributed.init_process_group`` over TCP) before the mesh is
built, and :func:`all_shards` lays out every process's shards.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

__all__ = ["TIME_AXIS", "FREQ_AXIS", "AXES", "OPS", "Shard",
           "CorrelatorMesh", "init_distributed", "all_shards",
           "make_correlator_mesh", "block_sharding", "validate_shapes"]

TIME_AXIS = "time"
FREQ_AXIS = "freq"
#: The linearized (time, freq) shard index, the axes the halo and the
#: fused step's psums run over.
AXES = (TIME_AXIS, FREQ_AXIS)

#: The collectives' names in ``fxtpu``'s accounting (its HLO op names),
#: the keys of :attr:`CorrelatorMesh.volume`.
OPS = ("all-reduce", "collective-permute", "all-to-all", "all-gather",
       "reduce-scatter")

#: Seconds a rendezvous or a collective may wait for another process.
DEFAULT_TIMEOUT = 300.0


@dataclasses.dataclass(frozen=True)
class Shard:
    """One place of the mesh: the process that owns it and its device."""
    rank: int
    device: torch.device


def _process() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process
    group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class CorrelatorMesh:
    """A ``(mesh_time, mesh_freq)`` grid of :class:`Shard` s in linearized
    order.  ``shape`` maps the axis names to their sizes as a JAX mesh's
    does; :attr:`local` lists the shards this process owns;
    :attr:`volume` counts the payload bytes of every collective run over
    the mesh, by ``fxtpu``'s op name, and :attr:`staged_bytes` the bytes
    staged through pinned host memory for a ``gloo`` transfer of CUDA
    tensors (:mod:`~fxtpu_torch.parallel.collectives`)."""

    def __init__(self, shards: Sequence[Shard], mesh_time: int,
                 mesh_freq: int):
        if len(shards) != mesh_time * mesh_freq:
            raise ValueError(f"{len(shards)} shards for a {mesh_time}x"
                             f"{mesh_freq} mesh")
        self.shards = tuple(shards)
        self.shape = {TIME_AXIS: mesh_time, FREQ_AXIS: mesh_freq}
        self.process_index, self.process_count = _process()
        self.local = [i for i, s in enumerate(self.shards)
                      if s.rank == self.process_index]
        if not self.local:
            raise ValueError(f"process {self.process_index} owns no shard "
                             "of the mesh")
        self.backend = (dist.get_backend() if self.process_count > 1
                        else None)
        self.volume = {}
        self.staged_bytes = 0
        self.reset_volume()

    @property
    def size(self) -> int:
        return len(self.shards)

    @property
    def home(self) -> torch.device:
        """The device of this process's first shard: where the step's
        replicated inputs and outputs (history, delays, visibilities)
        live."""
        return self.shards[self.local[0]].device

    def reset_volume(self):
        self.volume = {op: 0 for op in OPS}
        self.staged_bytes = 0


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "gloo",
                     timeout: float = DEFAULT_TIMEOUT):
    """Join ``num_processes`` processes over TCP at ``coordinator``
    (``host:port``; process 0 listens there), as ``fxtpu``'s
    ``jax.distributed.initialize``; a no-op for one process.  ``backend``
    is ``"nccl"`` where every rank owns its own card, ``"gloo"``
    otherwise (the CPU, or several ranks on one card); every rendezvous
    and collective gives up after ``timeout`` seconds."""
    if num_processes is None or num_processes <= 1:
        return
    if process_id is None or not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} is not in "
                         f"[0, {num_processes})")
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout))


def all_shards(local_devices: int = 1, device: str = "cuda") -> List[Shard]:
    """Every process's shards in rank order, ``local_devices`` each.
    ``device`` ``"cpu"`` puts them all on the CPU; ``"cuda"`` spreads the
    shards over the cards a process sees, ``cuda:(rank * local_devices +
    j) % device_count`` (on one card every shard is on ``cuda:0``)."""
    world = _process()[1]
    if local_devices < 1:
        raise ValueError(f"local_devices must be >= 1, got {local_devices}")
    if device == "cpu":
        return [Shard(r, torch.device("cpu")) for r in range(world)
                for _ in range(local_devices)]
    if device != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda."
                           "is_available() is False; ask for 'cpu'")
    count = torch.cuda.device_count()
    return [Shard(r, torch.device("cuda", (r * local_devices + j) % count))
            for r in range(world) for j in range(local_devices)]


def make_correlator_mesh(mesh_time: int = 0, mesh_freq: int = 1,
                         devices=None) -> CorrelatorMesh:
    """Build a ``(time, freq)`` mesh over the first ``mesh_time *
    mesh_freq`` of ``devices`` (:class:`Shard` s, or torch devices of this
    process; default :func:`all_shards` on the card, which raises where
    there is none: a mesh on the CPU is asked for by passing its devices,
    or ``all_shards(n, "cpu")``).  ``mesh_time=0`` means "all remaining
    devices"."""
    if devices is None:
        devices = all_shards(device="cuda")
    rank = _process()[0]
    devices = [d if isinstance(d, Shard) else Shard(rank, torch.device(d))
               for d in devices]
    n = len(devices)
    if mesh_time == 0:
        if n % mesh_freq:
            raise ValueError(f"{n} devices not divisible by mesh_freq="
                             f"{mesh_freq}")
        mesh_time = n // mesh_freq
    if mesh_time * mesh_freq > n:
        raise ValueError(
            f"mesh {mesh_time}x{mesh_freq} needs {mesh_time * mesh_freq} "
            f"devices, have {n}")
    return CorrelatorMesh(devices[: mesh_time * mesh_freq], mesh_time,
                          mesh_freq)


def block_sharding(mesh: CorrelatorMesh, num_samp: int,
                   nbins: int = 1) -> List[Tuple[int, int]]:
    """The ``[start, stop)`` sample span of each shard of a block of
    ``num_samp`` samples (``fxtpu``'s ``P(None, (time, freq))`` over the
    sample axis): whole rows of ``nbins`` samples, the same number a
    shard, the last shard also holding the samples after the last whole
    row (the plain step's DC mean reads them; the frames do not)."""
    per = num_samp // nbins // mesh.size * nbins
    spans = [(i * per, (i + 1) * per) for i in range(mesh.size)]
    spans[-1] = (spans[-1][0], num_samp)
    return spans


def validate_shapes(num_samp: int, nbins: int, mesh: CorrelatorMesh,
                    ntaps: int = 1) -> Tuple[int, int]:
    """Check divisibility constraints; returns (rows_per_shard,
    bins_per_shard)."""
    t = mesh.shape[TIME_AXIS]
    f = mesh.shape[FREQ_AXIS]
    s = num_samp // nbins
    if s % (t * f):
        raise ValueError(
            f"frames per block ({s}) must divide by mesh size {t * f}")
    if nbins % f:
        raise ValueError(f"nbins ({nbins}) must divide by mesh_freq ({f})")
    rows = s // (t * f)
    if rows < ntaps - 1:
        raise ValueError(
            f"each shard owns {rows} PFB rows but the tap-history halo "
            f"needs {ntaps - 1}; use a bigger block or a smaller mesh")
    return rows, nbins // f
