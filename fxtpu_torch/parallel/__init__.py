"""fxtpu_torch.parallel — the shard mesh, its collectives on
``torch.distributed``, sharded ingest and the distributed FX step."""

from fxtpu_torch.parallel.mesh import (
    TIME_AXIS,
    FREQ_AXIS,
    init_distributed,
    make_correlator_mesh,
    block_sharding,
    validate_shapes,
)
from fxtpu_torch.parallel.sharded import make_sharded_fx_step

__all__ = [
    "TIME_AXIS", "FREQ_AXIS", "init_distributed", "make_correlator_mesh",
    "block_sharding", "validate_shapes", "make_sharded_fx_step",
]
