"""Device meshes over a ``torch.distributed`` world and the parameter
sharding of training on them (counterpart of ``kbner_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    local_rows,
    make_mesh,
    pad_batch_for_mesh,
    replicated,
    shard_batch,
)
from .sharding_rules import (
    gather_state_dict,
    param_placements,
    shard_params,
    shard_state_dict,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "local_rows",
    "pad_batch_for_mesh",
    "param_placements",
    "shard_params",
    "gather_state_dict",
    "shard_state_dict",
]
