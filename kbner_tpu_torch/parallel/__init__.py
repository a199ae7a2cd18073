"""Device meshes over a ``torch.distributed`` world (counterpart of
``kbner_tpu/parallel``)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    pad_batch_for_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "make_mesh",
    "batch_sharding",
    "replicated",
    "shard_batch",
    "pad_batch_for_mesh",
]
