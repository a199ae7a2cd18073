"""A ``(data, model)`` device mesh over a ``torch.distributed`` world
(counterpart of ``kbner_tpu/parallel/mesh.py``).

The reference builds one ``jax.sharding.Mesh`` over the chips of one
program and lets XLA insert the collectives. Here every device is driven
by a process of its own: the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions are named
``("data", "model")``, and a sharded computation issues its collectives
itself over the mesh's groups (``mesh.get_group("data")``).

Axes, as in the reference:
  data   -- the batch axis of training, evaluation and query batches
            (DP), and the document axis of a sharded retrieval index
  model  -- the hidden and tag-set axes of large layers (TP)

One process per device: ``torchrun --nproc_per_node=N`` on a machine with
N cards (NCCL), or spawned processes with ``init_process_group("gloo",
...)`` on the CPU. Build the mesh the same way in every rank.
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(data: Optional[int] = None, model: int = 1,
              device_type: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` over every rank of the world.

    It uses the default process group, or initialises one from torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``): NCCL on ``"cuda"``, gloo otherwise. ``data``
    defaults to the world size over ``model``; ``data * model`` must be
    the world size. On ``"cuda"`` a rank's device is ``cuda:{local_rank %
    device_count}`` (``LOCAL_RANK`` from the environment, else the global
    rank), so ranks may share a card. A collective call: every rank makes
    it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://")
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def data_size(mesh) -> int:
    """Ranks along the mesh's data axis."""
    return mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def batch_sharding(mesh) -> tuple:
    """DTensor placements sharding the leading (batch) axis over 'data'
    and replicating it over 'model'."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh) -> tuple:
    """DTensor placements replicating a tensor over the whole mesh."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def shard_batch(batch: Dict[str, np.ndarray], mesh) -> dict:
    """A host batch as DTensors with the batch axis sharded over 'data'
    (the reference's ``shard_batch``): ``shard_batch(b, mesh)[name]
    .to_local()`` is this rank's rows, :func:`local_rows`. Every rank
    holds the same host batch, so each takes its own rows without a
    collective. The batch size must be divisible by the data-axis size;
    :func:`pad_batch_for_mesh` pads it to that multiple."""
    from torch.distributed.tensor import DTensor

    placements = batch_sharding(mesh)
    dev = torch.device(mesh.device_type,
                       torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return {k: DTensor.from_local(torch.as_tensor(np.asarray(v)).to(dev),
                                  mesh, placements, run_check=False)
            for k, v in local_rows(batch, mesh).items()}


def local_rows(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a host batch sharded over 'data', cut on the
    host (a training step takes its rows this way: DTensor's import and
    first call take a fresh process seconds). The batch size must be
    divisible by the data-axis size."""
    n = data_size(mesh)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch of {b} rows over data={n}: pad it first "
                         "(pad_batch_for_mesh)")
    lo = mesh.get_local_rank(DATA_AXIS) * (b // n)
    return {k: v[lo:lo + b // n] for k, v in batch.items()}


# (index, count) while this process computes rows ``index`` of ``count``
# equal shards of a global batch (batch_rows), else None
_BATCH_ROWS: Optional[Tuple[int, int]] = None


@contextlib.contextmanager
def batch_rows(index: int, count: int):
    """Within it this process holds rows ``index`` of ``count`` equal
    shards of a global batch: the models draw each dropout mask over the
    global batch and keep those rows (``models.xlmr.draw_uniform``), so a
    data-parallel step draws the single-process step's masks. A plain
    module global, so the backward pass (and a remat layer's recompute in
    it) sees it on the autograd engine's threads too."""
    global _BATCH_ROWS
    prev, _BATCH_ROWS = _BATCH_ROWS, (index, count)
    try:
        yield
    finally:
        _BATCH_ROWS = prev


def current_batch_rows() -> Optional[Tuple[int, int]]:
    """``(index, count)`` inside :func:`batch_rows`, else None."""
    return _BATCH_ROWS


def pad_batch_for_mesh(batch: Dict[str, np.ndarray], mesh
                       ) -> Dict[str, np.ndarray]:
    """Pad the batch axis up to a multiple of the data-axis size with zero
    rows (zero attention and word masks make padding sentences inert)."""
    n_data = data_size(mesh)
    b = next(iter(batch.values())).shape[0]
    rem = (-b) % n_data
    if rem == 0:
        return batch
    out = {}
    for k, v in batch.items():
        pad_width = [(0, rem)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out
