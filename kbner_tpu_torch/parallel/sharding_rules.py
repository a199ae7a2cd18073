"""Parameter sharding for training over a ``(data, model)`` mesh
(counterpart of ``kbner_tpu/parallel/sharding_rules.py``).

The reference annotates its parameters with ``PartitionSpec``s and lets
GSPMD insert the collectives. Here every rank is a process of its own:
:func:`shard_params` keeps only the rank's slices, as plain local
parameters, and the sharded layers issue their collectives themselves
over the mesh's groups (``mesh.get_group("model")``, ``"data"``):

  - tensor parallelism (Megatron) over ``model``: Q, K, V and MLP-in are
    column-parallel (their output features split; their biases follow),
    attention-out and MLP-out row-parallel (their input features split,
    the partial sums all-reduced; their biases replicated), the embedding
    tables split the hidden axis (the summed lookups all-gathered over
    ``model``). Before the column-parallel layers the input passes an
    identity whose backward all-reduces its gradient; after a
    row-parallel layer an all-reduce whose backward is the identity;
  - with ``fsdp=True`` (ZeRO-3) the free axis of each 2-D encoder matrix
    and the vocabulary axis of each embedding table also split over
    ``data``: a layer's weight is all-gathered over ``data`` just before
    use, and its gradient reduce-scattered and averaged over ``data`` in
    the backward pass. A leaf whose sharded dims do not divide keeps the
    TP-only spec, leaf by leaf, as the reference's fallback does.

Layer norms, ``embedding2nn``, the emission head and the transitions are
replicated, as is every leaf whose path has no ``encoder``. The
parameters stay plain tensors, so :class:`~..train.optim.FinetuneOptimizer`
runs on them unchanged (its moments exist for the rank's slices only).

A placement is a tuple with one entry per dim of the torch tensor: the
mesh axis that dim is split over, or None. Flax Dense kernels are ``[in,
out]`` and ``nn.Linear`` weights ``[out, in]``, so a kernel's spec maps
with its dims swapped (the names and transposes of :mod:`..weights`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from .mesh import DATA_AXIS, MODEL_AXIS

Placement = Tuple[Optional[str], ...]
BUCKET_BYTES = 256 << 20  # gradients all-reduced per call over 'data'


def _spec_for(path_keys, ndim: int, fsdp: bool = False) -> tuple:
    """The reference's spec of a Flax leaf (``_spec_for``), as a tuple."""
    path = "/".join(path_keys)
    data = DATA_AXIS if fsdp else None
    if "encoder" not in path:
        return ()  # heads, transitions, stack members: replicated
    if "embeddings" in path and path.endswith("embedding"):
        return (data, MODEL_AXIS)  # [V, H] hidden sharded (+V over data)
    if any(f"/{qkv}/" in path for qkv in ("query", "key", "value")):
        return (data, MODEL_AXIS) if ndim == 2 else (MODEL_AXIS,)
    if "/intermediate/" in path:
        return (data, MODEL_AXIS) if ndim == 2 else (MODEL_AXIS,)
    if "/attention/out/" in path or "/output/" in path:
        # row-parallel: input dim sharded; bias replicated (tiny)
        return (MODEL_AXIS, data) if ndim == 2 else ()
    return ()  # layer norms etc.


def _axis_sizes(mesh) -> Dict[str, int]:
    """``{"data": d, "model": m}`` of a ``DeviceMesh``, or of a mapping
    that gives them (a mesh's shape without a world)."""
    if isinstance(mesh, Mapping):
        return {DATA_AXIS: int(mesh[DATA_AXIS]),
                MODEL_AXIS: int(mesh[MODEL_AXIS])}
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def _flax_leaves(model: nn.Module):
    """``state-dict name -> (Flax path keys, kernel dims swapped)`` of
    every leaf :mod:`..weights` lays out as a Dense, Embed or LayerNorm
    leaf (the only kinds an encoder holds)."""
    from ..weights import _LEAVES, _pairs

    out = {}
    for path, prefix, kind in _pairs(model):
        for src, dst in _LEAVES.get(kind, ()):
            out[f"{prefix}.{dst}"] = (("params",) + tuple(path) + (src,),
                                      kind in ("dense", "dense_nobias")
                                      and src == "kernel")
    return out


def param_placements(model: nn.Module, mesh, fsdp: bool = False
                     ) -> Dict[str, Placement]:
    """Each parameter's placement on the ``(data, model)`` ``mesh`` (a
    ``DeviceMesh`` or ``{"data": d, "model": m}``), by state-dict name,
    for the model's full (unsharded) shapes: the reference's
    ``tagger_param_shardings`` leaf by leaf, the divisibility fallback
    included. Encoders inside an ACE stack (``stack.members.<i>.encoder``)
    match, as ``"encoder" in path`` matches them in the reference."""
    sizes = _axis_sizes(mesh)
    flax = _flax_leaves(model)
    out: Dict[str, Placement] = {}
    for name, p in model.named_parameters():
        place: Placement = (None,) * p.dim()
        if name in flax:
            keys, swap = flax[name]
            shape = tuple(p.shape)[::-1] if swap else tuple(p.shape)
            spec = _spec_for(keys, len(shape), fsdp)
            if fsdp and any(ax is not None and dim % sizes[ax]
                            for dim, ax in zip(shape, spec)):
                spec = _spec_for(keys, len(shape), False)
            spec = tuple(spec) + (None,) * (len(shape) - len(spec))
            place = spec[::-1] if swap else spec
        out[name] = place
    return out


# -- collectives with their autograd rules --------------------------------------

def _all_gather_cat(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _EnterModel(torch.autograd.Function):
    """Identity forward; backward all-reduces the gradient over
    ``model`` (before the column-parallel layers)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceModel(torch.autograd.Function):
    """All-reduce forward over ``model`` (after a row-parallel layer);
    identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherModel(torch.autograd.Function):
    """All-gather forward along ``dim`` over ``model``; backward keeps
    this rank's chunk (the gradient downstream is the same on every
    rank of the group)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather_cat(x, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return grad.chunk(n, ctx.dim)[r].contiguous(), None, None


class _GatherData(torch.autograd.Function):
    """FSDP: all-gather a weight along ``dim`` over ``data`` forward;
    backward reduce-scatters the gradient and averages it over the
    ``data`` ranks (each computed it on its own rows)."""

    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather_cat(w, dim, group)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        parts = [c.contiguous() for c in grad.chunk(n, ctx.dim)]
        out = torch.empty_like(parts[0])
        dist.reduce_scatter(out, parts, group=ctx.group)
        return out / n, None, None


# -- where a model's parameters lie ------------------------------------------------

class Sharding:
    """The placements of a model's parameters on a mesh, with the mesh's
    sizes, this rank's coordinates and groups; ``shard_params`` sets one
    as ``model.sharding``."""

    def __init__(self, mesh, placements: Dict[str, Placement]):
        self.mesh = mesh
        self.placements = placements
        self.sizes = _axis_sizes(mesh)
        self.coords = {ax: mesh.get_local_rank(ax)
                       for ax in (DATA_AXIS, MODEL_AXIS)}
        self.groups = {ax: mesh.get_group(ax)
                       for ax in (DATA_AXIS, MODEL_AXIS)}

    def split(self, name: str) -> List[Tuple[int, str]]:
        """``(dim, axis)`` of each dim of ``name`` split over an axis of
        more than one rank."""
        return [(d, ax) for d, ax in enumerate(self.placements.get(name, ()))
                if ax is not None and self.sizes[ax] > 1]

    def replicas(self, name: str) -> int:
        """The ranks that hold the same values of ``name``'s slice."""
        split = {ax for _, ax in self.split(name)}
        return math.prod(n for ax, n in self.sizes.items()
                         if ax not in split)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the full tensor ``full``."""
        for dim, ax in self.split(name):
            full = full.chunk(self.sizes[ax], dim)[self.coords[ax]]
        return full.contiguous()

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor of every rank's slice of ``name`` (a
        collective: every rank calls it)."""
        for dim, ax in self.split(name):
            local = _all_gather_cat(local, dim, self.groups[ax])
        return local

    def sync_gradients(self, model: nn.Module) -> None:
        """Average over ``data`` the gradients of the leaves not split
        over ``data`` (an FSDP leaf's backward already did), in
        all-reduces of at most :data:`BUCKET_BYTES`."""
        n = self.sizes[DATA_AXIS]
        if n == 1:
            return
        grads = [p.grad for name, p in model.named_parameters()
                 if p.grad is not None
                 and DATA_AXIS not in {ax for _, ax in self.split(name)}]
        buckets: Dict[torch.dtype, List[List[torch.Tensor]]] = {}
        for g in grads:
            chain = buckets.setdefault(g.dtype, [[]])
            if chain[-1] and (sum(t.numel() for t in chain[-1]) + g.numel()
                              ) * g.element_size() > BUCKET_BYTES:
                chain.append([])
            chain[-1].append(g)
        for chain in buckets.values():
            for bucket in chain:
                flat = torch.cat([g.reshape(-1) for g in bucket])
                dist.all_reduce(flat, group=self.groups[DATA_AXIS])
                flat /= n
                for g, piece in zip(bucket, flat.split(
                        [g.numel() for g in bucket])):
                    g.copy_(piece.view_as(g))


# -- the sharded layers ------------------------------------------------------------

class ShardedEmbedding(nn.Module):
    """An embedding table's slice: its hidden axis split over ``model``
    (the encoder gathers the summed lookups), and with FSDP its
    vocabulary axis over ``data`` (gathered before the lookup)."""

    def __init__(self, weight: torch.Tensor, data_group=None):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.data_group = data_group

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.data_group is not None:
            w = _GatherData.apply(w, 0, self.data_group)
        return F.embedding(ids, w)


class ShardedLinear(nn.Module):
    """A Dense layer's slice, its weight ``[out, in]``: column-parallel
    (``out`` split over ``model``; ``enter`` passes the input through the
    identity whose backward all-reduces it), row-parallel (``in`` split:
    the partial products are all-reduced in float32, then the replicated
    bias is added), or whole over ``model``; with FSDP the weight's
    ``data``-split dim is all-gathered before use. Weight and bias are
    cast to the input's dtype where they are used, as
    :class:`..models.xlmr.Linear` casts them."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor,
                 mode: Optional[str], model_group, data_dim: Optional[int],
                 data_group, enter: bool):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        self.mode, self.model_group, self.enter = mode, model_group, enter
        self.data_dim, self.data_group = data_dim, data_group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight
        if self.data_dim is not None:
            w = _GatherData.apply(w, self.data_dim, self.data_group)
        w = w.to(x.dtype)
        if self.mode == "row":
            y = _ReduceModel.apply(F.linear(x, w).float(), self.model_group)
            return (y + self.bias.float()).to(x.dtype)
        if self.mode == "column" and self.enter:
            x = _EnterModel.apply(x, self.model_group)
        return F.linear(x, w, self.bias.to(x.dtype))


def _shard_encoder(enc: nn.Module, prefix: str, sh: Sharding) -> None:
    """Swap the encoder's embedding tables and Dense layers for their
    sharded slices and set its tensor-parallel hooks."""
    m = sh.sizes[MODEL_AXIS]
    model_group = sh.groups[MODEL_AXIS] if m > 1 else None
    data_group = sh.groups[DATA_AXIS]

    def data_dim(name: str) -> Optional[int]:
        return next((d for d, ax in sh.split(name) if ax == DATA_AXIS), None)

    def full(name: str) -> str:
        return f"{prefix}.{name}" if prefix else name

    gathered = False
    for n in ("word_embeddings", "position_embeddings",
              "token_type_embeddings"):
        name = full(f"{n}.weight")
        table = getattr(enc, n).weight
        dd = data_dim(name)
        setattr(enc, n, ShardedEmbedding(
            sh.local(name, table.detach()),
            data_group if dd is not None else None))
        gathered |= (1, MODEL_AXIS) in sh.split(name)
    if gathered:
        enc.tp_gather = lambda h: _GatherModel.apply(h, -1, model_group)

    def linear(parent: nn.Module, attr: str, name: str, enter: bool):
        lin = getattr(parent, attr)
        w_name, b_name = full(f"{name}.weight"), full(f"{name}.bias")
        split = dict((ax, d) for d, ax in sh.split(w_name))
        mode = ({0: "column", 1: "row"}[split[MODEL_AXIS]]
                if MODEL_AXIS in split else None)
        setattr(parent, attr, ShardedLinear(
            sh.local(w_name, lin.weight.detach()),
            sh.local(b_name, lin.bias.detach()), mode, model_group,
            split.get(DATA_AXIS), data_group, enter))
        return mode

    for i, layer in enumerate(enc.layers):
        att = layer.attention
        modes = [linear(att, p, f"layers.{i}.attention.{p}", enter=False)
                 for p in ("query", "key", "value")]
        linear(att, "out", f"layers.{i}.attention.out", enter=False)
        linear(layer, "intermediate", f"layers.{i}.intermediate", enter=True)
        linear(layer, "output", f"layers.{i}.output", enter=False)
        if "column" in modes:
            if att.num_heads % m:
                raise ValueError(f"{att.num_heads} heads do not split over "
                                 f"model={m}")
            att.head_offset = sh.coords[MODEL_AXIS] * (att.num_heads // m)
            att.tp_enter = lambda h, g=model_group: _EnterModel.apply(h, g)


def shard_params(model: nn.Module, mesh, fsdp: bool = False) -> nn.Module:
    """Keep this rank's slices of ``model``'s parameters on ``mesh`` (a
    ``DeviceMesh`` from :func:`.mesh.make_mesh`) and make its encoders'
    layers issue the collectives of that layout; returns ``model``, with
    ``model.sharding`` set. Every rank builds the same model from the same
    seed, then calls this (no collective is made here). Raises
    ``ValueError`` when a split dim does not divide over its axis."""
    from ..models.xlmr import XLMREncoder

    placements = param_placements(model, mesh, fsdp)
    sh = Sharding(mesh, placements)
    for name, p in model.named_parameters():
        for dim, ax in sh.split(name):
            if p.shape[dim] % sh.sizes[ax]:
                raise ValueError(f"{name} {tuple(p.shape)}: dim {dim} does "
                                 f"not split over {ax}={sh.sizes[ax]}")
    for prefix, module in list(model.named_modules()):
        if isinstance(module, XLMREncoder):
            _shard_encoder(module, prefix, sh)
    model.sharding = sh
    return model


def gather_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's full, unsharded state dict (a collective on a sharded
    model: every rank calls it); a model that was not sharded gives its
    own ``state_dict()``."""
    sh = getattr(model, "sharding", None)
    state = model.state_dict()
    if sh is None:
        return state
    return {k: sh.gather(k, v) for k, v in state.items()}


def shard_state_dict(model: nn.Module, state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state dict, for ``load_state_dict``
    of a sharded model (the state itself for one that was not)."""
    sh = getattr(model, "sharding", None)
    if sh is None:
        return dict(state)
    return {k: sh.local(k, v) for k, v in state.items()}
