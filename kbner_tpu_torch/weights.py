"""Carry a Flax tagger's parameters over to :class:`SequenceTagger` and
back.

The Flax side is the JAX package's parameter tree as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``, or a checkpoint
read by :mod:`.checkpoint`), so this module needs no JAX. Flax
``Dense.kernel`` is ``[in, out]`` and becomes ``nn.Linear.weight``
``[out, in]``; LayerNorm ``scale``/``bias`` become ``weight``/``bias``;
``Embed.embedding`` becomes ``nn.Embedding.weight``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from . import checkpoint
from .models.tagger import TaggerConfig

_EMBEDS = ("word_embeddings", "position_embeddings", "token_type_embeddings")
_PROJS = ("query", "key", "value", "out")


def _pairs(config: TaggerConfig):
    """``(flax path, state-dict prefix, kind)`` of every parameter group
    of the tagger; kind is ``dense``, ``norm`` or ``embed``."""
    out = [(("encoder", n), f"encoder.{n}", "embed") for n in _EMBEDS]
    out.append((("encoder", "embeddings_ln"), "encoder.embeddings_ln",
                "norm"))
    for i in range(config.encoder.num_layers):
        src, dst = ("encoder", f"layer_{i}"), f"encoder.layers.{i}"
        out += [(src + ("attention", p), f"{dst}.attention.{p}", "dense")
                for p in _PROJS]
        out += [(src + ("attention_ln",), f"{dst}.attention_ln", "norm"),
                (src + ("intermediate",), f"{dst}.intermediate", "dense"),
                (src + ("output",), f"{dst}.output", "dense"),
                (src + ("output_ln",), f"{dst}.output_ln", "norm")]
    if config.relearn_embeddings:
        out.append((("embedding2nn",), "embedding2nn", "dense"))
    out.append((("emission",), "emission", "dense"))
    return out


_LEAVES = {"dense": (("kernel", "weight"), ("bias", "bias")),
           "norm": (("scale", "weight"), ("bias", "bias")),
           "embed": (("embedding", "weight"),)}


def from_jax_params(params: Mapping[str, Any], config: TaggerConfig
                    ) -> Dict[str, torch.Tensor]:
    """State dict for ``SequenceTagger(config)`` from a Flax
    ``SequenceTagger`` parameter tree (with or without the outer
    ``"params"`` key). Tensors come back on the CPU in the dtypes the
    module keeps (the encoder's storage dtype; float32 for the emission
    head and transitions); ``load_state_dict`` moves them to the module's
    device."""
    p = params.get("params", params)
    state: Dict[str, torch.Tensor] = {}
    for path, prefix, kind in _pairs(config):
        node = p
        for key in path:
            node = node[key]
        dtype = (torch.float32 if prefix == "emission"
                 else config.encoder.storage_dtype)
        for src, dst in _LEAVES[kind]:
            t = _tensor(node[src])
            if src == "kernel":
                t = t.T
            state[f"{prefix}.{dst}"] = t.to(dtype).contiguous()
    if config.use_crf:
        state["transitions"] = _tensor(p["transitions"]).float()
    return state


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of its own memory from an array or tensor leaf (numpy
    arrays may be read-only views of a checkpoint's bytes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return torch.from_numpy(np.array(x))


def to_jax_params(state: Mapping[str, torch.Tensor], config: TaggerConfig
                  ) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: the Flax tagger's tree
    ``{"params": {...}}`` of float32 numpy arrays, the layout
    ``kbner_tpu``'s ``FinetuneTrainer.save`` writes."""
    tree: Dict[str, Any] = {}
    for path, prefix, kind in _pairs(config):
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        for src, dst in _LEAVES[kind]:
            arr = state[f"{prefix}.{dst}"].detach().float().cpu().numpy()
            node[src] = np.ascontiguousarray(arr.T if src == "kernel"
                                             else arr)
    if config.use_crf:
        tree["transitions"] = state["transitions"].detach().float().cpu(
        ).numpy()
    return {"params": tree}


def save_params(state: Mapping[str, torch.Tensor], config: TaggerConfig,
                path: Union[str, Path]) -> None:
    """Write a tagger's state dict as the Flax checkpoint
    ``FinetuneTrainer.save`` of ``kbner_tpu`` writes."""
    checkpoint.dump(to_jax_params(state, config), path)


def load_params(path: Union[str, Path], config: TaggerConfig
                ) -> Dict[str, torch.Tensor]:
    """The state dict of a Flax tagger checkpoint written by either
    package."""
    return from_jax_params(checkpoint.load(path), config)
