"""Carry a Flax tagger's parameters over to :class:`SequenceTagger` and
back.

The Flax side is the JAX package's parameter tree as numpy arrays (for
example ``jax.tree_util.tree_map(np.asarray, params)``, or a checkpoint
read by :mod:`.checkpoint`), so this module needs no JAX. Flax
``Dense.kernel`` is ``[in, out]`` and becomes ``nn.Linear.weight``
``[out, in]``; LayerNorm ``scale``/``bias`` become ``weight``/``bias``;
``Embed.embedding`` becomes ``nn.Embedding.weight``.

A stacked tagger's tree (``kbner_tpu``'s ``StackedSequenceTagger``) holds
its members under ``stack/members_{i}``: XLM-R's ``encoder``, a word
table's ``table``, the char-BiLSTM's ``chars`` with its forward and
backward cells ``OptimizedLSTMCell_0`` and ``_1``, each Flair LM's
``{fwd,bwd}/embed`` and ``{fwd,bwd}/OptimizedLSTMCell_0``; an LSTM cell's
``{ii,if,ig,io}/kernel`` and ``{hi,hf,hg,ho}/{kernel,bias}`` become
:class:`~.models.embedders.FlaxLSTM`'s fused ``kernel_i``, ``kernel_h``
and ``bias``. An ELMo member keeps the Flax names: ``chars``,
``conv{width}`` (a Flax Conv kernel ``[width, in, out]`` is a ``Conv1d``
weight ``[out, in, width]``), ``hw_t{i}``/``hw_h{i}`` and ``proj`` as
Dense layers, ``mix/{weights,gamma}``, and either bilm-tf's cells
``{fwd,bwd}{i}/{W_0,B,W_P_0}`` as they are or, in the native topology,
the LSTM cells ``OptimizedLSTMCell_{2i}`` (forward, layer i) and
``_{2i+1}`` (backward); a BPEmb member its ``table``. The transitions,
and the transition attention's ``sent_to_trans_att`` ``[H, L]`` and
``sent_to_trans_att_b`` ``[L]``, keep their Flax names and layout.

The parser and classifier families (:mod:`.models.biaffine`,
:mod:`.models.classifier`) keep their Flax names: the encoder under
``encoder``, Dense layers (``mlp_*``, ``head``), the ROOT vector ``root``
and the biaffine ``weight`` ``[out, in_x, in_y]`` (the same layout in
both trees); the classifier's GRU ``doc_rnn/cell`` holds ``{ir,iz,in}/
{kernel,bias}``, ``{hr,hz}/kernel`` and ``hn/{kernel,bias}``, which become
:class:`~.models.embedders.FlaxGRU`'s fused ``kernel_i``, ``bias_i``,
``kernel_h`` and ``bias_hn``. The MFVI head (:mod:`.ops.mfvi`) keeps
``potentials/{U,V}/kernel`` (Dense layers without bias) and
``potentials/{W1,W2}``, and with third order ``ternary/{W1,W2,W3,T1,T2,
T3}/kernel`` and ``ternary/tag_emb``. Every function here takes a
:class:`TaggerConfig` (the plain tagger) or the module itself.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from . import checkpoint
from .models.biaffine import (BiaffineNER, BiaffineParser,
                              SemanticDependencyParser)
from .models.classifier import TextClassifier, TextRegressor
from .models.embedders import (BPEmbEmbedder, CharBiLSTMEmbedder,
                               CharLMHead, ELMoEmbedder, FlairLMEmbedder,
                               TransformerWordEmbedder, WordEmbedder)
from .models.ensemble_model import EnsembleModel
from .models.tagger import SequenceTagger, StackedSequenceTagger, TaggerConfig
from .models.xlmr import XLMRConfig
from .ops.mfvi import MFVIHead

_EMBEDS = ("word_embeddings", "position_embeddings", "token_type_embeddings")
_PROJS = ("query", "key", "value", "out")
_GATES = "ifgo"
_GRU_GATES = "rzn"
_TASK_MODELS = (BiaffineParser, SemanticDependencyParser, BiaffineNER,
                TextClassifier, TextRegressor)
Target = Union[TaggerConfig, SequenceTagger, CharLMHead, EnsembleModel,
               BiaffineParser, SemanticDependencyParser, BiaffineNER,
               TextClassifier, TextRegressor, MFVIHead]


def _encoder_pairs(enc: XLMRConfig, src: tuple, dst: str):
    out = [(src + (n,), f"{dst}.{n}", "embed") for n in _EMBEDS]
    out.append((src + ("embeddings_ln",), f"{dst}.embeddings_ln", "norm"))
    for i in range(enc.num_layers):
        s, d = src + (f"layer_{i}",), f"{dst}.layers.{i}"
        out += [(s + ("attention", p), f"{d}.attention.{p}", "dense")
                for p in _PROJS]
        out += [(s + ("attention_ln",), f"{d}.attention_ln", "norm"),
                (s + ("intermediate",), f"{d}.intermediate", "dense"),
                (s + ("output",), f"{d}.output", "dense"),
                (s + ("output_ln",), f"{d}.output_ln", "norm")]
    return out


def _member_pairs(member, src: tuple, dst: str):
    if isinstance(member, TransformerWordEmbedder):
        return _encoder_pairs(member.encoder.config, src + ("encoder",),
                              f"{dst}.encoder")
    if isinstance(member, WordEmbedder):
        return [(src + ("table",), f"{dst}.table", "embed")]
    if isinstance(member, CharBiLSTMEmbedder):
        return [(src + ("chars",), f"{dst}.chars", "embed"),
                (src + ("OptimizedLSTMCell_0",), f"{dst}.fwd", "lstm"),
                (src + ("OptimizedLSTMCell_1",), f"{dst}.bwd", "lstm")]
    if isinstance(member, FlairLMEmbedder):
        return [pair for d in ("fwd", "bwd") for pair in (
            (src + (d, "embed"), f"{dst}.{d}.embed", "embed"),
            (src + (d, "OptimizedLSTMCell_0"), f"{dst}.{d}.lstm", "lstm"))]
    if isinstance(member, ELMoEmbedder):
        return _elmo_pairs(member, src, dst)
    if isinstance(member, BPEmbEmbedder):
        return [(src + ("table",), f"{dst}.table", "embed")]
    raise TypeError(f"no Flax layout for a {type(member).__name__} member")


def _elmo_pairs(member: ELMoEmbedder, src: tuple, dst: str):
    out = [(src + ("chars",), f"{dst}.chars", "embed")]
    out += [(src + (f"conv{w}",), f"{dst}.conv{w}", "conv")
            for w, _ in member.filters]
    out += [(src + (f"hw_{g}{i}",), f"{dst}.hw_{g}{i}", "dense")
            for i in range(member.n_highway) for g in "th"]
    out.append((src + ("proj",), f"{dst}.proj", "dense"))
    for i in range(member.num_layers):
        for j, d in enumerate(("fwd", "bwd")):
            if member.bilm:
                out += [(src + (f"{d}{i}", leaf), f"{dst}.{d}{i}.{leaf}",
                         "param") for leaf in ("W_0", "B", "W_P_0")]
            else:
                out.append((src + (f"OptimizedLSTMCell_{2 * i + j}",),
                            f"{dst}.{d}{i}", "lstm"))
    if member.mix is not None:
        out += [(src + ("mix", leaf), f"{dst}.mix.{leaf}", "param")
                for leaf in ("weights", "gamma")]
    return out


def _mfvi_pairs(head: MFVIHead):
    out = [(("potentials", n), f"potentials.{n}", "dense_nobias")
           for n in "UV"]
    out += [(("potentials", n), f"potentials.{n}", "param")
            for n in ("W1", "W2")]
    if head.use_third_order:
        out += [(("ternary", n), f"ternary.{n}", "dense_nobias")
                for n in ("W1", "W2", "W3", "T1", "T2", "T3")]
        out.append((("ternary", "tag_emb"), "ternary.tag_emb", "param"))
    return out


def _config(target: Target) -> TaggerConfig:
    return target if isinstance(target, TaggerConfig) else target.config


def _use_crf(target: Target) -> bool:
    return (not isinstance(target, (CharLMHead, EnsembleModel, MFVIHead)
                           + _TASK_MODELS)
            and _config(target).use_crf)


def _task_pairs(target: nn.Module):
    """The parser and classifier families' groups (see the module's
    docstring)."""
    out = _encoder_pairs(target.config.encoder, ("encoder",), "encoder")
    if isinstance(target, BiaffineNER):
        return out + [(("mlp_start",), "mlp_start", "dense"),
                      (("mlp_end",), "mlp_end", "dense"),
                      (("span_attn",), "span_attn", "biaffine")]
    if isinstance(target, (TextClassifier, TextRegressor)):
        out.append((("head",), "head", "dense"))
        if getattr(target, "doc_rnn", None) is not None:
            out.append((("doc_rnn", "cell"), "doc_rnn", "gru"))
        return out
    return out + [(("root",), "root", "param")] + [
        ((name,), name, "dense") for name in (
            "mlp_arc_h", "mlp_arc_d", "mlp_rel_h", "mlp_rel_d")] + [
        (("arc_attn",), "arc_attn", "biaffine"),
        (("rel_attn",), "rel_attn", "biaffine")]


def _crf_leaves(target: Target):
    """The CRF's float32 leaves, named alike in both trees."""
    if not _use_crf(target):
        return ()
    cfg = _config(target)
    if cfg.num_languages > 0 and cfg.transition_attention:
        return ("transitions", "sent_to_trans_att", "sent_to_trans_att_b")
    return ("transitions",)


def _pairs(target: Target):
    """``(flax path, state-dict prefix, kind)`` of every parameter group
    of the model; kind is a key of ``_LEAVES``, ``lstm``, ``gru`` or
    ``param`` (one leaf as it is)."""
    if isinstance(target, CharLMHead):
        return [(("lm", "embed"), "lm.embed", "embed"),
                (("lm", "OptimizedLSTMCell_0"), "lm.lstm", "lstm"),
                (("decoder",), "decoder", "dense")]
    if isinstance(target, EnsembleModel):
        return [(("hidden",), "hidden", "dense"),
                (("hidden2score",), "hidden2score", "dense")]
    if isinstance(target, MFVIHead):
        return _mfvi_pairs(target)
    if isinstance(target, _TASK_MODELS):
        return _task_pairs(target)
    config = _config(target)
    if isinstance(target, StackedSequenceTagger):
        out = [pair for i, m in enumerate(target.stack.members)
               for pair in _member_pairs(m, ("stack", f"members_{i}"),
                                         f"stack.members.{i}")]
    else:
        out = _encoder_pairs(config.encoder, ("encoder",), "encoder")
    if config.relearn_embeddings:
        out.append((("embedding2nn",), "embedding2nn", "dense"))
    out.append((("emission",), "emission", "dense"))
    return out


_LEAVES = {"dense": (("kernel", "weight"), ("bias", "bias")),
           "dense_nobias": (("kernel", "weight"),),
           "conv": (("kernel", "weight"), ("bias", "bias")),
           "norm": (("scale", "weight"), ("bias", "bias")),
           "embed": (("embedding", "weight"),),
           "biaffine": (("weight", "weight"),)}


def _kernel_to_torch(kind: str, src: str, t: torch.Tensor) -> torch.Tensor:
    """A Flax kernel in the torch layout: Dense ``[in, out]`` ->
    ``[out, in]``, Conv ``[w, in, out]`` -> ``[out, in, w]``."""
    if src != "kernel":
        return t
    return t.permute(2, 1, 0) if kind == "conv" else t.T


def _kernel_to_flax(kind: str, src: str, arr: np.ndarray) -> np.ndarray:
    """The inverse of :func:`_kernel_to_torch`."""
    if src != "kernel":
        return arr
    return arr.transpose(2, 1, 0) if kind == "conv" else arr.T


def _dtypes(target: Target):
    """``name -> dtype`` the tagger keeps each parameter in."""
    if isinstance(target, nn.Module):
        return {k: v.dtype for k, v in target.state_dict().items()}.get
    return lambda name: (torch.float32 if name.startswith("emission")
                         else target.encoder.storage_dtype)


def _state(p: Mapping[str, Any], pairs, dtype) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, prefix, kind in pairs:
        node = p
        for key in path:
            node = node[key]
        if kind == "lstm":
            leaves = lstm_from_flax(node)
        elif kind == "gru":
            leaves = gru_from_flax(node)
        elif kind == "param":
            leaves = {"": _tensor(node)}
        else:
            leaves = {dst: _kernel_to_torch(kind, src, _tensor(node[src]))
                      for src, dst in _LEAVES[kind]}
        for dst, t in leaves.items():
            name = f"{prefix}.{dst}".strip(".")
            state[name] = t.to(dtype(name)).contiguous()
    return state


def _tree(state: Mapping[str, torch.Tensor], pairs) -> Dict[str, Any]:
    def array(name):
        return state[name.lstrip(".")].detach().float().cpu().numpy()

    tree: Dict[str, Any] = {}
    for path, prefix, kind in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if kind == "param":
            node[path[-1]] = np.array(array(prefix), order="C")  # 0-d too
            continue
        node = node.setdefault(path[-1], {})
        if kind == "lstm":
            node.update(lstm_to_flax(*(array(f"{prefix}.{n}") for n in (
                "kernel_i", "kernel_h", "bias"))))
            continue
        if kind == "gru":
            node.update(gru_to_flax(*(array(f"{prefix}.{n}") for n in (
                "kernel_i", "bias_i", "kernel_h", "bias_hn"))))
            continue
        for src, dst in _LEAVES[kind]:
            node[src] = np.ascontiguousarray(_kernel_to_flax(
                kind, src, array(f"{prefix}.{dst}")))
    return tree


def from_jax_params(params: Mapping[str, Any], target: Target
                    ) -> Dict[str, torch.Tensor]:
    """State dict for the tagger from a Flax ``SequenceTagger`` (or
    ``StackedSequenceTagger``) parameter tree (with or without the outer
    ``"params"`` key). Tensors come back on the CPU in the dtypes the
    module keeps (the plain tagger's encoder storage dtype, float32 for
    its emission head and transitions; a module's own dtypes);
    ``load_state_dict`` moves them to the module's device."""
    p = params.get("params", params)
    state = _state(p, _pairs(target), _dtypes(target))
    for name in _crf_leaves(target):
        state[name] = _tensor(p[name]).float()
    return state


def member_from_jax_params(params: Mapping[str, Any], member: nn.Module
                           ) -> Dict[str, torch.Tensor]:
    """State dict for one stack member (a classic embedder or the
    transformer member) from its Flax subtree ``stack/members_<i>``."""
    return _state(params.get("params", params),
                  _member_pairs(member, (), ""), _dtypes(member))


def member_to_jax_params(state: Mapping[str, torch.Tensor],
                         member: nn.Module) -> Dict[str, Any]:
    """The inverse of :func:`member_from_jax_params`: the member's Flax
    subtree of float32 numpy arrays."""
    return _tree(state, _member_pairs(member, (), ""))


def lstm_from_flax(cell: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """:class:`~.models.embedders.FlaxLSTM`'s ``kernel_i``, ``kernel_h``
    and ``bias`` from a Flax ``OptimizedLSTMCell``'s parameters."""
    return {"kernel_i": torch.cat([_tensor(cell[f"i{g}"]["kernel"])
                                   for g in _GATES], dim=1),
            "kernel_h": torch.cat([_tensor(cell[f"h{g}"]["kernel"])
                                   for g in _GATES], dim=1),
            "bias": torch.cat([_tensor(cell[f"h{g}"]["bias"])
                               for g in _GATES])}


def lstm_to_flax(kernel_i: np.ndarray, kernel_h: np.ndarray,
                 bias: np.ndarray) -> Dict[str, Any]:
    """The inverse of :func:`lstm_from_flax`, as numpy arrays."""
    H = kernel_h.shape[0]
    tree: Dict[str, Any] = {}
    for j, g in enumerate(_GATES):
        cols = slice(j * H, (j + 1) * H)
        tree[f"i{g}"] = {"kernel": np.ascontiguousarray(kernel_i[:, cols])}
        tree[f"h{g}"] = {"kernel": np.ascontiguousarray(kernel_h[:, cols]),
                         "bias": np.ascontiguousarray(bias[cols])}
    return tree


def gru_from_flax(cell: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """:class:`~.models.embedders.FlaxGRU`'s ``kernel_i``, ``bias_i``,
    ``kernel_h`` and ``bias_hn`` from a Flax ``GRUCell``'s parameters."""
    return {"kernel_i": torch.cat([_tensor(cell[f"i{g}"]["kernel"])
                                   for g in _GRU_GATES], dim=1),
            "bias_i": torch.cat([_tensor(cell[f"i{g}"]["bias"])
                                 for g in _GRU_GATES]),
            "kernel_h": torch.cat([_tensor(cell[f"h{g}"]["kernel"])
                                   for g in _GRU_GATES], dim=1),
            "bias_hn": _tensor(cell["hn"]["bias"])}


def gru_to_flax(kernel_i: np.ndarray, bias_i: np.ndarray,
                kernel_h: np.ndarray, bias_hn: np.ndarray) -> Dict[str, Any]:
    """The inverse of :func:`gru_from_flax`, as numpy arrays."""
    H = kernel_h.shape[0]
    tree: Dict[str, Any] = {}
    for j, g in enumerate(_GRU_GATES):
        cols = slice(j * H, (j + 1) * H)
        tree[f"i{g}"] = {"kernel": np.ascontiguousarray(kernel_i[:, cols]),
                         "bias": np.ascontiguousarray(bias_i[cols])}
        tree[f"h{g}"] = {"kernel": np.ascontiguousarray(kernel_h[:, cols])}
    tree["hn"]["bias"] = np.ascontiguousarray(bias_hn)
    return tree


def _tensor(x) -> torch.Tensor:
    """A CPU tensor of its own memory from an array or tensor leaf (numpy
    arrays may be read-only views of a checkpoint's bytes)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return torch.from_numpy(np.array(x))


def to_jax_params(state: Mapping[str, torch.Tensor], target: Target
                  ) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_params`: the Flax tagger's tree
    ``{"params": {...}}`` of float32 numpy arrays, the layout
    ``kbner_tpu``'s ``FinetuneTrainer.save`` writes."""
    tree = _tree(state, _pairs(target))
    for name in _crf_leaves(target):
        tree[name] = state[name].detach().float().cpu().numpy()
    return {"params": tree}


def save_params(state: Mapping[str, torch.Tensor], target: Target,
                path: Union[str, Path]) -> None:
    """Write a tagger's state dict as the Flax checkpoint
    ``FinetuneTrainer.save`` of ``kbner_tpu`` writes."""
    checkpoint.dump(to_jax_params(state, target), path)


def load_params(path: Union[str, Path], target: Target
                ) -> Dict[str, torch.Tensor]:
    """The state dict of a Flax tagger checkpoint written by either
    package."""
    return from_jax_params(checkpoint.load(path), target)
