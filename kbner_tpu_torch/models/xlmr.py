"""XLM-RoBERTa encoder as a PyTorch module (counterpart of
``kbner_tpu/models/xlmr.py``).

The same computation as the Flax encoder:
  - RoBERTa position ids ``cumsum(mask) * mask + pad_token_id``;
  - an additive ``-1e9`` attention mask;
  - attention written as two matmuls and a softmax taken in float32;
  - exact (erf) GELU; post-LayerNorm with ``layer_norm_eps``, its
    statistics in float32 and its output in the compute dtype, as Flax's
    ``LayerNorm(dtype=...)`` computes it;
  - dropout where Flax puts it: after the embedding LayerNorm, on the
    softmaxed attention probabilities, and on the attention and MLP
    outputs before their residual LayerNorms.

Two dtypes: ``dtype`` is the compute dtype of every matmul and activation
(bfloat16 for ``base``/``large``, float32 for ``tiny``), ``param_dtype``
the dtype the parameters are stored in. Serving stores them in the compute
dtype (``param_dtype=None``); training keeps float32 master parameters and
casts each one to the compute dtype where it is used, Dense by Dense, as
Flax's ``Dense(dtype=bfloat16)`` does with its float32 parameters, so that
the optimizer's small updates are not lost to bfloat16's 8 mantissa bits.

Dropout draws from ``torch.Generator``s: a forward pass given a host
generator (``rng``) takes one seed from it per dropout site group (the
embeddings, then each layer) and draws that group's masks on the device
from a generator seeded with it. A layer under ``remat`` recomputes its
masks from the same seed in the backward pass. Without ``rng`` the pass
is deterministic. Inside ``parallel.mesh.batch_rows`` a rank holding
rows ``i`` of ``n`` of a data-parallel batch draws each mask over the
global batch and keeps its rows, so the masks are the single-device
step's.

Under tensor parallelism (``parallel/sharding_rules.py``) a rank holds
``num_heads / model`` of the heads: the attention takes its head count
from its query projection's width, and the hooks ``tp_enter`` (before
the column-parallel projections) and ``tp_gather`` (after the embedding
lookups) are set; unsharded they are None and nothing changes.

:func:`load_hf_checkpoint` reads an HF xlm-roberta checkpoint directory
(``model.safetensors`` through the module's own reader, else
``pytorch_model.bin``) into the encoder's state dict; HF's Linear weights
are ``[out, in]`` as ``nn.Linear`` keeps them, so nothing is transposed.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import mmap
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..device import resolve_device
from ..parallel.mesh import current_batch_rows

_aten = torch.ops.aten
_SAVED_DOTS = {
    "dots_saveable": (_aten.mm.default, _aten.addmm.default,
                      _aten.bmm.default),
    "dots_with_no_batch_dims_saveable": (_aten.mm.default,
                                         _aten.addmm.default),
}


@dataclasses.dataclass(frozen=True)
class XLMRConfig:
    vocab_size: int = 250002
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    dtype: torch.dtype = torch.bfloat16  # compute (activation) dtype
    param_dtype: Optional[torch.dtype] = None  # None: the compute dtype
    # recompute each layer's activations in the backward pass
    # (torch.utils.checkpoint per layer): less memory for more FLOPs
    remat: bool = False
    # None recomputes everything; "dots_saveable" keeps every matmul's
    # output and "dots_with_no_batch_dims_saveable" the unbatched ones
    # (the Dense layers), recomputing the rest, as the jax.checkpoint
    # policies of those names do
    remat_policy: Optional[str] = None

    @property
    def storage_dtype(self) -> torch.dtype:
        return self.param_dtype or self.dtype

    @classmethod
    def base(cls, **kw) -> "XLMRConfig":
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "XLMRConfig":
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   intermediate_size=4096, **kw)

    @classmethod
    def tiny(cls, **kw) -> "XLMRConfig":
        """Tiny config for tests (float32, CPU-sized, no dropout)."""
        defaults = dict(vocab_size=1000, hidden_size=64, num_layers=2,
                        num_heads=4, intermediate_size=128,
                        max_position_embeddings=130, dtype=torch.float32,
                        hidden_dropout=0.0, attention_dropout=0.0)
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def from_hf_config(cls, path: str | Path, **kw) -> "XLMRConfig":
        """The config of an HF ``config.json`` (its field names); explicit
        ``kw`` win over the file's values."""
        hf = json.loads(Path(path).read_text())
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position_embeddings=hf["max_position_embeddings"],
            type_vocab_size=hf.get("type_vocab_size", 1),
            pad_token_id=hf.get("pad_token_id", 1),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        )
        fields.update(kw)
        return cls(**fields)


def _remat_context(policy: Optional[str]):
    """``context_fn`` of ``torch.utils.checkpoint`` for a named policy."""
    if policy is None:
        return None
    if policy not in _SAVED_DOTS:
        raise ValueError(f"remat_policy {policy!r}: one of "
                         f"{sorted(_SAVED_DOTS)} or None")
    saved = _SAVED_DOTS[policy]

    def choose(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, choose)


def draw_uniform(shape, gen: torch.Generator, device,
                 heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``. Inside
    :func:`..parallel.mesh.batch_rows` it is this process's rows of a draw
    over the global batch (dim 0 times the shard count); with
    ``heads=(offset, total)`` dim 1 holds heads ``offset, ...`` of a draw
    over all ``total`` heads."""
    rows = current_batch_rows()
    full = list(shape)
    if rows is not None:
        full[0] *= rows[1]
    if heads is not None:
        full[1] = heads[1]
    u = torch.rand(full, generator=gen, device=device)
    if rows is not None:
        lo = rows[0] * shape[0]
        u = u[lo:lo + shape[0]]
    if heads is not None and shape[1] != heads[1]:
        u = u[:, heads[0]:heads[0] + shape[1]]
    return u


def dropout(x: torch.Tensor, rate: float,
            gen: Optional[torch.Generator],
            heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout as Flax's ``nn.Dropout``: each element is kept
    with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``. The
    mask comes from ``gen`` (on ``x``'s device; see :func:`draw_uniform`
    for ``heads``); no generator or a zero rate is the identity."""
    if gen is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = draw_uniform(x.shape, gen, x.device, heads) < keep
    return torch.where(mask, x / keep, 0.0)


def device_generator(rng: Optional[torch.Generator], device
                     ) -> Optional[torch.Generator]:
    """A generator on ``device`` seeded with one draw from the host
    generator ``rng`` (None without one)."""
    if rng is None:
        return None
    seed = int(torch.randint(0, 2**62, (1,), generator=rng))
    return torch.Generator(device=device).manual_seed(seed)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are cast to the input's dtype
    (the compute dtype) where they are used."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32 and returned in ``dtype``, as
    Flax's ``LayerNorm(dtype=dtype)`` computes it."""

    def __init__(self, n: int, eps: float, out_dtype: torch.dtype,
                 device=None, dtype=None):
        super().__init__(n, eps=eps, device=device, dtype=dtype)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape,
                            self.weight.float(), self.bias.float(),
                            self.eps).to(self.out_dtype)


def _linear(n_in: int, n_out: int, cfg: XLMRConfig, device) -> Linear:
    return Linear(n_in, n_out, device=device, dtype=cfg.storage_dtype)


def _norm(cfg: XLMRConfig, device) -> LayerNorm:
    return LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, cfg.dtype,
                     device=device, dtype=cfg.storage_dtype)


class SelfAttention(nn.Module):
    def __init__(self, cfg: XLMRConfig, device=None):
        super().__init__()
        self.num_heads = cfg.num_heads  # every rank's heads together
        self.head_dim = cfg.hidden_size // cfg.num_heads
        self.attention_dropout = cfg.attention_dropout
        self.query = _linear(cfg.hidden_size, cfg.hidden_size, cfg, device)
        self.key = _linear(cfg.hidden_size, cfg.hidden_size, cfg, device)
        self.value = _linear(cfg.hidden_size, cfg.hidden_size, cfg, device)
        self.out = _linear(cfg.hidden_size, cfg.hidden_size, cfg, device)
        # tensor parallelism: this rank's first head, and the identity
        # whose backward sums the input's gradient over the model group
        self.head_offset = 0
        self.tp_enter: Optional[Callable] = None

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        B, S, _ = hidden.shape
        if self.tp_enter is not None:
            hidden = self.tp_enter(hidden)
        q = self.query(hidden)
        width = q.shape[-1]  # H, or H / model on a tensor-parallel rank
        n_heads = width // self.head_dim

        def heads(x):  # [B, S, width] -> [B, heads, S, head_dim]
            return x.view(B, S, n_heads, self.head_dim).transpose(1, 2)

        q, k, v = heads(q), heads(self.key(hidden)), heads(self.value(hidden))
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(
            self.head_dim)
        scores = scores + attn_bias  # [B, 1, 1, S] additive mask
        probs = torch.softmax(scores.float(), dim=-1).to(hidden.dtype)
        probs = dropout(probs, self.attention_dropout, gen,
                        heads=(self.head_offset, self.num_heads))
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, width)
        return self.out(ctx)


class EncoderLayer(nn.Module):
    def __init__(self, cfg: XLMRConfig, device=None):
        super().__init__()
        H = cfg.hidden_size
        self.hidden_dropout = cfg.hidden_dropout
        self.attention = SelfAttention(cfg, device)
        self.attention_ln = _norm(cfg, device)
        self.intermediate = _linear(H, cfg.intermediate_size, cfg, device)
        self.output = _linear(cfg.intermediate_size, H, cfg, device)
        self.output_ln = _norm(cfg, device)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        gen = (None if seed is None else
               torch.Generator(device=hidden.device).manual_seed(seed))
        attn = dropout(self.attention(hidden, attn_bias, gen),
                       self.hidden_dropout, gen)
        hidden = self.attention_ln(hidden + attn)
        mlp = self.output(F.gelu(self.intermediate(hidden)))
        mlp = dropout(mlp, self.hidden_dropout, gen)
        return self.output_ln(hidden + mlp)


class XLMREncoder(nn.Module):
    """RoBERTa-style encoder; ``forward`` returns the last hidden state
    ``[B, S, H]`` in the compute dtype."""

    def __init__(self, cfg: XLMRConfig, device=None):
        super().__init__()
        self.config = cfg
        H = cfg.hidden_size
        store = cfg.storage_dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H, device=device,
                                            dtype=store)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, H, device=device, dtype=store)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, H, device=device, dtype=store)
        self.embeddings_ln = _norm(cfg, device)
        self.layers = nn.ModuleList(
            EncoderLayer(cfg, device) for _ in range(cfg.num_layers))
        self._remat_context = _remat_context(cfg.remat_policy)
        # tensor parallelism: gathers the hidden axis of the summed
        # embedding lookups over the model group
        self.tp_gather: Optional[Callable] = None

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                rng: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        mask = attention_mask.long()
        # RoBERTa position ids: pads get pad_token_id, real tokens count up
        # from pad_token_id + 1 (fairseq/HF convention)
        position_ids = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id
        hidden = (self.word_embeddings(input_ids).to(cfg.dtype)
                  + self.position_embeddings(position_ids).to(cfg.dtype)
                  + self.token_type_embeddings(
                      torch.zeros_like(input_ids)).to(cfg.dtype))
        if self.tp_gather is not None:
            hidden = self.tp_gather(hidden)
        hidden = self.embeddings_ln(hidden)
        hidden = dropout(hidden, cfg.hidden_dropout,
                         device_generator(rng, hidden.device))
        attn_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).to(
            cfg.dtype)
        for layer in self.layers:
            seed = (None if rng is None else
                    int(torch.randint(0, 2**62, (1,), generator=rng)))
            if cfg.remat and torch.is_grad_enabled():
                # the layer's dropout masks come from its seed, so the
                # global RNG state need not be kept for the recompute
                kw = ({"context_fn": self._remat_context}
                      if self._remat_context else {})
                hidden = checkpoint(layer, hidden, attn_bias, seed,
                                    use_reentrant=False,
                                    preserve_rng_state=False, **kw)
            else:
                hidden = layer(hidden, attn_bias, seed)
        return hidden


# -- HF checkpoints ---------------------------------------------------------------

def _hf_key_map(num_layers: int) -> Dict[str, str]:
    """HF ``roberta.*`` state-dict keys (prefix stripped) -> the
    :class:`XLMREncoder` state-dict names. HF Linear weights are already
    ``[out, in]``, as ``nn.Linear`` keeps them."""
    m = {
        "embeddings.word_embeddings.weight": "word_embeddings.weight",
        "embeddings.position_embeddings.weight":
            "position_embeddings.weight",
        "embeddings.token_type_embeddings.weight":
            "token_type_embeddings.weight",
        "embeddings.LayerNorm.weight": "embeddings_ln.weight",
        "embeddings.LayerNorm.bias": "embeddings_ln.bias",
    }
    for i in range(num_layers):
        src, dst = f"encoder.layer.{i}", f"layers.{i}"
        for leaf in ("weight", "bias"):
            for qkv in ("query", "key", "value"):
                m[f"{src}.attention.self.{qkv}.{leaf}"] = \
                    f"{dst}.attention.{qkv}.{leaf}"
            m[f"{src}.attention.output.dense.{leaf}"] = \
                f"{dst}.attention.out.{leaf}"
            m[f"{src}.attention.output.LayerNorm.{leaf}"] = \
                f"{dst}.attention_ln.{leaf}"
            m[f"{src}.intermediate.dense.{leaf}"] = \
                f"{dst}.intermediate.{leaf}"
            m[f"{src}.output.dense.{leaf}"] = f"{dst}.output.{leaf}"
            m[f"{src}.output.LayerNorm.{leaf}"] = f"{dst}.output_ln.{leaf}"
    return m


# safetensors dtype -> (little-endian numpy dtype of the raw bytes, the
# torch dtype those bytes are); BF16 is read as uint16 and reinterpreted
_SAFETENSORS_DTYPES = {"F32": ("<f4", torch.float32),
                       "F16": ("<f2", torch.float16),
                       "BF16": ("<u2", torch.bfloat16)}


class _SafetensorsFile:
    """A ``model.safetensors`` file, ``mmap``ped: a little-endian u64
    header length, a JSON header (``{name: {dtype, shape, data_offsets}}``
    with offsets into the data after it), then the raw tensors."""

    def __init__(self, path: Path):
        self._file = open(path, "rb")
        try:
            self._map = mmap.mmap(self._file.fileno(), 0,
                                  access=mmap.ACCESS_COPY)
            n = int.from_bytes(self._map[:8], "little")
            self.header = json.loads(self._map[8:8 + n])
        except BaseException:
            self.close()
            raise
        self.header.pop("__metadata__", None)
        self._base = 8 + n

    def keys(self):
        return self.header.keys()

    def tensor(self, name: str) -> torch.Tensor:
        """Tensor ``name``, a CPU view of the mapped bytes: copy it before
        the file closes."""
        entry = self.header[name]
        if entry["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{name}: safetensors dtype {entry['dtype']} "
                             f"(reads {sorted(_SAFETENSORS_DTYPES)})")
        raw, dtype = _SAFETENSORS_DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        count = math.prod(entry["shape"])
        if end - begin != count * np.dtype(raw).itemsize:
            raise ValueError(f"{name}: data_offsets {begin}..{end} do not "
                             f"hold shape {entry['shape']} of "
                             f"{entry['dtype']}")
        arr = np.frombuffer(self._map, dtype=raw, count=count,
                            offset=self._base + begin)
        return torch.from_numpy(arr).view(dtype).reshape(entry["shape"])

    def close(self) -> None:
        if getattr(self, "_map", None) is not None:
            self._map.close()
        self._file.close()


def load_hf_checkpoint(model_dir: str | Path,
                       config: Optional[XLMRConfig] = None,
                       dtype: torch.dtype = torch.float32,
                       device="cuda") -> Dict[str, torch.Tensor]:
    """The :class:`XLMREncoder` state dict of an HF xlm-roberta checkpoint
    directory, in ``dtype`` on ``device`` (the card unless asked for the
    CPU).

    Reads ``model.safetensors`` (F32, F16 or BF16, ``mmap``ped, one tensor
    at a time) or else ``pytorch_model.bin`` (``torch.load`` with
    ``weights_only=True``); a ``roberta.`` key prefix is stripped. The
    config defaults to the directory's ``config.json``. Raises
    ``KeyError`` naming a weight the checkpoint lacks, and
    ``FileNotFoundError`` when the directory holds neither file."""
    device = resolve_device(device)
    model_dir = Path(model_dir)
    if config is None:
        config = XLMRConfig.from_hf_config(model_dir / "config.json")
    key_map = _hf_key_map(config.num_layers)
    st_path = model_dir / "model.safetensors"
    pt_path = model_dir / "pytorch_model.bin"
    if st_path.exists():
        source = _SafetensorsFile(st_path)
        read, close = source.tensor, source.close
        names = source.keys()
    elif pt_path.exists():
        raw = torch.load(pt_path, map_location="cpu", weights_only=True)
        read, close, names = raw.__getitem__, raw.clear, raw.keys()
    else:
        raise FileNotFoundError(
            f"no model.safetensors or pytorch_model.bin in {model_dir}")
    try:
        by_key = {k[len("roberta."):] if k.startswith("roberta.") else k: k
                  for k in names}
        state = {}
        for hf_key, ours in key_map.items():
            if hf_key not in by_key:
                raise KeyError(f"missing weight in checkpoint: {hf_key}")
            state[ours] = read(by_key[hf_key]).to(device=device, dtype=dtype,
                                                  copy=True)
    finally:
        close()
    return state
