"""Text classification and regression heads (counterpart of
``kbner_tpu/models/classifier.py``): a document embedding pooled from the
XLM-R encoder's token states, then a float32 linear head; CE (or BCE for
multi-label) for classification, MSE for regression.

Pooling (``TextClassifierConfig.pooling``): ``cls`` (the first token),
``mean``, ``max``, ``min`` and ``min_max_mean`` over the real tokens, or
``rnn``: a GRU (:class:`~.embedders.FlaxGRU`, Flax's ``GRUCell``) over the
tokens, read at each document's last real token. Modules are made on
``device`` (the card by default) and drawn from a ``torch.Generator``
seeded with ``seed`` from Flax's distributions; dropout (the encoder's,
and the classifier's on the document embedding) is on only when a host
generator is passed as ``rng``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .embedders import FlaxGRU, _dense, reset_flax_
from .xlmr import XLMRConfig, XLMREncoder, device_generator, dropout

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TextClassifierConfig:
    encoder: XLMRConfig
    num_labels: int
    multi_label: bool = False
    dropout: float = 0.1
    # "cls" | "mean" | "max" | "min" | "min_max_mean" | "rnn"
    pooling: str = "cls"
    rnn_hidden: int = 128


def _pool_tokens(hidden: torch.Tensor, mask: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """Masked pooling over the subtoken axis: ``[B, S, D]`` -> ``[B, D]``."""
    m = mask.float()[:, :, None]
    if mode == "mean":
        return (hidden * m).sum(1) / m.sum(1).clamp(min=1.0)
    if mode == "max":
        return torch.where(m > 0, hidden, -torch.inf).amax(1)
    if mode == "min":
        return torch.where(m > 0, hidden, torch.inf).amin(1)
    if mode == "min_max_mean":
        return torch.cat([_pool_tokens(hidden, mask, m_)
                          for m_ in ("min", "max", "mean")], dim=-1)
    raise ValueError(f"unknown pooling {mode!r}")


class TextClassifier(nn.Module):
    def __init__(self, config: TextClassifierConfig, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        H = config.encoder.hidden_size
        self.encoder = XLMREncoder(config.encoder, device=device)
        self.doc_rnn = (FlaxGRU(H, config.rnn_hidden, device=device)
                        if config.pooling == "rnn" else None)
        width = {"rnn": config.rnn_hidden, "min_max_mean": 3 * H}.get(
            config.pooling, H)
        self.head = _dense(width, config.num_labels, device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        reset_flax_(self, gen)
        if self.doc_rnn is not None:
            self.doc_rnn.reset_parameters(gen)

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def document_embedding(self, batch: Batch,
                           rng: Optional[torch.Generator] = None
                           ) -> torch.Tensor:
        hidden = self.encoder(batch["input_ids"], batch["attention_mask"],
                              rng=rng).float()
        mode = self.config.pooling
        if mode == "cls":
            return hidden[:, 0]
        if mode == "rnn":
            lengths = batch["attention_mask"].long().sum(-1)
            out = self.doc_rnn(hidden, seq_lengths=lengths)
            last = (lengths - 1).clamp(min=0)
            return out.gather(
                1, last[:, None, None].expand(-1, 1, out.shape[-1]))[:, 0]
        return _pool_tokens(hidden, batch["attention_mask"], mode)

    def logits(self, batch: Batch, rng: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        doc = self.document_embedding(batch, rng)
        doc = dropout(doc, self.config.dropout,
                      device_generator(rng, doc.device))
        return self.head(doc)

    def forward(self, batch: Batch, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        return self.logits(batch, rng)

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """CE against ``label_ids`` [B] (BCE against ``label_multi``
        [B, L] for multi-label)."""
        logits = self.logits(batch, rng)
        if self.config.multi_label:
            return optax_sigmoid_ce(
                logits, batch["label_multi"].float()).mean()
        logp = F.log_softmax(logits, dim=-1)
        return -logp.gather(1, batch["label_ids"].long()[:, None]).mean()

    @torch.no_grad()
    def predict(self, batch: Batch) -> torch.Tensor:
        """Label ids ``[B]`` int32 (0/1 ``[B, L]`` for multi-label)."""
        logits = self.logits(batch)
        if self.config.multi_label:
            return (torch.sigmoid(logits) > 0.5).to(torch.int32)
        return logits.argmax(-1).to(torch.int32)


def optax_sigmoid_ce(logits: torch.Tensor, targets: torch.Tensor
                     ) -> torch.Tensor:
    """Elementwise sigmoid cross-entropy, as ``optax.sigmoid_binary_
    cross_entropy``."""
    return -(targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


@dataclasses.dataclass(frozen=True)
class TextRegressorConfig:
    encoder: XLMRConfig
    dropout: float = 0.1


class TextRegressor(nn.Module):
    """A float32 linear head over the first token's state."""

    def __init__(self, config: TextRegressorConfig, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.encoder = XLMREncoder(config.encoder, device=device)
        self.head = _dense(config.encoder.hidden_size, 1, device)
        reset_flax_(self, torch.Generator(device=device).manual_seed(seed))

    @property
    def device(self) -> torch.device:
        return self.head.weight.device

    def forward(self, batch: Batch, rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        hidden = self.encoder(batch["input_ids"], batch["attention_mask"],
                              rng=rng)
        return self.head(hidden[:, 0].float())[:, 0]

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        return ((self(batch, rng) - batch["targets"].float()) ** 2).mean()

    @torch.no_grad()
    def predict(self, batch: Batch) -> torch.Tensor:
        return self(batch)


def encode_labels(records, label_dict, eb) -> None:
    """Attach ``label_ids`` [B] (the first label) and ``label_multi``
    [B, L], int32."""
    B = len(records)
    label_ids = np.zeros((B,), dtype=np.int32)
    multi = np.zeros((B, len(label_dict)), dtype=np.int32)
    for b, rec in enumerate(records):
        for i, lbl in enumerate(rec.labels):
            idx = label_dict.item2idx.get(lbl, 0)
            if i == 0:
                label_ids[b] = idx
            multi[b, idx] = 1
    eb.extra["label_ids"] = label_ids
    eb.extra["label_multi"] = multi


def build_label_dictionary(records):
    """The labels of ``records`` in first-seen order."""
    from ..data.dictionary import Dictionary

    d = Dictionary()
    for rec in records:
        for lbl in rec.labels:
            d.add_item(lbl)
    return d
