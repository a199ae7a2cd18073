"""SWAF system combination (counterpart of
``kbner_tpu/models/ensemble_model.py``).

Given S systems' tags for the same sentences, :class:`EnsembleModel`
learns per-token weights for the systems from their one-hot predictions:
a Dense layer, relu, and a Dense layer to S scores, trained with binary
cross-entropy on whether each system was right. At decode time the
systems vote, each weighted by the sigmoid of its score.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from .embedders import reset_dense_


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    num_systems: int
    num_labels: int
    hidden: int = 128


class EnsembleModel(nn.Module):
    """Float32 parameters on ``device`` (the card by default), drawn as
    Flax's ``Dense`` draws them (lecun_normal kernels, zero biases) from a
    generator seeded with ``seed``."""

    def __init__(self, config: EnsembleConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        S, L = config.num_systems, config.num_labels
        self.hidden = nn.Linear(S * L, config.hidden, device=device)
        self.hidden2score = nn.Linear(config.hidden, S, device=device)
        gen = torch.Generator(device=device).manual_seed(seed)
        reset_dense_(self.hidden, gen)
        reset_dense_(self.hidden2score, gen)

    def forward(self, system_onehots: torch.Tensor) -> torch.Tensor:
        """``[B, W, S, L]`` one-hot system predictions -> ``[B, W, S]``
        scores."""
        B, W, S, L = system_onehots.shape
        x = system_onehots.reshape(B, W, S * L).float()
        return self.hidden2score(F.relu(self.hidden(x)))

    def loss(self, system_onehots: torch.Tensor, correct: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
        """Binary cross-entropy of each system's score against whether it
        was right, averaged over systems, then over unmasked tokens."""
        logits = self(system_onehots)
        t = correct.float()
        per = -(t * F.logsigmoid(logits)
                + (1 - t) * F.logsigmoid(-logits)).mean(-1)
        m = mask.float()
        return (per * m).sum() / m.sum().clamp(min=1.0)

    @torch.no_grad()
    def combine(self, system_onehots: torch.Tensor) -> torch.Tensor:
        """The weighted vote: combined label ids ``[B, W]`` int32 (the
        first label among equal votes)."""
        weights = torch.sigmoid(self(system_onehots))
        votes = torch.einsum("bwsl,bws->bwl", system_onehots.float(), weights)
        return votes.argmax(-1).to(torch.int32)


def encode_system_predictions(
    all_system_tags: Sequence[Sequence[Sequence[str]]],
    gold_tags: Sequence[Sequence[str]],
    label_dict,
    word_bucket: int = 8,
) -> Dict[str, np.ndarray]:
    """S systems' tag strings and the gold tags as arrays: ``system_onehots``
    ``[B, W, S, L]``, ``correct`` ``[B, W, S]``, ``mask`` ``[B, W]`` and
    ``gold_ids`` ``[B, W]``, W the longest gold sentence rounded up to
    ``word_bucket``. A system's missing word reads as ``O``; a tag outside
    ``label_dict`` as label 0."""
    S, B, L = len(all_system_tags), len(gold_tags), len(label_dict)
    W = max((len(g) for g in gold_tags), default=1)
    W = ((W + word_bucket - 1) // word_bucket) * word_bucket
    onehots = np.zeros((B, W, S, L), dtype=np.float32)
    correct = np.zeros((B, W, S), dtype=np.float32)
    mask = np.zeros((B, W), dtype=np.int32)
    gold_ids = np.zeros((B, W), dtype=np.int32)
    for b, gold in enumerate(gold_tags):
        for w, g in enumerate(gold[:W]):
            mask[b, w] = 1
            gid = label_dict.item2idx.get(g, 0)
            gold_ids[b, w] = gid
            for s in range(S):
                tags = all_system_tags[s][b]
                pid = label_dict.item2idx.get(
                    tags[w] if w < len(tags) else "O", 0)
                onehots[b, w, s, pid] = 1.0
                correct[b, w, s] = float(pid == gid)
    return {"system_onehots": onehots, "correct": correct, "mask": mask,
            "gold_ids": gold_ids}


class SWAFTrainer:
    """Trains an :class:`EnsembleModel` on the dev split's system arrays
    and combines the test split's, on the model's device."""

    def __init__(self, model: EnsembleModel):
        self.model = model

    def _tensors(self, arrays: Dict[str, np.ndarray]):
        dev = self.model.hidden.weight.device
        return {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}

    def train(self, arrays: Dict[str, np.ndarray], steps: int = 200,
              lr: float = 1e-2) -> List[float]:
        """``steps`` full-batch steps of Adam at a constant ``lr`` (b1 0.9,
        b2 0.999, eps 1e-8 outside the square root, bias-corrected, as
        ``optax.adam``). Returns each step's loss."""
        from ..train.optim import make_finetune_optimizer

        t = self._tensors(arrays)
        opt = make_finetune_optimizer(
            self.model.named_parameters(), lr=lr,
            schedule_fn=lambda peak: (lambda count: peak), grad_clip=0.0)
        losses = []
        for _ in range(steps):
            loss = self.model.loss(t["system_onehots"], t["correct"],
                                   t["mask"])
            loss.backward()
            opt.step()
            self.model.zero_grad(set_to_none=True)
            losses.append(loss.detach())
        return [float(v) for v in torch.stack(losses).cpu()] if losses \
            else []

    def combine(self, arrays: Dict[str, np.ndarray]) -> np.ndarray:
        return self.model.combine(
            self._tensors(arrays)["system_onehots"]).cpu().numpy()
