"""Character language-model trainer (counterpart of
``kbner_tpu/train/lm_trainer.py``): trains a
:class:`~..models.embedders.CharLMHead` on plain text with next-character
cross-entropy, through global-norm clipping then Adam (optax's
``chain(clip_by_global_norm, adam)``, on the port's optimizer with a
constant rate). The trained LM's parameters slot into a
:class:`~..models.embedders.FlairLMEmbedder` (backward LMs train on
reversed streams). ``char-lm.msgpack`` is the Flax tree ``{"params":
{"lm": ..., "decoder": ...}}`` that ``kbner_tpu``'s trainer writes.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import List

import numpy as np
import torch

from .. import weights
from ..data.dictionary import Dictionary
from ..device import resolve_device
from ..models.embedders import CharLMHead
from .optim import make_finetune_optimizer

log = logging.getLogger("kbner_tpu_torch")


@dataclasses.dataclass
class LMTrainConfig:
    learning_rate: float = 1e-3
    batch_size: int = 16
    seq_len: int = 128
    max_steps: int = 1000
    grad_clip: float = 5.0
    seed: int = 0
    backward: bool = False  # train on reversed character streams
    log_every: int = 100


def build_char_stream(texts: List[str], vocab: Dictionary) -> np.ndarray:
    """The texts' character ids in one int32 stream, each text followed by
    the newline's id (the space's, else 0, without one)."""
    nl = vocab.item2idx.get("\n", vocab.item2idx.get(" ", 0))
    ids: List[int] = []
    for t in texts:
        ids.extend(vocab.item2idx.get(ch, 0) for ch in t)
        ids.append(nl)
    return np.asarray(ids, dtype=np.int32)


class LanguageModelTrainer:
    """Trains ``model`` on ``device`` (the card by default)."""

    def __init__(self, model: CharLMHead, vocab: Dictionary, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.vocab = vocab

    def train(self, texts: List[str], base_path: str | Path,
              config: LMTrainConfig) -> dict:
        """``max_steps`` steps on windows of ``seq_len`` characters at
        offsets drawn from ``RandomState(seed)``; writes
        ``char-lm.msgpack``. Returns the final loss and every step's."""
        base_path = Path(base_path)
        base_path.mkdir(parents=True, exist_ok=True)
        stream = build_char_stream(texts, self.vocab)
        if config.backward:
            stream = stream[::-1].copy()
        opt = make_finetune_optimizer(
            self.model.named_parameters(), lr=config.learning_rate,
            schedule_fn=lambda peak: (lambda count: peak),
            grad_clip=config.grad_clip)
        rng = np.random.RandomState(config.seed)
        B, T = config.batch_size, config.seq_len
        losses: List[float] = []
        t0 = time.time()
        for it in range(config.max_steps):
            if len(stream) <= T + 1:
                starts = np.zeros(B, dtype=np.int64)
            else:
                starts = rng.randint(0, len(stream) - T - 1, size=B)
            batch = torch.from_numpy(
                np.stack([stream[s:s + T] for s in starts])).to(self.device)
            loss = self.model.loss(batch, torch.ones_like(batch))
            loss.backward()
            opt.step()
            self.model.zero_grad(set_to_none=True)
            losses.append(float(loss.detach()))
            if (it + 1) % config.log_every == 0:
                ppl = float(np.exp(np.mean(losses[-config.log_every:])))
                log.info("lm step %d: ppl %.2f (%.1fs)", it + 1, ppl,
                         time.time() - t0)
        self.save(base_path / "char-lm.msgpack")
        return {"final_loss": losses[-1] if losses else None,
                "losses": losses}

    def save(self, path: str | Path) -> None:
        weights.save_params(self.model.state_dict(), self.model, path)

    def load(self, path: str | Path) -> None:
        self.model.load_state_dict(weights.load_params(path, self.model))


@torch.no_grad()
def generate_text(model: CharLMHead, vocab: Dictionary, prefix: str = "\n",
                  length: int = 100, temperature: float = 1.0,
                  seed: int = 0) -> str:
    """Sample ``length`` characters after ``prefix``, one forward pass per
    character, from a ``torch.Generator`` seeded with ``seed``."""
    device = model.decoder.weight.device
    gen = torch.Generator(device=device).manual_seed(seed)
    ids = [vocab.item2idx.get(c, 0) for c in prefix] or [0]
    for _ in range(length):
        stream = torch.tensor([ids], dtype=torch.int32, device=device)
        logits = model(stream)[0, -1] / max(temperature, 1e-6)
        ids.append(int(torch.multinomial(torch.softmax(logits, -1), 1,
                                         generator=gen)))
    return "".join(vocab.get_item_for_index(i) for i in ids)
