"""ACE: automated concatenation of embeddings by reinforcement learning
(counterpart of ``kbner_tpu/train/reinforce.py``).

  - :class:`EmbedController` keeps one Bernoulli logit per stack member
    and samples a selection mask that is neither empty nor already
    visited, from a host ``np.random.RandomState`` (so its draws are the
    reference's);
  - each episode fine-tunes the stacked tagger from its initial
    parameters with the sampled mask; the dev F1 is the reward, shaped
    against the best F1 so far, and a REINFORCE step moves the logits;
  - ``training_state.json`` keeps the episode, logits, baseline and best
    action; the final model is trained with the best action.

The controller is a handful of host numbers; the device work is the
inner fine-tuning through :class:`~.trainer.FinetuneTrainer`.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, List, Optional, Set, Tuple

import numpy as np


@dataclasses.dataclass
class EmbedController:
    """Bernoulli selector over N stack members."""

    num_embeddings: int
    logits: Optional[np.ndarray] = None
    baseline: float = 0.0

    def __post_init__(self):
        if self.logits is None:
            self.logits = np.zeros(self.num_embeddings, dtype=np.float64)

    def probs(self) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.logits))

    def sample(self, rng: np.random.RandomState,
               visited: Set[Tuple[int, ...]]) -> np.ndarray:
        """A non-empty mask not visited yet, from up to 64 draws; else the
        mask of the members at probability >= 0.5 (the likeliest one if
        none is)."""
        p = self.probs()
        for _ in range(64):
            mask = (rng.rand(self.num_embeddings) < p).astype(np.float32)
            if mask.sum() > 0 and tuple(int(x) for x in mask) not in visited:
                return mask
        return self.best_action()

    def best_action(self) -> np.ndarray:
        mask = (self.probs() >= 0.5).astype(np.float32)
        if mask.sum() == 0:
            mask[int(np.argmax(self.probs()))] = 1.0
        return mask

    def update(self, mask: np.ndarray, reward: float, lr: float = 0.1,
               baseline_decay: float = 0.9) -> None:
        """REINFORCE: the logits move by ``lr * (mask - p) * (reward -
        baseline)``; the baseline is a moving average of the rewards."""
        advantage = reward - self.baseline
        grad = (mask - self.probs()) * advantage  # d log Bernoulli / d logit
        self.logits = self.logits + lr * grad
        self.baseline = (baseline_decay * self.baseline
                         + (1 - baseline_decay) * reward)

    def save(self, path: str | Path, episode: int,
             best_action: Optional[np.ndarray] = None) -> None:
        Path(path).write_text(json.dumps({
            "episode": episode,
            "logits": self.logits.tolist(),
            "baseline": self.baseline,
            "best_action": (best_action if best_action is not None
                            else self.best_action()).tolist(),
        }))

    @classmethod
    def load(cls, path: str | Path) -> Tuple["EmbedController", dict]:
        state = json.loads(Path(path).read_text())
        return cls(num_embeddings=len(state["logits"]),
                   logits=np.asarray(state["logits"]),
                   baseline=state["baseline"]), state


@dataclasses.dataclass
class ReinforceConfig:
    episodes: int = 10
    controller_lr: float = 0.1
    reward_kind: str = "plain"  # plain | log | sqrt
    seed: int = 0


class ReinforcementTrainer:
    """The ACE episode loop: ``run_episode(mask) -> dev F1`` fine-tunes
    the tagger with that selection mask."""

    def __init__(self, num_embeddings: int, run_episode: Callable,
                 config: ReinforceConfig):
        self.controller = EmbedController(num_embeddings)
        self.run_episode = run_episode
        self.config = config
        self.history: List[dict] = []

    def _shape_reward(self, f1: float, prev_best: float) -> float:
        gain = f1 - prev_best
        kind = self.config.reward_kind
        if kind == "log":
            return float(np.sign(gain) * np.log1p(abs(gain) * 100))
        if kind == "sqrt":
            return float(np.sign(gain) * np.sqrt(abs(gain)))
        return gain

    def train(self, base_path: str | Path) -> dict:
        base_path = Path(base_path)
        base_path.mkdir(parents=True, exist_ok=True)
        rng = np.random.RandomState(self.config.seed)
        visited: Set[Tuple[int, ...]] = set()
        best_f1, best_mask = -1.0, None
        for episode in range(self.config.episodes):
            mask = self.controller.sample(rng, visited)
            visited.add(tuple(int(x) for x in mask))
            f1 = float(self.run_episode(mask))
            reward = self._shape_reward(f1, best_f1 if best_f1 >= 0 else 0.0)
            self.controller.update(mask, reward, lr=self.config.controller_lr)
            if f1 > best_f1:
                best_f1, best_mask = f1, mask
            self.history.append({"episode": episode, "mask": mask.tolist(),
                                 "f1": f1, "reward": reward})
            self.controller.save(base_path / "training_state.json", episode,
                                 best_mask)
        return {"best_f1": best_f1, "best_action": best_mask.tolist(),
                "history": self.history}


def ace_train(trainer, train_config, base_path: str | Path,
              num_embeddings: int,
              config: Optional[ReinforceConfig] = None) -> dict:
    """The ACE search over ``trainer`` (a FinetuneTrainer of a
    StackedSequenceTagger), then the final training with the best
    action under ``base_path``. Every episode and the final training
    start from a copy of the initial parameters and a fresh optimizer
    (``trainer.train`` makes one); episodes write under
    ``base_path/episode``."""
    base_path = Path(base_path)
    config = config or ReinforceConfig()
    init = {k: v.detach().clone()
            for k, v in trainer.model.state_dict().items()}

    def restart(mask):
        trainer.model.load_state_dict(init)
        trainer.selection = np.asarray(mask, np.float32)

    def run_episode(mask: np.ndarray) -> float:
        restart(mask)
        return trainer.train(base_path / "episode",
                             train_config)["best_dev_score"]

    search = ReinforcementTrainer(num_embeddings, run_episode,
                                  config).train(base_path)
    restart(search["best_action"])
    search["final"] = trainer.train(base_path, train_config)
    return search
