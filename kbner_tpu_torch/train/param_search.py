"""Hyperparameter search (counterpart of
``kbner_tpu/train/param_search.py``): random search and a Tree-structured
Parzen Estimator over a :class:`SearchSpace`, each trial a call of
``run_trial(params) -> dev score``, the best setting the highest score.
Pure numpy; the same seed gives the same trials as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SearchSpace:
    """Named choices (lists) or (low, high) uniform/log-uniform ranges."""

    choices: Dict[str, Sequence[Any]] = dataclasses.field(
        default_factory=dict)
    uniform: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)
    log_uniform: Dict[str, Tuple[float, float]] = dataclasses.field(
        default_factory=dict)

    def sample(self, rng: np.random.RandomState) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, vals in self.choices.items():
            out[k] = vals[rng.randint(len(vals))]
        for k, (lo, hi) in self.uniform.items():
            out[k] = float(rng.uniform(lo, hi))
        for k, (lo, hi) in self.log_uniform.items():
            out[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        return out


def random_search(
    space: SearchSpace,
    run_trial: Callable[[Dict[str, Any]], float],
    n_trials: int = 10,
    seed: int = 0,
    base_path: str | Path | None = None,
) -> Dict[str, Any]:
    """Sample settings, run trials, return {best_params, best_score, trials}."""
    rng = np.random.RandomState(seed)
    trials: List[Dict[str, Any]] = []
    best_score, best_params = -np.inf, None
    for i in range(n_trials):
        params = space.sample(rng)
        score = float(run_trial(params))
        trials.append({"params": params, "score": score})
        if score > best_score:
            best_score, best_params = score, params
    result = {"best_params": best_params, "best_score": best_score,
              "trials": trials}
    if base_path is not None:
        Path(base_path).mkdir(parents=True, exist_ok=True)
        (Path(base_path) / "param_search.json").write_text(
            json.dumps(result, indent=2))
    return result


def _parzen_pick(
    rng: np.random.RandomState,
    good: np.ndarray,
    bad: np.ndarray,
    lo: float,
    hi: float,
    n_cand: int = 24,
) -> float:
    """1-D TPE step: draw candidates from a Parzen mixture over the good
    observations, return the one maximizing density(good)/density(bad)."""
    span = hi - lo

    def sigma(n):  # Silverman-style width, floored to keep exploration
        return max(span / max(np.sqrt(n), 1.0) * 0.5, span * 0.05)

    sg, sb = sigma(len(good)), sigma(max(len(bad), 1))
    centers = good[rng.randint(len(good), size=n_cand)]
    cands = np.clip(centers + rng.randn(n_cand) * sg, lo, hi)

    def log_density(x, obs, s):
        if len(obs) == 0:
            return np.full(x.shape, -np.log(span))  # uniform prior
        d = (x[:, None] - obs[None, :]) / s
        m = (-0.5 * d * d).max(axis=1)
        return m + np.log(
            np.exp(-0.5 * d * d - m[:, None]).sum(axis=1) / (len(obs) * s))

    ratio = log_density(cands, good, sg) - log_density(cands, bad, sb)
    return float(cands[np.argmax(ratio)])


def tpe_search(
    space: SearchSpace,
    run_trial: Callable[[Dict[str, Any]], float],
    n_trials: int = 20,
    n_startup: int = 5,
    gamma: float = 0.25,
    seed: int = 0,
    base_path: str | Path | None = None,
) -> Dict[str, Any]:
    """Tree-structured Parzen Estimator search (Bergstra et al. 2011) —
    the reference's ``hyperopt.tpe`` path (``param_selection.py:7,158``).

    The first ``n_startup`` trials sample uniformly; afterwards the trial
    history is split at the ``gamma`` quantile into good/bad sets and each
    parameter is proposed to maximize P(x|good)/P(x|bad): categorical
    parameters via Laplace-smoothed count ratios, continuous (and
    log-continuous, handled in log space) via Gaussian Parzen mixtures.
    Maximizes ``run_trial``'s return value (dev score).
    """
    rng = np.random.RandomState(seed)
    trials: List[Dict[str, Any]] = []

    def propose() -> Dict[str, Any]:
        if len(trials) < n_startup:
            return space.sample(rng)
        scores = np.asarray([t["score"] for t in trials])
        n_good = max(1, int(np.ceil(gamma * len(trials))))
        good_idx = set(np.argsort(-scores)[:n_good].tolist())
        out: Dict[str, Any] = {}
        for k, vals in space.choices.items():
            counts_g = np.ones(len(vals))  # Laplace prior
            counts_b = np.ones(len(vals))
            index = {
                json.dumps(v, sort_keys=True, default=str): i
                for i, v in enumerate(vals)}
            for i, t in enumerate(trials):
                key = json.dumps(t["params"][k], sort_keys=True, default=str)
                (counts_g if i in good_idx else counts_b)[index[key]] += 1
            ratio = (counts_g / counts_g.sum()) / (counts_b / counts_b.sum())
            out[k] = vals[int(np.argmax(ratio))] if rng.rand() > 0.1 else \
                vals[rng.randint(len(vals))]  # 10% exploration
        for k, (lo, hi) in space.uniform.items():
            obs = np.asarray([t["params"][k] for t in trials])
            good = obs[[i in good_idx for i in range(len(trials))]]
            bad = obs[[i not in good_idx for i in range(len(trials))]]
            out[k] = _parzen_pick(rng, good, bad, lo, hi)
        for k, (lo, hi) in space.log_uniform.items():
            obs = np.log(np.asarray([t["params"][k] for t in trials]))
            good = obs[[i in good_idx for i in range(len(trials))]]
            bad = obs[[i not in good_idx for i in range(len(trials))]]
            out[k] = float(np.exp(_parzen_pick(
                rng, good, bad, np.log(lo), np.log(hi))))
        return out

    best_score, best_params = -np.inf, None
    for _ in range(n_trials):
        params = propose()
        score = float(run_trial(params))
        trials.append({"params": params, "score": score})
        if score > best_score:
            best_score, best_params = score, params
    result = {"best_params": best_params, "best_score": best_score,
              "trials": trials}
    if base_path is not None:
        Path(base_path).mkdir(parents=True, exist_ok=True)
        (Path(base_path) / "param_search.json").write_text(
            json.dumps(result, indent=2))
    return result
