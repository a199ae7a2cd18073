"""Optimizer and LR schedules for fine-tuning (counterpart of
``kbner_tpu/train/optim.py``), written on tensors to optax's bookkeeping:

  - two parameter groups: the encoder at ``lr``, everything else at
    ``lr * lr_rate``, each with its own AdamW state;
  - AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
    parameter) with a schedule read at the update count *before* the
    update, so a linear warmup's first update has lr 0, as
    ``optax.linear_schedule`` gives;
  - one update count for the whole optimizer, advanced on every update
    whatever the gradients are (a frozen group keeps counting, as optax's
    does: freezing multiplies gradients by 0 and is the caller's);
  - clipping by the global norm of all gradients before the update;
  - accumulation as ``optax.MultiSteps``: the running mean of k micro-step
    gradients, and only every k-th call updates (and advances the count);
  - the first moment optionally stored in bfloat16 (``mu_dtype``), computed
    in float32.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Schedule = Callable[[int], float]


def linear_warmup_linear_decay(peak_lr: float, warmup_steps: int,
                               total_steps: int) -> Schedule:
    """0 -> peak over ``warmup_steps`` (at least 1), then peak -> 0 over
    the rest, as optax's joined linear schedules compute it."""
    warmup_steps = max(warmup_steps, 1)
    decay_steps = max(total_steps - warmup_steps, 1)

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak_lr * count / warmup_steps
        done = min(count - warmup_steps, decay_steps)
        return peak_lr * (1.0 - done / decay_steps)

    return schedule


def inverse_sqrt_schedule(peak_lr: float, warmup_steps: int) -> Schedule:
    """Linear warmup, then decay as ``peak * sqrt(warmup / step)``."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(count: int) -> float:
        step = max(count, 1)
        if step < warmup_steps:
            return peak_lr * step / warmup_steps
        return peak_lr * math.sqrt(warmup_steps / step)

    return schedule


def is_encoder_param(name: str) -> bool:
    """An encoder parameter: one with ``encoder`` among its path's names,
    the plain tagger's ``encoder.*`` and a stack's
    ``stack.members.<i>.encoder.*`` alike (optax's ``encoder`` label)."""
    return "encoder" in name.split(".")


class FinetuneOptimizer:
    """Two-group AdamW over named parameters, updated in place.

    Call :meth:`step` after the gradients of one micro-batch are in each
    parameter's ``.grad``; it returns True when it updated the
    parameters (every ``accumulation_steps``-th call). The update count
    and the moments live on the object, so a checkpoint of
    :meth:`state_dict` resumes it."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        schedules: Dict[str, Schedule],
        weight_decay: float = 0.0,
        grad_clip: float = 5.0,
        accumulation_steps: int = 1,
        mu_dtype: Optional[torch.dtype] = None,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
    ):
        self.groups: Dict[str, List[torch.nn.Parameter]] = {
            "encoder": [], "head": []}
        for name, p in named_params:
            self.groups["encoder" if is_encoder_param(name) else "head"
                        ].append(p)
        self.schedules = schedules
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.k = accumulation_steps
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0  # updates made (optax's inner count)
        self.mini_step = 0  # micro-steps accumulated toward the next one
        params = self.params
        self.mu = [torch.zeros_like(p, dtype=mu_dtype or p.dtype)
                   for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.acc = ([torch.zeros_like(p) for p in params]
                    if self.k > 1 else None)

    @property
    def params(self) -> List[torch.nn.Parameter]:
        return self.groups["encoder"] + self.groups["head"]

    def lr(self, group: str) -> float:
        """The group's learning rate of the next update."""
        return self.schedules[group](self.count)

    @torch.no_grad()
    def step(self) -> bool:
        """Take this micro-batch's gradients (a missing ``.grad`` counts
        as zeros); clipping scales them in place."""
        params = self.params
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.acc is not None:
            # running mean of the micro-step gradients (optax.MultiSteps)
            torch._foreach_lerp_(self.acc, grads, 1.0 / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads = self.acc
        if self.grad_clip and self.grad_clip > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        self._adamw(params, grads)
        if self.acc is not None:
            torch._foreach_zero_(self.acc)
        return True

    def _adamw(self, params: Sequence[torch.Tensor],
               grads: List[torch.Tensor]) -> None:
        b1, b2 = self.b1, self.b2
        n = self.count + 1
        # bias corrections in float32, as optax computes them (0.999 in
        # float32 moves 1 - 0.999 by 1.3e-5 relative)
        one = np.float32(1.0)
        bc1 = float(one - np.float32(b1) ** np.float32(n))
        bc2 = float(one - np.float32(b2) ** np.float32(n))
        n_enc = len(self.groups["encoder"])
        if self.mu[0].dtype == torch.float32:
            mu = self.mu
            torch._foreach_mul_(mu, b1)
        else:
            # optax takes b1 * mu in mu's dtype, b1 rounded to it as a
            # weakly typed scalar (0.8984375 in bfloat16), then adds the
            # float32 (1 - b1) * g
            b1_low = float(torch.tensor(b1, dtype=self.mu[0].dtype))
            mu = [(m * b1_low).float() for m in self.mu]
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu, bc1)
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, list(params), alpha=self.weight_decay)
        for group, sl in (("encoder", slice(0, n_enc)),
                          ("head", slice(n_enc, None))):
            lr = self.lr(group)
            if lr and params[sl]:
                torch._foreach_add_(list(params[sl]), upd[sl], alpha=-lr)
        for m, new in zip(self.mu, mu):
            if m is not new:
                m.copy_(new)
        self.count = n

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "mu": self.mu, "nu": self.nu, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.count = state["count"]
        self.mini_step = state["mini_step"]
        for dst, src in (("mu", state["mu"]), ("nu", state["nu"]),
                         ("acc", state["acc"])):
            if src is not None:
                for d, s in zip(getattr(self, dst), src):
                    d.copy_(s)


def make_finetune_optimizer(
    named_params: Iterable[Tuple[str, torch.nn.Parameter]],
    lr: float,
    lr_rate: float = 1.0,
    schedule_fn: Optional[Callable[[float], Schedule]] = None,
    warmup_steps: int = 0,
    total_steps: int = 10000,
    weight_decay: float = 0.0,
    grad_clip: float = 5.0,
    accumulation_steps: int = 1,
    use_inverse_sqrt: bool = False,
    mu_dtype: Optional[torch.dtype] = None,
) -> FinetuneOptimizer:
    """Two-group AdamW: encoder parameters at ``lr``, everything else at
    ``lr * lr_rate``, each on the chosen schedule."""

    def make_sched(peak: float) -> Schedule:
        if schedule_fn is not None:
            return schedule_fn(peak)
        if use_inverse_sqrt:
            return inverse_sqrt_schedule(peak, warmup_steps)
        return linear_warmup_linear_decay(peak, warmup_steps, total_steps)

    return FinetuneOptimizer(
        named_params,
        {"encoder": make_sched(lr), "head": make_sched(lr * lr_rate)},
        weight_decay=weight_decay, grad_clip=grad_clip,
        accumulation_steps=accumulation_steps, mu_dtype=mu_dtype)


class ReduceLROnPlateau:
    """Host-side plateau LR controller: callers scale the LR between
    epochs by the returned factor and stop when it floors."""

    def __init__(self, factor: float = 0.5, patience: int = 3,
                 min_lr_factor: float = 1e-3, mode: str = "max"):
        self.factor = factor
        self.patience = patience
        self.min_lr_factor = min_lr_factor
        self.mode = mode
        self.best: Optional[float] = None
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        """Update with this epoch's metric; returns the current LR scale."""
        improved = (
            self.best is None
            or (metric > self.best if self.mode == "max"
                else metric < self.best)
        )
        if improved:
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale = max(self.scale * self.factor,
                                 self.min_lr_factor)
                self.bad_epochs = 0
        return self.scale

    @property
    def floored(self) -> bool:
        return self.scale <= self.min_lr_factor
