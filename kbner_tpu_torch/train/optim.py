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
    in float32;
  - on a mesh's slices (``parallel/sharding_rules.py``) the global norm
    sums each leaf's squared norm over the world, weighted by one over
    the ranks that hold the same slice, so a replicated leaf counts once;
    the moments exist for the rank's slices only.

:class:`SGDW` and :func:`exp_anneal_schedule` are the reference's
``sgdw`` and ``exp_anneal_schedule``; as there, no trainer uses them.

:func:`optax_state` and :func:`from_optax_state` carry the state to and
from the tree ``kbner_tpu``'s optimizer keeps (``optax.MultiSteps`` of
``clip_by_global_norm`` and ``multi_transform`` of two masked AdamW
chains), in the layout ``flax.serialization`` writes, so either package
resumes the other's ``checkpoint.msgpack``.
"""

from __future__ import annotations

import math
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from ..utils.spans import span

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
    and the moments live on the object (:meth:`named_moments`,
    :func:`optax_state`), so a checkpoint of them resumes it."""

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
        norm_weights: Optional[Mapping[str, float]] = None,
        norm_group=None,
    ):
        self.groups: Dict[str, List[torch.nn.Parameter]] = {
            "encoder": [], "head": []}
        names: Dict[str, List[str]] = {"encoder": [], "head": []}
        for name, p in named_params:
            group = "encoder" if is_encoder_param(name) else "head"
            self.groups[group].append(p)
            names[group].append(name)
        self.names = names["encoder"] + names["head"]  # as :attr:`params`
        # a sharded model: each leaf's weight in the world's squared norm
        self.norm_weights = (None if norm_weights is None else
                             [norm_weights[n] for n in self.names])
        self.norm_group = norm_group
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
            with span("kbner.optim.clip"):
                norm = self._global_norm(grads)
                scale = torch.where(norm < self.grad_clip, 1.0,
                                    self.grad_clip / norm)
                torch._foreach_mul_(grads, scale)
        with span("kbner.optim.update"):
            self._adamw(params, grads)
            if self.acc is not None:
                torch._foreach_zero_(self.acc)
        return True

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch.stack(torch._foreach_norm(grads))
        if self.norm_weights is None:
            return torch.linalg.vector_norm(norms)
        import torch.distributed as dist

        w = torch.tensor(self.norm_weights, dtype=norms.dtype,
                         device=norms.device)
        total = (norms.square() * w).sum()
        dist.all_reduce(total, group=self.norm_group)
        return total.sqrt()

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

    def named_moments(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """``{"mu": {name: tensor}, "nu": ..., "acc": ...}`` (``acc``
        without accumulation is absent), by parameter name."""
        out = {"mu": self.mu, "nu": self.nu}
        if self.acc is not None:
            out["acc"] = self.acc
        return {k: dict(zip(self.names, v)) for k, v in out.items()}

    @torch.no_grad()
    def load_named_moments(self, moments: Mapping[str, Mapping[str, Any]]
                           ) -> None:
        """Copy :meth:`named_moments`-shaped tensors into the state (each
        cast to its moment's dtype)."""
        for key, named in moments.items():
            for name, dst in zip(self.names, getattr(self, key)):
                dst.copy_(named[name])


# -- the optax state tree ---------------------------------------------------------

def _masked(tree: Mapping[str, Any], encoder: bool, inside: bool = False
            ) -> Dict[str, Any]:
    """``tree`` with the leaves of the other group as ``{}`` (optax's
    ``MaskedNode`` as flax writes it): a leaf is the encoder's when a key
    on its path is ``encoder``, as optax's labels say."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        under = inside or k == "encoder"
        if isinstance(v, dict):
            out[k] = _masked(v, encoder, under)
        else:
            out[k] = v if under == encoder else {}
    return out


def _unmasked(a: Mapping[str, Any], b: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`_masked`: each leaf from whichever of the two
    group trees holds it."""
    out: Dict[str, Any] = {}
    for k, v in a.items():
        if isinstance(v, dict) and v:
            out[k] = _unmasked(v, b[k])
        else:
            out[k] = b[k] if isinstance(v, dict) else v
    return out


def optax_state(opt: FinetuneOptimizer,
                moments: Mapping[str, Mapping[str, torch.Tensor]],
                target) -> Dict[str, Any]:
    """The state of ``kbner_tpu``'s ``make_finetune_optimizer`` (with
    ``opt``'s clipping and accumulation) as ``flax.serialization`` writes
    it, from ``opt``'s counts and the full (gathered) ``moments`` of
    :meth:`~FinetuneOptimizer.named_moments`. Moments carry the names and
    transposes of the parameters (``weights.to_jax_params`` of
    ``target``); a bfloat16 ``mu`` stays bfloat16. Optax keeps one
    ``count`` per AdamW and schedule; the port's single count fills all
    four."""
    from .. import weights

    count = np.array(opt.count, np.int32)

    def tree(named):
        out = weights.to_jax_params(named, target)
        dtype = next(iter(named.values())).dtype
        if dtype != torch.float32:  # exact: the values are dtype's
            out = _map_leaves(out, lambda a: torch.from_numpy(a).to(dtype))
        return out

    mu, nu = tree(moments["mu"]), tree(moments["nu"])
    inner = {"inner_states": {group: {"inner_state": {
        "0": {"count": count, "mu": _masked(mu, group == "encoder"),
              "nu": _masked(nu, group == "encoder")},
        "1": {},
        "2": {"count": count}}} for group in ("encoder", "head")}}
    if opt.grad_clip and opt.grad_clip > 0:
        inner = {"0": {}, "1": inner}
    if opt.acc is None:
        return inner
    return {"mini_step": np.array(opt.mini_step, np.int32),
            "gradient_step": count, "inner_opt_state": inner,
            "acc_grads": tree(moments["acc"]), "skip_state": {}}


def from_optax_state(tree: Mapping[str, Any], opt: FinetuneOptimizer,
                     target) -> Tuple[int, int, Dict[str, Dict[str, Any]]]:
    """``(count, mini_step, moments)`` of an optax state tree (as
    :func:`optax_state` or ``kbner_tpu``'s trainer writes it), the moments
    full and by parameter name (``weights.from_jax_params`` of
    ``target``). Raises ``ValueError`` when the tree's accumulation or
    clipping differs from ``opt``'s."""
    from .. import weights

    multi = "inner_opt_state" in tree
    if multi != (opt.acc is not None):
        raise ValueError(f"the checkpoint's optimizer "
                         f"{'accumulates' if multi else 'does not accumulate'}"
                         f" gradients; this one has accumulation_steps="
                         f"{opt.k}")
    inner = tree["inner_opt_state"] if multi else tree
    clipped = bool(opt.grad_clip and opt.grad_clip > 0)
    if ("inner_states" not in inner) != clipped:
        raise ValueError("the checkpoint's optimizer and this one differ in "
                         "global-norm clipping")
    if clipped:
        inner = inner["1"]
    enc, head = (inner["inner_states"][g]["inner_state"]["0"]
                 for g in ("encoder", "head"))

    def named(a, b):
        return weights.from_jax_params(_unmasked(a, b), target)

    moments = {"mu": named(enc["mu"], head["mu"]),
               "nu": named(enc["nu"], head["nu"])}
    if multi:
        moments["acc"] = weights.from_jax_params(tree["acc_grads"], target)
    mini_step = int(np.asarray(tree["mini_step"])) if multi else 0
    return int(np.asarray(enc["count"])), mini_step, moments


def _map_leaves(tree: Mapping[str, Any], fn) -> Dict[str, Any]:
    return {k: _map_leaves(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


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
    norm_weights: Optional[Mapping[str, float]] = None,
    norm_group=None,
) -> FinetuneOptimizer:
    """Two-group AdamW: encoder parameters at ``lr``, everything else at
    ``lr * lr_rate``, each on the chosen schedule. On a sharded model
    ``norm_weights`` (by name: one over the ranks that hold each slice)
    and ``norm_group`` (the world) make the clipping norm global."""

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
        accumulation_steps=accumulation_steps, mu_dtype=mu_dtype,
        norm_weights=norm_weights, norm_group=norm_group)


def exp_anneal_schedule(base_lr: float, gamma: float) -> Schedule:
    """``base_lr * gamma ** count`` (the reference's ExpAnnealLR, optax's
    ``exponential_decay`` with ``transition_steps=1``, not staircased)."""

    def schedule(count: int) -> float:
        return base_lr * gamma ** count

    return schedule


class SGDW(torch.optim.Optimizer):
    """SGD with momentum and decoupled weight decay (the reference's
    ``sgdw``, flair's SGDW), as optax's chain ``trace(momentum)`` ->
    ``add_decayed_weights(weight_decay)`` -> ``scale_by_learning_rate``
    computes it: ``m = g + momentum * m``, then ``p -= lr * (m +
    weight_decay * p)``, the decay added after the momentum trace (where
    ``torch.optim.SGD`` adds it to the gradient before). ``lr`` is a
    float or a schedule of the group's update count, read before the
    update. A parameter without a gradient is skipped. Each product and
    sum is its own rounding, so the update is the same on every
    device."""

    def __init__(self, params, lr: float | Schedule, momentum: float = 0.9,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, momentum=momentum,
                                      weight_decay=weight_decay, count=0))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            lr = group["lr"]
            lr = lr(group["count"]) if callable(lr) else lr
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "momentum_buffer" not in state:
                    state["momentum_buffer"] = torch.zeros_like(p)
                m = state["momentum_buffer"]
                m.mul_(group["momentum"]).add_(p.grad)
                if group["weight_decay"] > 0:
                    u = torch.mul(p, group["weight_decay"]).add_(m)
                    u.mul_(-lr)
                else:
                    u = m * -lr
                p.add_(u)
            group["count"] += 1
        return loss


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
