"""Distillation and multi-view agreement losses (counterpart of
``kbner_tpu/ops/losses.py``): temperature distillation over logits,
posterior distillation over CRF marginals, multi-view agreement (the
context view, detached, teaches the context-free view), L2 feature
matching, and token cross-entropy with an entropy term.

All take explicit ``[B, W]`` masks and average over unmasked positions:
over the batch's own count of them, or over ``norm`` where a caller gives
one (a data-parallel rank's share of the global batch's count).
"""

from __future__ import annotations

from typing import Literal, Optional

import torch
import torch.nn.functional as F


def _masked_mean(per_token: torch.Tensor, mask: torch.Tensor,
                 norm: Optional[float] = None) -> torch.Tensor:
    mask = mask.float()
    if norm is None:
        norm = mask.sum().clamp(min=1.0)
    return (per_token * mask).sum() / norm


def distillation_loss(
    student_logits: torch.Tensor,  # [B, W, K]
    teacher_logits: torch.Tensor,  # [B, W, K]
    mask: torch.Tensor,  # [B, W]
    temperature: float = 1.0,
    kind: Literal["ce", "mse"] = "ce",
    norm: Optional[float] = None,
) -> torch.Tensor:
    """Logit distillation with temperature (teacher side detached)."""
    t = temperature
    teacher = teacher_logits.detach()
    if kind == "mse":
        per = ((F.softmax(teacher / t, -1)
                - F.softmax(student_logits / t, -1)) ** 2).mean(-1)
    else:
        p_teacher = F.softmax(teacher / t, dim=-1)
        logq = F.log_softmax(student_logits / t, dim=-1)
        per = -(p_teacher * logq).sum(-1) * (t * t)
    return _masked_mean(per, mask, norm)


def posterior_distillation_loss(
    student_marginals: torch.Tensor,  # [B, W, K], rows sum to 1
    teacher_marginals: torch.Tensor,  # [B, W, K]
    mask: torch.Tensor,  # [B, W]
    eps: float = 1e-8,
    norm: Optional[float] = None,
) -> torch.Tensor:
    """Cross-entropy between teacher and student posterior tag
    marginals."""
    teacher = teacher_marginals.detach()
    per = -(teacher * torch.log(student_marginals + eps)).sum(-1)
    return _masked_mean(per, mask, norm)


def multi_view_loss(
    context_marginals: torch.Tensor,  # [B, W, K] from the context view
    orig_marginals: torch.Tensor,  # [B, W, K] from the context-free view
    mask: torch.Tensor,  # [B, W] original-sentence positions only
    kind: Literal["kl", "ce"] = "kl",
    eps: float = 1e-8,
    norm: Optional[float] = None,
) -> torch.Tensor:
    """The context view (detached) teaches the context-free view on the
    shared original-sentence positions, by KL or cross-entropy."""
    teacher = context_marginals.detach()
    if kind == "ce":
        per = -(teacher * torch.log(orig_marginals + eps)).sum(-1)
    else:
        per = (teacher * (torch.log(teacher + eps)
                          - torch.log(orig_marginals + eps))).sum(-1)
    return _masked_mean(per, mask, norm)


def feature_l2_loss(
    context_features: torch.Tensor,  # [B, W, H]
    orig_features: torch.Tensor,  # [B, W, H]
    mask: torch.Tensor,  # [B, W]
    norm: Optional[float] = None,
) -> torch.Tensor:
    """L2 feature matching between the two views (context side
    detached)."""
    per = ((context_features.detach() - orig_features) ** 2).sum(-1)
    return _masked_mean(per, mask, norm)


def token_ce_entropy_loss(
    logits: torch.Tensor,  # [B, W, K]
    tags: Optional[torch.Tensor],  # [B, W] or None for unlabeled
    mask: torch.Tensor,  # [B, W]
    entropy_weight: float = 0.0,
) -> torch.Tensor:
    """Token cross-entropy (with gold tags), plus an entropy penalty for
    unlabeled data."""
    logp = F.log_softmax(logits, dim=-1)
    loss = torch.zeros((), dtype=logp.dtype, device=logp.device)
    if tags is not None:
        gold = torch.gather(logp, -1, tags.long().unsqueeze(-1)).squeeze(-1)
        loss = -_masked_mean(gold, mask)
    if entropy_weight > 0:
        ent = -(logp.exp() * logp).sum(-1)
        loss = loss + entropy_weight * _masked_mean(ent, mask)
    return loss
