"""Mean-field variational inference over second- and third-order tag
potentials (counterpart of ``kbner_tpu/ops/mfvi.py``):

  pair potential of adjacent words (t, t+1), rank R:
      phi[b, t, k, l] = sum_r (f_t U)_r (f_{t+1} V)_r W1[k, r] W2[l, r]
  triple potential of (t, t+1, t+2):
      psi[b, t, a, b', c] = sum_r g[b, t, r] T1[a, r] T2[b', r] T3[c, r],
      g = (f_t W1)(f_{t+1} W2)(f_{t+2} W3) / sqrt(R), T_i = tag_emb T_i

  ``iterations`` fixed-point updates q <- softmax(unary + pair messages
  + triple messages), from q = softmax(unary).

Triple messages are taken in rank space (q through the tag factors,
products, back through the factors): O(K R) per position where the
materialized ``[B, T-2, K, K, K]`` tensor (:func:`dense_ternary`, for
tests) costs O(K^3). Pairs and triples that cross padding carry no
message. No tagger wires the head in; it stands beside the CRF.
Parameters are drawn as Flax draws them: the factor tables ``W1``,
``W2`` and ``tag_emb`` normal(0, 0.02), the Dense layers (no bias)
lecun-normal.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from ..models.embedders import lecun_normal_

Factors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _linear(n_in: int, n_out: int, device) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, device=device,
                     dtype=torch.float32)


class QuadrilinearPotentials(nn.Module):
    """Low-rank pair potentials of adjacent words."""

    def __init__(self, feat_dim: int, num_tags: int, rank: int = 64,
                 device=None):
        super().__init__()
        self.U = _linear(feat_dim, rank, device)
        self.V = _linear(feat_dim, rank, device)
        self.W1 = nn.Parameter(torch.empty(num_tags, rank, device=device))
        self.W2 = nn.Parameter(torch.empty(num_tags, rank, device=device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for lin in (self.U, self.V):
            lecun_normal_(lin.weight, lin.in_features, gen)
        for t in (self.W1, self.W2):
            t.normal_(0.0, 0.02, generator=gen)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        """``[B, T, H]`` -> pair potentials ``[B, T-1, K, K]``."""
        pair = self.U(feats)[:, :-1] * self.V(feats)[:, 1:]
        return torch.einsum("btr,kr,lr->btkl", pair, self.W1, self.W2)


class HexalinearPotentials(nn.Module):
    """Low-rank triple potentials, returned in rank space: ``g [B, T-2,
    R]`` and the tag factors ``t1, t2, t3 [K, R]``."""

    def __init__(self, feat_dim: int, num_tags: int, rank: int = 64,
                 temb: int = 20, device=None):
        super().__init__()
        self.rank = rank
        for name in ("W1", "W2", "W3"):
            setattr(self, name, _linear(feat_dim, rank, device))
        self.tag_emb = nn.Parameter(torch.empty(num_tags, temb,
                                                device=device))
        for name in ("T1", "T2", "T3"):
            setattr(self, name, _linear(temb, rank, device))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for name in ("W1", "W2", "W3", "T1", "T2", "T3"):
            lin = getattr(self, name)
            lecun_normal_(lin.weight, lin.in_features, gen)
        self.tag_emb.normal_(0.0, 0.02, generator=gen)

    def forward(self, feats: torch.Tensor) -> Factors:
        g = (self.W1(feats[:, :-2]) * self.W2(feats[:, 1:-1])
             * self.W3(feats[:, 2:])) / float(self.rank) ** 0.5
        return g, self.T1(self.tag_emb), self.T2(self.tag_emb), \
            self.T3(self.tag_emb)


def dense_ternary(factors: Factors) -> torch.Tensor:
    """The ``[B, T-2, K, K, K]`` triple potentials. Tests only."""
    g, t1, t2, t3 = factors
    return torch.einsum("ntr,ar,br,cr->ntabc", g, t1, t2, t3)


def ternary_messages(q: torch.Tensor, factors: Factors,
                     triple_mask: torch.Tensor) -> torch.Tensor:
    """Triple messages in rank space: into t+2 from (t, t+1), into t+1
    from (t, t+2), into t from (t+1, t+2); ``triple_mask [B, T-2]``
    silences the triples that cross padding."""
    g, t1, t2, t3 = factors
    g = g * triple_mask[..., None]
    qa = q[:, :-2] @ t1  # [B, T-2, R]
    qb = q[:, 1:-1] @ t2
    qc = q[:, 2:] @ t3
    zeros = q.new_zeros(q.shape[0], 2, q.shape[2])
    return (torch.cat([zeros, (qa * qb * g) @ t3.T], dim=1)
            + torch.cat([zeros[:, :1], (qa * qc * g) @ t2.T, zeros[:, :1]],
                        dim=1)
            + torch.cat([(qb * qc * g) @ t1.T, zeros], dim=1))


def mean_field_iterate(unary: torch.Tensor, binary: torch.Tensor,
                       mask: torch.Tensor, iterations: int = 3,
                       ternary_factors: Optional[Factors] = None
                       ) -> torch.Tensor:
    """``iterations`` mean-field updates over ``unary [B, T, K]``, pair
    potentials ``binary [B, T-1, K, K]`` and, if given, the rank-space
    triple factors; returns q ``[B, T, K]``."""
    mask_f = mask.float()[:, :, None]
    pair_mask = (mask_f[:, :-1] * mask_f[:, 1:])[..., None]  # [B,T-1,1,1]
    binary = binary * pair_mask
    triple_mask = None
    if ternary_factors is not None:
        triple_mask = (mask_f[:, :-2] * mask_f[:, 1:-1]
                       * mask_f[:, 2:])[..., 0]
    zeros = unary.new_zeros(unary.shape[0], 1, unary.shape[2])
    q = torch.softmax(unary, dim=-1)
    for _ in range(iterations):
        # into t from t-1 (sum over k of q[t-1, k] binary[t-1, k, l]) and
        # into t from t+1 (sum over l of q[t+1, l] binary[t, k, l])
        from_left = torch.einsum("btk,btkl->btl", q[:, :-1], binary)
        from_right = torch.einsum("btl,btkl->btk", q[:, 1:], binary)
        total = (unary + torch.cat([zeros, from_left], dim=1)
                 + torch.cat([from_right, zeros], dim=1))
        if ternary_factors is not None:
            total = total + ternary_messages(q, ternary_factors, triple_mask)
        q = torch.softmax(total, dim=-1)
    return q


class MFVIHead(nn.Module):
    """Second- (and with ``use_third_order`` third-) order decoding: the
    emissions ``unary`` plus quadrilinear pair (and hexalinear triple)
    potentials of the word features ``feats [B, T, feat_dim]``, through
    ``iterations`` mean-field updates. Made from ``seed`` on ``device``."""

    def __init__(self, feat_dim: int, num_tags: int, rank: int = 64,
                 iterations: int = 3, use_third_order: bool = False,
                 temb: int = 20, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.iterations = iterations
        self.use_third_order = use_third_order
        self.potentials = QuadrilinearPotentials(feat_dim, num_tags, rank,
                                                 device=device)
        self.ternary = (HexalinearPotentials(feat_dim, num_tags, rank, temb,
                                             device=device)
                        if use_third_order else None)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.potentials.reset_parameters(gen)
        if self.ternary is not None:
            self.ternary.reset_parameters(gen)

    def posteriors(self, feats: torch.Tensor, unary: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
        feats = feats.float()
        factors = self.ternary(feats) if self.ternary is not None else None
        return mean_field_iterate(unary.float(), self.potentials(feats), mask,
                                  self.iterations, ternary_factors=factors)

    def loss(self, feats: torch.Tensor, unary: torch.Tensor,
             tags: torch.Tensor, mask: torch.Tensor,
             eps: float = 1e-8) -> torch.Tensor:
        """Mean negative log posterior of the gold tags over real words."""
        q = self.posteriors(feats, unary, mask)
        gold = torch.gather(torch.log(q + eps), 2,
                            tags.long()[:, :, None])[..., 0]
        m = mask.float()
        return -(gold * m).sum() / m.sum().clamp(min=1.0)

    def decode(self, feats: torch.Tensor, unary: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
        """Each word's most probable tag, int32 ``[B, T]``."""
        return self.posteriors(feats, unary, mask).argmax(-1).to(torch.int32)
