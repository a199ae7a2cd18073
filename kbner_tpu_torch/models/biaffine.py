"""Biaffine parsing heads (counterpart of ``kbner_tpu/models/biaffine.py``):

  - :class:`BiaffineParser`: Dozat-Manning arc and relation scores over
    the encoder's word features with a learned ROOT vector prepended, so
    arcs live on a ``[W+1, W+1]`` grid; the arc loss is head
    cross-entropy, the projective tree CRF (``arc_loss: crf``) or its
    partial-annotation form, plus relation cross-entropy at the gold
    heads; decoding takes each word's best head (under the tree CRF, from
    its marginals), and the trainer repairs a non-tree on the host with
    :func:`mst_decode`;
  - :class:`BiaffineNER`: span NER as parsing, label scores for every
    (start, end) span, decoded greedily into non-overlapping spans on the
    host;
  - :class:`SemanticDependencyParser`: graph parsing, each word may take
    several heads (sigmoid arcs under BCE, relation CE at the gold arcs);
  - the host decoders :func:`chu_liu_edmonds`, :func:`mst_decode` and
    :func:`eisner_decode` (copies of the reference's, ties broken alike),
    and :func:`single_root_eisner`, the port's own, which the trainer
    falls back on where the reference's MST leaves no single-root tree;
    and the ``encode_*`` functions that attach a task's gold arrays to an
    encoded batch.

Modules are made on ``device`` (the card by default) and drawn from a
``torch.Generator`` seeded with ``seed`` from Flax's distributions: the
encoder as the tagger's, every Dense lecun-normal with a zero bias, the
ROOT vector normal(0, 0.02), the biaffine weights zero. The heads run in
float32 over the encoder's features cast to float32; dropout is on only
in the encoder, when a host generator is passed as ``rng``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.tree_crf import tree_crf_loss, tree_crf_marginals
from .embedders import _dense, _gather_words, reset_flax_
from .xlmr import XLMRConfig, XLMREncoder

Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class BiaffineConfig:
    encoder: XLMRConfig
    num_rels: int
    arc_dim: int = 256
    rel_dim: int = 64
    dropout: float = 0.1
    # "ce" (head classification) or "crf" (projective tree CRF); with
    # ``partial``, heads < 0 are marginalized under "crf"
    arc_loss: str = "ce"
    partial: bool = False


class Biaffine(nn.Module):
    """Bilinear scorer ``x W y^T`` with a column of ones appended to x
    (``bias_x``) and to y (``bias_y``) before the product: ``[B, Wx, Dx]``
    and ``[B, Wy, Dy]`` -> ``[B, out, Wx, Wy]``. The weight
    ``[out, Dx (+1), Dy (+1)]`` starts at zero."""

    def __init__(self, n_x: int, n_y: int, out_features: int = 1,
                 bias_x: bool = True, bias_y: bool = True, device=None):
        super().__init__()
        self.bias_x, self.bias_y = bias_x, bias_y
        self.weight = nn.Parameter(torch.zeros(
            out_features, n_x + bias_x, n_y + bias_y, device=device))

    @staticmethod
    def _ones(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x, x.new_ones(x.shape[:-1] + (1,))], dim=-1)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        if self.bias_x:
            x = self._ones(x)
        if self.bias_y:
            y = self._ones(y)
        return torch.einsum("bxi,oij,byj->boxy", x, self.weight, y)


class _ArcScorer(nn.Module):
    """The encoder, the ROOT vector, the four MLPs and the arc and
    relation biaffines shared by the tree and the graph parser."""

    def __init__(self, config, device, seed: int):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        H = config.encoder.hidden_size
        self.encoder = XLMREncoder(config.encoder, device=device)
        self.root = nn.Parameter(torch.empty(H, device=device))
        self.mlp_arc_h = _dense(H, config.arc_dim, device)
        self.mlp_arc_d = _dense(H, config.arc_dim, device)
        self.mlp_rel_h = _dense(H, config.rel_dim, device)
        self.mlp_rel_d = _dense(H, config.rel_dim, device)
        self.arc_attn = Biaffine(config.arc_dim, config.arc_dim, 1,
                                 bias_x=True, bias_y=False, device=device)
        self.rel_attn = Biaffine(config.rel_dim, config.rel_dim,
                                 config.num_rels, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        reset_flax_(self, gen)
        self.root.normal_(0.0, 0.02, generator=gen)
        self.arc_attn.weight.zero_()
        self.rel_attn.weight.zero_()

    @property
    def device(self) -> torch.device:
        return self.root.device

    def _features(self, batch: Batch, rng: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
        """ROOT then each word's first-subtoken state (positions clipped
        into the sequence), float32 ``[B, W+1, H]``."""
        hidden = self.encoder(batch["input_ids"], batch["attention_mask"],
                              rng=rng)
        feats = _gather_words(hidden, batch["word_starts"]).float()
        root = self.root[None, None, :].expand(feats.shape[0], 1, -1)
        return torch.cat([root, feats], dim=1)

    def scores(self, batch: Batch, rng: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(s_arc [B, W+1, W+1], s_rel [B, W+1, W+1, R])``;
        ``s_arc[b, d, h]`` scores head h for dependent d (position 0 is
        ROOT, valid only as a head)."""
        x = self._features(batch, rng)
        arc_h = F.relu(self.mlp_arc_h(x))
        arc_d = F.relu(self.mlp_arc_d(x))
        rel_h = F.relu(self.mlp_rel_h(x))
        rel_d = F.relu(self.mlp_rel_d(x))
        s_arc = self.arc_attn(arc_d, arc_h)[:, 0]
        s_rel = self.rel_attn(rel_d, rel_h).movedim(1, -1)
        return s_arc, s_rel


def _head_valid(word_mask: torch.Tensor) -> torch.Tensor:
    """``[B, W+1]``: ROOT, then the real words."""
    return torch.cat([torch.ones_like(word_mask[:, :1]), word_mask], dim=1)


class BiaffineParser(_ArcScorer):
    """Tree parser (``targets: dependency``)."""

    def __init__(self, config: BiaffineConfig, device="cuda", seed: int = 0):
        super().__init__(config, device, seed)

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Arc loss plus relation CE at the gold heads, over the words.
        ``batch`` holds ``heads`` [B, W] (0 = ROOT, < 0 unannotated) and
        ``rel_ids`` [B, W]."""
        s_arc, s_rel = self.scores(batch, rng)
        mask = batch["word_mask"].float()
        gold_heads = batch["heads"].long()
        annotated = gold_heads >= 0
        heads0 = gold_heads.clamp(min=0)
        if self.config.arc_loss == "crf":
            nll = tree_crf_loss(s_arc, batch["word_mask"], gold_heads,
                                partial=self.config.partial)  # [B]
            # spread each sentence's NLL over its words, so that the
            # word-count normalization below applies to it too
            arc_ll = -(nll[:, None] / mask.sum(1, keepdim=True).clamp(
                min=1.0)) * mask
        else:
            valid = _head_valid(mask)[:, None, :] > 0
            logp_arc = F.log_softmax(
                torch.where(valid, s_arc[:, 1:, :], -1e9), dim=-1)
            arc_ll = logp_arc.gather(2, heads0[:, :, None])[..., 0]
            arc_ll = torch.where(annotated, arc_ll, 0.0)
        rel_logits = s_rel[:, 1:]  # [B, W, W+1, R]
        R = rel_logits.shape[-1]
        rel_at_gold = rel_logits.gather(
            2, heads0[:, :, None, None].expand(-1, -1, 1, R))[:, :, 0]
        logp_rel = F.log_softmax(rel_at_gold, dim=-1)
        rel_ll = logp_rel.gather(
            2, batch["rel_ids"].long()[:, :, None])[..., 0]
        rel_ll = torch.where(annotated, rel_ll, 0.0)
        return -((arc_ll + rel_ll) * mask).sum() / mask.sum().clamp(min=1.0)

    @torch.no_grad()
    def marginals(self, batch: Batch) -> torch.Tensor:
        """Arc marginals P(h -> d) ``[B, W+1, W+1]`` under the tree CRF."""
        s_arc, _ = self.scores(batch)
        return tree_crf_marginals(s_arc, batch["word_mask"])

    @torch.no_grad()
    def decode(self, batch: Batch, return_scores: bool = False):
        """Each word's best head and its best relation there, int32
        ``[B, W]`` each (under ``arc_loss: crf`` the heads maximize the
        tree-CRF marginals); with ``return_scores`` also ``s_arc``."""
        s_arc, s_rel = self.scores(batch)
        mask = batch["word_mask"]
        arc = (tree_crf_marginals(s_arc, mask)
               if self.config.arc_loss == "crf" else s_arc)
        valid = _head_valid(mask)[:, None, :] > 0
        heads = torch.where(valid, arc[:, 1:, :], -1e9).argmax(-1)
        R = s_rel.shape[-1]
        rel_logits = s_rel[:, 1:].gather(
            2, heads[:, :, None, None].expand(-1, -1, 1, R))[:, :, 0]
        rels = rel_logits.argmax(-1)
        out = (heads.to(torch.int32), rels.to(torch.int32))
        return out + (s_arc,) if return_scores else out


def chu_liu_edmonds(scores: np.ndarray) -> np.ndarray:
    """Maximum spanning arborescence rooted at node 0 (host numpy).
    ``scores[d, h]`` scores the arc h -> d (the orientation of s_arc);
    returns each node's head (``head[0] = 0``)."""
    n = scores.shape[0]
    scores = scores.copy()
    np.fill_diagonal(scores, -np.inf)
    scores[0, :] = -np.inf  # ROOT has no head

    heads = np.zeros(n, dtype=np.int64)
    heads[1:] = np.argmax(scores[1:], axis=1)

    def find_cycle(h):
        color = [0] * n
        for start in range(1, n):
            if color[start]:
                continue
            path, node = [], start
            while True:
                if color[node] == 1:
                    # a cycle: the path from its first visit on
                    idx = path.index(node)
                    return path[idx:]
                if color[node] == 2:
                    break
                color[node] = 1
                path.append(node)
                node = int(h[node])
                if node == 0:
                    break
            for p in path:
                color[p] = 2
        return None

    for _ in range(n):
        cycle = find_cycle(heads)
        if cycle is None:
            return heads
        cyc = set(cycle)
        # the best arc into the cycle from outside breaks it
        best_gain, best_d, best_h = -np.inf, None, None
        for d in cycle:
            for h in range(n):
                if h in cyc or not np.isfinite(scores[d, h]):
                    continue
                gain = scores[d, h] - scores[d, heads[d]]
                if gain > best_gain:
                    best_gain, best_d, best_h = gain, d, h
        if best_d is None:
            return heads
        heads[best_d] = best_h
    return heads


def mst_decode(s_arc: np.ndarray, word_mask: np.ndarray) -> np.ndarray:
    """Per-sentence :func:`chu_liu_edmonds` over ``s_arc [B, W+1, W+1]``:
    heads ``[B, W]``."""
    B, Wp1, _ = s_arc.shape
    out = np.zeros((B, Wp1 - 1), dtype=np.int64)
    for b in range(B):
        n = int(word_mask[b].sum()) + 1
        out[b, : n - 1] = chu_liu_edmonds(s_arc[b, :n, :n])[1:]
    return out


def eisner_decode(scores: np.ndarray) -> np.ndarray:
    """Projective maximum spanning tree (Eisner's algorithm, O(n^3), host
    numpy). ``scores[d, h]`` scores the arc h -> d over n nodes with ROOT
    at 0; returns each node's head (``head[0] = 0``)."""
    n = scores.shape[0]
    NEGINF = -np.inf
    # [0]: head at the right end j, [1]: head at the left end i
    inc = np.full((2, n, n), NEGINF)  # incomplete spans
    com = np.full((2, n, n), NEGINF)  # complete spans
    inc_bp = np.zeros((2, n, n), dtype=np.int64)
    com_bp = np.zeros((2, n, n), dtype=np.int64)
    for i in range(n):
        inc[0, i, i] = inc[1, i, i] = 0.0
        com[0, i, i] = com[1, i, i] = 0.0

    for length in range(1, n):
        for i in range(0, n - length):
            j = i + length
            best, arg = NEGINF, i
            for r in range(i, j):
                v = com[1, i, r] + com[0, r + 1, j]
                if v > best:
                    best, arg = v, r
            inc[0, i, j] = best + scores[i, j]  # j -> i (head j)
            inc[1, i, j] = best + scores[j, i]  # i -> j (head i)
            inc_bp[0, i, j] = inc_bp[1, i, j] = arg
            best, arg = NEGINF, i
            for r in range(i, j):
                v = com[0, i, r] + inc[0, r, j]
                if v > best:
                    best, arg = v, r
            com[0, i, j] = best
            com_bp[0, i, j] = arg
            best, arg = NEGINF, i + 1
            for r in range(i + 1, j + 1):
                v = inc[1, i, r] + com[1, r, j]
                if v > best:
                    best, arg = v, r
            com[1, i, j] = best
            com_bp[1, i, j] = arg

    heads = np.zeros(n, dtype=np.int64)

    def backtrack(i, j, direction, complete):
        if i == j:
            return
        if complete:
            r = com_bp[direction, i, j]
            if direction == 0:
                backtrack(i, r, 0, True)
                backtrack(r, j, 0, False)
            else:
                backtrack(i, r, 1, False)
                backtrack(r, j, 1, True)
        else:
            if direction == 0:
                heads[i] = j
            else:
                heads[j] = i
            r = inc_bp[direction, i, j]
            backtrack(i, r, 1, True)
            backtrack(r + 1, j, 0, True)

    backtrack(0, n - 1, 1, True)
    return heads


def single_root_eisner(scores: np.ndarray) -> np.ndarray:
    """The best projective tree with exactly one word on ROOT (host
    numpy): Eisner's charts over the words ``1..n-1``, then the root word
    ``r`` maximizing its left and right complete spans plus the arc
    ``0 -> r``. ``scores[d, h]`` scores the arc h -> d; returns each
    node's head (``head[0] = 0``). The port's last repair where
    :func:`mst_decode` leaves a cycle or several root children (the
    reference's greedy cycle breaking can; ROADMAP C)."""
    n = scores.shape[0]
    heads = np.zeros(n, dtype=np.int64)
    if n < 2:
        return heads
    neg = -np.inf
    inc = np.full((2, n, n), neg)
    com = np.full((2, n, n), neg)
    inc_bp = np.zeros((2, n, n), dtype=np.int64)
    com_bp = np.zeros((2, n, n), dtype=np.int64)
    idx = np.arange(n)
    com[:, idx, idx] = 0.0
    for length in range(1, n):
        for i in range(n - length):
            j = i + length
            v = com[1, i, i:j] + com[0, i + 1:j + 1, j]
            k = int(np.argmax(v))
            inc[0, i, j] = v[k] + scores[i, j]  # head j
            inc[1, i, j] = v[k] + scores[j, i]  # head i
            inc_bp[:, i, j] = i + k
            v = com[0, i, i:j] + inc[0, i:j, j]
            k = int(np.argmax(v))
            com[0, i, j], com_bp[0, i, j] = v[k], i + k
            v = inc[1, i, i + 1:j + 1] + com[1, i + 1:j + 1, j]
            k = int(np.argmax(v))
            com[1, i, j], com_bp[1, i, j] = v[k], i + 1 + k

    def backtrack(i, j, direction, complete):
        if i == j:
            return
        if complete:
            r = com_bp[direction, i, j]
            if direction == 0:
                backtrack(i, r, 0, True)
                backtrack(r, j, 0, False)
            else:
                backtrack(i, r, 1, False)
                backtrack(r, j, 1, True)
        else:
            heads[i if direction == 0 else j] = j if direction == 0 else i
            r = inc_bp[direction, i, j]
            backtrack(i, r, 1, True)
            backtrack(r + 1, j, 0, True)

    words = np.arange(1, n)
    root = int(words[np.argmax(com[0, 1, words] + com[1, words, n - 1]
                               + scores[words, 0])])
    heads[root] = 0
    backtrack(1, root, 0, True)
    backtrack(root, n - 1, 1, True)
    return heads


# -- span NER as parsing ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BiaffineNERConfig:
    encoder: XLMRConfig
    num_labels: int  # 'O' at index 0
    span_dim: int = 128
    max_span_len: int = 30


class BiaffineNER(nn.Module):
    """Span classifier (``targets: ner_dp``): a biaffine over start and
    end representations."""

    def __init__(self, config: BiaffineNERConfig, device="cuda",
                 seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        H = config.encoder.hidden_size
        self.encoder = XLMREncoder(config.encoder, device=device)
        self.mlp_start = _dense(H, config.span_dim, device)
        self.mlp_end = _dense(H, config.span_dim, device)
        self.span_attn = Biaffine(config.span_dim, config.span_dim,
                                  config.num_labels, device=device)
        self.reset_parameters(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        reset_flax_(self, gen)
        self.span_attn.weight.zero_()

    @property
    def device(self) -> torch.device:
        return self.span_attn.weight.device

    def scores(self, batch: Batch, rng: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        """Label scores of the span from word i to word j, float32
        ``[B, W, W, L]``."""
        hidden = self.encoder(batch["input_ids"], batch["attention_mask"],
                              rng=rng)
        feats = _gather_words(hidden, batch["word_starts"]).float()
        s = F.relu(self.mlp_start(feats))
        e = F.relu(self.mlp_end(feats))
        return self.span_attn(s, e).movedim(1, -1)

    def _valid(self, word_mask: torch.Tensor) -> torch.Tensor:
        """Spans inside the sentence, start <= end, shorter than
        ``max_span_len``: ``[B, W, W]``."""
        W = word_mask.shape[1]
        ii = torch.arange(W, device=word_mask.device)
        span = ii[None, None, :] - ii[None, :, None]
        valid = (span >= 0) & (span < self.config.max_span_len)
        m = word_mask > 0
        return valid & m[:, :, None] & m[:, None, :]

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """Label CE over every valid span; gold ``span_labels`` [B, W, W]
        (0 = no entity)."""
        logp = F.log_softmax(self.scores(batch, rng), dim=-1)
        gold = logp.gather(-1, batch["span_labels"].long()[..., None])[..., 0]
        valid = self._valid(batch["word_mask"])
        return -torch.where(valid, gold, 0.0).sum() / valid.sum().clamp(min=1)

    @torch.no_grad()
    def decode(self, batch: Batch) -> List[List[Tuple]]:
        """Per sentence, non-overlapping spans ``(start, end_inclusive,
        label_id, log-prob)`` sorted by position: every span (shorter than
        ``max_span_len``) whose best label is not 0 is a candidate, taken
        greedily by descending ``(log-prob, start, end, label)``."""
        logits = self.scores(batch).cpu()
        return decode_spans(logits, batch["word_mask"].cpu().numpy(),
                            self.config.max_span_len)


def decode_spans(logits: torch.Tensor, mask: np.ndarray,
                 max_span_len: int) -> List[List[Tuple]]:
    """:meth:`BiaffineNER.decode` on CPU span logits ``[B, W, W, L]``."""
    logp = (logits - torch.logsumexp(logits, -1, keepdim=True)).numpy()
    labels = logits.numpy().argmax(-1)  # the first best, as np.argmax
    results = []
    for b in range(logits.shape[0]):
        n = int(mask[b].sum())
        cands = []
        for i in range(n):
            for j in range(i, min(n, i + max_span_len)):
                label = int(labels[b, i, j])
                if label != 0:
                    cands.append((float(logp[b, i, j, label]), i, j, label))
        cands.sort(reverse=True)
        taken = np.zeros(n, dtype=bool)
        chosen = []
        for score, i, j, label in cands:
            if taken[i:j + 1].any():
                continue
            taken[i:j + 1] = True
            chosen.append((i, j, label, score))
        results.append(sorted(chosen))
    return results


# -- graph parsing ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SemDepConfig:
    encoder: XLMRConfig
    num_rels: int
    arc_dim: int = 256
    rel_dim: int = 64
    arc_threshold: float = 0.5


class SemanticDependencyParser(_ArcScorer):
    """Graph (DAG) parser (``targets: enhancedud``): sigmoid arc scores
    under masked BCE plus relation CE at the gold arcs; decoding keeps the
    arcs above ``arc_threshold`` and gives a word with none its best
    head."""

    def __init__(self, config: SemDepConfig, device="cuda", seed: int = 0):
        super().__init__(config, device, seed)

    @staticmethod
    def _grid_mask(word_mask: torch.Tensor) -> torch.Tensor:
        """Real dependents by ROOT or real heads, ``[B, W, W+1]``."""
        return (word_mask[:, :, None] > 0) & (
            _head_valid(word_mask)[:, None, :] > 0)

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None
             ) -> torch.Tensor:
        """``batch`` holds ``arc_matrix`` [B, W, W+1] (0/1) and
        ``rel_matrix`` [B, W, W+1] (the relation at each gold arc)."""
        s_arc, s_rel = self.scores(batch, rng)
        arc_logits = s_arc[:, 1:, :]
        grid = self._grid_mask(batch["word_mask"])
        targets = batch["arc_matrix"].float()
        bce = -(targets * F.logsigmoid(arc_logits)
                + (1 - targets) * F.logsigmoid(-arc_logits))
        arc_loss = torch.where(grid, bce, 0.0).sum() / grid.sum().clamp(min=1)
        logp_rel = F.log_softmax(s_rel[:, 1:], dim=-1)
        gold_rel = logp_rel.gather(
            -1, batch["rel_matrix"].long()[..., None])[..., 0]
        arc_mask = grid & (batch["arc_matrix"] > 0)
        rel_loss = -torch.where(arc_mask, gold_rel, 0.0).sum() / \
            arc_mask.sum().clamp(min=1)
        return arc_loss + rel_loss

    @torch.no_grad()
    def decode(self, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(arcs [B, W, W+1] 0/1, rels [B, W, W+1])`` int32."""
        s_arc, s_rel = self.scores(batch)
        arc_logits = s_arc[:, 1:, :]
        grid = self._grid_mask(batch["word_mask"])
        prob = torch.sigmoid(torch.where(grid, arc_logits, -1e9))
        arcs = (prob > self.config.arc_threshold).to(torch.int32)
        fallback = F.one_hot(prob.argmax(-1), arc_logits.shape[-1]).to(
            torch.int32)
        has_head = arcs.sum(-1, keepdim=True) > 0
        arcs = torch.where(has_head, arcs, fallback) * grid.to(torch.int32)
        rels = s_rel[:, 1:].argmax(-1).to(torch.int32)
        return arcs, rels


# -- gold arrays --------------------------------------------------------------

def encode_dependency_arrays(eb, head_layer: str = "head",
                             rel_layer: str = "deprel", rel_dict=None) -> None:
    """Attach ``heads``/``rel_ids`` int32 ``[B, W]`` from CoNLL-U string
    layers; an unannotated head (``_``) encodes as -1 (marginalized under
    ``partial``, masked from the CE losses)."""
    B, W = eb.word_mask.shape
    heads = np.zeros((B, W), dtype=np.int32)
    rel_ids = np.zeros((B, W), dtype=np.int32)
    for b, rec in enumerate(eb.records):
        hs = rec.tags.get(head_layer, [])
        rs = rec.tags.get(rel_layer, [])
        for w in range(min(len(hs), W)):
            try:
                heads[b, w] = int(hs[w])
            except ValueError:
                heads[b, w] = -1
            if rel_dict is not None and w < len(rs):
                rel_ids[b, w] = rel_dict.item2idx.get(rs[w], 0)
    eb.extra["heads"] = heads
    eb.extra["rel_ids"] = rel_ids


def encode_span_labels(eb, tag_layer: str = "ner", label_dict=None) -> None:
    """Attach ``span_labels`` int32 ``[B, W, W]`` from BIOES tags (the
    label of the span from word i to word j at ``[i, j]``)."""
    from ..data.tag_schemes import get_spans

    B, W = eb.word_mask.shape
    labels = np.zeros((B, W, W), dtype=np.int32)
    for b, rec in enumerate(eb.records):
        for span in get_spans(rec.tags.get(tag_layer, []),
                              ignore_labels=("X",)):
            if span.end - 1 < W and label_dict is not None:
                labels[b, span.start, span.end - 1] = \
                    label_dict.item2idx.get(span.label, 0)
    eb.extra["span_labels"] = labels


def encode_semdep_arrays(eb, layer: str = "deps", rel_dict=None) -> None:
    """Attach ``arc_matrix``/``rel_matrix`` int32 ``[B, W, W+1]`` from
    enhanced-UD ``head:rel|head:rel`` cells."""
    B, W = eb.word_mask.shape
    arc = np.zeros((B, W, W + 1), dtype=np.int32)
    rel = np.zeros((B, W, W + 1), dtype=np.int32)
    for b, rec in enumerate(eb.records):
        vals = rec.tags.get(layer, [])
        for w in range(min(len(vals), W)):
            for item in vals[w].split("|"):
                if ":" not in item:
                    continue
                h, r = item.split(":", 1)
                try:
                    h = int(h)
                except ValueError:
                    continue
                if 0 <= h <= W:
                    arc[b, w, h] = 1
                    if rel_dict is not None:
                        rel[b, w, h] = rel_dict.item2idx.get(r, 0)
    eb.extra["arc_matrix"] = arc
    eb.extra["rel_matrix"] = rel
