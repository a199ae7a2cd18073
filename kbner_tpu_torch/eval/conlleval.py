"""CoNLL chunk evaluation with the official conlleval semantics
(counterpart of ``kbner_tpu/eval/conlleval.py``).

Tags are collapsed to BIO (S->B, E->I) before boundary detection, chunk
boundaries follow the CoNLL-2000 rules, and a chunk counts as correct iff
gold and prediction start AND end together with the same type. On
well-formed BIOES output it agrees with ``eval/metrics.py``'s permissive
span decoder; on malformed tag sequences the two can differ.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Optional, Sequence, Tuple

BIOTag = Tuple[str, Optional[str]]  # collapsed (B|I|O, type)


def collapse_tag(tag: str, o_tag: str = "O") -> BIOTag:
    """Chunk tag -> (BIO tag, type): S->B, E->I, type split on the first
    hyphen (types may contain hyphens)."""
    if tag == "O" or tag == o_tag or tag == "":
        return "O", None
    if "-" in tag:
        t, ty = tag.split("-", 1)
    else:
        t, ty = tag, None
    if t == "S":
        t = "B"
    elif t == "E":
        t = "I"
    return t, ty


def chunk_starts(prev: BIOTag, cur: BIOTag) -> bool:
    """A chunk starts between prev and cur (CoNLL-2000 rules, BIO space)."""
    (pt, pty), (ct, cty) = prev, cur
    if ct == "B":
        return True
    if pt == "O" and ct == "I":
        return True
    return ct != "O" and pty != cty


def chunk_ends(prev: BIOTag, cur: BIOTag) -> bool:
    """A chunk ends between prev and cur."""
    (pt, pty), (ct, cty) = prev, cur
    if pt in ("B", "I") and ct in ("B", "O"):
        return True
    return pt != "O" and pty != cty


@dataclasses.dataclass
class ConllEval:
    """Aggregated conlleval counts and derived scores."""

    correct_chunks: Dict[str, int]
    gold_chunks: Dict[str, int]
    pred_chunks: Dict[str, int]
    correct_tags: int
    n_tokens: int

    @staticmethod
    def _prf(tp: int, p: int, t: int) -> Tuple[float, float, float]:
        prec = tp / p if p else 0.0
        rec = tp / t if t else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        return prec, rec, f1

    def overall(self) -> Tuple[float, float, float]:
        return self._prf(
            sum(self.correct_chunks.values()),
            sum(self.pred_chunks.values()),
            sum(self.gold_chunks.values()),
        )

    def per_type(self) -> Dict[str, Tuple[float, float, float]]:
        types = sorted(set(self.gold_chunks) | set(self.pred_chunks))
        return {
            ty: self._prf(self.correct_chunks.get(ty, 0),
                          self.pred_chunks.get(ty, 0),
                          self.gold_chunks.get(ty, 0))
            for ty in types
        }

    def accuracy(self) -> float:
        return self.correct_tags / self.n_tokens if self.n_tokens else 0.0

    def macro_f1(self) -> float:
        scores = [f1 for (_, _, f1) in self.per_type().values()]
        return sum(scores) / len(scores) if scores else 0.0

    def micro_f1(self) -> float:
        return self.overall()[2]


def conll_evaluate(
    gold_tags: Sequence[Sequence[str]],
    pred_tags: Sequence[Sequence[str]],
    remove_x: bool = False,
    o_tag: str = "O",
) -> ConllEval:
    """Evaluate tagged sentences with conlleval chunk matching.

    ``remove_x`` skips tokens whose GOLD type is 'X' (retrieved-context
    tokens), as ``--remove_x`` does. Sentence boundaries act
    as O tokens for chunk-boundary purposes and are not counted.
    """
    correct_chunks: Dict[str, int] = defaultdict(int)
    gold_chunks: Dict[str, int] = defaultdict(int)
    pred_chunks: Dict[str, int] = defaultdict(int)
    correct_tags = 0
    n_tokens = 0

    O: BIOTag = ("O", None)
    last_gold, last_pred = O, O
    in_correct = False
    # the type of the currently-matched chunk (set at its start)
    match_type: Optional[str] = None

    def step(gold: BIOTag, pred: BIOTag, count_token: bool) -> None:
        nonlocal last_gold, last_pred, in_correct, match_type
        nonlocal correct_tags, n_tokens
        if in_correct:
            g_end = chunk_ends(last_gold, gold)
            p_end = chunk_ends(last_pred, pred)
            if g_end and p_end:
                in_correct = False
                correct_chunks[match_type] += 1
            elif g_end != p_end or gold[1] != pred[1]:
                in_correct = False
        g_start = chunk_starts(last_gold, gold)
        p_start = chunk_starts(last_pred, pred)
        if g_start and p_start and gold[1] == pred[1]:
            in_correct = True
            match_type = gold[1]
        if g_start:
            gold_chunks[gold[1]] += 1
        if p_start:
            pred_chunks[pred[1]] += 1
        if count_token:
            if gold == pred:
                correct_tags += 1
            n_tokens += 1
        last_gold, last_pred = gold, pred

    for g_sent, p_sent in zip(gold_tags, pred_tags):
        for g_raw, p_raw in zip(g_sent, p_sent):
            gold = collapse_tag(g_raw, o_tag)
            if remove_x and gold[1] == "X":
                continue
            step(gold, collapse_tag(p_raw, o_tag), count_token=True)
        step(O, O, count_token=False)  # sentence boundary
    if in_correct:
        correct_chunks[match_type] += 1

    return ConllEval(dict(correct_chunks), dict(gold_chunks),
                     dict(pred_chunks), correct_tags, n_tokens)
