"""Span-level evaluation metrics (counterpart of
``kbner_tpu/eval/metrics.py``).

``Metric`` keeps per-class tp/fp/fn/tn counts with micro and macro
averages; spans are (positions, label) pairs, and 'X' context spans are
dropped from both gold and prediction.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.tag_schemes import TagSpan, get_spans


class Metric:
    """Per-class tp/fp/fn/tn counters with micro/macro F1."""

    def __init__(self, name: str = "metric", beta: float = 1.0):
        self.name = name
        self.beta = beta
        self._tps: Dict[Optional[str], int] = defaultdict(int)
        self._fps: Dict[Optional[str], int] = defaultdict(int)
        self._tns: Dict[Optional[str], int] = defaultdict(int)
        self._fns: Dict[Optional[str], int] = defaultdict(int)

    def add_tp(self, class_name: Optional[str] = None):
        self._tps[class_name] += 1

    def add_fp(self, class_name: Optional[str] = None):
        self._fps[class_name] += 1

    def add_tn(self, class_name: Optional[str] = None):
        self._tns[class_name] += 1

    def add_fn(self, class_name: Optional[str] = None):
        self._fns[class_name] += 1

    def get_tp(self, class_name=None):
        return self._tps[class_name]

    def get_fp(self, class_name=None):
        return self._fps[class_name]

    def get_fn(self, class_name=None):
        return self._fns[class_name]

    def _sum(self, counter: Dict[Optional[str], int], class_name) -> int:
        if class_name is not None:
            return counter[class_name]
        # micro aggregation: sum over all classes
        return sum(v for k, v in counter.items() if k is not None)

    def precision(self, class_name=None) -> float:
        tp = self._sum(self._tps, class_name)
        fp = self._sum(self._fps, class_name)
        return tp / (tp + fp) if tp + fp > 0 else 0.0

    def recall(self, class_name=None) -> float:
        tp = self._sum(self._tps, class_name)
        fn = self._sum(self._fns, class_name)
        return tp / (tp + fn) if tp + fn > 0 else 0.0

    def f_score(self, class_name=None) -> float:
        p, r = self.precision(class_name), self.recall(class_name)
        b2 = self.beta * self.beta
        return (1 + b2) * p * r / (b2 * p + r) if p + r > 0 else 0.0

    def accuracy(self, class_name=None) -> float:
        tp = self._sum(self._tps, class_name)
        fp = self._sum(self._fps, class_name)
        fn = self._sum(self._fns, class_name)
        denom = tp + fp + fn
        return tp / denom if denom > 0 else 0.0

    def get_classes(self) -> List[str]:
        classes = set(self._tps) | set(self._fps) | set(self._fns) | set(self._tns)
        classes.discard(None)
        return sorted(classes)

    def micro_avg_f_score(self) -> float:
        return self.f_score(None)

    def macro_avg_f_score(self) -> float:
        classes = self.get_classes()
        if not classes:
            return 0.0
        return sum(self.f_score(c) for c in classes) / len(classes)

    def micro_avg_accuracy(self) -> float:
        return self.accuracy(None)

    def __str__(self) -> str:
        lines = []
        for c in self.get_classes():
            lines.append(
                f"{c:<12} tp: {self._tps[c]} - fp: {self._fps[c]} - "
                f"fn: {self._fns[c]} - precision: {self.precision(c):.4f} - "
                f"recall: {self.recall(c):.4f} - f1-score: {self.f_score(c):.4f}"
            )
        lines.append(
            f"MICRO_AVG: f1-score {self.micro_avg_f_score():.4f}  "
            f"MACRO_AVG: f1-score {self.macro_avg_f_score():.4f}"
        )
        return "\n".join(lines)


def span_key(span: TagSpan) -> Tuple[Tuple[int, ...], str]:
    return (span.positions, span.label)


def evaluate_spans(
    gold_tags: Sequence[Sequence[str]],
    pred_tags: Sequence[Sequence[str]],
    ignore_labels: Sequence[str] = ("X", "_", "NE"),
    metric: Optional[Metric] = None,
) -> Metric:
    """Accumulate span-level tp/fp/fn over sentences.

    A predicted span is a tp iff an identical (positions, label) span exists
    in gold; otherwise fp (+ fn for the gold label of any missed gold
    span).
    """
    if metric is None:
        metric = Metric("Evaluation")
    for gold, pred in zip(gold_tags, pred_tags):
        gold_spans = {span_key(s) for s in get_spans(gold, ignore_labels=ignore_labels)}
        pred_spans = {span_key(s) for s in get_spans(pred, ignore_labels=ignore_labels)}
        for key in pred_spans:
            if key in gold_spans:
                metric.add_tp(key[1])
            else:
                metric.add_fp(key[1])
        for key in gold_spans:
            if key not in pred_spans:
                metric.add_fn(key[1])
    return metric
