"""Majority-vote ensembling of several systems' predictions (counterpart
of ``kbner_tpu/eval/ensemble.py``), on the host.

Each system's spans in a sentence are votes keyed by (start, end,
label); spans with at least ``threshold`` votes (half the systems by
default) are taken greedily by votes, then length, then start, each
dropped if it overlaps one already taken; the taken spans are written
back as BIOES tags.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.tag_schemes import get_spans

SpanKey = Tuple[int, int, str]  # (start, end, label)


def collect_votes(system_tags: Sequence[Sequence[str]],
                  ignore_labels: Sequence[str] = ("X",)
                  ) -> Dict[SpanKey, int]:
    """Votes per (start, end, label) span across the systems' tags of one
    sentence."""
    votes: Dict[SpanKey, int] = defaultdict(int)
    for tags in system_tags:
        for span in get_spans(tags, ignore_labels=ignore_labels):
            votes[(span.start, span.end, span.label)] += 1
    return votes


def select_spans(votes: Dict[SpanKey, int], threshold: float
                 ) -> List[SpanKey]:
    """The overlap-free spans with at least ``threshold`` votes, taken by
    (votes desc, length desc, start asc); returned sorted."""
    ranked = sorted(votes.items(),
                    key=lambda kv: (-kv[1], -(kv[0][1] - kv[0][0]), kv[0][0]))
    taken: set = set()
    chosen: List[SpanKey] = []
    for (start, end, label), n in ranked:
        positions = range(start, end)
        if n < threshold or any(p in taken for p in positions):
            continue
        taken.update(positions)
        chosen.append((start, end, label))
    return sorted(chosen)


def spans_to_bioes(spans: Sequence[SpanKey], length: int) -> List[str]:
    tags = ["O"] * length
    for start, end, label in spans:
        if end - start == 1:
            tags[start] = f"S-{label}"
        else:
            tags[start] = f"B-{label}"
            for i in range(start + 1, end - 1):
                tags[i] = f"I-{label}"
            tags[end - 1] = f"E-{label}"
    return tags


def ensemble_predictions(
    all_system_tags: Sequence[Sequence[Sequence[str]]],
    threshold: Optional[float] = None,
    ignore_labels: Sequence[str] = ("X",),
) -> List[List[str]]:
    """The ensembled BIOES tags per sentence; ``all_system_tags[s][i]``
    are system s's tags of sentence i, and ``threshold`` defaults to half
    the number of systems."""
    n_systems = len(all_system_tags)
    if n_systems == 0:
        return []
    if threshold is None:
        threshold = 0.5 * n_systems
    out: List[List[str]] = []
    for i in range(len(all_system_tags[0])):
        per_system = [all_system_tags[s][i] for s in range(n_systems)]
        votes = collect_votes(per_system, ignore_labels)
        out.append(spans_to_bioes(select_spans(votes, threshold),
                                  len(per_system[0])))
    return out
