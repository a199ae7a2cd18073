"""Tag-scheme conversions (IOB1 -> IOB2 -> BIOES, BIOES -> BIO) and span
extraction (counterpart of ``kbner_tpu/data/tag_schemes.py``)."""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


def iob2(tags: List[str]) -> Optional[List[str]]:
    """Validate IOB and convert IOB1 to IOB2. Returns None if invalid."""
    out = list(tags)
    for i, tag in enumerate(out):
        if tag == "O":
            continue
        split = tag.split("-")
        if len(split) < 2 or split[0] not in ("I", "B"):
            return None
        if split[0] == "B":
            continue
        if i == 0 or out[i - 1] == "O":
            out[i] = "B" + tag[1:]
        elif out[i - 1][1:] != tag[1:]:
            out[i] = "B" + tag[1:]
    return out


def iob_iobes(tags: List[str]) -> List[str]:
    """IOB2 -> BIOES."""
    new_tags: List[str] = []
    for i, tag in enumerate(tags):
        nxt_inside = i + 1 < len(tags) and tags[i + 1].startswith("I-")
        if tag == "O":
            new_tags.append(tag)
        elif tag.startswith("B-"):
            new_tags.append(tag if nxt_inside else "S-" + tag[2:])
        elif tag.startswith("I-"):
            new_tags.append(tag if nxt_inside else "E-" + tag[2:])
        else:
            raise ValueError(f"Invalid IOB tag: {tag!r}")
    return new_tags


def to_bioes(tags: List[str]) -> List[str]:
    """IOB1/IOB2 -> BIOES; raises on malformed input."""
    converted = iob2(tags)
    if converted is None:
        raise ValueError(f"Tags are not in valid IOB format: {tags}")
    return iob_iobes(converted)


def bioes_to_bio(tags: List[str]) -> List[str]:
    """BIOES -> BIO (S->B, E->I)."""
    out = []
    for tag in tags:
        if tag.startswith("S-"):
            out.append("B-" + tag[2:])
        elif tag.startswith("E-"):
            out.append("I-" + tag[2:])
        else:
            out.append(tag)
    return out


@dataclass(frozen=True)
class TagSpan:
    start: int  # inclusive token index
    end: int  # exclusive token index
    label: str
    score: float = 1.0

    @property
    def positions(self) -> Tuple[int, ...]:
        return tuple(range(self.start, self.end))


def get_spans(
    tags: Sequence[str],
    scores: Optional[Sequence[float]] = None,
    min_score: float = -1.0,
    ignore_labels: Sequence[str] = (),
) -> List[TagSpan]:
    """Permissive span decoder: any non-O tag is in-span; B-/S- start new
    spans; an S- followed by a different in-span label starts a new span;
    a span's label is the majority vote over its tags with start tags
    weighted 1.1; its score is the mean of token scores. Spans whose label
    is in ``ignore_labels`` are dropped (the X context spans)."""
    if scores is None:
        scores = [1.0] * len(tags)
    spans: List[TagSpan] = []
    current: List[int] = []
    votes = defaultdict(float)
    previous = "O-"

    def flush():
        if not current:
            return
        span_score = sum(scores[i] for i in current) / len(current)
        label = sorted(votes.items(), key=lambda kv: kv[1], reverse=True)[0][0]
        if span_score > min_score and label not in ignore_labels:
            spans.append(TagSpan(start=current[0], end=current[-1] + 1,
                                 label=label, score=span_score))

    for i, raw in enumerate(tags):
        tag = raw if raw not in ("", "O") else "O-"
        if tag[0:2] not in ("B-", "I-", "O-", "E-", "S-"):
            tag = "S-" + tag
        in_span = tag[0:2] != "O-"
        starts_new = tag[0:2] in ("B-", "S-")
        if previous[0:2] == "S-" and previous[2:] != tag[2:] and in_span:
            starts_new = True
        if (starts_new or not in_span) and current:
            flush()
            current = []
            votes = defaultdict(float)
        if in_span:
            current.append(i)
            votes[tag[2:]] += 1.1 if starts_new else 1.0
        previous = tag
    if current:
        flush()
    return spans
