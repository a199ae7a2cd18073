"""Document windows, the reference's ``v2_doc`` mode (counterpart of
``kbner_tpu/data/doc_context.py``).

Each sentence is rewritten as a window over its document: neighbour
sentences join, left and right in turn starting on the left, while the
subtoken budget allows, so the target sentence stays near the centre. The
neighbours' words are tagged ``S-X``: they shape the encoder's attention
but stay outside the CRF and the metrics. No window crosses a ``doc_id``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

from .conll import SentenceRecord
from .subword import SubwordTokenizer, subtoken_length

X_TAG = "S-X"


def make_doc_context_records(
    records: Sequence[SentenceRecord],
    tokenizer: SubwordTokenizer,
    budget: int = 510,
    tag_layer: str = "ner",
) -> Tuple[List[SentenceRecord], List[int]]:
    """``(windowed records, offsets)``: word ``w`` of sentence ``i`` is
    word ``offsets[i] + w`` of its window. Each round tries the next left
    neighbour, then the next right one, each added if it still fits the
    budget (a neighbour that does not fit is skipped, not retried); the
    rounds stop when neither side added one. A record without
    ``tag_layer`` gets ``O`` tags for its own words."""
    by_doc: Dict[int, List[int]] = defaultdict(list)
    for i, rec in enumerate(records):
        by_doc[rec.doc_id].append(i)
    lengths = [subtoken_length(tokenizer, r.tokens) for r in records]
    out: List[SentenceRecord] = [None] * len(records)  # type: ignore
    offsets = [0] * len(records)
    for idxs in by_doc.values():
        for pos, i in enumerate(idxs):
            rec, used = records[i], lengths[i]
            left: List[int] = []
            right: List[int] = []
            li, ri = pos - 1, pos + 1
            while used < budget and (li >= 0 or ri < len(idxs)):
                extended = False
                if li >= 0:
                    if used + lengths[idxs[li]] <= budget:
                        left.insert(0, idxs[li])
                        used += lengths[idxs[li]]
                        extended = True
                    li -= 1
                if ri < len(idxs):
                    if used + lengths[idxs[ri]] <= budget:
                        right.append(idxs[ri])
                        used += lengths[idxs[ri]]
                        extended = True
                    ri += 1
                if not extended:
                    break
            left_tokens = [t for j in left for t in records[j].tokens]
            right_tokens = [t for j in right for t in records[j].tokens]
            tags = {layer: [X_TAG] * len(left_tokens) + list(layer_tags)
                    + [X_TAG] * len(right_tokens)
                    for layer, layer_tags in rec.tags.items()}
            if tag_layer not in tags:
                tags[tag_layer] = ([X_TAG] * len(left_tokens)
                                   + ["O"] * len(rec.tokens)
                                   + [X_TAG] * len(right_tokens))
            out[i] = SentenceRecord(
                tokens=left_tokens + list(rec.tokens) + right_tokens,
                tags=tags, doc_id=rec.doc_id, lang_id=rec.lang_id,
                comment=rec.comment)
            offsets[i] = len(left_tokens)
    return out, offsets


def strip_doc_context(
    preds: Sequence[Sequence[str]],
    originals: Sequence[SentenceRecord],
    offsets: Sequence[int],
) -> List[List[str]]:
    """Each window's predictions cut back to its own sentence."""
    return [list(pred[off:off + len(rec.tokens)])
            for pred, rec, off in zip(preds, originals, offsets)]
