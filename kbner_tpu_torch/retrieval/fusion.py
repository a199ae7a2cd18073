"""Context fusion: retrieved documents -> <EOS>-separated context tokens
(counterpart of ``kbner_tpu/retrieval/fusion.py``).

Each input sentence gets its top-ranked retrieved contexts appended after
an ``<EOS>`` marker, every context token tagged ``B-X``, under a hard
subtoken budget measured with the tagger's tokenizer (budget 510).

Context granularities:
  - ``paragraph``      : the matched paragraph,
  - ``sentence_link``  : ``[ title ] sentence``,
  - ``sentence``       : the matched sentence with its wiki-anchor markup
                         recovered from the anchored paragraph
                         (:func:`match_origin_paragraph`).
"""

from __future__ import annotations

import re
from typing import List, Literal, Sequence

from ..data.conll import EOS_MARKER, SentenceRecord
from ..data.subword import SubwordTokenizer, subtoken_length
from .engine import RetrievedDoc

ContextMode = Literal["paragraph", "sentence_link", "sentence"]
X_TAG = "B-X"

_ANCHOR_RE = re.compile(r"<e:[^>]*>|</e>")


def match_origin_paragraph(sentence: str, paragraph: str) -> str:
    """Recover a plain sentence's wiki-anchor markup from its paragraph.

    Reference-schema retrieval rows store the matched sentence WITHOUT
    anchors next to the paragraph WITH ``<e:Title>surface</e>`` markup;
    Wiki-Sent mode re-projects the markup onto the sentence: locate the
    sentence in the anchor-stripped paragraph, then map that span back to
    anchored coordinates — tags strictly before the span shift its start,
    tags starting inside it (including exactly at its start) extend it,
    and the walk stops at the first tag at/after the span end (so a tag
    whose opening lands exactly at the span end is NOT absorbed, matching
    the reference's boundary conditions). Falls back to the plain
    sentence when it isn't found or the round-trip check fails.
    """
    stripped = _ANCHOR_RE.sub("", paragraph)
    pos = stripped.find(sentence)
    if pos < 0:
        return sentence
    start, length = pos, len(sentence)
    removed = 0  # markup chars preceding the current tag
    for m in _ANCHOR_RE.finditer(paragraph):
        tag_len = m.end() - m.start()
        plain_pos = m.start() - removed  # tag position in stripped coords
        if plain_pos < pos:
            start += tag_len
        elif plain_pos < pos + len(sentence):
            length += tag_len
        else:
            break
        removed += tag_len
    out = paragraph[start:start + length]
    return out if _ANCHOR_RE.sub("", out) == sentence else sentence


def context_tokens(doc: RetrievedDoc, mode: ContextMode) -> List[str]:
    if mode == "paragraph":
        text = doc.paragraph or doc.sentence
    elif mode == "sentence_link":
        title = doc.title or ""
        text = f"[ {title} ] {doc.sentence}" if title else doc.sentence
    elif mode == "sentence":
        text = doc.sentence
        # reference-schema rows: plain sentence + anchored paragraph
        if ("<e:" not in text and doc.paragraph
                and "<e:" in doc.paragraph):
            text = match_origin_paragraph(text, doc.paragraph)
    else:
        raise ValueError(f"unknown context mode {mode!r}")
    return text.split()


def fuse_contexts(
    records: Sequence[SentenceRecord],
    results: Sequence[Sequence[RetrievedDoc]],
    tokenizer: SubwordTokenizer,
    mode: ContextMode = "sentence_link",
    budget: int = 510,
    max_contexts: int = 10,
    drop_over_budget_train: bool = False,
) -> List[SentenceRecord]:
    """Build context-augmented sentence records.

    Contexts are consumed in retrieval rank order; each is added only if the
    running subtoken total stays within ``budget``. Sentences with no
    accepted context get no <EOS> marker, and sentences already over the
    budget are passed through unchanged, or left out with
    ``drop_over_budget_train`` (``cli retrieve`` sets it on the train
    split).
    """
    out: List[SentenceRecord] = []
    for rec, docs in zip(records, results):
        base_len = subtoken_length(tokenizer, rec.tokens)
        if base_len > budget:
            if not drop_over_budget_train:
                out.append(rec)
            continue

        new_tokens = list(rec.tokens)
        new_tags = {
            layer: list(tags) for layer, tags in rec.tags.items()
        }
        used = base_len + 1  # +1 for <EOS>
        appended_any = False
        for doc in docs[:max_contexts]:
            ctx = context_tokens(doc, mode)
            if not ctx:
                continue
            ctx_len = subtoken_length(tokenizer, ctx)
            if used + ctx_len > budget:
                break
            if not appended_any:
                new_tokens.append(EOS_MARKER)
                for layer in new_tags:
                    new_tags[layer].append(X_TAG)
                appended_any = True
            new_tokens.extend(ctx)
            for layer in new_tags:
                new_tags[layer].extend([X_TAG] * len(ctx))
            used += ctx_len

        out.append(SentenceRecord(
            tokens=new_tokens,
            tags=new_tags,
            doc_id=rec.doc_id,
            lang_id=rec.lang_id,
            comment=rec.comment,
        ))
    return out


def extract_entities(record: SentenceRecord,
                     tag_layer: str = "ner") -> List[str]:
    """Entity surface forms from B-/I- (or BIOES) tags, up to ``<EOS>``:
    the query seeds of entity-boosted retrieval."""
    tags = record.tags.get(tag_layer, [])
    entities: List[str] = []
    current: List[str] = []
    for tok, tag in zip(record.tokens, tags):
        if tok == EOS_MARKER:
            break
        prefix = tag[:2]
        if prefix in ("B-", "S-") and tag[2:] != "X":
            if current:
                entities.append(" ".join(current))
            current = [tok]
        elif prefix in ("I-", "E-") and tag[2:] != "X" and current:
            current.append(tok)
        else:
            if current:
                entities.append(" ".join(current))
            current = []
    if current:
        entities.append(" ".join(current))
    return entities
