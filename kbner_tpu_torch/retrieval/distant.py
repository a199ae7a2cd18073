"""Distant supervision and context scoring (counterpart of
``kbner_tpu/retrieval/distant.py``, the reference's
``kb/context_process.py:542-657``): entity counts in a context, Jaccard
ranking of contexts, and silver sentences made by projecting gold entity
spans onto retrieved contexts.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

from ..data.conll import SentenceRecord
from .engine import RetrievedDoc

# nltk's english stopword list (the reference's ``en_stopwords``)
EN_STOPWORDS = frozenset("""
a about above after again against all am an and any are aren't as at be
because been before being below between both but by can't cannot could
couldn't did didn't do does doesn't doing don't down during each few for
from further had hadn't has hasn't have haven't having he he'd he'll he's
her here here's hers herself him himself his how how's i i'd i'll i'm
i've if in into is isn't it it's its itself let's me more most mustn't
my myself no nor not of off on once only or other ought our ours
ourselves out over own same shan't she she'd she'll she's should
shouldn't so some such than that that's the their theirs them themselves
then there there's these they they'd they'll they're they've this those
through to too under until up very was wasn't we we'd we'll we're we've
were weren't what what's when when's where where's which while who who's
whom why why's with won't would wouldn't you you'd you'll you're you've
your yours yourself yourselves
""".split())


def match_entity_count(entities: Iterable[str], context: str) -> int:
    """How many times any known entity surface form occurs in the
    context (lowercased substring count, ``context_process.py:542-549``)."""
    context = context.lower()
    score = 0
    for entity in entities:
        e = entity.lower()
        if e:
            # non-overlapping occurrences — re.finditer semantics of the
            # reference's counter
            score += context.count(e)
    return score


def rank_contexts_jaccard(
    query: str,
    contexts: Sequence[str],
    stopwords: frozenset = EN_STOPWORDS,
) -> Tuple[List[str], int]:
    """Rank contexts by stopword-stripped bag-of-words Jaccard overlap
    with the query; contexts with zero overlap are DROPPED. Returns
    (ranked contexts, 1 if everything was dropped else 0) — the
    reference's ``removed_context`` counter (``:572-575``)."""
    bow = set(query.lower().split()) - stopwords
    scored: List[Tuple[float, str]] = []
    for context in contexts:
        cbow = set(context.lower().split()) - stopwords
        union = bow | cbow
        score = len(bow & cbow) / len(union) if union else 0.0
        scored.append((score, context))
    ranked = [c for s, c in sorted(scored, key=lambda x: (-x[0], x[1]))
              if s > 0]
    removed = 1 if contexts and not ranked else 0
    return ranked, removed


def named_entity_labels(record: SentenceRecord, tag_layer: str = "ner"
                        ) -> Dict[str, List[str]]:
    """Lowercased entity surface form -> its per-token gold tag sequence
    (the reference's ``get_named_entity`` dict feeding projection)."""
    tags = record.tags.get(tag_layer, [])
    out: Dict[str, List[str]] = {}
    cur_toks: List[str] = []
    cur_tags: List[str] = []

    def flush():
        if cur_toks:
            out[" ".join(cur_toks).lower()] = list(cur_tags)

    for tok, tag in zip(record.tokens, tags):
        prefix, label = tag[:2], tag[2:]
        if prefix in ("B-", "S-") and label != "X":
            flush()
            cur_toks, cur_tags = [tok], [tag]
        elif prefix in ("I-", "E-") and label != "X" and cur_toks:
            cur_toks.append(tok)
            cur_tags.append(tag)
        else:
            flush()
            cur_toks, cur_tags = [], []
    flush()
    return out


def distant_supervision(
    records: Sequence[SentenceRecord],
    results: Sequence[Sequence[RetrievedDoc]],
    tag_layer: str = "ner",
    max_words: int = 100,
    pad_tag: str = "B-X",
) -> List[SentenceRecord]:
    """Silver training sentences by projecting gold entity spans onto
    retrieved contexts (``unlabeled_assignment``, ``:578-657``).

    For each context (<= ``max_words`` words) containing a gold entity's
    exact token span (lowercased), the entity's gold tag sequence is
    copied onto the span and every other token gets ``pad_tag``; contexts
    with overlapping projected spans are skipped, as the reference skips
    double-annotated contexts (``:633-639``)."""
    silver: List[SentenceRecord] = []
    for rec, docs in zip(records, results):
        entity_tags = named_entity_labels(rec, tag_layer)
        if not entity_tags:
            continue
        for d in docs:
            words = d.sentence.split()
            if not words or len(words) > max_words:
                continue
            lower = [w.lower() for w in words]
            spans: List[Tuple[int, int]] = []
            labels: List[List[str]] = []
            for surface, tag_seq in entity_tags.items():
                etoks = surface.split()
                L = len(etoks)
                for i in range(len(words) - L + 1):
                    if lower[i:i + L] == etoks:
                        spans.append((i, i + L))
                        labels.append(tag_seq)
            if not spans:
                continue
            covered: set = set()
            overlap = False
            for s, e in spans:
                span_set = set(range(s, e))
                if covered & span_set:
                    overlap = True
                    break
                covered |= span_set
            if overlap:
                continue
            tags = [pad_tag] * len(words)
            for (s, e), tag_seq in zip(spans, labels):
                for off in range(e - s):
                    tags[s + off] = tag_seq[off]
            silver.append(SentenceRecord(tokens=list(words),
                                         tags={tag_layer: tags}))
    return silver
