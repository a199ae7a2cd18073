"""Corpus surgery for training (counterpart of
``kbner_tpu/data/corpus_ops.py``): language resampling with smoothing,
direct upsampling, downsampling, clipping over-budget sentences, and the
context-free view of a fused sentence for multi-view training."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .conll import ListCorpus, SentenceRecord
from .subword import SubwordTokenizer, subtoken_length


def resample_language_sizes(
    sizes: Sequence[int], smooth: float = 0.7
) -> List[int]:
    """Target per-corpus sample counts: total * size_i^smooth / sum."""
    sizes = np.asarray(sizes, dtype=np.float64)
    total = int(sizes.sum())
    w = sizes ** smooth
    w = w / w.sum()
    return [max(1, int(round(total * wi))) for wi in w]


def resample_corpora(
    corpus: ListCorpus, smooth: float = 0.7, seed: int = 0
) -> List[SentenceRecord]:
    """Resampled concatenated train list (small languages upweighted)."""
    rng = np.random.RandomState(seed)
    sizes = [len(c.train) for c in corpus.corpora]
    targets = resample_language_sizes(sizes, smooth)
    out: List[SentenceRecord] = []
    for c, n_target in zip(corpus.corpora, targets):
        n = len(c.train)
        if n == 0:
            continue
        idx = rng.choice(n, size=n_target, replace=n_target > n)
        out.extend(c.train[i] for i in idx)
    return out


def direct_upsample(
    corpus: ListCorpus, rate: int, max_size: Optional[int] = None
) -> None:
    """Copy small corpora x rate in place (corpora smaller than max_size,
    or all when max_size is None)."""
    for c in corpus.corpora:
        if max_size is not None and len(c.train) >= max_size:
            continue
        c.train = list(c.train) * rate


def down_sample(corpus: ListCorpus, amount: int, seed: int = 0) -> None:
    """Cap each corpus's train split at ``amount`` sentences in place."""
    rng = np.random.RandomState(seed)
    for c in corpus.corpora:
        if len(c.train) > amount:
            idx = rng.choice(len(c.train), size=amount, replace=False)
            c.train = [c.train[i] for i in sorted(idx)]


def clip_sentences(
    corpus: ListCorpus, tokenizer: SubwordTokenizer, max_subtokens: int = 510
) -> int:
    """Drop train sentences over the subtoken budget in place; returns the
    number removed."""
    removed = 0
    for c in corpus.corpora:
        kept = [r for r in c.train
                if subtoken_length(tokenizer, r.tokens) <= max_subtokens]
        removed += len(c.train) - len(kept)
        c.train = kept
    return removed


def make_orig_view(rec: SentenceRecord, tag_layer: str = "ner"
                   ) -> SentenceRecord:
    """The context-free view: tokens and tags truncated at <EOS>."""
    eos = rec.eos_index
    if eos < 0:
        return rec
    return SentenceRecord(
        tokens=rec.tokens[:eos],
        tags={layer: tags[:eos] for layer, tags in rec.tags.items()},
        doc_id=rec.doc_id, lang_id=rec.lang_id, comment=rec.comment)
