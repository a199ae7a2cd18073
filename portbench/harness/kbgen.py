"""The synthetic knowledge base and the words of its topics.

A copy of ``kbner_tpu_torch/retrieval/synth.py``'s ``zipf_cdf`` and
``synth_wiki_docs``, kept here so that the yardstick does not move with the
program. The copy also returns what the original draws and drops: each
topic's entity terms and each document's topic, which the traffic
generator needs to draw new sentences "of a topic" as a document is drawn.

Documents are term ids ``[N, max_len]`` int32, pad -1; a term id ``t`` is the
word ``w<t>`` (how the benchmark renders a document into text).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def zipf_cdf(vocab: int, s: float = 1.07) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** (-s)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return cdf


@dataclasses.dataclass
class TopicModel:
    """What a document of a topic is drawn from: the Zipf background over
    ``vocab`` terms and each topic's ``[n_topics, entities_per_topic]``
    entity terms, which make up ``entity_frac`` of a document's tokens."""

    vocab: int
    zipf_s: float
    entity_frac: float
    ent_vocab: np.ndarray
    _cdf: Optional[np.ndarray] = None

    def draw(self, rng: np.random.RandomState, topics: np.ndarray,
             lens: np.ndarray) -> tuple:
        """Tokens of one sentence per ``(topic, length)``: the flat term
        ids, and whether each is an entity term."""
        total = int(lens.sum())
        if self._cdf is None:
            self._cdf = zipf_cdf(self.vocab, self.zipf_s)
        terms = np.searchsorted(self._cdf, rng.random_sample(total)).astype(
            np.int64)
        tok_topic = np.repeat(topics, lens)
        is_ent = rng.random_sample(total) < self.entity_frac
        slot = rng.randint(0, self.ent_vocab.shape[1], size=total)
        terms = np.where(is_ent, self.ent_vocab[tok_topic, slot], terms)
        return terms, is_ent


def synth_wiki_docs(
    n_docs: int,
    vocab: int = 1_000_000,
    zipf_s: float = 1.07,
    mean_len: int = 22,
    sigma: float = 0.45,
    min_len: int = 4,
    max_len: int = 64,
    seed: int = 0,
    n_topics: int = 20_000,
    entity_frac: float = 0.3,
    entities_per_topic: int = 32,
):
    """``(docs [N, max_len] int32 pad -1, doc_topic [N], TopicModel)``:
    the draws of the original, in its order, with topics always on."""
    rng = np.random.RandomState(seed)
    lens = np.clip(
        rng.lognormal(np.log(mean_len), sigma, n_docs), min_len, max_len
    ).astype(np.int64)
    total = int(lens.sum())
    cdf = zipf_cdf(vocab, zipf_s)
    terms = np.searchsorted(cdf, rng.random_sample(total)).astype(np.int32)
    tail_lo = vocab // 10
    ent_vocab = rng.randint(
        tail_lo, vocab, size=(n_topics, entities_per_topic)).astype(np.int32)
    doc_topic = rng.randint(0, n_topics, size=n_docs)
    tok_topic = np.repeat(doc_topic, lens)
    is_ent = rng.random_sample(total) < entity_frac
    ent_slot = rng.randint(0, entities_per_topic, size=total)
    terms = np.where(is_ent, ent_vocab[tok_topic, ent_slot], terms)
    tok = np.full((n_docs, max_len), -1, dtype=np.int32)
    row = np.repeat(np.arange(n_docs), lens)
    offs = np.cumsum(lens) - lens
    col = np.arange(total) - np.repeat(offs, lens)
    tok[row, col] = terms
    return tok, doc_topic, TopicModel(vocab, zipf_s, entity_frac, ent_vocab)


def render(row: np.ndarray) -> str:
    """A document's text: its terms as ``w<id>`` words."""
    return " ".join(f"w{t}" for t in row[row >= 0].tolist())


def title_of(row: np.ndarray) -> str:
    """A document's title: its first two words (the smoke's title field)."""
    return " ".join(f"w{t}" for t in row[:2].tolist())
