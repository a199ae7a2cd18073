"""The one traffic generator: every mix under ``portbench/traffic/`` is a
JSON file of parameters that these functions read.

Sentence lengths are log-normal (``len_median``, ``len_sigma``) clipped to
``[len_min, len_max]``, and every seed gets the same lengths: each block of
``block`` sentences holds the block's quantiles of that distribution,
permuted by the seed. What the seed changes is the order, the topics and
the words: a sentence of topic t is drawn as the knowledge base draws a
document of t (that topic's entity terms at the KB's entity share, the
rest from the Zipf background), so it is no row of the KB.
"""

from __future__ import annotations

from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

from .kbgen import TopicModel
from .reference import EOS, subtokens

TYPES = ("PER", "LOC", "GRP", "CORP", "PROD", "CW")


def tag_list() -> List[str]:
    """The tag set: ``O``, BIOES of MultiCoNER 2022's six types; the CRF's
    ``<START>`` and ``<STOP>`` come after these."""
    return ["O"] + [f"{p}-{t}" for t in TYPES for p in "BIES"]


def _quantiles(n: int, median: float, sigma: float, lo: int, hi: int
               ) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    z = np.array([NormalDist().inv_cdf(float(x)) for x in q])
    return np.clip(np.rint(median * np.exp(sigma * z)), lo, hi).astype(
        np.int64)


def lengths(p: dict, n: int, rng: np.random.RandomState) -> np.ndarray:
    """``n`` sentence lengths: blocks of ``p["block"]`` with the same
    quantiles, each block permuted."""
    block = _quantiles(p["block"], p["len_median"], p["len_sigma"],
                       p["len_min"], p["len_max"])
    out = np.concatenate([rng.permutation(block)
                          for _ in range(-(-n // p["block"]))])
    return out[:n]


def sentences(p: dict, n: int, rng: np.random.RandomState,
              topics: TopicModel) -> Tuple[List[List[int]], List[List[bool]],
                                           np.ndarray]:
    """``n`` sentences of random topics: (term ids, entity flags, topics)."""
    lens = lengths(p, n, rng)
    topic = rng.randint(0, topics.ent_vocab.shape[0], size=n)
    terms, is_ent = topics.draw(rng, topic, lens)
    cut = np.cumsum(lens)[:-1]
    return ([t.tolist() for t in np.split(terms, cut)],
            [e.tolist() for e in np.split(is_ent, cut)], topic)


def backlog(p: dict, seed: int, topics: TopicModel) -> List[Dict]:
    """The serve client's backlog: ``p["sentences"]`` requests
    ``{"id", "tokens"}``."""
    rng = np.random.RandomState(seed % 2**32)
    sents, _, _ = sentences(p, p["sentences"], rng, topics)
    return [{"id": i, "tokens": [f"w{t}" for t in s]}
            for i, s in enumerate(sents)]


def bioes(flags: List[bool], typ: str) -> List[str]:
    """BIOES tags of the runs of entity terms, each run one entity."""
    tags, i = ["O"] * len(flags), 0
    while i < len(flags):
        if not flags[i]:
            i += 1
            continue
        j = i
        while j + 1 < len(flags) and flags[j + 1]:
            j += 1
        if i == j:
            tags[i] = f"S-{typ}"
        else:
            tags[i], tags[j] = f"B-{typ}", f"E-{typ}"
            for m in range(i + 1, j):
                tags[m] = f"I-{typ}"
        i = j + 1
    return tags


def fused_records(p: dict, seed: int, topics: TopicModel
                  ) -> List[Tuple[List[str], List[str]]]:
    """``p["records"]`` training records as ``cli retrieve`` writes them: a
    sentence (BIOES over its entity runs, the type by topic), ``<EOS>``,
    then ``[ title ] sentence`` contexts of the same topic (lengths as the
    KB's documents) while the ``p["budget"]`` subtokens hold; context words
    and ``<EOS>`` tagged ``S-X``."""
    rng = np.random.RandomState(seed % 2**32)
    n = p["records"]
    sents, flags, topic = sentences(p, n, rng, topics)
    ctx = p["context"]
    out = []
    for words, ent, t in zip(sents, flags, topic):
        tokens = [f"w{w}" for w in words]
        tags = bioes(ent, TYPES[int(t) % len(TYPES)])
        used = subtokens(tokens) + 1
        fused, ftags = tokens + [EOS], tags + ["S-X"]
        while True:
            m = int(np.clip(rng.lognormal(np.log(ctx["len_mean"]),
                                          ctx["len_sigma"]),
                            ctx["len_min"], ctx["len_max"]))
            row, _ = topics.draw(rng, np.array([t]), np.array([m]))
            doc = [f"w{w}" for w in row.tolist()]
            c = ["[", *doc[:2], "]", *doc]
            if used + subtokens(c) > p["budget"]:
                break
            fused += c
            ftags += ["S-X"] * len(c)
            used += subtokens(c)
        out.append((fused, ftags))
    return out
