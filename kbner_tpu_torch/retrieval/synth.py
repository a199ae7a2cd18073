"""Synthetic wiki-statistics corpora (counterpart of
``kbner_tpu/retrieval/synth.py``, copied unchanged).

Real dumps are not available offline, so collection-scale runs use
synthetic corpora that reproduce the statistics BM25 depends on:

  - Zipf(s~1.07) term distribution over a wiki-sized vocabulary, so
    sentence queries contain genuinely rare terms,
  - log-normal sentence lengths, so document norms and impact magnitudes
    vary like real text,
  - queries are corpus sentences (the v3 query is the raw sentence).

Everything is term-id space; ``BM25Index.build_encoded`` consumes ids.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def zipf_cdf(vocab: int, s: float = 1.07) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    w = ranks ** (-s)
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return cdf


def synth_wiki_docs(
    n_docs: int,
    vocab: int = 1_000_000,
    zipf_s: float = 1.07,
    mean_len: int = 22,
    sigma: float = 0.45,
    min_len: int = 4,
    max_len: int = 64,
    seed: int = 0,
    n_topics: Optional[int] = None,
    entity_frac: float = 0.3,
    entities_per_topic: int = 32,
) -> np.ndarray:
    """[N, max_len] int32 term ids, pad -1 — sentence-like synthetic docs.

    With ``n_topics`` set, docs are TOPICAL: each doc belongs to a topic
    (a wiki page) whose ``entities_per_topic`` rare "entity" terms (names,
    places — drawn from the vocab tail) make up ``entity_frac`` of its
    tokens; the rest is the global Zipf background. This is the structure
    real BM25 sentence retrieval exploits — sentences about the same page
    share rare entity mentions (the reference's example query finds the
    "Bic Runga" page via the rare terms, ``README.md:262-271``) — and it is
    what makes top-k pruning sound on real text. An iid-Zipf corpus
    (``n_topics=None``) has no such structure and is adversarial for ANY
    dynamic-pruning engine (Lucene's WAND/MaxScore included): top-10 there
    is a diffuse sum over mid-frequency terms.
    """
    rng = np.random.RandomState(seed)
    lens = np.clip(
        rng.lognormal(np.log(mean_len), sigma, n_docs), min_len, max_len
    ).astype(np.int64)
    total = int(lens.sum())
    cdf = zipf_cdf(vocab, zipf_s)
    # inverse-CDF sampling in one vectorized pass
    terms = np.searchsorted(cdf, rng.random_sample(total)).astype(np.int32)
    if n_topics:
        # per-topic entity vocabularies from the rare tail
        tail_lo = vocab // 10
        ent_vocab = rng.randint(
            tail_lo, vocab, size=(n_topics, entities_per_topic)
        ).astype(np.int32)
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
    return tok


def sentence_queries(
    docs: np.ndarray, n_queries: int, q_len: int, seed: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sentence queries = corpus rows (v3 retrieval semantics), padded to
    [Q, q_len] with -1; returns (query term ids, source doc ids)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, docs.shape[0], size=n_queries)
    q = np.full((n_queries, q_len), -1, dtype=np.int32)
    width = min(q_len, docs.shape[1])
    q[:, :width] = docs[ids, :width]
    return q, ids


def synth_delta16_docs(
    seed: int, n_docs: int = 64, max_terms: int = 10, vocab: int = 50_000,
    long_doc: int = 0, ids: Optional[np.ndarray] = None,
):
    """Inputs of the delta16 row packer (``engine._pack_doc_rows_delta16``)
    for edge cases of the rescore kernel: ``n_docs`` docs of up to
    ``max_terms`` distinct terms over a ``vocab``-term space whose remap
    keeps its order (every term non-tiny, equal df), so the ids of a doc
    spread over the whole space and gaps overflow the 13-bit field
    (continuation slots); tf 1..6; with ``long_doc``, doc 1 holds that many
    terms (a segment over 128 slots spans two rows). With ``ids``
    (distinct non-negative term ids), every doc draws its terms from them,
    the space is ``max(ids) + 1`` terms, and doc 2 holds all of them, so
    its gaps are those of ``ids``. Norms (k1=1.2, b=0.75) come from
    Lucene-quantized doc lengths. Returns (dt [N, L] int32, di [N, L]
    float32, remap [V] int64, idf [V] float32, norm [N] float32,
    norm_code [N] uint8, avgdl)."""
    from .index import int4_to_long, long_to_int4

    rng = np.random.RandomState(seed)
    if ids is not None:
        vocab = int(ids.max()) + 1
    width = max(max_terms, long_doc, 0 if ids is None else len(ids))
    dt = np.full((n_docs, width), -1, np.int32)
    di = np.zeros((n_docs, width), np.float32)
    idf = rng.uniform(0.5, 8.0, vocab).astype(np.float32)
    dl = rng.randint(1, 300, n_docs)
    code = np.asarray([long_to_int4(int(x)) for x in dl], np.uint8)
    dlq = np.asarray([int4_to_long(int(c)) for c in code], np.int64)
    avgdl = float(dl.mean())
    norm = (1.2 * (1.0 - 0.75 + 0.75 * dlq / avgdl)).astype(np.float32)
    for d in range(n_docs):
        n = long_doc if (long_doc and d == 1) else rng.randint(
            0, max_terms + 1)
        if ids is None:
            terms = rng.choice(vocab, size=n, replace=False)
        elif d == 2:
            terms = ids
        else:
            terms = rng.choice(ids, size=min(n, len(ids)), replace=False)
        n = len(terms)
        tfs = rng.randint(1, 7, size=n)
        dt[d, :n] = terms
        di[d, :n] = idf[terms] * tfs / (tfs + norm[d])
    remap = np.arange(vocab, dtype=np.int64)
    return dt, di, remap, idf, norm, code, avgdl


def synth_rescore_operands(seed: int, Q: int, C: int, long_doc: int = 0,
                           W: int = 16):
    """A rescore batch over :func:`synth_delta16_docs` rows, as numpy
    arrays: (q_terms [Q, W] int32, q_weights [Q, W] float32, cand [Q, C]
    int32, flat [NR, 128] uint16, doc_off [N] int32, doc_len [N] int32,
    norm_code [N] uint8, k1, b, avgdl, r2). A fifth of the candidates are
    id 0 (where the engine puts invalid ones); with ``long_doc`` every
    third is doc 1; each query holds up to W - 4 terms of its candidates,
    one id that matches nothing likely, and -1 pads."""
    from .engine import _pack_doc_rows_delta16

    dt, di, remap, idf, norm, code, avgdl = synth_delta16_docs(
        seed, long_doc=long_doc)
    flat, off, lens, r2 = _pack_doc_rows_delta16(dt, di, remap, idf, norm)
    rng = np.random.RandomState(seed)
    cand = _d16_candidates(rng, dt.shape[0], Q, C, long_doc)
    qt = _d16_queries(rng, dt, remap, cand, W)
    qw = rng.uniform(0.5, 8.0, size=(Q, W)).astype(np.float32)
    return (qt, qw, cand, flat, off, lens.astype(np.int32), code, 1.2, 0.75,
            avgdl, r2)


def _d16_candidates(rng: np.random.RandomState, n_docs: int, Q: int, C: int,
                    long_doc: int) -> np.ndarray:
    """[Q, C] int32 candidates: a fifth at id 0, every third doc 1 with
    ``long_doc``."""
    cand = rng.randint(0, n_docs, size=(Q, C)).astype(np.int32)
    cand[rng.rand(Q, C) < 0.2] = 0
    if long_doc:
        cand[:, ::3] = 1
    return cand


def _d16_queries(rng: np.random.RandomState, dt: np.ndarray,
                 remap: np.ndarray, cand: np.ndarray, W: int) -> np.ndarray:
    """[Q, W] int32 query terms: up to W - 4 terms of each query's
    candidates, one id that matches nothing likely, -1 pads."""
    qt = np.full((cand.shape[0], W), -1, np.int32)
    for q in range(cand.shape[0]):
        rows = dt[cand[q]]
        pool = np.unique(remap[rows[rows >= 0]])
        pick = rng.choice(pool, size=min(len(pool), W - 4), replace=False)
        qt[q, :len(pick)] = pick
        qt[q, W - 4] = rng.randint(0, len(remap))
    return qt


def _scatter_segments(flat: np.ndarray, off: np.ndarray, lens: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The segments of delta16 rows laid out again, each one to three slots
    after the one before, so most start at an offset that is not a
    multiple of 4 and long ones run over row boundaries. Returns (flat,
    off int32, r2: the most rows a segment covers, counted from the row of
    its first slot)."""
    lanes = flat.shape[1]
    src = flat.reshape(-1)
    lens = lens.astype(np.int64)
    new_off = np.zeros(len(off), np.int64)
    cursor = 0
    for d in range(len(off)):
        cursor += 1 + d % 3
        new_off[d] = cursor
        cursor += lens[d]
    last = new_off + np.maximum(lens, 1) - 1
    r2 = int((last // lanes - new_off // lanes).max()) + 1
    out = np.zeros(((cursor + lanes - 1) // lanes + r2) * lanes, np.uint16)
    for d in range(len(off)):
        out[new_off[d]:new_off[d] + lens[d]] = \
            src[off[d]:off[d] + lens[d]]
    return out.reshape(-1, lanes), new_off.astype(np.int32), r2


K2_KINDS = ("collide", "repeat", "wide", "max_terms", "unaligned", "max_gap")
# ids whose successive gaps sit at and around the 13-bit gap field's top:
# 8191 is one continuation slot and a real slot of gap 0, 8190 the largest
# real gap, 16382 two continuations
_MAX_GAP_IDS = np.cumsum([8191, 8190, 8191, 8192, 16382, 16383, 1, 3 * 8191])


def synth_k2_operands(seed: int, Q: int, C: int, kind: str):
    """A rescore batch for edge cases of the K2 kernel, in the form of
    :func:`synth_rescore_operands`. ``kind`` picks the trap:

    * ``collide``: docs and queries over 48 ids below 2^21 that fall on one
      slot of the kernels' term hash at every table size up to 8192 (8 of
      them in no doc);
    * ``repeat``: each query holds its first term in slots 0, 1, 3 and 40
      (two 32-slot chunks of the table build), W = 48;
    * ``wide``: W = 256;
    * ``max_terms``: W = 6144, the wrapper's limit, every slot a term;
    * ``unaligned``: the segments laid out again one to three slots apart,
      doc 1 of 300 slots running into a second and a third row (r2 = 3);
    * ``max_gap``: docs over ids whose gaps are 8191, 8190, 8192, 16382 and
      more (continuation slots, real slots of gap 0 and the largest gap),
      half the candidates doc 2, which holds them all.
    """
    if kind not in K2_KINDS:
        raise ValueError(f"kind must be one of {K2_KINDS}, got {kind!r}")
    from .engine import _pack_doc_rows_delta16

    rng = np.random.RandomState(seed)
    W = {"repeat": 48, "wide": 256, "max_terms": 6144}.get(kind, 16)
    long_doc = 300 if kind == "unaligned" else 0
    ids = misses = None
    if kind == "collide":
        ids = _colliding_ids(rng, 48, hi=1 << 21)
        ids, misses = ids[:40], ids[40:]
    elif kind == "max_gap":
        ids = _MAX_GAP_IDS
    dt, di, remap, idf, norm, code, avgdl = synth_delta16_docs(
        seed, long_doc=long_doc, ids=ids)
    flat, off, lens, r2 = _pack_doc_rows_delta16(dt, di, remap, idf, norm)
    if kind == "unaligned":
        flat, off, r2 = _scatter_segments(flat, off, lens)
    cand = _d16_candidates(rng, dt.shape[0], Q, C, long_doc)
    if kind == "max_gap":
        cand[:, ::2] = 2
    qt = _d16_queries(rng, dt, remap, cand, W)
    if kind == "collide":  # the id that matches nothing collides too
        qt[:, W - 4] = misses[np.arange(Q) % len(misses)]
    if kind == "max_terms":  # fill the pads with ids that mostly miss
        pad = qt == -1
        qt[pad] = rng.randint(0, len(remap), size=int(pad.sum()))
    if kind == "repeat":
        for j in (1, 3, 40):
            qt[:, j] = qt[:, 0]
    qw = rng.uniform(0.5, 8.0, size=(Q, W)).astype(np.float32)
    return (qt, qw, cand, flat, off, lens.astype(np.int32), code, 1.2, 0.75,
            avgdl, r2)


K3_KINDS = ("random", "collide", "pads")


def synth_k3_operands(seed: int, Q: int, C: int, Lq: int, Ld: int,
                      n_docs: int = 0, vocab: int = 40, kind: str = "random"):
    """A two-array rescore batch for edge cases of the K3 kernel, as numpy
    arrays: (q_terms [Q, Lq] int32, q_weights [Q, Lq] float32, cand [Q, C]
    int32, doc_terms [N, Ld] int32, doc_codes [N, Ld] uint16, lo, step).
    Term ids are drawn from [-1, vocab) on both sides, so -1 query pads
    meet -1 doc pads, and codes are random 16-bit values under every slot
    (pads included), with doc 1 all code 0 and doc N - 1 all code 65535;
    candidates include ids 0, 1 and N - 1 (N - 1 last); the first query
    term is doc N - 1's first and the second repeats it. ``lo`` and
    ``step`` are the 16-bit log scale of the reference's kernel test.
    ``kind`` ``collide`` draws the ``vocab`` real ids (and -1) from ids on
    one slot of the kernels' term hash at every table size up to 8192;
    ``pads`` also puts -1 in every third query slot and in the last third
    of every row, under nonzero codes."""
    if kind not in K3_KINDS:
        raise ValueError(f"kind must be one of {K3_KINDS}, got {kind!r}")
    rng = np.random.RandomState(seed)
    n = n_docs or max(2 * C, 8)
    pool = None
    if kind == "collide":
        pool = np.concatenate([[-1], _colliding_ids(rng, vocab)])
        pool = pool.astype(np.int32)
        dt = pool[rng.randint(0, len(pool), size=(n, Ld))]
    else:
        dt = rng.randint(-1, vocab, size=(n, Ld)).astype(np.int32)
    codes = rng.randint(0, 1 << 16, size=(n, Ld)).astype(np.uint16)
    if kind == "pads":
        dt[:, Ld - Ld // 3:] = -1
        codes[:, Ld - Ld // 3:] |= 1
    codes[1] = 0
    codes[n - 1] = 65535
    cand = rng.randint(0, n, size=(Q, C)).astype(np.int32)
    cand[:, C // 2] = 1
    cand[:, 0] = 0
    cand[:, -1] = n - 1
    if pool is None:
        qt = rng.randint(-1, vocab, size=(Q, Lq)).astype(np.int32)
    else:
        qt = pool[rng.randint(0, len(pool), size=(Q, Lq))]
    if kind == "pads":
        qt[:, 2::3] = -1
    qt[:, 0] = dt[n - 1, 0]  # a sure match, at code 65535
    if Lq > 1:
        qt[:, 1] = qt[:, 0]
        qt[:, -1] = -1
    qw = rng.uniform(0.5, 8.0, size=(Q, Lq)).astype(np.float32)
    return qt, qw, cand, dt, codes, -2.0, 1e-4


K1_KINDS = ("index", "big_ids", "collide", "shared", "repeat")
_HASH_MUL = 2654435761  # the kernels' multiplicative term hash


def _colliding_ids(rng: np.random.RandomState, n: int,
                   hi: int = 2**31 - 1) -> np.ndarray:
    """``n`` distinct ids in ``[0, hi)`` whose products with
    :data:`_HASH_MUL` (mod 2^32) share their top 13 bits, so they fall on
    one slot of a multiplicative hash table of any size up to 8192."""
    cand = np.unique(rng.randint(0, hi, size=1 << 23).astype(np.int64))
    top = ((cand * _HASH_MUL) & 0xFFFFFFFF) >> 19
    counts = np.bincount(top, minlength=1 << 13)
    return cand[top == np.argmax(counts)][:n]


def synth_k1_operands(seed: int, Q: int, Lq: int, Ld: int, N: int,
                      kind: str = "index"):
    """Exhaustive-scoring operands for edge cases of the K1 kernel, laid
    out as the index writes them, as numpy arrays: (q_terms [Q, Lq] int32,
    q_weights [Q, Lq] float32, doc_terms_t [Ld, N] int32, doc_impacts_t
    [Ld, N] float32). About 30% of the query slots are pads -2 with weight
    0 and 30% of the doc slots pads -1 with impact 0; real ids come from a
    set of 40, so queries repeat terms. ``kind`` picks the set and the
    query pattern:

    * ``index``: ids 0 .. 39;
    * ``big_ids``: ids just below 2^31 - 1 (and 2^31 - 1 itself);
    * ``collide``: half the ids share one slot of the kernel's hash at
      every table size up to 8192, half share their low 16 bits;
    * ``shared``: every slot of every query holds one term, which lies in
      about a third of the doc slots (the longest run of queries);
    * ``repeat``: each query holds its first term three times.
    """
    if kind not in K1_KINDS:
        raise ValueError(f"kind must be one of {K1_KINDS}, got {kind!r}")
    rng = np.random.RandomState(seed)
    vocab = 40
    if kind == "big_ids":
        ids = (2**31 - 1) - np.arange(vocab, dtype=np.int64)
    elif kind == "collide":
        low = (np.arange(vocab - vocab // 2, dtype=np.int64) << 16) | 0x1234
        ids = np.concatenate([_colliding_ids(rng, vocab // 2), low])
    else:
        ids = np.arange(vocab, dtype=np.int64)
    ids = ids.astype(np.int32)
    qt = ids[rng.randint(0, len(ids), size=(Q, Lq))]
    qw = rng.uniform(0.5, 4.0, size=(Q, Lq)).astype(np.float32)
    dt = ids[rng.randint(0, len(ids), size=(Ld, N))]
    di = rng.rand(Ld, N).astype(np.float32)
    if kind == "shared":
        qt[:] = ids[0]
        dt[rng.rand(Ld, N) < 0.3] = ids[0]
    else:
        qpad = rng.rand(Q, Lq) < 0.3
        if kind == "repeat" and Lq >= 4:
            qpad[:, :4] = False
            qt[:, 1] = qt[:, 3] = qt[:, 0]
        qt[qpad] = -2
        qw[qpad] = 0.0
    dpad = rng.rand(Ld, N) < 0.3
    dt[dpad] = -1
    di[dpad] = 0.0
    return qt, qw, dt, di
