"""Equal scores at the k-th place: ``ops.bm25.bm25_topk`` (one pass and
chunked) and ``merge_topk`` against ``kbner_tpu``'s on the same numpy
inputs, ids and scores equal, where ``lax.top_k`` keeps the lowest ids
among equal scores that straddle the cut; and ``search_stream`` over a
stream with empty batches against the reference's over the same stream
without them.

Scores are crafted through one-term operands (each document's impact is
its score) so that runs of equal scores cross the k-th place, or drawn as
seeded integers in [0, 4) over 8 rows at N from 16 to 100,000 (k = 10),
where ``torch.topk`` alone keeps other ids than a stable sort in many
rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.ops import bm25 as jbm25
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu_torch.ops import bm25 as tbm25
from kbner_tpu_torch.retrieval.engine import RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index
from kbner_tpu_torch.retrieval.synth import synth_wiki_docs


def _operands(scores: np.ndarray):
    """K1 operands whose score matrix is ``scores`` [Q, N]: row q's one
    query term is q, and document d holds every row's term with impact
    ``scores[q, d]`` (Ld = Q)."""
    Q, N = scores.shape
    qt = np.arange(Q, dtype=np.int32)[:, None]
    qw = np.ones((Q, 1), np.float32)
    dt = np.repeat(np.arange(Q, dtype=np.int32)[:, None], N, axis=1)
    return qt, qw, dt, scores.astype(np.float32)


def _both(scores, k, doc_chunk=None, id_offset=0):
    ops = _operands(scores)
    ts, ti = tbm25.bm25_topk([tuple(map(torch.from_numpy, ops))], k=k,
                             doc_chunk=doc_chunk, id_offset=id_offset)
    js, ji = jbm25.bm25_topk([tuple(map(jnp.asarray, ops))], k=k,
                             doc_chunk=doc_chunk, use_pallas=False,
                             id_offset=id_offset)
    return (ts.numpy(), ti.numpy()), (np.asarray(js), np.asarray(ji))


def _stable_first(scores, k):
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(scores, order, 1), order


def _crafted():
    """Runs of equal scores across k = 5 in every row: a run straddling
    the cut after a higher run, one that starts the row, one whose members
    lie on both sides of every 8-doc chunk, and a row of one score."""
    N = 32
    rows = np.zeros((4, N), np.float32)
    rows[0, [30, 2, 17]] = 9.0
    rows[0, [29, 3, 25, 11, 7, 19]] = 4.0
    rows[1, :] = 1.0
    rows[1, [31, 0]] = 2.0
    rows[2, ::3] = 5.0
    rows[2, [27, 28]] = 6.0
    rows[3, :] = 7.0
    return rows


@pytest.mark.parametrize("doc_chunk", [None, 8, 16])
@pytest.mark.parametrize("id_offset", [0, 1000])
def test_crafted_ties_at_the_cut(doc_chunk, id_offset):
    (ts, ti), (js, ji) = _both(_crafted(), 5, doc_chunk, id_offset)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(ti, ji)
    ws, wi = _stable_first(_crafted(), 5)
    np.testing.assert_array_equal(ti, wi + id_offset)
    np.testing.assert_array_equal(ts, ws)


@pytest.mark.parametrize("N,doc_chunk", [(16, None), (100, None),
                                         (1000, None), (1000, 100),
                                         (100_000, None), (100_000, 12_500),
                                         (64, 8)])
def test_seeded_integer_scores(N, doc_chunk):
    """Integer scores in [0, 4) over 8 rows, k = 10 (with N = 64 chunked
    by 8 each chunk holds fewer than k docs)."""
    rng = np.random.RandomState(N)
    scores = rng.randint(0, 4, (8, N)).astype(np.float32)
    (ts, ti), (js, ji) = _both(scores, 10, doc_chunk)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(ts, js)
    ws, wi = _stable_first(scores, 10)
    np.testing.assert_array_equal(ti, wi)


@pytest.mark.parametrize("seed", range(4))
def test_row_topk_is_lax_top_k(seed):
    """The one-pass helper against ``jax.lax.top_k``, the reference's call,
    on rows of few distinct values (and k at and beyond N; more tied rows
    than one refill block holds)."""
    rng = np.random.RandomState(seed)
    for q, n, k in ((5, 50, 10), (5, 300, 7), (5, 12, 12), (5, 9, 1),
                    (2 * tbm25.REFILL_ROWS + 3, 200, 10)):
        x = rng.randint(0, 3, (q, n)).astype(np.float32)
        ts, ti = tbm25._row_topk(torch.from_numpy(x), k)
        js, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_merge_topk_prefers_the_first_list():
    """Equal scores in both lists, and within each: ``lax.top_k`` over the
    concatenation keeps the earlier position."""
    rng = np.random.RandomState(7)
    sa = rng.randint(0, 3, (6, 5)).astype(np.float32)
    sb = rng.randint(0, 3, (6, 5)).astype(np.float32)
    ia = rng.randint(0, 50, (6, 5))
    ib = rng.randint(0, 50, (6, 5))
    for k in (1, 4, 5, 10):
        ts, ti = tbm25.merge_topk(*map(torch.from_numpy, (sa, ia, sb, ib)),
                                  k)
        js, ji = jbm25.merge_topk(*map(jnp.asarray, (sa, ia, sb, ib)), k)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# -- empty batches in search_stream ---------------------------------------------

@pytest.fixture(scope="module")
def kb():
    docs = synth_wiki_docs(600, n_topics=20, seed=4)
    vocab = {f"w{i}": i for i in range(int(docs.max()) + 1)}
    queries = [" ".join(f"w{t}" for t in row[row >= 0][:10])
               for row in docs[::23]]
    return docs, vocab, queries


@pytest.mark.parametrize("mode", ["exhaustive", "pruned"])
@pytest.mark.parametrize("encoded", [False, True])
def test_search_stream_yields_empty_results_for_an_empty_batch(kb, mode,
                                                                encoded):
    """``[]`` (or query arrays of no rows) between non-empty batches yields
    ``[0, k]`` results in its place; the other batches' results equal the
    reference's stream over them alone (which fails on the empty batch)."""
    docs, vocab, queries = kb
    index = BM25Index.build_encoded(docs, vocab)
    batches = [queries[:9], queries[9:20]]
    if encoded:
        batches = [index.encode_queries(b) for b in batches]
        empty = (np.zeros((0, batches[0][0].shape[1]), np.int32),
                 np.zeros((0, batches[0][0].shape[1]), np.float32))
    else:
        empty = []
    got = list(RetrievalEngine(index, mode=mode, device="cpu").search_stream(
        [empty, batches[0], [], empty, batches[1], []], k=7))
    jindex = JIndex.build_encoded(docs, vocab)
    want = list(JEngine(jindex, mode=mode, use_pallas=False).search_stream(
        batches, k=7))
    assert [g[0].shape for g in got] == [(0, 7), (9, 7), (0, 7), (0, 7),
                                         (11, 7), (0, 7)]
    for gs, gi in got:
        assert gs.dtype == np.float32 and gi.dtype == np.int64
    for (gs, gi), (ws, wi) in zip([got[1], got[4]], want):
        np.testing.assert_array_equal(gi, np.asarray(wi))
        np.testing.assert_allclose(gs, np.asarray(ws), rtol=1e-6)
