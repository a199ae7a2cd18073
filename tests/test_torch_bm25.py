"""The PyTorch port's BM25 path against kbner_tpu's: analyzer, index, the
plain twin of the exhaustive scoring kernel, top-k and the engine.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU (tests/conftest.py) and its Pallas kernel in interpret mode.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.ops import bm25 as jbm25
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import BM25Params as JParams
from kbner_tpu.retrieval import DocStore as JStore
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval.analyzer import standard_analyze as j_analyze
from kbner_tpu.retrieval.synth import sentence_queries as j_queries
from kbner_tpu.retrieval.synth import synth_wiki_docs as j_synth
from kbner_tpu_torch.ops import bm25 as tbm25
from kbner_tpu_torch.retrieval.analyzer import standard_analyze as t_analyze
from kbner_tpu_torch.retrieval.engine import DocStore, RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index, BM25Params
from kbner_tpu_torch.retrieval.synth import (sentence_queries,
                                             synth_k1_operands,
                                             synth_wiki_docs)

DOCS = [
    "Anthology is a compilation album by New Zealand singer Bic Runga",
    "The quick brown fox jumps over the lazy dog",
    "Berlin is the capital and largest city of Germany",
    "Bic Runga released her first album Drive in 1997",
    "A compilation album is a collection of songs from various recordings",
    "The European Union is a political and economic union of member states",
    "New York City is the most populous city in the United States",
    "Paris is the capital of France and a major European city",
    "The album topped the New Zealand charts for three weeks",
    "Germany is a country in Central Europe",
]
TITLES = [
    "Anthology (Bic Runga album)", "Fox", "Berlin", "Bic Runga",
    "Compilation album", "European Union", "New York City", "Paris",
    "Anthology (Bic Runga album)", "Germany",
]
QUERIES = ["anthology is a compilation album by bic runga",
           "capital city of germany", "the album charts", "zzz unknown",
           "album album city", ""]

# float32 sums over the same terms taken in another order
RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden_inputs():
    path = Path(__file__).parent / "test_analyzer_lucene_golden.py"
    spec = importlib.util.spec_from_file_location("_lucene_golden", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [text for text, _ in mod.GOLDEN]


def assert_same_ranking(scores_a, ids_a, scores_b, ids_b, rtol=1e-5):
    """Equal scores rank by rank, and equal id sets within each group of
    tied scores (torch.topk and lax.top_k order ties differently)."""
    scores_a, scores_b = np.asarray(scores_a), np.asarray(scores_b)
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    np.testing.assert_allclose(scores_a, scores_b, rtol=rtol)
    for q in range(scores_a.shape[0]):
        kth = min(scores_a[q, -1], scores_b[q, -1])
        for s in np.unique(scores_a[q]):
            if np.isclose(s, kth, rtol=rtol):
                continue  # the tie at the k-th score may be cut either way
            ga = set(ids_a[q][np.isclose(scores_a[q], s, rtol=rtol)])
            gb = set(ids_b[q][np.isclose(scores_b[q], s, rtol=rtol)])
            assert ga == gb, (q, s, ga, gb)


def random_operands(seed, Q, Lq, Ld, N, vocab=12):
    """Index-shaped operands: doc pads -1 with zero impact, query pads -2
    (out of vocabulary) and -1, both with weight 0."""
    rng = np.random.RandomState(seed)
    qt = rng.randint(0, vocab, size=(Q, Lq)).astype(np.int32)
    qw = (rng.rand(Q, Lq) + 0.5).astype(np.float32)
    qpad = rng.rand(Q, Lq) < 0.3
    qt[qpad] = rng.choice([-1, -2], size=int(qpad.sum()))
    qw[qpad] = 0.0
    dt = rng.randint(0, vocab, size=(Ld, N)).astype(np.int32)
    di = rng.rand(Ld, N).astype(np.float32)
    dpad = rng.rand(Ld, N) < 0.3
    dt[dpad] = -1
    di[dpad] = 0.0
    return qt, qw, dt, di


# -- analyzer, index ---------------------------------------------------------

def test_analyzer_matches_jax_on_lucene_golden_inputs():
    texts = _golden_inputs() + DOCS + TITLES
    assert len(texts) > 50
    for text in texts:
        assert t_analyze(text) == j_analyze(text), text


@pytest.mark.parametrize("quantize_norms", [True, False])
def test_index_build_and_queries_match_jax(quantize_norms):
    t = BM25Index.build(DOCS, params=BM25Params(quantize_norms=quantize_norms),
                        pad_docs_to=8)
    j = JIndex.build(DOCS, params=JParams(quantize_norms=quantize_norms),
                     pad_docs_to=8)
    assert t.vocab == j.vocab
    assert (t.n_docs, t.avgdl) == (j.n_docs, j.avgdl)
    for name in ("idf", "doc_terms", "doc_impacts", "doc_dl"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for max_terms, boosts in ((64, None), (3, [2.0] * len(QUERIES))):
        tq = t.encode_queries(QUERIES, max_query_terms=max_terms,
                              boosts=boosts)
        jq = j.encode_queries(QUERIES, max_query_terms=max_terms,
                              boosts=boosts)
        for a, b in zip(tq, jq):
            np.testing.assert_array_equal(a, b)


LOOKUP_DOCS = ["alpha extraordinary", "beta gamma"]
# kbner_tpu casts query tokens to the key array's fixed width, so a token
# longer than every key matches the key equal to its prefix; the port
# reproduces that.
TRUNCATED_QUERY = "extraordinarylongword beta"


@pytest.mark.parametrize("query", [
    "extraordinary beta", "alpha gamma zzz", "extra beta", "gamma gamma",
    "Alpha, BETA!", "", TRUNCATED_QUERY])
def test_query_lookup_matches_jax(query):
    t = BM25Index.build(LOOKUP_DOCS, pad_docs_to=8)
    j = JIndex.build(LOOKUP_DOCS, pad_docs_to=8)
    for a, b in zip(t.encode_queries([query], max_query_terms=4),
                    j.encode_queries([query], max_query_terms=4)):
        np.testing.assert_array_equal(a, b)


def test_query_term_longer_than_every_key_matches_its_prefix_key():
    """Both packages map "extraordinarylongword" to "extraordinary", the
    key it begins with that is as wide as the widest key."""
    t = BM25Index.build(LOOKUP_DOCS, pad_docs_to=8)
    qt, _ = t.encode_queries([TRUNCATED_QUERY], max_query_terms=4)
    assert sorted(qt[0].tolist()) == sorted(
        [t.vocab["extraordinary"], t.vocab["beta"], -2, -2])
    j = JIndex.build(LOOKUP_DOCS, pad_docs_to=8)
    jq, _ = j.encode_queries([TRUNCATED_QUERY], max_query_terms=4)
    assert sorted(jq[0].tolist()) == sorted(qt[0].tolist())
    assert j.vocab["extraordinary"] in jq[0].tolist()


def test_synth_and_build_encoded_match_jax():
    docs = synth_wiki_docs(600, vocab=3000, n_topics=12, seed=3)
    np.testing.assert_array_equal(
        docs, j_synth(600, vocab=3000, n_topics=12, seed=3))
    for a, b in zip(sentence_queries(docs, 7, 16, seed=2),
                    j_queries(docs, 7, 16, seed=2)):
        np.testing.assert_array_equal(a, b)
    vocab = {f"w{i}": i for i in range(3000)}
    for cap in ("auto", 9):
        t = BM25Index.build_encoded(docs, vocab, max_doc_terms=cap)
        j = JIndex.build_encoded(docs, vocab, max_doc_terms=cap)
        for name in ("idf", "doc_terms", "doc_impacts", "doc_dl"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))


def test_index_files_open_in_both_packages(tmp_path):
    t = BM25Index.build(DOCS, pad_docs_to=8)
    t.save(tmp_path / "port.idx")
    j = JIndex.load(tmp_path / "port.idx")
    j.save(tmp_path / "jax.idx")
    back = BM25Index.load(tmp_path / "jax.idx")
    assert back.vocab == t.vocab and back.n_docs == t.n_docs
    for name in ("idf", "doc_terms", "doc_impacts", "doc_dl"):
        np.testing.assert_array_equal(getattr(back, name), getattr(t, name))


# -- the plain twin of the exhaustive kernel ---------------------------------

@pytest.mark.parametrize("shape", [(4, 5, 6, 128), (8, 3, 2, 256),
                                   (2, 9, 11, 128)])
def test_score_block_ref_matches_pallas_and_xla(shape):
    qt, qw, dt, di = random_operands(sum(shape), *shape)
    got = tbm25.bm25_score_block_ref(*map(torch.from_numpy, (qt, qw, dt, di)))
    jops = [jnp.asarray(x) for x in (qt, qw, dt, di)]
    xla = np.asarray(jbm25.bm25_score_block_xla(*jops))
    pallas = np.asarray(jbm25.bm25_score_block_pallas(*jops))  # interpret
    assert got.dtype == torch.float32 and tuple(got.shape) == xla.shape
    assert (xla > 0).any()
    np.testing.assert_allclose(got.numpy(), xla, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL)


# the K1 kernel's traps (tests/test_torch_cuda.py holds the kernel to the
# plain twin on the same kinds of operands): (kind, Q, Lq, Ld, D, doc-axis
# offset into a wider array)
K1_TRAPS = {
    "ids-near-2^31": ("big_ids", 4, 8, 6, 128, 0),
    "hash-collisions": ("collide", 8, 16, 6, 256, 0),
    "one-term-in-every-slot": ("shared", 32, 64, 5, 128, 0),
    "repeated-term": ("repeat", 6, 9, 7, 128, 0),
    "Lq=130": ("index", 32, 130, 6, 128, 0),
    "Q=33": ("index", 33, 10, 4, 128, 0),
    "offset-1": ("index", 5, 7, 5, 128, 1),
    "offset-2": ("repeat", 5, 7, 5, 128, 2),
    "offset-3": ("index", 5, 7, 5, 128, 3),
    "N-below-a-tile": ("index", 5, 7, 9, 100, 0),
}


@pytest.mark.parametrize("case", sorted(K1_TRAPS))
def test_score_block_ref_matches_pallas_and_xla_on_kernel_traps(case):
    kind, Q, Lq, Ld, D, off = K1_TRAPS[case]
    qt, qw, dt, di = synth_k1_operands(Q + Lq + D, Q, Lq, Ld, D + off, kind)
    dt, di = dt[:, off:], di[:, off:]
    got = tbm25.bm25_score_block_ref(*map(torch.from_numpy, (qt, qw, dt, di)))
    jops = [jnp.asarray(x) for x in (qt, qw, dt, di)]
    xla = np.asarray(jbm25.bm25_score_block_xla(*jops))
    pallas = np.asarray(jbm25.bm25_score_block_pallas(*jops))  # interpret
    assert tuple(got.shape) == (Q, D) and (xla > 0).any()
    np.testing.assert_allclose(got.numpy(), xla, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=RTOL, atol=1e-6)


def test_score_block_ref_negative_ids_never_match():
    """-1 and -2 never match, even where a -1 doc slot carries an impact
    (the index never writes one; the kernel must not rely on that)."""
    qt, qw, dt, di = random_operands(7, 3, 6, 5, 40)
    qt[:, 0], qw[:, 0] = -1, 5.0
    di[dt == -1] = 9.0
    want = np.zeros((3, 40), np.float64)
    for q in range(3):
        for l in range(6):
            if qt[q, l] >= 0:
                want[q] += qw[q, l] * (di * (dt == qt[q, l])).sum(0)
    got = tbm25.bm25_score_block_ref(*map(torch.from_numpy, (qt, qw, dt, di)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    # the CPU wrapper is the plain version itself
    wrapped = tbm25.bm25_score_block(*map(torch.from_numpy, (qt, qw, dt, di)))
    assert torch.equal(wrapped, got)


@pytest.mark.parametrize("doc_chunk", [None, 64, 128])
@pytest.mark.parametrize("two_fields", [False, True])
def test_topk_matches_jax(doc_chunk, two_fields):
    text = random_operands(11, 6, 5, 7, 256)
    title = random_operands(12, 6, 3, 2, 256)
    fields = [text, title] if two_fields else [text]
    t_fields = [tuple(map(torch.from_numpy, f)) for f in fields]
    j_fields = [tuple(map(jnp.asarray, f)) for f in fields]
    for id_offset in (0, 1000):
        ts, ti = tbm25.bm25_topk(t_fields, k=5, doc_chunk=doc_chunk,
                                 id_offset=id_offset)
        js, ji = jbm25.bm25_topk(j_fields, k=5, doc_chunk=doc_chunk,
                                 use_pallas=False, id_offset=id_offset)
        assert ti.dtype == torch.int64 and tuple(ti.shape) == (6, 5)
        assert_same_ranking(ts.numpy(), ti.numpy(), np.asarray(js),
                            np.asarray(ji))


def test_merge_topk_matches_jax():
    rng = np.random.RandomState(5)
    sa, sb = rng.rand(4, 3).astype(np.float32), rng.rand(4, 3).astype(
        np.float32)
    ia, ib = rng.randint(0, 99, (4, 3)), rng.randint(100, 199, (4, 3))
    ts, ti = tbm25.merge_topk(*map(torch.from_numpy, (sa, ia, sb, ib)), 4)
    js, ji = jbm25.merge_topk(*map(jnp.asarray, (sa, ia, sb, ib)), 4)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_topk_doc_chunk_must_divide():
    ops = tuple(map(torch.from_numpy, random_operands(1, 2, 2, 2, 100)))
    with pytest.raises(ValueError, match="multiple of doc_chunk"):
        tbm25.bm25_topk([ops], k=3, doc_chunk=30)


# -- engine --------------------------------------------------------------------

@pytest.mark.parametrize("with_title", [False, True])
def test_engine_search_matches_jax(with_title):
    params = dict(quantize_norms=False)
    t_idx = BM25Index.build(DOCS, params=BM25Params(**params), pad_docs_to=8)
    j_idx = JIndex.build(DOCS, params=JParams(**params), pad_docs_to=8)
    t_title = j_title = None
    if with_title:
        t_title = BM25Index.build(TITLES, params=BM25Params(**params),
                                  pad_docs_to=8)
        j_title = JIndex.build(TITLES, params=JParams(**params),
                               pad_docs_to=8)
    t_eng = RetrievalEngine(t_idx, store=DocStore(DOCS, titles=TITLES),
                            title_index=t_title, device="cpu")
    j_eng = JEngine(j_idx, store=JStore(DOCS, titles=TITLES),
                    title_index=j_title, use_pallas=False, block_d=8)
    entities = ([["Bic Runga"], ["Paris"], [], ["Germany", "Berlin"],
                 ["Fox"], ["Bic"]] if with_title else None)
    kw = dict(k=4, entity_queries=entities, title_boost=2.0)
    t_res = t_eng.search(QUERIES, **kw)
    j_res = j_eng.search(QUERIES, **kw)
    assert len(t_res) == len(j_res) == len(QUERIES)
    assert any(len(r) for r in t_res)
    for a, b in zip(t_res, j_res):
        assert len(a) == len(b)
        if not a:
            continue
        assert_same_ranking([[d.score for d in a]], [[d.doc_id for d in a]],
                            [[d.score for d in b]], [[d.doc_id for d in b]])
        for d in a:
            assert (d.sentence, d.title) == (DOCS[d.doc_id], TITLES[d.doc_id])
    if with_title:  # the entity boost pulls a Bic Runga title up
        assert "Bic Runga" in t_res[2][0].title


def test_engine_doc_chunk_matches_whole_axis():
    docs = synth_wiki_docs(1500, vocab=2000, n_topics=30, seed=4)
    vocab = {f"w{i}": i for i in range(2000)}
    idx = BM25Index.build_encoded(docs, vocab)
    q, _ = sentence_queries(docs, 5, 64, seed=9)
    qt, qw = idx.encode_queries(
        [" ".join(f"w{t}" for t in row[row >= 0]) for row in q])
    whole = RetrievalEngine(idx, device="cpu")
    chunked = RetrievalEngine(idx, device="cpu", doc_chunk=512)
    assert whole.n_padded == 1536
    ws, wi = whole.search_encoded(qt, qw, k=6)
    cs, ci = chunked.search_encoded(qt, qw, k=6)
    assert_same_ranking(ws, wi, cs, ci)
