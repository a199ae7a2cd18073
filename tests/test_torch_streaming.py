"""The port's collection-scale index against kbner_tpu's: the streamed
chunked build, row-blocked postings, sharded persistence and the float64
scoring oracle.

The first five tests mirror ``tests/test_streaming_build.py`` case by case
on the port: ``build_streaming`` equals the one-shot ``build_encoded`` on
the concatenated input, and ``save_sharded``/``load_sharded`` round-trip
it exactly. The rest hold the port to the JAX package on the same numpy
inputs: equal arrays, equal postings, oracle scores within rtol 1e-6, and
sharded directories that open in either package.
"""

import dataclasses

import numpy as np
import pytest

from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu_torch.retrieval.index import BM25Index
from kbner_tpu_torch.retrieval.synth import synth_wiki_docs

VOCAB = 500


def _chunks(seed=0, widths=(24, 24, 24), n=(400, 300, 137)):
    rng = np.random.RandomState(seed)
    out = []
    for w, ni in zip(widths, n):
        lens = rng.randint(3, w + 1, size=ni)
        tok = np.full((ni, w), -1, np.int32)
        for i, L in enumerate(lens):
            tok[i, :L] = rng.randint(0, VOCAB, size=L)
        out.append(tok)
    return out


def _pad_concat(chunks):
    w = max(c.shape[1] for c in chunks)
    rows = [np.pad(c, ((0, 0), (0, w - c.shape[1])), constant_values=-1)
            for c in chunks]
    return np.vstack(rows)


def _vocab():
    return {f"t{i}": i for i in range(VOCAB)}


def _same_index(got, want):
    assert got.n_docs == want.n_docs
    assert got.avgdl == want.avgdl
    assert dataclasses.asdict(got.params) == \
        dataclasses.asdict(want.params)
    np.testing.assert_array_equal(got.idf, want.idf)
    np.testing.assert_array_equal(got.doc_terms, want.doc_terms)
    np.testing.assert_array_equal(got.doc_impacts, want.doc_impacts)
    np.testing.assert_array_equal(got.doc_dl, want.doc_dl)


def _row_pairs(index):
    """Each row's (term, impact bits) pairs, sorted: the kept set under a
    cap, whatever their order in the row."""
    return np.sort(index.doc_terms.astype(np.int64) * (1 << 32)
                   + index.doc_impacts.view(np.int32), axis=1)


# -- tests/test_streaming_build.py, on the port ------------------------------------

@pytest.mark.parametrize("widths", [(24, 24, 24), (16, 40, 28)])
def test_streaming_equals_one_shot(widths):
    chunks = _chunks(widths=widths)
    one = BM25Index.build_encoded(_pad_concat(chunks), _vocab())
    stream = BM25Index.build_streaming(iter(chunks), _vocab())
    _same_index(stream, one)


def test_streaming_capped_score_parity():
    """Under a max_doc_terms cap the per-row term order may differ (both
    paths keep the highest-impact terms); the kept pairs are equal."""
    chunks = _chunks(seed=3, widths=(48, 48), n=(200, 200))
    one = BM25Index.build_encoded(_pad_concat(chunks), _vocab(),
                                  max_doc_terms=8)
    stream = BM25Index.build_streaming(iter(chunks), _vocab(),
                                       max_doc_terms=8)
    assert stream.doc_terms.shape == one.doc_terms.shape
    np.testing.assert_array_equal(_row_pairs(stream), _row_pairs(one))


def test_streaming_synth_chunks_match():
    """Seeded synth chunks equal the one-shot build on the stacked
    corpus."""
    vocab = {i: i for i in range(2000)}
    chunks = [synth_wiki_docs(512, vocab=2000, n_topics=16, seed=s)
              for s in range(3)]
    one = BM25Index.build_encoded(np.vstack(chunks), vocab)
    stream = BM25Index.build_streaming(iter(chunks), vocab)
    np.testing.assert_array_equal(stream.doc_terms, one.doc_terms)
    np.testing.assert_array_equal(stream.doc_impacts, one.doc_impacts)


def test_sharded_roundtrip(tmp_path):
    idx = BM25Index.build_streaming(iter(_chunks(seed=7)), _vocab())
    idx.save_sharded(tmp_path / "sharded", n_shards=4)
    back = BM25Index.load_sharded(tmp_path / "sharded")
    _same_index(back, idx)
    assert back.vocab == idx.vocab
    q = ["t3 t17 t17 t99"]
    np.testing.assert_allclose(back.score_oracle(q), idx.score_oracle(q))


def test_sharded_uneven_last_shard(tmp_path):
    vocab = {i: i for i in range(300)}
    idx = BM25Index.build_encoded(synth_wiki_docs(1001, vocab=300, seed=1),
                                  vocab)
    idx.save_sharded(tmp_path / "s", n_shards=3)  # 334 + 334 + 333
    back = BM25Index.load_sharded(tmp_path / "s")
    np.testing.assert_array_equal(back.doc_terms, idx.doc_terms)
    np.testing.assert_array_equal(back.doc_impacts, idx.doc_impacts)


# -- against kbner_tpu -----------------------------------------------------------

@pytest.mark.parametrize("widths,cap", [
    ((24, 24, 24), "auto"), ((16, 40, 28), "auto"), ((48, 48), 8),
    ((16, 40, 28), None)])
def test_streaming_equals_the_jax_build(widths, cap):
    chunks = _chunks(seed=5, widths=widths, n=(300, 200, 91)[:len(widths)])
    got = BM25Index.build_streaming(iter(chunks), _vocab(),
                                    max_doc_terms=cap)
    want = JIndex.build_streaming(iter(chunks), _vocab(), max_doc_terms=cap)
    _same_index(got, want)


def test_streaming_wide_chunk_raises():
    with pytest.raises(ValueError, match="uint16"):
        BM25Index.build_streaming(
            iter([np.zeros((1, 1 << 16), np.int32)]), _vocab())


def test_streaming_skips_an_empty_chunk():
    """A chunk of no documents adds none: the layout equals the one-shot
    build. (The JAX package keeps one spurious per-document term count
    for such a chunk, which shifts the later documents' row offsets.)"""
    chunks = _chunks(seed=9)
    one = BM25Index.build_encoded(_pad_concat(chunks), _vocab())
    stream = BM25Index.build_streaming(
        iter([chunks[0], np.zeros((0, 24), np.int32)] + chunks[1:]),
        _vocab())
    _same_index(stream, one)


@pytest.mark.parametrize("lanes,guard", [(128, 32), (16, 3)])
def test_csr_rows_match_jax(lanes, guard):
    chunks = _chunks(seed=11)
    got = BM25Index.build_streaming(iter(chunks), _vocab())
    want = JIndex.build_streaming(iter(chunks), _vocab())
    for g, w in zip(got.csr_rows(lanes, guard), want.csr_rows(lanes, guard)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_score_oracle_matches_jax():
    chunks = _chunks(seed=13)
    got = BM25Index.build_streaming(iter(chunks), _vocab())
    want = JIndex.build_streaming(iter(chunks), _vocab())
    queries = ["t3 t17 t17 t99", "t5 nope t400", "", "t1 t2 t3 t4 t5"]
    boosts = [1.0, 2.0, 1.0, 0.5]
    for b in (None, boosts):
        g = got.score_oracle(queries, boosts=b)
        assert g.dtype == np.float64 and g.shape == (4, got.doc_terms.shape[0])
        np.testing.assert_allclose(g, want.score_oracle(queries, boosts=b),
                                   rtol=1e-6)
    assert (g[0] > 0).any() and not g[2].any()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_sharded_directories_cross_both_ways(tmp_path, writer):
    chunks = _chunks(seed=17, widths=(16, 40, 28))
    port = BM25Index.build_streaming(iter(chunks), _vocab())
    jax_index = JIndex.build_streaming(iter(chunks), _vocab())
    source, reader = ((port, JIndex) if writer == "port"
                      else (jax_index, BM25Index))
    source.save_sharded(tmp_path / "s", n_shards=3)
    back = reader.load_sharded(tmp_path / "s")
    _same_index(back, source)
    assert back.vocab == source.vocab
    q = ["t3 t17 t17 t99", "t250 t251"]
    np.testing.assert_allclose(back.score_oracle(q), port.score_oracle(q),
                               rtol=1e-6)
