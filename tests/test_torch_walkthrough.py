"""``examples/end_to_end_torch.py``, the port's walkthrough, on the CPU:
its steps 1-3 (KB JSONL, the text and title indices, retrieval and
``sentence_link`` fusion at k=3) against the same steps of
``examples/end_to_end.py`` run here with kbner_tpu's functions (the
exhaustive engine with ``use_pallas=False``, as that example builds it):
the KB's sentence count, the retrieved ids and scores (rtol 1e-5, atol
1e-6, K1's bar) and the fused train records token for token; then all
six steps through its ``main``. Fusion keeps retrieval's rank order, so
equal scores must rank as ``lax.top_k`` ranks them (lower id first):
``ops.bm25.bm25_topk`` is held to the reference's on tied scores, in one
pass and chunked."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data import HashTokenizer as JTokenizer
from kbner_tpu.ops.bm25 import bm25_topk as j_topk
from kbner_tpu.data import load_column_corpus as j_load
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval.fusion import fuse_contexts as j_fuse
from kbner_tpu.retrieval.pipeline import build_kb_from_jsonl as j_build
from kbner_tpu.retrieval.pipeline import retrieve_for_records as j_retrieve
from kbner_tpu.retrieval.wikitext import paragraphs_to_jsonl as j_jsonl

from kbner_tpu_torch.ops.bm25 import bm25_topk

REPO = Path(__file__).resolve().parents[1]


def _example():
    spec = importlib.util.spec_from_file_location(
        "end_to_end_torch", REPO / "examples" / "end_to_end_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within_ties(docs):
    """The ranked ids with each run of equal scores as a set."""
    runs = {}
    for d in docs:
        runs.setdefault(round(d.score, 5), set()).add(d.doc_id)
    return sorted(runs.items(), reverse=True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_steps_1_to_3_match_the_reference(tmp_path):
    ex = _example()
    got = ex.kb_and_fused(tmp_path / "port", device="cpu")

    (tmp_path / "jax").mkdir()
    n = j_jsonl(ex.WIKI, tmp_path / "jax" / "kb.jsonl", lang="en")
    text_index, store, title_index = j_build(tmp_path / "jax" / "kb.jsonl")
    engine = JEngine(text_index, store=store, title_index=title_index,
                     use_pallas=False)
    corpus = j_load(REPO / "tests/fixtures/ner_toy", {0: "text", 1: "ner"},
                    comment_symbol="# id")
    results = j_retrieve(engine, corpus.train, k=3)
    fused = j_fuse(corpus.train, results, JTokenizer(vocab_size=997),
                   mode="sentence_link")

    assert got["n_sentences"] == n == 6
    assert len(got["results"]) == len(results) == len(fused)
    for g, w in zip(got["results"], results):
        np.testing.assert_allclose([d.score for d in g],
                                   [d.score for d in w], rtol=1e-5,
                                   atol=1e-6)
        assert _within_ties(g) == _within_ties(w)
    assert [r.tokens for r in got["corpus"].train] == \
        [r.tokens for r in fused]
    assert [r.tags for r in got["corpus"].train] == [r.tags for r in fused]
    assert any("<EOS>" in r.tokens for r in fused)


def test_main_runs_all_six_steps_on_the_cpu(tmp_path):
    out = _example().main(device="cpu", work_dir=tmp_path)
    assert out["work"] == tmp_path
    assert (tmp_path / "ner.html").read_text().count("<p>") == 3
    assert (tmp_path / "run" / "best-model.msgpack").exists()
    assert len(out["fused"]) == len(out["results"])
    assert len(out["v4"]) == 2 and all(r.tokens for r in out["v4"])
    assert 0.0 <= out["f1"] <= 1.0


@pytest.mark.parametrize("doc_chunk", [None, 512])
def test_bm25_topk_ranks_ties_as_lax_top_k(doc_chunk):
    """Scores from a few distinct impacts over 2,048 docs, so every query
    meets long runs of equal scores; k ends where the scores drop, so the
    kept set is the same and only the order among equals can differ."""
    rng = np.random.RandomState(3)
    Q, Lq, Ld, N = 6, 4, 3, 2048
    qt = np.stack([rng.permutation(8)[:Lq] for _ in range(Q)]).astype(
        np.int32)
    qw = np.ones((Q, Lq), np.float32)
    dt = rng.randint(0, 8, (Ld, N)).astype(np.int32)
    di = rng.choice([0.5, 1.0], (Ld, N)).astype(np.float32)
    ws, wi = (np.asarray(a) for a in j_topk(
        [tuple(jnp.asarray(a) for a in (qt, qw, dt, di))], k=N,
        doc_chunk=doc_chunk, use_pallas=False))
    for q in range(Q):
        top = ws[q, 0]
        k = int((ws[q] == top).sum()) + int((ws[q] == ws[q][ws[q] < top][0])
                                            .sum())
        gs, gi = bm25_topk([tuple(torch.from_numpy(a)
                                  for a in (qt[q:q + 1], qw[q:q + 1], dt,
                                            di))], k=k, doc_chunk=doc_chunk)
        assert k > 10
        np.testing.assert_array_equal(gs[0].numpy(), ws[q, :k])
        np.testing.assert_array_equal(gi[0].numpy(), wi[q, :k])
