"""MIX retrieval in the PyTorch port against kbner_tpu's: the pruned top-k
with global pass-2 ids (``rescore_id_offset``), ``MixEngine`` over
host-array engines (``device=False``), the per-engine ``mix_search`` and
the language-routed ``langwiki_search``, and ``cli retrieve --route mix``
end to end.

Corpora and knobs are those of tests/test_mix_engine.py, made with numpy
from a seed and fed to both packages; JAX runs on the CPU with
``use_pallas=False``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kbner_tpu import cli as jcli
from kbner_tpu.ops import bm25 as jbm25
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import DocStore as JDocStore
from kbner_tpu.retrieval import MixEngine as JMix
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval import engine as jengine
from kbner_tpu_torch import cli
from kbner_tpu_torch.data.conll import read_column_file
from kbner_tpu_torch.ops import bm25 as tbm25
from kbner_tpu_torch.retrieval.engine import (DocStore, MixEngine,
                                              RetrievalEngine,
                                              langwiki_search, mix_search)
from kbner_tpu_torch.retrieval.index import BM25Index

FIX = Path(__file__).parent / "fixtures"
KNOBS = dict(mode="pruned", rare_terms=8, posting_budget=2048,
             n_candidates=64, tiny_df_cap=16, tiny_pack=False, tiny_f16=True)
LANGS11 = "bn de en es fa hi ko nl ru tr zh".split()
REL = 1e-5  # float32 sums in another order


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mk(seed, n=300, vocab=300, doc_len=12, zipf=True):
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks) if zipf else None
    return [" ".join(f"w{w}" for w in rng.choice(vocab, size=doc_len,
                                                 p=probs))
            for _ in range(n)]


def _both(corp):
    """Per language: (port host-array engine, port engine on the CPU, JAX
    host-array engine), over the same docs and knobs."""
    out = {}
    for lang, docs in corp.items():
        idx = BM25Index.build(docs, pad_docs_to=64)
        jidx = JIndex.build(docs, pad_docs_to=64)
        out[lang] = (
            RetrievalEngine(idx, store=DocStore(sentences=list(docs)),
                            device=False, **KNOBS),
            RetrievalEngine(idx, store=DocStore(sentences=list(docs)),
                            device="cpu", **KNOBS),
            JEngine(jidx, store=JDocStore(sentences=list(docs)),
                    device=False, use_pallas=False, **KNOBS))
    return out


def _rows(results):
    return [[(lang, d.doc_id, d.sentence) for lang, d in row]
            for row in results]


def _assert_same(got, want):
    assert _rows(got) == _rows(want)
    for g, w in zip(got, want):
        assert [d.score for _, d in g] == pytest.approx(
            [d.score for _, d in w], rel=REL)


def _mix_case(name):
    if name == "m3":
        corp = {lang: _mk(seed, n=200 + 50 * seed)
                for lang, seed in (("en", 0), ("de", 2), ("tr", 3))}
        queries = [corp["en"][0], corp["de"][3], corp["tr"][5],
                   "w1 w2 w3 w250", corp["en"][11]]
        return corp, queries, 64
    if name == "m11":
        corp = {lang: _mk(seed, n=100 + 20 * seed, doc_len=10)
                for seed, lang in enumerate(LANGS11)}
        queries = [corp["bn"][0], corp["zh"][7], corp["ko"][3],
                   "w1 w5 w9 w200", corp["ru"][19]]
        return corp, queries, 32
    # the first language's docs hold up to 200 non-tiny terms (two
    # covering rows of pass 2), the last language's at most 12 (one): the
    # plain pass 2 reads r2 = 2 rows from the last language's last docs
    wide = _mk(5, n=400, vocab=200, doc_len=40, zipf=False)
    wide[-3:] = [" ".join(f"w{w}" for w in np.random.RandomState(s)
                          .permutation(200)) for s in range(3)]
    corp = {"de": wide, "ru": _mk(6, n=150), "en": _mk(7, n=130)}
    queries = [wide[-1], wide[-2][:200], corp["en"][-1], corp["en"][-2],
               corp["ru"][4], "w1 w2 w3 w199"]
    return corp, queries, 64


@pytest.mark.parametrize("case", ["m3", "m11", "last_r2_smaller"])
def test_mix_engine_matches_jax_and_the_fanout(case):
    corp, queries, n_cand = _mix_case(case)
    engines = _both(corp)
    mix = MixEngine({lang: e[0] for lang, e in engines.items()},
                    n_candidates=n_cand, device="cpu")
    jmix = JMix({lang: e[2] for lang, e in engines.items()},
                n_candidates=n_cand)
    got = mix.search_texts(queries, k=5)
    assert len(got) == len(queries) and any(got)
    _assert_same(got, jmix.search_texts(queries, k=5))
    _assert_same(got, mix_search({lang: e[1] for lang, e in
                                  engines.items()}, queries, k=5))
    # concatenation, not pad-to-max: the doc axis is the sum of the
    # languages' padded docs, and the rows the sum of theirs
    flat, off = mix._dev[:2]
    assert off.shape[0] == sum(e[0].n_padded for e in engines.values())
    r2s = [e[0]._row_meta["text"][4] for e in engines.values()]
    assert flat.shape[0] == (sum(e[0].rows["text"][0].shape[0]
                                 for e in engines.values())
                             + max(r2s) - r2s[-1])
    if case == "last_r2_smaller":
        assert r2s[0] == max(r2s) > r2s[-1]
        # the plain pass 2 over the last language's last docs, at global
        # ids and the largest r2, against the language's own rows
        last = engines["en"][0]
        n = last.text_index.n_docs
        base = int(mix._doc_base[-1])
        local = torch.arange(n - 4, n, dtype=torch.int32)[None].repeat(2, 1)
        qt = torch.arange(8, dtype=torch.int32)[None].repeat(2, 1)
        qw = torch.ones((2, 8), dtype=torch.float32)
        meta = last._row_meta["text"]
        rows = [torch.from_numpy(a) for a in last.rows["text"]]
        want = tbm25.delta16_rescore_ref(qt, qw, local, *rows, *meta[1:4],
                                         meta[4])
        got2 = tbm25.delta16_rescore_ref(qt, qw, local + base, *mix._dev[:4],
                                         *meta[1:4], max(r2s))
        assert float(want.sum()) > 0
        torch.testing.assert_close(got2, want, rtol=REL, atol=1e-6)


def test_mix_engine_stream_matches_batchwise():
    corp, queries, _ = _mix_case("m3")
    engines = _both(corp)
    mix = MixEngine({lang: e[0] for lang, e in engines.items()},
                    n_candidates=64, device="cpu")
    batches = [queries[:3], queries[3:], queries[1:4]]
    want = [mix.search_texts(b, k=5) for b in batches]
    got = list(mix.search_texts_stream(batches, k=5, workers=2, depth=1))
    assert [[(lang, d.doc_id, d.score) for lang, d in row] for b in got
            for row in b] == [[(lang, d.doc_id, d.score) for lang, d in row]
                              for b in want for row in b]


def test_pruned_topk_with_global_ids_matches_jax():
    """``rescore_id_offset``: pass 2 reads the rows of the shifted ids and
    the returned ids are shifted, while the tiny match, the ``n_real_docs``
    bound and the pass-1 keys stay local (the port's pruned top-k against
    the reference's, over two languages' concatenated rows)."""
    corp, queries, _ = _mix_case("m3")
    engines = _both(corp)
    mix = MixEngine({lang: e[0] for lang, e in engines.items()},
                    n_candidates=64, device="cpu")
    jmix = JMix({lang: e[2] for lang, e in engines.items()},
                n_candidates=64)
    rare, t_doc, t_ex, qt, qw = mix.pack_batch(queries)
    flat, off, ln, nc, csr_off, csr_pk = mix._dev
    li = 1  # the second language: a nonzero doc and vocabulary base
    avgdl, lo, step, n_real, doc_b, voc_b = mix._scalars[li]
    assert doc_b > 0 and voc_b > 0
    rank_step = float(np.float32(step) + np.float32(np.log(64.0) / 254.0))
    keys = tbm25.gather_pruned_candidate_keys(
        torch.from_numpy(np.where(rare[li] >= 0, rare[li] + voc_b, -1)),
        csr_off, csr_pk, mix.per_term_cap, reencode=True, lo_src=lo,
        step_src=step, lo_dst=lo, step_dst=rank_step, aligned=True)
    ex = t_ex[li].astype(np.float32)
    kw = dict(n_real_docs=n_real, k=5, n_candidates=64,
              max_dup_shifts=mix.rare_terms + 1, imp_lo=lo,
              imp_step=rank_step, ragged_rows=(mix._r2,),
              rescore_id_offset=doc_b)
    got = tbm25.bm25_pruned_topk_packed(
        keys, ((torch.from_numpy(qt[li]), torch.from_numpy(qw[li]), flat,
                off, ln, nc, mix._k1, mix._b, avgdl),),
        tiny_doc=torch.from_numpy(t_doc[li]).long(),
        tiny_ex=torch.from_numpy(ex), **kw)
    jflat, joff, jln, jnc = jmix._dev[:4]
    want = jbm25.bm25_pruned_topk_packed(
        np.asarray(keys.numpy(), np.uint32),
        ((qt[li], qw[li], jflat, joff, jln, jnc, mix._k1, mix._b,
          np.float32(avgdl)),),
        tiny_doc=t_doc[li], tiny_ex=ex, use_pallas=False, **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=REL)
    assert (got[1].numpy() >= doc_b).any()


def test_mix_engine_rejects_mismatched_engines():
    corp, _, _ = _mix_case("m3")
    en = BM25Index.build(corp["en"], pad_docs_to=64)
    de = BM25Index.build(corp["de"], pad_docs_to=64)
    a = RetrievalEngine(en, device=False, **KNOBS)
    b = RetrievalEngine(de, device=False, **{**KNOBS, "rare_terms": 4})
    with pytest.raises(ValueError, match="pass-1 knobs"):
        MixEngine({"en": a, "de": b}, device="cpu")
    with pytest.raises(ValueError, match="pruned mode"):
        MixEngine({"en": RetrievalEngine(en, device="cpu")}, device="cpu")
    with pytest.raises(ValueError, match="pruned mode"):
        MixEngine({"en": RetrievalEngine(en, device=False,
                                         **{**KNOBS, "compact_rows": False})},
                  device="cpu")
    c = RetrievalEngine(de, device=False, **{**KNOBS,
                                             "align_windows": False})
    with pytest.raises(ValueError, match="align_windows"):
        MixEngine({"en": a, "de": c}, device="cpu")
    with pytest.raises(ValueError, match="at least one engine"):
        MixEngine({}, device="cpu")
    # the card by default: without CUDA it raises, not falls back
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MixEngine({"en": a})


def test_device_false_engine_refuses_search():
    corp, _, _ = _mix_case("m3")
    idx = BM25Index.build(corp["en"], pad_docs_to=64)
    eng = RetrievalEngine(idx, device=False, **KNOBS)
    assert isinstance(eng.rows["text"][0], np.ndarray)
    assert isinstance(eng.csr["text"][1], np.ndarray)
    qt, qw = idx.encode_queries([corp["en"][0]])
    for call in (lambda: eng.search([corp["en"][0]], k=3),
                 lambda: eng.search_encoded(qt, qw, k=3),
                 lambda: eng.search_stream([[corp["en"][0]]], k=3),
                 lambda: eng.search_texts_stream([corp["en"][0]], k=3)):
        with pytest.raises(ValueError, match="device=False"):
            call()
    with pytest.raises(ValueError, match="unsharded pruned"):
        RetrievalEngine(idx, device=False)


def _fixture_sentences(folder, split):
    return [" ".join(r.tokens) for r in read_column_file(
        FIX / folder / f"{split}.txt", {0: "text", 1: "ner"},
        comment_symbol="# id")]


@pytest.mark.parametrize("mode", ["exhaustive", "pruned"])
def test_langwiki_search_matches_jax(mode):
    kb = {"en": _fixture_sentences("ner_toy", "train")
          + _fixture_sentences("ner_toy", "dev"),
          "de": _fixture_sentences("ner_toy_de", "train")}
    port, jax_side = {}, {}
    for lang, docs in kb.items():
        port[lang] = RetrievalEngine(
            BM25Index.build(docs, pad_docs_to=8),
            store=DocStore(sentences=docs), mode=mode, device="cpu")
        jax_side[lang] = JEngine(
            JIndex.build(docs, pad_docs_to=8),
            store=JDocStore(sentences=docs), mode=mode, use_pallas=False)
    queries = (_fixture_sentences("ner_toy", "test")
               + _fixture_sentences("ner_toy_de", "dev") + ["Berlin"])
    langs = (["en"] * len(_fixture_sentences("ner_toy", "test"))
             + ["de"] * len(_fixture_sentences("ner_toy_de", "dev"))
             + ["fr"])
    got = langwiki_search(port, queries, langs, k=3)
    want = jengine.langwiki_search(jax_side, queries, langs, k=3)
    assert got[-1] == [] and sum(map(len, got)) > len(queries)
    for g, w in zip(got, want):
        # scores in order; the documents too, but among a row's last
        # equal scores (torch.topk and lax.top_k break ties differently)
        assert [d.score for d in g] == pytest.approx(
            [d.score for d in w], rel=REL)
        last = g[-1].score if g else 0.0
        assert [(d.doc_id, d.sentence) for d in g
                if d.score > last * (1 + REL)] == \
            [(d.doc_id, d.sentence) for d in w if d.score > last * (1 + REL)]


KB_EN = [
    ("Alice Smith", "Alice Smith is a software engineer who lives in Berlin ."),
    ("Berlin", "Berlin is the capital and largest city of Germany ."),
    ("European Union",
     "The European Union is a union of member states in Europe today ."),
    ("Paris", "Paris is the capital of France ."),
    ("Acme Corp", "Acme Corp hired hundreds of engineers in New York last "
     "year for a new office ."),
    ("Bob", "Bob is a common short form of the given name Robert in "
     "English ."),
]
KB_DE = [
    ("Hans", "Hans ist ein Vorname und lebt in einem Dorf bei Berlin ."),
    ("Berlin", "Berlin ist die Hauptstadt und groesste Stadt Deutschlands "
     "mit vielen Bezirken ."),
    ("Anna", "Anna arbeitet seit vielen Jahren bei Acme in Hamburg als "
     "Ingenieurin ."),
    ("Europaeische Union", "Die Europaeische Union ist ein Verbund von "
     "Staaten ."),
    ("Paris", "Paris liegt an der Seine ."),
]


def _assert_same_retrieval_files(got: Path, want: Path) -> None:
    """Retrieval files equal byte for byte but in the score column, which
    is held at ``REL``."""
    g_lines = got.read_text(encoding="utf-8").split("\n")
    w_lines = want.read_text(encoding="utf-8").split("\n")
    assert len(g_lines) == len(w_lines)
    for g, w in zip(g_lines, w_lines):
        gp, wp = g.split("\t"), w.split("\t")
        if len(gp) >= 4 and len(gp) == len(wp):
            assert float(gp[3]) == pytest.approx(float(wp[3]), rel=REL)
            gp[3] = wp[3] = ""
        assert gp == wp


@pytest.fixture(scope="module")
def mix_kbs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mixkb")
    paths = {}
    for lang, rows in (("en", KB_EN), ("de", KB_DE)):
        paths[lang] = d / f"{lang}.jsonl"
        with open(paths[lang], "w", encoding="utf-8") as f:
            for i, (title, sentence) in enumerate(rows):
                f.write(json.dumps({
                    "title": title, "sentence": sentence,
                    "paragraph": sentence + " Mehr .",
                    "url": f"https://{lang}.example.org/{i}"}) + "\n")
    return paths


@pytest.mark.parametrize("argv", [
    ["--engine_mode", "pruned"],
    ["--engine_mode", "pruned", "--with_entity"],
])
def test_cli_retrieve_route_mix_matches_jax(mix_kbs, tmp_path, monkeypatch,
                                           argv):
    """``--route mix``: pruned sentence queries through the MixEngine,
    entity-boosted ones through the per-engine fan-out. The port's fused
    files equal the JAX CLI's byte for byte, and so do the retrieval files
    of the MixEngine route; with entities their score column is held at
    ``REL`` (the plain title pass 2 sums in another order than XLA, which
    can move a score's sixth decimal) and every other byte is equal."""
    served = []
    search = MixEngine._search
    monkeypatch.setattr(MixEngine, "_search", lambda self, packed, k: (
        served.append(packed[0].shape[1]) or search(self, packed, k)))
    common = ["retrieve", "--route", "mix", "--kb", f"en={mix_kbs['en']}",
              "--kb", f"de={mix_kbs['de']}", "--data_folder",
              str(FIX / "ner_toy"), "--k", "4", *argv]
    stats = cli.main([*common, "--out", str(tmp_path / "port"), "--device",
                      "cpu"])
    jcli.main([*common, "--out", str(tmp_path / "jax")])
    assert set(stats) == {"train", "dev", "test"}
    # one MixEngine batch per split, or none with entities
    assert served == ([] if "--with_entity" in argv else [8, 2, 2])
    n_de = 0
    for split in ("train", "dev", "test"):
        got, want = (tmp_path / "port", tmp_path / "jax")
        assert (got / f"{split}.txt").read_bytes() == \
            (want / f"{split}.txt").read_bytes()
        tsv = f"{split}.retrieval.tsv"
        if "--with_entity" in argv:
            _assert_same_retrieval_files(got / tsv, want / tsv)
        else:
            assert (got / tsv).read_bytes() == (want / tsv).read_bytes()
        n_de += (got / tsv).read_text(encoding="utf-8").count(
            "de.example.org")
    assert n_de > 0  # some context came from the second language's KB
    if "--with_entity" in argv:
        assert "<hit>" in (tmp_path / "port" / "train.retrieval.tsv"
                           ).read_text(encoding="utf-8").split(" ---#--- ")[1]


def test_cli_retrieve_route_mix_needs_a_kb(tmp_path):
    with pytest.raises(SystemExit):
        cli.main(["retrieve", "--route", "mix", "--data_folder",
                  str(FIX / "ner_toy"), "--out", str(tmp_path), "--device",
                  "cpu"])
