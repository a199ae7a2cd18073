"""The KB's offline stage in the PyTorch port against kbner_tpu's: the
analyzer's highlight and its ASCII path, the packed doc store (the same
bytes from the same records), saved KBs opened across the two packages,
the JSONL build with its store and fail file, the dump and wikitext
ingestion, and the commands that build a KB (``cli ingest-dump``, ``cli
index``). Everything here runs on the host."""

import bz2
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from kbner_tpu import cli as jcli
from kbner_tpu.retrieval import analyzer as janalyzer
from kbner_tpu.retrieval import docstore as jdocstore
from kbner_tpu.retrieval import dump as jdump
from kbner_tpu.retrieval import wikitext as jwikitext
from kbner_tpu.retrieval.engine import DocStore as JDocStore
from kbner_tpu.retrieval.engine import RetrievalEngine as JEngine
from kbner_tpu.retrieval.pipeline import build_kb_from_jsonl as j_build_kb
from kbner_tpu.retrieval.pipeline import load_kb as j_load_kb
from kbner_tpu.retrieval.pipeline import save_kb as j_save_kb
from kbner_tpu_torch import cli
from kbner_tpu_torch.retrieval import analyzer, dump, wikitext
from kbner_tpu_torch.retrieval.docstore import (PackedDocStore,
                                                PackedDocStoreWriter)
from kbner_tpu_torch.retrieval.engine import DocStore, RetrievalEngine
from kbner_tpu_torch.retrieval.pipeline import (build_kb_from_jsonl,
                                                load_kb, save_kb)

# titles and sentences of distinct analyzed lengths, so BM25 scores tie
# rarely; unicode, an empty paragraph and an empty url among them
KB_ROWS = [
    ("Alice Smith", "Alice Smith is a software engineer who lives in "
     "Berlin ."),
    ("Berlin", "Berlin is the capital and largest city of Germany ."),
    ("European Union", "The European Union is a union of member states "
     "in Europe today ."),
    ("Paris", "Paris is the capital of France ."),
    ("Acme Corp", "Acme Corp hired hundreds of engineers in New York last "
     "year for a new office ."),
    ("New York City", "New York City is the most populous city in the "
     "United States of America ."),
    ("Bob", "Bob is a common short form of the given name Robert in "
     "English ."),
    ("Germany", "Germany is a large country in Central Europe ."),
    ("Union", "A union is an organization of workers ."),
    ("Zürich", "Zürich is the largest city in Switzerland — on the lake ."),
]
QUERIES = ["Alice visited Berlin", "the capital city of France",
           "workers union in Europe", "Zürich lake city", "zzz unknown",
           "New York engineers office"]
ENTITIES = [["Alice Smith"], ["Paris"], ["Union"], ["Zürich"], [],
            ["Acme Corp", "New York City"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(i, title, sentence):
    return {"title": title, "sentence": sentence,
            "paragraph": "" if i == 3 else sentence + " More text .",
            "url": "" if i == 5 else f"https://example.org/{i}"}


@pytest.fixture(scope="module")
def kb_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("kb") / "kb.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for i, (title, sentence) in enumerate(KB_ROWS):
            f.write(json.dumps(_record(i, title, sentence),
                               ensure_ascii=False) + "\n")
    return path


# -- the analyzer -------------------------------------------------------------

ASCII_ALPHABET = list("abcXYZ019_.',;:-!\t\"() ")


@pytest.mark.parametrize("seed", range(4))
def test_ascii_path_matches_the_uax29_rules(seed):
    """ASCII text takes one regex; it gives what the character loop gives
    (forced by a trailing non-ASCII breaking character) and what
    kbner_tpu's analyzer gives."""
    rng = np.random.RandomState(seed)
    for _ in range(3000):
        text = "".join(rng.choice(ASCII_ALPHABET, rng.randint(0, 14)))
        fast = analyzer.analyze_with_offsets(text)
        assert fast == analyzer.analyze_with_offsets(text + "§")
        assert fast == janalyzer.analyze_with_offsets(text)


def test_highlight_hits_matches_jax():
    texts = [r[1] for r in KB_ROWS] + ["don't U.S.A 3.14 foo_bar", ""]
    terms = [set(analyzer.standard_analyze(q)) for q in QUERIES] + [set()]
    for text in texts:
        for t in terms:
            assert analyzer.highlight_hits(text, t) == \
                janalyzer.highlight_hits(text, t)
    assert analyzer.highlight_hits("Berlin is big", {"BERLIN"}) == \
        "<hit>Berlin</hit> is big"
    assert analyzer.get_analyzer("en") is analyzer.standard_analyze
    # zh: the char-bigram analyzer, as in the reference
    assert analyzer.get_analyzer("zh") is analyzer.cjk_analyze
    assert janalyzer.get_analyzer("zh") is janalyzer.cjk_analyze


# -- the packed doc store -----------------------------------------------------

STORE_ROWS = [
    ("first sentence", "its paragraph", "Title", "https://x/1"),
    ("", "", "", ""),                            # every field empty
    ("Zürich — 北京 😀", "ünïcödé paragraph", "Zürich", ""),
    ("tab\tand\nnewline", "p", "t", "u"),
]


def test_store_file_is_byte_identical_to_jax(tmp_path):
    PackedDocStore.build(tmp_path / "port.docs", STORE_ROWS).close()
    jdocstore.PackedDocStore.build(tmp_path / "jax.docs", STORE_ROWS).close()
    assert (tmp_path / "port.docs").read_bytes() == \
        (tmp_path / "jax.docs").read_bytes()
    # dict records and an in-memory store pack to the same bytes
    dicts = [dict(zip(("sentence", "paragraph", "title", "url"), r))
             for r in STORE_ROWS]
    PackedDocStore.build(tmp_path / "dicts.docs", dicts).close()
    store = DocStore(*map(list, zip(*STORE_ROWS)))
    PackedDocStore.from_store(tmp_path / "mem.docs", store).close()
    for name in ("dicts.docs", "mem.docs"):
        assert (tmp_path / name).read_bytes() == \
            (tmp_path / "port.docs").read_bytes()


def test_store_round_trip(tmp_path):
    with PackedDocStoreWriter(tmp_path / "s.docs") as w:
        ids = [w.add(*r) for r in STORE_ROWS]
        assert len(w) == len(STORE_ROWS)
    assert ids == list(range(len(STORE_ROWS)))
    with PackedDocStore(tmp_path / "s.docs") as port, \
            jdocstore.PackedDocStore(tmp_path / "s.docs") as jax_side:
        assert len(port) == len(jax_side) == len(STORE_ROWS)
        for i, row in enumerate(STORE_ROWS):
            doc = port.materialize(i, 1.5)
            assert (doc.sentence, doc.paragraph, doc.title, doc.url) == row
            assert doc.doc_id == i and doc.score == 1.5
            assert vars(doc) == vars(jax_side.materialize(i, 1.5))
        assert list(port.field("title")) == [r[2] for r in STORE_ROWS]
        assert port.materialize(len(STORE_ROWS), 2.0).sentence == ""
        with pytest.raises(IndexError):
            port.get(-1, "sentence")


def test_store_refuses_other_files(tmp_path):
    bad = tmp_path / "bad.docs"
    bad.write_bytes(b"NOTKB\n" + bytes(40))
    with pytest.raises(ValueError, match="not a packed doc store"):
        PackedDocStore(bad)
    empty = tmp_path / "empty.docs"
    empty.write_bytes(b"")
    with pytest.raises(ValueError):
        PackedDocStore(empty)
    # a footer naming another field count
    PackedDocStore.build(tmp_path / "ok.docs", STORE_ROWS[:1]).close()
    raw = bytearray((tmp_path / "ok.docs").read_bytes())
    raw[-16:-8] = np.asarray([5], "<u8").tobytes()
    (tmp_path / "five.docs").write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="field count"):
        PackedDocStore(tmp_path / "five.docs")


# -- building and saving a KB -------------------------------------------------

def _ids_within_ties(got, want, rtol=1e-5, atol=1e-6):
    """Same scores row by row; the same ids above each row's last score
    (a tie at the cut may be broken either way)."""
    (gs, gi), (ws, wi) = got, want
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol)
    for q in range(gs.shape[0]):
        last = min(gs[q, -1], ws[q, -1])
        # a row with fewer than k hits ends in -inf: every hit counts
        if np.isfinite(last):
            last += atol + rtol * abs(ws[q, -1])
        assert set(gi[q][gs[q] > last]) == set(wi[q][ws[q] > last]), q


def assert_same_hits(got, want, rtol=1e-5):
    """Materialized results agree: per query the same scores, and the same
    documents, whose order may differ only among equal scores."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([d.score for d in g],
                                   [d.score for d in w], rtol=rtol)

        def key(d):
            return (-round(d.score, 4), d.doc_id, d.sentence, d.paragraph,
                    d.title, d.url)

        assert sorted(map(key, g)) == sorted(map(key, w))


def _search(engine, index, title_index, k=5):
    """Text-only and entity-boosted top-k of QUERIES, as (scores, ids)."""
    qt, qw = index.encode_queries(QUERIES)
    tt, tw = title_index.encode_queries([" ".join(e) for e in ENTITIES],
                                        boosts=[2.0] * len(ENTITIES))
    return [tuple(np.asarray(x) for x in engine.search_encoded(
        qt, qw, k=k)),
        tuple(np.asarray(x) for x in engine.search_encoded(
            qt, qw, k=k, title_terms=tt, title_weights=tw))]


def test_kb_saved_by_jax_opens_in_the_port(kb_path, tmp_path):
    jt, jstore, jtitle = j_build_kb(kb_path)
    j_save_kb(tmp_path / "kb", jt, jstore, jtitle, "en")
    text, store, title, lang = load_kb(tmp_path / "kb")
    assert lang == "en" and isinstance(store, PackedDocStore)
    assert store.n_docs == len(KB_ROWS)
    port = RetrievalEngine(text, store=store, title_index=title,
                           device="cpu")
    jax_side = JEngine(jt, store=jstore, title_index=jtitle,
                       use_pallas=False)
    for got, want in zip(_search(port, text, title),
                         _search(jax_side, jt, jtitle)):
        _ids_within_ties(got, want)
    assert_same_hits(port.search(QUERIES, k=5, entity_queries=ENTITIES),
                     jax_side.search(QUERIES, k=5, entity_queries=ENTITIES))
    store.close()


def test_kb_saved_by_the_port_opens_in_jax(kb_path, tmp_path):
    text, store, title = build_kb_from_jsonl(kb_path)
    save_kb(tmp_path / "kb", text, store, title)
    jt, jstore, jtitle, lang = j_load_kb(tmp_path / "kb")
    assert lang == "en"
    port = RetrievalEngine(text, store=store, title_index=title,
                           device="cpu")
    jax_side = JEngine(jt, store=jstore, title_index=jtitle,
                       use_pallas=False)
    for got, want in zip(_search(port, text, title),
                         _search(jax_side, jt, jtitle)):
        _ids_within_ties(got, want)
    # the same arrays either way
    for a, b in ((text, jt), (title, jtitle)):
        assert a.vocab == b.vocab and a.n_docs == b.n_docs
        np.testing.assert_array_equal(a.doc_terms, b.doc_terms)
        np.testing.assert_array_equal(a.doc_impacts, b.doc_impacts)
        np.testing.assert_array_equal(a.doc_dl, b.doc_dl)
    jstore.close()


def test_cli_index_opens_in_jax(kb_path, tmp_path):
    bad = tmp_path / "with_bad.jsonl"
    bad.write_text(kb_path.read_text(encoding="utf-8") + "{not json\n[1]\n",
                   encoding="utf-8")
    cli.main(["index", "--kb", str(bad), "--out", str(tmp_path / "port"),
              "--kb_fail_file", str(tmp_path / "port.fail")])
    jcli.main(["index", "--kb", str(bad), "--out", str(tmp_path / "jax"),
               "--kb_fail_file", str(tmp_path / "jax.fail")])
    for name in ("kb.docs", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    assert (tmp_path / "port.fail").read_text() == \
        (tmp_path / "jax.fail").read_text() == "{not json\n[1]\n"
    jt, jstore, jtitle, _ = j_load_kb(tmp_path / "port")
    text, store, title, _ = load_kb(tmp_path / "jax")
    port = RetrievalEngine(text, store=store, title_index=title,
                           device="cpu")
    jax_side = JEngine(jt, store=jstore, title_index=jtitle,
                       use_pallas=False)
    for got, want in zip(_search(port, text, title),
                         _search(jax_side, jt, jtitle)):
        _ids_within_ties(got, want)
    store.close()
    jstore.close()


def test_build_with_store_and_fail_file_matches_jax(kb_path, tmp_path):
    lines = kb_path.read_text(encoding="utf-8").splitlines()
    src = tmp_path / "kb.jsonl"
    src.write_text("\n".join(lines[:3] + ["{broken", "", "7"] + lines[3:])
                   + "\n", encoding="utf-8")
    text, store, title = build_kb_from_jsonl(
        src, store_path=tmp_path / "p.docs", fail_path=tmp_path / "p.fail")
    jt, jstore, jtitle = j_build_kb(
        src, store_path=tmp_path / "j.docs", fail_path=tmp_path / "j.fail")
    assert (tmp_path / "p.fail").read_text() == \
        (tmp_path / "j.fail").read_text() == "{broken\n7\n"
    assert (tmp_path / "p.docs").read_bytes() == \
        (tmp_path / "j.docs").read_bytes()
    assert isinstance(store, PackedDocStore) and store.n_docs == len(KB_ROWS)
    np.testing.assert_array_equal(text.doc_impacts, jt.doc_impacts)
    np.testing.assert_array_equal(title.doc_terms, jtitle.doc_terms)
    # max_docs, the in-memory store, and a malformed line without a fail
    # file
    t2, s2, _ = build_kb_from_jsonl(kb_path, max_docs=4,
                                    with_title_index=False)
    assert t2.n_docs == 4 and isinstance(s2, DocStore)
    with pytest.raises(ValueError):
        build_kb_from_jsonl(src)
    store.close()
    jstore.close()


def test_zh_and_ik_raise_naming_their_roadmap_item(kb_path, tmp_path):
    """zh KBs build, with or without an IK dictionary, and reopen with
    their analyzer."""
    text, _, title = build_kb_from_jsonl(kb_path, lang="zh")
    assert text.analyzer is analyzer.cjk_analyze
    assert title.analyzer is analyzer.cjk_analyze
    cli.main(["index", "--kb", str(kb_path), "--out", str(tmp_path / "x"),
              "--lang", "zh", "--ik_dict", "builtin"])
    assert (tmp_path / "x" / "ik.dic").read_bytes() == \
        analyzer.builtin_zh_lexicon().read_bytes()
    text_x, store_x, _, lang = load_kb(tmp_path / "x")
    assert lang == "zh" and isinstance(text_x.analyzer, analyzer.IkAnalyzer)
    store_x.close()
    text, store, title = build_kb_from_jsonl(kb_path)
    save_kb(tmp_path / "kb", text, store, title)
    (tmp_path / "kb" / "meta.json").write_text(json.dumps({"lang": "zh"}))
    assert load_kb(tmp_path / "kb")[0].analyzer is analyzer.cjk_analyze


# -- dump ingestion -----------------------------------------------------------

MW = "http://www.mediawiki.org/xml/export-0.10/"


def _page(title, text, ns=0, redirect=None):
    red = f'<redirect title="{redirect}" />' if redirect else ""
    return (f"<page><title>{title}</title><ns>{ns}</ns>{red}<id>1</id>"
            f"<revision><id>2</id><text xml:space=\"preserve\">{text}"
            f"</text></revision></page>")


# the dump of tests/test_dump_ingest.py
ARTICLE = """{{Infobox album
| name = Anthology
| type = [[Compilation album|compilation]]
}}
'''''Anthology''''' is a [[compilation album]] by [[Bic Runga]].&lt;ref name="a"&gt;cite&lt;/ref&gt;

== Background ==
It was released in [[New Zealand]].&lt;ref&gt;another cite&lt;/ref&gt; See [http://example.com/x the site] for details.
[[File:Cover.jpg|thumb|Album cover with [[Bic Runga|Runga]]]]
* [[Track listing|Tracks]] are short.
{| class="wikitable"
|-
| ignored || table
|}
[[Category:2012 albums]]
[[fr:Anthologie]]
"""
PAGES = [
    _page("Anthology (Bic Runga album)", ARTICLE),
    _page("Compilation album", "A '''compilation album''' collects tracks "
          "from many records. It is common in pop music."),
    _page("Bic Runga", "Briolette Kah Bic Runga is a New Zealand singer. "
          "She records in English."),
    _page("Comp album", "#REDIRECT [[Compilation album]]",
          redirect="Compilation album"),
    _page("Talk:Ignored", "talk page text here", ns=1),
    _page("Zürich", "'''Zürich''' is a city in [[Switzerland]]. It sits on "
          "[[Lake Zürich|the lake]]. Es ist groß."),
]


@pytest.fixture(scope="module")
def dump_file(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dump")
    xml = (f'<mediawiki xmlns="{MW}" xml:lang="en">' + "".join(PAGES)
           + "</mediawiki>").encode("utf-8")
    (tmp / "mini.xml").write_bytes(xml)
    (tmp / "mini.xml.bz2").write_bytes(bz2.compress(xml))
    return tmp / "mini.xml", tmp / "mini.xml.bz2"


@pytest.mark.parametrize("argv", [
    [], ["--paragraph", "first"], ["--max_pages", "3"],
    ["--lang", "de", "--paragraph", "first", "--max_pages", "5"]])
@pytest.mark.parametrize("compressed", [False, True])
def test_cli_ingest_dump_writes_jax_bytes(dump_file, tmp_path, argv,
                                          compressed):
    src = str(dump_file[compressed])
    cli.main(["ingest-dump", "--dump", src, "--out",
              str(tmp_path / "port.jsonl"), *argv])
    jcli.main(["ingest-dump", "--dump", src, "--out",
               str(tmp_path / "jax.jsonl"), *argv])
    got = (tmp_path / "port.jsonl").read_bytes()
    assert got == (tmp_path / "jax.jsonl").read_bytes()
    assert got  # the dump gave records


def test_dump_helpers_match_jax(dump_file):
    xml, packed = dump_file
    got = [vars(p) for p in dump.iter_dump_pages(packed)]
    assert got == [vars(p) for p in jdump.iter_dump_pages(xml)]
    assert dump.build_redirects(xml) == jdump.build_redirects(xml)
    redirects = {"A": "B", "B": "C", "C": "A", "D": "E"}
    for t in ("A", "D", "X"):
        assert dump.resolve_redirect(t, redirects) == \
            jdump.resolve_redirect(t, redirects)
    for page in got:
        assert dump.wikitext_to_paragraphs(page["text"]) == \
            jdump.wikitext_to_paragraphs(page["text"])
    for t in ("compilation_album#Section", "  x y ", ""):
        assert dump.normalize_title(t) == jdump.normalize_title(t)


def test_wikitext_helpers_match_jax(tmp_path):
    para = "Alice met Bob in Paris. Then she left! Did he? 北京很大。好的"
    anchors = [("Alice Smith", 0, 5), ("Paris", 17, 22), ("Bad", 50, 99)]
    assert wikitext.insert_anchors(para, anchors) == \
        jwikitext.insert_anchors(para, anchors)
    for lang in ("en", "zh", "de"):
        assert wikitext.split_sentences(para, lang) == \
            jwikitext.split_sentences(para, lang)
    marked = wikitext.insert_anchors(para, anchors)
    assert wikitext.strip_anchors(marked) == jwikitext.strip_anchors(marked)
    recs = [{"title": "T", "paragraph": para, "url": "u",
             "anchors": anchors}, {"title": "T", "paragraph": para},
            {"title": "U", "paragraph": "Second one. Two."}]
    n = wikitext.paragraphs_to_jsonl(recs, tmp_path / "p.jsonl")
    assert n == jwikitext.paragraphs_to_jsonl(recs, tmp_path / "j.jsonl")
    assert (tmp_path / "p.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()
