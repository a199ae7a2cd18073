"""The port's zh analyzers against kbner_tpu's on the same strings
(``cjk_analyze``, ``IkAnalyzer`` in ik_max_word and ik_smart modes,
``get_analyzer``; the checks of tests/test_zh_ik_coverage.py), and a zh KB
through ``cli index`` and ``cli retrieve`` in both packages: the saved
index arrays equal, the retrieval files equal within near-ties.
"""

import json
import pickle

import numpy as np
import pytest
import torch

from kbner_tpu import cli as jcli
from kbner_tpu.retrieval import analyzer as janalyzer
from kbner_tpu_torch import cli
from kbner_tpu_torch.data.conll import SentenceRecord, write_column_file
from kbner_tpu_torch.retrieval import analyzer
from kbner_tpu_torch.retrieval.engine import RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index
from kbner_tpu_torch.retrieval.pipeline import load_kb

from test_zh_ik_coverage import DICT, DOCS, max_match_segment

MIXED = [
    "北京大学的学生使用互联网研究人工智能技术",
    "Google 和百度的工程师在上海开会",
    "ACL 2022 在北京大学举行",
    "北京 大学",  # a space splits a Han run
    "中国人民银行，科学技术；发展。",
    "研究生的生活在北京，U.S.A 的 don't",
    "日本語のテキスト カタカナ",
    "\U00020000\U00020001 中文",
    "",
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zh_sentences(n, seed, n_words=(4, 11)):
    """Seeded zh sentences of builtin-lexicon words, some with a Latin
    word or a digit run among them."""
    rng = np.random.RandomState(seed)
    words = [w.strip() for w in analyzer.builtin_zh_lexicon().read_text(
        encoding="utf-8").splitlines() if w.strip()
        and not w.startswith("#")]
    latin = ["Google", "ACL", "2022", "U.S.A", "wiki"]
    out = []
    for _ in range(n):
        k = rng.randint(*n_words)
        toks = [words[i] for i in rng.randint(0, len(words), k)]
        if rng.rand() < 0.3:
            toks.insert(rng.randint(0, k), latin[rng.randint(len(latin))])
        out.append(toks)
    return out


def test_cjk_analyze_matches_jax():
    for text in MIXED + DOCS + ["".join(s) for s in zh_sentences(50, 1)]:
        assert analyzer.cjk_analyze(text) == janalyzer.cjk_analyze(text)
    toks = analyzer.cjk_analyze("北京大学")
    assert toks == ["北", "京", "北京", "大", "京大", "学", "大学"]


@pytest.mark.parametrize("smart", [False, True])
def test_ik_analyzer_matches_jax(tmp_path, smart):
    dict_path = tmp_path / "main.dic"
    dict_path.write_text("\n".join(["# toy ik dictionary"] + DICT),
                         encoding="utf-8")
    texts = MIXED + DOCS + ["".join(s) for s in zh_sentences(50, 2)]
    for path in (dict_path, "builtin"):
        ik = analyzer.get_analyzer("zh", dict_path=path, smart=smart)
        jik = janalyzer.get_analyzer("zh", dict_path=path, smart=smart)
        assert isinstance(ik, analyzer.IkAnalyzer) and ik.smart == smart
        assert ik.words == jik.words and ik.max_len == jik.max_len
        for text in texts:
            assert ik(text) == jik(text), text
    if smart:  # ik_smart is forward maximum matching
        ik = analyzer.IkAnalyzer(DICT, smart=True)
        for doc in DOCS:
            assert ik(doc) == max_match_segment(doc, DICT)
    else:  # ik_max_word: the compound and its parts, no covered unigram
        toks = analyzer.IkAnalyzer(DICT)("北京大学的学生")
        assert {"北京大学", "北京", "大学", "学生", "的"} <= set(toks)
        assert "北" not in toks


def test_get_analyzer_and_the_builtin_lexicon():
    assert analyzer.get_analyzer("zh") is analyzer.cjk_analyze
    assert analyzer.get_analyzer("en") is analyzer.standard_analyze
    assert analyzer.get_analyzer("de", dict_path="builtin") is \
        analyzer.standard_analyze
    assert analyzer.builtin_zh_lexicon().read_bytes() == \
        janalyzer.builtin_zh_lexicon().read_bytes()
    assert len(analyzer.get_analyzer("zh", dict_path="builtin").words) \
        >= 3000


def test_zh_index_queries_use_the_index_analyzer():
    """Queries are analyzed as the documents were: a bigram index encodes
    a batch of more than 16 queries (the native cjk mode) as it encodes
    each alone (the Python analyzer), and as kbner_tpu's index does."""
    from kbner_tpu.retrieval import BM25Index as JIndex

    docs = ["".join(s) for s in zh_sentences(300, 3)]
    t = BM25Index.build(docs, analyzer=analyzer.cjk_analyze, pad_docs_to=64)
    j = JIndex.build(docs, analyzer=janalyzer.cjk_analyze, pad_docs_to=64)
    assert t.vocab == j.vocab
    np.testing.assert_array_equal(t.doc_impacts, j.doc_impacts)
    queries = docs[:40]
    batch = t.encode_queries(queries)
    one = [t.encode_queries([q]) for q in queries]
    np.testing.assert_array_equal(batch[0], np.concatenate(
        [o[0] for o in one]))
    for a, b in zip(batch, j.encode_queries(queries)):
        np.testing.assert_array_equal(a, b)
    hits = RetrievalEngine(t, device="cpu").search(queries[:5], k=1)
    assert [h[0].doc_id for h in hits] == list(range(5))


def _blocks(path):
    """A retrieval file as (query, [(score, line with the score blanked)])
    blocks."""
    out = []
    for block in path.read_text(encoding="utf-8").split("\n\n"):
        if block.strip():
            query, *lines = block.split("\n")
            rows = []
            for line in lines:
                parts = line.split("\t")
                score = float(parts[3])
                parts[3] = ""
                rows.append((score, "\t".join(parts)))
            out.append((query, rows))
    return out


def assert_same_within_ties(got, want, k=10, rtol=1e-5):
    """Retrieval files with equal queries and, rank by rank, scores within
    ``rtol``; contexts equal but for order among scores within ``rtol`` of
    each other (float32 sums in another order can swap near-ties), and
    but for the docs of the last such run of a list cut at ``k``. Returns
    the number of contexts."""
    g, w = _blocks(got), _blocks(want)
    assert [q for q, _ in g] == [q for q, _ in w]
    n = 0
    for (_, gr), (_, wr) in zip(g, w):
        assert len(gr) == len(wr)
        np.testing.assert_allclose([x for x, _ in gr], [x for x, _ in wr],
                                   rtol=rtol)
        start = 0
        for i in range(1, len(wr) + 1):  # runs of near-equal scores
            if i == len(wr) or not np.isclose(wr[i][0], wr[i - 1][0],
                                              rtol=rtol, atol=0):
                if i < len(wr) or len(wr) < k:
                    assert sorted(x for _, x in gr[start:i]) == \
                        sorted(x for _, x in wr[start:i])
                start = i
        n += len(gr)
    return n


@pytest.fixture(scope="module")
def zh_kb(tmp_path_factory):
    """A 300-doc zh KB as parsed-wiki JSONL and a CoNLL folder of zh
    sentences (words as tokens, the first tagged B-PER)."""
    root = tmp_path_factory.mktemp("zh")
    sents = zh_sentences(300, 4)
    with open(root / "kb.jsonl", "w", encoding="utf-8") as f:
        for i, toks in enumerate(sents):
            text = "".join(toks)
            f.write(json.dumps({"title": toks[0], "sentence": text,
                                "paragraph": text,
                                "url": f"https://zh.wikipedia.org/{i}"},
                               ensure_ascii=False) + "\n")
    rng = np.random.RandomState(5)
    for split, n in (("train", 40), ("dev", 12), ("test", 12)):
        recs = []
        for i in range(n):
            toks = list(sents[rng.randint(len(sents))])
            rng.shuffle(toks)
            recs.append(SentenceRecord(
                tokens=toks[:6], tags={"ner": ["B-PER"] + ["O"] * (
                    len(toks[:6]) - 1)}, comment=f"# id {split}-{i}"))
        write_column_file(root / "conll" / f"{split}.txt", recs)
    return root


@pytest.mark.parametrize("ik", [["--ik_dict", "builtin"], []])
def test_cli_index_and_retrieve_zh_match_jax(zh_kb, tmp_path, ik):
    """``cli index --lang zh`` (IK over the builtin lexicon, or bigrams)
    writes the text and title indices kbner_tpu writes, and ``cli
    retrieve --lang zh`` over them writes the same retrieval and fused
    files, exhaustive and pruned."""
    for c, name in ((cli, "port"), (jcli, "jax")):
        c.main(["index", "--kb", str(zh_kb / "kb.jsonl"), "--out",
                str(tmp_path / name), "--lang", "zh", *ik])
    for field in ("text.idx", "title.idx"):
        got, want = (pickle.loads((tmp_path / n / field).read_bytes())
                     for n in ("port", "jax"))
        assert got["vocab"] == want["vocab"]
        for key in ("idf", "doc_terms", "doc_impacts", "doc_dl"):
            np.testing.assert_array_equal(got[key], want[key])
    assert (tmp_path / "port" / "kb.docs").read_bytes() == \
        (tmp_path / "jax" / "kb.docs").read_bytes()
    assert json.loads((tmp_path / "port" / "meta.json").read_text()) == \
        json.loads((tmp_path / "jax" / "meta.json").read_text())
    text_index = load_kb(tmp_path / "port")[0]
    assert isinstance(text_index.analyzer, analyzer.IkAnalyzer) == bool(ik)

    for mode in ("exhaustive", "pruned"):
        common = ["--data_folder", str(zh_kb / "conll"), "--lang", "zh",
                  "--engine_mode", mode]
        cli.main(["retrieve", "--index_dir", str(tmp_path / "port"),
                  *common, "--out", str(tmp_path / f"p-{mode}"),
                  "--device", "cpu"])
        jcli.main(["retrieve", "--index_dir", str(tmp_path / "jax"),
                   *common, "--out", str(tmp_path / f"j-{mode}")])
        n = 0
        for split in ("train", "dev", "test"):
            n += assert_same_within_ties(
                tmp_path / f"p-{mode}" / f"{split}.retrieval.tsv",
                tmp_path / f"j-{mode}" / f"{split}.retrieval.tsv")
            fused = [(tmp_path / f"{p}-{mode}" / f"{split}.txt").read_text(
                encoding="utf-8").split("\n\n") for p in "pj"]
            assert len(fused[0]) == len(fused[1])
            for a, b in zip(*fused):  # the sentence itself comes first
                assert a.split("<EOS>")[0] == b.split("<EOS>")[0]
        assert n > 100
        assert "<hit>" in (tmp_path / f"p-{mode}" /
                           "dev.retrieval.tsv").read_text(encoding="utf-8")
