"""The PyTorch port's data and evaluation modules against kbner_tpu's:
column files, tag schemes, seeded batching, corpus surgery, the quality
corpus, and the span and conlleval metrics. All host code, compared for
equality (metrics exactly: they are ratios of the same counts)."""

import dataclasses

import numpy as np
import pytest

from kbner_tpu.data import conll as jconll
from kbner_tpu.data import corpus_ops as jops
from kbner_tpu.data import encode as jencode
from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu.data import tag_schemes as jschemes
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.eval import conlleval as jconlleval
from kbner_tpu.eval import metrics as jmetrics
from kbner_tpu_torch.data import conll, corpus_ops, encode, quality_fixture
from kbner_tpu_torch.data import tag_schemes
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.eval import conlleval, metrics

FMT = {0: "text", 1: "ner"}


def _records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.tokens, g.tags, g.doc_id, g.lang_id, g.comment) == \
            (w.tokens, w.tags, w.doc_id, w.lang_id, w.comment)


@pytest.mark.parametrize("folder,kw", [
    ("ner_toy", dict(comment_symbol="# id", tag_to_bioes="ner")),
    ("ner_toy", dict(comment_symbol=None, tag_to_bioes=None)),
    ("ner_ctx", dict(comment_symbol="# id", tag_to_bioes="ner")),
    ("ner_toy_de", dict(comment_symbol="# id", tag_to_bioes="ner",
                        max_sentences=2)),
])
def test_read_column_file_matches_jax(fixtures_path, folder, kw):
    path = fixtures_path / folder / "train.txt"
    _records_equal(conll.read_column_file(path, FMT, **kw),
                   jconll.read_column_file(path, FMT, **kw))


def test_column_file_with_docstart_and_missing_columns(tmp_path):
    text = ("-DOCSTART- O\n\nA B-PER\nb\n\n-DOCSTART- O\n\nC I-LOC\nD "
            "I-LOC\n\n")
    p = tmp_path / "f.txt"
    p.write_text(text)
    got = conll.read_column_file(p, {0: "text", 1: "ner", 2: "pos"},
                                 tag_to_bioes="ner")
    want = jconll.read_column_file(p, {0: "text", 1: "ner", 2: "pos"},
                                   tag_to_bioes="ner")
    _records_equal(got, want)
    assert [r.doc_id for r in got] == [1, 2]
    assert got[1].tags["ner"] == ["B-LOC", "E-LOC"]


def test_write_column_file_matches_jax(fixtures_path, tmp_path):
    recs = conll.read_column_file(fixtures_path / "ner_toy" / "train.txt",
                                  FMT, comment_symbol="# id")
    jrecs = jconll.read_column_file(fixtures_path / "ner_toy" / "train.txt",
                                    FMT, comment_symbol="# id")
    for r, jr in zip(recs, jrecs):
        r.tags["pred"] = jr.tags["pred"] = list(reversed(r.tags["ner"]))
    conll.write_column_file(tmp_path / "a" / "out.conllu", recs,
                            layers=("ner", "pred", "absent"))
    jconll.write_column_file(tmp_path / "b" / "out.conllu", jrecs,
                             layers=("ner", "pred", "absent"))
    assert (tmp_path / "a" / "out.conllu").read_text() == \
        (tmp_path / "b" / "out.conllu").read_text()


def test_corpora_and_tag_dictionaries_match_jax(fixtures_path):
    kw = dict(comment_symbol="# id")
    toy, de = fixtures_path / "ner_toy", fixtures_path / "ner_toy_de"
    corpus = conll.ListCorpus([conll.load_column_corpus(toy, FMT, **kw),
                               conll.load_column_corpus(de, FMT, **kw)])
    jcorpus = jconll.ListCorpus([jconll.load_column_corpus(toy, FMT, **kw),
                                 jconll.load_column_corpus(de, FMT, **kw)])
    assert corpus.targets == jcorpus.targets == ["ner_toy", "ner_toy_de"]
    _records_equal(corpus.train, jcorpus.train)
    for a, b in zip(corpus.dev_list + corpus.test_list,
                    jcorpus.dev_list + jcorpus.test_list):
        _records_equal(a, b)
    assert corpus.make_tag_dictionary("ner").idx2item == \
        jcorpus.make_tag_dictionary("ner").idx2item
    one = corpus.corpora[0]
    assert one.make_tag_dictionary("ner").idx2item == \
        jcorpus.corpora[0].make_tag_dictionary("ner").idx2item
    small, jsmall = one.downsample(0.5), jcorpus.corpora[0].downsample(0.5)
    _records_equal(small.train, jsmall.train)
    assert small.name == jsmall.name


def _random_tags(rng, n, labels=("PER", "LOC", "ORG", "X")):
    prefixes = ("B", "I", "E", "S")
    return [("O" if rng.rand() < 0.35 else
             f"{prefixes[rng.randint(4)]}-{labels[rng.randint(len(labels))]}")
            for _ in range(n)]


def _random_iob(rng, n):
    return [("O" if rng.rand() < 0.4 else
             f"{'BI'[rng.randint(2)]}-{('PER', 'LOC')[rng.randint(2)]}")
            for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_tag_schemes_match_jax(seed):
    rng = np.random.RandomState(seed)
    for n in (1, 2, 5, 17):
        iob = _random_iob(rng, n)
        assert tag_schemes.iob2(iob) == jschemes.iob2(iob)
        iob2 = jschemes.iob2(iob)
        assert tag_schemes.iob_iobes(iob2) == jschemes.iob_iobes(iob2)
        assert tag_schemes.to_bioes(iob) == jschemes.to_bioes(iob)
        tags = _random_tags(rng, n)
        assert tag_schemes.bioes_to_bio(tags) == jschemes.bioes_to_bio(tags)
        got = tag_schemes.get_spans(tags, ignore_labels=("X",))
        want = jschemes.get_spans(tags, ignore_labels=("X",))
        assert [dataclasses.astuple(s) + (s.positions,) for s in got] == \
            [dataclasses.astuple(s) + (s.positions,) for s in want]
    assert tag_schemes.iob2(["E-PER"]) is jschemes.iob2(["E-PER"]) is None
    with pytest.raises(ValueError):
        tag_schemes.to_bioes(["X-PER"])


def _corpus_pair(seed=0, n=40):
    return (quality_fixture.make_quality_corpus(n, 8, 8, seed=seed),
            jquality.make_quality_corpus(n, 8, 8, seed=seed))


def test_quality_corpus_matches_jax():
    for seed in (0, 3):
        a, b = _corpus_pair(seed, 240)
        _records_equal(a.train, b.train)
        _records_equal(a.test_list[0], b.test_list[0])


@pytest.mark.parametrize("kw", [
    dict(batch_size=4),
    dict(batch_size=4, shuffle=True, seed=3),
    dict(batch_size=5, shuffle=True, seed=0, sort_by_length=False),
    dict(batch_size=8, token_budget=40),
    dict(batch_size=8, token_budget=40, shuffle=True, seed=2),
    dict(batch_size=3, n_buckets=3, shuffle=True, seed=1),
    dict(batch_size=4, n_buckets=2, token_budget=30),
    dict(batch_size=4, max_subtokens=12, shuffle=True, seed=5),
])
def test_make_batches_match_jax(kw):
    """Seeded batch order and every array, gold tags included."""
    corpus, jcorpus = _corpus_pair(1)
    tok, jtok = HashTokenizer(997), JTokenizer(997)
    tags = corpus.make_tag_dictionary("ner")
    jtags = jcorpus.make_tag_dictionary("ner")
    got = encode.make_batches(corpus.train, tok, tags, **kw)
    want = jencode.make_batches(jcorpus.train, jtok, jtags, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [r.tokens for r in g.records] == [r.tokens for r in w.records]
        ga, wa = g.arrays(), w.arrays()
        assert ga.keys() == wa.keys()
        for key in ga:
            np.testing.assert_array_equal(ga[key], wa[key], err_msg=key)


def test_encode_context_tags_and_kmeans_match_jax(fixtures_path):
    path = fixtures_path / "ner_ctx" / "train.txt"
    kw = dict(comment_symbol="# id", tag_to_bioes="ner")
    recs = conll.read_column_file(path, FMT, **kw)
    jrecs = jconll.read_column_file(path, FMT, **kw)
    # a tag dictionary without S-X: context tags encode as 0
    tags = conll.Corpus(recs[:1], [], []).make_tag_dictionary("ner")
    jtags = jconll.Corpus(jrecs[:1], [], []).make_tag_dictionary("ner")
    with pytest.raises(KeyError):
        encode.encode_batch(recs, HashTokenizer(997), tags)
    for r in recs + jrecs:
        r.tags["ner"] = [t if "X" in t or t == "O" else "O"
                         for t in r.tags["ner"]]
    got = encode.encode_batch(recs, HashTokenizer(997), tags).arrays()
    want = jencode.encode_batch(jrecs, JTokenizer(997), jtags).arrays()
    for key in got:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    lengths = np.random.RandomState(0).randint(3, 60, size=200)
    assert encode.kmeans(lengths, 5, seed=2) == jencode.kmeans(lengths, 5,
                                                               seed=2)


def test_corpus_ops_match_jax(fixtures_path):
    kw = dict(comment_symbol="# id")
    folders = (fixtures_path / "ner_toy", fixtures_path / "ner_toy_de")

    def pair():
        return (conll.ListCorpus([conll.load_column_corpus(f, FMT, **kw)
                                  for f in folders]),
                jconll.ListCorpus([jconll.load_column_corpus(f, FMT, **kw)
                                   for f in folders]))

    a, b = pair()
    assert corpus_ops.resample_language_sizes([10, 1000, 37]) == \
        jops.resample_language_sizes([10, 1000, 37])
    _records_equal(corpus_ops.resample_corpora(a, 0.7, seed=4),
                   jops.resample_corpora(b, 0.7, seed=4))
    corpus_ops.direct_upsample(a, 3, max_size=5)
    jops.direct_upsample(b, 3, max_size=5)
    _records_equal(a.train, b.train)
    corpus_ops.down_sample(a, 4, seed=1)
    jops.down_sample(b, 4, seed=1)
    _records_equal(a.train, b.train)
    a, b = pair()
    assert corpus_ops.clip_sentences(a, HashTokenizer(997), 9) == \
        jops.clip_sentences(b, JTokenizer(997), 9)
    _records_equal(a.train, b.train)
    ctx = conll.read_column_file(fixtures_path / "ner_ctx" / "train.txt",
                                 FMT, **kw)
    jctx = jconll.read_column_file(fixtures_path / "ner_ctx" / "train.txt",
                                   FMT, **kw)
    _records_equal([corpus_ops.make_orig_view(r) for r in ctx],
                   [jops.make_orig_view(r) for r in jctx])


@pytest.mark.parametrize("seed", range(3))
def test_metrics_match_jax_on_random_tags(seed):
    rng = np.random.RandomState(seed)
    gold = [_random_tags(rng, n) for n in rng.randint(1, 15, size=30)]
    pred = [_random_tags(rng, len(g)) for g in gold]
    # some sentences predicted right, so that tp > 0
    pred[::3] = gold[::3]
    got = metrics.evaluate_spans(gold, pred)
    want = jmetrics.evaluate_spans(gold, pred)
    assert str(got) == str(want)
    assert got.get_classes() == want.get_classes()
    for c in [None] + got.get_classes():
        assert (got.get_tp(c), got.get_fp(c), got.get_fn(c)) == \
            (want.get_tp(c), want.get_fp(c), want.get_fn(c))
        assert got.precision(c) == want.precision(c)
        assert got.recall(c) == want.recall(c)
        assert got.accuracy(c) == want.accuracy(c)
    assert got.micro_avg_f_score() == want.micro_avg_f_score()
    assert got.macro_avg_f_score() == want.macro_avg_f_score()
    for remove_x in (False, True):
        a = conlleval.conll_evaluate(gold, pred, remove_x=remove_x)
        b = jconlleval.conll_evaluate(gold, pred, remove_x=remove_x)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert (a.overall(), a.per_type(), a.accuracy(), a.macro_f1(),
                a.micro_f1()) == (b.overall(), b.per_type(), b.accuracy(),
                                  b.macro_f1(), b.micro_f1())


def test_metrics_match_jax_on_fixture_files(fixtures_path):
    for folder in ("ner_toy", "ner_toy_de", "ner_ctx"):
        recs = conll.read_column_file(fixtures_path / folder / "train.txt",
                                      FMT, comment_symbol="# id",
                                      tag_to_bioes="ner")
        gold = [r.tags["ner"] for r in recs]
        pred = [list(reversed(g)) for g in gold]
        for g, p in ((gold, gold), (gold, pred)):
            got = metrics.evaluate_spans(g, p)
            want = jmetrics.evaluate_spans(g, p)
            assert str(got) == str(want)
            assert dataclasses.asdict(conlleval.conll_evaluate(g, p)) == \
                dataclasses.asdict(jconlleval.conll_evaluate(g, p))
