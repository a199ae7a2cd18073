"""The PyTorch port's long-input and corpus policies against kbner_tpu's:
stride windows (split, stitch, ``predict_long``, the trainer's epoch
records and stitched evaluation), document windows (``doc_context``), the
named-corpus registry, the CoNLL-U and fastText readers, and ``cli
train`` with ``data.stride_windows``, ``data.doc_context`` and a named
corpus.

Everything here is held exactly: chunks and offsets, stitched tags,
windowed records token by token, registry specs field by field, read
records layer by layer, and tags predicted from carried-in weights.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kbner_tpu.config import ExperimentConfig as JExperimentConfig
from kbner_tpu.data import corpora as jcorpora
from kbner_tpu.data import doc_context as jdoc
from kbner_tpu.data import windows as jwin
from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.conll import load_column_corpus as j_load_corpus
from kbner_tpu.data.conll import read_conllu_file as j_read_conllu
from kbner_tpu.data.conll import read_fasttext_file as j_read_fasttext
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu.train import TrainConfig as JTrainConfig
from kbner_tpu_torch import cli, weights
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.data import corpora, doc_context, windows
from kbner_tpu_torch.data.conll import SentenceRecord, load_column_corpus
from kbner_tpu_torch.data.conll import read_conllu_file, read_fasttext_file
from kbner_tpu_torch.data.encode import encode_batch
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
TOK, JTOK = HashTokenizer(VOCAB), JTokenizer(VOCAB)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(n, seed):
    """``n`` words of 1 to 14 characters (1 to 3 hash subtokens)."""
    rng = np.random.RandomState(seed)
    return ["".join(chr(97 + c) for c in rng.randint(26, size=k))
            for k in rng.randint(1, 15, size=n)]


def _record(cls, n, seed, **kw):
    tokens = _words(n, seed)
    tags = [("B-PER", "E-PER", "O", "S-LOC")[i % 4] for i in range(n)]
    return cls(tokens=tokens, tags={"ner": tags, "pos": list(tokens)}, **kw)


def _same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.tokens == w.tokens and g.tags == w.tags
        assert (g.doc_id, g.lang_id, g.comment) == \
            (w.doc_id, w.lang_id, w.comment)


# -- stride windows --------------------------------------------------------------

def test_split_short_record_passthrough():
    rec = SentenceRecord(tokens=["a", "b"], tags={"ner": ["O", "O"]})
    pieces = windows.split_long_record(rec, TOK, max_subtokens=510)
    assert len(pieces) == 1 and pieces[0][0] is rec and pieces[0][1] == 0


@pytest.mark.parametrize("n,budget,stride", [
    (100, 34, 8), (100, 12, 2), (57, 20, 16), (40, 5, 3), (300, 128, 16),
    (33, 33, 0)])
def test_split_long_record_equals_the_reference(n, budget, stride):
    """Chunks and word offsets as the JAX package cuts them, every word
    covered, consecutive chunks overlapping (budgets down to one long
    word: a word over the budget is a chunk of its own)."""
    got = windows.split_long_record(
        _record(SentenceRecord, n, n, doc_id=3, lang_id=1, comment="# c"),
        TOK, max_subtokens=budget, stride_words=stride)
    want = jwin.split_long_record(
        _record(JRecord, n, n, doc_id=3, lang_id=1, comment="# c"), JTOK,
        max_subtokens=budget, stride_words=stride)
    assert [off for _, off in got] == [off for _, off in want]
    _same_records([c for c, _ in got], [c for c, _ in want])
    covered = set()
    for chunk, off in got:
        covered.update(range(off, off + len(chunk.tokens)))
    assert covered == set(range(n))


@pytest.mark.parametrize("pieces,total", [
    ([(10, 0), (10, 6)], 16),       # overlap 4: each side takes 2
    ([(10, 0), (10, 5)], 15),       # overlap 5 (odd): left 2, right 3
    ([(7, 0), (7, 4), (7, 8)], 15),  # overlaps 3 and 3
    ([(5, 0), (5, 5)], 10),         # no overlap
    ([(4, 0), (6, 1)], 7),          # overlap 3 of a 4-word chunk
    ([(3, 0)], 5),                  # uncovered words stay O
])
def test_stitch_equals_the_reference(pieces, total):
    tagged = [([f"T{i}-{w}" for w in range(clen)], off, clen)
              for i, (clen, off) in enumerate(pieces)]
    got = windows.stitch_window_predictions(tagged, total)
    assert got == jwin.stitch_window_predictions(tagged, total)
    if len(pieces) == 2 and pieces == [(10, 0), (10, 5)]:
        assert got[:7] == [f"T0-{w}" for w in range(7)]
        assert got[7:] == [f"T1-{w}" for w in range(2, 10)]


@pytest.fixture(scope="module")
def toy_pair():
    """The JAX trainer and the port's over the toy corpus with the same
    tiny tagger (perturbed Flax init), dropout off."""
    jc = j_load_corpus(FIX / "ner_toy", {0: "text", 1: "ner"},
                       comment_symbol="# id")
    pc = load_column_corpus(FIX / "ner_toy", {0: "text", 1: "ner"},
                            comment_symbol="# id")
    jtags, tags = jc.make_tag_dictionary("ner"), pc.make_tag_dictionary("ner")
    kw = dict(locked_dropout=0.0, word_dropout=0.0)
    model, params = init_tagger(
        JTaggerConfig.for_tag_dictionary(JXLMRConfig.tiny(vocab_size=VOCAB),
                                         jtags, **kw),
        jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in j_encode(
            jc.train[:2], JTOK, jtags).arrays().items()})
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    cfg = TaggerConfig.for_tag_dictionary(XLMRConfig.tiny(vocab_size=VOCAB),
                                          tags, **kw)
    tagger = SequenceTagger(cfg, device="cpu", seed=1)
    tagger.load_state_dict(weights.from_jax_params(params, cfg))
    return (jc, pc, jtags, tags, model,
            jax.tree_util.tree_map(jnp.asarray, params), tagger)


@pytest.mark.parametrize("budget,stride", [(40, 6), (12, 2), (9, 3)])
def test_predict_long_equals_the_reference(toy_pair, budget, stride):
    jc, pc, jtags, tags, model, params, tagger = toy_pair
    jt = JTrainer(model, params, jc, JTOK, jtags)
    pt = FinetuneTrainer(tagger, pc, TOK, tags, device="cpu")
    jrecs = [_record(JRecord, 80, 1)] + jc.train
    precs = [_record(SentenceRecord, 80, 1)] + pc.train
    got = windows.predict_long(pt, precs, max_subtokens=budget,
                               stride_words=stride)
    want = jwin.predict_long(jt, jrecs, max_subtokens=budget,
                             stride_words=stride)
    assert got == want
    assert [len(g) for g in got] == [len(r.tokens) for r in precs]


def test_trainer_stride_hooks_equal_the_reference(toy_pair):
    """``stride_windows``: the epoch's records (resampled, then split) and
    the stitched evaluation equal the JAX trainer's; without it, records
    pass through."""
    jc, pc, jtags, tags, model, params, tagger = toy_pair
    kw = dict(stride_windows=True, stride_max_subtokens=12, stride_words=2)
    jt = JTrainer(model, params, jc, JTOK, jtags, **kw)
    pt = FinetuneTrainer(tagger, pc, TOK, tags, device="cpu", **kw)
    for cfg in (dict(), dict(resample_smooth=0.7, seed=3)):
        want = jt._epoch_records(JTrainConfig(**cfg), 1)
        got = pt._epoch_records(TrainConfig(**cfg), 1)
        _same_records(got, want)
        assert len(got) > len(pc.train)
    metric_g, preds_g = pt.evaluate(pc.train)
    metric_w, preds_w = jt.evaluate(jc.train)
    assert preds_g == preds_w
    assert metric_g.micro_avg_f_score() == metric_w.micro_avg_f_score()
    plain = FinetuneTrainer(tagger, pc, TOK, tags, device="cpu")
    assert len(plain._epoch_records(TrainConfig(), 0)) == len(pc.train)


def test_crf_on_windows_that_start_in_context():
    """A window can start inside a fused record's retrieved context: word
    0 masked in every sentence of the batch, one sentence masked
    throughout. The port's CRF equals the JAX package's, whose chain
    starts at word 0 whatever the mask (rtol 1e-5, atol 1e-5; Viterbi
    tags exactly)."""
    from kbner_tpu.ops import crf as jcrf
    from kbner_tpu_torch.ops import crf

    rng = np.random.RandomState(3)
    B, T, K = 4, 9, 7
    em = rng.standard_normal((B, T, K)).astype(np.float32)
    trans = rng.standard_normal((K, K)).astype(np.float32)
    trans[:, K - 2] = -10000.0
    trans[K - 1, :] = -10000.0
    mask = (rng.rand(B, T) < 0.6).astype(np.int32)
    mask[:, 0] = 0
    mask[1] = 0
    mask[:, -1] = 0
    tags = rng.randint(0, K - 2, size=(B, T)).astype(np.int32)
    j = [np.asarray(x) for x in (
        jcrf.crf_neg_log_likelihood(em, tags, mask, trans, K - 2, K - 1),
        jcrf.crf_marginals(em, mask, trans, K - 2, K - 1))]
    t = [torch.from_numpy(x) for x in (em, tags, mask, trans)]
    got = [crf.crf_neg_log_likelihood(*t, K - 2, K - 1).numpy(),
           crf.crf_marginals(t[0], t[2], t[3], K - 2, K - 1).numpy()]
    for g, w in zip(got, j):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    want_tags, want_scores = jcrf.crf_decode(em, mask, trans, K - 2, K - 1)
    got_tags, got_scores = crf.crf_decode(t[0], t[2], t[3], K - 2, K - 1)
    np.testing.assert_array_equal(got_tags.numpy(), np.asarray(want_tags))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5)


# -- document windows -------------------------------------------------------------

def _doc_records(cls):
    sents = [(["First", "sentence", "here"], ["O", "O", "O"]),
             (["Alice", "visited", "Berlin"], ["S-PER", "O", "S-LOC"]),
             (["Third", "sentence", "follows"], ["O", "O", "O"]),
             (["Fourth", "one"], ["O", "O"])]
    return [cls(tokens=t, tags={"ner": g}, doc_id=0) for t, g in sents]


def test_window_includes_neighbors_and_masks_them():
    recs = _doc_records(SentenceRecord)
    windowed, offsets = doc_context.make_doc_context_records(recs, TOK)
    w1, off = windowed[1], offsets[1]
    assert "First" in w1.tokens and "Third" in w1.tokens
    assert w1.tokens[off:off + 3] == ["Alice", "visited", "Berlin"]
    assert w1.tags["ner"][off:off + 3] == ["S-PER", "O", "S-LOC"]
    assert all(t == "S-X" for t in w1.tags["ner"][:off])
    assert all(t == "S-X" for t in w1.tags["ner"][off + 3:])


def test_window_respects_budget():
    recs = _doc_records(SentenceRecord)
    windowed, _ = doc_context.make_doc_context_records(recs, TOK, budget=7)
    assert len(windowed[1].tokens) < sum(len(r.tokens) for r in recs)


def test_encode_masks_window_context():
    recs = _doc_records(SentenceRecord)
    windowed, offsets = doc_context.make_doc_context_records(recs, TOK)
    eb = encode_batch(windowed, TOK, None)
    off, n = offsets[1], len(windowed[1].tokens)
    assert (eb.crf_mask[1][off:off + 3] == 1).all()
    assert (eb.crf_mask[1][:off] == 0).all()
    assert (eb.crf_mask[1][off + 3:n] == 0).all()


def test_strip_doc_context_roundtrip():
    recs = _doc_records(SentenceRecord)
    windowed, offsets = doc_context.make_doc_context_records(recs, TOK)
    preds = [list(w.tags["ner"]) for w in windowed]
    stripped = doc_context.strip_doc_context(preds, recs, offsets)
    assert stripped[1] == ["S-PER", "O", "S-LOC"]
    assert all(len(s) == len(r.tokens) for s, r in zip(stripped, recs))


def test_documents_do_not_leak_across_doc_ids():
    recs = _doc_records(SentenceRecord)
    recs[3].doc_id = 1
    windowed, _ = doc_context.make_doc_context_records(recs, TOK)
    assert "Fourth" not in windowed[1].tokens
    assert "Alice" not in windowed[3].tokens


def _documents(cls, seed):
    """Sentences of 1 to 30 random words in documents of 1 to 8
    sentences, some without a tag layer, in an interleaved order."""
    rng = np.random.RandomState(seed)
    recs = []
    for doc in range(6):
        for _ in range(rng.randint(1, 9)):
            n = int(rng.randint(1, 31))
            r = _record(cls, n, int(rng.randint(1 << 30)), doc_id=doc,
                        lang_id=doc % 2, comment=f"# d{doc}")
            if rng.rand() < 0.2:
                r.tags = {"pos": r.tags["pos"]}
            recs.append(r)
    order = rng.permutation(len(recs))
    return [recs[i] for i in order]


@pytest.mark.parametrize("budget", [510, 64, 40, 20, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_doc_windows_equal_the_reference(budget, seed):
    """Every windowed record token by token (the left/right balancing,
    skipped neighbours that do not fit, records without the tag layer)
    and the offsets."""
    got, g_off = doc_context.make_doc_context_records(
        _documents(SentenceRecord, seed), TOK, budget=budget)
    want, w_off = jdoc.make_doc_context_records(
        _documents(JRecord, seed), JTOK, budget=budget)
    _same_records(got, want)
    assert g_off == w_off
    preds = [list(r.tags["ner"]) for r in got]
    assert doc_context.strip_doc_context(
        preds, _documents(SentenceRecord, seed), g_off) == \
        jdoc.strip_doc_context(preds, _documents(JRecord, seed), w_off)


# -- corpora -------------------------------------------------------------------------

def test_read_conllu_skips_ranges_and_empty_nodes():
    path = FIX / "ud_toy" / "en_toy-ud-train.conllu"
    recs = read_conllu_file(path)
    assert len(recs) == 24
    r0 = recs[0]
    assert r0.tokens == ["The", "dog", "barks"]
    assert r0.tags["head"] == ["2", "3", "0"]
    assert r0.tags["deps"] == ["2:det", "3:nsubj", "0:root"]
    assert recs[2].tokens == ["She", "does", "n't", "run"]
    _same_records(recs, j_read_conllu(path))
    _same_records(read_conllu_file(path, max_sentences=5),
                  j_read_conllu(path, max_sentences=5))


def test_read_fasttext_equals_the_reference(tmp_path):
    path = tmp_path / "clf.txt"
    path.write_text((FIX / "clf_toy" / "train.txt").read_text()
                    + "__label__a __label__b two labels\n__label__x\n\n")
    got, want = read_fasttext_file(path), j_read_fasttext(path)
    _same_records(got, want)
    assert [r.labels for r in got] == [r.labels for r in want]
    assert got[-1].labels == ["a", "b"]
    assert len(read_fasttext_file(path, max_sentences=2)) == 2


def test_ud_registry_entries():
    e = corpora.CORPUS_REGISTRY["UD_ENGLISH"]
    assert e.format == "conllu" and e.train_file == "en_ewt-ud-train.conllu"
    spec = corpora.corpus_spec("UD_ENGLISH", "/data")
    assert (spec.format, spec.data_folder) == ("conllu", "/data/ud_english")
    spec = corpora.corpus_spec("UD_ENGLISH", str(FIX),
                               data_folder=str(FIX / "ud_toy"),
                               train_file="en_toy-ud-train.conllu")
    assert spec.train_file == "en_toy-ud-train.conllu"


def test_named_corpus_registry():
    """Every registry entry resolves to the JAX package's spec, field by
    field; unknown names raise; a named block without a column format
    loads the toy corpus through its overrides."""
    assert set(corpora.CORPUS_REGISTRY) == set(jcorpora.CORPUS_REGISTRY)
    assert len(corpora.CORPUS_REGISTRY) >= 80
    for name in corpora.CORPUS_REGISTRY:
        for root in ("/data", "rel/root"):
            assert dataclasses.asdict(corpora.corpus_spec(name, root)) == \
                dataclasses.asdict(jcorpora.corpus_spec(name, root)), name
    assert dataclasses.asdict(corpora.corpus_spec(
        "conll_03", "/d", train_file="x")) == dataclasses.asdict(
        jcorpora.corpus_spec("conll_03", "/d", train_file="x"))
    with pytest.raises(KeyError):
        corpora.corpus_spec("NO_SUCH_CORPUS", "/data")
    block = {"name": "reg", "corpora": [{
        "name": "CONLL_03_SPANISH", "data_folder": str(FIX / "ner_toy"),
        "train_file": "train.txt", "dev_file": "dev.txt",
        "test_file": "test.txt", "comment_symbol": "# id"}]}
    got = ExperimentConfig.from_dict(block).load_corpus()
    want = JExperimentConfig.from_dict(block).load_corpus()
    assert len(got.train) == 8
    _same_records(got.train + got.test_list[0],
                  want.train + want.test_list[0])


@pytest.mark.parametrize("block", [
    {"name": "UD", "data_folder": str(FIX / "ud_toy"), "format": "conllu",
     "train_file": "en_toy-ud-train.conllu",
     "dev_file": "en_toy-ud-dev.conllu"},
    {"name": "CLF", "data_folder": str(FIX / "clf_toy"),
     "format": "fasttext"},
    {"name": "UD_ENGLISH", "data_root": str(FIX),
     "data_folder": str(FIX / "ud_toy"),
     "train_file": "en_toy-ud-train.conllu"},
    {"name": "TOY", "data_folder": str(FIX / "ner_toy"),
     "column_format": {0: "text", 1: "ner"}, "comment_symbol": "# id"},
], ids=["conllu", "fasttext", "named-conllu", "column"])
def test_config_corpora_equal_the_reference(block):
    """Each kind of ``corpora:`` block gives the JAX config's spec and
    the same records in every split."""
    raw = {"name": "c", "corpora": [block]}
    got, want = ExperimentConfig.from_dict(raw), JExperimentConfig.from_dict(
        raw)
    assert dataclasses.asdict(got.corpora[0]) == \
        dataclasses.asdict(want.corpora[0])
    gc, wc = got.load_corpus(), want.load_corpus()
    for split in ("train", "dev", "test"):
        g = getattr(gc.corpora[0], split)
        w = getattr(wc.corpora[0], split)
        _same_records(g, w)
        assert [r.labels for r in g] == [r.labels for r in w]
    assert len(gc.train) > 0


def test_prepare_corpus_equals_the_reference(tmp_path):
    """``data.doc_context`` windows every split of every corpus with
    ``doc_window_budget``, as the JAX config does."""
    raw = {"name": "d", "data": {"doc_context": True,
                                 "doc_window_budget": 24},
           "corpora": [{"name": n, "data_folder": str(FIX / f),
                        "column_format": {0: "text", 1: "ner"},
                        "comment_symbol": "# id"}
                       for n, f in (("EN", "ner_toy"), ("DE", "ner_toy_de"))]}
    got = ExperimentConfig.from_dict(raw)
    want = JExperimentConfig.from_dict(raw)
    gc = got.prepare_corpus(got.load_corpus(), TOK)
    wc = want.prepare_corpus(want.load_corpus(), JTOK)
    for g, w in zip(gc.corpora, wc.corpora):
        for split in ("train", "dev", "test"):
            _same_records(getattr(g, split), getattr(w, split))
    assert any("S-X" in r.tags["ner"] for r in gc.train)


# -- the CLI ---------------------------------------------------------------------------

def _cli_config(tmp_path, data, epochs):
    raw = yaml.safe_load((FIX / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(FIX / "ner_toy")
    raw["corpora"][0]["test_file"] = "train.txt"
    raw["train"].update(max_epochs=epochs)
    raw["target_dir"] = str(tmp_path / "run")
    raw["data"] = data
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p, Path(raw["target_dir"])


def test_cli_train_with_doc_context(tmp_path):
    """``data: {doc_context: true}`` trains and evaluates on document
    windows: neighbour sentences as S-X context around each sentence."""
    p, run = _cli_config(tmp_path, {"doc_context": True,
                                    "doc_window_budget": 64}, 30)
    cli.main(["train", "--config", str(p), "--device", "cpu"])
    results = json.loads((run / "test_results.json").read_text())
    assert results["TOY"]["micro_f1"] > 0.9
    cfg = ExperimentConfig.from_file(p)
    corpus = cfg.prepare_corpus(cfg.load_corpus(), cfg.make_tokenizer())
    assert any("S-X" in rec.tags["ner"] for rec in corpus.train)
    assert all(len(rec.tokens) == len(rec.tags["ner"])
               for rec in corpus.train)


def test_cli_train_with_stride_windows(tmp_path):
    """Over-budget sentences train and evaluate as overlapping windows,
    stitched back: one block per original sentence in the test file."""
    p, run = _cli_config(tmp_path, {"stride_windows": True,
                                    "max_subtokens": 12,
                                    "stride_words": 2}, 30)
    cli.main(["train", "--config", str(p), "--device", "cpu"])
    results = json.loads((run / "test_results.json").read_text())
    out = (run / "test.TOY.tsv").read_text().strip().split("\n\n")
    assert len(out) == 8
    assert results["TOY"]["micro_f1"] > 0.5
    trainer = cli._build(ExperimentConfig.from_file(p), "cpu")
    assert (trainer.stride_windows, trainer.stride_max_subtokens,
            trainer.stride_words) == (True, 12, 2)


def test_cli_refuses_data_policies_for_parser_targets(tmp_path):
    """The JAX CLI's refusal: document and stride windows are NER-tagger
    policies."""
    p, _ = _cli_config(tmp_path, {"stride_windows": True}, 1)
    raw = yaml.safe_load(p.read_text())
    raw["targets"] = "dependency"
    p.write_text(yaml.safe_dump(raw))
    with pytest.raises(ValueError, match="NER-tagger data policies"):
        cli._build(ExperimentConfig.from_file(p), "cpu")
