"""Retrieval over corpus splits in the PyTorch port against kbner_tpu's:
``retrieve_for_records`` in each engine mode, the pipelined stream against
per-batch search, the retrieval file (the same bytes from the same
results), ``cli retrieve`` end to end (its retrieval files parsed with
scores at rtol 1e-5 and every other byte equal, its fused column files
byte for byte), reranking (edit distance, BERTScore F1 and the encoder's
word embeddings), distant supervision, and ``cli serve`` from a saved KB.
"""

import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kbner_tpu import cli as jcli
from kbner_tpu.data.conll import Corpus as JCorpus
from kbner_tpu.data.conll import ListCorpus as JListCorpus
from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.dictionary import Dictionary as JDictionary
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.retrieval import distant as jdistant
from kbner_tpu.retrieval import pipeline as jpipeline
from kbner_tpu.retrieval import rerank as jrerank
from kbner_tpu.retrieval.engine import RetrievalEngine as JEngine
from kbner_tpu.retrieval.engine import RetrievedDoc as JDoc
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu_torch import cli
from kbner_tpu_torch.data.conll import ListCorpus, read_column_file
from kbner_tpu_torch.data.dictionary import Dictionary
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.retrieval import distant, pipeline, rerank
from kbner_tpu_torch.retrieval.engine import RetrievalEngine, RetrievedDoc
from kbner_tpu_torch.retrieval.index import BM25Index
from kbner_tpu_torch.retrieval.synth import synth_wiki_docs
from kbner_tpu_torch.serve import serve
from kbner_tpu_torch.train import FinetuneTrainer
from kbner_tpu_torch.weights import from_jax_params

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
# sentences of distinct analyzed lengths (6 to 15 terms) and titles that
# share no term, so BM25 scores do not tie: torch.topk and lax.top_k order
# tied documents differently, and the files are compared in order
KB_ROWS = [
    ("Alice Smith", "Alice Smith is a software engineer who lives in Berlin ."),
    ("Berlin", "Berlin is the capital and largest city of Germany ."),
    ("European Union",
     "The European Union is a union of member states in Europe today ."),
    ("Paris", "Paris is the capital of France ."),
    ("Acme Corp", "Acme Corp hired hundreds of engineers in New York last "
     "year for a new office ."),
    ("New York City", "New York City is the most populous city in the "
     "United States of America ."),
    ("Bob", "Bob is a common short form of the given name Robert in "
     "English ."),
    ("Germany", "Germany is a large country in Central Europe ."),
    ("Union", "A union is an organization of workers ."),
    ("City", "A city is a large human settlement where many people live ."),
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kb_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("kb") / "kb.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for i, (title, sentence) in enumerate(KB_ROWS):
            f.write(json.dumps({"title": title, "sentence": sentence,
                                "paragraph": sentence + " More text .",
                                "url": f"https://example.org/{i}"}) + "\n")
    return path


def _records():
    recs = []
    for split in ("train", "dev", "test"):
        recs += read_column_file(FIX / "ner_toy" / f"{split}.txt",
                                 {0: "text", 1: "ner"},
                                 comment_symbol="# id")
    return recs


def _j(recs):
    return [JRecord(tokens=r.tokens, tags=r.tags) for r in recs]


def _rows(results):
    return [[(d.doc_id, d.sentence, d.paragraph, d.title, d.url)
             for d in r] for r in results]


def _scores(results):
    return [[d.score for d in r] for r in results]


# -- retrieve_for_records -----------------------------------------------------

@pytest.mark.parametrize("mode,with_entity,given", [
    ("exhaustive", False, False), ("exhaustive", True, False),
    ("exhaustive", True, True), ("pruned", False, False),
    ("pruned", True, False)])
def test_retrieve_for_records_matches_jax(kb_path, mode, with_entity, given):
    text, store, title = pipeline.build_kb_from_jsonl(kb_path)
    jt, jstore, jtitle = jpipeline.build_kb_from_jsonl(kb_path)
    port = RetrievalEngine(text, store=store, title_index=title, mode=mode,
                           device="cpu")
    jax_side = JEngine(jt, store=jstore, title_index=jtitle, mode=mode,
                       use_pallas=mode == "pruned")
    recs = _records()
    # given seeds: each sentence's last word, a seed no tag gives
    seeds = [[r.tokens[-2]] for r in recs] if given else None
    got = pipeline.retrieve_for_records(port, recs, k=4,
                                        with_entity=with_entity,
                                        entities=seeds, batch_size=5)
    want = jpipeline.retrieve_for_records(jax_side, _j(recs), k=4,
                                          with_entity=with_entity,
                                          entities=seeds, batch_size=5)
    assert _rows(got) == _rows(want)
    np.testing.assert_allclose(sum(_scores(got), []),
                               sum(_scores(want), []), rtol=1e-5)
    assert sum(map(len, got)) > len(recs)


def test_sentence_query_and_cjk_cleanup():
    rec = _records()[0]
    rec.tokens = rec.tokens + ["<EOS>", "context"]
    assert pipeline.sentence_query(rec) == jpipeline.sentence_query(rec)
    assert "<EOS>" not in pipeline.sentence_query(rec)
    for text in ("北 京 大 学 is big", "a b", "한 국 어 x 中 文"):
        assert pipeline.clean_cjk_spaces(text) == \
            jpipeline.clean_cjk_spaces(text)


# -- the pipelined stream -----------------------------------------------------

@pytest.fixture(scope="module")
def synth_kb():
    docs = synth_wiki_docs(2000, n_topics=40, seed=3)
    vocab = {f"w{i}": i for i in range(int(docs.max()) + 1)}
    index = BM25Index.build_encoded(docs, vocab)
    queries = [" ".join(f"w{t}" for t in row[row >= 0][:14])
               for row in docs[::29]]
    return index, queries


@pytest.mark.parametrize("workers,depth", [(1, 1), (3, 3), (2, 1)])
@pytest.mark.parametrize("raw", [True, False])
def test_search_stream_equals_per_batch_search(synth_kb, workers, depth,
                                               raw):
    """The stream yields, in order, what per-batch search_encoded gives on
    an engine built alike (the never-shrink widths grow the same way)."""
    index, queries = synth_kb
    batches = [queries[i:i + 11] for i in range(0, len(queries), 11)]
    encoded = [index.encode_queries(b) for b in batches]
    stream = RetrievalEngine(index, mode="pruned", device="cpu")
    per_batch = RetrievalEngine(index, mode="pruned", device="cpu")
    got = list(stream.search_stream(batches if raw else encoded, k=7,
                                    workers=workers, depth=depth))
    want = [per_batch.search_encoded(qt, qw, k=7) for qt, qw in encoded]
    assert len(got) == len(want) == len(batches)
    for (gs, gi), (ws, wi) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
        assert gs.dtype == ws.dtype and gi.dtype == wi.dtype
    assert stream._t_cols_floor == per_batch._t_cols_floor
    assert list(stream.search_stream([], workers=workers,
                                     depth=depth)) == []


def test_search_stream_exhaustive_and_texts(synth_kb):
    index, queries = synth_kb
    engine = RetrievalEngine(index, device="cpu")
    batches = [queries[i:i + 16] for i in range(0, len(queries), 16)]
    for (gs, gi), b in zip(engine.search_stream(batches, k=5), batches):
        ws, wi = engine.search_encoded(*index.encode_queries(b), k=5)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
    pruned = RetrievalEngine(index, mode="pruned", device="cpu")
    got = pruned.search_texts_stream(queries, k=5, batch_size=16)
    want = RetrievalEngine(index, mode="pruned", device="cpu").search(
        queries[:16], k=5)
    assert _rows(got[:16]) == _rows(want) and len(got) == len(queries)


def test_search_stream_raises_what_a_batch_raises(synth_kb):
    index, queries = synth_kb
    engine = RetrievalEngine(index, mode="pruned", device="cpu")
    bad = [queries[:4], (np.zeros((2, 3), np.int32),), queries[4:8]]
    with pytest.raises(ValueError):
        list(engine.search_stream(bad, workers=3))


# -- the retrieval file -------------------------------------------------------

def _results():
    """Retrieved contexts with unicode, empty fields, and scores whose 6th
    decimal rounds both ways."""
    docs = [
        RetrievedDoc(3, 12.3456785, "Alice lives in Berlin .",
                     "Alice lives in Berlin . More .", "Alice Smith",
                     "https://x/3"),
        RetrievedDoc(7, 0.1234564, "Zürich — a city", "", "Zürich", ""),
        RetrievedDoc(1, 1e-7, "Berlin is big", "p", "Berlin", "u"),
    ]
    return [docs, [], docs[::-1]]


def test_write_retrieval_file_is_byte_identical(tmp_path):
    recs = _records()[:3]
    results = _results()
    ents = [["Alice Smith"], [], ["Berlin", "Zürich"]]
    for entities in (None, ents):
        pipeline.write_retrieval_file(tmp_path / "p.tsv", recs, results,
                                      entities=entities)
        jpipeline.write_retrieval_file(
            tmp_path / "j.tsv", _j(recs),
            [[JDoc(**vars(d)) for d in r] for r in results],
            entities=entities)
        assert (tmp_path / "p.tsv").read_bytes() == \
            (tmp_path / "j.tsv").read_bytes()
    assert "<hit>Berlin</hit>" in (tmp_path / "p.tsv").read_text()
    got = pipeline.read_retrieval_file(tmp_path / "j.tsv")
    want = jpipeline.read_retrieval_file(tmp_path / "j.tsv")
    assert list(got) == list(want)
    assert {q: [vars(d) for d in r] for q, r in got.items()} == \
        {q: [vars(d) for d in r] for q, r in want.items()}


# -- cli retrieve -------------------------------------------------------------

def assert_same_retrieval_files(got: Path, want: Path, rtol=1e-5):
    """Retrieval files equal byte for byte but in the score column, which
    is held at ``rtol``."""
    g_lines = got.read_text(encoding="utf-8").split("\n")
    w_lines = want.read_text(encoding="utf-8").split("\n")
    assert len(g_lines) == len(w_lines)
    n_scores = 0
    for g, w in zip(g_lines, w_lines):
        gp, wp = g.split("\t"), w.split("\t")
        if len(gp) >= 4 and len(gp) == len(wp):
            np.testing.assert_allclose(float(gp[3]), float(wp[3]),
                                       rtol=rtol)
            gp[3] = wp[3] = ""
            n_scores += 1
        assert gp == wp
    return n_scores


@pytest.mark.parametrize("argv", [
    [],
    ["--with_entity"],
    ["--rerank", "edit", "--k", "3", "--mode", "paragraph"],
    ["--distant_out", "DISTANT"],
    ["--with_entity", "--engine_mode", "pruned", "--mode", "sentence"],
])
def test_cli_retrieve_matches_jax(kb_path, tmp_path, argv):
    argv = [str(tmp_path / "{}.silver") if a == "DISTANT" else a
            for a in argv]
    common = ["--kb", str(kb_path), "--data_folder", str(FIX / "ner_toy")]
    cli.main(["retrieve", *common, "--out", str(tmp_path / "port"),
              "--device", "cpu", *[a.format("port") for a in argv]])
    jcli.main(["retrieve", *common, "--out", str(tmp_path / "jax"),
               *[a.format("jax") for a in argv]])
    n = 0
    for split in ("train", "dev", "test"):
        n += assert_same_retrieval_files(
            tmp_path / "port" / f"{split}.retrieval.tsv",
            tmp_path / "jax" / f"{split}.retrieval.tsv")
        assert (tmp_path / "port" / f"{split}.txt").read_bytes() == \
            (tmp_path / "jax" / f"{split}.txt").read_bytes()
    assert n > 10
    if "--distant_out" in argv:
        silver = (tmp_path / "port.silver").read_bytes()
        assert silver == (tmp_path / "jax.silver").read_bytes()
        assert silver  # some gold span was found in a context


def test_cli_retrieve_from_a_saved_kb_and_store(kb_path, tmp_path):
    """--index_dir, and --kb with --store, give the files that --kb gives;
    the command returns each split's stage seconds."""
    cli.main(["index", "--kb", str(kb_path), "--out", str(tmp_path / "kb")])
    outs = {}
    for name, src in (("kb", ["--kb", str(kb_path)]),
                      ("dir", ["--index_dir", str(tmp_path / "kb")]),
                      ("store", ["--kb", str(kb_path), "--store",
                                 str(tmp_path / "s.docs")])):
        stats = cli.main(["retrieve", *src, "--data_folder",
                          str(FIX / "ner_toy"), "--out",
                          str(tmp_path / name), "--device", "cpu",
                          "--with_entity"])
        assert set(stats) == {"train", "dev", "test"}
        assert stats["train"]["sentences"] == 8
        assert {"retrieve", "fuse", "write"} <= set(stats["dev"])
        outs[name] = [(tmp_path / name / f).read_bytes() for f in (
            "train.txt", "dev.retrieval.tsv", "test.retrieval.tsv")]
    assert outs["kb"] == outs["dir"] == outs["store"]


def test_cli_retrieve_refuses_unported_options(kb_path, tmp_path):
    """What cli retrieve refuses: BERTScore reranking without the model
    that embeds (``--hf_tokenizer`` runs: the test below)."""
    common = ["retrieve", "--kb", str(kb_path), "--data_folder",
              str(FIX / "ner_toy"), "--out", str(tmp_path), "--device",
              "cpu"]
    with pytest.raises(SystemExit):
        cli.main(common + ["--rerank", "bertscore"])
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        cli.main(common + ["--hf_tokenizer", str(tmp_path)])


@pytest.mark.parametrize("route", ["hf_tokenizer", "tokenizer_config"])
def test_cli_retrieve_hf_tokenizer_matches_jax(kb_path, tmp_path, route):
    """``--hf_tokenizer DIR`` and ``--tokenizer_config`` with ``tokenizer:
    {type: hf, dir: DIR}`` measure the fusion budget with the HF
    tokenizer, as the JAX CLI does (tests/test_serve_decoupled.py): the
    same files. A 300-piece XLM-R-shaped tokenizer splits words into many
    pieces, so the budget binds and the fused files differ from the hash
    proxy's."""
    from kbner_tpu_torch.data.synth_tokenizer import \
        write_xlmr_like_tokenizer

    tok = write_xlmr_like_tokenizer(tmp_path / "tok", n_pieces=300, seed=0)
    if route == "hf_tokenizer":
        flag = ["--hf_tokenizer", str(tok)]
    else:
        cfg = tmp_path / "tok.yaml"
        cfg.write_text(yaml.safe_dump({
            "name": "tok", "corpora": [],
            "tokenizer": {"type": "hf", "dir": str(tok)}}))
        flag = ["--tokenizer_config", str(cfg)]
    common = ["--kb", str(kb_path), "--data_folder", str(FIX / "ner_toy"),
              "--k", "10"]
    cli.main(["retrieve", *common, *flag, "--out", str(tmp_path / "port"),
              "--device", "cpu"])
    jcli.main(["retrieve", *common, *flag, "--out", str(tmp_path / "jax")])
    cli.main(["retrieve", *common, "--out", str(tmp_path / "hash"),
              "--device", "cpu"])
    differs = 0
    for split in ("train", "dev", "test"):
        assert_same_retrieval_files(
            tmp_path / "port" / f"{split}.retrieval.tsv",
            tmp_path / "jax" / f"{split}.retrieval.tsv")
        fused = (tmp_path / "port" / f"{split}.txt").read_bytes()
        assert fused == (tmp_path / "jax" / f"{split}.txt").read_bytes()
        differs += fused != (tmp_path / "hash" / f"{split}.txt").read_bytes()
    assert differs


# -- a trained model in cli retrieve ------------------------------------------

@pytest.fixture(scope="module")
def both_models(tmp_path_factory):
    """A tiny tagger with the same weights in both packages, saved as a
    trained model (config, tag dictionary, best-model.msgpack) that
    either package's ``cli retrieve --model_config`` loads: (jax
    trainer, port trainer, config path)."""
    tmp = tmp_path_factory.mktemp("model")
    tags = ["O", "B-PER", "I-PER", "E-PER", "S-PER", "B-LOC", "E-LOC",
            "S-LOC", "B-ORG", "I-ORG", "E-ORG", "S-ORG", "<START>",
            "<STOP>"]
    j_tags = JDictionary.from_items(tags)
    j_tok = JTokenizer(vocab_size=VOCAB)
    j_cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB), j_tags, locked_dropout=0.0,
        word_dropout=0.0)
    example = j_encode([JRecord(tokens=["x"], tags={"ner": ["O"]})], j_tok)
    model, params = init_tagger(
        j_cfg, jax.random.PRNGKey(2),
        {k: jnp.asarray(v) for k, v in example.arrays().items()})
    rng = np.random.RandomState(2)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    empty = JListCorpus([JCorpus(train=[], dev=[], test=[], name="m")])
    j_trainer = JTrainer(model, jax.tree_util.tree_map(jnp.asarray,
                                                       np_params),
                         empty, j_tok, j_tags, tag_layer="ner")
    target = tmp / "run"
    target.mkdir()
    j_tags.save(target / "tag_dictionary.json")
    j_trainer.save(target / "best-model.msgpack")
    cfg_path = tmp / "model.yaml"
    cfg_path.write_text(yaml.safe_dump({
        "name": "m", "tokenizer": {"type": "hash", "vocab_size": VOCAB},
        "model": {"encoder": "tiny", "locked_dropout": 0.0,
                  "word_dropout": 0.0},
        "target_dir": str(target),
        "corpora": [{"name": "toy", "data_folder": str(FIX / "ner_toy"),
                     "column_format": {0: "text", 1: "ner"},
                     "comment_symbol": "# id"}]}))
    tag_dict = Dictionary.load(target / "tag_dictionary.json")
    tcfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tag_dict)
    tagger = SequenceTagger(tcfg, device="cpu")
    tagger.load_state_dict(from_jax_params(np_params, tcfg), strict=True)
    port = FinetuneTrainer(tagger, ListCorpus([]), HashTokenizer(VOCAB),
                           tag_dict, device="cpu")
    return j_trainer, port, cfg_path


def test_embed_texts_matches_jax(both_models):
    j_trainer, port, _ = both_models
    texts = ["Alice lives in Berlin .", "", "one", "a b c d e f g h i j k"]
    emb, mask = port.embed_texts(texts, batch_size=2)
    j_emb, j_mask = j_trainer.embed_texts(texts, batch_size=2)
    assert emb.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_allclose(emb.numpy(), j_emb, atol=1e-4, rtol=0)
    assert port.embed_texts([])[0].shape == (0, 0, 0)


def test_cli_retrieve_with_a_model_matches_jax(kb_path, tmp_path,
                                               both_models):
    """Predicted entity seeds on dev/test and BERTScore reranking from the
    trained model's encoder."""
    _, _, cfg = both_models
    common = ["--kb", str(kb_path), "--data_folder", str(FIX / "ner_toy"),
              "--with_entity", "--model_config", str(cfg), "--rerank",
              "bertscore"]
    cli.main(["retrieve", *common, "--out", str(tmp_path / "port"),
              "--device", "cpu"])
    jcli.main(["retrieve", *common, "--out", str(tmp_path / "jax")])
    for split in ("train", "dev", "test"):
        assert_same_retrieval_files(
            tmp_path / "port" / f"{split}.retrieval.tsv",
            tmp_path / "jax" / f"{split}.retrieval.tsv")
        assert (tmp_path / "port" / f"{split}.txt").read_bytes() == \
            (tmp_path / "jax" / f"{split}.txt").read_bytes()


# -- reranking and distant supervision ----------------------------------------

@pytest.mark.parametrize("seed", range(3))
def test_bertscore_f1_matches_jax(seed):
    rng = np.random.RandomState(seed)
    K, Lq, Ld, D = 5, 7, 9, 16
    q, d = rng.randn(Lq, D).astype(np.float32), rng.randn(
        K, Ld, D).astype(np.float32)
    qm = (rng.rand(Lq) < 0.8).astype(np.int32)
    dm = (rng.rand(K, Ld) < 0.7).astype(np.int32)
    dm[1] = 0  # a candidate with no token scores 0
    got = rerank.bertscore_f1(torch.from_numpy(q), torch.from_numpy(qm),
                              torch.from_numpy(d), torch.from_numpy(dm))
    want = np.asarray(jrerank.bertscore_f1(q, qm, d, dm))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got[1] == 0
    assert float(rerank.bertscore_f1(q, 0 * qm, d, dm).abs().max()) == 0


def test_reranking_matches_jax():
    docs = _results()[0] + [RetrievedDoc(9, 2.0, "Alice lives", "", "", "")]
    j_docs = [JDoc(**vars(d)) for d in docs]
    for q in ("Alice lives in Berlin", "", "Zürich city"):
        assert [d.doc_id for d in rerank.rerank_by_edit_distance(q, docs)] \
            == [d.doc_id for d in jrerank.rerank_by_edit_distance(q, j_docs)]
        for a in (q, "Berlin"):
            assert rerank.edit_distance(q, a) == jrerank.edit_distance(q, a)
            assert rerank.normalized_edit_similarity(q, a) == \
                jrerank.normalized_edit_similarity(q, a)

    def scorer(a, b):
        return len(set(a) & set(b))

    assert [d.doc_id for d in rerank.rerank_with_scorer("Berlin", docs,
                                                        scorer)] == \
        [d.doc_id for d in jrerank.rerank_with_scorer("Berlin", j_docs,
                                                      scorer)]
    rng = np.random.RandomState(0)
    table = rng.randn(64, 8).astype(np.float32)

    def encode(texts):
        W = max(len(t.split()) for t in texts)
        emb = np.zeros((len(texts), W, 8), np.float32)
        mask = np.zeros((len(texts), W), np.int32)
        for i, t in enumerate(texts):
            for j, w in enumerate(t.split()):
                emb[i, j] = table[sum(map(ord, w)) % 64]
                mask[i, j] = 1
        return emb, mask

    assert [d.doc_id for d in rerank.rerank_by_bertscore(
        encode, "Alice lives in Berlin", docs)] == \
        [d.doc_id for d in jrerank.rerank_by_bertscore(
            encode, "Alice lives in Berlin", j_docs)]
    assert rerank.rerank_by_bertscore(encode, "x", []) == []
    assert rerank.split_corpus(list(range(7)), 3) == \
        jrerank.split_corpus(list(range(7)), 3)


def test_cli_bertscore_rerank_in_chunks_equals_one_call():
    """``cli retrieve --rerank bertscore`` embeds a chunk of queries with
    their contexts per call; any chunk size gives the lists that one call
    over the whole split gives, and no call embeds more than one
    chunk's texts."""
    rng = np.random.RandomState(3)
    table = torch.from_numpy(rng.randn(64, 8).astype(np.float32))
    calls = []

    class Encoder:
        def embed_texts(self, texts):
            calls.append(len(texts))
            W = max(len(t.split()) for t in texts)
            emb = torch.zeros((len(texts), W, 8))
            mask = torch.zeros((len(texts), W), dtype=torch.int32)
            for i, t in enumerate(texts):
                for j, w in enumerate(t.split()):
                    emb[i, j] = table[sum(map(ord, w)) % 64]
                    mask[i, j] = 1
            return emb, mask

    words = ["Alice", "lives", "in", "Berlin", "Paris", "city", "old", "x"]

    def text():
        return " ".join(rng.choice(words, rng.randint(1, 6)))

    queries = [text() for _ in range(7)]
    results = [[RetrievedDoc(d, 1.0, text(), "", "", "")
                for d in range(rng.randint(0, 5))] for _ in queries]
    results[2] = []
    whole = cli._rerank_bertscore(Encoder(), queries, results)
    assert calls == [len(queries) + sum(map(len, results))]
    for chunk in (1, 2, 3):
        calls.clear()
        got = cli._rerank_bertscore(Encoder(), queries, results, chunk=chunk)
        assert [[d.doc_id for d in r] for r in got] == \
            [[d.doc_id for d in r] for r in whole]
        assert len(calls) == -(-len(queries) // chunk)
        assert max(calls) <= chunk * 5


def test_distant_supervision_matches_jax():
    recs = _records()
    results = [[RetrievedDoc(0, 1.0, s, "", t, "") for t, s in KB_ROWS]
               + [RetrievedDoc(1, 0.5, "Alice Smith met Alice Smith Smith",
                               "", "", "")]] * len(recs)
    got = distant.distant_supervision(recs, results)
    want = jdistant.distant_supervision(
        _j(recs), [[JDoc(**vars(d)) for d in r] for r in results])
    assert [(r.tokens, r.tags) for r in got] == \
        [(r.tokens, r.tags) for r in want]
    assert got
    for r in recs:
        assert distant.named_entity_labels(r) == \
            jdistant.named_entity_labels(r)
    ctx = [s for _, s in KB_ROWS]
    assert distant.rank_contexts_jaccard("the city of Berlin", ctx) == \
        jdistant.rank_contexts_jaccard("the city of Berlin", ctx)
    assert distant.match_entity_count(["Berlin", "city"], ctx[1]) == \
        jdistant.match_entity_count(["Berlin", "city"], ctx[1])


# -- cli serve from a saved KB ------------------------------------------------

REQUESTS = [{"id": 0, "tokens": ["Alice", "visited", "Berlin"]},
            {"id": 1, "text": "Paris in France"},
            {"id": 2, "tokens": ["workers", "union", "of", "Germany"]},
            {"id": 3, "tokens": ["zzz"]}]


@pytest.mark.parametrize("engine_mode", ["exhaustive", "pruned"])
def test_cli_serve_from_a_saved_kb(kb_path, tmp_path, capsys, monkeypatch,
                                   engine_mode):
    target = tmp_path / "run"
    tags = Dictionary.load(Path(str(_tags(target))))
    assert len(tags) > 2
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "name": "toy", "tokenizer": {"type": "hash", "vocab_size": VOCAB},
        "model": {"encoder": "tiny"}, "target_dir": str(target)}))
    cli.main(["index", "--kb", str(kb_path), "--out", str(tmp_path / "kb")])
    outs = {}
    for name, src in (("kb", ["--kb", str(kb_path)]),
                      ("dir", ["--index_dir", str(tmp_path / "kb")]),
                      ("store", ["--kb", str(kb_path), "--store",
                                 str(tmp_path / "s.docs")])):
        monkeypatch.setattr("sys.stdin", io.StringIO(
            "\n".join(json.dumps(r) for r in REQUESTS) + "\n"))
        cli.main(["serve", "--config", str(cfg), *src, "--device", "cpu",
                  "--k", "3", "--batch_size", "3", "--engine_mode",
                  engine_mode])
        outs[name] = capsys.readouterr().out
    assert outs["kb"] == outs["dir"] == outs["store"]
    assert [json.loads(line)["id"] for line in
            outs["dir"].strip().splitlines()] == [0, 1, 2, 3]
    # and what serve() gives on the in-memory engine
    tagger = SequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags), device="cpu").eval()
    text, store, title = pipeline.build_kb_from_jsonl(kb_path)
    engine = RetrievalEngine(text, store=store, title_index=title,
                             mode=engine_mode, device="cpu")
    want = []
    for i in range(0, len(REQUESTS), 3):
        want += serve(REQUESTS[i:i + 3], engine, tagger,
                      HashTokenizer(VOCAB), tags, k=3, batch_size=3)
    assert [json.loads(line) for line in outs["dir"].strip().splitlines()] \
        == json.loads(json.dumps(want))


def _tags(target: Path) -> Path:
    from kbner_tpu_torch.data.dictionary import make_tag_dictionary

    path = target / "tag_dictionary.json"
    make_tag_dictionary([["S-PER", "S-LOC", "B-ORG", "E-ORG"]]).save(path)
    return path


def test_fusion_drops_over_budget_train_sentences_as_jax():
    from kbner_tpu.retrieval.fusion import fuse_contexts as j_fuse
    from kbner_tpu_torch.retrieval.fusion import fuse_contexts

    recs = _records()[:3]
    recs[1].tokens = ["extraordinary"] * 300
    recs[1].tags = {"ner": ["O"] * 300}
    results = _results()
    for drop in (False, True):
        got = fuse_contexts(recs, results, HashTokenizer(VOCAB),
                            drop_over_budget_train=drop)
        want = j_fuse(_j(recs), [[JDoc(**vars(d)) for d in r]
                                 for r in results], JTokenizer(VOCAB),
                      drop_over_budget_train=drop)
        assert [(r.tokens, r.tags) for r in got] == \
            [(r.tokens, r.tags) for r in want]
        assert len(got) == 3 - drop


def test_word_length_counts_the_hashed_pieces():
    tok = HashTokenizer(VOCAB, max_pieces=3)
    for word in ("", "a", "abcd", "abcde", "x" * 12, "x" * 13, "Zürich",
                 "<EOS>", "北京大学很大"):
        assert tok.word_length(word) == len(tok.encode_word(word)) == \
            len(JTokenizer(VOCAB).encode_word(word))


def test_search_stream_under_thread_switching_stress(synth_kb):
    """More prep threads than cores and a short switch interval: the
    batches still pack in order (the never-shrink widths grow as per-batch
    calls grow them) and every result equals per-batch search."""
    import sys

    index, queries = synth_kb
    batches = [queries[i:i + 3] for i in range(0, len(queries), 3)]
    stream = RetrievalEngine(index, mode="pruned", device="cpu")
    per_batch = RetrievalEngine(index, mode="pruned", device="cpu")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        got = list(stream.search_stream(batches, k=5, workers=16, depth=4))
    finally:
        sys.setswitchinterval(interval)
    assert len(got) == len(batches)
    for (gs, gi), b in zip(got, batches):
        ws, wi = per_batch.search_encoded(*index.encode_queries(b), k=5)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)


def test_encode_queries_on_a_fresh_index_from_many_threads():
    """The lazy vocabulary lookup table is published in one assignment:
    threads encoding on a fresh index all see a whole table."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    docs = synth_wiki_docs(300, vocab=100_000, seed=4)
    vocab = {f"w{i}": i for i in range(100_000)}
    queries = [" ".join(f"w{t}" for t in r[r >= 0]) for r in docs[:4]]
    want = BM25Index.build_encoded(docs, vocab).encode_queries(queries)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(12):
            fresh = BM25Index.build_encoded(docs, vocab)
            with ThreadPoolExecutor(16) as ex:
                outs = list(ex.map(lambda _: fresh.encode_queries(queries),
                                   range(16), timeout=60))
            for qt, qw in outs:
                np.testing.assert_array_equal(qt, want[0])
                np.testing.assert_array_equal(qw, want[1])
    finally:
        sys.setswitchinterval(interval)
