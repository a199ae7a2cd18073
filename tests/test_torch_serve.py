"""The PyTorch port's serve path end to end against kbner_tpu's: the
``tests/fixtures/ner_toy`` sentences are searched in a small KB, fused
with their retrieved contexts and tagged by a tiny tagger that holds the
same weights in both packages. The JAX side is what ``kbner_tpu.cli
serve`` runs per micro-batch: ``engine.search`` -> ``fuse_contexts`` ->
``FinetuneTrainer.predict``.
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

from kbner_tpu.data.conll import Corpus, ListCorpus
from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.conll import read_column_file
from kbner_tpu.data.dictionary import Dictionary as JDictionary
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.data.tag_schemes import get_spans as j_get_spans
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval.fusion import fuse_contexts as j_fuse
from kbner_tpu.retrieval.pipeline import build_kb_from_jsonl as j_build_kb
from kbner_tpu.train import FinetuneTrainer
from kbner_tpu_torch import cli
from kbner_tpu_torch.data.dictionary import Dictionary
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.retrieval.engine import RetrievalEngine
from kbner_tpu_torch.retrieval.fusion import fuse_contexts
from kbner_tpu_torch.retrieval.pipeline import (build_kb_from_jsonl,
                                                save_kb)
from kbner_tpu_torch.serve import predict, request_record, serve
from kbner_tpu_torch.weights import from_jax_params

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
# sentences of distinct analyzed lengths (6 to 15 terms), so that BM25
# scores do not tie: torch.topk and lax.top_k order tied documents
# differently, and the fused token lists are compared in order
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


def _requests():
    recs = []
    for split in ("train", "dev", "test"):
        recs += read_column_file(FIX / "ner_toy" / f"{split}.txt",
                                 {0: "text", 1: "ner"},
                                 comment_symbol="# id")
    reqs = [{"id": i, "tokens": r.tokens} for i, r in enumerate(recs)]
    # a text request, and one past the 512-subtoken budget: its last words
    # are cut off and come back as O
    reqs.append({"id": "text", "text": "Alice met Bob in Paris ."})
    reqs.append({"id": "long", "tokens": ["Berlin", "extraordinary"] * 200})
    return reqs


@pytest.fixture(scope="module")
def both(kb_path):
    """The two pipelines with the same weights: (port tagger, port engine,
    port tag dictionary, jax trainer, jax engine, jax tag dictionary)."""
    j_tags = JDictionary.from_items(
        ["O", "B-PER", "E-PER", "S-LOC", "B-ORG", "I-ORG", "E-ORG", "S-PER",
         "B-LOC", "E-LOC", "S-ORG", "<START>", "<STOP>"])
    j_tok = JTokenizer(vocab_size=VOCAB)
    j_cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB, max_position_embeddings=514),
        j_tags, locked_dropout=0.0, word_dropout=0.0)
    example = j_encode([JRecord(tokens=["x"], tags={"ner": ["O"]})], j_tok)
    model, params = init_tagger(
        j_cfg, jax.random.PRNGKey(1),
        {k: jnp.asarray(v) for k, v in example.arrays().items()})
    rng = np.random.RandomState(1)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    empty = ListCorpus([Corpus(train=[], dev=[], test=[], name="serve")])
    trainer = FinetuneTrainer(
        model, jax.tree_util.tree_map(jnp.asarray, np_params), empty, j_tok,
        j_tags, tag_layer="ner")
    text, store, title = j_build_kb(kb_path)
    j_engine = JEngine(text, store=store, title_index=title,
                       use_pallas=False)

    tags = Dictionary.load(_save(j_tags, kb_path.parent / "tags.json"))
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB, max_position_embeddings=514), tags)
    tagger = SequenceTagger(cfg, device="cpu").eval()
    tagger.load_state_dict(from_jax_params(np_params, cfg), strict=True)
    text, store, title = build_kb_from_jsonl(kb_path)
    engine = RetrievalEngine(text, store=store, title_index=title,
                             device="cpu")
    return tagger, engine, tags, trainer, j_engine, j_tags


def _save(dictionary, path):
    dictionary.save(path)
    return path


@pytest.mark.parametrize("mode", ["sentence_link", "paragraph"])
def test_fused_records_match_jax(both, mode):
    _, engine, _, _, j_engine, _ = both
    reqs = _requests()
    orig = [request_record(r) for r in reqs]
    j_orig = [JRecord(tokens=r.tokens, tags=r.tags) for r in orig]
    queries = [" ".join(r.tokens) for r in orig]
    results = engine.search(queries, k=4)
    for docs in results:  # the fixture has no ties to order
        scores = [d.score for d in docs]
        assert len(set(scores)) == len(scores)
    fused = fuse_contexts(orig, results, HashTokenizer(VOCAB), mode=mode)
    j_fused = j_fuse(j_orig, j_engine.search(queries, k=4),
                     JTokenizer(VOCAB), mode=mode)
    assert [r.tokens for r in fused] == [r.tokens for r in j_fused]
    assert [r.tags for r in fused] == [r.tags for r in j_fused]
    n_ctx = sum("<EOS>" in r.tokens for r in fused)
    assert 0 < n_ctx < len(fused)  # the long request gets no context


def test_serve_matches_jax_pipeline(both):
    tagger, engine, tags, trainer, j_engine, _ = both
    reqs = _requests()
    got = serve(reqs, engine, tagger, HashTokenizer(VOCAB), tags, k=4,
                batch_size=4)

    orig = [JRecord(tokens=r.tokens, tags=r.tags)
            for r in map(request_record, reqs)]
    results = j_engine.search([" ".join(r.tokens) for r in orig], k=4)
    fused = j_fuse(orig, results, JTokenizer(VOCAB))
    preds = trainer.predict(fused, batch_size=4)
    assert [r["id"] for r in got] == [r["id"] for r in reqs]
    for resp, rec, pred in zip(got, orig, preds):
        want = pred[:len(rec.tokens)]
        assert resp["tokens"] == rec.tokens
        assert resp["tags"] == want
        assert resp["spans"] == [
            {"start": s.start, "end": s.end, "label": s.label}
            for s in j_get_spans(want, ignore_labels=("X",))]
    long_tags = got[-1]["tags"]
    assert len(long_tags) == 400 and long_tags[-1] == "O"


def test_predict_refills_context_with_x(both):
    tagger, _, tags, trainer, _, _ = both
    recs = [request_record({"tokens": ["Alice", "met", "<EOS>", "Bob",
                                       "works"]})]
    got = predict(recs, tagger, HashTokenizer(VOCAB), tags)
    want = trainer.predict([JRecord(tokens=r.tokens, tags=r.tags)
                            for r in recs])
    assert got == want and got[0][2:] == ["S-X"] * 3


def _write_config(tmp_path, target):
    cfg = {"name": "toy", "tag_layer": "ner",
           "tokenizer": {"type": "hash", "vocab_size": VOCAB},
           "model": {"encoder": "tiny", "use_crf": True},
           "train": {"batch_size": 4}, "target_dir": str(target)}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_cli_serve_writes_serve_responses(both, kb_path, tmp_path, capsys,
                                          monkeypatch):
    _, _, tags, _, _, _ = both
    target = tmp_path / "run"
    tags.save(target / "tag_dictionary.json")
    cfg = _write_config(tmp_path, target)
    reqs = _requests()[:6]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "\n".join(json.dumps(r) for r in reqs) + "\n\n"))
    cli.main(["serve", "--config", str(cfg), "--kb", str(kb_path),
              "--device", "cpu", "--batch_size", "4", "--k", "3"])
    out = [json.loads(line)
           for line in capsys.readouterr().out.strip().splitlines()]

    # what the CLI builds: the config's tiny encoder cut to the hash
    # vocabulary, random weights from seed 0
    tagger = SequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags), device="cpu").eval()
    text, store, title = build_kb_from_jsonl(kb_path)
    engine = RetrievalEngine(text, store=store, title_index=title,
                             device="cpu")
    want = []
    for i in range(0, len(reqs), 4):
        want += serve(reqs[i:i + 4], engine, tagger, HashTokenizer(VOCAB),
                      tags, k=3, batch_size=4)
    assert out == json.loads(json.dumps(want))


@pytest.mark.parametrize("argv,err", [
    # a sharded engine is not a mode of the port (ROADMAP A6, multi-GPU)
    (["--engine_mode", "sharded"], ValueError),
    # an HF tokenizer without its dir, a KeyError as in kbner_tpu
    (["--config", "hf.yaml"], KeyError),
    # a zh KB saved with an IK dictionary that has gone missing
    (["--index_dir", "kb_dir"], FileNotFoundError),
])
def test_cli_serve_refuses_later_slices(both, kb_path, tmp_path, monkeypatch,
                                        argv, err):
    """What cli serve still refuses. (zh KBs, --store and --index_dir are
    served: tests/test_torch_zh.py, test_torch_retrieve.py; HF tokenizers
    with their dir: the test below.)"""
    _, _, tags, _, _, _ = both
    target = tmp_path / "run"
    tags.save(target / "tag_dictionary.json")
    cfg = _write_config(tmp_path, target)
    hf = yaml.safe_load(cfg.read_text())
    hf["tokenizer"] = {"type": "hf"}
    (tmp_path / "hf.yaml").write_text(yaml.safe_dump(hf))
    text, store, title = build_kb_from_jsonl(kb_path)
    save_kb(tmp_path / "kb_dir", text, store, title)
    (tmp_path / "kb_dir" / "meta.json").write_text(
        '{"lang": "zh", "ik_dict": "ik.dic"}')
    argv = [str(tmp_path / a) if a in ("hf.yaml", "kb_dir") else a
            for a in argv]
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    with pytest.raises(err):
        cli.main(["serve", "--config", str(cfg), "--kb", str(kb_path),
                  "--device", "cpu", *argv])


def test_cli_serve_hf_tokenizer_matches_jax_cli(both, tmp_path, capsys,
                                                monkeypatch):
    """``tokenizer: {type: hf, dir: DIR}``: both CLIs serve the same
    answers from one checkpoint (the JAX CLI's tiny tagger, its weights
    moved off their draw) over a 1,000-id XLM-R-shaped tokenizer, whose
    ids index the tiny encoder's own 1,000-row table as they stand."""
    from kbner_tpu import cli as j_cli
    from kbner_tpu.config import ExperimentConfig as JExperimentConfig
    from kbner_tpu_torch.data.synth_tokenizer import \
        write_xlmr_like_tokenizer

    _, _, tags, _, _, _ = both
    tok = write_xlmr_like_tokenizer(tmp_path / "tok", n_pieces=995, seed=0)
    target = tmp_path / "run"
    tags.save(target / "tag_dictionary.json")
    raw = yaml.safe_load(_write_config(tmp_path, target).read_text())
    raw.update(tokenizer={"type": "hf", "dir": str(tok)}, corpora=[])
    cfg = tmp_path / "hf.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    _, _, _, trainer = j_cli._build_for_inference(
        JExperimentConfig.from_file(cfg))
    rng = np.random.RandomState(5)
    trainer.params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + 0.1 * rng.standard_normal(
            x.shape).astype(np.float32)), trainer.params)
    trainer.save(target / "best-model.msgpack")
    # without a KB: the tiny encoder has 128 positions, fewer than a
    # fused sentence takes in pieces this small (cli retrieve's fusion
    # through the HF tokenizer is held to the JAX CLI's in
    # tests/test_torch_retrieve.py)
    reqs = _requests()[:-1]
    stdin = "\n".join(json.dumps(r) for r in reqs) + "\n"
    outs = []
    for main, extra in ((cli.main, ["--device", "cpu"]), (j_cli.main, [])):
        monkeypatch.setattr("sys.stdin", io.StringIO(stdin))
        main(["serve", "--config", str(cfg), "--batch_size", "4", *extra])
        outs.append([json.loads(line) for line in
                     capsys.readouterr().out.strip().splitlines()])
    assert len(outs[0]) == len(reqs)
    assert outs[0] == outs[1]
    assert any(s for r in outs[0] for s in r["spans"])


def test_cli_serve_needs_the_tag_dictionary(tmp_path):
    cfg = _write_config(tmp_path, tmp_path / "missing")
    with pytest.raises(ValueError, match="tag_dictionary.json"):
        cli.main(["serve", "--config", str(cfg), "--device", "cpu"])
