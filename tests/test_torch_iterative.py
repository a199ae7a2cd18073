"""The v4 entity-retrieval round and staged fine-tuning in the PyTorch
port against kbner_tpu's (``retrieval/iterative.py``, ``cli
multistage``): the fused records of a round with gold and with predicted
entities, ``strip_context``, each stage's encoder handed to the next, and
a stage-1 encoder exported by the JAX trainer loaded into a port stage.

Inputs are the ``ner_toy`` fixtures and tiny taggers with the same weights
in both packages; JAX runs on the CPU.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data import load_column_corpus as j_load_corpus
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import BM25Params as JParams
from kbner_tpu.retrieval import DocStore as JDocStore
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval import iterative as jiterative
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu.train import TrainConfig as JTrainConfig
from kbner_tpu_torch import checkpoint, cli, weights
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.data.conll import EOS_MARKER, load_column_corpus
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.retrieval.engine import DocStore, RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index, BM25Params
from kbner_tpu_torch.retrieval.iterative import (entity_retrieval_round,
                                                 run_multistage,
                                                 strip_context)
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
# documents of distinct lengths, so no two scores tie (torch.topk and
# lax.top_k order tied documents differently)
DOCS = [
    "Alice Smith is a fictional person",
    "Berlin is the capital and largest city of Germany",
    "Acme Corp is a fictional company",
    "Paris is the capital of France",
    "The European Union is a political union",
]
TITLES = ["Alice Smith", "Berlin", "Acme Corp", "Paris", "European Union"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_corpus(folder="ner_toy"):
    return load_column_corpus(FIX / folder, {0: "text", 1: "ner"},
                              comment_symbol="# id")


def _port_trainer(corpus, tag_dict, seed=0):
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=1000), tag_dict, locked_dropout=0.0,
        word_dropout=0.0)
    return FinetuneTrainer(SequenceTagger(cfg, device="cpu", seed=seed),
                           corpus, HashTokenizer(VOCAB), tag_dict,
                           device="cpu")


def _encoder_tree(trainer):
    return weights.to_jax_params(trainer.model.state_dict(),
                                 trainer.model.config)["params"]["encoder"]


def _max_abs_diff(a, b) -> float:
    """The largest absolute difference of two trees with the same keys."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        return max((_max_abs_diff(a[k], b[k]) for k in a), default=0.0)
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max(initial=0.0))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The ner_toy corpus, one engine over DOCS/TITLES and one tiny tagger
    with the same weights in each package: (jax corpus, jax engine, jax
    trainer, port corpus, port engine, port trainer)."""
    jcorpus = j_load_corpus(FIX / "ner_toy", {0: "text", 1: "ner"},
                            comment_symbol="# id")
    jtags = jcorpus.make_tag_dictionary("ner")
    jcfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=1000), jtags, locked_dropout=0.0,
        word_dropout=0.0)
    batch = j_encode(jcorpus.train[:2], JTokenizer(VOCAB), jtags)
    model, params = init_tagger(
        jcfg, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.arrays().items()})
    rng = np.random.RandomState(3)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    jtrainer = JTrainer(model, jax.tree_util.tree_map(jnp.asarray,
                                                      np_params),
                        jcorpus, JTokenizer(VOCAB), jtags)
    corpus = _port_corpus()
    port = _port_trainer(corpus, corpus.make_tag_dictionary("ner"))
    port.model.load_state_dict(weights.from_jax_params(
        np_params, port.model.config))
    params_idx = dict(quantize_norms=False)
    jengine = JEngine(
        JIndex.build(DOCS, params=JParams(**params_idx), pad_docs_to=8),
        store=JDocStore(sentences=DOCS, titles=TITLES),
        title_index=JIndex.build(TITLES, params=JParams(**params_idx),
                                 pad_docs_to=8),
        use_pallas=False, block_d=8)
    engine = RetrievalEngine(
        BM25Index.build(DOCS, params=BM25Params(**params_idx),
                        pad_docs_to=8),
        store=DocStore(sentences=DOCS, titles=TITLES),
        title_index=BM25Index.build(TITLES, params=BM25Params(**params_idx),
                                    pad_docs_to=8), device="cpu")
    return jcorpus, jengine, jtrainer, corpus, engine, port


def _records(recs):
    return [(r.tokens, r.tags, r.lang_id) for r in recs]


@pytest.mark.parametrize("gold", [True, False])
def test_entity_retrieval_round_matches_jax(both, gold):
    jcorpus, jengine, jtrainer, corpus, engine, port = both
    split = "train" if gold else "dev"
    got = entity_retrieval_round(
        engine, port, getattr(corpus, split), HashTokenizer(VOCAB), k=3,
        use_gold_entities=gold)
    want = jiterative.entity_retrieval_round(
        jengine, jtrainer, getattr(jcorpus, split), JTokenizer(VOCAB), k=3,
        use_gold_entities=gold)
    assert _records(got) == _records(want)
    assert len(got) == len(getattr(corpus, split))
    assert any(EOS_MARKER in r.tokens for r in got)
    if gold:  # the Alice sentence pulls the Alice-titled context
        ctx = got[0].tokens[got[0].eos_index:]
        assert "Alice" in ctx


def test_strip_context_is_idempotent(both):
    _, _, _, corpus, engine, port = both
    fused = entity_retrieval_round(engine, port, corpus.train,
                                   HashTokenizer(VOCAB), k=3,
                                   use_gold_entities=True)
    stripped = strip_context(fused)
    assert _records(stripped) == _records(corpus.train)
    assert _records(strip_context(stripped)) == _records(stripped)
    assert _records(strip_context(corpus.train)) == _records(corpus.train)


def test_run_multistage_hands_each_stage_the_previous_encoder(tmp_path):
    corpus = _port_corpus()
    tags = corpus.make_tag_dictionary("ner")
    loaded = []

    def build_trainer(stage, encoder_init):
        t = _port_trainer(corpus, tags, seed=stage["seed"])
        if encoder_init is not None:
            t.load_encoder(encoder_init)
            loaded.append((str(encoder_init), _max_abs_diff(
                _encoder_tree(t), checkpoint.load(encoder_init))))
        return (t, TrainConfig(learning_rate=1e-3, lr_rate=1.0,
                               batch_size=8, max_epochs=1),
                tmp_path / f"stage{stage['seed']}")

    results = run_multistage([{"seed": 0}, {"seed": 1}, {"seed": 2}],
                             build_trainer)
    assert len(results) == 3
    assert [p for p, _ in loaded] == [
        str(tmp_path / f"stage{s}" / "finetuned-encoder.msgpack")
        for s in (0, 1)]
    assert [d for _, d in loaded] == [0.0, 0.0]
    for s in range(3):
        assert (tmp_path / f"stage{s}" / "finetuned-encoder.msgpack").exists()


def _stage_config(path, target, corpora, **train):
    path.write_text(json.dumps({
        "name": path.stem,
        "corpora": [{"name": name, "data_folder": str(FIX / name),
                     "column_format": {"0": "text", "1": "ner"},
                     "comment_symbol": "# id"} for name in corpora],
        "tag_layer": "ner",
        "tokenizer": {"type": "hash", "vocab_size": VOCAB},
        "model": {"encoder": "tiny", "locked_dropout": 0.0,
                  "word_dropout": 0.0},
        "train": {"learning_rate": 1e-3, "lr_rate": 1.0, "batch_size": 4,
                  "max_epochs": 1, **train},
        "target_dir": str(target)}))
    return path


def test_cli_multistage_two_tiny_stages(tmp_path, monkeypatch):
    """Stage 1 multilingual (en and de, resampled), stage 2 monolingual
    from stage 1's export; stage 2's encoder at load equals the export."""
    s1 = _stage_config(tmp_path / "s1.json", tmp_path / "multi",
                       ["ner_toy", "ner_toy_de"], resample_smooth=0.7,
                       save_finetuned_encoder=True)
    s2 = _stage_config(tmp_path / "s2.json", tmp_path / "mono",
                       ["ner_toy"])
    loaded = []
    load_encoder = FinetuneTrainer.load_encoder

    def spy(self, path):
        load_encoder(self, path)
        loaded.append((Path(path), _max_abs_diff(_encoder_tree(self),
                                                 checkpoint.load(path))))

    monkeypatch.setattr(FinetuneTrainer, "load_encoder", spy)
    results = cli.main(["multistage", str(s1), str(s2), "--device", "cpu"])
    assert len(results) == 2
    assert all(len(r["history"]["train_loss"]) == 1 for r in results)
    assert loaded == [(tmp_path / "multi" / "finetuned-encoder.msgpack",
                       0.0)]
    for d in ("multi", "mono"):
        assert (tmp_path / d / "finetuned-encoder.msgpack").exists()
        assert (tmp_path / d / "best-model.msgpack").exists()
    # the default device is the card: without CUDA it raises
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["multistage", str(s2)])


def test_jax_stage_one_export_loads_into_a_port_stage_two(tmp_path):
    """A two-stage ``run_multistage`` of the port whose first stage is the
    JAX trainer: its exported encoder starts the port's second stage, equal
    to the export at load."""
    jcorpus = j_load_corpus(FIX / "ner_toy", {0: "text", 1: "ner"},
                            comment_symbol="# id")
    jtags = jcorpus.make_tag_dictionary("ner")
    jcfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=1000), jtags, locked_dropout=0.0,
        word_dropout=0.0)
    batch = j_encode(jcorpus.train[:2], JTokenizer(VOCAB), jtags)
    model, params = init_tagger(
        jcfg, jax.random.PRNGKey(5),
        {k: jnp.asarray(v) for k, v in batch.arrays().items()})
    corpus = _port_corpus()
    seen = {}

    def build_trainer(stage, encoder_init):
        if stage == "jax":
            return (JTrainer(model, params, jcorpus, JTokenizer(VOCAB),
                             jtags),
                    JTrainConfig(learning_rate=1e-3, lr_rate=1.0,
                                 batch_size=8, max_epochs=1),
                    tmp_path / "jax")
        t = _port_trainer(corpus, corpus.make_tag_dictionary("ner"), seed=9)
        before = _encoder_tree(t)
        t.load_encoder(encoder_init)
        export = checkpoint.load(encoder_init)
        seen.update(path=encoder_init, diff=_max_abs_diff(
            _encoder_tree(t), export), moved=_max_abs_diff(before, export))
        return (t, TrainConfig(learning_rate=1e-3, lr_rate=1.0,
                               batch_size=8, max_epochs=1),
                tmp_path / "port")

    results = run_multistage(["jax", "port"], build_trainer)
    assert len(results) == 2
    assert seen["path"] == tmp_path / "jax" / "finetuned-encoder.msgpack"
    assert seen["diff"] == 0.0 and seen["moved"] > 0.0
    assert (tmp_path / "port" / "finetuned-encoder.msgpack").exists()


def test_a_json_stage_config_reads_as_json(tmp_path):
    """A stage config written as JSON reads alike with PyYAML or without:
    5e-06 is a number (YAML 1.1 would read it as a string)."""
    path = _stage_config(tmp_path / "s.json", tmp_path / "t", ["ner_toy"],
                         learning_rate=5e-6, resample_smooth=0.7)
    assert "5e-06" in path.read_text()
    train = ExperimentConfig.from_file(path).make_train_config()
    assert train.learning_rate == 5e-6 and train.resample_smooth == 0.7
