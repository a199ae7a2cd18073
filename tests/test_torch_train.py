"""The PyTorch port's training path against kbner_tpu's: the optimizer
against optax, a trainer run against the JAX trainer's, Flax checkpoints
in both directions, the CLI's train/test/parse/serve on a trained model,
the quality gate, and each dropout's rate, shape and scaling.

Tolerances: parameters after optimizer updates rtol 1e-5 (float32 Adam
in another operation order); after a trainer run, whose gradients come
through float32 forward and backward passes of two frameworks, rtol 1e-5
with atol 1e-7.
"""

import io
import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu.train import TrainConfig as JTrainConfig
from kbner_tpu.train.optim import make_finetune_optimizer as j_make_opt
from kbner_tpu_torch import checkpoint, cli, weights
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.data import quality_fixture
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig, XLMREncoder, dropout
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
from kbner_tpu_torch.train.parser_trainer import ParserTrainer
from kbner_tpu_torch.train.optim import (inverse_sqrt_schedule,
                                         linear_warmup_linear_decay,
                                         make_finetune_optimizer)
from kbner_tpu.train.optim import inverse_sqrt_schedule as j_inv_sqrt
from kbner_tpu.train.optim import linear_warmup_linear_decay as j_linear

VOCAB = 997


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the optimizer against optax -----------------------------------------------

def _param_tree(rng):
    return {"encoder": {"w": rng.randn(4, 3).astype(np.float32),
                        "b": rng.randn(3).astype(np.float32)},
            "emission": {"kernel": rng.randn(3, 5).astype(np.float32)},
            "transitions": rng.randn(5, 5).astype(np.float32)}


def _named(tree):
    return [("encoder.w", tree["encoder"]["w"]),
            ("encoder.b", tree["encoder"]["b"]),
            ("emission.kernel", tree["emission"]["kernel"]),
            ("transitions", tree["transitions"])]


def test_schedules_match_optax():
    for peak, warm, total in ((1e-3, 0, 10), (5e-2, 3, 10), (1.0, 4, 4)):
        got = linear_warmup_linear_decay(peak, warm, total)
        want = j_linear(peak, warm, total)
        for c in range(total + 3):
            np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6,
                                       atol=1e-12)
    got, want = inverse_sqrt_schedule(2e-3, 5), j_inv_sqrt(2e-3, 5)
    for c in range(12):
        np.testing.assert_allclose(got(c), float(want(c)), rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(accumulation_steps=1),
    dict(accumulation_steps=2),
    dict(accumulation_steps=2, weight_decay=0.01, use_inverse_sqrt=True),
    dict(accumulation_steps=1, mu_dtype="bf16"),
])
def test_optimizer_steps_match_optax(kw):
    """Six micro-steps: a warmup whose first update has lr 0, two groups
    (the head at lr * lr_rate), clipping active (the gradients' global
    norm is about 14 against a clip of 1), the encoder frozen on the
    first two micro-steps, and MultiSteps accumulation."""
    kw = dict(kw)
    bf16 = kw.pop("mu_dtype", None) == "bf16"
    rng = np.random.RandomState(0)
    tree = _param_tree(rng)
    opts = dict(lr=1e-2, lr_rate=10.0, warmup_steps=2, total_steps=6,
                grad_clip=1.0, **kw)
    tx = j_make_opt(tree, mu_dtype=jnp.bfloat16 if bf16 else None, **opts)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(j_params)
    params = {n: torch.nn.Parameter(torch.tensor(a))
              for n, a in _named(tree)}
    opt = make_finetune_optimizer(
        params.items(), mu_dtype=torch.bfloat16 if bf16 else None, **opts)
    for step in range(6):
        grads = jax.tree_util.tree_map(
            lambda x: (4.0 * rng.randn(*x.shape)).astype(np.float32), tree)
        if step < 2:  # first-epoch freezing, as the trainers apply it
            grads["encoder"] = jax.tree_util.tree_map(
                lambda g: g * 0.0, grads["encoder"])
        updates, state = tx.update(
            jax.tree_util.tree_map(jnp.asarray, grads), state, j_params)
        j_params = optax.apply_updates(j_params, updates)
        for n, g in _named(grads):
            params[n].grad = torch.tensor(g)
        opt.step()
        for n, want in _named(jax.tree_util.tree_map(np.asarray, j_params)):
            np.testing.assert_allclose(params[n].detach().numpy(), want,
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"{n} after step {step}")
    k = kw["accumulation_steps"]
    assert opt.count == 6 // k
    if bf16:
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)


# -- a trainer run against the JAX trainer -------------------------------------

def _jax_tagger(corpus, tag_dict, seed=0):
    cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB), tag_dict, locked_dropout=0.0,
        word_dropout=0.0)
    eb = j_encode(corpus.train[:2], JTokenizer(VOCAB), tag_dict)
    return init_tagger(cfg, jax.random.PRNGKey(seed),
                       {k: jnp.asarray(v) for k, v in eb.arrays().items()})


def _port_tagger(tag_dict, **kw):
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB, **kw), tag_dict,
        locked_dropout=0.0, word_dropout=0.0)
    return SequenceTagger(cfg, device="cpu", seed=0)


@pytest.fixture(scope="module")
def trained_pair(tmp_path_factory):
    """Both trainers run one epoch (4 batches: the first update at lr 0,
    then three) from the same initial weights, dropout off."""
    jcorpus = jquality.make_quality_corpus(28, 6, 8, seed=2)
    corpus = quality_fixture.make_quality_corpus(28, 6, 8, seed=2)
    jtags = jcorpus.make_tag_dictionary("ner")
    tags = corpus.make_tag_dictionary("ner")
    model, params = _jax_tagger(jcorpus, jtags)
    tagger = _port_tagger(tags)
    tagger.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tagger.config))
    kw = dict(learning_rate=1e-3, lr_rate=3.0, batch_size=8, max_epochs=1,
              warmup_fraction=0.0, seed=4)
    jdir, pdir = tmp_path_factory.mktemp("jax"), tmp_path_factory.mktemp("pt")
    init = jax.tree_util.tree_map(np.array, params)  # train donates params
    jt = JTrainer(model, params, jcorpus, JTokenizer(VOCAB), jtags)
    j_result = jt.train(jdir, JTrainConfig(**kw))
    pt = FinetuneTrainer(tagger, corpus, HashTokenizer(VOCAB), tags,
                         device="cpu")
    p_result = pt.train(pdir, TrainConfig(**kw))
    return SimpleNamespace(jt=jt, pt=pt, jdir=jdir, pdir=pdir,
                           j_result=j_result, p_result=p_result,
                           corpus=corpus, jcorpus=jcorpus, init=init)


def test_trainer_run_matches_jax_trainer(trained_pair):
    jt, pt, jdir, pdir = (trained_pair.jt, trained_pair.pt,
                          trained_pair.jdir, trained_pair.pdir)
    j_result, p_result = trained_pair.j_result, trained_pair.p_result
    want = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.params), pt.model.config)
    init = weights.from_jax_params(trained_pair.init, pt.model.config)
    moved = 0
    for name, p in pt.model.state_dict().items():
        if name.endswith("attention.key.bias"):
            # its gradient is 0 in exact arithmetic (it shifts every score
            # of a softmax row alike), so Adam turns each framework's
            # rounding noise into a step of up to lr: both stay within the
            # three steps' reach of the start
            for x in (p, want[name]):
                assert float((x - init[name]).abs().max()) <= 3 * 1e-3 * 1.01
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        moved += int(not torch.equal(p, init[name]))
    assert moved > 0
    np.testing.assert_allclose(p_result["history"]["train_loss"],
                               j_result["history"]["train_loss"], rtol=1e-5)
    assert p_result["history"]["dev_score"] == \
        j_result["history"]["dev_score"]
    for name in ("loss.tsv", "history.json", "best-model.msgpack",
                 "final-model.msgpack", "tag_dictionary.json"):
        assert (pdir / name).exists() and (jdir / name).exists(), name
    assert json.loads((pdir / "tag_dictionary.json").read_text()) == \
        json.loads((jdir / "tag_dictionary.json").read_text())


def test_recipe_head_lr_run_matches_jax_trainer(tmp_path):
    """The recipe's schedule (lr 5e-6, the head at x10000, warmup 0.1,
    batch 16, three epochs) from the same Flax-drawn weights, dropout off:
    both packages' epoch mean losses agree at rtol 1e-5, and their
    updated parameters at rtol 1e-4, atol 1e-6 (the key biases within one
    Adam step per update of the start, as in
    test_trainer_run_matches_jax_trainer). The epoch means are not
    monotone in the reference either: the head's lr of 0.05 overshoots in
    the second epoch, so a falling epoch mean is no test of this
    recipe's learning from random weights."""
    jcorpus = jquality.make_quality_corpus(64, 4, 4, seed=2)
    corpus = quality_fixture.make_quality_corpus(64, 4, 4, seed=2)
    jtags = jcorpus.make_tag_dictionary("ner")
    tags = corpus.make_tag_dictionary("ner")
    model, params = _jax_tagger(jcorpus, jtags)
    tagger = _port_tagger(tags)
    tagger.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), tagger.config))
    init = {n: p.clone() for n, p in tagger.state_dict().items()}
    kw = dict(learning_rate=5e-6, lr_rate=10000.0, warmup_fraction=0.1,
              batch_size=16, max_epochs=3, seed=4)
    jt = JTrainer(model, params, jcorpus, JTokenizer(VOCAB), jtags)
    j_loss = jt.train(tmp_path / "jax",
                      JTrainConfig(**kw))["history"]["train_loss"]
    pt = FinetuneTrainer(tagger, corpus, HashTokenizer(VOCAB), tags,
                         device="cpu")
    p_loss = pt.train(tmp_path / "pt",
                      TrainConfig(**kw))["history"]["train_loss"]
    np.testing.assert_allclose(p_loss, j_loss, rtol=1e-5)
    assert j_loss[1] > j_loss[0]
    want = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.params), tagger.config)
    for name, p in pt.model.state_dict().items():
        if name.endswith("attention.key.bias"):
            for x in (p, want[name]):
                assert float((x - init[name]).abs().max()) <= \
                    12 * 5e-6 * 1.01, name
            continue
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_checkpoints_cross_both_ways(trained_pair, tmp_path):
    """best-model.msgpack of either package: the same tree layout, and
    the other package loads it and decodes the same tags."""
    jt, pt, jdir, pdir = (trained_pair.jt, trained_pair.pt,
                          trained_pair.jdir, trained_pair.pdir)
    corpus, jcorpus = trained_pair.corpus, trained_pair.jcorpus
    j_bytes = (jdir / "best-model.msgpack").read_bytes()
    p_bytes = (pdir / "best-model.msgpack").read_bytes()
    j_tree = serialization.msgpack_restore(j_bytes)
    p_tree = serialization.msgpack_restore(p_bytes)
    assert jax.tree_util.tree_structure(j_tree) == \
        jax.tree_util.tree_structure(p_tree)
    # the JAX trainer reads the port's file ...
    model, params = _jax_tagger(jcorpus, jt.tag_dict, seed=9)
    reader = JTrainer(model, params, jcorpus, JTokenizer(VOCAB), jt.tag_dict)
    reader.load(pdir / "best-model.msgpack")
    for a, b in zip(jax.tree_util.tree_leaves(reader.params),
                    jax.tree_util.tree_leaves(p_tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    test = corpus.test_list[0]
    assert reader.predict(jcorpus.test_list[0]) == pt.predict(test)
    # ... and the port reads the JAX trainer's
    port_reader = FinetuneTrainer(_port_tagger(pt.tag_dict), corpus,
                                  HashTokenizer(VOCAB), pt.tag_dict,
                                  device="cpu")
    port_reader.load(jdir / "best-model.msgpack")
    want = weights.from_jax_params(j_tree, port_reader.model.config)
    for name, p in port_reader.model.state_dict().items():
        assert torch.equal(p, want[name]), name
    assert port_reader.predict(test) == jt.predict(jcorpus.test_list[0])
    # the encoder export, in the layout save_encoder writes
    pt.save_encoder(tmp_path / "enc.msgpack")
    jt.save_encoder(tmp_path / "jenc.msgpack")
    enc = checkpoint.load(tmp_path / "enc.msgpack")
    jenc = serialization.msgpack_restore(
        (tmp_path / "jenc.msgpack").read_bytes())
    assert jax.tree_util.tree_structure(enc) == \
        jax.tree_util.tree_structure(jenc)
    port_reader.load_encoder(tmp_path / "jenc.msgpack")


def test_codec_writes_flax_bytes_and_chunks(monkeypatch):
    """The port writes the bytes flax writes, chunked form included
    (forced at a small size), and reads flax's chunked bytes."""
    rng = np.random.RandomState(3)
    tree = {"params": {"a": rng.randn(40, 30).astype(np.float32),
                       "n": {"i": rng.randint(0, 9, size=(7,)),
                             "s": np.float32(1.5)}},
            "meta": "x" * 300, "k": 70000, "f": -2.5, "t": True,
            "none": None, "c": 1 - 2j}
    assert checkpoint.dumps(tree) == serialization.msgpack_serialize(tree)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 1000)
    flax_chunked = serialization.msgpack_serialize(tree)
    ours = checkpoint.dumps(tree, max_chunk_bytes=1000)
    assert ours == flax_chunked
    assert b"__msgpack_chunked_array__" in ours
    back = checkpoint.loads(flax_chunked)
    np.testing.assert_array_equal(back["params"]["a"], tree["params"]["a"])
    np.testing.assert_array_equal(
        serialization.msgpack_restore(ours)["params"]["a"],
        tree["params"]["a"])
    assert back["c"] == tree["c"] and back["k"] == 70000


def test_codec_reads_bfloat16_and_tensors():
    x = jnp.asarray(np.random.RandomState(0).randn(3, 4), jnp.bfloat16)
    data = serialization.msgpack_serialize({"w": np.asarray(x)})
    got = checkpoint.loads(data)["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))
    assert checkpoint.dumps({"w": got}) == data


# -- the CLI ---------------------------------------------------------------------

def _toy_config(fixtures_path, tmp_path, **model):
    raw = yaml.safe_load((fixtures_path / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(fixtures_path / "ner_toy")
    raw["target_dir"] = str(tmp_path / "run")
    raw["train"].update(max_epochs=3)
    raw["model"].update(model)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path, tmp_path / "run"


def test_cli_train_test_parse_and_serve(fixtures_path, tmp_path, capsys,
                                        monkeypatch):
    cfg, run = _toy_config(fixtures_path, tmp_path)
    cli.main(["train", "--config", str(cfg), "--device", "cpu"])
    for name in ("best-model.msgpack", "final-model.msgpack", "loss.tsv",
                 "history.json", "test_results.json", "test.TOY.tsv",
                 "training.log"):
        assert (run / name).exists(), name
    capsys.readouterr()
    cli.main(["test", "--config", str(cfg), "--device", "cpu"])
    results = json.loads(capsys.readouterr().out)
    assert set(results) == {"TOY"}
    assert results == json.loads((run / "test_results.json").read_text())

    out = tmp_path / "parsed"
    cli.main(["parse", "--config", str(cfg), "--device", "cpu",
              "--target_dir", str(fixtures_path / "ner_toy"),
              "--out_dir", str(out), "--keep_order", "--save_embedding"])
    assert sorted(p.name for p in out.iterdir()) == [
        "dev.conllu", "test.conllu", "train.conllu"]
    assert (run / "finetuned-encoder.msgpack").exists()

    # the trained checkpoint, decoded by the trainer and served by the CLI
    config = ExperimentConfig.from_file(cfg)
    trainer = cli._build(config, "cpu")
    trainer.load(run / "best-model.msgpack")
    test = config.load_corpus().test_list[0]
    reqs = [{"id": i, "tokens": r.tokens} for i, r in enumerate(test)]
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "\n".join(json.dumps(r) for r in reqs) + "\n"))
    cli.main(["serve", "--config", str(cfg), "--device", "cpu"])
    served = [json.loads(line)
              for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["tags"] for r in served] == trainer.predict(test)
    parsed = (out / "test.conllu").read_text().split("\n\n")
    assert [[line.split()[1] for line in block.splitlines()
             if not line.startswith("#")] for block in parsed if block.strip()
            ] == trainer.predict(test)


def test_cli_serve_answers_with_a_jax_checkpoint(trained_pair, tmp_path,
                                                  capsys, monkeypatch):
    jt, jdir = trained_pair.jt, trained_pair.jdir
    corpus, jcorpus = trained_pair.corpus, trained_pair.jcorpus
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "name": "q", "tokenizer": {"type": "hash", "vocab_size": VOCAB},
        "model": {"encoder": "tiny"}, "target_dir": str(jdir)}))
    test = corpus.test_list[0]
    monkeypatch.setattr("sys.stdin", io.StringIO("\n".join(
        json.dumps({"id": i, "text": " ".join(r.tokens)})
        for i, r in enumerate(test))))
    cli.main(["serve", "--config", str(cfg), "--device", "cpu",
              "--batch_size", "3"])
    served = [json.loads(line)
              for line in capsys.readouterr().out.strip().splitlines()]
    assert [r["tags"] for r in served] == jt.predict(jcorpus.test_list[0])


def test_config_refusals(fixtures_path, tmp_path):
    """Unknown keys, trainers and targets raise; a device mesh still
    raises naming ROADMAP A6. What used to raise here runs: document
    windows, the distillation trainer's student, the parser target,
    conllu corpora and stride windows."""
    raw = yaml.safe_load((fixtures_path / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(fixtures_path / "ner_toy")
    with pytest.raises(ValueError, match="unknown config keys"):
        ExperimentConfig.from_dict({**raw, "trian": {}})
    with pytest.raises(ValueError, match="unknown train keys"):
        ExperimentConfig.from_dict(
            {**raw, "train": {"learing_rate": 1.0}}).make_train_config()
    with pytest.raises(ValueError, match="unknown trainer"):
        ExperimentConfig.from_dict({**raw, "trainer": "Nope"})
    cfg = ExperimentConfig.from_dict({**raw, "data": {"doc_context": True}})
    corpus = cfg.prepare_corpus(cfg.load_corpus(), HashTokenizer(VOCAB))
    assert any("S-X" in r.tags["ner"] for r in corpus.train)
    student = cli._build(ExperimentConfig.from_dict(
        {**raw, "trainer": "ModelDistiller"}), "cpu")
    assert isinstance(student, FinetuneTrainer)
    parser = cli._build_parser(ExperimentConfig.from_dict(
        {**raw, "targets": "dependency"}), "cpu")[3]
    assert isinstance(parser, ParserTrainer)
    with pytest.raises(ValueError, match="unknown targets"):
        cli._build_parser(ExperimentConfig.from_dict(
            {**raw, "targets": "constituency"}), "cpu")
    conllu = dict(raw, corpora=[{"name": "UD", "data_folder": "x",
                                 "format": "conllu"}])
    spec = ExperimentConfig.from_dict(conllu).corpora[0]
    assert (spec.format, spec.train_file) == ("conllu", "train.conllu")
    enc = ExperimentConfig.from_dict(raw).make_train_encoder_config(
        HashTokenizer(VOCAB))
    assert enc.param_dtype == torch.float32 and enc.vocab_size == VOCAB
    tags = quality_fixture.make_quality_corpus(8, 2, 2).make_tag_dictionary(
        "ner")
    strided = FinetuneTrainer(_port_tagger(tags), quality_fixture
                              .make_quality_corpus(8, 2, 2),
                              HashTokenizer(VOCAB), tags,
                              stride_windows=True, stride_max_subtokens=6,
                              stride_words=1, device="cpu")
    assert len(strided._epoch_records(TrainConfig(), 0)) > 8
    with pytest.raises(TypeError, match="DeviceMesh"):
        FinetuneTrainer(_port_tagger(tags), quality_fixture
                        .make_quality_corpus(8, 2, 2), HashTokenizer(VOCAB),
                        tags, mesh=object(), device="cpu")


def test_checkpoint_resume_and_interrupt(tmp_path, monkeypatch):
    """checkpoint: true writes checkpoint.msgpack (the JAX trainer's
    blob) each epoch; resume: true picks up after its epoch with the same
    history; an interrupt saves final-model.msgpack and re-raises."""
    corpus = quality_fixture.make_quality_corpus(16, 4, 4, seed=1)
    tags = corpus.make_tag_dictionary("ner")
    kw = dict(learning_rate=1e-3, lr_rate=1.0, batch_size=8, seed=1,
              checkpoint=True)
    full = FinetuneTrainer(_port_tagger(tags), corpus, HashTokenizer(VOCAB),
                           tags, device="cpu")
    want = full.train(tmp_path / "full", TrainConfig(max_epochs=2, **kw))
    half = FinetuneTrainer(_port_tagger(tags), corpus, HashTokenizer(VOCAB),
                           tags, device="cpu")
    half.train(tmp_path / "half", TrainConfig(max_epochs=1, **kw))
    resumed = FinetuneTrainer(_port_tagger(tags), corpus,
                              HashTokenizer(VOCAB), tags, device="cpu")
    # the horizon of a two-epoch run, resumed after epoch 1
    got = resumed.train(tmp_path / "half",
                        TrainConfig(max_epochs=2, resume=True, **kw))
    assert len(got["history"]["train_loss"]) == 2
    assert got["history"]["train_loss"][0] == \
        want["history"]["train_loss"][0]
    blob = checkpoint.load(tmp_path / "half" / "checkpoint.msgpack")
    assert set(blob) == {"params", "opt_state", "meta"}
    assert json.loads(blob["meta"])["epoch"] == 1
    assert not (tmp_path / "half" / "checkpoint.pt").exists()

    def interrupt(*args, **kwargs):
        raise KeyboardInterrupt

    stopped = FinetuneTrainer(_port_tagger(tags), corpus,
                              HashTokenizer(VOCAB), tags, device="cpu")
    monkeypatch.setattr(stopped, "train_step", interrupt)
    with pytest.raises(KeyboardInterrupt):
        stopped.train(tmp_path / "stop", TrainConfig(max_epochs=1, **kw))
    assert (tmp_path / "stop" / "final-model.msgpack").exists()


def test_profile_window_writes_a_trace(tmp_path):
    corpus = quality_fixture.make_quality_corpus(24, 4, 4, seed=1)
    tags = corpus.make_tag_dictionary("ner")
    trainer = FinetuneTrainer(_port_tagger(tags), corpus,
                              HashTokenizer(VOCAB), tags, device="cpu")
    trainer.train(tmp_path, TrainConfig(batch_size=8, max_epochs=1,
                                        profile_steps=1, profile_start=1))
    assert (tmp_path / "profile" / "trace.json").stat().st_size > 0


# -- the quality gate and mixed precision ------------------------------------------

def test_quality_gate_f1():
    """The port's trainer learns the pattern corpus to held-out span F1
    >= 0.95, the bar tests/test_quality_gate.py holds the JAX trainer to."""
    assert quality_fixture.run_quality_gate(device="cpu") >= 0.95


def test_bfloat16_compute_keeps_float32_master_parameters():
    """bfloat16 activations over float32 parameters: an encoder lr of
    1e-6 moves the float32 masters, an update bfloat16 storage would
    lose (its spacing near 0.02 is 1.2e-4)."""
    corpus = quality_fixture.make_quality_corpus(8, 2, 2, seed=3)
    tags = corpus.make_tag_dictionary("ner")
    tagger = _port_tagger(tags, dtype=torch.bfloat16,
                          param_dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in tagger.named_parameters()}
    trainer = FinetuneTrainer(tagger, corpus, HashTokenizer(VOCAB), tags,
                              device="cpu")
    cfg = TrainConfig(learning_rate=1e-6, lr_rate=1.0, batch_size=4,
                      use_inverse_sqrt=True)
    batch = trainer._make_train_batches(corpus.train, cfg, 0)[0]
    with torch.no_grad():
        hidden = tagger.encoder(*(torch.from_numpy(x) for x in (
            batch.input_ids, batch.attention_mask)))
    assert hidden.dtype == torch.bfloat16
    loss = trainer.train_step(batch, trainer.make_optimizer(cfg), cfg, None)
    assert bool(torch.isfinite(loss))
    w = tagger.encoder.layers[0].intermediate.weight
    assert all(p.dtype == torch.float32 for p in tagger.parameters())
    moved = (w.detach() != before["encoder.layers.0.intermediate.weight"])
    assert moved.float().mean() > 0.5
    assert bool((w.detach().to(torch.bfloat16).float()
                 == before["encoder.layers.0.intermediate.weight"]
                 .to(torch.bfloat16).float()).float().mean() > 0.9)


# -- dropout -------------------------------------------------------------------------

def test_dropout_rate_and_scaling():
    x = torch.rand(200, 500) + 0.5
    g = torch.Generator().manual_seed(0)
    y = dropout(x, 0.1, g)
    kept = y != 0
    assert abs(1 - float(kept.float().mean()) - 0.1) < 0.005
    torch.testing.assert_close(y[kept], x[kept] / 0.9)
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, g) is x
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    assert torch.equal(dropout(x, 0.3, g1), dropout(x, 0.3, g2))


def test_encoder_dropout_sites():
    """Hidden and attention dropout change the output only with a
    generator; the same seed gives the same output."""
    torch.manual_seed(0)
    enc = XLMREncoder(XLMRConfig.tiny(hidden_dropout=0.1,
                                      attention_dropout=0.1))
    ids = torch.randint(4, 1000, (2, 9))
    mask = torch.ones(2, 9, dtype=torch.long)
    plain = enc(ids, mask)
    a = enc(ids, mask, rng=torch.Generator().manual_seed(1))
    b = enc(ids, mask, rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, plain)
    assert torch.equal(plain, enc(ids, mask))


def _dropout_tagger(**kw):
    tags = quality_fixture.make_quality_corpus(8, 2, 2).make_tag_dictionary(
        "ner")
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags, relearn_embeddings=False,
        **kw)
    corpus = quality_fixture.make_quality_corpus(64, 2, 2, seed=4)
    eb = j_encode_port(corpus.train, tags)
    return SequenceTagger(cfg, device="cpu", seed=0), eb


def j_encode_port(records, tags):
    from kbner_tpu_torch.data.encode import encode_batch

    arrays = encode_batch(records, HashTokenizer(VOCAB), tags).arrays()
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def test_word_dropout_zeroes_whole_words_without_rescaling():
    tagger, batch = _dropout_tagger(word_dropout=0.25, locked_dropout=0.0)
    with torch.no_grad():
        det = tagger._word_features(batch)
        got = tagger._word_features(batch, torch.Generator().manual_seed(2))
    words = batch["word_mask"].bool()
    zero = (got == 0).all(-1) & words
    same = (got == det).all(-1) & words
    assert bool((zero | same)[words].all())
    assert abs(float(zero[words].float().mean()) - 0.25) < 0.05


def test_locked_dropout_one_mask_per_sentence_and_channel():
    tagger, batch = _dropout_tagger(word_dropout=0.0, locked_dropout=0.5)
    with torch.no_grad():
        det = tagger._word_features(batch)
        got = tagger._word_features(batch, torch.Generator().manual_seed(3))
    words = batch["word_mask"].bool()
    ratio = torch.where(det.abs() > 1e-6, got / det, torch.nan)
    first = ratio[:, :1, :]  # each (sentence, channel) over its words
    for b in range(ratio.shape[0]):
        r = ratio[b][words[b]]
        r = r[:, ~torch.isnan(r).any(0)]
        assert bool(((r - r[:1]).abs() < 1e-5).all())
        assert bool((((r[0] - 2.0).abs() < 1e-5)
                     | (r[0].abs() < 1e-6)).all())
    kept = torch.nan_to_num(first).abs() > 1
    assert abs(float(kept.float().mean()) - 0.5) < 0.05
