"""The PyTorch port's ACE loop and char-LM trainer against kbner_tpu's:
the controller's draws, updates and saved state under a stub episode;
``cli train`` with ``trainer: ReinforcementTrainer`` end to end; an ACE
checkpoint crossing between the packages both ways, ELMo and BPEmb
members included (their weights from HDF5, npz and word2vec files; ``cli
test`` on the result); the char-LM
trainer's losses against optax's (rtol 1e-5: float32 Adam in another
operation order, as tests/test_torch_train.py holds the optimizer).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from kbner_tpu import cli as jcli
from kbner_tpu.config import ExperimentConfig as JExperimentConfig
from kbner_tpu.data.dictionary import Dictionary as JDictionary
from kbner_tpu.models.embedders import CharLMHead as JCharLMHead
from kbner_tpu.train.lm_trainer import LanguageModelTrainer as JLMTrainer
from kbner_tpu.train.lm_trainer import LMTrainConfig as JLMTrainConfig
from kbner_tpu.train.lm_trainer import build_char_stream as j_char_stream
from kbner_tpu.train.reinforce import ReinforceConfig as JReinforceConfig
from kbner_tpu.train.reinforce import \
    ReinforcementTrainer as JReinforcementTrainer
from kbner_tpu_torch import checkpoint, cli, weights
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.data.dictionary import Dictionary
from kbner_tpu_torch.models import embedders as emb
from kbner_tpu_torch.models.embedders import CharLMHead
from kbner_tpu_torch.models.tagger import StackedSequenceTagger
from kbner_tpu_torch.train.lm_trainer import (LanguageModelTrainer,
                                              LMTrainConfig,
                                              build_char_stream,
                                              generate_text)
from kbner_tpu_torch.train.reinforce import (EmbedController,
                                             ReinforceConfig,
                                             ReinforcementTrainer)

FIX = Path(__file__).parent / "fixtures"
STACK = [{"type": "transformer"}, {"type": "word", "dim": 12},
         {"type": "char_bilstm", "char_dim": 6, "hidden": 5},
         {"type": "flair", "embed_dim": 4, "hidden": 6}]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, name, **overrides):
    raw = yaml.safe_load((FIX / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(FIX / "ner_toy")
    raw["corpora"][0]["test_file"] = "train.txt"
    raw["target_dir"] = str(tmp_path / f"{name}_run")
    raw["name"] = name
    raw.update(overrides)
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path, raw


# -- the controller -------------------------------------------------------------------

def _stub_episode(mask):
    """A dev F1 from the mask alone: member 2 helps most, member 0 hurts."""
    return float(0.5 + 0.2 * mask[2] + 0.1 * mask[1] - 0.15 * mask[0]
                 + 0.05 * mask[3])


@pytest.mark.parametrize("kw", [
    dict(episodes=8, controller_lr=0.5),
    dict(episodes=15, controller_lr=0.1, reward_kind="log", seed=3),
    dict(episodes=6, controller_lr=1.0, reward_kind="sqrt", seed=7)])
def test_controller_loop_equals_the_reference(tmp_path, kw):
    """Samples, rewards, updates, best action and training_state.json,
    byte for byte, over more episodes than there are masks (the
    controller's fallback draw)."""
    got = ReinforcementTrainer(4, _stub_episode, ReinforceConfig(**kw)
                               ).train(tmp_path / "pt")
    want = JReinforcementTrainer(4, _stub_episode, JReinforceConfig(**kw)
                                 ).train(tmp_path / "jax")
    assert got == want
    assert (tmp_path / "pt" / "training_state.json").read_bytes() == \
        (tmp_path / "jax" / "training_state.json").read_bytes()
    controller, state = EmbedController.load(
        tmp_path / "pt" / "training_state.json")
    assert state["best_action"] == got["best_action"]
    assert controller.num_embeddings == 4


def test_controller_update_moves_chosen_members_up():
    c = EmbedController(3)
    before = c.probs().copy()
    c.update(np.asarray([1.0, 0.0, 1.0]), reward=1.0)
    after = c.probs()
    assert after[0] > before[0] and after[2] > before[2]
    assert after[1] < before[1] and c.baseline == pytest.approx(0.1)


# -- cli train with the ACE trainer ------------------------------------------------------

def test_cli_ace_end_to_end(tmp_path):
    """The ACE episode loop over a word + char-BiLSTM stack through ``cli
    train``, as tests/test_cli_trainers.py drives the JAX CLI: the
    controller's state, the final model trained with the best action and
    its test results."""
    path, raw = _config(tmp_path, "ace", trainer="ReinforcementTrainer")
    raw["model"]["embeddings"] = [
        {"type": "word", "dim": 24},
        {"type": "char_bilstm", "char_dim": 8, "hidden": 8}]
    raw["ace"] = {"episodes": 3}
    raw["train"].update(max_epochs=15, learning_rate=0.05)
    path.write_text(yaml.safe_dump(raw))
    result = cli.main(["train", "--config", str(path), "--device", "cpu"])
    run = Path(raw["target_dir"])
    state = json.loads((run / "training_state.json").read_text())
    assert len(state["best_action"]) == 2 and sum(state["best_action"]) >= 1
    assert state["best_action"] == result["best_action"]
    assert [h["episode"] for h in result["history"]] == [0, 1, 2]
    for name in ("best-model.msgpack", "final-model.msgpack",
                 "test.TOY.tsv", "episode/best-model.msgpack"):
        assert (run / name).exists(), name
    results = json.loads((run / "test_results.json").read_text())
    assert results["TOY"]["micro_f1"] > 0.5


def test_ace_checkpoints_cross_both_ways(tmp_path):
    """A port-written ACE ``best-model.msgpack`` over all four member kinds
    loads into the JAX stacked tagger and gives the port's emissions, and
    the JAX package's file loads into the port."""
    path, raw = _config(tmp_path, "cross", trainer="ReinforcementTrainer",
                        ace={"episodes": 1})
    raw["model"]["embeddings"] = STACK
    raw["train"].update(max_epochs=1, learning_rate=0.05)
    path.write_text(yaml.safe_dump(raw))
    cli.main(["train", "--config", str(path), "--device", "cpu"])
    best = Path(raw["target_dir"]) / "best-model.msgpack"

    config = ExperimentConfig.from_file(path)
    trainer, specs = cli._build_ace(config, "cpu")
    assert isinstance(trainer.model, StackedSequenceTagger)
    _, jtrainer, jspecs = jcli._build_ace(JExperimentConfig.from_file(path))
    assert len(specs) == len(jspecs) == 4
    init_tree = serialization.to_state_dict(jtrainer.params)
    jtrainer.load(best)
    trainer.load(best)
    trainer.model.eval()
    sel = np.asarray([1, 0, 1, 1], np.float32)
    trainer.selection = jtrainer.selection = sel
    eb = trainer._make_train_batches(config.load_corpus().train,
                                     config.make_train_config(), 0)[0]
    batch = trainer._to_device(eb)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = jtrainer.model.apply(jtrainer.params, jbatch,
                                method=jtrainer.model.emissions)
    with torch.no_grad():
        got = trainer.model.emissions(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)

    # the JAX package's file (its initial parameters) into the port
    jpath = tmp_path / "jax-model.msgpack"
    jpath.write_bytes(serialization.msgpack_serialize(init_tree))
    trainer.load(jpath)
    tree = weights.to_jax_params(trainer.model.state_dict(), trainer.model)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(checkpoint.load(jpath))
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(checkpoint.load(jpath))):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(KeyError, match="params.encoder"):
        trainer.load_encoder(jpath)  # the stack's encoder is not there


# a bilm-tf ELMo member on allennlp's byte ids, and a BPEmb member
ELMO = {"type": "elmo", "char_encoding": "elmo_bytes", "char_dim": 4,
        "filters": [[1, 3], [2, 4], [4, 2]], "n_highway": 1, "cell_dim": 6,
        "proj_dim": 5, "num_layers": 2, "mode": "all"}


def _elmo_weights(tmp_path, fmt):
    """Seeded weights of ``ELMO``'s widths, in bilm-tf's HDF5 layout
    (written with h5py) or as the member's npz."""
    import h5py

    from kbner_tpu_torch.models.embedders import ELMoEmbedder

    m = ELMoEmbedder(261, 4, filters=((1, 3), (2, 4), (4, 2)), n_highway=1,
                     proj_dim=5, num_layers=2, cell_dim=6,
                     conv_activation="relu")
    m.reset_parameters(torch.Generator().manual_seed(3))
    if fmt == "npz":
        m.save_npz(tmp_path / "elmo.npz")
        return tmp_path / "elmo.npz"
    tree = weights.member_to_jax_params(m.state_dict(), m)
    path = tmp_path / "elmo_weights.hdf5"
    with h5py.File(path, "w") as f:
        f["char_embed"] = tree["chars"]["embedding"]
        for i, (w, _) in enumerate(m.filters):
            f[f"CNN/W_cnn_{i}"] = tree[f"conv{w}"]["kernel"][None]
            f[f"CNN/b_cnn_{i}"] = tree[f"conv{w}"]["bias"]
        f["CNN_high_0/W_carry"] = tree["hw_t0"]["kernel"]
        f["CNN_high_0/b_carry"] = tree["hw_t0"]["bias"]
        f["CNN_high_0/W_transform"] = tree["hw_h0"]["kernel"]
        f["CNN_high_0/b_transform"] = tree["hw_h0"]["bias"]
        f["CNN_proj/W_proj"] = tree["proj"]["kernel"]
        f["CNN_proj/b_proj"] = tree["proj"]["bias"]
        for d, prefix in enumerate(("fwd", "bwd")):
            for layer in range(2):
                g = f"RNN_{d}/RNN/MultiRNNCell/Cell{layer}/LSTMCell"
                for leaf in ("W_0", "B", "W_P_0"):
                    f[f"{g}/{leaf}"] = tree[f"{prefix}{layer}"][leaf]
    return path


@pytest.mark.parametrize("fmt", ["hdf5", "npz"])
def test_cli_ace_with_elmo_and_bpemb(tmp_path, fmt):
    """``cli train`` with the ACE trainer over a word + bilm-tf ELMo
    (byte ids, weights spliced from the file) + BPEmb (word2vec text)
    stack, then ``cli test``; the spliced weights equal the file's, and
    the best checkpoint crosses to kbner_tpu and back with an equal tree
    and the port's emissions."""
    wfile = _elmo_weights(tmp_path, fmt)
    vec = tmp_path / "bpe.vec"
    bpe = emb.BPEVocab.build(ExperimentConfig.from_file(
        FIX / "toy_config.yaml").load_corpus().train, dim=3, max_words=10)
    vec.write_text(f"{len(bpe.pieces)} 3\n" + "".join(
        f"{p} {' '.join(f'{v:.4f}' for v in bpe.matrix[i])}\n"
        for p, i in bpe.pieces.items()))
    path, raw = _config(tmp_path, f"elmo_{fmt}",
                        trainer="ReinforcementTrainer", ace={"episodes": 1})
    raw["model"]["embeddings"] = [
        {"type": "word", "dim": 6}, dict(ELMO, weights=str(wfile)),
        {"type": "bpemb", "dim": 3, "vectors": str(vec)}]
    raw["train"].update(max_epochs=1, learning_rate=0.05)
    path.write_text(yaml.safe_dump(raw))
    config = ExperimentConfig.from_file(path)
    trainer, specs = cli._build_ace(config, "cpu")
    elmo = trainer.model.stack.members[1]
    assert trainer.elmo_bytes and elmo.input_key == "elmo_char_ids"
    assert [s.dim for s in specs] == [6, 30, 6]
    want = emb.ELMoEmbedder(261, 4, filters=((1, 3), (2, 4), (4, 2)),
                            n_highway=1, proj_dim=5, num_layers=2,
                            cell_dim=6, conv_activation="relu")
    want.load_npz(wfile) if fmt == "npz" else want.load_hdf5(wfile)
    for (name, a), b in zip(elmo.state_dict().items(),
                            want.state_dict().values()):
        assert torch.equal(a, b), name

    result = cli.main(["train", "--config", str(path), "--device", "cpu"])
    run = Path(raw["target_dir"])
    tested = json.loads((run / "test_results.json").read_text())
    assert np.isfinite(result["final"]["history"]["train_loss"]).all()
    assert cli.main(["test", "--config", str(path), "--device",
                     "cpu"]) is None
    assert json.loads((run / "test_results.json").read_text()) == tested

    best = run / "best-model.msgpack"
    trainer.load(best)
    _, jtrainer, jspecs = jcli._build_ace(JExperimentConfig.from_file(path))
    assert [s.dim for s in jspecs] == [6, 30, 6]
    jtrainer.load(best)
    tree = weights.to_jax_params(trainer.model.state_dict(), trainer.model)
    jtree = serialization.to_state_dict(jtrainer.params)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(jtree)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, np.asarray(b))
    trainer.model.eval()
    trainer.selection = jtrainer.selection = np.ones(3, np.float32)
    batch = trainer._to_device(trainer._make_train_batches(
        config.load_corpus().train, config.make_train_config(), 0)[0])
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with torch.no_grad():
        got = trainer.model.emissions(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtrainer.model.apply(
        jtrainer.params, jbatch, method=jtrainer.model.emissions)),
        rtol=1e-5, atol=1e-4)
    # and kbner_tpu's file back into the port
    jpath = tmp_path / "jax-model.msgpack"
    jpath.write_bytes(serialization.msgpack_serialize(jtree))
    trainer.load(jpath)
    for a, b in zip(jax.tree_util.tree_leaves(weights.to_jax_params(
            trainer.model.state_dict(), trainer.model)),
            jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_ace_refuses_unknown_members(tmp_path):
    path, raw = _config(tmp_path, "unknown", trainer="ReinforcementTrainer")
    raw["model"]["embeddings"] = [{"type": "glove"}]
    path.write_text(yaml.safe_dump(raw))
    with pytest.raises(ValueError, match="unknown ACE embedding type"):
        cli._build_ace(ExperimentConfig.from_file(path), "cpu")


# -- the char-LM trainer -------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(max_steps=6, batch_size=4, seq_len=24, learning_rate=1e-2,
         grad_clip=0.5),
    dict(max_steps=4, batch_size=3, seq_len=16, learning_rate=3e-3,
         backward=True, seed=5)])
def test_lm_trainer_losses_match_optax(tmp_path, kw):
    texts = [" ".join(r.tokens) for r in JExperimentConfig.from_file(
        FIX / "toy_config.yaml").load_corpus().train]
    jvocab, vocab = JDictionary(), Dictionary()
    for ch in " \n" + "".join(texts):
        jvocab.add_item(ch)
        vocab.add_item(ch)
    jm = JCharLMHead(len(jvocab), 8, 12)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))
    model = CharLMHead(len(vocab), 8, 12)
    model.load_state_dict(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), model))
    np.testing.assert_array_equal(build_char_stream(texts, vocab),
                                  j_char_stream(texts, jvocab))
    want = JLMTrainer(jm, params, jvocab).train(
        texts, tmp_path / "jax", JLMTrainConfig(log_every=1000, **kw))
    trainer = LanguageModelTrainer(model, vocab, device="cpu")
    got = trainer.train(texts, tmp_path / "pt",
                        LMTrainConfig(log_every=1000, **kw))
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    # the port's char-lm.msgpack is the JAX trainer's layout
    reader = JLMTrainer(jm, params, jvocab)
    reader.load(tmp_path / "pt" / "char-lm.msgpack")
    for name, p in weights.from_jax_params(jax.tree_util.tree_map(
            np.asarray, reader.params), model).items():
        torch.testing.assert_close(p, model.state_dict()[name], rtol=0,
                                   atol=0)
    trainer.load(tmp_path / "jax" / "char-lm.msgpack")
    text = generate_text(model, vocab, prefix="Al", length=12, seed=1)
    assert text.startswith("Al") and len(text) == 14
    assert text == generate_text(model, vocab, prefix="Al", length=12,
                                 seed=1)


def test_cli_lm_end_to_end(tmp_path):
    path, raw = _config(tmp_path, "lm", trainer="LanguageModelTrainer")
    raw["model"] = {"embed_dim": 16, "hidden": 32}
    raw["train"] = {"max_steps": 20, "batch_size": 4, "seq_len": 32,
                    "log_every": 1000}
    path.write_text(yaml.safe_dump(raw))
    result = cli.main(["train", "--config", str(path), "--device", "cpu"])
    run = Path(raw["target_dir"])
    assert (run / "char-lm.msgpack").exists()
    assert json.loads((run / "char_vocab.json").read_text())["items"][:2] \
        == [" ", "\n"]
    assert len(result["losses"]) == 20 and np.isfinite(result["losses"]).all()
    assert result["losses"][-1] < result["losses"][0]
    with pytest.raises(ValueError, match="unknown train keys"):
        ExperimentConfig.from_dict({**raw, "train": {"max_epochs": 1}}
                                   ).make_train_config()
