"""The PyTorch port's sharded training against kbner_tpu's unsharded
model: spawned gloo worlds on the CPU, one per layout (data parallelism
over 2 ranks, tensor parallelism over 2, and (data=2, model=2) with FSDP
over 4), each run by ``tests/torch_world.py``'s ``mesh_train_rank``
while the JAX reference computes here.

The sharded step's loss and every gradient on a ner_toy batch (7
sentences, padded to a multiple of the data axis as the reference pads
it) equal ``jax.grad`` of the reference's unsharded Flax model on that
padded batch at the reference's own tolerances
(``tests/test_mesh_training_equality.py``): loss rel 1e-4, gradients
rtol 2e-3, atol 1e-5; and the port's single-process step on it the same
way. A sharded step reorders float32 sums (partial products all-reduced,
gradients averaged), so runs of several Adam steps are held to the
single-process run at rtol 1e-4, atol 1e-6, except the attention's key
bias: its gradient is 0 in exact arithmetic (it shifts a softmax row
alike), so Adam turns rounding noise into steps of up to the lr, and it
is held within those steps' reach of its start (as
tests/test_torch_train.py holds it). Files are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from kbner_tpu.data import HashTokenizer as JTokenizer
from kbner_tpu.data import encode_batch as j_encode
from kbner_tpu.data import load_column_corpus as j_load
from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu_torch import checkpoint, weights
from kbner_tpu_torch.data.encode import encode_batch
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
from kbner_tpu_torch.train.optim import from_optax_state

import torch_world
from torch_world import (ACC_CONFIG, ACC_ROWS, JOIN_S, RUN_CONFIG,
                         TOY_FOLDER, TOY_ROWS, TOY_VOCAB, World,
                         quality_corpus, run_pair, toy_corpus, toy_tagger)

LAYOUTS = {"dp2": (2, 1, False), "tp2": (1, 2, False),
           "dp2xtp2_fsdp": (2, 2, True)}
HEADS = ("crf", "softmax")
LOSS_REL, G_RTOL, G_ATOL = 1e-4, 2e-3, 1e-5
RUN_RTOL, RUN_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_side():
    """The reference's Flax taggers (CRF and softmax heads, dropout off)
    from PRNGKey(0), and its unsharded loss and gradients on the ner_toy
    batch padded to 8 rows (data = 2) and unpadded (data = 1)."""
    corpus = j_load(TOY_FOLDER, {0: "text", 1: "ner"},
                    comment_symbol="# id")
    tags = corpus.make_tag_dictionary("ner")
    arrays = j_encode(corpus.train[:TOY_ROWS], JTokenizer(TOY_VOCAB),
                      tags).arrays()
    out = {"arrays": arrays}
    for head in HEADS:
        cfg = JTaggerConfig.for_tag_dictionary(
            JXLMRConfig.tiny(vocab_size=1000), tags, use_crf=head == "crf",
            locked_dropout=0.0, word_dropout=0.0)
        model, params = init_tagger(
            cfg, jax.random.PRNGKey(0),
            {k: jnp.asarray(v) for k, v in arrays.items()})

        def loss_fn(p, b, model=model):
            return model.apply(p, b, deterministic=True, method=model.loss)

        out[head] = {"tree": jax.tree_util.tree_map(np.asarray, params)}
        for data in (1, 2):
            padded = {k: np.pad(v, [(0, (-v.shape[0]) % data)]
                                + [(0, 0)] * (v.ndim - 1))
                      for k, v in arrays.items()}
            loss, grads = jax.value_and_grad(loss_fn)(
                params, {k: jnp.asarray(v) for k, v in padded.items()})
            out[head][data] = (float(loss), jax.tree_util.tree_map(
                np.asarray, grads), padded)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each layout's per-rank arrays (the worlds run together while the
    reference computes) and the JAX side."""
    # the ranks start from the reference's weights, so it runs first
    jax_side = _jax_side()
    started = {}
    trees = {head: jax_side[head]["tree"] for head in HEADS}
    for name, (data, model, fsdp) in LAYOUTS.items():
        d = tmp_path_factory.mktemp(name)
        started[name] = (World(torch_world.mesh_train_rank, data * model, d,
                               data, model, fsdp, trees, str(d)), d)
    return {name: (w.join(JOIN_S), d) for name, (w, d) in
            started.items()}, jax_side


@pytest.fixture(scope="module")
def single(tmp_path_factory, worlds):
    """The port's single-process references: the accumulated step and
    the train/resume pair with dropout on."""
    corpus = toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(TOY_VOCAB)
    trainer = FinetuneTrainer(toy_tagger(worlds[1]["crf"]["tree"], tags),
                              corpus, tok, tags, device="cpu")
    cfg = TrainConfig(**ACC_CONFIG)
    opt = trainer.make_optimizer(cfg)
    norms = []
    for lo, hi in ACC_ROWS:
        eb = encode_batch(corpus.train[lo:hi], tok, tags)
        trainer.model.loss(trainer._to_device(eb)).backward()
        norms.append(float(torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in trainer.model.parameters()
             if p.grad is not None]))))
        trainer.model.zero_grad(set_to_none=True)
        trainer.train_step(eb, opt, cfg, None)
    acc = {n: v.numpy() for n, v in trainer.model.state_dict().items()}
    q = quality_corpus()
    q_tags = q.make_tag_dictionary("ner")
    run = run_pair(lambda: FinetuneTrainer(
        toy_tagger(None, q_tags, dropout=True), q, tok, q_tags,
        device="cpu"), tmp_path_factory.mktemp("single") / "run")
    init = {n: v.numpy() for n, v in toy_tagger(
        None, q_tags, dropout=True).state_dict().items()}
    return {"acc": acc, "acc_count": opt.count, "norms": norms, "run": run,
            "init": init, "q_tags": q_tags}


def _port_grads(tree, padded, use_crf):
    """The port's single-process loss and gradients on the padded batch."""
    corpus = toy_corpus()
    model = toy_tagger(tree, corpus.make_tag_dictionary("ner"), use_crf)
    loss = model.loss({k: torch.from_numpy(v) for k, v in padded.items()})
    loss.backward()
    return float(loss), {n: p.grad.numpy()
                         for n, p in model.named_parameters()}


def test_batches_are_the_reference_batches(worlds):
    """The ranks' batches (the port's encoding of ner_toy) are the
    reference's: the comparisons below are on the same inputs."""
    corpus = toy_corpus()
    port = encode_batch(corpus.train[:TOY_ROWS], HashTokenizer(TOY_VOCAB),
                        corpus.make_tag_dictionary("ner")).arrays()
    want = worlds[1]["arrays"]
    assert sorted(port) == sorted(want) and TOY_ROWS % 2 == 1
    for k in want:
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)


@pytest.mark.parametrize("head", HEADS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_loss_and_gradients_match_jax_grad(worlds, layout, head):
    """Every rank's loss and every (gathered) gradient of the sharded
    ``train_step`` equal ``jax.grad`` of the unsharded Flax model on the
    batch padded to the data axis (7 rows -> 8 over data = 2), and the
    port's single-process step on that padded batch."""
    ranks = worlds[0][layout][0]
    data = LAYOUTS[layout][0]
    j_loss, j_grads, padded = worlds[1][head][data]
    model = toy_tagger(None, toy_corpus().make_tag_dictionary("ner"),
                       head == "crf")
    want = weights.from_jax_params(j_grads, model)
    p_loss, p_grads = _port_grads(worlds[1][head]["tree"], padded,
                                  head == "crf")
    assert p_loss == pytest.approx(j_loss, rel=LOSS_REL)
    assert set(want) == set(p_grads)
    for r, got in enumerate(ranks):
        assert float(got[f"{head}/loss"]) == pytest.approx(j_loss,
                                                           rel=LOSS_REL)
        for name, w in want.items():
            g = got[f"{head}/grad/{name}"]
            np.testing.assert_allclose(g, w.numpy(), rtol=G_RTOL,
                                       atol=G_ATOL,
                                       err_msg=f"rank {r} {name}")
            np.testing.assert_allclose(g, p_grads[name], rtol=G_RTOL,
                                       atol=G_ATOL,
                                       err_msg=f"rank {r} {name} (port)")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_accumulated_clipped_updates_match_single_process(worlds, single,
                                                          layout):
    """Two updates of accumulation 2 with global-norm clipping active
    (every micro-batch's gradient norm is above the clip of 0.5): the
    gathered parameters equal the single-process run's; the norm sums
    each slice once, so a replicated leaf is not counted per rank."""
    assert min(single["norms"]) > ACC_CONFIG["grad_clip"]
    for r, got in enumerate(worlds[0][layout][0]):
        assert int(got["acc/count"]) == single["acc_count"] == 2
        for name, want in single["acc"].items():
            got_p = got[f"acc/param/{name}"]
            if name.endswith("attention.key.bias"):
                continue  # held in the runs below
            np.testing.assert_allclose(got_p, want, rtol=RUN_RTOL,
                                       atol=RUN_ATOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_train_and_resume_match_single_process_with_dropout(worlds, single,
                                                            layout):
    """``FinetuneTrainer.train`` for one epoch with every dropout on and
    ``checkpoint: true``, then a fresh trainer resuming to two: the
    epoch losses, dev scores, update counts, parameters and moments
    equal the single-process runs' (the masks are drawn over the global
    batch and cut to each rank's rows and heads)."""
    want = single["run"]
    lr = RUN_CONFIG["learning_rate"]
    for r, got in enumerate(worlds[0][layout][0]):
        for run, steps in (("run0", 2), ("run1", 4)):
            np.testing.assert_allclose(got[f"{run}/loss"],
                                       want[f"{run}/loss"], rtol=1e-5)
            np.testing.assert_array_equal(got[f"{run}/dev"],
                                          want[f"{run}/dev"])
            assert int(got[f"{run}/count"]) == int(want[f"{run}/count"]) \
                == steps
            for key in ("param", "mu", "nu"):
                names = [k for k in want if k.startswith(f"{run}/{key}/")]
                assert names and set(names) <= set(got)
                for k in names:
                    if k.endswith("attention.key.bias"):
                        if key == "param":
                            init = single["init"][k.split("/", 2)[2]]
                            for x in (got[k], want[k]):
                                assert np.abs(x - init).max() <= \
                                    steps * lr * 1.01, k
                        continue
                    np.testing.assert_allclose(
                        got[k], want[k], rtol=RUN_RTOL,
                        atol=RUN_ATOL if key == "param" else 1e-7,
                        err_msg=f"{layout} rank {r} {k}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_rank_zero_files_open_unsharded_in_both_packages(worlds, single,
                                                         layout):
    """Rank 0 wrote the run's files in the single-process layout: the
    port reopens ``checkpoint.msgpack`` unsharded to the ranks' gathered
    parameters and moments bit for bit; ``best-model.msgpack`` opens in
    kbner_tpu's trainer to the port's reading of it."""
    ranks, d = worlds[0][layout]
    run = d / "run"
    names = sorted(p.name for p in run.iterdir() if p.is_file())
    assert names == ["best-model.msgpack", "checkpoint.msgpack",
                     "final-model.msgpack", "history.json", "loss.tsv",
                     "tag_dictionary.json"]
    q_tags = single["q_tags"]
    model = toy_tagger(None, q_tags, dropout=True)
    blob = checkpoint.load(run / "checkpoint.msgpack")
    params = weights.from_jax_params(blob["params"], model)
    opt = FinetuneTrainer(model, quality_corpus(), HashTokenizer(TOY_VOCAB),
                          q_tags, device="cpu").make_optimizer(
        TrainConfig(max_epochs=2, **RUN_CONFIG))
    count, mini_step, moments = from_optax_state(blob["opt_state"], opt,
                                                 model)
    r0 = ranks[0]
    assert (count, mini_step) == (int(r0["run1/count"]), 0)
    for n, v in params.items():
        np.testing.assert_array_equal(v.numpy(), r0[f"run1/param/{n}"], n)
    for key in ("mu", "nu"):
        for n, v in moments[key].items():
            np.testing.assert_array_equal(v.float().numpy(),
                                          r0[f"run1/{key}/{n}"], n)
    jcorpus = jquality.make_quality_corpus(16, 4, 4, seed=1)
    jtags = jcorpus.make_tag_dictionary("ner")
    cfg = JTaggerConfig.for_tag_dictionary(JXLMRConfig.tiny(
        vocab_size=1000), jtags)
    eb = j_encode(jcorpus.train[:2], JTokenizer(TOY_VOCAB), jtags)
    jmodel, jparams = init_tagger(cfg, jax.random.PRNGKey(3), {
        k: jnp.asarray(v) for k, v in eb.arrays().items()})
    reader = JTrainer(jmodel, jparams, jcorpus, JTokenizer(TOY_VOCAB), jtags)
    reader.load(run / "best-model.msgpack")
    port_tree = checkpoint.load(run / "best-model.msgpack")
    assert jax.tree_util.tree_structure(reader.params) == \
        jax.tree_util.tree_structure(port_tree)
    for a, b in zip(jax.tree_util.tree_leaves(reader.params),
                    jax.tree_util.tree_leaves(port_tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    j_bytes = serialization.msgpack_restore(
        (run / "checkpoint.msgpack").read_bytes())
    assert set(j_bytes) == {"params", "opt_state", "meta"}


@pytest.mark.parametrize("key, words", [
    ("plain", ("parallel.shard_params(model, mesh)",)),
])
def test_meshed_trainer_refusals(worlds, key, words):
    """A model that ``shard_params`` did not shard on the mesh is
    refused."""
    for name, ranks_dir in worlds[0].items():
        for got in ranks_dir[0]:
            for w in words:
                assert w in str(got[key]), (name, key)
