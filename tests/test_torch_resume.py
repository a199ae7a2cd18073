"""Resume across packages through ``checkpoint.msgpack``: one epoch with
``checkpoint: true`` in one package, then ``resume: true`` to a second
epoch in the other, both ways, with ``adam_mu_bf16`` on and off and
``accumulation_steps`` 1 and 2 (three micro-batches an epoch, so the
accumulation checkpoint holds a half-full accumulator).

Every dropout is 0, so the packages' second epochs compare. The state a
package reads from the other's file is the other's exactly (parameters,
``mu`` in its dtype, ``nu``, the accumulator, the counts); after the
second epoch the run that crossed packages is held to a resume within
one package: counts, epoch, best score and dev scores equal, losses at
rtol 1e-5, parameters and moments at rtol 1e-4, atol 1e-6. With a
bfloat16 ``mu`` the first epochs, one per framework, differ in the last
bits and a bfloat16 rounding can fall either way: each tensor's largest
difference stays within 2^-5 (``mu``) or 1e-3 (``nu``) of its largest
value, and a parameter's within 0.05 x lr per second-epoch update
(measured at most 0.98%, 0.017% and 0.0145 x lr); the attention's key
bias within the updates' reach of its start (its gradient is 0 in exact
arithmetic; see tests/test_torch_train.py).
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu.train import TrainConfig as JTrainConfig
from kbner_tpu_torch import checkpoint, weights
from kbner_tpu_torch.data import quality_fixture
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
from kbner_tpu_torch.train.optim import from_optax_state

VOCAB = 997
LR = 1e-3
KW = dict(learning_rate=LR, lr_rate=3.0, batch_size=8, warmup_fraction=0.0,
          seed=4, checkpoint=True)
CASES = [dict(adam_mu_bf16=bf16, accumulation_steps=acc)
         for bf16 in (False, True) for acc in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pair:
    """Both packages' taggers from the same Flax-drawn weights, and
    trainers of each over the same corpus."""

    def __init__(self):
        self.jcorpus = jquality.make_quality_corpus(24, 4, 4, seed=2)
        self.corpus = quality_fixture.make_quality_corpus(24, 4, 4, seed=2)
        self.jtags = self.jcorpus.make_tag_dictionary("ner")
        self.tags = self.corpus.make_tag_dictionary("ner")
        cfg = JTaggerConfig.for_tag_dictionary(
            JXLMRConfig.tiny(vocab_size=VOCAB), self.jtags,
            locked_dropout=0.0, word_dropout=0.0)
        eb = j_encode(self.jcorpus.train[:2], JTokenizer(VOCAB), self.jtags)
        self.jmodel, params = init_tagger(
            cfg, jax.random.PRNGKey(0),
            {k: jnp.asarray(v) for k, v in eb.arrays().items()})
        self.init = jax.tree_util.tree_map(np.array, params)

    def jax_trainer(self):
        params = jax.tree_util.tree_map(jnp.asarray, self.init)
        return JTrainer(self.jmodel, params, self.jcorpus, JTokenizer(VOCAB),
                        self.jtags)

    def port_trainer(self):
        cfg = TaggerConfig.for_tag_dictionary(
            XLMRConfig.tiny(vocab_size=VOCAB), self.tags,
            locked_dropout=0.0, word_dropout=0.0)
        model = SequenceTagger(cfg, device="cpu", seed=0)
        model.load_state_dict(weights.from_jax_params(self.init, model))
        return FinetuneTrainer(model, self.corpus, HashTokenizer(VOCAB),
                               self.tags, device="cpu")


def _resume(make, src, dst, config):
    """A fresh trainer resumes from ``src``'s checkpoint in ``dst``."""
    dst.mkdir()
    shutil.copy(src / "checkpoint.msgpack", dst / "checkpoint.msgpack")
    make().train(dst, config)
    return checkpoint.load(dst / "checkpoint.msgpack")


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"mu_bf16={c['adam_mu_bf16']}-acc="
                              f"{c['accumulation_steps']}")
def runs(request, tmp_path_factory):
    """First epochs in both packages, then each resumed to a second
    epoch in both packages: ``{(first, second): checkpoint tree}``."""
    case = request.param
    pair = Pair()
    tmp = tmp_path_factory.mktemp("resume")
    first = {"jax": tmp / "jax1", "port": tmp / "port1"}
    pair.jax_trainer().train(first["jax"], JTrainConfig(max_epochs=1,
                                                        **KW, **case))
    pair.port_trainer().train(first["port"], TrainConfig(max_epochs=1,
                                                         **KW, **case))
    second = {}
    for a in ("jax", "port"):
        for b, make, config in (
                ("jax", pair.jax_trainer, JTrainConfig(
                    max_epochs=2, resume=True, **KW, **case)),
                ("port", pair.port_trainer, TrainConfig(
                    max_epochs=2, resume=True, **KW, **case))):
            second[a, b] = _resume(make, first[a], tmp / f"{a}-{b}", config)
    return case, pair, first, second


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _array(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x)


def test_a_checkpoint_is_read_exactly_by_the_other_package(runs):
    """The port reads the JAX trainer's first-epoch checkpoint to its
    exact numbers (``mu`` in bfloat16 where it was), and the JAX trainer
    restores the port's file through flax's template without a
    mismatch, to the same bytes' numbers."""
    case, pair, first, _ = runs
    j_tree = checkpoint.load(first["jax"] / "checkpoint.msgpack")
    trainer = pair.port_trainer()
    config = TrainConfig(max_epochs=2, **KW, **case)
    opt = trainer.make_optimizer(config)
    meta = trainer._load_checkpoint(first["jax"] / "checkpoint.msgpack", opt)
    assert meta == json.loads(j_tree["meta"])
    want = weights.from_jax_params(j_tree["params"], trainer.model)
    for n, p in trainer.model.state_dict().items():
        assert torch.equal(p, want[n]), n
    count, mini_step, moments = from_optax_state(j_tree["opt_state"], opt,
                                                 trainer.model)
    assert (opt.count, opt.mini_step) == (count, mini_step)
    assert opt.count == (3 if case["accumulation_steps"] == 1 else 1)
    assert opt.mini_step == (0 if case["accumulation_steps"] == 1 else 1)
    for key, named in opt.named_moments().items():
        for n, t in named.items():
            assert torch.equal(t, moments[key][n].to(t.dtype)), (key, n)
    if case["adam_mu_bf16"]:
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)
        assert any(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16
                   for _, v in _leaves(j_tree["opt_state"]))
    # the JAX trainer reads the port's file
    p_bytes = (first["port"] / "checkpoint.msgpack").read_bytes()
    jt = pair.jax_trainer()
    from kbner_tpu.train.optim import make_finetune_optimizer

    tx = make_finetune_optimizer(
        jt.params, lr=LR, lr_rate=3.0, accumulation_steps=case[
            "accumulation_steps"],
        mu_dtype=jnp.bfloat16 if case["adam_mu_bf16"] else None)
    state = jt._load_checkpoint(first["port"] / "checkpoint.msgpack",
                                tx.init(jt.params))
    p_tree = serialization.msgpack_restore(p_bytes)
    got = dict(_leaves(serialization.to_state_dict(state["opt_state"])))
    for path, want_leaf in _leaves(p_tree["opt_state"]):
        np.testing.assert_array_equal(np.asarray(got[path]), want_leaf,
                                      err_msg=path)
        assert np.asarray(got[path]).dtype == np.asarray(want_leaf).dtype
    assert state["epoch"] == 0


@pytest.mark.parametrize("second", ["port", "jax"])
def test_resume_across_packages_equals_resume_within_one(runs, second):
    """The second epoch resumed in ``second`` from the other package's
    first epoch against the same resumed from ``second``'s own."""
    case, pair, _, runs2 = runs
    other = "jax" if second == "port" else "port"
    got, want = runs2[other, second], runs2[second, second]
    meta_g, meta_w = json.loads(got["meta"]), json.loads(want["meta"])
    assert meta_g["epoch"] == meta_w["epoch"] == 1
    assert meta_g["best_score"] == meta_w["best_score"]
    assert meta_g["history"]["dev_score"] == meta_w["history"]["dev_score"]
    np.testing.assert_allclose(meta_g["history"]["train_loss"],
                               meta_w["history"]["train_loss"], rtol=1e-5)
    init = dict(_leaves(pair.init))
    g_leaves, w_leaves = dict(_leaves(got)), dict(_leaves(want))
    assert set(g_leaves) == set(w_leaves)
    steps = 6 if case["accumulation_steps"] == 1 else 3
    updates = steps // 2  # in the second epoch
    n_moments = 0
    for path, w in w_leaves.items():
        if path == "/meta":
            continue
        g = g_leaves[path]
        if isinstance(w, dict):  # an optax MaskedNode
            assert g == {}, path
            continue
        if path.endswith("count") or path.endswith("_step"):
            assert int(np.asarray(g)) == int(np.asarray(w)), path
            continue
        if isinstance(w, torch.Tensor) or isinstance(g, torch.Tensor):
            assert isinstance(g, torch.Tensor) and isinstance(
                w, torch.Tensor) and g.dtype == w.dtype, path
        g, w = _array(g), _array(w)
        if "/key/bias" in path:
            if path.startswith("/params/"):
                start = init[path[len("/params"):]]
                for x in (g, w):
                    assert np.abs(x - start).max() <= steps * LR * 1.01, path
            continue
        n_moments += "/mu/" in path or "/nu/" in path
        if case["adam_mu_bf16"]:
            # a bfloat16 rounding of mu that differs between the packages'
            # first epochs moves an element by one bfloat16 spacing of its
            # value (<= 2^-7 of the tensor's largest); the updates carry it
            # into the parameters (a part of each update's lr) and nu
            if path.startswith("/params/"):
                bound = 0.05 * LR * updates
            else:
                bound = (2.0 ** -5 if "/mu/" in path else 1e-3) * np.abs(
                    w).max()
            assert np.abs(g - w).max() <= bound, path
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=path)
    assert n_moments > 0
