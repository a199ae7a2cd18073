"""The port's text classifier and regressor
(``kbner_tpu_torch/models/classifier.py``) and its GRU
(``models/embedders.py`` ``FlaxGRU``) against ``kbner_tpu``'s Flax modules
on the same seeded inputs: the GRU's states against ``nn.RNN(GRUCell)``
with ragged lengths, each pooling mode's logits, the loss and every
parameter's gradient (single- and multi-label), the regressor's, the
predictions, the encoded label arrays and the label dictionary; and the
GRU's initial parameters against Flax's distributions.

Tolerances (float32, tiny encoder): outputs atol 1e-5, losses rtol 1e-5,
gradients rtol 1e-4 / atol 1e-5, predictions equal.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import classifier as JC
from kbner_tpu_torch.data.conll import SentenceRecord
from kbner_tpu_torch.data.encode import encode_batch
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models import classifier as PC
from kbner_tpu_torch.models.embedders import FlaxGRU
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.weights import (from_jax_params, gru_from_flax,
                                     gru_to_flax, to_jax_params)

VOCAB = 997
LABELS = ["sports", "finance", "tech"]
RTOL, ATOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gru_matches_flax_rnn_with_ragged_lengths():
    """States before each row's length equal ``nn.RNN(nn.GRUCell)``'s
    (rows of length 1, mid and full); the cell's tree crosses both ways."""
    rng = np.random.RandomState(0)
    B, T, D, H = 4, 9, 6, 5
    x = rng.randn(B, T, D).astype(np.float32)
    lengths = np.array([9, 1, 5, 3], np.int32)
    rnn = fnn.RNN(fnn.GRUCell(H))
    params = rnn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                      seq_lengths=jnp.asarray(lengths))
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.randn(*a.shape).astype(
            np.float32), params)
    want = np.asarray(rnn.apply(params, jnp.asarray(x),
                                seq_lengths=jnp.asarray(lengths)))
    gru = FlaxGRU(D, H)
    gru.load_state_dict(gru_from_flax(params["params"]["cell"]))
    got = gru(torch.from_numpy(x), seq_lengths=torch.from_numpy(lengths))
    assert got.shape == (B, int(lengths.max()), H)
    for b, n in enumerate(lengths):
        np.testing.assert_allclose(got[b, :n].detach().numpy(),
                                   want[b, :n], atol=ATOL)
    back = gru_to_flax(*(gru.state_dict()[k].numpy() for k in (
        "kernel_i", "bias_i", "kernel_h", "bias_hn")))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params["params"]["cell"])):
        np.testing.assert_array_equal(a, b)


def test_gru_is_drawn_as_flax_draws_it():
    """Input kernels lecun-normal, recurrent kernels orthogonal per gate
    (each gate's [H, H] block satisfies K^T K = I), biases zero; means and
    stds within six standard errors of Flax's."""
    D, H = 64, 32
    gru = FlaxGRU(D, H)
    gru.reset_parameters(torch.Generator().manual_seed(0))
    want = fnn.RNN(fnn.GRUCell(H)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, D)))["params"]["cell"]
    got = gru_to_flax(*(gru.state_dict()[k].numpy() for k in (
        "kernel_i", "bias_i", "kernel_h", "bias_hn")))
    for gate in ("ir", "iz", "in", "hr", "hz", "hn"):
        for leaf, w in want[gate].items():
            g, w = got[gate][leaf], np.asarray(w)
            assert g.shape == w.shape, (gate, leaf)
            s, n = float(w.std()), w.size
            assert abs(float(g.mean()) - float(w.mean())) <= \
                6 * s * (2 / n) ** 0.5 + 1e-7, (gate, leaf)
            assert abs(float(g.std()) - s) <= 6 * s / n ** 0.5 + 1e-7, \
                (gate, leaf)
        k = got[gate]["kernel"]
        if gate.startswith("h"):
            np.testing.assert_allclose(k.T @ k, np.eye(H), atol=1e-5)


def _records(cls, multi=False):
    rng = np.random.RandomState(3)
    out = []
    for n in (5, 2, 9, 1, 4):
        labels = [LABELS[rng.randint(3)]]
        if multi and rng.rand() < 0.6:
            labels.append(LABELS[(LABELS.index(labels[0]) + 1) % 3])
        out.append(cls(tokens=[f"w{rng.randint(80)}" for _ in range(n)],
                       labels=labels))
    return out


def _label_dicts(multi):
    j = JC.build_label_dictionary(_records(JRecord, multi))
    p = PC.build_label_dictionary(_records(SentenceRecord, multi))
    assert p.idx2item == j.idx2item
    return j, p


def _batches(multi=False, regression=False):
    jrecs, precs = _records(JRecord, multi), _records(SentenceRecord, multi)
    jeb = j_encode(jrecs, JTokenizer(vocab_size=VOCAB))
    peb = encode_batch(precs, HashTokenizer(vocab_size=VOCAB))
    jd, pd = _label_dicts(multi)
    JC.encode_labels(jrecs, jd, jeb)
    PC.encode_labels(precs, pd, peb)
    if regression:
        vals = np.random.RandomState(5).randn(len(precs)).astype(np.float32)
        jeb.extra["targets"] = peb.extra["targets"] = vals
    return ({k: jnp.asarray(v) for k, v in jeb.arrays().items()},
            {k: torch.from_numpy(v) for k, v in peb.arrays().items()})


def test_encoded_labels_match_jax():
    for multi in (False, True):
        jb, pb = _batches(multi)
        for k in ("label_ids", "label_multi"):
            np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]))
        assert (pb["label_multi"].sum(1) > 1).any() == multi


def _pair(kind, **kw):
    """(Flax model, perturbed params, port model with the same weights,
    JAX batch, port batch), dropout off."""
    jenc, enc = JXLMRConfig.tiny(vocab_size=VOCAB), XLMRConfig.tiny(
        vocab_size=VOCAB)
    if kind == "regressor":
        jb, pb = _batches(regression=True)
        jm = JC.TextRegressor(JC.TextRegressorConfig(jenc, dropout=0.0))
        pm = PC.TextRegressor(PC.TextRegressorConfig(enc, dropout=0.0),
                              device="cpu", seed=2)
    else:
        jb, pb = _batches(kw.get("multi_label", False))
        jm = JC.TextClassifier(JC.TextClassifierConfig(
            jenc, num_labels=len(LABELS), dropout=0.0, rnn_hidden=12, **kw))
        pm = PC.TextClassifier(PC.TextClassifierConfig(
            enc, num_labels=len(LABELS), dropout=0.0, rnn_hidden=12, **kw),
            device="cpu", seed=2)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jb, method=jm.loss)
    rng = np.random.RandomState(6)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    pm.load_state_dict(from_jax_params(np_params, pm), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, np_params), pm, jb, pb


KINDS = [("classifier", dict(pooling=p)) for p in (
    "cls", "mean", "max", "min", "min_max_mean", "rnn")] + [
    ("classifier", dict(pooling="mean", multi_label=True)),
    ("regressor", {})]


@pytest.mark.parametrize("kind,kw", KINDS)
def test_outputs_loss_gradients_and_predictions_match_flax(kind, kw):
    jm, params, pm, jb, pb = _pair(kind, **kw)
    if kind == "classifier":
        np.testing.assert_allclose(
            pm.logits(pb).detach().numpy(),
            np.asarray(jm.apply(params, jb, method=jm.logits)), atol=ATOL)
    want, j_grads = jax.value_and_grad(lambda p: jm.apply(
        p, jb, deterministic=True, method=jm.loss))(params)
    got = pm.loss(pb)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    want_grads = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads),
                                 pm)
    assert set(want_grads) == {n for n, _ in pm.named_parameters()}
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[n].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=n)
    pred = pm.predict(pb).numpy()
    want_pred = np.asarray(jm.apply(params, jb, method=jm.predict))
    if kind == "regressor":
        np.testing.assert_allclose(pred, want_pred, atol=ATOL)
    else:
        np.testing.assert_array_equal(pred, want_pred)
    back = to_jax_params(pm.state_dict(), pm)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray,
                                                            params))


@pytest.mark.parametrize("mode", ["mean", "max", "min", "min_max_mean"])
def test_pooling_matches_jax(mode):
    """Masked pooling over ragged token masks (a one-token row included)."""
    rng = np.random.RandomState(9)
    hidden = rng.randn(3, 6, 4).astype(np.float32)
    mask = np.array([[1] * 6, [1, 0, 0, 0, 0, 0], [1, 1, 1, 0, 0, 0]],
                    np.int32)
    np.testing.assert_allclose(
        PC._pool_tokens(torch.from_numpy(hidden), torch.from_numpy(mask),
                        mode).numpy(),
        np.asarray(JC._pool_tokens(jnp.asarray(hidden), jnp.asarray(mask),
                                   mode)), atol=1e-6)
    with pytest.raises(ValueError, match="unknown pooling"):
        PC._pool_tokens(torch.from_numpy(hidden), torch.from_numpy(mask),
                        "median")
