"""The PyTorch port's SWAF system combination against kbner_tpu's: the
system arrays, the ensemble model's scores, loss and gradients, 200 Adam
steps against ``optax.adam``, the weighted vote, and ``cli train`` with
``trainer: SWAFTrainer``.

The Flax model is initialized from a seed and carried over with
``weights.from_jax_params``. Tolerances, float32 on the CPU: scores and
the loss rtol 1e-5; gradients rtol 1e-4, atol 1e-6; each of the 200 steps'
loss rtol 1e-5 and the parameters after them rtol 1e-4, atol 1e-6 (Adam
divides each gradient by its running size, so the two frameworks' last
bits accumulate over the steps); arrays, combined labels and files
exactly.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kbner_tpu.data.dictionary import Dictionary as JDictionary
from kbner_tpu.models import ensemble_model as jens
from kbner_tpu_torch import cli, weights
from kbner_tpu_torch.data.dictionary import Dictionary
from kbner_tpu_torch.models import ensemble_model as ens

FIX = Path(__file__).parent / "fixtures"
LABELS = ["O", "B-PER", "I-PER", "B-LOC", "I-LOC", "B-ORG"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _systems(n_sys=3, n_sent=9, seed=0):
    """Gold tags and ``n_sys`` systems that agree with gold at different
    rates; one system misses the last words of some sentences, one writes
    a tag outside the label dictionary."""
    rng = np.random.RandomState(seed)
    gold = [[LABELS[i] for i in rng.randint(len(LABELS), size=n)]
            for n in rng.randint(1, 13, size=n_sent)]
    systems = []
    for s in range(n_sys):
        right = 0.9 - 0.25 * s
        sys_tags = [[g if rng.rand() < right else LABELS[rng.randint(6)]
                     for g in sent] for sent in gold]
        systems.append(sys_tags)
    systems[1] = [sent[:max(1, len(sent) - 2)] for sent in systems[1]]
    systems[-1][0][0] = "B-MISC"
    return gold, systems


def _dicts():
    j, p = JDictionary(), Dictionary()
    for d in (j, p):
        for lab in LABELS:
            d.add_item(lab)
    return j, p


@pytest.mark.parametrize("bucket", [8, 5, 1])
def test_system_arrays_equal_the_reference(bucket):
    gold, systems = _systems()
    jd, pd = _dicts()
    want = jens.encode_system_predictions(systems, gold, jd,
                                          word_bucket=bucket)
    got = ens.encode_system_predictions(systems, gold, pd,
                                        word_bucket=bucket)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["mask"].shape[1] % bucket == 0


def _pair(n_sys=3, hidden=16, seed=0):
    gold, systems = _systems(n_sys=n_sys, seed=seed)
    jd, pd = _dicts()
    arrays = ens.encode_system_predictions(systems, gold, pd)
    cfg = dict(num_systems=n_sys, num_labels=len(pd), hidden=hidden)
    model = jens.EnsembleModel(jens.EnsembleConfig(**cfg))
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.asarray(arrays["system_onehots"][:1]))
    params = jax.tree_util.tree_map(np.asarray, params)
    port = ens.EnsembleModel(ens.EnsembleConfig(**cfg), device="cpu",
                             seed=seed + 1)
    port.load_state_dict(weights.from_jax_params(params, port), strict=True)
    return model, params, port, arrays


def test_weights_carry_both_ways():
    model, params, port, _ = _pair()
    tree = weights.to_jax_params(port.state_dict(), port)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(tree),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_initial_draws_follow_flax_dense():
    port = ens.EnsembleModel(ens.EnsembleConfig(8, 40, hidden=256),
                             device="cpu", seed=3)
    w = port.hidden.weight.detach()
    assert abs(float(w.std()) - 320 ** -0.5) < 0.002  # lecun normal
    assert float(w.abs().max()) <= 2 * 320 ** -0.5 / 0.8796
    assert not bool(port.hidden.bias.any())
    assert not bool(port.hidden2score.bias.any())


@pytest.mark.parametrize("n_sys", [2, 3, 5])
def test_scores_loss_and_gradients_match_flax(n_sys):
    model, params, port, arrays = _pair(n_sys=n_sys, seed=n_sys)
    a = {k: jnp.asarray(v) for k, v in arrays.items()}
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    want_scores = model.apply(params, a["system_onehots"])
    np.testing.assert_allclose(port(t["system_onehots"]).detach().numpy(),
                               np.asarray(want_scores), rtol=1e-5, atol=1e-6)
    want, j_grads = jax.value_and_grad(lambda p: model.apply(
        p, a["system_onehots"], a["correct"], a["mask"],
        method=model.loss))(jax.tree_util.tree_map(jnp.asarray, params))
    got = port.loss(t["system_onehots"], t["correct"], t["mask"])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_grads = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, j_grads), port)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(
        port.combine(t["system_onehots"]).numpy(),
        np.asarray(model.apply(params, a["system_onehots"],
                               method=model.combine)))


@pytest.mark.parametrize("lr", [1e-2, 5e-2])
def test_200_adam_steps_match_optax(lr):
    """``SWAFTrainer.train`` against the JAX package's ``optax.adam``
    loop over 200 full-batch steps: every step's loss, the parameters at
    the end, and the combined labels of a second split."""
    model, params, port, arrays = _pair(n_sys=3, seed=7)
    jt = jens.SWAFTrainer(model, jax.tree_util.tree_map(jnp.asarray,
                                                        params))
    want = jt.train(arrays, steps=200, lr=lr)
    pt = ens.SWAFTrainer(port)
    got = pt.train(arrays, steps=200, lr=lr)
    assert len(got) == len(want) == 200
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert want[-1] < want[0]
    final = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.params), port)
    for name, p in port.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)
    gold, systems = _systems(seed=11)
    _, pd = _dicts()
    other = ens.encode_system_predictions(systems, gold, pd)
    np.testing.assert_array_equal(pt.combine(other), jt.combine(other))


# -- the CLI -----------------------------------------------------------------------

def _swaf_config(tmp_path, name, files, **train):
    raw = yaml.safe_load((FIX / "toy_config.yaml").read_text())
    raw.update(name=name, trainer="SWAFTrainer", systems=files,
               target_dir=str(tmp_path / f"{name}_run"),
               train={"max_epochs": 300, "learning_rate": 0.05, **train})
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p, Path(raw["target_dir"])


def test_cli_swaf_end_to_end(tmp_path, capsys):
    """Two systems, one right on PER and one on LOC: the weighted vote
    recovers both entities, as the JAX CLI's does; the files and the
    printed JSON line."""
    from kbner_tpu import cli as jcli

    gold = [("Alice", "B-PER", "B-PER", "O"), ("visited", "O", "O", "O"),
            ("Berlin", "B-LOC", "O", "B-LOC")]
    files = {}
    for split in ("dev", "test"):
        for s, name in ((0, "a"), (1, "b")):
            f = tmp_path / f"{split}.{name}.tsv"
            f.write_text("\n".join(f"{t} {g} {(a, b)[s]}"
                                   for t, g, a, b in gold) + "\n\n")
            files.setdefault(split, []).append(str(f))
    p, run = _swaf_config(tmp_path, "swaf", files)
    jp, jrun = _swaf_config(tmp_path, "jswaf", files)
    capsys.readouterr()
    result = cli.main(["train", "--config", str(p), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result == json.loads(
        (run / "swaf_results.json").read_text())
    assert result["test_micro_f1"] == pytest.approx(1.0)
    assert np.isfinite(result["final_loss"])
    jcli.main(["train", "--config", str(jp)])
    assert (run / "test.swaf.tsv").read_bytes() == \
        (jrun / "test.swaf.tsv").read_bytes()
    assert (run / "test.swaf.tsv").read_text().split("\n")[:3] == \
        ["Alice B-PER", "visited O", "Berlin B-LOC"]
    jresult = json.loads((jrun / "swaf_results.json").read_text())
    assert set(jresult) == set(result)
    assert jresult["test_micro_f1"] == result["test_micro_f1"]


def test_cli_swaf_requires_systems(tmp_path):
    p, _ = _swaf_config(tmp_path, "nosys", {"dev": ["x.tsv"]})
    with pytest.raises(ValueError, match="systems"):
        cli.main(["train", "--config", str(p), "--device", "cpu"])
