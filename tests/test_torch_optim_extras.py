"""The port's ``SGDW`` and ``exp_anneal_schedule`` against kbner_tpu's
``sgdw`` (optax's ``trace`` -> ``add_decayed_weights`` ->
``scale_by_learning_rate``) and ``exp_anneal_schedule`` (optax's
``exponential_decay``). Tolerance rtol 1e-6: the same float32 products
and sums in the same order, XLA free to fuse a product into its sum."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kbner_tpu.train.optim import exp_anneal_schedule as j_exp_anneal
from kbner_tpu.train.optim import sgdw as j_sgdw
from kbner_tpu_torch.train import SGDW, exp_anneal_schedule

STEPS = 5


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w": rng.randn(7, 5).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}


@pytest.mark.parametrize("lr", ["const", "exp_anneal"])
@pytest.mark.parametrize("wd", [0.01, 0.0])
def test_sgdw_matches_optax(wd, lr):
    lr_j = 0.05 if lr == "const" else j_exp_anneal(0.05, 0.7)
    lr_t = 0.05 if lr == "const" else exp_anneal_schedule(0.05, 0.7)
    init = _tree(0)
    grads = [_tree(1 + i) for i in range(STEPS)]

    tx = j_sgdw(lr_j, momentum=0.9, weight_decay=wd)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    want = []
    for g in grads:
        updates, state = tx.update(
            {k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
        want.append(({k: np.asarray(v) for k, v in params.items()},
                     {k: np.asarray(v) for k, v in state[0].trace.items()}))

    ps = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in init.items()}
    opt = SGDW(list(ps.values()), lr=lr_t, momentum=0.9, weight_decay=wd)
    for g, (w_params, w_trace) in zip(grads, want):
        for k, p in ps.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in ps.items():
            np.testing.assert_allclose(p.detach().numpy(), w_params[k],
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(
                opt.state[p]["momentum_buffer"].numpy(), w_trace[k],
                rtol=1e-6, atol=0)
    assert opt.param_groups[0]["count"] == STEPS


def test_sgdw_skips_parameters_without_gradients():
    p = torch.nn.Parameter(torch.ones(3))
    opt = SGDW([p], lr=0.1, weight_decay=0.5)
    opt.step()
    assert torch.equal(p.detach(), torch.ones(3))
    assert not opt.state[p]


def test_exp_anneal_schedule_matches_reference():
    want = j_exp_anneal(5e-6, 0.5)
    got = exp_anneal_schedule(5e-6, 0.5)
    for step in range(11):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6)
