"""The PyTorch port's MFVI head (``ops/mfvi.py``) against kbner_tpu's on
the same seeded numpy inputs: rank-space triple messages against the
materialized triple potentials and against kbner_tpu's messages; the
mean-field iterations over padded sentences with and without third
order; ``MFVIHead``'s loss, every parameter's gradient against
``jax.grad``, and its decode; the head's Flax tree both ways.

Tolerances, float32 on the CPU: messages, posteriors and losses rtol
1e-5, atol 1e-6; gradients rtol 1e-4, atol 1e-6; decoded tags equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.ops import mfvi as jmfvi
from kbner_tpu_torch import weights
from kbner_tpu_torch.ops import mfvi

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B=3, T=7, H=6, K=5):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, T, H).astype(np.float32)
    unary = rng.randn(B, T, K).astype(np.float32)
    mask = np.ones((B, T), np.int32)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    tags = rng.randint(0, K, size=(B, T)).astype(np.int32)
    return feats, unary, mask, tags


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def _factors(rng, B, T, R, K):
    return [rng.randn(*s).astype(np.float32)
            for s in ((B, T - 2, R), (K, R), (K, R), (K, R))]


def test_ternary_messages_equal_the_dense_einsums():
    """The rank-space messages into t+2, t+1 and t are the dense
    ``nsa,nsb,nsabc->nsc``, ``nsa,nsc,nsabc->nsb`` and
    ``nsb,nsc,nsabc->nsa`` sums, and kbner_tpu's messages."""
    rng = np.random.RandomState(0)
    B, T, R, K = 2, 6, 4, 3
    factors = _factors(rng, B, T, R, K)
    q = torch.softmax(torch.from_numpy(rng.randn(B, T, K).astype(
        np.float32)), -1)
    tmask = torch.from_numpy((rng.rand(B, T - 2) > 0.3).astype(np.float32))
    got = mfvi.ternary_messages(q, _t(*factors), tmask)
    dense = mfvi.dense_ternary(_t(*factors)) * tmask[..., None, None, None]
    qa, qb, qc = q[:, :-2], q[:, 1:-1], q[:, 2:]
    want = torch.zeros_like(q)
    want[:, 2:] += torch.einsum("nsa,nsb,nsabc->nsc", qa, qb, dense)
    want[:, 1:-1] += torch.einsum("nsa,nsc,nsabc->nsb", qa, qc, dense)
    want[:, :-2] += torch.einsum("nsb,nsc,nsabc->nsa", qb, qc, dense)
    _close(got, want.numpy())
    _close(got, jmfvi.ternary_messages(jnp.asarray(q.numpy()), [
        jnp.asarray(f) for f in factors], jnp.asarray(tmask.numpy())))
    _close(mfvi.dense_ternary(_t(*factors)), jmfvi.dense_ternary(
        [jnp.asarray(f) for f in factors]))


@pytest.mark.parametrize("third", [False, True])
@pytest.mark.parametrize("iterations", [0, 1, 3])
def test_mean_field_iterate_matches_the_reference(third, iterations):
    rng = np.random.RandomState(1 + iterations)
    B, T, K, R = 3, 7, 4, 5
    _, unary, mask, _ = _inputs(2, B, T, 6, K)
    binary = rng.randn(B, T - 1, K, K).astype(np.float32)
    factors = _factors(rng, B, T, R, K) if third else None
    got = mfvi.mean_field_iterate(
        *_t(unary, binary, mask), iterations,
        ternary_factors=_t(*factors) if third else None)
    want = jmfvi.mean_field_iterate(
        jnp.asarray(unary), jnp.asarray(binary), jnp.asarray(mask),
        iterations, ternary_factors=[jnp.asarray(f) for f in factors]
        if third else None)
    _close(got, want)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-6)


def _heads(third, seed, H=6, K=5, rank=4):
    jm = jmfvi.MFVIHead(K, rank=rank, iterations=3, use_third_order=third)
    feats, unary, mask, _ = _inputs(seed, H=H, K=K)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(feats),
                     jnp.asarray(unary), jnp.asarray(mask),
                     method=jm.posteriors)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.2 * np.random.RandomState(seed)
                   .standard_normal(x.shape)).astype(np.float32), params)
    pm = mfvi.MFVIHead(H, K, rank=rank, iterations=3,
                       use_third_order=third, device="cpu")
    pm.load_state_dict(weights.from_jax_params(params, pm), strict=True)
    return jm, params, pm


@pytest.mark.parametrize("third", [False, True])
def test_head_loss_gradients_and_decode_match_flax(third):
    jm, params, pm = _heads(third, seed=3)
    feats, unary, mask, tags = _inputs(4, K=5)
    jin = [jnp.asarray(a) for a in (feats, unary)]
    want, grads = jax.value_and_grad(lambda p, f, u: jm.apply(
        p, f, u, jnp.asarray(tags), jnp.asarray(mask), method=jm.loss),
        argnums=(0, 1, 2))(params, *jin)
    f_t, u_t = (torch.from_numpy(a).requires_grad_() for a in (feats, unary))
    loss = pm.loss(f_t, u_t, *_t(tags, mask))
    _close(loss, want)
    loss.backward()
    want_p = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads[0]), pm)
    named = dict(pm.named_parameters())
    assert named.keys() == want_p.keys()
    for name, p in named.items():
        _close(p.grad, want_p[name].numpy(), rtol=GRAD_RTOL, msg=name)
    _close(f_t.grad, grads[1], rtol=GRAD_RTOL, msg="feats")
    _close(u_t.grad, grads[2], rtol=GRAD_RTOL, msg="unary")
    with torch.no_grad():
        q = pm.posteriors(*_t(feats, unary, mask))
        tags_got = pm.decode(*_t(feats, unary, mask))
    _close(q, jm.apply(params, *jin, jnp.asarray(mask),
                       method=jm.posteriors))
    want_tags = np.asarray(jm.apply(params, *jin, jnp.asarray(mask),
                                    method=jm.decode))
    assert tags_got.dtype == torch.int32
    np.testing.assert_array_equal(tags_got.numpy(), want_tags)


@pytest.mark.parametrize("third", [False, True])
def test_head_tree_crosses_both_ways(third):
    _, params, pm = _heads(third, seed=5)
    tree = weights.to_jax_params(pm.state_dict(), pm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, tree, params))


def test_head_is_drawn_like_flax():
    """Factor tables normal(0, 0.02), Dense kernels lecun-normal."""
    pm = mfvi.MFVIHead(256, 9, rank=64, use_third_order=True, device="cpu")
    jm = jmfvi.MFVIHead(9, rank=64, use_third_order=True)
    feats, unary, mask, _ = _inputs(0, B=3, T=5, H=256, K=9)
    want = weights.from_jax_params(jax.tree_util.tree_map(
        np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(feats),
                            jnp.asarray(unary), jnp.asarray(mask),
                            method=jm.posteriors)), pm)
    for name, p in pm.state_dict().items():
        assert float(p.std()) == pytest.approx(float(want[name].std()),
                                               rel=0.15), name
