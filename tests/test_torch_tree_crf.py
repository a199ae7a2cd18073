"""The port's projective tree CRF (``kbner_tpu_torch/ops/tree_crf.py``)
against ``kbner_tpu/ops/tree_crf.py`` on the same seeded numpy scores:
the log partition, the marginals, the full and the partial loss and the
loss's gradient, for B=3 and grids up to n=8 with ragged word masks; and
against brute-force enumeration of every projective tree for n <= 5.

Tolerances: float32 against float32 at rtol 1e-5 / atol 1e-4 for the log
partition and the losses (sums of up to n-1 log-sum-exps of values up to
~25), atol 1e-5 for the marginals and gradients (probabilities); the
brute force runs in float64 and the port in float32, atol 1e-4.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.ops import tree_crf as J
from kbner_tpu_torch.ops import tree_crf as P

RTOL, ATOL, P_ATOL = 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _projective(rng, lo, hi, head, out):
    """A random projective subtree over words ``lo..hi`` under ``head``:
    a random word of the span takes ``head``, the two sides recurse."""
    if lo > hi:
        return
    r = rng.randint(lo, hi + 1)
    out[r - 1] = head
    _projective(rng, lo, r - 1, r, out)
    _projective(rng, r + 1, hi, r, out)


def _inputs(seed, n, lens, scale=3.0):
    """Scores, ragged word masks and a random single-root projective gold
    tree per sentence (padding heads 0)."""
    rng = np.random.RandomState(seed)
    scores = (scale * rng.randn(len(lens), n, n)).astype(np.float32)
    word_mask = np.zeros((len(lens), n - 1), np.int32)
    heads = np.zeros((len(lens), n - 1), np.int32)
    for b, length in enumerate(lens):
        word_mask[b, :length] = 1
        _projective(rng, 1, length, 0, heads[b])
    return scores, word_mask, heads, rng


CASES = [(0, 8, [7, 4, 1]), (1, 8, [3, 7, 5]), (2, 6, [5, 5, 2]),
         (3, 2, [1, 1, 0]), (4, 5, [0, 2, 4])]


@pytest.mark.parametrize("seed,n,lens", CASES)
def test_inside_marginals_and_losses_match_jax(seed, n, lens):
    scores, wm, heads, rng = _inputs(seed, n, lens)
    s, m = torch.from_numpy(scores), torch.from_numpy(wm)
    js, jm = jnp.asarray(scores), jnp.asarray(wm)
    np.testing.assert_allclose(
        P.tree_crf_inside(s, m).numpy(),
        np.asarray(J.tree_crf_inside(js, jm)), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        P.tree_crf_marginals(s, m).numpy(),
        np.asarray(J.tree_crf_marginals(js, jm)), atol=P_ATOL)
    # a gold tree for the full loss; a partial one with about half of the
    # heads unannotated (-1), each annotated head taken from the full one
    partial_heads = np.where(rng.rand(*heads.shape) < 0.5, -1, heads)
    for h, partial in ((heads, False), (partial_heads, True)):
        got = P.tree_crf_loss(s, m, torch.from_numpy(h), partial=partial)
        want = J.tree_crf_loss(js, jm, jnp.asarray(h), partial=partial)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("partial", [False, True])
def test_loss_gradient_matches_jax(partial):
    """Autograd reaches the scores through every out-of-place update:
    the gradient of the summed loss equals ``jax.grad``'s."""
    scores, wm, heads, rng = _inputs(5, 7, [6, 3, 4])
    heads = np.where(rng.rand(*heads.shape) < 0.3, -1, heads) if partial \
        else heads
    s = torch.from_numpy(scores).requires_grad_(True)
    P.tree_crf_loss(s, torch.from_numpy(wm), torch.from_numpy(heads),
                    partial=partial).sum().backward()
    want = jax.grad(lambda x: jnp.sum(J.tree_crf_loss(
        x, jnp.asarray(wm), jnp.asarray(heads), partial=partial)))(
            jnp.asarray(scores))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want),
                               atol=P_ATOL)


def test_marginals_are_differentiable():
    """With scores that require a gradient, the marginals keep their
    graph (a second derivative), as ``jax.grad`` of them does."""
    scores, wm, _, _ = _inputs(6, 5, [4, 2, 3])
    w = np.random.RandomState(7).randn(*scores.shape).astype(np.float32)
    s = torch.from_numpy(scores).requires_grad_(True)
    (P.tree_crf_marginals(s, torch.from_numpy(wm))
     * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda x: jnp.sum(J.tree_crf_marginals(
        x, jnp.asarray(wm)) * w))(jnp.asarray(scores))
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(want), atol=1e-4)


# -- brute force --------------------------------------------------------------

def _ancestors(heads, x):
    out = []
    while x != 0:
        x = heads[x - 1]
        out.append(x)
        if len(out) > len(heads) + 1:
            return None
    return out


def _projective_trees(n):
    """Every single-root projective head assignment of grid size n."""
    trees = []
    for heads in itertools.product(range(n), repeat=n - 1):
        if sum(h == 0 for h in heads) != 1 or any(
                h == d + 1 for d, h in enumerate(heads)):
            continue
        if any(_ancestors(heads, d) is None for d in range(1, n)):
            continue
        if all(h == k or h in _ancestors(heads, k)
               for d in range(1, n)
               for h in (heads[d - 1],)
               for k in range(min(h, d) + 1, max(h, d))):
            trees.append(heads)
    return trees


def _lse(xs):
    xs = np.asarray(xs, np.float64)
    return xs.max() + np.log(np.exp(xs - xs.max()).sum())


def _score(scores, heads):
    return sum(scores[d, heads[d - 1]] for d in range(1, len(heads) + 1))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_against_brute_force_enumeration(n):
    """logZ, every marginal, the loss of a gold tree and the partial loss
    with only the first word's head annotated, against sums over every
    projective tree in float64."""
    lens = [n - 1, max(n - 2, 1), 1]
    scores, wm, _, _ = _inputs(10 + n, n, lens)
    s, m = torch.from_numpy(scores), torch.from_numpy(wm)
    log_z = P.tree_crf_inside(s, m).numpy()
    marg = P.tree_crf_marginals(s, m).numpy()
    heads = np.zeros((len(lens), n - 1), np.int32)
    heads[:, 1:] = 1  # word 1 the root's child, the others its dependents
    loss = P.tree_crf_loss(s, m, torch.from_numpy(heads)).numpy()
    part = np.full_like(heads, -1)
    part[:, 0] = 0
    ploss = P.tree_crf_loss(s, m, torch.from_numpy(part), partial=True)
    for b, length in enumerate(lens):
        sc = scores[b].astype(np.float64)
        trees = _projective_trees(length + 1)
        ws = np.array([_score(sc, t) for t in trees])
        want_z = _lse(ws)
        assert abs(log_z[b] - want_z) < ATOL
        p = np.exp(ws - want_z)
        want_m = np.zeros((n, n))
        for t, pi in zip(trees, p):
            for d in range(1, length + 1):
                want_m[d, t[d - 1]] += pi
        np.testing.assert_allclose(marg[b], want_m, atol=ATOL)
        gold = _score(sc, tuple(heads[b, :length]))
        assert abs(loss[b] - (want_z - gold)) < ATOL
        rooted = [w for t, w in zip(trees, ws) if t[0] == 0]
        assert abs(float(ploss[b]) - (want_z - _lse(rooted))) < ATOL
