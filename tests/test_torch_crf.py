"""The PyTorch port's CRF ops and losses against kbner_tpu's on the same
numpy inputs: values, and gradients against ``jax.grad``.

Tolerances: values rtol 1e-5 (float32 log-sum-exps taken in another
order); gradients rtol 1e-4, atol 1e-6 (the same, through the backward
recursion).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.ops import crf as jcrf
from kbner_tpu.ops import losses as jlosses
from kbner_tpu_torch.ops import crf, losses

RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, T, K, per_sentence, trailing_context=0):
    """Emissions, tags, a mask with padding and masked interior positions
    (retrieved context), and constrained transitions ([K, K] or one per
    sentence). ``trailing_context`` masks the last columns in every
    sentence, as the context words of a fused batch are."""
    rng = np.random.RandomState(seed)
    em = rng.randn(B, T, K).astype(np.float32)
    tags = rng.randint(0, K - 2, size=(B, T)).astype(np.int32)
    trans = rng.randn(*((B, K, K) if per_sentence else (K, K))).astype(
        np.float32)
    start, stop = K - 2, K - 1
    trans[..., :, start] = -10000.0
    trans[..., stop, :] = -10000.0
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    inner = rng.rand(B, T) < 0.3
    inner[:, 0] = False
    mask[inner] = 0
    if trailing_context:
        mask[:, T - trailing_context:] = 0
    return em, tags, mask, trans, start, stop


CASES = [(6, 9, 7, False, 0), (4, 1, 5, False, 0), (5, 12, 6, True, 0),
         (3, 30, 19, False, 0), (4, 14, 6, False, 6), (3, 10, 5, True, 4)]


def _t(x, grad=False):
    return torch.tensor(x, requires_grad=grad)


@pytest.mark.parametrize("B,T,K,per_sentence,ctx", CASES)
def test_forward_gold_nll_and_grads_match_jax(B, T, K, per_sentence, ctx):
    em, tags, mask, trans, start, stop = _inputs(B * T + K, B, T, K,
                                                 per_sentence, ctx)
    for name in ("crf_forward", "crf_gold_score", "crf_neg_log_likelihood"):
        jf, tf = getattr(jcrf, name), getattr(crf, name)
        extra = () if name == "crf_forward" else (tags,)
        w = np.random.RandomState(T).randn(B).astype(np.float32)

        def j_obj(e, t):
            args = (e,) + tuple(jnp.asarray(x) for x in extra) + (mask, t)
            return jnp.sum(jf(*args, start, stop) * w)

        want = jf(em, *extra, mask, trans, start, stop)
        j_gem, j_gtr = jax.grad(j_obj, argnums=(0, 1))(em, trans)
        e, t = _t(em, True), _t(trans, True)
        got = tf(e, *(torch.from_numpy(x) for x in extra),
                 torch.from_numpy(mask), t, start, stop)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=RTOL, err_msg=name)
        (got * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(e.grad.numpy(), np.asarray(j_gem),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_gtr),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("B,T,K,per_sentence,ctx", CASES)
def test_marginals_and_grads_match_jax(B, T, K, per_sentence, ctx):
    em, _, mask, trans, start, stop = _inputs(B * T + K + 1, B, T, K,
                                              per_sentence, ctx)
    w = np.random.RandomState(K).randn(B, T, K).astype(np.float32)
    want = jcrf.crf_marginals(em, mask, trans, start, stop)
    j_gem, j_gtr = jax.grad(lambda e, t: jnp.sum(
        jcrf.crf_marginals(e, mask, t, start, stop) * w),
        argnums=(0, 1))(em, trans)
    e, t = _t(em, True), _t(trans, True)
    got = crf.crf_marginals(e, torch.from_numpy(mask), t, start, stop)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=1e-7)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(j_gem),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(j_gtr),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("B,T,K,n_best", [(4, 9, 6, 3), (3, 1, 5, 2),
                                          (2, 12, 4, 5), (3, 8, 5, 1)])
def test_nbest_matches_jax(B, T, K, n_best):
    em, _, mask, trans, start, stop = _inputs(B + T + K, B, T, K, False)
    for pad_tag in (0, 1):
        want_tags, want_scores = jcrf.crf_decode_nbest(
            em, mask, trans, start, stop, n_best=n_best, pad_tag=pad_tag)
        got_tags, got_scores = crf.crf_decode_nbest(
            torch.from_numpy(em), torch.from_numpy(mask),
            torch.from_numpy(trans), start, stop, n_best=n_best,
            pad_tag=pad_tag)
        np.testing.assert_array_equal(got_tags.numpy(),
                                      np.asarray(want_tags))
        np.testing.assert_allclose(got_scores.numpy(),
                                   np.asarray(want_scores), rtol=RTOL)


def test_nbest_first_path_is_viterbi_with_per_sentence_transitions():
    em, _, mask, trans, start, stop = _inputs(7, 4, 10, 6, True)
    args = [torch.from_numpy(x) for x in (em, mask, trans)]
    tags, scores = crf.crf_decode_nbest(*args, start, stop, n_best=3)
    v_tags, v_scores = crf.crf_decode(*args, start, stop)
    assert torch.equal(tags[:, 0], v_tags)
    torch.testing.assert_close(scores[:, 0], v_scores)
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())


def test_dropping_all_masked_columns_changes_nothing():
    """The forward recursions skip columns masked in every sentence: the
    result equals a run where one sentence keeps those columns live."""
    em, tags, mask, trans, start, stop = _inputs(3, 3, 12, 5, False, 5)
    full = mask.copy()
    full[0, 7:] = 1  # every column live in sentence 0
    for m in (mask, full):
        e = _t(em, True)
        z = crf.crf_forward(e, torch.from_numpy(m), torch.from_numpy(trans),
                            start, stop)
        zj = jcrf.crf_forward(em, m, trans, start, stop)
        np.testing.assert_allclose(z.detach().numpy(), np.asarray(zj),
                                   rtol=RTOL)


def _plain_viterbi(em, mask, trans, start, stop, pad_tag):
    """Viterbi with one step for every word column, masked or not: the
    loop as it runs without dropping any column."""
    em, mask = torch.from_numpy(em), torch.from_numpy(mask).bool()
    B, T, K = em.shape
    trans = torch.from_numpy(trans)
    if trans.dim() == 2:
        trans = trans.expand(B, K, K)
    identity = torch.arange(K).expand(B, K)
    alpha = trans[:, start, :] + em[:, 0, :]
    bps = []
    for t in range(1, T):
        best, prev = (alpha.unsqueeze(2) + trans).max(dim=1)
        m = mask[:, t, None]
        alpha = torch.where(m, best + em[:, t, :], alpha)
        bps.append(torch.where(m, prev, identity))
    score, tag = (alpha + trans[:, :, stop]).max(dim=1)
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag.unsqueeze(1)).squeeze(1)
        tags.append(tag)
    tags = torch.stack(tags[::-1], dim=1)
    tags = torch.where(mask, tags, torch.full_like(tags, pad_tag))
    return tags.to(torch.int32).numpy(), score.numpy()


def _decode_mask(kind, rng, B, T):
    """Masks of the shapes a served batch gives ``crf_decode``."""
    lengths = rng.randint(1, 9, size=B)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    if kind == "fused":  # a live prefix, then context masked in every row
        return mask
    if kind == "interior":  # and columns masked in some rows only
        inner = rng.rand(B, T) < 0.3
        inner[:, 0] = False
        mask[inner] = 0
        return mask
    if kind == "all_live":
        return np.ones((B, T), np.int32)
    # a stride window that starts in context: column 0 masked in some
    # rows, or in every row
    mask[1::2, 0] = 0
    if kind == "col0_masked_everywhere":
        mask[:, 0] = 0
    return mask


@pytest.mark.parametrize("kind", ["fused", "interior", "all_live",
                                  "col0_masked", "col0_masked_everywhere"])
@pytest.mark.parametrize("per_sentence", [False, True])
@pytest.mark.parametrize("integer", [False, True])
def test_decode_over_live_columns_equals_the_full_loop(kind, per_sentence,
                                                       integer):
    """``crf_decode`` runs over the live columns only, given or found: the
    tags and scores are exactly those of a step for every column, ties
    (integer scores) going to the lowest index."""
    rng = np.random.RandomState(7)
    B, T, K = 5, 40, 6
    draw = ((lambda *s: rng.randint(-2, 3, size=s).astype(np.float32))
            if integer else
            (lambda *s: rng.randn(*s).astype(np.float32)))
    em = draw(B, T, K)
    trans = draw(*((B, K, K) if per_sentence else (K, K)))
    start, stop = K - 2, K - 1
    trans[..., :, start] = -10000.0
    trans[..., stop, :] = -10000.0
    mask = _decode_mask(kind, rng, B, T)
    live = mask.any(0)
    live[0] = True
    cols = crf.live_columns(torch.from_numpy(mask))
    np.testing.assert_array_equal(cols.numpy(), np.nonzero(live)[0])
    args = (torch.from_numpy(em), torch.from_numpy(mask),
            torch.from_numpy(trans), start, stop)
    for pad_tag in (0, 2):
        want_tags, want_score = _plain_viterbi(em, mask, trans, start, stop,
                                               pad_tag)
        for given in (None, cols, torch.arange(T)):
            tags, score = crf.crf_decode(*args, pad_tag=pad_tag, cols=given)
            assert tags.dtype == torch.int32 and tags.shape == (B, T)
            np.testing.assert_array_equal(tags.numpy(), want_tags)
            np.testing.assert_array_equal(score.numpy(), want_score)


def _loss_inputs(seed, B=3, W=7, K=5, H=6):
    rng = np.random.RandomState(seed)
    mask = (rng.rand(B, W) < 0.8).astype(np.int32)
    mask[:, 0] = 1

    def probs():
        x = rng.rand(B, W, K).astype(np.float32) + 0.05
        return x / x.sum(-1, keepdims=True)

    return dict(
        logits=rng.randn(B, W, K).astype(np.float32),
        teacher=rng.randn(B, W, K).astype(np.float32),
        p_student=probs(), p_teacher=probs(),
        feats=rng.randn(B, W, H).astype(np.float32),
        feats_teacher=rng.randn(B, W, H).astype(np.float32),
        tags=rng.randint(0, K, size=(B, W)).astype(np.int32),
        mask=mask)


LOSSES = [
    ("distillation_loss", ("logits", "teacher"), dict(temperature=2.0)),
    ("distillation_loss", ("logits", "teacher"), dict(kind="mse",
                                                     temperature=1.5)),
    ("posterior_distillation_loss", ("p_student", "p_teacher"), {}),
    ("multi_view_loss", ("p_teacher", "p_student"), {}),
    ("multi_view_loss", ("p_teacher", "p_student"), dict(kind="ce")),
    ("feature_l2_loss", ("feats_teacher", "feats"), {}),
    ("token_ce_entropy_loss", ("logits", "tags"), {}),
    ("token_ce_entropy_loss", ("logits", "tags"), dict(entropy_weight=0.3)),
]


@pytest.mark.parametrize("name,keys,kw", LOSSES)
def test_losses_and_grads_match_jax(name, keys, kw):
    """Each loss, and its gradient with respect to both operands (the
    detached side of the reference gets none)."""
    x = _loss_inputs(len(name) + len(kw))
    a, b = x[keys[0]], x[keys[1]]
    jf, tf = getattr(jlosses, name), getattr(losses, name)
    want = jf(a, b, x["mask"], **kw)
    float_b = b.dtype == np.float32
    j_ga, j_gb = jax.grad(
        lambda p, q: jf(p, q if float_b else b, x["mask"], **kw),
        argnums=(0, 1))(a, b.astype(np.float32))
    ta = _t(a, True)
    tb = _t(b, True) if float_b else torch.from_numpy(b)
    got = tf(ta, tb, torch.from_numpy(x["mask"]), **kw)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    got.backward()
    for arr, t, want_grad in ((a, ta, j_ga), (b, tb, j_gb)):
        if arr.dtype != np.float32:
            continue  # integer tags
        # a detached operand gets no gradient on either side
        g = t.grad.numpy() if t.grad is not None else np.zeros_like(arr)
        np.testing.assert_allclose(g, np.asarray(want_grad),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_token_entropy_without_tags_matches_jax():
    x = _loss_inputs(11)
    want = jlosses.token_ce_entropy_loss(x["logits"], None, x["mask"],
                                         entropy_weight=0.5)
    got = losses.token_ce_entropy_loss(torch.from_numpy(x["logits"]), None,
                                       torch.from_numpy(x["mask"]),
                                       entropy_weight=0.5)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
