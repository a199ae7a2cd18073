"""The port's biaffine parsers (``kbner_tpu_torch/models/biaffine.py``)
against ``kbner_tpu/models/biaffine.py``: the gold arrays of every
``encode_*`` function, then, for the tree parser under ``ce``, ``crf`` and
``partial``, the graph parser and span NER, the scores, the loss and every
parameter's gradient from the same Flax weights (perturbed with seeded
numpy noise, so the biaffine weights, which start at zero, are not),
carried over with ``weights.from_jax_params``; each decode on the same
logits (ties included); and the host decoders on random matrices with
ties; and the port's own ``single_root_eisner`` against brute force,
with the trainer's repair chain (ROADMAP C).

Tolerances (float32 on both sides, tiny encoder): scores atol 1e-5; the
loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-5 (the tree CRF's
gradients are sums over up to W inside steps); decodes equal.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.dictionary import Dictionary as JDictionary
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import biaffine as JB
from kbner_tpu_torch.data.conll import SentenceRecord
from kbner_tpu_torch.data.dictionary import Dictionary
from kbner_tpu_torch.data.encode import encode_batch
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models import biaffine as PB
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.weights import from_jax_params, to_jax_params

VOCAB = 997
RELS = ["root", "nsubj", "obj", "det", "amod", "advmod"]
LABELS = ["PER", "LOC", "ORG"]
SCORE_ATOL, RTOL, GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-5, 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _projective(rng, lo, hi, head, out):
    if lo > hi:
        return
    r = rng.randint(lo, hi + 1)
    out[r - 1] = head
    _projective(rng, lo, r - 1, r, out)
    _projective(rng, r + 1, hi, r, out)


def _bioes(rng, n):
    tags, i = ["O"] * n, 0
    while i < n:
        size = rng.randint(1, 4)
        if rng.rand() < 0.4 and i + size <= n:
            lab = LABELS[rng.randint(len(LABELS))]
            if size == 1:
                tags[i] = f"S-{lab}"
            else:
                tags[i:i + size] = ([f"B-{lab}"] + [f"I-{lab}"] * (size - 2)
                                    + [f"E-{lab}"])
        i += size
    return tags


def _layers(seed=0, lengths=(6, 1, 9, 3), unannotated=0.0):
    """Per sentence: tokens, a random projective tree (``_`` heads with
    probability ``unannotated``), relations, enhanced-UD cells with a
    second head on some words, and BIOES tags."""
    rng = np.random.RandomState(seed)
    out = []
    for n in lengths:
        heads = np.zeros(n, np.int64)
        _projective(rng, 1, n, 0, heads)
        rels = [RELS[0] if h == 0 else RELS[rng.randint(1, len(RELS))]
                for h in heads]
        deps = [f"{h}:{r}" for h, r in zip(heads, rels)]
        for w in range(n):
            if rng.rand() < 0.3:
                h2 = rng.randint(0, n + 1)
                if h2 not in (heads[w], w + 1):
                    deps[w] += f"|{h2}:{RELS[rng.randint(1, len(RELS))]}"
        head_col = [("_" if rng.rand() < unannotated else str(h))
                    for h in heads]
        out.append({"tokens": [f"w{rng.randint(50)}" for _ in range(n)],
                    "head": head_col, "deprel": rels, "deps": deps,
                    "ner": _bioes(rng, n)})
    return out


def _records(cls, layers):
    return [cls(tokens=list(s["tokens"]),
                tags={k: list(s[k]) for k in ("head", "deprel", "deps",
                                              "ner")})
            for s in layers]


def _dicts(cls):
    rel, sem, lab = cls(), cls(), cls()
    sem.add_item("<unk>")
    lab.add_item("O")
    for r in RELS:
        rel.add_item(r)
        sem.add_item(r)
    for x in LABELS:
        lab.add_item(x)
    return rel, sem, lab


def _batches(layers):
    """(JAX batch arrays, port batch arrays) with every task's gold
    arrays attached by each package's ``encode_*``."""
    jeb = j_encode(_records(JRecord, layers), JTokenizer(vocab_size=VOCAB))
    peb = encode_batch(_records(SentenceRecord, layers),
                       HashTokenizer(vocab_size=VOCAB))
    for mod, eb, (rel, sem, lab) in ((JB, jeb, _dicts(JDictionary)),
                                     (PB, peb, _dicts(Dictionary))):
        mod.encode_dependency_arrays(eb, rel_dict=rel)
        mod.encode_semdep_arrays(eb, rel_dict=sem)
        mod.encode_span_labels(eb, label_dict=lab)
    return ({k: jnp.asarray(v) for k, v in jeb.arrays().items()},
            {k: torch.from_numpy(v) for k, v in peb.arrays().items()})


def test_encoded_arrays_match_jax():
    """heads (with -1 for ``_``), rel_ids, arc and relation matrices and
    span labels are the JAX package's arrays."""
    jb, pb = _batches(_layers(1, unannotated=0.3))
    assert set(jb) == set(pb)
    for k in jb:
        np.testing.assert_array_equal(pb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    assert (pb["heads"] < 0).any() and (pb["arc_matrix"].sum(-1) > 1).any()
    assert pb["span_labels"].any()


MODELS = {
    "ce": ("dep", dict(arc_loss="ce")),
    "crf": ("dep", dict(arc_loss="crf")),
    "partial": ("dep", dict(arc_loss="crf", partial=True)),
    "semdep": ("semdep", dict(arc_threshold=0.5)),
    "ner_dp": ("ner", dict(max_span_len=4)),
}


def _pair(name):
    """(Flax model, perturbed Flax params, port model with the same
    weights, JAX batch, port batch)."""
    kind, kw = MODELS[name]
    layers = _layers(2, unannotated=0.3 if name == "partial" else 0.0)
    jb, pb = _batches(layers)
    jenc, enc = JXLMRConfig.tiny(vocab_size=VOCAB), XLMRConfig.tiny(
        vocab_size=VOCAB)
    if kind == "dep":
        jm = JB.BiaffineParser(JB.BiaffineConfig(
            jenc, num_rels=len(RELS), arc_dim=16, rel_dim=8, **kw))
        pm = PB.BiaffineParser(PB.BiaffineConfig(
            enc, num_rels=len(RELS), arc_dim=16, rel_dim=8, **kw),
            device="cpu", seed=3)
    elif kind == "semdep":
        jm = JB.SemanticDependencyParser(JB.SemDepConfig(
            jenc, num_rels=len(RELS) + 1, arc_dim=16, rel_dim=8, **kw))
        pm = PB.SemanticDependencyParser(PB.SemDepConfig(
            enc, num_rels=len(RELS) + 1, arc_dim=16, rel_dim=8, **kw),
            device="cpu", seed=3)
    else:
        jm = JB.BiaffineNER(JB.BiaffineNERConfig(
            jenc, num_labels=len(LABELS) + 1, span_dim=16, **kw))
        pm = PB.BiaffineNER(PB.BiaffineNERConfig(
            enc, num_labels=len(LABELS) + 1, span_dim=16, **kw),
            device="cpu", seed=3)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jb, method=jm.loss)
    rng = np.random.RandomState(4)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    pm.load_state_dict(from_jax_params(np_params, pm), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, np_params), pm, jb, pb


@pytest.mark.parametrize("name", list(MODELS))
def test_scores_loss_and_every_gradient_match_flax(name):
    jm, params, pm, jb, pb = _pair(name)
    want_scores = jm.apply(params, jb, method=jm.scores)
    got_scores = pm.scores(pb)
    if isinstance(got_scores, torch.Tensor):
        got_scores, want_scores = (got_scores,), (want_scores,)
    for g, w in zip(got_scores, want_scores):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=SCORE_ATOL, rtol=1e-5)
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
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=n)
    # the tree crosses back unchanged
    back = to_jax_params(pm.state_dict(), pm)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_matches_flax(name):
    """Each model's decode from the same weights: heads and relations
    (MBR heads under the tree CRF), the arcs of the graph, the chosen
    spans and their scores; and the tree CRF's marginals."""
    jm, params, pm, jb, pb = _pair(name)
    want = jm.apply(params, jb, method=jm.decode)
    got = pm.decode(pb)
    if name == "ner_dp":
        assert [[s[:3] for s in sent] for sent in got] == \
            [[s[:3] for s in sent] for sent in want]
        np.testing.assert_allclose([s[3] for sent in got for s in sent],
                                   [s[3] for sent in want for s in sent],
                                   atol=1e-5)
        assert any(got)
        return
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if name in ("crf", "partial"):
        np.testing.assert_allclose(
            pm.marginals(pb).numpy(),
            np.asarray(jm.apply(params, jb, method=jm.marginals)), atol=1e-5)


def _fixed(cls, *outs):
    """A Flax subclass whose ``scores`` returns the batch's ``outs``."""
    class Fixed(cls):
        def scores(self, batch, deterministic=True):
            got = tuple(batch[k] for k in outs)
            return got if len(got) > 1 else got[0]
    return Fixed


def test_decodes_on_the_same_logits_with_ties():
    """Integer-valued scores (many ties): argmax heads and relations, the
    graph's threshold and fallback, and the greedy span order break ties
    as the JAX decodes do."""
    rng = np.random.RandomState(8)
    B, W, R, L = 3, 7, 4, 4
    wm = np.zeros((B, W), np.int32)
    for b, n in enumerate((7, 4, 1)):
        wm[b, :n] = 1
    s_arc = rng.randint(-2, 3, size=(B, W + 1, W + 1)).astype(np.float32)
    s_rel = rng.randint(-2, 3, size=(B, W + 1, W + 1, R)).astype(np.float32)
    spans = rng.randint(-2, 3, size=(B, W, W, L)).astype(np.float32)
    enc = JXLMRConfig.tiny(vocab_size=VOCAB)
    jb = {"word_mask": jnp.asarray(wm), "s_arc": jnp.asarray(s_arc),
          "s_rel": jnp.asarray(s_rel), "spans": jnp.asarray(spans)}
    pb = {"word_mask": torch.from_numpy(wm)}
    root = {"params": {"root": jnp.zeros((enc.hidden_size,))}}
    for kind in ("ce", "crf"):
        jm = _fixed(JB.BiaffineParser, "s_arc", "s_rel")(
            JB.BiaffineConfig(enc, num_rels=R, arc_loss=kind))
        pm = PB.BiaffineParser(PB.BiaffineConfig(
            XLMRConfig.tiny(vocab_size=VOCAB), num_rels=R, arc_loss=kind),
            device="cpu")
        pm.scores = lambda batch: (torch.from_numpy(s_arc),
                                   torch.from_numpy(s_rel))
        want = jm.apply(root, jb, method=jm.decode)
        for g, w in zip(pm.decode(pb), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for thr in (0.5, 0.95):
        jm = _fixed(JB.SemanticDependencyParser, "s_arc", "s_rel")(
            JB.SemDepConfig(enc, num_rels=R, arc_threshold=thr))
        pm = PB.SemanticDependencyParser(PB.SemDepConfig(
            XLMRConfig.tiny(vocab_size=VOCAB), num_rels=R,
            arc_threshold=thr), device="cpu")
        pm.scores = lambda batch: (torch.from_numpy(s_arc),
                                   torch.from_numpy(s_rel))
        want = jm.apply(root, jb, method=jm.decode)
        for g, w in zip(pm.decode(pb), want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for max_len in (1, 3, 30):
        jm = _fixed(JB.BiaffineNER, "spans")(JB.BiaffineNERConfig(
            enc, num_labels=L, max_span_len=max_len))
        want = jm.apply({}, jb, method=jm.decode)
        got = PB.decode_spans(torch.from_numpy(spans), wm, max_len)
        assert [[s[:3] for s in x] for x in got] == \
            [[s[:3] for s in x] for x in want]
        np.testing.assert_allclose([s[3] for x in got for s in x],
                                   [s[3] for x in want for s in x],
                                   atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_host_decoders_match_jax_with_ties(seed):
    """chu_liu_edmonds, mst_decode and eisner_decode on random matrices of
    small integers (ties everywhere) and of normals."""
    rng = np.random.RandomState(seed)
    n = 3 + 2 * seed
    for scores in (rng.randint(-2, 3, size=(n, n)).astype(np.float64),
                   rng.randn(n, n)):
        np.testing.assert_array_equal(PB.chu_liu_edmonds(scores),
                                      JB.chu_liu_edmonds(scores))
        np.testing.assert_array_equal(PB.eisner_decode(scores),
                                      JB.eisner_decode(scores))
    s_arc = rng.randint(-2, 3, size=(3, n, n)).astype(np.float32)
    wm = np.zeros((3, n - 1), np.int32)
    for b, k in enumerate((n - 1, 1, n // 2)):
        wm[b, :k] = 1
    np.testing.assert_array_equal(PB.mst_decode(s_arc, wm),
                                  JB.mst_decode(s_arc, wm))


def _single_root_projective(n):
    """Every head assignment of n-1 words with one word on ROOT, no cycle
    and no crossing arcs (each arc's span lies under its head)."""
    out = []
    for heads in itertools.product(range(n), repeat=n - 1):
        h = (0,) + heads
        if sum(x == 0 for x in heads) != 1 or any(
                h[d] == d for d in range(1, n)):
            continue

        def chain(d):
            seen = []
            while d != 0 and d not in seen and len(seen) <= n:
                seen.append(d)
                d = h[d]
            return seen if d == 0 else None

        chains = [chain(d) for d in range(1, n)]
        if any(c is None for c in chains):
            continue
        if all(h[d] == 0 or h[d] in chains[k - 1] for d in range(1, n)
               for k in range(min(d, h[d]) + 1, max(d, h[d]))):
            out.append(h)
    return out


@pytest.mark.parametrize("n", [2, 3, 4, 5, 6])
def test_single_root_eisner_is_the_best_single_root_projective_tree(n):
    rng = np.random.RandomState(n)
    trees = _single_root_projective(n)
    for _ in range(4):
        scores = rng.randn(n, n)
        got = PB.single_root_eisner(scores)
        best = max(sum(scores[d, t[d]] for d in range(1, n)) for t in trees)
        assert tuple(got) in set(trees), got
        assert sum(scores[d, got[d]] for d in range(1, n)) == \
            pytest.approx(best, abs=1e-12)


def test_parser_trainer_repairs_into_trees_as_the_reference_where_it_can():
    """Greedy heads that are not a tree go through the reference's MST
    repair; where that leaves a cycle or several root children (the
    reference keeps it so, ROADMAP C), the port takes
    ``single_root_eisner``'s tree. Everywhere else the heads equal the
    reference trainer's."""
    from kbner_tpu.train.parser_trainer import \
        _has_cycle_or_multiroot as j_not_tree
    from kbner_tpu_torch.train.parser_trainer import ParserTrainer

    rng = np.random.RandomState(11)
    B, W = 24, 12
    lengths = rng.randint(1, W + 1, size=B)
    records = [SentenceRecord(tokens=[f"w{i}" for i in range(n)],
                              tags={"head": ["0"] * n, "deprel": ["root"] * n})
               for n in lengths]
    eb = encode_batch(records, HashTokenizer(vocab_size=VOCAB))
    wm = np.asarray(eb.word_mask)
    greedy = rng.randint(0, W + 1, size=(B, eb.word_mask.shape[1]))
    s_arc = rng.randn(B, wm.shape[1] + 1, wm.shape[1] + 1).astype(np.float32)

    class Fixed(torch.nn.Module):
        def decode(self, batch, return_scores=False):
            return (torch.from_numpy(greedy.astype(np.int32)),
                    torch.zeros_like(torch.from_numpy(greedy)),
                    torch.from_numpy(s_arc))

    trainer = ParserTrainer(Fixed(), None, None, Dictionary(), device="cpu")
    heads, _ = trainer.predict(eb)
    n_fallback = 0
    for b, n in enumerate(lengths):
        want = greedy[b, :n]
        if j_not_tree(want):
            want = JB.mst_decode(s_arc[b:b + 1], wm[b:b + 1])[0, :n]
        if j_not_tree(want):
            n_fallback += 1
            want = PB.single_root_eisner(s_arc[b, :n + 1, :n + 1])[1:]
        np.testing.assert_array_equal(heads[b, :n], want)
        assert not j_not_tree(heads[b, :n])
    assert trainer.tree_repairs == n_fallback > 0
    assert trainer.mst_repairs > n_fallback
