"""The PyTorch port's tagger against kbner_tpu's Flax tagger: the XLM-R
encoder, Viterbi decode, the encoded batch and the weight carry-over.

The Flax tagger is made at a tiny float32 width, its parameters perturbed
with numpy noise from a seed (so that no bias or LayerNorm term keeps its
init value), and carried over with ``weights.from_jax_params``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.dictionary import make_tag_dictionary as j_tag_dict
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.encode import make_batches as j_make_batches
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.ops.crf import crf_decode as j_crf_decode
from kbner_tpu_torch.data.conll import SentenceRecord
from kbner_tpu_torch.data.dictionary import make_tag_dictionary
from kbner_tpu_torch.data.encode import encode_batch, make_batches
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.ops.crf import crf_decode
from kbner_tpu_torch.weights import from_jax_params

TAGS = ["B-PER", "E-PER", "S-LOC", "B-ORG", "I-ORG", "E-ORG", "S-PER"]
SENTENCES = [
    (["Alice", "Smith", "visited", "Berlin", "."], None),
    (["The", "European", "Union", "met", "in", "Paris", "yesterday",
      "afternoon", "with", "extraordinarilylongwordpieces"], None),
    (["Bob", "works", "<EOS>", "[", "Bob", "]", "is", "a", "person"], None),
    # gold S-X context tags without an <EOS> word mask those positions too
    (["Carol", "met", "Dave", "here"], ["O", "S-X", "S-X", "O"]),
    (["Hi"], None),
]
VOCAB = 997


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(cls):
    out = []
    for tokens, tags in SENTENCES:
        out.append(cls(tokens=list(tokens),
                       tags={"ner": list(tags or ["O"] * len(tokens))}))
    return out


@pytest.fixture(scope="module")
def models():
    """(flax model, perturbed flax params, port tagger with the same
    weights, port tag dictionary, port batch arrays as numpy)."""
    j_tags = j_tag_dict([TAGS])
    j_cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB), j_tags,
        locked_dropout=0.0, word_dropout=0.0)
    batch = j_encode(_records(JRecord), JTokenizer(vocab_size=VOCAB))
    model, params = init_tagger(
        j_cfg, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.arrays().items()})
    rng = np.random.RandomState(0)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)

    tags = make_tag_dictionary([TAGS])
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags)
    tagger = SequenceTagger(cfg, device="cpu", seed=3).eval()
    tagger.load_state_dict(from_jax_params(np_params, cfg), strict=True)
    arrays = encode_batch(_records(SentenceRecord),
                          HashTokenizer(vocab_size=VOCAB)).arrays()
    return (model, jax.tree_util.tree_map(jnp.asarray, np_params), tagger,
            tags, arrays)


def _torch_batch(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def test_encoded_batches_match_jax():
    tok, j_tok = HashTokenizer(VOCAB), JTokenizer(VOCAB)
    assert [tok.encode_word(w) for w in ("a", "Berlin", "超长的词语", "x" * 20)
            ] == [j_tok.encode_word(w)
                  for w in ("a", "Berlin", "超长的词语", "x" * 20)]
    for kw in ({}, {"max_subtokens": 12}):
        got = encode_batch(_records(SentenceRecord), tok, **kw).arrays()
        want = j_encode(_records(JRecord), j_tok, **kw).arrays()
        assert got.keys() == want.keys()
        for key in got:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    got = make_batches(_records(SentenceRecord), tok, None, 2)
    want = j_make_batches(_records(JRecord), j_tok, None, 2)
    assert [[r.tokens for r in b.records] for b in got] == \
        [[r.tokens for r in b.records] for b in want]


def test_weights_cover_every_parameter(models):
    _, params, tagger, _, _ = models
    state = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                            tagger.config)
    assert set(state) == set(tagger.state_dict())
    flax_leaves = jax.tree_util.tree_leaves(params)
    assert sum(x.size for x in flax_leaves) == sum(
        p.numel() for p in tagger.parameters())


def test_encoder_matches_flax(models):
    model, params, tagger, _, arrays = models
    want, _ = model.apply(
        params, jnp.asarray(arrays["input_ids"]),
        jnp.asarray(arrays["attention_mask"]),
        method=lambda m, ids, mask: m.encoder(ids, mask))
    with torch.no_grad():
        got = tagger.encoder(torch.from_numpy(arrays["input_ids"]),
                             torch.from_numpy(arrays["attention_mask"]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_transition_matrix_matches_flax(models):
    model, params, tagger, _, _ = models
    want = model.apply(params, method=lambda m: m.transition_matrix())
    np.testing.assert_array_equal(
        tagger.transition_matrix().detach().numpy(), np.asarray(want))


def test_tagger_decode_matches_flax(models):
    model, params, tagger, _, arrays = models
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    want_em = model.apply(params, jb, method=lambda m, b: m.emissions(b))
    want_tags, want_scores = model.apply(params, jb,
                                         method=lambda m, b: m.decode(b))
    with torch.no_grad():
        got_em = tagger.emissions(_torch_batch(arrays))
    got_tags, got_scores = tagger.decode(_torch_batch(arrays))
    np.testing.assert_allclose(got_em.numpy(), np.asarray(want_em),
                               atol=1e-4)
    assert got_tags.dtype == torch.int32
    np.testing.assert_array_equal(got_tags.numpy(), np.asarray(want_tags))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5)


def test_bfloat16_encoder_keeps_its_dtype():
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB, dtype=torch.bfloat16),
        make_tag_dictionary([TAGS]))
    tagger = SequenceTagger(cfg, device="cpu", seed=0).eval()
    arrays = _torch_batch(encode_batch(_records(SentenceRecord),
                                       HashTokenizer(VOCAB)).arrays())
    with torch.no_grad():
        hidden = tagger.encoder(arrays["input_ids"], arrays["attention_mask"])
        em = tagger.emissions(arrays)
    assert hidden.dtype == torch.bfloat16 and em.dtype == torch.float32
    assert bool(torch.isfinite(em).all())


def _crf_inputs(seed, B, T, K, per_sentence):
    rng = np.random.RandomState(seed)
    em = rng.randn(B, T, K).astype(np.float32)
    shape = (B, K, K) if per_sentence else (K, K)
    trans = rng.randn(*shape).astype(np.float32)
    start, stop = K - 2, K - 1
    trans[..., :, start] = -10000.0
    trans[..., stop, :] = -10000.0
    lengths = rng.randint(1, T + 1, size=B)
    lengths[0] = T
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    # compacted rows: interior positions masked as retrieved context
    inner = rng.rand(B, T) < 0.3
    inner[:, 0] = False
    mask[inner] = 0
    return em, mask, trans, start, stop


@pytest.mark.parametrize("B,T,K,per_sentence", [
    (6, 9, 7, False), (4, 1, 5, False), (5, 12, 6, True), (3, 30, 19, False)])
def test_crf_decode_matches_jax(B, T, K, per_sentence):
    em, mask, trans, start, stop = _crf_inputs(B * T + K, B, T, K,
                                               per_sentence)
    for pad_tag in (0, 2):
        tags, scores = crf_decode(torch.from_numpy(em),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(trans), start, stop,
                                  pad_tag=pad_tag)
        j_tags, j_scores = j_crf_decode(em, mask, trans, start, stop,
                                        pad_tag=pad_tag)
        np.testing.assert_array_equal(tags.numpy(), np.asarray(j_tags))
        np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores),
                                   rtol=1e-5)


def test_crf_decode_masking_equals_compaction():
    em, mask, trans, start, stop = _crf_inputs(3, 1, 10, 6, False)
    keep = np.nonzero(mask[0])[0]
    tags, score = crf_decode(*map(torch.from_numpy, (em, mask, trans)),
                             start, stop)
    c_tags, c_score = crf_decode(
        torch.from_numpy(em[:, keep]),
        torch.ones(1, len(keep), dtype=torch.int32),
        torch.from_numpy(trans), start, stop)
    assert tags[0, keep].tolist() == c_tags[0].tolist()
    torch.testing.assert_close(score, c_score)


@pytest.mark.parametrize("kw", [
    dict(), dict(num_languages=2),
    dict(num_languages=2, transition_attention=True)])
def test_decode_of_a_fused_batch_equals_the_full_loop(kw):
    """``decode`` finds the live word columns before the forward and runs
    the Viterbi over them: the same tags and scores as a step for every
    word column, retrieved context included, under ``[K, K]`` and
    per-sentence transitions."""
    tags = make_tag_dictionary([TAGS + ["S-X"]])
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags, **kw)
    tagger = SequenceTagger(cfg, device="cpu", seed=4).eval()
    ctx = ["[", "Berlin", "]", "is", "the", "capital", "of", "Germany"] * 3
    records = [SentenceRecord(tokens=r.tokens + ["<EOS>"] + ctx,
                              tags={"ner": r.tags["ner"]
                                    + ["S-X"] * (1 + len(ctx))},
                              lang_id=r.lang_id)
               for r in _tagged_records(SentenceRecord)]
    batch = _torch_batch(encode_batch(records, HashTokenizer(VOCAB),
                                      tags).arrays())
    mask = batch["crf_mask"].bool()
    W = mask.shape[1]
    assert int(mask.any(0).sum()) < W // 2  # most columns are context
    for pad_tag in (0, 3):
        got_tags, got_scores = tagger.decode(batch, pad_tag=pad_tag)
        with torch.no_grad():
            feats, em = tagger._features_and_emissions(batch)
            want_tags, want_scores = crf_decode(
                em, mask, tagger._batch_transitions(batch, feats),
                cfg.start_idx, cfg.stop_idx, pad_tag=pad_tag,
                cols=torch.arange(W))
        np.testing.assert_array_equal(got_tags.numpy(), want_tags.numpy())
        np.testing.assert_array_equal(got_scores.numpy(),
                                      want_scores.numpy())


def test_unported_decode_options_raise():
    """The options that used to raise here (transition attention and the
    distillation losses) now run, held to the Flax tagger: the attention
    tagger's loss and Viterbi tags, and its logit and k-best
    distillation losses on the same teacher inputs (their gradients:
    tests/test_torch_distill.py)."""
    model, params, tagger, arrays = _pair(num_languages=2,
                                          transition_attention=True)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch = _torch_batch(arrays)
    rng = np.random.RandomState(2)
    B, W = arrays["word_mask"].shape
    K = tagger.config.num_tags
    logits = rng.standard_normal((B, W, K)).astype(np.float32)
    paths = rng.randint(0, K - 2, size=(B, 3, W)).astype(np.int32)
    pw = rng.dirichlet(np.ones(3), size=B).astype(np.float32)
    want = [
        model.apply(params, jb, deterministic=True, method=model.loss),
        model.apply(params, jb, jnp.asarray(logits), deterministic=True,
                    temperature=2.0, method=model.distill_loss),
        model.apply(params, jb, jnp.asarray(paths), jnp.asarray(pw),
                    deterministic=True, method=model.kbest_distill_loss)]
    with torch.no_grad():
        got = [tagger.loss(batch),
               tagger.distill_loss(batch, torch.from_numpy(logits),
                                   temperature=2.0),
               tagger.kbest_distill_loss(batch, torch.from_numpy(paths),
                                         torch.from_numpy(pw))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    want_tags, _ = model.apply(params, jb, method=model.decode)
    np.testing.assert_array_equal(tagger.decode(batch)[0].numpy(),
                                  np.asarray(want_tags))


# -- the training side and the decode options, against the Flax tagger --------

def _tagged_records(cls):
    """The test sentences with gold tags from the tag set (S-X on the
    context words) and two languages."""
    rng = np.random.RandomState(5)
    out = []
    for i, (tokens, tags) in enumerate(SENTENCES):
        gold = [TAGS[rng.randint(len(TAGS))] for _ in tokens]
        eos = tokens.index("<EOS>") if "<EOS>" in tokens else len(tokens)
        gold = [g if w < eos and (tags is None or tags[w] != "S-X")
                else "S-X" for w, g in enumerate(gold)]
        out.append(cls(tokens=list(tokens), tags={"ner": gold},
                       lang_id=i % 2))
    return out


def _pair(**kw):
    """A Flax tagger with perturbed parameters and the port's tagger with
    the same weights, for tagger options ``kw``; dropout off."""
    j_tags = j_tag_dict([TAGS + ["S-X"]])
    j_cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB), j_tags, locked_dropout=0.0,
        word_dropout=0.0, **kw)
    batch = j_encode(_tagged_records(JRecord), JTokenizer(vocab_size=VOCAB),
                     j_tags)
    model, params = init_tagger(
        j_cfg, jax.random.PRNGKey(1),
        {k: jnp.asarray(v) for k, v in batch.arrays().items()})
    rng = np.random.RandomState(1)
    np_params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.05 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    tags = make_tag_dictionary([TAGS + ["S-X"]])
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags, locked_dropout=0.0,
        word_dropout=0.0, **kw)
    tagger = SequenceTagger(cfg, device="cpu", seed=3)
    tagger.load_state_dict(from_jax_params(np_params, cfg), strict=True)
    arrays = encode_batch(_tagged_records(SentenceRecord),
                          HashTokenizer(vocab_size=VOCAB), tags).arrays()
    np.testing.assert_array_equal(arrays["tag_ids"], batch.tag_ids)
    return model, jax.tree_util.tree_map(jnp.asarray, np_params), tagger, \
        arrays


HEADS = [dict(), dict(use_crf=False), dict(num_languages=2),
         dict(relearn_embeddings=False)]
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.mark.parametrize("kw", HEADS)
def test_loss_and_every_gradient_match_flax(kw):
    """The mean CRF NLL (or masked token cross-entropy), and the gradient
    of every parameter carried back through ``from_jax_params``."""
    model, params, tagger, arrays = _pair(**kw)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    want, j_grads = jax.value_and_grad(lambda p: model.apply(
        p, jb, deterministic=True, method=model.loss))(params)
    got = tagger.loss(_torch_batch(arrays))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_grads = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads),
                                 tagger.config)
    for name, p in tagger.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("kw", HEADS[:3])
def test_decode_options_match_flax(kw):
    """Viterbi (per-language transitions included), posterior decode and
    the softmax head's argmax: tags and scores; and the marginals."""
    model, params, tagger, arrays = _pair(**kw)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    for posterior in (False, True):
        want_tags, want_scores = model.apply(
            params, jb, method=lambda m, b: m.decode(b, pad_tag=1,
                                                     posterior=posterior))
        got_tags, got_scores = tagger.decode(_torch_batch(arrays), pad_tag=1,
                                             posterior=posterior)
        np.testing.assert_array_equal(got_tags.numpy(),
                                      np.asarray(want_tags))
        np.testing.assert_allclose(got_scores.numpy(),
                                   np.asarray(want_scores), rtol=1e-5)
    want = model.apply(params, jb, method=lambda m, b: m.marginals(b))
    got = tagger.marginals(_torch_batch(arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_per_language_transitions_match_flax():
    model, params, tagger, arrays = _pair(num_languages=2)
    lang = torch.from_numpy(arrays["lang_ids"])
    assert set(lang.tolist()) == {0, 1}
    for ids in (None, lang, lang + 5):  # clipped into the languages
        want = model.apply(params, method=lambda m: m.transition_matrix(
            None if ids is None else jnp.asarray(ids.numpy())))
        np.testing.assert_array_equal(
            tagger.transition_matrix(ids).detach().numpy(), np.asarray(want))


@pytest.mark.parametrize("kw", [dict(), dict(use_crf=False)])
def test_multi_view_loss_and_gradients_match_flax(kw):
    """The context view's loss plus the agreement of the context-free view
    (the sentences cut at <EOS>) with its detached marginals, and an L2
    feature term."""
    from kbner_tpu.data.corpus_ops import make_orig_view as j_orig
    from kbner_tpu_torch.data.corpus_ops import make_orig_view

    model, params, tagger, arrays = _pair(**kw)
    tags = make_tag_dictionary([TAGS + ["S-X"]])
    orig = encode_batch([make_orig_view(r) for r in
                         _tagged_records(SentenceRecord)],
                        HashTokenizer(VOCAB), tags).arrays()
    j_orig_arrays = j_encode([j_orig(r) for r in _tagged_records(JRecord)],
                             JTokenizer(VOCAB),
                             j_tag_dict([TAGS + ["S-X"]])).arrays()
    for key in orig:
        np.testing.assert_array_equal(orig[key], j_orig_arrays[key])
    mv = dict(agreement_weight=0.7, l2_weight=0.3, kind="kl")
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jo = {k: jnp.asarray(v) for k, v in orig.items()}
    want, j_grads = jax.value_and_grad(lambda p: model.apply(
        p, jb, jo, deterministic=True, method=model.multi_view_loss,
        **mv))(params)
    got = tagger.multi_view_loss(_torch_batch(arrays), _torch_batch(orig),
                                 **mv)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_grads = from_jax_params(jax.tree_util.tree_map(np.asarray, j_grads),
                                 tagger.config)
    for name, p in tagger.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


# -- the initial draw, against Flax's defaults ---------------------------------

def _drawn_trees(kind):
    """The Flax tagger's initial tree and the port tagger's (as a Flax
    tree through ``to_jax_params``) at width 64, each from its own seed:
    the plain tagger, one with per-language transitions and transition
    attention, or a stacked tagger over XLM-R and a word table."""
    from kbner_tpu.data.encode import add_classic_features as j_classic
    from kbner_tpu.data.encode import build_char_vocab as j_char_vocab
    from kbner_tpu.data.encode import build_word_vocab as j_word_vocab
    from kbner_tpu.models import embedders as jemb
    from kbner_tpu.models.tagger import init_stacked_tagger
    from kbner_tpu_torch.models import embedders as emb
    from kbner_tpu_torch.models.tagger import StackedSequenceTagger
    from kbner_tpu_torch.weights import to_jax_params

    kw = dict(num_languages=2, transition_attention=True) \
        if kind == "attention" else {}
    j_tags = j_tag_dict([TAGS])
    j_cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB), j_tags, **kw)
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), make_tag_dictionary([TAGS]), **kw)
    records = _records(JRecord)
    batch = j_encode(records, JTokenizer(vocab_size=VOCAB))
    if kind == "stacked":
        n_words = 400
        j_classic(batch, j_word_vocab(records), j_char_vocab(records))
        _, params = init_stacked_tagger(
            j_cfg, [jemb.EmbedderSpec("x", jemb.TransformerWordEmbedder(
                j_cfg.encoder), 64),
                jemb.EmbedderSpec("w", jemb.WordEmbedder(n_words, 32), 32)],
            jax.random.PRNGKey(0),
            {k: jnp.asarray(v) for k, v in batch.arrays().items()})
        # the Flax table's size is the vocabulary's; draw the same size
        n_words = params["params"]["stack"]["members_1"]["table"][
            "embedding"].shape[0]
        tagger = StackedSequenceTagger(cfg, [
            emb.EmbedderSpec("x", emb.TransformerWordEmbedder(cfg.encoder),
                             64),
            emb.EmbedderSpec("w", emb.WordEmbedder(n_words, 32), 32)],
            device="cpu", seed=0)
    else:
        _, params = init_tagger(
            j_cfg, jax.random.PRNGKey(0),
            {k: jnp.asarray(v) for k, v in batch.arrays().items()})
        tagger = SequenceTagger(cfg, device="cpu", seed=0)
    return (jax.tree_util.tree_map(np.asarray, params),
            to_jax_params(tagger.state_dict(), tagger))


@pytest.mark.parametrize("kind", ["plain", "attention", "stacked"])
def test_parameters_are_drawn_as_flax_draws_them(kind):
    """Every parameter's mean and std match the Flax tree's leaf by leaf:
    Dense kernels lecun-normal, Embed tables normal(0, 1/sqrt(D)), zero
    biases, LayerNorm ones and zeros, normal(0, 1) transitions and the
    attention's normal(0, 0.02). Tolerance, for a leaf of n values whose
    Flax std is s: six standard errors of the difference of two samples,
    6 s sqrt(2/n) for the means and 6 s / sqrt(n) for the stds (exact
    for constant leaves). No leaf reads std 0.02 where Flax's does not."""
    want, got = _drawn_trees(kind)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        g = flat_got[path]
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        s, n = float(w.std()), w.size
        assert abs(float(g.mean()) - float(w.mean())) <= \
            6 * s * (2 / n) ** 0.5 + 1e-7, name
        assert abs(float(g.std()) - s) <= 6 * s / n ** 0.5 + 1e-7, name
        if abs(s - 0.02) > 0.005:
            assert abs(float(g.std()) - 0.02) > 0.005, name
