"""The PyTorch port's classic embedders, ACE stack and stacked tagger
against kbner_tpu's Flax modules on the same numpy inputs.

The Flax modules are initialized from a seed, their parameters perturbed
with numpy noise (so that no bias keeps its zero), and carried over with
``weights.from_jax_params``. Tolerances, float32 on the CPU: the LSTM and
the classic members rtol 1e-5, atol 1e-6; their gradients rtol 1e-4
(atol 1e-6); XLM-R's features and everything computed from them (the
transformer member, the stack, the stacked tagger's emissions and loss)
atol 1e-4 with rtol 1e-5, the tolerance tests/test_torch_tagger.py holds
the encoder to.
"""

from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data import load_column_corpus as j_load_corpus
from kbner_tpu.data.encode import add_classic_features as j_add_classic
from kbner_tpu.data.encode import build_char_vocab as j_char_vocab
from kbner_tpu.data.encode import build_word_vocab as j_word_vocab
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import embedders as jemb
from kbner_tpu.models.tagger import init_stacked_tagger
from kbner_tpu_torch import weights
from kbner_tpu_torch.data.conll import load_column_corpus
from kbner_tpu_torch.data.encode import (add_classic_features,
                                         build_char_vocab, build_word_vocab,
                                         encode_batch)
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models import embedders as emb
from kbner_tpu_torch.models.tagger import StackedSequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
RTOL, ATOL = 1e-5, 1e-6
XLMR_ATOL = 1e-4  # XLM-R's features, as tests/test_torch_tagger.py
GRAD_RTOL = 1e-4
# a stream cut that falls inside the batch's longer sentences
SHORT_STREAM = 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _corpus(load):
    return load(FIX / "ner_toy", {0: "text", 1: "ner"},
                comment_symbol="# id")


@pytest.fixture(scope="module")
def data():
    """Both packages' corpora, vocabularies and one batch of the train
    sentences (ragged words and character streams, pad words of no
    characters), with the classic features."""
    jc, pc = _corpus(j_load_corpus), _corpus(load_column_corpus)
    jwv, jcv = j_word_vocab(jc.train), j_char_vocab(jc.train)
    wv, cv = build_word_vocab(pc.train), build_char_vocab(pc.train)
    assert wv.idx2item == jwv.idx2item and cv.idx2item == jcv.idx2item
    jeb = j_encode(jc.train[:6], JTokenizer(VOCAB),
                   jc.make_tag_dictionary("ner"))
    j_add_classic(jeb, jwv, jcv)
    eb = encode_batch(pc.train[:6], HashTokenizer(VOCAB),
                      pc.make_tag_dictionary("ner"))
    add_classic_features(eb, wv, cv)
    arrays = eb.arrays()
    lengths = arrays["char_mask"].sum(-1)
    assert (lengths == 0).any() and len(np.unique(lengths)) > 3
    return dict(jc=jc, pc=pc, wv=wv, cv=cv, jwv=jwv, jcv=jcv,
                arrays=arrays, jarrays={k: jnp.asarray(v) for k, v in
                                        jeb.arrays().items()})


def _perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)


def _torch(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


# -- the classic features -----------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"max_stream_chars": SHORT_STREAM}, {"max_chars_per_word": 4},
    {"max_stream_chars": 7},
    {"max_stream_chars": SHORT_STREAM, "max_chars_per_word": 4}])
def test_classic_features_equal_the_reference(data, kw):
    jc, pc = data["jc"], data["pc"]
    for lo, hi in ((0, 3), (3, 6), (6, None)):
        jeb = j_encode(jc.train[lo:hi], JTokenizer(VOCAB))
        j_add_classic(jeb, data["jwv"], data["jcv"], **kw)
        eb = encode_batch(pc.train[lo:hi], HashTokenizer(VOCAB))
        add_classic_features(eb, data["wv"], data["cv"], **kw)
        assert eb.extra.keys() == jeb.extra.keys()
        for key, want in jeb.extra.items():
            assert eb.extra[key].dtype == want.dtype, key
            np.testing.assert_array_equal(eb.extra[key], want, err_msg=key)
    if kw.get("max_stream_chars"):
        assert eb.extra["char_stream"].shape[1] == kw["max_stream_chars"]


def test_word_vectors_from_text(tmp_path):
    path = tmp_path / "vec.txt"
    path.write_text("3 2\nfoo 1 2\nbar 3 4\n<unk> 5 6\nfoo 7 8\nbad\n")
    assert emb.WordEmbedder.load_pretrained_text(path)[0] == \
        jemb.WordEmbedder.load_pretrained_text(path)[0]
    np.testing.assert_array_equal(
        emb.WordEmbedder.load_pretrained_text(path)[1],
        jemb.WordEmbedder.load_pretrained_text(path)[1])


# -- the LSTM -----------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_lstm_matches_flax_rnn(reverse, ragged):
    """States of ``nn.RNN(OptimizedLSTMCell)``, with lengths of 0, 1,
    part and all of the row; the state at each row's last scan step is
    the carry's ``h``."""
    rng = np.random.RandomState(1)
    B, T, D, H = 6, 13, 5, 7
    x = rng.randn(B, T, D).astype(np.float32)
    lengths = np.array([13, 4, 0, 9, 1, 12], np.int32)
    kw = {"seq_lengths": jnp.asarray(lengths)} if ragged else {}
    rnn = fnn.RNN(fnn.OptimizedLSTMCell(H), reverse=reverse, keep_order=True,
                  return_carry=True)
    params = _perturbed(rnn.init(jax.random.PRNGKey(2), jnp.asarray(x),
                                 **kw), 3)
    (_, h_want), want = rnn.apply(params, jnp.asarray(x), **kw)
    lstm = emb.FlaxLSTM(D, H, reverse=reverse)
    lstm.load_state_dict(weights.lstm_from_flax(params["params"]["cell"]))
    got = lstm(torch.from_numpy(x),
               torch.from_numpy(lengths) if ragged else None)
    _close(got, want)
    # the last scan step: position 0 of a reverse pass (its length-0 rows
    # flipped whole), position (length - 1) mod T of a forward one
    n = lengths if ragged else np.full(B, T)
    last = np.zeros(B, int) if reverse else (n - 1) % T
    _close(got[np.arange(B), last], h_want)
    tree = weights.lstm_to_flax(*(t.detach().numpy() for t in (
        lstm.kernel_i, lstm.kernel_h, lstm.bias)))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, tree, params["params"]["cell"]))


def test_reverse_lstm_ignores_padding():
    """A reverse pass's real states do not depend on the row's padding."""
    rng = np.random.RandomState(4)
    lstm = emb.FlaxLSTM(3, 4, reverse=True)
    lstm.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.from_numpy(rng.randn(1, 5, 3).astype(np.float32))
    short = lstm(x, torch.tensor([5]))
    padded = lstm(torch.cat([x, torch.randn(1, 6, 3)], 1), torch.tensor([5]))
    _close(padded[:, :5], short.detach().numpy(), rtol=0, atol=0)


# -- the members --------------------------------------------------------------------

MEMBERS = {
    "word": (lambda wv, cv: jemb.WordEmbedder(len(wv), 6),
             lambda wv, cv: emb.WordEmbedder(len(wv), 6)),
    "char_bilstm": (lambda wv, cv: jemb.CharBiLSTMEmbedder(len(cv), 5, 4),
                    lambda wv, cv: emb.CharBiLSTMEmbedder(len(cv), 5, 4)),
    "flair": (lambda wv, cv: jemb.FlairLMEmbedder(len(cv), 4, 6),
              lambda wv, cv: emb.FlairLMEmbedder(len(cv), 4, 6)),
}


def _member_pair(data, kind, seed=0):
    """(flax module, perturbed params, port module with them)."""
    jmake, pmake = MEMBERS[kind]
    jm, pm = jmake(data["jwv"], data["jcv"]), pmake(data["wv"], data["cv"])
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), data["jarrays"]),
                        seed + 1)
    pm.load_state_dict(weights.member_from_jax_params(params, pm),
                       strict=True)
    return jm, params, pm


@pytest.mark.parametrize("kind", sorted(MEMBERS))
def test_member_and_its_gradients_match_flax(data, kind):
    """The member's features, and the gradients of every table and LSTM
    parameter of a weighted sum of them against ``jax.grad``."""
    jm, params, pm = _member_pair(data, kind, seed=5)
    arrays, jarrays = data["arrays"], data["jarrays"]
    got = pm(_torch(arrays))
    assert got.dtype == torch.float32
    _close(got, jm.apply(params, jarrays), msg=kind)
    w = np.random.RandomState(6).randn(*got.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jm.apply(p, jarrays) * w))(params)
    (got * torch.from_numpy(w)).sum().backward()
    want = weights.member_from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads), pm)
    named = dict(pm.named_parameters())
    assert named.keys() == want.keys()
    for name, p in named.items():
        _close(p.grad, want[name].numpy(), rtol=GRAD_RTOL, atol=ATOL,
               msg=name)


def test_flair_member_on_streams_cut_short(data):
    """Streams cut at ``max_stream_chars``: the LMs stop there and the
    words past it take the clipped last position."""
    eb = encode_batch(data["pc"].train[:6], HashTokenizer(VOCAB))
    add_classic_features(eb, data["wv"], data["cv"],
                         max_stream_chars=SHORT_STREAM)
    arrays = eb.arrays()
    assert (arrays["word_char_ends"] == SHORT_STREAM - 1).sum() > 1
    jm, params, pm = _member_pair(data, "flair", seed=12)
    _close(pm(_torch(arrays)), jm.apply(
        params, {k: jnp.asarray(v) for k, v in arrays.items()}))


def test_char_lm_head_matches_flax(data):
    cv = data["cv"]
    jm = jemb.CharLMHead(len(cv), 4, 6)
    stream = data["arrays"]["char_stream"]
    mask = data["arrays"]["char_stream_mask"]
    params = _perturbed(jm.init(jax.random.PRNGKey(7), jnp.zeros(
        (2, 16), jnp.int32)), 8)
    pm = emb.CharLMHead(len(cv), 4, 6)
    pm.load_state_dict(weights.from_jax_params(params, pm))
    _close(pm(torch.from_numpy(stream)), jm.apply(params, jnp.asarray(stream)))
    want, grads = jax.value_and_grad(lambda p: jm.apply(
        p, jnp.asarray(stream), jnp.asarray(mask), method=jm.loss))(params)
    loss = pm.loss(torch.from_numpy(stream), torch.from_numpy(mask))
    _close(loss, want)
    loss.backward()
    want_grads = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads), pm)
    for name, p in pm.named_parameters():
        _close(p.grad, want_grads[name].numpy(), rtol=GRAD_RTOL, atol=ATOL,
               msg=name)
    assert jax.tree_util.tree_structure(weights.to_jax_params(
        pm.state_dict(), pm)) == jax.tree_util.tree_structure(params)


def test_scalar_mix_matches_flax():
    rng = np.random.RandomState(9)
    layers = rng.randn(3, 2, 4, 5).astype(np.float32)
    jm = jemb.ScalarMix(3)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(layers)),
                        10)
    pm = emb.ScalarMix(3)
    pm.load_state_dict({"weights": torch.from_numpy(
        params["params"]["weights"]), "gamma": torch.from_numpy(
        np.asarray(params["params"]["gamma"]))})
    _close(pm(torch.from_numpy(layers)), jm.apply(params, jnp.asarray(layers)))


# -- the stack and the stacked tagger ------------------------------------------------

@pytest.fixture(scope="module")
def stacked(data):
    """The Flax stacked tagger over all four member kinds (XLM-R tiny,
    word, char-BiLSTM, Flair), per-language transitions over two
    languages, dropout off; the port's with the same weights."""
    jtags = data["jc"].make_tag_dictionary("ner")
    tags = data["pc"].make_tag_dictionary("ner")
    jenc = JXLMRConfig.tiny(vocab_size=VOCAB)
    enc = XLMRConfig.tiny(vocab_size=VOCAB)
    jspecs = [
        jemb.EmbedderSpec("x", jemb.TransformerWordEmbedder(jenc), 64),
        jemb.EmbedderSpec("w", jemb.WordEmbedder(len(data["jwv"]), 6), 6),
        jemb.EmbedderSpec("c", jemb.CharBiLSTMEmbedder(len(data["jcv"]), 5,
                                                       4), 8),
        jemb.EmbedderSpec("f", jemb.FlairLMEmbedder(len(data["jcv"]), 4, 6),
                          12)]
    specs = [
        emb.EmbedderSpec("x", emb.TransformerWordEmbedder(enc), 64),
        emb.EmbedderSpec("w", emb.WordEmbedder(len(data["wv"]), 6), 6),
        emb.EmbedderSpec("c", emb.CharBiLSTMEmbedder(len(data["cv"]), 5, 4),
                         8),
        emb.EmbedderSpec("f", emb.FlairLMEmbedder(len(data["cv"]), 4, 6),
                         12)]
    kw = dict(locked_dropout=0.0, word_dropout=0.0, num_languages=2)
    model, params = init_stacked_tagger(
        JTaggerConfig.for_tag_dictionary(jenc, jtags, **kw), jspecs,
        jax.random.PRNGKey(0), data["jarrays"])
    params = _perturbed(params, 11)
    tagger = StackedSequenceTagger(
        TaggerConfig.for_tag_dictionary(enc, tags, **kw), specs,
        device="cpu", seed=4).eval()
    tagger.load_state_dict(weights.from_jax_params(params, tagger),
                           strict=True)
    arrays = dict(data["arrays"])
    arrays["lang_ids"] = np.arange(len(arrays["lang_ids"]),
                                   dtype=np.int32) % 2
    return model, jax.tree_util.tree_map(jnp.asarray, params), tagger, arrays


def test_stacked_weights_cover_every_parameter(stacked):
    _, params, tagger, _ = stacked
    tree = weights.to_jax_params(tagger.state_dict(), tagger)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    assert set(weights.from_jax_params(tree, tagger)) == \
        set(tagger.state_dict())
    assert sum(x.size for x in jax.tree_util.tree_leaves(params)) == sum(
        p.numel() for p in tagger.parameters())


def test_transformer_member_matches_flax(stacked):
    model, params, tagger, arrays = stacked
    member = jemb.TransformerWordEmbedder(JXLMRConfig.tiny(vocab_size=VOCAB))
    want = member.apply({"params": params["params"]["stack"]["members_0"]},
                        {k: jnp.asarray(v) for k, v in arrays.items()})
    got = tagger.stack.members[0](_torch(arrays))
    assert not got.requires_grad  # frozen: no gradient reaches XLM-R
    _close(got, want, atol=XLMR_ATOL)


@pytest.mark.parametrize("selection", [None, [1, 1, 1, 1], [1, 0, 1, 1],
                                       [0, 1, 0, 0], [0, 0, 1, 1]])
def test_stack_matches_flax_under_selection(stacked, selection):
    model, params, tagger, arrays = stacked
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    sel = None if selection is None else np.asarray(selection, np.float32)
    want = model.apply(params, jb, True, sel,
                       method=lambda m, b, d, s: m._extract_features(b, d, s))
    batch = _torch(arrays)
    if sel is not None:
        batch["selection"] = torch.from_numpy(sel)
    got = tagger._extract_features(batch)
    assert got.dtype == torch.float32 and got.shape == want.shape
    _close(got, want, atol=XLMR_ATOL)
    if sel is not None:  # masked members add zeros; the width stays
        bounds = np.cumsum([0, 64, 6, 8, 12])
        for i, s in enumerate(sel):
            if s == 0:
                assert not got[..., bounds[i]:bounds[i + 1]].any()


@pytest.mark.parametrize("selection", [None, [1, 0, 1, 1]])
def test_stacked_tagger_loss_and_emissions_match_flax(stacked, selection):
    model, params, tagger, arrays = stacked
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    batch = _torch(arrays)
    if selection is not None:
        jb["selection"] = jnp.asarray(selection, jnp.float32)
        batch["selection"] = torch.tensor(selection, dtype=torch.float32)
    want_em = model.apply(params, jb, method=model.emissions)
    want_loss = model.apply(params, jb, deterministic=True,
                            method=model.loss)
    want_tags, _ = model.apply(params, jb, method=model.decode)
    _close(tagger.emissions(batch), want_em, atol=XLMR_ATOL)
    _close(tagger.loss(batch), want_loss, atol=XLMR_ATOL)
    np.testing.assert_array_equal(tagger.decode(batch)[0].numpy(),
                                  np.asarray(want_tags))


def test_stacked_tagger_refuses_transition_attention(data):
    """Transition attention over a stack (it used to raise): the
    attention is ``[total width, L]`` with its bias, carried both ways;
    the loss (under the attention mixture), Viterbi tags and every
    gradient equal the Flax stacked tagger's (word 24 + char-BiLSTM 8/8,
    the composition tests/test_embedders_ace.py builds)."""
    jtags = data["jc"].make_tag_dictionary("ner")
    tags = data["pc"].make_tag_dictionary("ner")
    jspecs = [jemb.EmbedderSpec("w", jemb.WordEmbedder(len(data["jwv"]), 24),
                                24),
              jemb.EmbedderSpec("c", jemb.CharBiLSTMEmbedder(
                  len(data["jcv"]), 8, 8), 16)]
    specs = [emb.EmbedderSpec("w", emb.WordEmbedder(len(data["wv"]), 24), 24),
             emb.EmbedderSpec("c", emb.CharBiLSTMEmbedder(len(data["cv"]), 8,
                                                          8), 16)]
    kw = dict(locked_dropout=0.0, word_dropout=0.0, num_languages=2,
              transition_attention=True)
    model, params = init_stacked_tagger(
        JTaggerConfig.for_tag_dictionary(JXLMRConfig.tiny(vocab_size=VOCAB),
                                         jtags, **kw), jspecs,
        jax.random.PRNGKey(0), data["jarrays"])
    assert params["params"]["sent_to_trans_att"].shape == (24 + 16, 2)
    params = _perturbed(params, 12)
    tagger = StackedSequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags, **kw), specs,
        device="cpu", seed=2)
    assert tuple(tagger.sent_to_trans_att.shape) == (40, 2)
    tagger.load_state_dict(weights.from_jax_params(params, tagger),
                           strict=True)
    tree = weights.to_jax_params(tagger.state_dict(), tagger)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    arrays = dict(data["arrays"])
    arrays["lang_ids"] = np.arange(len(arrays["lang_ids"]),
                                   dtype=np.int32) % 2
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want, j_grads = jax.value_and_grad(lambda p: model.apply(
        p, jb, deterministic=True, method=model.loss))(jp)
    want_tags, _ = model.apply(jp, jb, method=model.decode)
    got = tagger.loss(_torch(arrays))
    got.backward()
    _close(got, want)
    want_grads = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, j_grads), tagger)
    for name, p in tagger.named_parameters():
        _close(p.grad, want_grads[name].numpy(), rtol=GRAD_RTOL, msg=name)
    assert bool(tagger.sent_to_trans_att.grad.any())
    np.testing.assert_array_equal(tagger.decode(_torch(arrays))[0].numpy(),
                                  np.asarray(want_tags))


def test_initial_draws_follow_flax_distributions():
    """Tables normal(0, 1/D), input kernels truncated lecun_normal,
    recurrent kernels orthogonal per gate, zero biases."""
    gen = torch.Generator().manual_seed(0)
    word = emb.WordEmbedder(500, 64)
    word.reset_parameters(gen)
    assert abs(float(word.table.weight.detach().std()) - 64 ** -0.5) < 0.01
    lstm = emb.FlaxLSTM(200, 32)
    lstm.reset_parameters(gen)
    k_i = lstm.kernel_i.detach()
    assert abs(float(k_i.std()) - 200 ** -0.5) < 0.005
    assert float(k_i.abs().max()) <= 2 * 200 ** -0.5 / 0.87962566103423978
    for g in range(4):
        block = lstm.kernel_h.detach()[:, g * 32:(g + 1) * 32]
        torch.testing.assert_close(block.T @ block, torch.eye(32), atol=1e-5,
                                   rtol=0)
    assert not lstm.bias.any()
