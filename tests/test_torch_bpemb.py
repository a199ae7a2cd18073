"""The PyTorch port's BPEmb member, ELMo's byte ids and the pooled Flair
table against kbner_tpu's on the same inputs: ``BPEVocab`` built from a
corpus, read from word2vec text and segmenting words (pieces, vectors
and ids equal); ``add_classic_features`` with a piece vocabulary and
``elmo_bytes`` (arrays and dtypes equal); ``BPEmbEmbedder``'s features
and gradients against ``jax.grad`` (rtol 1e-6: a lookup); and
``build_pooled_flair_table`` for mean, min and max pooling (the
vocabulary equal, the table rtol 1e-5, atol 1e-6 in float32).
"""

from pathlib import Path

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
from kbner_tpu.models import embedders as jemb
from kbner_tpu_torch import weights
from kbner_tpu_torch.data import encode as penc
from kbner_tpu_torch.data.conll import SentenceRecord, load_column_corpus
from kbner_tpu_torch.data.encode import (add_classic_features,
                                         build_char_vocab, build_word_vocab,
                                         encode_batch)
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models import embedders as emb

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
RTOL, ATOL = 1e-5, 1e-6
LOOKUP_RTOL = 1e-6


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
def corpora():
    return _corpus(j_load_corpus), _corpus(load_column_corpus)


ODD_WORDS = ["", "ωωω", "Straße", "é", "THE", "x" * 60, "naïve",
             "日本語", "a-b", "'s"]


@pytest.mark.parametrize("kw", [dict(dim=8, max_words=50),
                                dict(dim=5, max_words=3, seed=4),
                                dict(dim=3, max_words=0, seed=9)])
def test_bpe_vocab_build_and_segment_equal_the_reference(corpora, kw):
    jc, pc = corpora
    want = jemb.BPEVocab.build(jc.train, **kw)
    got = emb.BPEVocab.build(pc.train, **kw)
    assert got.pieces == want.pieces and got.dim == want.dim
    np.testing.assert_array_equal(got.matrix, want.matrix)
    words = [t for r in pc.train for t in r.tokens] + ODD_WORDS
    for w in words:
        assert got.segment(w) == want.segment(w), w
        assert got.segment(w)  # never empty


def test_bpe_vocab_from_w2v_text(tmp_path):
    path = tmp_path / "bpe.vec"
    path.write_text("6 3\n<unk> 0 0 1\n▁the 1 2 3\nhe 5 6 7\n▁t 1 1 1\n"
                    "e 2 2 2\n▁the 9 9 9\n")
    got, want = (m.BPEVocab.from_w2v_text(path) for m in (emb, jemb))
    assert got.pieces == want.pieces and got.dim == 3
    np.testing.assert_array_equal(got.matrix, want.matrix)
    for w in ("the", "The", "then", "eh", "he", "q"):
        assert got.segment(w) == want.segment(w), w
    assert got.segment("the") == [got.pieces["▁the"]]


@pytest.mark.parametrize("kw", [
    dict(elmo_bytes=True), dict(bpe=True), dict(bpe=True, elmo_bytes=True,
                                                words=True, chars=True),
    dict(elmo_bytes=True, chars=True, max_chars_per_word=4)])
def test_classic_features_with_bytes_and_pieces_equal_the_reference(
        corpora, kw):
    jc, pc = corpora
    kw = dict(kw)
    bpe, words, chars = (kw.pop(k, False) for k in ("bpe", "words", "chars"))
    jbv = jemb.BPEVocab.build(jc.train, dim=4, max_words=20) if bpe else None
    pbv = emb.BPEVocab.build(pc.train, dim=4, max_words=20) if bpe else None
    extra = [SentenceRecord(tokens=["Ünïcödé", "x" * 70, "日本", "a"],
                            tags={"ner": ["O"] * 4})]
    for lo, hi in ((0, 3), (3, None)):
        jrec = list(jc.train[lo:hi]) + extra  # the records duck-type
        prec = list(pc.train[lo:hi]) + extra
        jeb = j_encode(jrec, JTokenizer(VOCAB))
        j_add_classic(jeb, j_word_vocab(jc.train) if words else None,
                      j_char_vocab(jc.train) if chars else None,
                      bpe_vocab=jbv, **kw)
        eb = encode_batch(prec, HashTokenizer(VOCAB))
        add_classic_features(eb, build_word_vocab(pc.train) if words
                             else None,
                             build_char_vocab(pc.train) if chars else None,
                             bpe_vocab=pbv, **kw)
        assert eb.extra.keys() == jeb.extra.keys()
        for key, want in jeb.extra.items():
            assert eb.extra[key].dtype == want.dtype, key
            np.testing.assert_array_equal(eb.extra[key], want, err_msg=key)
    if kw.get("elmo_bytes"):
        ids = eb.extra["elmo_char_ids"]
        assert ids.shape[2] == penc.ELMO_MAX_CHARS == 50
        assert ids.max() < penc.ELMO_CHAR_VOCAB == 261
        # the 70-character word keeps 48 bytes between its markers
        row = ids[-1, 1]
        assert row[0] == penc.ELMO_BOW and row[49] == penc.ELMO_EOW
        assert (row[1:49] == ord("x")).all()


@pytest.mark.parametrize("trainable", [True, False])
def test_bpemb_member_and_gradients_match_flax(corpora, trainable):
    jc, pc = corpora
    bv = emb.BPEVocab.build(pc.train, dim=6, max_words=30)
    eb = encode_batch(pc.train[:5], HashTokenizer(VOCAB))
    add_classic_features(eb, bpe_vocab=bv)
    arrays = {k: v for k, v in eb.arrays().items() if k.startswith("bpe")}
    jarrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    jm = jemb.BPEmbEmbedder(len(bv.pieces), bv.dim, trainable=trainable)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.1,
        jm.init(jax.random.PRNGKey(0), jarrays))
    pm = emb.BPEmbEmbedder(len(bv.pieces), bv.dim, trainable=trainable)
    pm.load_state_dict(weights.member_from_jax_params(params, pm))
    got = pm({k: torch.from_numpy(v) for k, v in arrays.items()})
    want = jm.apply(params, jarrays)
    assert got.shape == (*eb.word_mask.shape, 2 * bv.dim)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=LOOKUP_RTOL)
    w = np.random.RandomState(1).randn(*got.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jm.apply(p, jarrays) * w))(params)
    loss = (got * torch.from_numpy(w)).sum()
    if not trainable:  # detached: nothing reaches the table
        assert not loss.requires_grad
        assert not np.asarray(grads["params"]["table"]["embedding"]).any()
        return
    loss.backward()
    np.testing.assert_allclose(
        pm.table.weight.grad.numpy(),
        np.asarray(grads["params"]["table"]["embedding"]), rtol=RTOL,
        atol=ATOL)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, weights.member_to_jax_params(pm.state_dict(), pm),
        params["params"]))


@pytest.mark.parametrize("pooling", ["mean", "min", "max"])
def test_pooled_flair_table_equals_the_reference(corpora, pooling):
    jc, pc = corpora
    jcv, cv = j_char_vocab(jc.train), build_char_vocab(pc.train)
    jm = jemb.FlairLMEmbedder(len(jcv), 4, 5)
    eb = j_encode(jc.train[:2], JTokenizer(VOCAB))
    j_add_classic(eb, None, jcv)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + 0.1 * np.random.RandomState(2)
                   .standard_normal(x.shape)).astype(np.float32),
        jm.init(jax.random.PRNGKey(1), {
            k: jnp.asarray(v) for k, v in eb.arrays().items()}))
    pm = emb.FlairLMEmbedder(len(cv), 4, 5)
    pm.load_state_dict(weights.member_from_jax_params(params, pm))
    # three batches, the last one short; words repeat across batches
    recs = pc.train[:7]
    jvocab, want = jemb.build_pooled_flair_table(
        jm, params, jc.train[:7], JTokenizer(VOCAB), jcv, pooling=pooling,
        batch_size=3)
    vocab, got = emb.build_pooled_flair_table(
        pm, recs, HashTokenizer(VOCAB), cv, pooling=pooling, batch_size=3)
    assert vocab.idx2item == jvocab.idx2item
    assert got.dtype == np.float32 and got.shape == (len(vocab), 10)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert not got[0].any()  # <unk> is never seen
    with pytest.raises(ValueError, match="pooling"):
        emb.build_pooled_flair_table(pm, recs, HashTokenizer(VOCAB), cv,
                                     pooling="fade")
