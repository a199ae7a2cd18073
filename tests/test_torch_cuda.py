"""kbner_tpu_torch on the card: the CUDA kernels against their plain
versions, and retrieval (exhaustive, pruned, entity-boosted and the
two-operand pruned top-k), tagging, the ACE members (ELMo and pooled
Flair tables among them) and the MFVI head on the card against the same
on the CPU.

These tests need an NVIDIA GPU and skip without one. The machine with the
card has no JAX, so run them there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from kbner_tpu_torch.data.conll import EOS_MARKER
from kbner_tpu_torch.data.dictionary import make_tag_dictionary
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.ops import bm25
from kbner_tpu_torch.retrieval.engine import DocStore, RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index
from kbner_tpu_torch.retrieval.fusion import fuse_contexts
from kbner_tpu_torch.retrieval.synth import (sentence_queries,
                                             synth_k1_operands,
                                             synth_k2_operands,
                                             synth_k3_operands,
                                             synth_rescore_operands,
                                             synth_wiki_docs)
from kbner_tpu_torch.serve import predict, request_record

pytestmark = pytest.mark.cuda

# float32 sums of the same terms taken in another order
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    # float32 products in full float32, as on the CPU they are compared with
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        saved


@pytest.mark.parametrize("Q,Lq,Ld,N,off,kind", [
    (5, 7, 9, 1000, 0, "random"),       # ragged in both block dimensions
    (33, 70, 52, 4099, 0, "random"),    # two query tiles, two term tiles
    (1, 1, 1, 1, 0, "random"),
    (64, 64, 3, 257, 131, "random"),    # a doc-axis slice of a wider array
    (4, 64, 52, 3000, 0, "big_ids"),    # ids near 2^31 - 1
    (32, 64, 52, 3000, 0, "collide"),   # ids on one hash slot / low bits
    (32, 64, 52, 3000, 0, "shared"),    # one term in every query slot
    (32, 64, 52, 3000, 0, "repeat"),    # a term repeated within a query
    (32, 130, 52, 3000, 0, "index"),    # Lq = 130: three term tiles
    (33, 64, 52, 3000, 0, "index"),     # Q = 33: two query tiles
    (32, 64, 52, 4099, 1, "index"),     # slices unaligned for 16-byte
    (32, 64, 52, 4099, 2, "repeat"),    # copies, N not a multiple of 4
    (32, 64, 52, 4099, 3, "index"),
    (32, 64, 52, 100, 0, "index"),      # N smaller than one doc tile
    (32, 64, 2, 5000, 0, "index"),      # the title field's Ld
])
def test_kernel_matches_plain(card, Q, Lq, Ld, N, off, kind):
    if kind == "random":  # -1 pads in both operands carry weights/impacts
        rng = np.random.RandomState(Q + N)
        qt = rng.randint(-2, 40, size=(Q, Lq)).astype(np.int32)
        qw = rng.rand(Q, Lq).astype(np.float32)
        dt = rng.randint(-1, 40, size=(Ld, N + off)).astype(np.int32)
        di = rng.rand(Ld, N + off).astype(np.float32)
    else:
        qt, qw, dt, di = synth_k1_operands(Q + N + off, Q, Lq, Ld, N + off,
                                           kind)
    qt, qw, dt, di = (torch.from_numpy(x).to(card) for x in (qt, qw, dt, di))
    dt, di = dt[:, off:], di[:, off:]
    before = bm25.bm25_score_block.launches
    got = bm25.bm25_score_block(qt, qw, dt, di)
    torch.cuda.synchronize()
    assert bm25.bm25_score_block.launches == before + 1
    want = bm25.bm25_score_block_ref(qt, qw, dt, di)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    if kind != "random":  # index-shaped operands always match somewhere
        assert (want > 0).any()


def test_kernel_negative_ids_never_match(card):
    """A -1 doc slot that carries an impact, and -1/-2 query terms with a
    weight, add nothing."""
    qt = torch.tensor([[-1, -2, 3], [3, -1, -1]], dtype=torch.int32)
    qw = torch.tensor([[5.0, 5.0, 1.0], [2.0, 7.0, 7.0]])
    dt = torch.tensor([[-1, 3, -1], [3, -1, -2]], dtype=torch.int32)
    di = torch.tensor([[9.0, 0.5, 9.0], [0.25, 9.0, 9.0]])
    got = bm25.bm25_score_block(*(x.to(card) for x in (qt, qw, dt, di)))
    want = torch.tensor([[0.25, 0.5, 0.0], [0.5, 1.0, 0.0]])
    torch.testing.assert_close(got.cpu(), want)


def _synth_engine(device, doc_chunk=None):
    docs = synth_wiki_docs(3000, vocab=4000, n_topics=40, seed=5)
    vocab = {f"w{i}": i for i in range(4000)}
    index = BM25Index.build_encoded(docs, vocab)
    store = DocStore([" ".join(f"w{t}" for t in r[r >= 0]) for r in docs])
    return docs, RetrievalEngine(index, store=store, device=device,
                                 doc_chunk=doc_chunk)


def _assert_same_topk(gs, gi, cs, ci):
    """Equal scores, and equal ids above the k-th score (a tie there may
    be cut either way)."""
    np.testing.assert_allclose(gs, cs, rtol=RTOL, atol=ATOL)
    for q in range(gs.shape[0]):
        kth = min(gs[q, -1], cs[q, -1])
        # a row with fewer than k hits ends in -inf: every hit counts
        cut = kth + ATOL + RTOL * abs(kth) if np.isfinite(kth) else kth
        assert set(gi[q][gs[q] > cut]) == set(ci[q][cs[q] > cut])


@pytest.mark.parametrize("doc_chunk", [None, 1024])
def test_engine_on_card_matches_cpu(card, doc_chunk):
    docs, gpu = _synth_engine(card, doc_chunk)
    _, cpu = _synth_engine("cpu", doc_chunk)
    q, _ = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = gpu.text_index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    before = bm25.bm25_score_block.launches
    gs, gi = gpu.search_encoded(qt, qw, k=10)
    assert bm25.bm25_score_block.launches > before
    _assert_same_topk(gs, gi, *cpu.search_encoded(qt, qw, k=10))


@pytest.mark.parametrize("Q,C,long_doc", [
    (5, 300, 0),       # ragged Q and C
    (8, 128, 140),     # a segment over 128 slots: R2 = 2
    (3, 77, 140),
    (32, 1024, 0),     # the serve shape
    (1, 1, 0),
])
def test_delta16_kernel_matches_plain(card, Q, C, long_doc):
    """K2 against its plain version on rows with continuation slots, -1
    query pads and invalid candidates at id 0."""
    qt, qw, cand, flat, off, lens, nc, k1, b, avgdl, r2 = \
        synth_rescore_operands(Q + C, Q, C, long_doc=long_doc)
    assert r2 == (2 if long_doc else 1)
    ops = [torch.from_numpy(x).to(card)
           for x in (qt, qw, cand, flat.view(np.int16), off, lens, nc)]
    before = bm25.delta16_rescore.launches
    got = bm25.delta16_rescore(*ops, k1, b, avgdl, r2)
    torch.cuda.synchronize()
    assert bm25.delta16_rescore.launches == before + 1
    want = bm25.delta16_rescore_ref(*ops, k1, b, avgdl, r2)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


def _k2_on_card(card, ops, flat=None):
    """K2 and its plain version on these synth operands (``flat`` in place
    of the operands' rows if given); asserts one launch."""
    qt, qw, cand, flat_np, off, lens, nc, k1, b, avgdl, r2 = ops
    t = [torch.from_numpy(x).to(card)
         for x in (qt, qw, cand, flat_np.view(np.int16), off, lens, nc)]
    if flat is not None:
        t[3] = flat
    before = bm25.delta16_rescore.launches
    got = bm25.delta16_rescore(*t, k1, b, avgdl, r2)
    torch.cuda.synchronize()
    assert bm25.delta16_rescore.launches == before + 1
    return got, bm25.delta16_rescore_ref(*t, k1, b, avgdl, r2)


@pytest.mark.parametrize("Q,C,kind", [
    (32, 1024, "collide"),    # ids on one hash slot
    (32, 1024, "repeat"),     # a term in 4 query slots, two build chunks
    (8, 128, "wide"),         # W = 256
    (2, 64, "max_terms"),     # W = 6144: over 48 KB of shared memory
    (5, 300, "unaligned"),    # segments at odd offsets, R2 = 3
    (32, 1024, "max_gap"),    # gaps of 8190, 8191, 8192, 16382, ...
])
def test_delta16_kernel_matches_plain_on_traps(card, Q, C, kind):
    ops = synth_k2_operands(Q + C, Q, C, kind)
    assert ops[-1] == (3 if kind == "unaligned" else 1)
    got, want = _k2_on_card(card, ops)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


def test_delta16_kernel_on_8_byte_aligned_rows(card):
    """Rows that start 8 bytes past a 16-byte boundary: the wrapper takes
    8-byte aligned rows, and the kernel reads them 8 bytes at a time."""
    ops = synth_rescore_operands(7, 32, 1024, long_doc=140)
    flat = torch.from_numpy(ops[3].view(np.int16)).to(card)
    buf = torch.zeros(flat.numel() + 4, dtype=torch.int16, device=card)
    buf[4:] = flat.reshape(-1)
    shifted = buf[4:].view(flat.shape)
    assert shifted.data_ptr() % 16 == 8
    got, want = _k2_on_card(card, ops, flat=shifted)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


def _pruned_engine(device):
    docs = synth_wiki_docs(3000, vocab=4000, n_topics=40, seed=5)
    vocab = {f"w{i}": i for i in range(4000)}
    index = BM25Index.build_encoded(docs, vocab)
    return docs, RetrievalEngine(
        index, mode="pruned", device=device, rare_terms=16,
        posting_budget=6144, n_candidates=1024, tiny_width=384,
        tiny_pack=False, tiny_df_cap=128, tiny_cols_floor=512,
        d16_width_floor=32)


def test_pruned_engine_on_card_matches_cpu(card):
    docs, gpu = _pruned_engine(card)
    _, cpu = _pruned_engine("cpu")
    q, _ = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = gpu.text_index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    before = bm25.delta16_rescore.launches
    gs, gi = gpu.search_encoded(qt, qw, k=10)
    assert bm25.delta16_rescore.launches == before + 1
    cs, ci = cpu.search_encoded(qt, qw, k=10)
    _assert_same_topk(gs, gi, cs, ci)


def test_deep_windows_on_card_match_cpu(card):
    """Deep pass-1 windows (the 4 rarest terms read to 1024 postings,
    the others to 32) on the card equal the same engine on the CPU, with
    one K2 launch per batch."""
    docs = synth_wiki_docs(3000, vocab=4000, n_topics=40, seed=5)
    index = BM25Index.build_encoded(docs, {f"w{i}": i for i in range(4000)})
    kw = dict(mode="pruned", rare_terms=8, posting_budget=256,
              n_candidates=256, deep_terms=4, deep_cap=1024)
    gpu = RetrievalEngine(index, device=card, **kw)
    cpu = RetrievalEngine(index, device="cpu", **kw)
    q, _ = sentence_queries(docs, 32, 64, seed=4)
    qt, qw = index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    before = bm25.delta16_rescore.launches
    gs, gi = gpu.search_encoded(qt, qw, k=10)
    assert bm25.delta16_rescore.launches == before + 1
    _assert_same_topk(gs, gi, *cpu.search_encoded(qt, qw, k=10))


@pytest.mark.parametrize("Q,C,Lq,Ld", [
    (5, 300, 12, 20),     # ragged Q and C
    (3, 77, 1, 52),       # one query term
    (2, 64, 64, 130),     # a row longer than a warp's 4 passes
    (32, 1024, 64, 52),   # the serve shape
    (1, 1, 1, 1),
])
def test_rescore_kernel_matches_plain(card, Q, C, Lq, Ld):
    """K3 against its plain version: codes 0 and 65535, candidates at id 0
    and N - 1, a repeated query term, and -1 pads on both sides under
    nonzero codes (they match, as in the reference)."""
    qt, qw, cand, dt, codes, lo, step = synth_k3_operands(Q + C, Q, C, Lq,
                                                          Ld)
    ops = [torch.from_numpy(x).to(card)
           for x in (qt, qw, cand, dt, codes.view(np.int16))]
    before = bm25.bm25_rescore.launches
    got = bm25.bm25_rescore(*ops, lo, step)
    torch.cuda.synchronize()
    assert bm25.bm25_rescore.launches == before + 1
    want = bm25.bm25_rescore_ref(*ops, lo, step)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


@pytest.mark.parametrize("Q,C,Lq,Ld,kind,vocab", [
    (32, 1024, 64, 52, "collide", 40),   # ids on one hash slot
    (32, 1024, 64, 52, "pads", 40),      # -1 query slots meet coded pads
    (5, 300, 12, 13, "pads", 40),        # Ld = 13: rows not 16-byte wide
    (2, 64, 6144, 52, "random", 20000),  # Lq = 6144: over 48 KB shared
])
def test_rescore_kernel_matches_plain_on_traps(card, Q, C, Lq, Ld, kind,
                                               vocab):
    qt, qw, cand, dt, codes, lo, step = synth_k3_operands(
        Q + C + Ld, Q, C, Lq, Ld, vocab=vocab, kind=kind)
    ops = [torch.from_numpy(x).to(card)
           for x in (qt, qw, cand, dt, codes.view(np.int16))]
    got = bm25.bm25_rescore(*ops, lo, step)
    want = bm25.bm25_rescore_ref(*ops, lo, step)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


def test_rescore_kernel_on_unaligned_rows(card):
    """Ld = 52 rows whose arrays start 4 bytes (terms) and 2 bytes (codes)
    past an aligned address: the kernel takes rows at any alignment their
    types allow."""
    qt, qw, cand, dt, codes, lo, step = synth_k3_operands(9, 32, 1024, 64,
                                                          52)
    ops = [torch.from_numpy(x).to(card)
           for x in (qt, qw, cand, dt, codes.view(np.int16))]
    for i in (3, 4):
        buf = torch.zeros(ops[i].numel() + 1, dtype=ops[i].dtype,
                          device=card)
        buf[1:] = ops[i].reshape(-1)
        ops[i] = buf[1:].view(ops[i].shape)
    assert ops[3].data_ptr() % 16 == 4 and ops[4].data_ptr() % 8 == 2
    got = bm25.bm25_rescore(*ops, lo, step)
    want = bm25.bm25_rescore_ref(*ops, lo, step)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert (want > 0).any()


def _title_engine(device, **kw):
    docs = synth_wiki_docs(3000, vocab=4000, n_topics=40, seed=5)
    vocab = {f"w{i}": i for i in range(4000)}
    index = BM25Index.build_encoded(docs, vocab)
    titles = BM25Index.build_encoded(docs[:, :2], vocab)
    return docs, RetrievalEngine(
        index, title_index=titles, mode="pruned", device=device,
        rare_terms=16, posting_budget=6144, n_candidates=1024, **kw)


@pytest.mark.parametrize("row_layout", ["auto", "packed32"])
def test_entity_boosted_pruned_engine_on_card_matches_cpu(card, row_layout):
    """The title field's packed32 rows and CSR on the card: entity-boosted
    search equals the CPU's."""
    docs, gpu = _title_engine(card, row_layout=row_layout)
    _, cpu = _title_engine("cpu", row_layout=row_layout)
    q, src = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = gpu.text_index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    tt, tw = gpu.title_index.encode_queries(
        [" ".join(f"w{t}" for t in docs[s, :2]) for s in src],
        boosts=[2.0] * len(src))
    kw = dict(k=10, title_terms=tt, title_weights=tw)
    _assert_same_topk(*gpu.search_encoded(qt, qw, **kw),
                      *cpu.search_encoded(qt, qw, **kw))


def test_two_operand_topk_on_card_matches_cpu(card):
    """The path K3 serves: the packed32 engine's pass-1 windows as a
    two-operand pool, rescored over a two-array field, on the card (one K3
    launch) and on the CPU."""
    from kbner_tpu_torch.retrieval.index import log_quantize

    docs, eng = _title_engine("cpu", row_layout="packed32",
                              compact_rows=False)
    idx = eng.text_index
    q, _ = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = idx.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    codes, lo, step = log_quantize(idx.doc_impacts, bits=16)
    arrays = (qt, qw, idx.doc_terms, codes.view(np.int16))
    rare = torch.from_numpy(eng._select_rare_terms(qt))
    out = []
    for dev in (card, torch.device("cpu")):
        off, pk = (x.to(dev) for x in eng.csr["text"])
        cd, ci = bm25.gather_pruned_candidates(
            rare.to(dev), off, pk, eng.per_term_cap,
            *eng._csr_scale["text"])
        field = tuple(torch.from_numpy(x).to(dev) for x in arrays) + (lo,
                                                                      step)
        before = bm25.bm25_rescore.launches
        s, i = bm25.bm25_pruned_topk(cd, ci, (field,), n_real_docs=idx.n_docs,
                                     k=10, n_candidates=1024,
                                     max_dup_shifts=16)
        assert bm25.bm25_rescore.launches == before + (dev.type == "cuda")
        out.append((s.cpu().numpy(), i.cpu().numpy()))
    _assert_same_topk(*out[0], *out[1])


def test_tagging_on_card_matches_cpu(card):
    """The same fused records through a float32 tagger with the same
    weights on the card and on the CPU give the same tags."""
    docs, engine = _synth_engine("cpu")
    tags = make_tag_dictionary([["B-PER", "E-PER", "S-LOC", "S-ORG"]])
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(max_position_embeddings=514), tags)
    cpu_tagger = SequenceTagger(cfg, device="cpu", seed=0).eval()
    gpu_tagger = SequenceTagger(cfg, device=card, seed=1).eval()
    gpu_tagger.load_state_dict(cpu_tagger.state_dict())
    q, _ = sentence_queries(docs, 16, 64, seed=4)
    records = [request_record({"tokens": [f"w{t}" for t in r[r >= 0]]})
               for r in q]
    tok = HashTokenizer(vocab_size=1000)
    fused = fuse_contexts(
        records, engine.search([" ".join(r.tokens) for r in records], k=5),
        tok)
    assert any(EOS_MARKER in r.tokens for r in fused)
    assert predict(fused, gpu_tagger, tok, tags, batch_size=8) == \
        predict(fused, cpu_tagger, tok, tags, batch_size=8)


@pytest.mark.parametrize("per_sentence", [False, True])
def test_crf_decode_over_live_columns_on_card(card, per_sentence):
    """Viterbi at a served batch's shape (32 rows, 337 word columns, most
    of them context masked in every row): on the card, over the live
    columns (given or found), the tags and scores of a step for every
    column, and the CPU's."""
    from kbner_tpu_torch.ops.crf import crf_decode, live_columns

    rng = np.random.RandomState(11)
    B, T, K = 32, 337, 27
    em = rng.randn(B, T, K).astype(np.float32)
    trans = rng.randn(*((B, K, K) if per_sentence else (K, K))).astype(
        np.float32)
    trans[..., :, K - 2] = -10000.0
    trans[..., K - 1, :] = -10000.0
    lengths = rng.randint(4, 41, size=B)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.int32)
    mask[rng.rand(B, T) < 0.1] = 0
    args = [torch.from_numpy(x) for x in (em, mask, trans)]
    want = crf_decode(*args, K - 2, K - 1, pad_tag=3)
    on = [x.to(card) for x in args]
    cols = live_columns(on[1])
    assert cols.numel() == int(np.maximum(mask.any(0),
                                          np.arange(T) == 0).sum()) < T // 4
    full = crf_decode(*on, K - 2, K - 1, pad_tag=3,
                      cols=torch.arange(T, device=card))
    for given in (None, cols):
        got = crf_decode(*on, K - 2, K - 1, pad_tag=3, cols=given)
        for g, f, w in zip(got, full, want):
            assert torch.equal(g, f)
            assert torch.equal(g.cpu(), w)


def _zero_gradient(name):
    """The attention's key bias: softmax over the keys is unchanged by it,
    so its gradient is zero in exact arithmetic, and float32 leaves
    rounding noise near Adam's eps whose normalised step takes the
    noise's sign on each device. Such a parameter is held to one Adam
    step's bound (each element moves by at most the learning rate), and
    where the gradient is at hand, to a zero gradient, instead of to the
    other device's update."""
    return name.endswith("attention.key.bias")


def _training_pair(card, **enc):
    """The same tiny tagger (same weights) and quality-corpus batch on the
    card and on the CPU, with their trainers and optimizers."""
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    corpus = make_quality_corpus(16, 2, 2, seed=5)
    tags = corpus.make_tag_dictionary("ner")
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=1000, **enc), tags, locked_dropout=0.0,
        word_dropout=0.0)
    config = TrainConfig(learning_rate=1e-4, lr_rate=10.0, batch_size=8,
                         use_inverse_sqrt=True)
    out = []
    cpu_state = SequenceTagger(cfg, device="cpu", seed=0).state_dict()
    for dev in ("cpu", card):
        # the card's generator draws another init: same weights by copy
        tagger = SequenceTagger(cfg, device=dev, seed=0)
        tagger.load_state_dict(cpu_state)
        trainer = FinetuneTrainer(tagger, corpus, HashTokenizer(1000), tags,
                                  device=dev)
        batch = trainer._make_train_batches(corpus.train, config, 0)[0]
        out.append((trainer, trainer.make_optimizer(config), batch))
    return out, config


def test_training_step_on_card_matches_cpu(card):
    """One float32 optimizer step (lr > 0 from the first update) on the
    card equals the same step on the CPU: loss rtol 1e-5, parameters rtol
    1e-4, atol 1e-6 (float32 gradients summed in another order, through
    Adam's normalisation); the key biases with a zero gradient within
    atol 1e-6 on both devices and within one Adam step of where they
    started (``_zero_gradient``)."""
    (cpu, gpu), config = _training_pair(card)
    before = {n: p.detach().clone()
              for n, p in cpu[0].model.named_parameters()}
    losses, grads = [], []
    for trainer, opt, batch in (cpu, gpu):
        taken = {}

        def recorded(step=opt.step, model=trainer.model, taken=taken):
            taken.update({n: p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()
                          if _zero_gradient(n)})
            return step()

        opt.step = recorded
        losses.append(trainer.train_step(batch, opt, config, None))
        grads.append(taken)
    torch.testing.assert_close(losses[1].cpu(), losses[0], rtol=1e-5,
                               atol=0)
    assert grads[0] and grads[1].keys() == grads[0].keys()
    want = dict(cpu[0].model.named_parameters())
    for name, p in gpu[0].model.named_parameters():
        if _zero_gradient(name):
            for grad, moved in ((grads[0][name], want[name].detach()),
                                (grads[1][name], p.detach().cpu())):
                assert float(grad.abs().max()) <= 1e-6, name
                assert float((moved - before[name]).abs().max()) <= \
                    config.learning_rate * (1 + 1e-6), name
            continue
        torch.testing.assert_close(p.detach().cpu(), want[name].detach(),
                                   rtol=1e-4, atol=1e-6, msg=name)


def test_bfloat16_training_step_keeps_float32_masters_on_card(card):
    (_, (trainer, opt, batch)), config = _training_pair(
        card, dtype=torch.bfloat16, param_dtype=torch.float32)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    loss = trainer.train_step(batch, opt, config, None)
    assert bool(torch.isfinite(loss))
    for name, p in trainer.model.named_parameters():
        assert p.dtype == torch.float32 and p.device.type == "cuda", name
    w = "encoder.layers.0.intermediate.weight"
    moved = dict(trainer.model.named_parameters())[w].detach() != before[w]
    assert float(moved.float().mean()) > 0.5


def _stream_engine(device):
    docs = synth_wiki_docs(3000, vocab=4000, n_topics=40, seed=5)
    vocab = {f"w{i}": i for i in range(4000)}
    index = BM25Index.build_encoded(docs, vocab)
    store = DocStore([" ".join(f"w{t}" for t in r[r >= 0]) for r in docs])
    return docs, RetrievalEngine(index, store=store, mode="pruned",
                                 device=device)


@pytest.mark.parametrize("workers,depth", [(1, 1), (3, 2)])
def test_search_stream_on_card_equals_per_batch_search(card, workers,
                                                       depth):
    """The pipelined stream (uploads on a side stream, pulls after CUDA
    events on their own threads) yields what per-batch search gives on an
    engine built alike, in order, with one K2 launch per batch, all made on
    the caller's thread; and what the CPU gives."""
    docs, stream = _stream_engine(card)
    _, per_batch = _stream_engine(card)
    _, cpu = _stream_engine("cpu")
    q, _ = sentence_queries(docs, 5 * 32, 64, seed=4)
    texts = [" ".join(f"w{t}" for t in r[r >= 0]) for r in q]
    batches = [texts[i:i + 32] for i in range(0, len(texts), 32)]
    before = bm25.delta16_rescore.launches
    got = list(stream.search_stream(batches, k=10, workers=workers,
                                    depth=depth))
    assert bm25.delta16_rescore.launches == before + len(batches)
    for (gs, gi), b in zip(got, batches):
        enc = per_batch.text_index.encode_queries(b)
        ws, wi = per_batch.search_encoded(*enc, k=10)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)
        _assert_same_topk(gs, gi, *cpu.search_encoded(*enc, k=10))
    assert len(got) == len(batches)


def test_bertscore_on_card_matches_cpu(card):
    from kbner_tpu_torch.retrieval.rerank import bertscore_f1

    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(12, 1024).astype(np.float32))
    d = torch.from_numpy(rng.randn(10, 30, 1024).astype(np.float32))
    qm = torch.from_numpy((rng.rand(12) < 0.8).astype(np.int32))
    dm = torch.from_numpy((rng.rand(10, 30) < 0.7).astype(np.int32))
    dm[3] = 0
    want = bertscore_f1(q, qm, d, dm)
    got = bertscore_f1(*(x.to(card) for x in (q, qm, d, dm)))
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


def _mix_corpora(n_langs: int = 11):
    """Seeded corpora, one per language: Zipf sentences of 10 words, but
    the first language's are 40 words drawn evenly from 200 (no term is
    tiny) and its last three hold all 200, two covering rows of pass 2
    where the last language's docs need one."""
    out = {}
    for seed, lang in enumerate("bn de en es fa hi ko nl ru tr zh".split()
                                [:n_langs]):
        rng = np.random.RandomState(seed)
        ranks = np.arange(1, 301, dtype=np.float64)
        p = (1.0 / ranks) / np.sum(1.0 / ranks)
        out[lang] = [" ".join(f"w{w}" for w in rng.choice(300, 10, p=p))
                     for _ in range(100 + 20 * seed)]
    rng = np.random.RandomState(99)
    out["bn"] = [" ".join(f"w{w}" for w in rng.choice(200, 40))
                 for _ in range(400)] + [
        " ".join(f"w{w}" for w in rng.permutation(200)) for _ in range(3)]
    return out


MIX_KNOBS = dict(mode="pruned", rare_terms=8, posting_budget=2048,
                 n_candidates=32, tiny_df_cap=16, tiny_pack=False,
                 tiny_f16=True)


def test_mix_engine_on_card_matches_the_fanout(card):
    """MixEngine at M=11 on the card against mix_search over the same
    languages' pruned engines on the card: (lang, doc_id) equal within
    ties, scores at RTOL; one K2 launch per language and batch."""
    from kbner_tpu_torch.retrieval.engine import MixEngine, mix_search

    corp = _mix_corpora()
    idxs = {lang: BM25Index.build(d, pad_docs_to=64)
            for lang, d in corp.items()}
    mix = MixEngine({lang: RetrievalEngine(
        idx, store=DocStore(sentences=corp[lang]), device=False,
        **MIX_KNOBS) for lang, idx in idxs.items()}, n_candidates=32)
    per_engine = {lang: RetrievalEngine(
        idx, store=DocStore(sentences=corp[lang]), device=card,
        **MIX_KNOBS) for lang, idx in idxs.items()}
    queries = [corp["bn"][0], corp["bn"][-1], corp["zh"][7], corp["ko"][3],
               "w1 w5 w9 w200", corp["ru"][19]]
    before = bm25.delta16_rescore.launches
    got = mix.search_texts(queries, k=5)
    assert bm25.delta16_rescore.launches - before == len(corp)
    want = mix_search(per_engine, queries, k=5)
    assert any(got)
    for g, w in zip(got, want):
        gs = np.array([d.score for _, d in g])
        ws = np.array([d.score for _, d in w])
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL)
        cut = gs[-1] * (1 + RTOL) + ATOL if len(gs) else 0.0
        assert {(lang, d.doc_id) for lang, d in g if d.score > cut} == \
            {(lang, d.doc_id) for lang, d in w if d.score > cut}


def test_delta16_kernel_with_global_ids_matches_plain(card):
    """K2 on a MixEngine's concatenated rows, candidates at global ids of
    every language (the last language's last docs at the largest r2),
    against the plain version on the card."""
    from kbner_tpu_torch.retrieval.engine import MixEngine

    corp = _mix_corpora(4)
    mix = MixEngine({lang: RetrievalEngine(
        BM25Index.build(d, pad_docs_to=64), device=False, **MIX_KNOBS)
        for lang, d in corp.items()}, n_candidates=32)
    flat, off, ln, nc = mix._dev[:4]
    rng = np.random.RandomState(0)
    n = off.shape[0]
    cand = np.concatenate([rng.randint(0, n, size=(4, 200)),
                           np.tile(np.arange(n - 50, n), (4, 1))], axis=1)
    cand = torch.from_numpy(cand.astype(np.int32)).to(card)
    qt = torch.from_numpy(rng.randint(-1, 200, size=(4, 64)).astype(
        np.int32)).to(card)
    qw = torch.from_numpy(rng.rand(4, 64).astype(np.float32)).to(card)
    avgdl = mix._scalars[-1][0]
    args = (qt, qw, cand, flat, off, ln, nc, mix._k1, mix._b, avgdl,
            mix._r2)
    got = bm25.delta16_rescore(*args)
    want = bm25.delta16_rescore_ref(*args)
    torch.cuda.synchronize()
    assert mix._r2 > 1 and float(want.abs().sum()) > 0
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


def _stacked_pair(card):
    """A float32 stacked tagger over all four member kinds (XLM-R tiny,
    frozen as ACE's stack holds it, word, char-BiLSTM, Flair) on the CPU
    and, with the same weights, on the card; a quality-corpus batch with
    the classic features; the tag dictionary."""
    from kbner_tpu_torch.data.encode import (add_classic_features,
                                             build_char_vocab,
                                             build_word_vocab, encode_batch)
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus
    from kbner_tpu_torch.models import embedders as emb
    from kbner_tpu_torch.models.tagger import StackedSequenceTagger

    corpus = make_quality_corpus(24, 2, 2, seed=3)
    tags = corpus.make_tag_dictionary("ner")
    wv, cv = build_word_vocab(corpus.train), build_char_vocab(corpus.train)
    enc = XLMRConfig.tiny(vocab_size=1000)
    cfg = TaggerConfig.for_tag_dictionary(enc, tags, locked_dropout=0.0,
                                          word_dropout=0.0)
    taggers = []
    for dev in ("cpu", card):
        specs = [
            emb.EmbedderSpec("x", emb.TransformerWordEmbedder(
                enc, device=dev), 64),
            emb.EmbedderSpec("w", emb.WordEmbedder(len(wv), 16, device=dev),
                             16),
            emb.EmbedderSpec("c", emb.CharBiLSTMEmbedder(len(cv), 8, 12,
                                                         device=dev), 24),
            emb.EmbedderSpec("f", emb.FlairLMEmbedder(len(cv), 8, 32,
                                                      device=dev), 64)]
        taggers.append(StackedSequenceTagger(cfg, specs, device=dev,
                                             seed=0).eval())
    taggers[1].load_state_dict(taggers[0].state_dict())
    eb = encode_batch(corpus.train[:16], HashTokenizer(1000), tags)
    add_classic_features(eb, wv, cv)
    return taggers, eb, tags


@pytest.mark.parametrize("selection", [None, [1.0, 0.0, 1.0, 1.0]])
def test_stacked_tagger_on_card_matches_cpu(card, selection):
    """The stack's features, emissions, loss and tags on the card against
    the CPU, float32, same weights: rtol 1e-5, atol 1e-5 (the LSTMs'
    float32 sums taken in another order over up to 160 steps)."""
    (cpu, gpu), eb, _ = _stacked_pair(card)
    arrays = eb.arrays()
    outs = []
    for tagger, dev in ((cpu, "cpu"), (gpu, card)):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        if selection is not None:
            batch["selection"] = torch.tensor(selection, device=dev)
        with torch.no_grad():
            outs.append((tagger._extract_features(batch),
                         tagger.emissions(batch), tagger.loss(batch),
                         tagger.decode(batch)[0]))
    for name, want, got in zip(("features", "emissions", "loss"), outs[0],
                               outs[1]):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5,
                                   msg=name)
    assert torch.equal(outs[1][3].cpu(), outs[0][3])


@pytest.mark.parametrize("selection", [[1.0, 1.0, 1.0, 1.0],
                                       [1.0, 0.0, 1.0, 1.0]])
def test_stacked_training_step_on_card_matches_cpu(card, selection):
    """One float32 ACE optimizer step (``train_step``, AdamW with lr > 0
    from the first update) of the stacked tagger on the card equals the
    same step on the CPU: the loss rtol 1e-5; the gradients the optimizer
    takes rtol 1e-4, atol 1e-6 (the LSTMs' backward sums taken in another
    order); the updated parameters rtol 1e-4, atol 1e-6, as
    test_training_step_on_card_matches_cpu. The frozen XLM-R has no
    gradient and stays as it was; a masked member's gradients are zero."""
    from kbner_tpu_torch.data.conll import ListCorpus
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    taggers, eb, tags = _stacked_pair(card)
    before = {n: p.detach().clone() for n, p in taggers[0].named_parameters()}
    config = TrainConfig(learning_rate=1e-4, lr_rate=10.0, batch_size=16,
                         use_inverse_sqrt=True)
    runs = []
    for tagger, dev in zip(taggers, ("cpu", card)):
        trainer = FinetuneTrainer(tagger.train(), ListCorpus([]),
                                  HashTokenizer(1000), tags, device=dev)
        trainer.selection = np.asarray(selection, np.float32)
        opt = trainer.make_optimizer(config)
        grads = {}

        def recorded(step=opt.step, model=tagger, grads=grads):
            grads.update({n: None if p.grad is None else
                          p.grad.detach().cpu().clone()
                          for n, p in model.named_parameters()})
            return step()

        opt.step = recorded
        loss = trainer.train_step(eb, opt, config, None)
        runs.append((loss.cpu(), grads, {
            n: p.detach().cpu() for n, p in tagger.named_parameters()}))
    (loss_c, grads_c, after_c), (loss_g, grads_g, after_g) = runs
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-5, atol=0)
    assert grads_g.keys() == grads_c.keys()
    for name, want in grads_c.items():
        if name.startswith("stack.members.0.encoder."):
            assert want is None and grads_g[name] is None, name
            assert torch.equal(after_c[name], before[name]), name
            assert torch.equal(after_g[name], before[name]), name
            continue
        torch.testing.assert_close(grads_g[name], want, rtol=1e-4,
                                   atol=1e-6, msg=name)
        if name.startswith("stack.members.1.") and selection[1] == 0.0:
            assert not bool(want.any()), name
        torch.testing.assert_close(after_g[name], after_c[name], rtol=1e-4,
                                   atol=1e-6, msg=name)
    for lstm in ("stack.members.2.fwd.kernel_h",
                 "stack.members.3.bwd.lstm.kernel_h"):
        assert not torch.equal(after_c[lstm], before[lstm]), lstm


def test_ace_episode_on_card(card, tmp_path):
    """One ACE episode and the final training through ``cli train`` on
    the card: the controller's state, the checkpoint (read back into a
    CPU tagger that decodes the card's tags) and finite test results."""
    import json
    from pathlib import Path

    import yaml

    from kbner_tpu_torch import cli
    from kbner_tpu_torch.config import ExperimentConfig

    fixtures = Path(__file__).parent / "fixtures"
    raw = yaml.safe_load((fixtures / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(fixtures / "ner_toy")
    raw.update(target_dir=str(tmp_path / "run"),
               trainer="ReinforcementTrainer", ace={"episodes": 1})
    raw["model"]["embeddings"] = [
        {"type": "transformer"}, {"type": "word", "dim": 16},
        {"type": "char_bilstm", "char_dim": 8, "hidden": 8},
        {"type": "flair", "embed_dim": 8, "hidden": 16}]
    raw["train"].update(max_epochs=3, learning_rate=0.05)
    path = tmp_path / "ace.yaml"
    path.write_text(yaml.safe_dump(raw))
    result = cli.main(["train", "--config", str(path)])
    run = tmp_path / "run"
    state = json.loads((run / "training_state.json").read_text())
    assert state["best_action"] == result["best_action"]
    assert sum(state["best_action"]) >= 1
    f1 = json.loads((run / "test_results.json").read_text())["TOY"]
    assert 0.0 <= f1["micro_f1"] <= 1.0
    config = ExperimentConfig.from_file(path)
    tags = []
    for dev in ("cpu", "cuda"):
        trainer, _ = cli._build_ace(config, dev)
        trainer.load(run / "best-model.msgpack")
        trainer.model.eval()
        trainer.selection = np.asarray(result["best_action"], np.float32)
        tags.append(trainer.predict(config.load_corpus().test_list[0]))
    assert tags[0] == tags[1]


def _distill_pair(card):
    """A tiny student with transition attention over two languages and
    one teacher (float32, dropout off), the same weights on the card and
    on the CPU, over a two-language quality corpus; the teacher's targets
    cached on the CPU."""
    from kbner_tpu_torch.data.conll import Corpus, ListCorpus
    from kbner_tpu_torch.data.encode import make_batches
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus
    from kbner_tpu_torch.train.distill import DistillationTrainer

    base = make_quality_corpus(16, 2, 2, seed=5).corpora[0]
    corpus = ListCorpus([Corpus(base.train[:8], [], [], "EN"),
                         Corpus(base.train[8:], [], [], "DE")])
    tags = corpus.make_tag_dictionary("ner")
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=1000), tags, locked_dropout=0.0,
        word_dropout=0.0, num_languages=2, transition_attention=True)
    cpu_state = SequenceTagger(cfg, device="cpu", seed=0).state_dict()
    teacher = SequenceTagger(cfg, device="cpu", seed=7)
    out = []
    for dev in ("cpu", card):
        student = SequenceTagger(cfg, device=dev, seed=0)
        student.load_state_dict(cpu_state)
        out.append(DistillationTrainer(student, corpus, HashTokenizer(1000),
                                       tags, teachers=[teacher], device=dev))
    batch = make_batches(corpus.train, HashTokenizer(1000), tags, 16)[0]
    assert set(batch.lang_ids.tolist()) == {0, 1}
    return out, batch


@pytest.mark.parametrize("mode", ["logit", "posterior", "kbest"])
def test_distillation_step_on_card_matches_cpu(card, mode):
    """One float32 distillation step (AdamW with lr > 0 from the first
    update) of a student with transition attention, on the card against
    the CPU, on the CPU's teacher targets: the loss rtol 1e-5; the
    gradients and the updated parameters rtol 1e-4, atol 1e-6, as the
    stacked step (the key biases: a zero gradient within atol 1e-6 on
    both, one Adam step's bound, ``_zero_gradient``). The teacher's
    emissions and k-best paths on the card equal the CPU's (emissions
    rtol 1e-5, atol 1e-5; paths exactly)."""
    from kbner_tpu_torch.train.distill import DistillConfig
    from kbner_tpu_torch.train.optim import make_finetune_optimizer

    trainers, batch = _distill_pair(card)
    config = DistillConfig(interpolation=0.6, temperature=2.0,
                           posterior=mode == "posterior",
                           kbest=3 if mode == "kbest" else 0)
    cached = [t._teacher_kbest([batch], 3)[0] if mode == "kbest" else
              t._teacher_emissions([batch], dtype=np.float32)[0]
              for t in trainers]
    if mode == "kbest":
        np.testing.assert_array_equal(cached[1][0], cached[0][0])
        np.testing.assert_allclose(cached[1][1], cached[0][1], rtol=1e-5,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(cached[1], cached[0], rtol=1e-5,
                                   atol=1e-5)
    runs = []
    before = {n: p.detach().cpu().clone()
              for n, p in trainers[0].model.named_parameters()}
    for trainer in trainers:
        arrays = trainer._to_device(batch)
        opt = make_finetune_optimizer(
            trainer.model.named_parameters(), lr=1e-4, lr_rate=10.0,
            use_inverse_sqrt=True)
        loss = trainer._kd_loss(arrays, trainer._targets(
            config, batch, arrays, cached[0]), config, None)
        loss.backward()
        grads = {n: p.grad.detach().cpu().clone()
                 for n, p in trainer.model.named_parameters()}
        opt.step()
        runs.append((loss.detach().cpu(), grads, {
            n: p.detach().cpu() for n, p in
            trainer.model.named_parameters()}))
    (loss_c, grads_c, after_c), (loss_g, grads_g, after_g) = runs
    torch.testing.assert_close(loss_g, loss_c, rtol=1e-5, atol=0)
    assert bool(grads_c["sent_to_trans_att"].any())
    for name, want in grads_c.items():
        torch.testing.assert_close(grads_g[name], want, rtol=1e-4,
                                   atol=1e-6, msg=name)
        if _zero_gradient(name):
            for grad, moved in ((want, after_c[name]),
                                (grads_g[name], after_g[name])):
                assert float(grad.abs().max()) <= 1e-6, name
                assert float((moved - before[name]).abs().max()) <= \
                    1e-4 * (1 + 1e-6), name
            continue
        torch.testing.assert_close(after_g[name], after_c[name], rtol=1e-4,
                                   atol=1e-6, msg=name)


# -- pretrained checkpoints and the collection-scale index ---------------------

def _write_safetensors(path, tensors):
    """A ``model.safetensors`` file of float32 CPU tensors: a little-endian
    u64 header length, the JSON header, then the raw bytes."""
    import json

    header, blobs, offset = {}, [], 0
    for name, t in tensors.items():
        data = t.detach().contiguous().numpy().astype("<f4").tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head + b"".join(blobs))


def test_hf_checkpoint_on_card_equals_the_cpu_load(card, tmp_path):
    """``load_hf_checkpoint`` onto the card reads the same bits as onto the
    CPU, in float32 and in bfloat16."""
    import json

    from kbner_tpu_torch.models.xlmr import (XLMREncoder, _hf_key_map,
                                             load_hf_checkpoint)

    cfg = XLMRConfig.tiny(vocab_size=251, max_position_embeddings=40)
    torch.manual_seed(0)
    state = {k: torch.randn(v.shape) for k, v in
             XLMREncoder(cfg, device="cpu").state_dict().items()}
    _write_safetensors(tmp_path / "model.safetensors", {
        f"roberta.{hf}": state[ours]
        for hf, ours in _hf_key_map(cfg.num_layers).items()})
    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 251, "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": 40}))
    for dtype in (torch.float32, torch.bfloat16):
        on_card = load_hf_checkpoint(tmp_path, dtype=dtype)
        on_cpu = load_hf_checkpoint(tmp_path, dtype=dtype, device="cpu")
        assert on_card.keys() == state.keys()
        for k, t in on_card.items():
            assert t.device.type == "cuda" and t.dtype == dtype, k
            assert torch.equal(t.cpu(), on_cpu[k]), k
            assert torch.equal(on_cpu[k], state[k].to(dtype)), k


@pytest.mark.parametrize("mode", ["exhaustive", "pruned"])
def test_engine_over_a_sharded_index_matches_the_original(card, tmp_path,
                                                          mode):
    """An index streamed in chunks, saved in shards and reopened serves the
    same top-10 on the card as the one-shot index it equals."""
    docs = synth_wiki_docs(3000, vocab=4000, n_topics=40, seed=5)
    vocab = {f"w{i}": i for i in range(4000)}
    index = BM25Index.build_encoded(docs, vocab)
    chunks = [docs[i:i + 700] for i in range(0, len(docs), 700)]
    streamed = BM25Index.build_streaming(
        (c[:, :int((c >= 0).sum(1).max())] for c in chunks), vocab)
    streamed.save_sharded(tmp_path / "s", n_shards=3)
    reopened = BM25Index.load_sharded(tmp_path / "s")
    np.testing.assert_array_equal(reopened.doc_terms, index.doc_terms)
    np.testing.assert_array_equal(reopened.doc_impacts, index.doc_impacts)
    kw = dict(mode=mode, device=card)
    if mode == "pruned":
        kw.update(rare_terms=16, posting_budget=6144, n_candidates=1024)
    q, _ = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    _assert_same_topk(
        *RetrievalEngine(reopened, **kw).search_encoded(qt, qw, k=10),
        *RetrievalEngine(index, **kw).search_encoded(qt, qw, k=10))


def _shard_operands(S, s):
    """One shard's K1 and K2 operands, as a meshed engine at data
    coordinate ``s`` of ``S`` builds them, and a 32-query batch."""
    from kbner_tpu_torch.retrieval import engine as eng_mod

    docs, pruned = _pruned_engine("cpu")
    index = pruned.text_index
    ss = -(-index.n_docs // (S * 512)) * 512
    n = index.doc_terms.shape[0]
    dt = np.pad(index.doc_terms, ((0, S * ss - n), (0, 0)),
                constant_values=-1)
    di = np.pad(index.doc_impacts, ((0, S * ss - n), (0, 0)))
    q, _ = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    mine = slice(s * ss, (s + 1) * ss)
    k1 = (qt, qw, np.ascontiguousarray(dt[mine].T),
          np.ascontiguousarray(di[mine].T))
    df = index.csr[3]
    dt_r, di_r = eng_mod._drop_tiny_slots(dt, di, df, pruned.tiny_cap)
    p = index.params
    dl = np.zeros(S * ss, np.int64)
    dl[:len(index.doc_dl)] = index.doc_dl
    norm = (p.k1 * (1.0 - p.b + p.b * dl / index.avgdl)).astype(np.float32)
    flat, off, lens, r2 = eng_mod.shard_rows_delta16(
        dt_r, di_r, pruned._d16_remap, index.idf, norm, S, ss, shards=[s])
    lut = np.asarray([eng_mod.long_to_int4(i)
                      for i in range(int(dl.max()) + 1)], np.uint8)
    q2, w2 = pruned._remap_queries_d16(qt, qw)
    cand = np.random.RandomState(s).randint(0, ss, (32, 1024)).astype(
        np.int32)
    k2 = (q2, w2, cand, flat[0].view(np.int16), off[0], lens[0],
          lut[dl][mine])
    return k1, k2, (p.k1, p.b, index.avgdl, r2)


@pytest.mark.parametrize("S", [2, 4])
def test_kernels_on_one_shard_match_plain(card, S):
    """K1 on a shard's contiguous [Ld, N / S] copy and K2 on its delta16
    rows (padded to the shards' widest plus the shared r2 guard rows), at
    every shard of S, against their plain versions on the card."""
    for s in range(S):
        k1, k2, (k1p, b, avgdl, r2) = _shard_operands(S, s)
        k1 = [torch.from_numpy(a).to(card) for a in k1]
        got = bm25.bm25_score_block(*k1)
        torch.testing.assert_close(got, bm25.bm25_score_block_ref(*k1),
                                   rtol=RTOL, atol=ATOL)
        k2 = [torch.from_numpy(np.ascontiguousarray(a)).to(card)
              for a in k2]
        before = bm25.delta16_rescore.launches
        got = bm25.delta16_rescore(*k2, k1p, b, avgdl, r2)
        assert bm25.delta16_rescore.launches == before + 1
        want = bm25.delta16_rescore_ref(*k2, k1p, b, avgdl, r2)
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        # the last shard of S = 4 holds padding docs only
        assert bool((want > 0).any()) == (s * k1[2].shape[1] < 3000)


def test_meshed_engines_on_card_match_the_cpu(card, tmp_path):
    """Two gloo ranks on the one card: the meshed exhaustive and pruned
    engines launch K1 and K2 on their shards, gather their CUDA tensors
    over gloo, and return the top 10 their CPU twins return (within
    ties)."""
    import torch_world

    ranks = torch_world.World(torch_world.card_engine_rank, 2, tmp_path,
                              3000).join()
    for r in ranks:
        for mode, launches in (("exhaustive", [1, 0]), ("pruned", [0, 1])):
            assert list(r[f"{mode}/cuda/launches"]) == launches
            assert list(r[f"{mode}/cpu/launches"]) == [0, 0]
            _assert_same_topk(r[f"{mode}/cuda/s"], r[f"{mode}/cuda/i"],
                              r[f"{mode}/cpu/s"], r[f"{mode}/cpu/i"])


def test_sharded_training_steps_on_card_match_one_rank(card, tmp_path):
    """Two gloo ranks on the one card: a data-parallel step (7 sentences
    padded to 8), a tensor-parallel one and an FSDP one, each with the
    gradients gathered, equal the single-rank step on the padded batch
    in float32 (the reference's tolerances: loss rel 1e-4, gradients
    rtol 2e-3, atol 1e-5)."""
    import torch_world
    from kbner_tpu_torch.data.encode import encode_batch

    ranks = torch_world.World(torch_world.card_train_rank, 2,
                              tmp_path).join()
    corpus = torch_world.toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    arrays = encode_batch(corpus.train[:torch_world.TOY_ROWS],
                          HashTokenizer(torch_world.TOY_VOCAB),
                          tags).arrays()
    for name, (data, _, _) in torch_world.CARD_LAYOUTS.items():
        model = torch_world.toy_tagger(None, tags, device=card)
        padded = {k: torch.from_numpy(np.pad(
            v, [(0, (-v.shape[0]) % data)] + [(0, 0)] * (v.ndim - 1))
        ).to(card) for k, v in arrays.items()}
        loss = model.loss(padded)
        loss.backward()
        for r in ranks:
            assert float(r[f"{name}/loss"]) == pytest.approx(float(loss),
                                                             rel=1e-4)
            for n, p in model.named_parameters():
                np.testing.assert_allclose(r[f"{name}/grad/{n}"],
                                           p.grad.cpu().numpy(), rtol=2e-3,
                                           atol=1e-5, err_msg=f"{name} {n}")


def test_meshed_distillation_and_multi_view_steps_on_card_match_one_rank(
        card, tmp_path):
    """Two gloo ranks on the one card, data-parallel: a logit
    distillation step and a multi-view step (7 fused sentences padded to
    8, the teacher's logits padded with zero rows), each with the
    gradients gathered, equal the single-rank losses on the padded batch
    in float32 (loss rel 1e-4, gradients rtol 2e-3, atol 1e-5)."""
    import torch_world
    from kbner_tpu_torch.data.corpus_ops import make_orig_view
    from kbner_tpu_torch.data.encode import encode_batch

    ranks = torch_world.World(torch_world.card_kd_rank, 2, tmp_path).join()
    corpus = torch_world.fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(torch_world.TOY_VOCAB)
    recs = corpus.train[:torch_world.TOY_ROWS]

    def padded(records):
        return {k: torch.from_numpy(np.pad(
            v, [(0, (-v.shape[0]) % 2)] + [(0, 0)] * (v.ndim - 1))).to(card)
            for k, v in encode_batch(records, tok, tags).arrays().items()}

    batch = padded(recs)
    orig = padded([make_orig_view(r) for r in recs])
    teacher = torch.from_numpy(torch_world.kd_targets(
        len(recs), batch["word_mask"].shape[1], len(tags), 2)).to(card)
    mv = torch_world.MV_CONFIG
    for kind in ("kd", "mv"):
        model = torch_world.toy_tagger(None, tags, device=card)
        if kind == "kd":
            loss = model.distill_loss(batch, teacher,
                                      **torch_world.KD_STEPS["logit"])
        else:
            loss = model.multi_view_loss(batch, orig, kind=mv["mv_kind"],
                                         l2_weight=mv["mv_l2_weight"])
        loss.backward()
        for r in ranks:
            assert float(r[f"{kind}/loss"]) == pytest.approx(loss.item(),
                                                             rel=1e-4)
            for n, p in model.named_parameters():
                np.testing.assert_allclose(r[f"{kind}/grad/{n}"],
                                           p.grad.cpu().numpy(), rtol=2e-3,
                                           atol=1e-5, err_msg=f"{kind} {n}")


def _parser_batch(device, lengths=(9, 4, 1, 6), seed=0, unannotated=0.0):
    """A batch of random projective trees for the biaffine parser:
    encoded arrays with ``heads`` (-1 where unannotated) and ``rel_ids``
    (4 relations), on ``device``."""
    from kbner_tpu_torch.data.conll import SentenceRecord
    from kbner_tpu_torch.data.dictionary import Dictionary
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.models.biaffine import encode_dependency_arrays

    rng = np.random.RandomState(seed)

    def tree(lo, hi, head, out):
        if lo <= hi:
            r = rng.randint(lo, hi + 1)
            out[r - 1] = head
            tree(lo, r - 1, r, out)
            tree(r + 1, hi, r, out)

    rels = Dictionary()
    for r in ("root", "nsubj", "obj", "det"):
        rels.add_item(r)
    recs = []
    for n in lengths:
        heads = [0] * n
        tree(1, n, 0, heads)
        recs.append(SentenceRecord(
            tokens=[f"w{rng.randint(90)}" for _ in range(n)],
            tags={"head": ["_" if rng.rand() < unannotated else str(h)
                           for h in heads],
                  "deprel": [rels.idx2item[rng.randint(4)]
                             for _ in range(n)]}))
    eb = encode_batch(recs, HashTokenizer(vocab_size=1000))
    encode_dependency_arrays(eb, rel_dict=rels)
    return {k: torch.from_numpy(v).to(device) for k, v in eb.arrays().items()}


@pytest.mark.parametrize("arc_loss,partial", [("ce", False), ("crf", False),
                                              ("crf", True)])
def test_parser_loss_and_gradients_on_card_match_cpu(card, arc_loss,
                                                     partial):
    """The float32 biaffine parser (tiny encoder) on the card against the
    same weights on the CPU: the arc scores, the loss (head CE, tree CRF,
    partial tree CRF) and every parameter's gradient; rtol 1e-4 / atol
    1e-5 (float32 reductions in another order)."""
    from kbner_tpu_torch.models.biaffine import BiaffineConfig, BiaffineParser

    cfg = BiaffineConfig(XLMRConfig.tiny(), num_rels=4, arc_dim=32,
                         rel_dim=16, arc_loss=arc_loss, partial=partial)
    cpu = BiaffineParser(cfg, device="cpu", seed=0)
    with torch.no_grad():  # biaffine weights start at zero: make them not
        gen = torch.Generator().manual_seed(1)
        for p in (cpu.arc_attn.weight, cpu.rel_attn.weight):
            p.normal_(0.0, 0.1, generator=gen)
    gpu = BiaffineParser(cfg, device=card, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    kw = dict(unannotated=0.3 if partial else 0.0)
    b_cpu, b_gpu = _parser_batch("cpu", **kw), _parser_batch(card, **kw)
    np.testing.assert_allclose(gpu.scores(b_gpu)[0].detach().cpu().numpy(),
                               cpu.scores(b_cpu)[0].detach().numpy(),
                               rtol=1e-4, atol=1e-5)
    l_cpu, l_gpu = cpu.loss(b_cpu), gpu.loss(b_gpu)
    l_cpu.backward()
    l_gpu.backward()
    np.testing.assert_allclose(float(l_gpu.detach()), float(l_cpu.detach()),
                               rtol=1e-5)
    for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
        np.testing.assert_allclose(q.grad.cpu().numpy(), p.grad.numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_tree_crf_marginals_on_card_match_float64_cpu(card):
    """The inside loop's marginals at a full-width parser's shape (B=16,
    sentences of 8-40 words) on the card against the same scores in
    float64 on the CPU: atol 1e-4."""
    from kbner_tpu_torch.ops.tree_crf import tree_crf_marginals

    rng = np.random.RandomState(3)
    lens = rng.randint(8, 41, size=16)
    n = int(lens.max()) + 1
    scores = (3 * rng.randn(16, n, n)).astype(np.float32)
    wm = (np.arange(n - 1)[None, :] < lens[:, None]).astype(np.int32)
    got = tree_crf_marginals(torch.from_numpy(scores).to(card),
                             torch.from_numpy(wm).to(card))
    want = tree_crf_marginals(torch.from_numpy(scores).double(),
                              torch.from_numpy(wm))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4)
    np.testing.assert_allclose(got.sum(-1).cpu().numpy()[:, 1:],
                               wm.astype(np.float32), atol=1e-4)


def _elmo_batch(elmo_bytes):
    """A quality-corpus batch with ELMo's byte ids or the corpus's
    character ids, and its character vocabulary."""
    from kbner_tpu_torch.data.encode import (add_classic_features,
                                             build_char_vocab, encode_batch)
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus

    corpus = make_quality_corpus(24, 2, 2, seed=5)
    cv = build_char_vocab(corpus.train)
    eb = encode_batch(corpus.train[:12], HashTokenizer(1000))
    add_classic_features(eb, None, None if elmo_bytes else cv,
                         elmo_bytes=elmo_bytes)
    return eb.arrays(), cv, corpus


@pytest.mark.parametrize("bilm", [False, True], ids=["native", "bilm"])
def test_elmo_member_on_card_matches_cpu(card, bilm):
    """The ELMo member's features and every parameter's gradient on the
    card against the CPU, float32, same seeded weights: features rtol
    1e-5, atol 1e-5; gradients rtol 1e-4, atol 1e-5 (sums over characters,
    words and gates taken in another order)."""
    from kbner_tpu_torch.models.embedders import ELMoEmbedder

    arrays, cv, _ = _elmo_batch(bilm)
    kw = dict(filters=((1, 8), (2, 8), (4, 16)), n_highway=2, proj_dim=16,
              num_layers=2, mode="mix")
    if bilm:
        kw.update(cell_dim=64, conv_activation="relu",
                  input_key="elmo_char_ids")
    members = [ELMoEmbedder(261 if bilm else len(cv), 8, device=dev, **kw)
               for dev in ("cpu", card)]
    members[0].reset_parameters(torch.Generator().manual_seed(2))
    members[1].load_state_dict(members[0].state_dict())
    w = torch.from_numpy(np.random.RandomState(3).randn(
        *arrays["word_mask"].shape, members[0].out_dim).astype(np.float32))
    outs = []
    for m, dev in zip(members, ("cpu", card)):
        out = m({k: torch.from_numpy(v).to(dev) for k, v in arrays.items()})
        (out * w.to(dev)).sum().backward()
        outs.append(out.detach().cpu())
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-5, atol=1e-5)
    for (name, p), q in zip(members[0].named_parameters(),
                            members[1].parameters()):
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4,
                                   atol=1e-5, msg=name)


@pytest.mark.parametrize("third", [False, True])
def test_mfvi_head_on_card_matches_cpu(card, third):
    """The MFVI head's loss and gradients (rtol 1e-5 and 1e-4, atol
    1e-6) and decoded tags (equal) on the card against the CPU."""
    from kbner_tpu_torch.ops.mfvi import MFVIHead

    rng = np.random.RandomState(4)
    feats = torch.from_numpy(rng.randn(4, 30, 64).astype(np.float32))
    unary = torch.from_numpy(rng.randn(4, 30, 9).astype(np.float32))
    tags = torch.from_numpy(rng.randint(0, 9, size=(4, 30)))
    mask = torch.ones(4, 30, dtype=torch.int32)
    mask[1, 20:] = 0
    heads = [MFVIHead(64, 9, rank=16, use_third_order=third, device=dev)
             for dev in ("cpu", card)]
    heads[1].load_state_dict(heads[0].state_dict())
    runs = []
    for head, dev in zip(heads, ("cpu", card)):
        args = [t.to(dev) for t in (feats, unary, tags, mask)]
        loss = head.loss(*args)
        loss.backward()
        with torch.no_grad():
            decoded = head.decode(args[0], args[1], args[3])
        runs.append((loss.detach().cpu(), decoded.cpu()))
    torch.testing.assert_close(runs[1][0], runs[0][0], rtol=1e-5, atol=1e-6)
    assert torch.equal(runs[1][1], runs[0][1])
    for (name, p), q in zip(heads[0].named_parameters(),
                            heads[1].parameters()):
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4,
                                   atol=1e-6, msg=name)


@pytest.mark.parametrize("pooling", ["mean", "min", "max"])
def test_pooled_flair_table_on_card_matches_cpu(card, pooling):
    """``build_pooled_flair_table`` on the card against the CPU: the same
    vocabulary, the table within rtol 1e-5, atol 1e-6."""
    from kbner_tpu_torch.models.embedders import (FlairLMEmbedder,
                                                  build_pooled_flair_table)

    _, cv, corpus = _elmo_batch(False)
    flairs = [FlairLMEmbedder(len(cv), 8, 32, device=dev)
              for dev in ("cpu", card)]
    flairs[0].reset_parameters(torch.Generator().manual_seed(6))
    flairs[1].load_state_dict(flairs[0].state_dict())
    (v_cpu, t_cpu), (v_card, t_card) = (build_pooled_flair_table(
        f, corpus.train, HashTokenizer(1000), cv, pooling=pooling,
        batch_size=8) for f in flairs)
    assert v_card.idx2item == v_cpu.idx2item
    np.testing.assert_allclose(t_card, t_cpu, rtol=1e-5, atol=1e-6)
