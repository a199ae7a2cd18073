"""The PyTorch port's pass 2 over every row layout against kbner_tpu's: the
plain twin of the two-array rescore kernel (K3), ``_rescore_candidates``
for each of its five layouts, the two-operand pruned top-k with its
window gather, the packed32 row packer, and the pruned engine over
packed32 rows and with a title field.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU (tests/conftest.py), its Pallas kernels in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kbner_tpu.native as jnative
from kbner_tpu.ops import bm25 as jbm25
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import BM25Params as JParams
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval import engine as jengine
from kbner_tpu.retrieval.index import log_quantize as j_log_quantize
from kbner_tpu_torch import native as tnative
from kbner_tpu_torch.ops import bm25 as tbm25
from kbner_tpu_torch.retrieval import engine as tengine
from kbner_tpu_torch.retrieval.engine import RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index, BM25Params, log_quantize
from kbner_tpu_torch.retrieval.synth import (_HASH_MUL, synth_k1_operands,
                                             synth_k2_operands,
                                             synth_k3_operands)

# K3 against bm25_rescore_pallas: test_rescore_pallas_matches_xla's own
K3_RTOL, K3_ATOL = 2e-5, 1e-5
# pass 2 and the top-k: float32 sums of the same terms in another order
RTOL, ATOL = 1e-5, 1e-5
# a pruned engine against the exhaustive one: 12-bit log-quantized title
# rows (tests/test_pruned_retrieval.py's bar)
BOOST_RTOL = 2e-3
EXP_RTOL = 2.5e-7  # two float32 exp implementations: within an ulp
LO, STEP = -2.0, 1e-4  # the 16-bit log scale of the JAX test


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_corpus(n_docs=400, vocab=300, doc_len=12, seed=0):
    """Zipf docs, the recipe of tests/test_pruned_retrieval.py."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    return [" ".join(f"w{w}" for w in rng.choice(vocab, size=doc_len, p=probs))
            for _ in range(n_docs)]


@pytest.fixture(scope="module")
def corpus():
    """(docs, titles, {quantize_norms: (port, kbner_tpu) text indices},
    (port, kbner_tpu) title indices, 16 queries, 16 entity queries)."""
    docs = make_corpus()
    titles = [" ".join(d.split()[:2]) for d in docs]
    text = {qn: (BM25Index.build(docs, params=BM25Params(quantize_norms=qn),
                                 pad_docs_to=64),
                 JIndex.build(docs, params=JParams(quantize_norms=qn),
                              pad_docs_to=64))
            for qn in (True, False)}
    title = (BM25Index.build(titles, params=BM25Params(quantize_norms=False),
                             pad_docs_to=64),
             JIndex.build(titles, params=JParams(quantize_norms=False),
                          pad_docs_to=64))
    rng = np.random.RandomState(5)
    queries = [docs[i] for i in rng.randint(0, len(docs), 16)]
    ents = [[titles[i]] for i in rng.randint(0, len(docs), 16)]
    return docs, titles, text, title, queries, ents


def assert_same_topk(ts, ti, js, ji, rtol=RTOL, atol=ATOL):
    """Equal scores rank by rank; ids equal except where they swap among
    tied scores."""
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)
    for q in range(ts.shape[0]):
        for r in np.nonzero(ti[q] != ji[q])[0]:
            tied = np.isclose(ts[q], ts[q, r], rtol=rtol, atol=atol)
            assert set(ti[q][tied]) == set(ji[q][tied]), (q, r)


def t_(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -- K3's plain twin -------------------------------------------------------------

def k3_inputs(seed, Q, C, Lq=12, Ld=20, N=600):
    """The inputs of test_rescore_pallas_matches_xla, doc-major: random
    ids with -1 on both sides and random 16-bit codes under the -1 doc
    pads, so a -1 query pad meets a -1 doc slot that carries an impact."""
    rng = np.random.RandomState(seed)
    qt = rng.randint(-1, 50, size=(Q, Lq)).astype(np.int32)
    qw = rng.rand(Q, Lq).astype(np.float32)
    dt = rng.randint(-1, 50, size=(N, Ld)).astype(np.int32)
    codes = rng.randint(0, 1 << 16, size=(N, Ld)).astype(np.uint16)
    cand = rng.randint(0, N, size=(Q, C)).astype(np.int32)
    return qt, qw, cand, dt, codes


def k3_port(qt, qw, cand, dt, codes, fn=tbm25.bm25_rescore_ref):
    return fn(t_(qt), t_(qw), t_(cand), t_(dt), t_(codes.view(np.int16)),
              LO, STEP).numpy()


def test_k3_plain_matches_pallas():
    """Q=16, Lq=12, Ld=20, C=256: bm25_rescore_pallas in interpret mode on
    the gathered, transposed candidate rows; -1 pad matches count."""
    qt, qw, cand, dt, codes = k3_inputs(0, 16, 256)
    want = jbm25.bm25_rescore_pallas(
        jnp.asarray(qt), jnp.asarray(qw),
        jnp.asarray(np.swapaxes(dt[cand], 1, 2).copy()),
        jnp.asarray(np.swapaxes(codes[cand].astype(np.int32), 1, 2).copy()),
        lo=LO, step=STEP)
    got = k3_port(qt, qw, cand, dt, codes)
    np.testing.assert_allclose(got, np.asarray(want), rtol=K3_RTOL,
                               atol=K3_ATOL)
    # the case is exercised: pad query slots meet pad doc slots with
    # nonzero codes, and leaving those matches out changes the scores
    pad_q = (qt == -1).any(1)[:, None, None]
    assert (pad_q & (dt[cand] == -1) & (codes[cand] > 0)).any()
    masked = np.where(qt >= 0, qt, -7).astype(np.int32)
    assert not np.allclose(k3_port(masked, qw, cand, dt, codes), got,
                           rtol=K3_RTOL, atol=K3_ATOL)
    # the wrapper takes the plain version for CPU tensors, launching nothing
    before = tbm25.bm25_rescore.launches
    np.testing.assert_array_equal(
        k3_port(qt, qw, cand, dt, codes, fn=tbm25.bm25_rescore), got)
    assert tbm25.bm25_rescore.launches == before


@pytest.mark.parametrize("Q,C,Lq,Ld", [(5, 300, 12, 20), (3, 77, 1, 52),
                                       (1, 1, 64, 1)])
def test_k3_plain_matches_xla_on_ragged_shapes(Q, C, Lq, Ld):
    """Shapes off the reference's Q % 8 / C % 128 tiling: its
    ``_rescore_candidates`` takes the XLA form of the same arithmetic."""
    qt, qw, cand, dt, codes = k3_inputs(Q + C, Q, C, Lq=Lq, Ld=Ld)
    codes[0] = 65535  # the top code, at a candidate id 0
    cand[:, 0] = 0
    cand[:, -1] = dt.shape[0] - 1
    field = (jnp.asarray(qt), jnp.asarray(qw), jnp.asarray(dt),
             jnp.asarray(codes), LO, STEP)
    want = jbm25._rescore_candidates(jnp.asarray(cand), (field,), (), True)
    np.testing.assert_allclose(k3_port(qt, qw, cand, dt, codes),
                               np.asarray(want), rtol=K3_RTOL, atol=K3_ATOL)


@pytest.mark.parametrize("Q,C,Lq,Ld,kind,vocab", [
    (5, 300, 64, 52, "collide", 40),    # ids on one hash slot
    (8, 128, 64, 52, "collide", 40),    # (the Pallas kernel's tiling)
    (5, 300, 64, 52, "pads", 40),       # -1 query slots meet coded pads
    (8, 128, 64, 52, "pads", 40),
    (5, 300, 12, 13, "pads", 40),       # Ld = 13, not a multiple of 4
    (2, 64, 6144, 52, "random", 20000),  # Lq = 6144, the wrapper's limit
])
def test_k3_plain_matches_reference_on_kernel_traps(Q, C, Lq, Ld, kind,
                                                    vocab):
    """The K3 kernel's trap operands (synth_k3_operands) through
    kbner_tpu's ``_rescore_candidates``: the Pallas kernel in interpret
    mode where Q % 8 == 0 and C % 128 == 0, its XLA form elsewhere."""
    qt, qw, cand, dt, codes, lo, step = synth_k3_operands(
        Q + C + Ld, Q, C, Lq, Ld, vocab=vocab, kind=kind)
    field = (jnp.asarray(qt), jnp.asarray(qw), jnp.asarray(dt),
             jnp.asarray(codes), lo, step)
    want = jbm25._rescore_candidates(jnp.asarray(cand), (field,), (), True)
    got = tbm25.bm25_rescore_ref(t_(qt), t_(qw), t_(cand), t_(dt),
                                 t_(codes.view(np.int16)), lo, step).numpy()
    assert (got > 0).mean() > 0.5
    np.testing.assert_allclose(got, np.asarray(want), rtol=K3_RTOL,
                               atol=K3_ATOL)
    if kind == "pads":  # -1 query slots meet -1 doc slots with codes
        assert ((qt == -1).any(1)[:, None, None] & (dt[cand] == -1)
                & (codes[cand] > 0)).any()


def _d16_ids(flat, off, lens):
    """Every term id that delta16 rows decode to: the prefix sums of each
    segment's gaps at its slots with tf > 0."""
    slots = flat.reshape(-1).astype(np.int64)
    out = []
    for o, n in zip(off, lens):
        seg = slots[o:o + n]
        out.append(np.cumsum(seg >> 3)[(seg & 7) > 0])
    return np.concatenate(out)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_collide_kinds_fall_on_one_hash_slot(kernel):
    """The "collide" trap operands put their ids on one slot of the
    kernels' term hash (term_table.cuh, bm25_score.cu: the top log_t bits
    of id * 2654435761 mod 2^32) at every table size from 32 to 8192
    entries. K1's set is half such ids and half ids sharing their low 16
    bits; K2's and K3's are all such ids."""
    if kernel == "K1":
        qt, _, dt, _ = synth_k1_operands(0, 32, 64, 52, 300, "collide")
        ids = np.concatenate([qt.ravel(), dt.ravel()])
    elif kernel == "K2":
        qt, _, _, flat, off, lens = synth_k2_operands(0, 8, 128,
                                                      "collide")[:6]
        ids = np.concatenate([qt.ravel(), _d16_ids(flat, off, lens)])
    else:
        qt, _, _, dt = synth_k3_operands(0, 8, 128, 64, 52,
                                         kind="collide")[:4]
        ids = np.concatenate([qt.ravel(), dt.ravel()])
    ids = np.unique(ids[ids >= 0]).astype(np.int64)
    assert len(ids) >= 40
    prod = (ids * _HASH_MUL) & 0xFFFFFFFF
    for log_t in range(5, 14):
        n_slots = len(np.unique(prod >> (32 - log_t)))
        if kernel == "K1":
            assert np.bincount(prod >> (32 - log_t)).max() >= 20
        else:
            assert n_slots == 1, (log_t, n_slots)


# -- _rescore_candidates over every layout ---------------------------------------

LAYOUTS = ("delta16", "packed32", "packed_dense", "two_array", "f32")


def layout_fields(corpus, layout, Q):
    """One field of ``layout`` built from the corpus's text index, as
    (port field, kbner_tpu field, ragged rows)."""
    _, _, text, _, queries, _ = corpus
    t = text[True][0]
    qt, qw = t.encode_queries(queries[:Q])
    dt, di = t.doc_terms, t.doc_impacts
    if layout in ("delta16", "packed32"):
        te = RetrievalEngine(t, mode="pruned", device="cpu",
                             compact_rows=False, row_layout=layout)
        field = te._field("text", *te._text_query_block(qt, qw))
        r2 = te._row_meta["text"][4]
        arrays = [x.numpy() for x in field[:6 if layout == "delta16" else 5]]
        if layout == "delta16":
            arrays[2] = arrays[2].view(np.uint16)
        jfield = tuple(jnp.asarray(x) for x in arrays) + tuple(
            field[len(arrays):])
        return field, jfield, r2
    if layout == "f32":
        arrays, scalars = (qt, qw, dt, di), ()
    elif layout == "two_array":
        codes, lo, step = log_quantize(di, bits=16)
        arrays, scalars = (qt, qw, dt, codes), (lo, step)
    else:
        tb = int(np.ceil(np.log2(len(t.vocab) + 2)))
        codes, lo, step = log_quantize(di, bits=32 - tb)
        packed = ((codes.astype(np.uint32) << tb)
                  | (dt.astype(np.uint32) & ((1 << tb) - 1))).view(np.int32)
        arrays, scalars = (qt, qw, np.where(dt >= 0, packed, -1)), (
            tb, lo, step)
    port = [t_(x) for x in arrays]
    if layout == "two_array":
        port[3] = t_(arrays[3].view(np.int16))
    return (tuple(port) + scalars,
            tuple(jnp.asarray(x) for x in arrays) + scalars, 1)


@pytest.mark.parametrize("Q,C", [(8, 128), (5, 300)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_rescore_candidates_matches_jax(corpus, layout, Q, C):
    """Each layout's pass 2, the port's dispatch against the reference's
    (Pallas where it takes it: Q % 8 == 0 and C % 128 == 0), on
    candidates that include ids past the doc axis (an XLA gather clamps
    them; so must the port)."""
    field, jfield, r2 = layout_fields(corpus, layout, Q)
    rng = np.random.RandomState(C)
    cand = rng.randint(0, 448, size=(Q, C)).astype(np.int64)
    cand[:, 1] = 0xFFFFFF
    cand[:, 2] = 447
    got = tbm25._rescore_candidates(torch.from_numpy(cand), (field,), (r2,))
    want = jbm25._rescore_candidates(jnp.asarray(cand.astype(np.int32)),
                                     (jfield,), (r2,), True)
    assert got.dtype == torch.float32 and (got.numpy() > 0).mean() > 0.3
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    fn, _ = tbm25._rescore_operands(torch.from_numpy(cand), (field,),
                                    (r2,))[0]
    kernel = {"delta16": tbm25.delta16_rescore,
              "two_array": tbm25.bm25_rescore}.get(layout)
    assert (fn is kernel) == (kernel is not None)


def test_rescore_operands_refuses_unknown_layouts():
    field = (torch.zeros((1, 1), dtype=torch.int32), torch.zeros((1, 1)),
             torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="3 operands"):
        tbm25._rescore_operands(torch.zeros((1, 1), dtype=torch.int64),
                                (field,), ())


# -- the two-operand pruned top-k ------------------------------------------------

def f32_field(N, entries, Ld=2, n_terms=2):
    """A float32 field [N, Ld] with (doc, slot, term, impact) entries and
    the query of terms 0 .. n_terms - 1 at weight 1."""
    dt = np.full((N, Ld), -1, np.int32)
    di = np.zeros((N, Ld), np.float32)
    for d, j, term, imp in entries:
        dt[d, j], di[d, j] = term, imp
    qt = np.arange(n_terms, dtype=np.int32)[None]
    qw = np.ones((1, n_terms), np.float32)
    return (t_(qt), t_(qw), t_(dt), t_(di)), tuple(
        jnp.asarray(x) for x in (qt, qw, dt, di))


def both_topk(cand_doc, cand_imp, field, jfield, **kw):
    """The port's and the reference's two-operand top-k on one pool."""
    ts, ti = tbm25.bm25_pruned_topk(
        t_(np.asarray(cand_doc, np.int32)),
        t_(np.asarray(cand_imp, np.float32)), (field,), **kw)
    js, ji = jbm25.bm25_pruned_topk(
        jnp.asarray(cand_doc, jnp.int32), jnp.asarray(cand_imp, jnp.float32),
        (jfield,), **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    return ts.numpy()[0].tolist(), ti.numpy()[0].tolist()


def test_pruned_topk_duplicate_summing():
    """Two entries of doc 3 merge before the top-C (as
    tests/test_pruned_retrieval.py builds it)."""
    field, jfield = f32_field(8, [(3, 0, 0, 1.0), (7, 0, 1, 4.0)])
    scores, ids = both_topk([[3, 3, 7, -1]], [[1.0, 2.0, 5.0, 0.0]], field,
                            jfield, n_real_docs=8, k=2, n_candidates=4,
                            max_dup_shifts=4)
    assert ids == [7, 3] and scores == pytest.approx([4.0, 1.0])


def test_pruned_dedup_scan_long_runs():
    """A 16-entry run sums fully and beats single higher impacts; a run
    past the window does not crash or double-count."""
    P = 64
    docs = [5] * 16 + list(range(10, 20)) + [77] * 20
    imps = [1.0] * 16 + [10.0] * 10 + [0.1] * 20
    docs += [-1] * (P - len(docs))
    imps += [0.0] * (P - len(imps))
    entries = [(d, 0, 0, v) for d, v in
               [(5, 3.0), (77, 0.5)] + [(d, 1.0) for d in range(10, 20)]]
    field, jfield = f32_field(100, entries, Ld=1, n_terms=1)
    scores, ids = both_topk([docs], [imps], field, jfield, n_real_docs=100,
                            k=2, n_candidates=2, max_dup_shifts=16)
    assert ids[0] == 5 and ids[1] in range(10, 20)
    assert scores[0] == pytest.approx(3.0)


def test_pruned_topk_exact_by_sign():
    """Negative impacts are exact contributions, concatenated before the
    windows: their magnitude ranks, and they add to the rescore."""
    field, jfield = f32_field(16, [(3, 0, 0, 1.0), (7, 0, 1, 4.0),
                                   (9, 0, 0, 0.5)])
    cand_doc = [[3, 9, 12, 7, 9, 3, -1]]
    cand_imp = [[-2.0, -0.25, -6.0, 4.0, 1.0, 1.0, 0.0]]
    scores, ids = both_topk(cand_doc, cand_imp, field, jfield,
                            n_real_docs=16, k=4, n_candidates=4,
                            max_dup_shifts=4, exact_by_sign=True)
    # 12: 0 + 6 exact; 7: 4; 3: 1 + 2 exact; 9: 0.5 + 0.25 exact
    assert ids == [12, 7, 3, 9]
    assert scores == pytest.approx([6.0, 4.0, 3.0, 0.75])


@pytest.mark.parametrize("aligned", [False, True])
def test_gather_pruned_candidates_matches_jax(corpus, aligned):
    t = corpus[2][True][0]
    cap = 170
    off32, packed, lo, step = t.csr_rows_packed(cap=cap,
                                                align_windows=aligned)
    rng = np.random.RandomState(int(aligned))
    rare = rng.randint(0, len(t.vocab), size=(6, 9)).astype(np.int32)
    rare[rng.rand(6, 9) < 0.3] = -1
    rare[0, 0] = len(t.vocab) - 1  # the last term's window
    got = tbm25.gather_pruned_candidates(t_(rare), t_(off32), t_(packed),
                                         cap, lo, step)
    want = jbm25.gather_pruned_candidates(
        jnp.asarray(rare), jnp.asarray(off32), jnp.asarray(packed), cap,
        lo, step)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # XLA's float32 exp and torch's differ by an ulp on some codes
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=EXP_RTOL, atol=0)
    assert (got[0].numpy() >= 0).sum() > 50


def two_operand_pool(eng, qt):
    """The packed32 engine's rare terms and CSR windows as the two-operand
    pool, and the same windows as packed keys."""
    rare = t_(eng._select_rare_terms(qt))
    off, pk = eng.csr["text"]
    lo, step = eng._csr_scale["text"]
    cd, ci = tbm25.gather_pruned_candidates(rare, off, pk,
                                            eng.per_term_cap, lo, step)
    keys = tbm25.gather_pruned_candidate_keys(rare, off, pk,
                                              eng.per_term_cap)
    return cd, ci, keys, (lo, step)


def test_packed_kernel_matches_two_operand(corpus):
    """The single-key pruned top-k and the two-operand one give the same
    top-k on one candidate pool (tests/test_pruned_retrieval.py), and the
    two-operand one equals the reference's."""
    t, j = corpus[2][True]
    queries = corpus[4][:8]
    kw = dict(mode="pruned", rare_terms=12, posting_budget=4096,
              n_candidates=128, compact_rows=False, row_layout="packed32")
    eng = RetrievalEngine(t, device="cpu", **kw)
    qt, qw = t.encode_queries(queries)
    cd, ci, keys, (lo, step) = two_operand_pool(eng, qt)
    field = eng._field("text", *eng._text_query_block(qt, qw))
    r2 = eng._row_meta["text"][4]
    opts = dict(n_real_docs=t.n_docs, k=10, n_candidates=128,
                max_dup_shifts=12, ragged_rows=(r2,))
    s1, i1 = tbm25.bm25_pruned_topk(cd, ci, (field,), **opts)
    s2, i2 = tbm25.bm25_pruned_topk_packed(keys, (field,), imp_lo=lo,
                                           imp_step=step, **opts)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=RTOL)
    assert (i1.numpy() >= 0).all()

    je = JEngine(j, **kw)
    jfield = tuple(jnp.asarray(x.numpy()) for x in field[:5]) + field[5:]
    js, ji = jbm25.bm25_pruned_topk(jnp.asarray(cd.numpy()),
                                    jnp.asarray(ci.numpy()), (jfield,),
                                    **opts)
    np.testing.assert_array_equal(eng._select_rare_terms(qt),
                                  je._select_rare_terms(qt))
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    np.testing.assert_allclose(s1.numpy(), np.asarray(js), rtol=RTOL)


def test_two_operand_topk_over_two_array_field_matches_jax(corpus):
    """The path K3 serves: the engine's pool rescored over a two-array
    field (term ids + 16-bit log codes of the same index), port against
    reference (whose Pallas kernel takes Q=16, C=128)."""
    t = corpus[2][True][0]
    queries = corpus[4]
    eng = RetrievalEngine(t, mode="pruned", device="cpu", rare_terms=12,
                          posting_budget=4096, n_candidates=128,
                          compact_rows=False, row_layout="packed32")
    qt, qw = t.encode_queries(queries)
    cd, ci, _, _ = two_operand_pool(eng, qt)
    codes, lo, step = log_quantize(t.doc_impacts, bits=16)
    field = (t_(qt), t_(qw), t_(t.doc_terms), t_(codes.view(np.int16)), lo,
             step)
    jfield = (jnp.asarray(qt), jnp.asarray(qw), jnp.asarray(t.doc_terms),
              jnp.asarray(codes), lo, step)
    opts = dict(n_real_docs=t.n_docs, k=10, n_candidates=128,
                max_dup_shifts=12)
    _, valid, _, ops = tbm25.pass2_operands_two_operand(
        cd, ci, (field,), n_candidates=128, max_dup_shifts=12)
    assert ops[0][0] is tbm25.bm25_rescore and valid.all()
    ts, ti = tbm25.bm25_pruned_topk(cd, ci, (field,), **opts)
    js, ji = jbm25.bm25_pruned_topk(jnp.asarray(cd.numpy()),
                                    jnp.asarray(ci.numpy()), (jfield,),
                                    use_pallas=True, **opts)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)


# -- the packed32 row packer -----------------------------------------------------

def scale_of(kind, index, code_bits):
    if kind == "none":
        return None
    if kind == "global":
        return (-3.25, 0.001)
    return tengine._term_scale_from_csr(index, code_bits)


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["none", "global", "per_term"])
def test_pack_doc_rows_ragged_matches_jax(corpus, monkeypatch, branch, kind):
    """Bit-equal to the reference's rows through either of its branches
    (the native fused pack, or its numpy code with the native one off), on
    the index's rows and on rows with the tiny slots dropped."""
    t = corpus[2][True][0]
    ran = []
    native = jnative.pack_ragged
    if branch == "numpy":
        monkeypatch.setattr(jnative, "pack_ragged", lambda *a, **k: False)
    else:
        monkeypatch.setattr(jnative, "pack_ragged",
                            lambda *a, **k: ran.append(native(*a, **k))
                            or ran[-1])
    V = len(t.vocab)
    code_bits = 32 - int(np.ceil(np.log2(V + 2)))
    scale = scale_of(kind, t, code_bits)
    compact = tengine._drop_tiny_slots(t.doc_terms, t.doc_impacts,
                                       t.csr[3], 3)
    for dt, di in ((t.doc_terms, t.doc_impacts), compact):
        got = tengine._pack_doc_rows_ragged(dt, di, V, scale=scale)
        want = jengine._pack_doc_rows_ragged(dt, di, V, scale=scale)
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
        assert got[3:] == want[3:]
    assert ran == ([True, True] if branch == "native" else [])


def test_pack_doc_rows_ragged_interior_pads(monkeypatch):
    """Where the reference's two branches part: a -1 between real slots.
    The native pack left-packs each row's real slots; the numpy branch,
    which the port follows, keeps them at their columns, so a slot after
    the pad falls outside the segment. The engine only hands the packer
    left-packed rows (BM25Index rows, _drop_tiny_slots), where they
    agree (test above)."""
    dt = np.asarray([[5, -1, 7], [3, 4, -1]], np.int32)
    di = np.asarray([[0.5, 0.0, 2.0], [1.0, 3.0, 0.0]], np.float32)
    got = tengine._pack_doc_rows_ragged(dt, di, 16)
    native = jengine._pack_doc_rows_ragged(dt, di, 16)
    monkeypatch.setattr(jnative, "pack_ragged", lambda *a, **k: False)
    numpy_branch = jengine._pack_doc_rows_ragged(dt, di, 16)
    np.testing.assert_array_equal(got[0], numpy_branch[0])
    tb = got[3]
    seg = got[0].ravel()[got[1][0]:got[1][0] + got[2][0]]
    assert (seg & ((1 << tb) - 1)).tolist() == [5, (1 << tb) - 1]  # a pad
    nseg = native[0].ravel()[native[1][0]:native[1][0] + native[2][0]]
    assert (nseg & ((1 << tb) - 1)).tolist() == [5, 7]


@pytest.mark.parametrize("field", ["text", "title"])
def test_term_scale_from_csr_matches_jax(corpus, field):
    _, _, text, title, _, _ = corpus
    t, j = text[True] if field == "text" else title
    for code_bits in (12, 23):
        got = tengine._term_scale_from_csr(t, code_bits)
        want = jengine._term_scale_from_csr(j, code_bits)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == want[0].dtype and got[1] == want[1]


@pytest.mark.parametrize("bits,scale", [(16, None), (12, (-1.5, 0.002)),
                                        (23, (0.25, 1e-6))])
def test_quantize_codes_matches_jax(corpus, bits, scale):
    """The log codes of the index's impacts: ``log_quantize``'s on their
    own range, and at a given scale the codes the native ragged pack
    writes above the term bits, equal to the reference's
    ``_quantize_codes``."""
    t = corpus[2][True][0]
    di = t.doc_impacts
    want = jengine._quantize_codes(di, bits, scale)
    if scale is None:
        got = log_quantize(di, bits)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[0], j_log_quantize(di, bits)[0])
        assert got[0].dtype == want[0].dtype and got[1:] == want[1:]
        return
    N, Ld = di.shape
    flat = np.full(N * Ld, -1, np.int32)
    tnative.pack_ragged(t.doc_terms, di, np.arange(N) * Ld, 32 - bits,
                        scale[0], scale[1], (1 << bits) - 2, flat)
    valid = t.doc_terms >= 0
    codes = flat.reshape(N, Ld).view(np.uint32) >> (32 - bits)
    np.testing.assert_array_equal(codes[valid], want[0][valid])
    assert (want[0][valid] > 1).any()


# -- the pruned engine over packed32 rows and with a title field -----------------

ENGINE_CONFIGS = {
    "packed32": dict(row_layout="packed32"),
    "packed32_full_rows": dict(row_layout="packed32", compact_rows=False),
    "packed32_bench": dict(row_layout="packed32", rare_terms=16,
                           posting_budget=6144, n_candidates=1024,
                           tiny_width=384, tiny_pack=False,
                           tiny_df_cap=128, tiny_cols_floor=512,
                           d16_width_floor=32),
    "auto_raw_norms": dict(),
}


def engines(corpus, config, with_title=False):
    _, _, text, title, queries, ents = corpus
    t, j = text[config != "auto_raw_norms"]
    kw = ENGINE_CONFIGS[config]
    extra = dict(title_index=title[0]) if with_title else {}
    jextra = dict(title_index=title[1]) if with_title else {}
    te = RetrievalEngine(t, mode="pruned", device="cpu", **extra, **kw)
    je = JEngine(j, mode="pruned", **jextra, **kw)
    return te, je


def assert_same_arrays(te, je, name):
    """The engine's device arrays of field ``name`` equal the reference's."""
    for a, b in zip(te.rows[name], je._device_rows[name]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert te._row_meta[name] == je._row_meta[name]
    np.testing.assert_array_equal(te._term_lo[name], je._term_lo[name])
    jcsr = je._device_csr if name == "text" else je._device_csr_title
    jscale = je._csr_scale if name == "text" else je._csr_scale_title
    for a, b in zip(te.csr[name], jcsr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert te._csr_scale[name] == jscale


@pytest.mark.parametrize("config", sorted(ENGINE_CONFIGS))
def test_packed32_engine_matches_jax(corpus, config):
    """row_layout='packed32', and 'auto' on an index without quantized
    norms: the same rows, CSR and top-k as the reference."""
    te, je = engines(corpus, config)
    assert te._row_meta["text"][0] == "p32"
    assert_same_arrays(te, je, "text")
    qt, qw = te.text_index.encode_queries(corpus[4])
    for _ in range(2):
        ts, ti = te.search_encoded(qt, qw, k=10)
        js, ji = je.search_encoded(qt, qw, k=10)
        assert (ti >= 0).all()
        assert_same_topk(ts, ti, js, ji)


@pytest.mark.parametrize("config", ["auto_raw_norms", "packed32_full_rows"])
def test_packed32_engine_recall_against_exhaustive(corpus, config):
    """The bars of tests/test_pruned_retrieval.py for a packed32 engine:
    recall@10 >= 0.99 of the exhaustive top-10, and equal scores where
    both find a doc."""
    te, _ = engines(corpus, config)
    queries = corpus[4]
    exact = RetrievalEngine(te.text_index, device="cpu").search(queries,
                                                                 k=10)
    recalls = []
    for a, b in zip(exact, te.search(queries, k=10)):
        by_id = {d.doc_id: d.score for d in a}
        recalls.append(len(by_id.keys() & {d.doc_id for d in b})
                       / len(by_id))
        for d in b:
            if d.doc_id in by_id:
                assert d.score == pytest.approx(by_id[d.doc_id], rel=5e-4)
    assert np.mean(recalls) >= 0.99, np.mean(recalls)


def parse_title_upload(je, packed, lqs, t_cols):
    """The title rare block and the title query block of kbner_tpu's
    single upload (tiny block as tiny_pack=False, tiny_f16=True sends it,
    or none)."""
    M = je.rare_terms
    pos = 2 * M + (t_cols + t_cols // 2 if t_cols else 0) + 2 * lqs[0]
    return (packed[:, M:2 * M], packed[:, pos:pos + lqs[1]],
            packed[:, pos + lqs[1]:pos + 2 * lqs[1]].view(np.float32))


@pytest.mark.parametrize("layout", ["auto", "packed32"])
def test_title_field_engine_matches_jax(corpus, layout, monkeypatch):
    """Entity-boosted pruned search with a title index: the same title
    rows, CSR, second rare block and folded title weights as the
    reference, the same top-k, and the exhaustive engine's documents
    (tests/test_pruned_retrieval.py's entity-boost test)."""
    monkeypatch.setattr(jnative, "gather_tiny_exact", lambda *a, **k: None)
    _, _, text, title, queries, ents = corpus
    kw = dict(rare_terms=12, posting_budget=4096, n_candidates=256,
              row_layout=layout, tiny_pack=False)
    te = RetrievalEngine(text[True][0], title_index=title[0], mode="pruned",
                         device="cpu", **kw)
    je = JEngine(text[True][1], title_index=title[1], mode="pruned", **kw)
    assert te._row_meta["title"][0] == "p32"
    assert_same_arrays(te, je, "title")
    qt, qw = te.text_index.encode_queries(queries)
    tt, tw = te.title_index.encode_queries(
        [" ".join(e) for e in ents], boosts=[2.0] * len(ents))
    rares, _, blocks = te._pack_queries(qt, qw, tt, tw)
    packed, lqs, t_cols, _ = je._pack_queries(qt, qw, [(tt, tw)])
    want = parse_title_upload(je, packed, lqs, t_cols)
    np.testing.assert_array_equal(rares[1], want[0])
    np.testing.assert_array_equal(blocks[1][0], want[1])
    np.testing.assert_array_equal(blocks[1][1], want[2])
    assert (rares[1] >= 0).any()

    ts, ti = te.search_encoded(qt, qw, k=5, title_terms=tt, title_weights=tw)
    js, ji = je.search_encoded(qt, qw, k=5, title_terms=tt, title_weights=tw)
    assert_same_topk(ts, ti, js, ji)

    exact = RetrievalEngine(text[True][0], title_index=title[0],
                            device="cpu").search(queries, k=5,
                                                 entity_queries=ents)
    for a, b in zip(exact, te.search(queries, k=5, entity_queries=ents)):
        assert {d.doc_id for d in a} == {d.doc_id for d in b}
        np.testing.assert_allclose(sorted(d.score for d in a),
                                   sorted(d.score for d in b),
                                   rtol=BOOST_RTOL)


def test_title_index_without_entity_queries_searches_text_alone(corpus):
    """With a title index but no entity queries the pruned engine
    searches the text field alone, as the reference's dispatch does: the
    results equal the text-only engine's, and the reference's."""
    _, _, text, title, queries, _ = corpus
    t, j = text[True]
    te = RetrievalEngine(t, title_index=title[0], mode="pruned",
                         device="cpu")
    plain = RetrievalEngine(t, mode="pruned", device="cpu")
    je = JEngine(j, title_index=title[1], mode="pruned")
    qt, qw = t.encode_queries(queries)
    ts, ti = te.search_encoded(qt, qw, k=10)
    ps, pi = plain.search_encoded(qt, qw, k=10)
    np.testing.assert_array_equal(ti, pi)
    np.testing.assert_array_equal(ts, ps)
    assert_same_topk(ts, ti, *je.search_encoded(qt, qw, k=10))
    rares, _, blocks = te._pack_queries(qt, qw)
    assert len(rares) == len(blocks) == 1


def test_entity_queries_need_a_title_index(corpus):
    t = corpus[2][True][0]
    te = RetrievalEngine(t, mode="pruned", device="cpu")
    with pytest.raises(ValueError, match="title index"):
        te.search(["w1 w2"], entity_queries=[["w3"]])
    qt, qw = t.encode_queries(["w1 w2"])
    with pytest.raises(ValueError, match="title index"):
        te.search_encoded(qt, qw, title_terms=qt, title_weights=qw)
