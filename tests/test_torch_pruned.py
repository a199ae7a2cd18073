"""The PyTorch port's pruned retrieval path against kbner_tpu's: the CSR
side of the index, the delta16 row packer, the host query preparation, the
pass-1 key gather, the plain twin of the delta16 rescore kernel (K2), the
pruned top-k and the pruned engine end to end.

Inputs are made with numpy from a seed and fed to both packages; JAX runs
on the CPU (tests/conftest.py), its Pallas kernel in interpret mode.
"""

import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import kbner_tpu.native as jnative
from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.ops import bm25 as jbm25
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import BM25Params as JParams
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval import engine as jengine
from kbner_tpu.retrieval.fusion import fuse_contexts as j_fuse
from kbner_tpu_torch import cli
from kbner_tpu_torch import native as tnative
from kbner_tpu_torch.data.dictionary import make_tag_dictionary
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.ops import bm25 as tbm25
from kbner_tpu_torch.retrieval import engine as tengine
from kbner_tpu_torch.retrieval.engine import DocStore, RetrievalEngine
from kbner_tpu_torch.retrieval.fusion import fuse_contexts
from kbner_tpu_torch.retrieval.index import (BM25Index, BM25Params,
                                             long_to_int4, int4_to_long)
from kbner_tpu_torch.retrieval.pipeline import build_kb_from_jsonl
from kbner_tpu_torch.retrieval.synth import (K2_KINDS, synth_delta16_docs,
                                             synth_k2_operands,
                                             synth_rescore_operands)
from kbner_tpu_torch.serve import request_record, serve

# float32 sums of the same terms in another order; the tiny sums of the
# numpy twin are float64, the native gathers' float32
RTOL, ATOL = 1e-5, 1e-5
K2_RTOL, K2_ATOL = 1e-5, 1e-6
TINY_RTOL = 1e-6

# the knobs bench.py tunes the pruned engine with (bench.py:381-389)
BENCH_KNOBS = dict(rare_terms=16, posting_budget=6144, n_candidates=1024,
                   tiny_width=384, tiny_pack=False, tiny_df_cap=128,
                   tiny_cols_floor=512, d16_width_floor=32)
ENGINE_CONFIGS = {
    "defaults": {},
    "bench": BENCH_KNOBS,
    "tiny_pack": dict(tiny_pack=True, tiny_f16=False, tiny_df_cap=8),
    "tiny_f16": dict(tiny_pack=False, tiny_f16=True, tiny_df_cap=8),
    "tiny_f32": dict(tiny_pack=False, tiny_f16=False, tiny_df_cap=8),
    "tiny_width": dict(tiny_width=128, tiny_pack=False, rare_terms=8,
                       posting_budget=2048, n_candidates=256),
    "full_rows": dict(compact_rows=False),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def zipf_corpus(n_docs=512, vocab=400, doc_len=12, seed=0, max_rep=3):
    """Zipf docs with bounded within-doc repeats (tf <= max_rep keeps the
    delta16 3-bit tf field exact). A copy of the recipe of
    tests/test_delta16_rows.py."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    docs = []
    for _ in range(n_docs):
        words = []
        counts = {}
        while len(words) < doc_len:
            w = int(rng.choice(vocab, p=probs))
            if counts.get(w, 0) >= max_rep:
                continue
            counts[w] = counts.get(w, 0) + 1
            words.append(f"w{w}")
        docs.append(" ".join(words))
    return docs


@pytest.fixture(scope="module")
def corpus():
    """(docs, port index, kbner_tpu index, 16 query strings)."""
    docs = zipf_corpus()
    t = BM25Index.build(docs, params=BM25Params(quantize_norms=True),
                        pad_docs_to=64)
    j = JIndex.build(docs, params=JParams(quantize_norms=True),
                     pad_docs_to=64)
    rng = np.random.RandomState(1)
    queries = [docs[i] for i in rng.randint(0, len(docs), 16)]
    return docs, t, j, queries


def assert_same_topk(ts, ti, js, ji, rtol=RTOL, atol=ATOL):
    """Equal scores rank by rank; ids equal except where they swap among
    tied scores."""
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)
    for q in range(ts.shape[0]):
        for r in np.nonzero(ti[q] != ji[q])[0]:
            tied = np.isclose(ts[q], ts[q, r], rtol=rtol, atol=atol)
            assert set(ti[q][tied]) == set(ji[q][tied]), (q, r)


# -- the CSR side of the index -------------------------------------------------

def test_csr_matches_jax(corpus):
    _, t, j, _ = corpus
    got, want = t.csr, j.csr
    assert len(got) == 4
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("cap,min_df", [(0, 0), (5, 0), (5, 3), (0, 3),
                                        (1000, 0)])
def test_csr_capped_matches_jax(corpus, cap, min_df):
    _, t, j, _ = corpus
    for a, b in zip(t.csr_capped(cap, min_df=min_df),
                    j.csr_capped(cap, min_df=min_df)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("align_windows", [False, True])
@pytest.mark.parametrize("cap,min_df", [(0, 0), (170, 64), (7, 2)])
def test_csr_rows_packed_matches_jax(corpus, cap, min_df, align_windows):
    _, t, j, _ = corpus
    got = t.csr_rows_packed(cap=cap, min_df=min_df,
                            align_windows=align_windows)
    want = j.csr_rows_packed(cap=cap, min_df=min_df,
                             align_windows=align_windows)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[2:] == want[2:]


# -- the delta16 row layout ----------------------------------------------------

def test_place_length_groups_matches_jax():
    rng = np.random.RandomState(3)
    lens = np.concatenate([rng.randint(0, 40, 300), [128, 129, 300, 0]])
    for max_seg in (300, 40):
        got = tengine._place_length_groups(lens, 128, max_seg)
        want = jengine._place_length_groups(lens, 128, max_seg)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


@pytest.mark.parametrize("tiny_cap", [0, 3, 64])
def test_nontiny_remap_matches_jax(corpus, tiny_cap):
    df = corpus[1].csr[3]
    got, want = (tengine._nontiny_remap(df, tiny_cap),
                 jengine._nontiny_remap(df, tiny_cap))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == int((df > tiny_cap).sum())


@pytest.mark.parametrize("tiny_cap", [0, 8, 64])
def test_drop_tiny_slots_matches_jax(corpus, tiny_cap):
    _, t, _, _ = corpus
    df = t.csr[3]
    for a, b in zip(tengine._drop_tiny_slots(t.doc_terms, t.doc_impacts, df,
                                             tiny_cap),
                    jengine._drop_tiny_slots(t.doc_terms, t.doc_impacts, df,
                                             tiny_cap)):
        np.testing.assert_array_equal(a, b)


def random_rows(seed, long_doc=0):
    """Packer inputs over a 50k-term space (continuation slots occur)."""
    return synth_delta16_docs(seed, long_doc=long_doc)


def n_continuations(flat, off, lens):
    """Continuation slots (tf = 0) inside the documents' segments."""
    slots = flat.ravel()
    return sum(int(((slots[o:o + n] & 7) == 0).sum())
               for o, n in zip(off.tolist(), lens.tolist()))


def continuation_edge():
    """Gaps right at the 13-bit boundary (a continuation slot and a
    zero-gap real slot), as tests/test_delta16_rows.py builds them."""
    V = 3 * tengine.DELTA16_MAX_GAP
    idf = np.ones(V, np.float32)
    norm = np.ones(1, np.float32)
    remap, _ = tengine._nontiny_remap(np.full(V, 5, np.int64), 0)
    tgt = [0, tengine.DELTA16_MAX_GAP, 2 * tengine.DELTA16_MAX_GAP + 1]
    orig = [int(np.nonzero(remap == x)[0][0]) for x in tgt]
    dt = np.asarray([orig], np.int32)
    di = np.asarray([[0.5] * 3], np.float32)
    return dt, di, remap, idf, norm


@pytest.mark.parametrize("case", ["random", "continuation_edge", "r2"])
def test_pack_doc_rows_delta16_matches_jax(case):
    if case == "continuation_edge":
        args = continuation_edge()
    else:
        args = random_rows(7, long_doc=140 if case == "r2" else 0)[:5]
    got = tengine._pack_doc_rows_delta16(*args)
    want = jengine._pack_doc_rows_delta16(*args)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert got[3] == want[3] == (2 if case == "r2" else 1)
    assert n_continuations(*got[:3]) > 0


# -- host query preparation ----------------------------------------------------

def _engines(corpus, **kw):
    _, t, j, queries = corpus
    te = RetrievalEngine(t, mode="pruned", device="cpu", **kw)
    je = JEngine(j, mode="pruned", use_pallas=True, **kw)
    qt, qw = t.encode_queries(queries)
    return te, je, qt, qw


@pytest.mark.parametrize("config", ["defaults", "bench", "full_rows"])
def test_engine_construction_matches_jax(corpus, config):
    te, je, _, _ = _engines(corpus, **ENGINE_CONFIGS[config])
    for name in ("per_term_cap", "tiny_cap", "df_cap", "n_padded",
                 "_tiny_pack"):
        assert getattr(te, name) == getattr(je, name), name
    flat, off, lens, normc = (x.numpy() for x in te.rows["text"])
    jflat, joff, jlens, jnormc = (np.asarray(x)
                                  for x in je._device_rows["text"])
    np.testing.assert_array_equal(flat.view(np.uint16), jflat)
    np.testing.assert_array_equal(off, joff)
    np.testing.assert_array_equal(lens, jlens)
    np.testing.assert_array_equal(normc, jnormc)
    assert te._row_meta == je._row_meta
    for a, b in zip(te.csr["text"], je._device_csr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert te._csr_scale["text"] == je._csr_scale


@pytest.mark.parametrize("config", ["defaults", "bench", "full_rows"])
def test_rare_terms_and_remapped_queries_match_jax(corpus, config):
    te, je, qt, qw = _engines(corpus, **ENGINE_CONFIGS[config])
    floor = te.tiny_cap if te.compact_rows else 0
    np.testing.assert_array_equal(te._select_rare_terms(qt, df_floor=floor),
                                  je._select_rare_terms(qt, df_floor=floor))
    for a, b in zip(te._remap_queries_d16(qt, qw),
                    je._remap_queries_d16(qt, qw)):
        np.testing.assert_array_equal(a, b)
    assert te._d16_w_floor == je._d16_w_floor


def _tiny_maps(doc, ex):
    return [{int(d): float(x) for d, x in zip(doc[q], ex[q]) if d >= 0}
            for q in range(doc.shape[0])]


@pytest.mark.parametrize("config", ["defaults", "bench"])
def test_gather_tiny_exact_matches_jax(corpus, config):
    """The port's native gather equals kbner_tpu's (float32 sums in
    posting order, docs first-seen); its numpy twin sums in float64 and
    sorts, so it is compared as per-query {doc: sum} maps."""
    te, je, qt, qw = _engines(corpus, **ENGINE_CONFIGS[config])
    got = te._gather_tiny_exact(qt, qw)
    want = je._gather_tiny_exact(qt, qw)
    assert got[0].shape[1] > 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    offsets, p_doc, p_imp, df = te.text_index.csr
    is_tiny = (qt >= 0) & (df[np.maximum(qt, 0)] <= te.tiny_cap)
    twin = tnative.gather_tiny_exact_ref(offsets, p_doc, p_imp, qt, qw,
                                         is_tiny)
    assert twin[0].shape == got[0].shape
    for i in (1, 2):
        for g, w in zip(_tiny_maps(twin[0], twin[i]),
                        _tiny_maps(want[0], want[i])):
            assert g.keys() == w.keys()
            for d in g:
                assert g[d] == pytest.approx(w[d], rel=TINY_RTOL)


def _parse_jax_packed(je, packed, t_cols, lq):
    """kbner_tpu's single upload split back into (rare, tiny, qt2, qw2)."""
    M = je.rare_terms
    rare, pos, tiny = packed[:, :M], M, None
    if t_cols and je._tiny_pack is not None:
        scale = packed[0, pos + t_cols: pos + t_cols + 2].view(np.float32)
        tiny = ("pack", packed[:, pos:pos + t_cols].view(np.uint32),
                float(scale[0]), float(scale[1]))
        pos += t_cols + 2
    elif t_cols and je.tiny_f16:
        u = packed[:, pos + t_cols: pos + t_cols + t_cols // 2].view(
            np.uint32)
        ex = np.stack([u & 0xFFFF, u >> 16], axis=-1).reshape(
            u.shape[0], t_cols).astype(np.uint16).view(np.float16)
        tiny = ("f16", packed[:, pos:pos + t_cols], ex)
        pos += t_cols + t_cols // 2
    elif t_cols:
        tiny = ("f32", packed[:, pos:pos + t_cols],
                -packed[:, pos + t_cols: pos + 2 * t_cols].view(np.float32))
        pos += 2 * t_cols
    return (rare, tiny, packed[:, pos:pos + lq],
            packed[:, pos + lq:pos + 2 * lq].view(np.float32))


@pytest.mark.parametrize("branch", ["native", "numpy"])
@pytest.mark.parametrize("config", ["defaults", "bench", "tiny_pack",
                                    "tiny_f16", "tiny_f32", "tiny_width",
                                    "full_rows"])
def test_query_blocks_and_tiny_encodings_match_jax(corpus, config, branch,
                                                   monkeypatch):
    """The port's query blocks equal the reference's upload, encoding for
    encoding: both tiny gathers native, or both numpy (kbner_tpu's native
    gather off, the port's numpy twin in place of its native one)."""
    if branch == "numpy":
        monkeypatch.setattr(jnative, "gather_tiny_exact",
                            lambda *a, **k: None)
        monkeypatch.setattr(tnative, "gather_tiny_exact",
                            tnative.gather_tiny_exact_ref)
    te, je, qt, qw = _engines(corpus, **ENGINE_CONFIGS[config])
    for _ in range(2):  # the second batch meets the raised width floors
        (rare,), tiny, [(qt2, qw2)] = te._pack_queries(qt, qw)
        packed, lqs, t_cols, _ = je._pack_queries(qt, qw, [])
        want = _parse_jax_packed(je, packed, t_cols, lqs[0])
        np.testing.assert_array_equal(rare, want[0])
        np.testing.assert_array_equal(qt2, want[2])
        np.testing.assert_array_equal(qw2, want[3])
        if want[1] is None:
            assert tiny is None and not te.compact_rows
            continue
        assert tiny[0] == want[1][0]
        if tiny[0] == "pack":
            np.testing.assert_array_equal(tiny[1], want[1][1])
            assert tiny[2:] == want[1][2:]
        else:
            np.testing.assert_array_equal(tiny[1], want[1][1])
            np.testing.assert_array_equal(tiny[2], want[1][2])


# -- pass 1: the key gather ----------------------------------------------------

@pytest.mark.parametrize("aligned", [False, True])
@pytest.mark.parametrize("reencode", [False, True])
def test_gather_pruned_candidate_keys_matches_jax(corpus, aligned, reencode):
    _, t, _, _ = corpus
    cap = 170
    off32, packed, lo, step = t.csr_rows_packed(
        cap=cap, min_df=3, align_windows=aligned)
    rng = np.random.RandomState(int(aligned) + 2 * int(reencode))
    rare = rng.randint(0, len(t.vocab), size=(6, 9)).astype(np.int32)
    rare[rng.rand(6, 9) < 0.3] = -1
    kw = dict(reencode=reencode, lo_src=lo, step_src=step, lo_dst=lo - 0.3,
              step_dst=step + np.log(64.0) / 254.0, aligned=aligned)
    got = tbm25.gather_pruned_candidate_keys(
        torch.from_numpy(rare), torch.from_numpy(off32),
        torch.from_numpy(packed), cap, **kw)
    want = jbm25.gather_pruned_candidate_keys(
        jnp.asarray(rare), jnp.asarray(off32), jnp.asarray(packed), cap,
        **kw)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    assert (got.numpy() != tbm25.KEY_PAD).sum() > 50


# -- K2's plain twin -------------------------------------------------------------

def k2_operands(seed, Q, C, long_doc=0):
    """Delta16 rows from the port's packer (continuation slots included),
    candidates with invalid ones at id 0, query terms from the candidates'
    own terms with -1 pads."""
    ops = synth_rescore_operands(seed, Q, C, long_doc=long_doc)
    assert n_continuations(*ops[3:6]) > 0
    return ops


def _k2_port(ops):
    qt, qw, cand, flat, off, lens, nc, k1, b, avgdl, r2 = ops
    t = [torch.from_numpy(x) for x in (qt, qw, cand, flat.view(np.int16),
                                        off, lens, nc)]
    return tbm25.delta16_rescore_ref(*t, k1, b, avgdl, r2).numpy()


def _k2_jax(ops, use_pallas):
    qt, qw, cand, flat, off, lens, nc, k1, b, avgdl, r2 = ops
    field = (jnp.asarray(qt), jnp.asarray(qw), jnp.asarray(flat),
             jnp.asarray(off), jnp.asarray(lens), jnp.asarray(nc), k1, b,
             avgdl)
    return np.asarray(jbm25._rescore_candidates(
        jnp.asarray(cand), (field,), (r2,), use_pallas))


def test_delta16_rescore_ref_matches_pallas():
    """R2 = 1, Q % 8 == 0, C % 128 == 0: the shapes on which kbner_tpu's
    rescore takes the Pallas kernel (interpret mode here)."""
    ops = k2_operands(11, 8, 128)
    assert ops[-1] == 1
    got = _k2_port(ops)
    assert (got > 0).mean() > 0.1
    np.testing.assert_allclose(got, _k2_jax(ops, True), rtol=K2_RTOL,
                               atol=K2_ATOL)


@pytest.mark.parametrize("Q,C,long_doc", [(5, 300, 0), (8, 128, 140),
                                          (3, 77, 140), (1, 1, 0)])
def test_delta16_rescore_ref_matches_xla(Q, C, long_doc):
    ops = k2_operands(Q + C, Q, C, long_doc=long_doc)
    assert ops[-1] == (2 if long_doc else 1)
    got = _k2_port(ops)
    np.testing.assert_allclose(got, _k2_jax(ops, False), rtol=K2_RTOL,
                               atol=K2_ATOL)
    if long_doc:  # the two-row segment scores
        assert (got[:, ::3] > 0).any()


@pytest.mark.parametrize("kind", K2_KINDS)
def test_delta16_rescore_ref_matches_xla_on_kernel_traps(kind):
    """The K2 kernel's trap operands (ids on one hash slot, repeated
    terms, W = 256 and 6144, segments at odd offsets over three rows, gaps
    at the 13-bit field's top) at ragged shapes: kbner_tpu takes the XLA
    form of the rescore there."""
    Q, C = (2, 64) if kind == "max_terms" else (5, 300)
    ops = synth_k2_operands(Q + C, Q, C, kind)
    assert ops[-1] == (3 if kind == "unaligned" else 1)
    got = _k2_port(ops)
    assert (got > 0).mean() > 0.05
    np.testing.assert_allclose(got, _k2_jax(ops, False), rtol=K2_RTOL,
                               atol=K2_ATOL)


@pytest.mark.parametrize("kind", ["collide", "repeat", "max_gap"])
def test_delta16_rescore_ref_matches_pallas_on_kernel_traps(kind):
    """The same traps at Q = 8, C = 128, where kbner_tpu takes the Pallas
    kernel (interpret mode here)."""
    ops = synth_k2_operands(17, 8, 128, kind)
    assert ops[-1] == 1
    np.testing.assert_allclose(_k2_port(ops), _k2_jax(ops, True),
                               rtol=K2_RTOL, atol=K2_ATOL)


def test_delta16_norm_decodes_lucene_codes():
    dl = np.arange(0, 5000, 7)
    code = np.asarray([long_to_int4(int(x)) for x in dl], np.uint8)
    got = tbm25._delta16_norm(torch.from_numpy(code), 1.2, 0.75, 20.0)
    dlq = np.asarray([int4_to_long(int(c)) for c in code], np.float32)
    want = np.float32(1.2) * (np.float32(0.25)
                              + np.float32(0.75) * dlq / np.float32(20.0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-7)


# -- the pruned top-k ------------------------------------------------------------

@pytest.mark.parametrize("config", ["defaults", "bench", "full_rows"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_bm25_pruned_topk_packed_matches_jax(corpus, config, use_pallas):
    """Identical keys, rows and tiny block in, the same top-k out: ids
    equal (both take the lower position first among ties) and scores
    within float32 reordering."""
    te, _, qt, qw = _engines(corpus, **ENGINE_CONFIGS[config])
    keys, (field,), (t_doc, t_ex), kw = te._device_queries(
        te._pack_queries(qt, qw))
    kw["n_real_docs"] = te.text_index.n_docs
    ts, ti = tbm25.bm25_pruned_topk_packed(keys, (field,), k=10,
                                           tiny_doc=t_doc, tiny_ex=t_ex, **kw)
    qt2, qw2, flat, off, lens, nc = (x.numpy() for x in field[:6])
    jfield = (jnp.asarray(qt2), jnp.asarray(qw2),
              jnp.asarray(flat.view(np.uint16)), jnp.asarray(off),
              jnp.asarray(lens), jnp.asarray(nc), *field[6:])
    js, ji = jbm25.bm25_pruned_topk_packed(
        jnp.asarray(keys.numpy().astype(np.uint32)), (jfield,), k=10,
        tiny_doc=None if t_doc is None else jnp.asarray(
            t_doc.numpy().astype(np.int32)),
        tiny_ex=None if t_ex is None else jnp.asarray(t_ex.numpy()),
        use_pallas=use_pallas, **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)
    assert (ti.numpy() >= 0).all()


def test_pruned_topk_takes_lower_positions_first_among_ties():
    """Every candidate ties: the top C and the top k are the lowest doc
    ids, as lax.top_k orders them."""
    keys = torch.tensor([[(d << 8) | 5 for d in (9, 3, 7, 1, 5)]
                         + [tbm25.KEY_PAD]], dtype=torch.int64)
    Q = 1
    flat = torch.zeros((2, 128), dtype=torch.int16)
    field = (torch.full((Q, 1), -1, dtype=torch.int32),
             torch.zeros((Q, 1)), flat, torch.zeros(10, dtype=torch.int32),
             torch.zeros(10, dtype=torch.int32),
             torch.zeros(10, dtype=torch.uint8), 1.2, 0.75, 10.0)
    tiny_doc = torch.tensor([[1, 3, 5, 7, 9]])
    tiny_ex = torch.full((1, 5), 2.0)
    s, i = tbm25.bm25_pruned_topk_packed(
        keys, (field,), n_real_docs=8, k=3, n_candidates=4,
        tiny_doc=tiny_doc, tiny_ex=tiny_ex, ragged_rows=(1,))
    assert i.tolist() == [[1, 3, 5]] and s.tolist() == [[2.0, 2.0, 2.0]]
    s, i = tbm25.bm25_pruned_topk_packed(
        keys, (field,), n_real_docs=4, k=3, n_candidates=4,
        tiny_doc=tiny_doc, tiny_ex=tiny_ex, ragged_rows=(1,))
    assert i.tolist() == [[1, 3, -1]]  # doc 5 and 7 are padding docs


def test_pass2_operands_are_what_the_search_rescores(corpus, monkeypatch):
    """The K2 arguments ``pass2_operands`` gives for a batch are the ones
    the engine's search hands ``delta16_rescore``."""
    _, t, _, queries = corpus
    te = RetrievalEngine(t, mode="pruned", device="cpu", **BENCH_KNOBS)
    qt, qw = t.encode_queries(queries)
    served = []
    rescore = tbm25.delta16_rescore
    monkeypatch.setattr(tbm25, "delta16_rescore",
                        lambda *a: served.append(a) or rescore(*a))
    te.search_encoded(qt, qw, k=10)
    keys, fields, _, kw = te._device_queries(te._pack_queries(qt, qw))
    _, valid, ops = tbm25.pass2_operands(keys, fields, **kw)
    assert len(served) == len(ops) == 1 and valid.any()
    fn, args = ops[0]
    assert fn is tbm25.delta16_rescore
    for got, want in zip(served[0], args):
        if isinstance(want, torch.Tensor):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        else:
            assert got == want


# -- the engine ------------------------------------------------------------------

@pytest.mark.parametrize("config", sorted(ENGINE_CONFIGS))
def test_pruned_engine_matches_jax(corpus, config):
    te, je, qt, qw = _engines(corpus, **ENGINE_CONFIGS[config])
    for _ in range(2):
        ts, ti = te.search_encoded(qt, qw, k=10)
        js, ji = je.search_encoded(qt, qw, k=10)
        assert ti.shape == (16, 10) and (ti >= 0).all()
        assert_same_topk(ts, ti, js, ji)
    es, ei = te.search_encoded(qt[:0], qw[:0], k=10)  # an empty batch
    assert es.shape == ei.shape == (0, 10)


DEEP_KNOBS = dict(rare_terms=8, posting_budget=256, n_candidates=128)


@pytest.mark.parametrize("compact_rows", [True, False])
def test_deep_windows_match_jax(corpus, compact_rows):
    """deep_terms=4, deep_cap=1024 over windows of 32 postings: the text
    CSR kept at deep_cap, the deep key block first in pass 1, and top-k
    ids equal to the reference's within ties, from search_encoded and
    from search_stream; recall against exhaustive no lower than without
    deep windows (tests/test_pruned_retrieval.py's deep-window test)."""
    _, t, j, queries = corpus
    kw = dict(DEEP_KNOBS, deep_terms=4, deep_cap=1024,
              compact_rows=compact_rows)
    te = RetrievalEngine(t, mode="pruned", device="cpu", **kw)
    je = JEngine(j, mode="pruned", use_pallas=True, **kw)
    assert te.per_term_cap == je.per_term_cap == 32
    assert te.deep_cap == je.deep_cap == 1024
    for a, b in zip(te.csr["text"], je._device_csr):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    qt, qw = t.encode_queries(queries)
    keys, _, _, _ = te._device_queries(te._pack_queries(qt, qw))
    rare = te._pack_queries(qt, qw)[0][0]
    deep = tbm25.gather_pruned_candidate_keys(
        torch.from_numpy(rare[:, :4]), *te.csr["text"], 1024,
        reencode=True, lo_src=te._csr_scale["text"][0],
        step_src=te._csr_scale["text"][1], lo_dst=te._csr_scale["text"][0],
        step_dst=te._csr_scale["text"][1] + float(np.log(64.0)) / 254.0,
        aligned=True)
    torch.testing.assert_close(keys[:, :deep.shape[1]], deep, rtol=0,
                               atol=0)
    ts, ti = te.search_encoded(qt, qw, k=10)
    js, ji = je.search_encoded(qt, qw, k=10)
    assert_same_topk(ts, ti, js, ji)
    (ss, si), = list(te.search_stream([(qt, qw)], k=10))
    np.testing.assert_array_equal(ss, ts)
    np.testing.assert_array_equal(si, ti)

    exact = RetrievalEngine(t, device="cpu").search(queries, k=10)
    shallow = RetrievalEngine(t, mode="pruned", device="cpu",
                              compact_rows=compact_rows, **DEEP_KNOBS)

    def recall(engine):
        return np.mean([
            len({d.doc_id for d in a} & {d.doc_id for d in b}) / len(a)
            for a, b in zip(exact, engine.search(queries, k=10))])

    assert recall(te) >= recall(shallow)


def test_deep_windows_validation():
    """tests/test_pruned_retrieval.py's deep-window refusals."""
    index = BM25Index.build(zipf_corpus(n_docs=100, vocab=200, seed=9),
                            params=BM25Params(quantize_norms=False),
                            pad_docs_to=64)
    with pytest.raises(ValueError, match="deep_terms"):
        RetrievalEngine(index, mode="pruned", rare_terms=8, deep_terms=12,
                        deep_cap=512, device="cpu")
    with pytest.raises(ValueError, match="unsharded"):
        RetrievalEngine(index, mode="exhaustive", deep_terms=2,
                        deep_cap=512, device="cpu")


@pytest.mark.parametrize("compact_rows,rel", [(False, 1e-4), (True, 5e-4)])
def test_pruned_recall_against_exhaustive(corpus, compact_rows, rel):
    """The bars of tests/test_pruned_retrieval.py: recall@10 >= 0.99 of
    the exhaustive top-10, equal scores where both find a doc."""
    docs, t, _, queries = corpus
    exact = RetrievalEngine(t, device="cpu").search(queries, k=10)
    pruned = RetrievalEngine(t, mode="pruned", device="cpu", rare_terms=12,
                             posting_budget=4096, n_candidates=128,
                             compact_rows=compact_rows).search(queries, k=10)
    recalls = []
    for a, b in zip(exact, pruned):
        want = {d.doc_id for d in a}
        recalls.append(len(want & {d.doc_id for d in b}) / len(want))
        by_id = {d.doc_id: d.score for d in a}
        for d in b:
            if d.doc_id in by_id:
                assert d.score == pytest.approx(by_id[d.doc_id], rel=rel)
    assert np.mean(recalls) >= 0.99, np.mean(recalls)


KB_ROWS = [
    ("Berlin", "Berlin is the capital and largest city of Germany ."),
    ("Paris", "Paris is the capital of France ."),
    ("Germany", "Germany is a large country in Central Europe ."),
    ("City", "A city is a large human settlement where many people live ."),
    ("Union", "A union is an organization of workers ."),
    ("Acme", "Acme hired engineers in Paris and Berlin last year ."),
]
REQUESTS = [{"id": 0, "tokens": ["Berlin", "is", "a", "city"]},
            {"id": 1, "text": "Paris in France"},
            {"id": 2, "tokens": ["workers", "union", "of", "Germany"]},
            {"id": 3, "tokens": ["zzz"]}]


@pytest.fixture(scope="module")
def kb_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("kb") / "kb.jsonl"
    with open(path, "w", encoding="utf-8") as f:
        for i, (title, sentence) in enumerate(KB_ROWS):
            f.write(json.dumps({"title": title, "sentence": sentence,
                                "paragraph": sentence,
                                "url": f"https://example.org/{i}"}) + "\n")
    return path


def test_search_fused_records_match_jax(corpus):
    docs, t, j, queries = corpus
    te = RetrievalEngine(t, store=DocStore(docs), mode="pruned",
                         device="cpu", **BENCH_KNOBS)
    je = JEngine(j, store=jengine.DocStore(docs), mode="pruned",
                 use_pallas=True, **BENCH_KNOBS)
    recs = [request_record({"tokens": q.split()}) for q in queries]
    got = te.search([" ".join(r.tokens) for r in recs], k=5)
    assert all(got)
    fused = fuse_contexts(recs, got, HashTokenizer(997))
    j_recs = [JRecord(tokens=r.tokens, tags=r.tags) for r in recs]
    j_fused = j_fuse(j_recs, je.search(queries, k=5), JTokenizer(997))
    assert [r.tokens for r in fused] == [r.tokens for r in j_fused]
    assert [r.tags for r in fused] == [r.tags for r in j_fused]


def test_cli_serve_pruned_answers(kb_path, tmp_path, capsys, monkeypatch):
    tags = make_tag_dictionary([["S-PER", "S-LOC", "B-ORG", "E-ORG"]])
    target = tmp_path / "run"
    tags.save(target / "tag_dictionary.json")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "name": "toy", "tag_layer": "ner",
        "tokenizer": {"type": "hash", "vocab_size": 997},
        "model": {"encoder": "tiny", "use_crf": True},
        "target_dir": str(target)}))
    monkeypatch.setattr("sys.stdin", io.StringIO(
        "\n".join(json.dumps(r) for r in REQUESTS) + "\n"))
    built = []
    monkeypatch.setattr(cli, "RetrievalEngine",
                        lambda *a, **kw: built.append(
                            RetrievalEngine(*a, **kw)) or built[-1])
    cli.main(["serve", "--config", str(cfg), "--kb", str(kb_path),
              "--engine_mode", "pruned", "--device", "cpu", "--k", "3"])
    out = [json.loads(line)
           for line in capsys.readouterr().out.strip().splitlines()]
    # the served engine holds the title field, as the reference's serve
    # builds it (kbner_tpu/cli.py _open_kb)
    (served,) = built
    assert served.mode == "pruned" and served.title_index is not None
    assert set(served.rows) == {"text", "title"}

    tagger = SequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=997), tags), device="cpu").eval()
    text, store, _ = build_kb_from_jsonl(kb_path, with_title_index=False)
    engine = RetrievalEngine(text, store=store, mode="pruned", device="cpu")
    assert engine.search(["Berlin is a city"], k=3)[0]
    want = serve(REQUESTS, engine, tagger, HashTokenizer(997), tags, k=3)
    assert out == json.loads(json.dumps(want))
    assert [r["id"] for r in out] == [0, 1, 2, 3]
    assert out[1]["tokens"] == ["Paris", "in", "France"]
