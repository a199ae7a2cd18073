"""The PyTorch port's device mesh and the host side of its sharded engine
against kbner_tpu's: ``parallel.mesh`` in spawned gloo worlds (the JAX side
on conftest's 8 CPU devices), the per-shard host arrays of a meshed
engine without a world, and the pass-1 approximate top-C
(``approx_topk_reduction_size`` against XLA's own formula, ``approx_max_k``
against ``lax.top_k`` and its recall target).
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax._src.lib import _jax
from jax.sharding import NamedSharding, PartitionSpec

from kbner_tpu.parallel import make_mesh as j_make_mesh
from kbner_tpu.parallel import pad_batch_for_mesh as j_pad
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import BM25Params as JParams
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu_torch.ops.bm25 import (_top_sorted, approx_max_k,
                                      approx_topk_reduction_size)
from kbner_tpu_torch.parallel import make_mesh
from kbner_tpu_torch.retrieval import engine as tengine
from kbner_tpu_torch.retrieval.index import BM25Index, BM25Params

import torch_world
from torch_world import World, zipf_corpus

SHAPES = ((4, 1), (2, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(0)
    return {"input_ids": rng.randint(0, 100, (6, 5)).astype(np.int32),
            "mask": rng.rand(6, 5) > 0.5,
            "weights": rng.rand(6).astype(np.float32)}


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """One spawned world of 4 gloo ranks: meshes 4x1 and 2x2."""
    return World(torch_world.mesh_rank, 4, tmp_path_factory.mktemp("mesh"),
                 _batch(), SHAPES).join()


@pytest.fixture
def world_of_one(tmp_path):
    """An in-process gloo world of one rank, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def _jax_mesh(data, model):
    return j_make_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])


# -- parallel.mesh ---------------------------------------------------------------

@pytest.mark.parametrize("data,model", SHAPES)
def test_pad_batch_for_mesh_equals_the_reference(mesh_world, data, model):
    want = j_pad(_batch(), _jax_mesh(data, model))
    for ranks in mesh_world:
        for k, v in want.items():
            got = ranks[f"{data}x{model}/pad/{k}"]
            np.testing.assert_array_equal(got, v)
            assert got.dtype == v.dtype


@pytest.mark.parametrize("data,model", SHAPES)
def test_shard_batch_gives_each_rank_the_reference_shard(mesh_world, data,
                                                         model):
    """Rank r sits at mesh coordinate (r // model, r % model), as device r
    of the reference's ``devices.reshape(data, model)``; its local rows
    (``shard_batch``'s DTensor, and ``local_rows`` cut on the host) are the
    JAX sharding's shard on that device."""
    jmesh = _jax_mesh(data, model)
    padded = j_pad(_batch(), jmesh)
    sharding = NamedSharding(jmesh, PartitionSpec("data"))
    for r, ranks in enumerate(mesh_world):
        coord = tuple(ranks[f"{data}x{model}/coord"])
        assert coord == (r // model, r % model)
        device = jmesh.devices[coord]
        for k, v in padded.items():
            index = sharding.devices_indices_map(v.shape)[device]
            np.testing.assert_array_equal(
                ranks[f"{data}x{model}/local/{k}"], v[index])
            np.testing.assert_array_equal(
                ranks[f"{data}x{model}/rows/{k}"], v[index])


def test_make_mesh_refuses_a_mesh_that_is_not_the_world(mesh_world,
                                                        world_of_one):
    for ranks in mesh_world:
        assert str(ranks["mismatch"]) == "mesh 5x1 != 4 devices"
    with pytest.raises(ValueError, match=r"mesh 2x1 != 1 devices"):
        make_mesh(data=2, model=1, device_type="cpu")
    mesh = make_mesh(device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)


# -- the per-shard host arrays ------------------------------------------------------

@pytest.fixture(scope="module", params=[400, 1500], ids=["400docs",
                                                         "1500docs"])
def indices(request):
    """Both packages' text and title indices of a Zipf corpus of
    tests/test_pruned_retrieval.py's shape (12 words, vocabulary 300; the
    400 docs sit in shard 0 at every S, 1500 fill two shards)."""
    docs = zipf_corpus(n_docs=request.param, vocab=300)
    titles = torch_world.titles_of(docs)
    return (BM25Index.build(docs, params=BM25Params(quantize_norms=True),
                            pad_docs_to=64),
            BM25Index.build(titles, params=BM25Params(quantize_norms=False),
                            pad_docs_to=64),
            JIndex.build(docs, params=JParams(quantize_norms=True),
                         pad_docs_to=64),
            JIndex.build(titles, params=JParams(quantize_norms=False),
                         pad_docs_to=64))


KNOBS = dict(mode="pruned", rare_terms=8, posting_budget=2048,
             n_candidates=256)


def _jax_engine(indices, S, **kw):
    _, _, j, jt = indices
    return JEngine(j, title_index=jt, mesh=_jax_mesh(S, 1), use_pallas=False,
                   **KNOBS, **kw)


def _padded(index, n_padded):
    n = index.doc_terms.shape[0]
    return (np.pad(index.doc_terms, ((0, n_padded - n), (0, 0)),
                   constant_values=-1),
            np.pad(index.doc_impacts, ((0, n_padded - n), (0, 0))))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("tiny_df_cap", [8, 64])
def test_shard_rows_delta16_equal_the_reference(indices, S, tiny_df_cap):
    t = indices[0]
    je = _jax_engine(indices, S, tiny_df_cap=tiny_df_cap,
                     row_layout="delta16")
    ss = je._shard_size
    dt, di = _padded(t, S * ss)
    df = t.csr[3]
    dt, di = tengine._drop_tiny_slots(dt, di, df, je.tiny_cap)
    remap, _ = tengine._nontiny_remap(df, je.tiny_cap)
    p = t.params
    dl = np.zeros(S * ss, np.int64)
    dl[:len(t.doc_dl)] = t.doc_dl
    norm = (p.k1 * (1.0 - p.b + p.b * dl / t.avgdl)).astype(np.float32)
    flat, off, lens, r2 = tengine.shard_rows_delta16(dt, di, remap, t.idf,
                                                     norm, S, ss)
    jflat, joff, jlens, _ = je._device_rows["text"]
    for a, b in ((flat, jflat), (off, joff), (lens, jlens)):
        _same(a, b)
    assert r2 == je._row_meta["text"][4]
    # one shard at a time: the same slice of the stacked arrays
    for s in range(S):
        one = tengine.shard_rows_delta16(dt, di, remap, t.idf, norm, S, ss,
                                         shards=[s])
        for a, b in zip(one[:3], (flat, off, lens)):
            _same(a[0], b[s])


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("field", ["text", "title"])
def test_shard_rows_packed32_equal_the_reference(indices, S, field):
    t, title = indices[:2]
    je = _jax_engine(indices, S, tiny_df_cap=8, row_layout="packed32")
    ss = je._shard_size
    idx = t if field == "text" else title
    dt, di = _padded(idx, S * ss)
    if field == "text":
        dt, di = tengine._drop_tiny_slots(dt, di, idx.csr[3], je.tiny_cap)
    code_bits = 32 - max(int(np.ceil(np.log2(len(idx.vocab) + 2))), 1)
    term_lo, step = tengine._term_scale_from_csr(idx, code_bits)
    flat, off, lens, tb, step_out, r2 = tengine.shard_rows_packed32(
        dt, di, len(idx.vocab), (term_lo, step), S, ss)
    for a, b in zip((flat, off, lens), je._device_rows[field]):
        _same(a, b)
    assert ("p32", tb, 0.0, step_out, r2) == je._row_meta[field]


@pytest.mark.parametrize("S", [2, 4, 8])
@pytest.mark.parametrize("field", ["text", "title"])
def test_shard_csr_equals_the_reference(indices, S, field):
    t, title = indices[:2]
    je = _jax_engine(indices, S, tiny_df_cap=8)
    ss = je._shard_size
    idx = t if field == "text" else title
    dt, di = _padded(idx, S * ss)
    off, packed, lo, step = tengine.shard_csr(
        dt, di, len(idx.vocab), je.per_term_cap, S, ss,
        gdf=idx.csr[3] if field == "text" else None, tiny_cap=je.tiny_cap)
    want = je._device_csr if field == "text" else je._device_csr_title
    _same(off, want[0])
    _same(packed, want[1])
    assert (lo, step) == (je._csr_scale if field == "text"
                          else je._csr_scale_title)
    if S > 1:
        one = tengine.shard_csr(dt, di, len(idx.vocab), je.per_term_cap, S,
                                ss, gdf=idx.csr[3] if field == "text"
                                else None, tiny_cap=je.tiny_cap, shards=[1])
        _same(one[0][0], off[1])
        _same(one[1][0], packed[1])


@pytest.mark.parametrize("S", [2, 4, 8])
def test_slice_tiny_per_shard_equals_the_reference(indices, S):
    t = indices[0]
    je = _jax_engine(indices, S, tiny_df_cap=8)
    docs = zipf_corpus(n_docs=t.n_docs, vocab=300)
    qt, qw = t.encode_queries(torch_world.query_texts(docs, 16, 3)[0])
    t_doc, _, t_ex = je._gather_tiny_exact(qt, qw)
    block, Tb = tengine.slice_tiny_per_shard(t_doc, t_ex, S, je._shard_size)
    jblock, jTb = je._slice_tiny_per_shard(t_doc, t_ex)
    assert Tb == jTb
    _same(block, jblock)
    empty = tengine.slice_tiny_per_shard(t_doc[:, :0], t_ex[:, :0], S,
                                         je._shard_size)
    assert empty == (None, 0)


# -- the pass-1 approximate top-C ---------------------------------------------------

SIZES = sorted({256, 257, 1000, 1024, 1025, 2048, 2049, 6144, 6145, 100000,
                131072, 262143, 262144}
               | set(np.random.RandomState(0).randint(256, 262145, 40)
                     .tolist()))
KS = sorted({1, 2, 3, 16, 63, 64, 100, 128, 255, 256, 512, 1000, 1023, 1024}
            | set(np.random.RandomState(1).randint(1, 1025, 16).tolist()))
TARGETS = [round(0.8 + 0.01 * i, 2) for i in range(20)]


@pytest.mark.parametrize("target", TARGETS)
def test_approx_topk_reduction_size_equals_xla(target):
    for rank in (1, 2):
        for n in SIZES:
            for k in KS:
                want = tuple(_jax.approx_top_k_reduction_output_size(
                    n, rank, k, target, False))
                assert approx_topk_reduction_size(n, k, target, rank) == \
                    want, (n, k, target, rank)


def test_xla_reduces_only_below_the_serve_knobs():
    """XLA's formula at the serve knobs: P = 6,144 pass-1 keys, C =
    1,024 reduce at no target; C = 64 does."""
    for r in (0.9, 0.95):
        assert approx_topk_reduction_size(6144, 1024, r) == (6144, 0)
    assert approx_topk_reduction_size(6144, 64, 0.9) == (768, 3)
    assert approx_topk_reduction_size(6144, 64, 0.95) == (1536, 2)


@pytest.mark.parametrize("P,k,target", [(6144, 1024, 0.95), (6144, 1024, 0.9),
                                        (100, 10, 0.9), (5000, 1000, 0.99),
                                        (128, 1, 0.8)])
def test_approx_max_k_is_lax_top_k_where_it_does_not_reduce(P, k, target):
    assert approx_topk_reduction_size(P, k, target)[1] == 0
    rng = np.random.RandomState(P + k)
    # repeated values and -inf, as the pass-1 partials have
    x = np.round(rng.randn(4, P), 1).astype(np.float32)
    x[rng.rand(4, P) < 0.3] = -np.inf
    vals, pos = approx_max_k(torch.from_numpy(x), k, target)
    jv, jp = jax.lax.top_k(x, k)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jp))
    jv, jp = jax.lax.approx_max_k(x, k, recall_target=target)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("target", [0.9, 0.95])
def test_approx_max_k_meets_its_recall_target_where_it_reduces(target):
    """Over 20 seeded [8, 6144] inputs at k = 64 the mean recall of the
    exact top-k is at least the target; each returned value is the
    element at its position, and it is its bin's maximum (positions i
    and j share a bin when i = j mod reduced_size)."""
    reduced, log2 = approx_topk_reduction_size(6144, 64, target)
    assert log2 > 0
    recalls = []
    for seed in range(20):
        x = torch.from_numpy(
            np.random.RandomState(seed).randn(8, 6144).astype(np.float32))
        vals, pos = approx_max_k(x, 64, target)
        _, exact = _top_sorted(x, 64)
        assert torch.equal(torch.gather(x, 1, pos), vals)
        assert bool((vals[:, 1:] <= vals[:, :-1]).all())
        bins = torch.nn.functional.pad(
            x, (0, reduced * (1 << log2) - 6144), value=float("-inf")
        ).reshape(8, 1 << log2, reduced).amax(dim=1)
        assert torch.equal(torch.gather(bins, 1, pos % reduced), vals)
        recalls += [len(set(pos[q].tolist()) & set(exact[q].tolist())) / 64
                     for q in range(8)]
    assert np.mean(recalls) >= target, np.mean(recalls)
