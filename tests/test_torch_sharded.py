"""The PyTorch port's meshed retrieval engine against kbner_tpu's: each
rank of a spawned gloo world (S = 2 and 4 data shards, and a (data=2,
model=2) world) builds the engines over the same corpus, searches its shard
and merges every shard's top k; the JAX side runs its meshed engine on
conftest's 8 CPU devices (``use_pallas=False``) while the worlds run.

Scores are float32 sums in another order, so they are held to ``rtol=1e-5``
(pruned: ``atol=1e-5`` too, as tests/test_delta16_rows.py holds them) and
ids are equal except among tied scores (``torch.topk`` orders ties as it
likes).
"""

import datetime

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from kbner_tpu.parallel import make_mesh as j_make_mesh
from kbner_tpu.retrieval import BM25Index as JIndex
from kbner_tpu.retrieval import BM25Params as JParams
from kbner_tpu.retrieval import RetrievalEngine as JEngine
from kbner_tpu.retrieval.engine import MixEngine as JMixEngine
from kbner_tpu_torch.ops.bm25 import approx_topk_reduction_size
from kbner_tpu_torch.parallel import make_mesh
from kbner_tpu_torch.retrieval.engine import MixEngine, RetrievalEngine

import torch_world
from torch_world import World, port_indices, query_texts, zipf_corpus

RTOL, ATOL = 1e-5, 1e-5
K = 10
N_QUERIES, SEED = 16, 1
KNOBS = dict(mode="pruned", rare_terms=8, posting_budget=2048,
             n_candidates=256)
CONFIGS = {
    "exhaustive": {},
    "d16": dict(KNOBS),
    "d16_tiny8": dict(KNOBS, tiny_df_cap=8),
    "p32": dict(KNOBS, row_layout="packed32"),
    "p32_tiny8": dict(KNOBS, row_layout="packed32", tiny_df_cap=8),
    "full_rows": dict(KNOBS, compact_rows=False),
    # XLA's formula does not reduce at C = 1,024 (approx_max_k is exact)
    "topc_c1024": dict(KNOBS, n_candidates=1024, topc_recall=0.95),
}
# which configs each world runs, and which of them the JAX side holds
# (each JAX meshed pruned engine compiles for ~2-4 s on the CPU)
WORLD_CONFIGS = {
    2: ("exhaustive", "d16_tiny8", "p32", "full_rows", "topc_c1024"),
    4: ("exhaustive", "d16", "p32_tiny8"),
    "2x2": ("exhaustive", "d16_tiny8", "p32"),
}
# where the approximation must show: C = 64 at recall 0.9
TOPC = dict(rare_terms=8, posting_budget=2048, n_candidates=64,
            tiny_df_cap=8, recalls=(0.0, 0.9))
STREAM = "d16_tiny8"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _queries(index, title_index):
    docs = zipf_corpus()
    queries, ents = query_texts(docs, N_QUERIES, SEED)
    qt, qw = index.encode_queries(queries)
    tt, tw = title_index.encode_queries([" ".join(e) for e in ents],
                                        boosts=[2.0] * len(ents))
    return qt, qw, tt, tw


def _jax_results(S, names):
    docs = zipf_corpus()
    j = JIndex.build(docs, params=JParams(quantize_norms=True),
                     pad_docs_to=64)
    jt = JIndex.build(torch_world.titles_of(docs),
                      params=JParams(quantize_norms=False), pad_docs_to=64)
    qt, qw, tt, tw = _queries(j, jt)
    mesh = j_make_mesh(data=S, model=1, devices=jax.devices()[:S])
    out = {}
    for name in names:
        eng = JEngine(j, title_index=jt, mesh=mesh, use_pallas=False,
                      **CONFIGS[name])
        out[name] = {"plain": eng.search_encoded(qt, qw, k=K)}
        if not name.startswith("topc"):
            out[name]["entities"] = eng.search_encoded(
                qt, qw, k=K, title_terms=tt, title_weights=tw)
        out[name]["engine"] = eng
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The three worlds' per-rank arrays, and the JAX meshed engines'
    results at S = 2 and 4 (computed while the worlds run)."""
    started = {}
    for key, names in WORLD_CONFIGS.items():
        data, model = (2, 2) if key == "2x2" else (key, 1)
        started[key] = World(
            torch_world.engine_rank, data * model,
            tmp_path_factory.mktemp(f"world{key}"), data, model,
            {n: CONFIGS[n] for n in names}, N_QUERIES, SEED,
            STREAM if key == 2 else "", TOPC if key == 2 else {})
    jax_side = {S: _jax_results(S, WORLD_CONFIGS[S]) for S in (2, 4)}
    return {key: w.join() for key, w in started.items()}, jax_side


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded engines' results over the same corpus."""
    text, title = port_indices(zipf_corpus())
    qt, qw, tt, tw = _queries(text, title)
    out = {}
    for name, kw in CONFIGS.items():
        eng = RetrievalEngine(text, title_index=title, device="cpu", **kw)
        out[name] = {"plain": eng.search_encoded(qt, qw, k=K)}
        if not name.startswith("topc"):
            out[name]["entities"] = eng.search_encoded(
                qt, qw, k=K, title_terms=tt, title_weights=tw)
    return out


def _got(ranks, name, kind):
    p = "" if kind == "plain" else "t"
    return [(r[f"{name}/{p}s"], r[f"{name}/{p}i"]) for r in ranks]


def assert_same_topk(ts, ti, js, ji, rtol=RTOL, atol=ATOL):
    """Equal scores rank by rank; ids equal except where they swap among
    tied scores (a tie at the k-th score may bring in either document)."""
    np.testing.assert_allclose(ts, js, rtol=rtol, atol=atol)
    for q in range(ts.shape[0]):
        last = np.isclose(js[q], js[q][-1], rtol=rtol, atol=atol)
        for r in np.nonzero(ti[q] != ji[q])[0]:
            if last[r]:
                continue
            tied = np.isclose(ts[q], ts[q, r], rtol=rtol, atol=atol)
            assert set(ti[q][tied]) == set(ji[q][tied]), (q, r)


def assert_same_sets(ts, ti, js, ji, rtol=RTOL):
    """The reference's own hold of a sharded pruned engine against the
    unsharded one (tests/test_pruned_retrieval.py): the same docs, the
    same sorted scores."""
    for q in range(ts.shape[0]):
        a, b = ti[q] >= 0, ji[q] >= 0
        assert set(ti[q][a]) == set(ji[q][b]), q
        np.testing.assert_allclose(np.sort(ts[q][a]), np.sort(js[q][b]),
                                   rtol=rtol)


def _cases(kinds=("plain", "entities")):
    return [pytest.param(S, name, kind, id=f"S{S}-{name}-{kind}")
            for S in (2, 4) for name in WORLD_CONFIGS[S]
            for kind in kinds
            if not (name.startswith("topc") and kind == "entities")]


# -- against kbner_tpu's meshed engine ------------------------------------------

@pytest.mark.parametrize("S,name,kind", _cases())
def test_meshed_engine_equals_the_reference(worlds, S, name, kind):
    ranks, jax_side = worlds
    js, ji = jax_side[S][name][kind]
    for ts, ti in _got(ranks[S], name, kind):
        assert ti.shape == (N_QUERIES, K)
        assert_same_topk(ts, ti, np.asarray(js), np.asarray(ji))


@pytest.mark.parametrize("S,name", [
    pytest.param(S, n, id=f"S{S}-{n}") for S in (2, 4)
    for n in WORLD_CONFIGS[S] if not n.startswith("topc")])
def test_each_rank_holds_the_reference_shard(worlds, S, name):
    """Rank s holds shard s of the reference's stacked arrays: the
    exhaustive fields' [Ld, N / S] slices, the pruned rows (delta16 bits as
    int16; lengths widened to int32) and CSR, and the shard geometry."""
    ranks, jax_side = worlds
    je = jax_side[S][name]["engine"]
    ss = je._shard_size
    for s, r in enumerate(ranks[S]):
        assert tuple(r[f"{name}/shard"]) == (S, s, ss, je.n_padded)
        if name == "exhaustive":
            want = {f: [np.asarray(a)[:, s * ss:(s + 1) * ss] for a in v]
                    for f, v in je._device_fields.items()}
        else:
            want = {f"rows/{f}": [np.asarray(a)[s] for a in v]
                    for f, v in je._device_rows.items()}
            want["csr/text"] = [np.asarray(a)[s] for a in je._device_csr]
            want["csr/title"] = [np.asarray(a)[s]
                                 for a in je._device_csr_title]
        for f, arrays in want.items():
            for j, a in enumerate(arrays):
                got = r[f"{name}/arr/{f}/{j}"]
                if got.dtype == np.int16:
                    got = got.view(np.uint16)
                np.testing.assert_array_equal(got, a.astype(got.dtype),
                                              err_msg=f"{f}/{j}")


def test_search_stream_equals_per_batch_search(worlds):
    ranks, _ = worlds
    for r in ranks[2]:
        for b in range(3):
            np.testing.assert_array_equal(r[f"stream/{b}/i"],
                                          r[f"batch/{b}/i"])
            np.testing.assert_array_equal(r[f"stream/{b}/s"],
                                          r[f"batch/{b}/s"])
        ids = np.concatenate([r[f"batch/{b}/i"] for b in range(3)])
        ids = np.where(np.concatenate([r[f"batch/{b}/s"]
                                       for b in range(3)]) > 0, ids, -1)
        np.testing.assert_array_equal(r["texts_stream/i"], ids)


def test_search_with_entities_materializes_the_encoded_search(worlds):
    ranks, _ = worlds
    for r in ranks[2]:
        ids = np.where(r[f"{STREAM}/ts"] > 0, r[f"{STREAM}/ti"], -1)
        np.testing.assert_array_equal(r["search/ti"], ids)


@pytest.mark.parametrize("name", WORLD_CONFIGS["2x2"])
def test_2x2_world_equals_two_shards(worlds, name):
    """On a (data=2, model=2) mesh ranks 2d and 2d + 1 hold shard d, and
    every rank returns what the S = 2 world returns."""
    ranks, _ = worlds
    want = ranks[2][0]
    for r, got in enumerate(ranks["2x2"]):
        assert tuple(got["coord"]) == (r // 2, r % 2)
        assert got[f"{name}/shard"][1] == r // 2
        for key in ("s", "i", "ts", "ti"):
            np.testing.assert_array_equal(got[f"{name}/{key}"],
                                          want[f"{name}/{key}"])


@pytest.mark.parametrize("S,name,kind", _cases())
def test_meshed_engine_equals_the_unsharded_engine(worlds, unsharded, S,
                                                   name, kind):
    """Exhaustive: the same top k within ties. Pruned, plain queries: the
    same docs and sorted scores (the reference's own hold). Pruned with
    entities: recall@10 at least 0.9 -- the shards' CSRs rank pass 1 on
    another 8-bit scale than the unsharded CSR, and the reference's meshed
    engine departs from its unsharded one on this corpus too (one query of
    16 at S = 2 and 4)."""
    ranks, _ = worlds
    us, ui = unsharded[name][kind]
    for ts, ti in _got(ranks[S], name, kind):
        if name == "exhaustive":
            assert_same_topk(ts, ti, us, ui)
        elif kind == "plain":
            assert_same_sets(ts, ti, us, ui)
        else:
            hit = np.mean([len(set(ti[q]) & set(ui[q])) / K
                           for q in range(N_QUERIES)])
            assert hit >= 0.9, hit


def test_topc_where_it_reduces_keeps_its_recall(worlds, unsharded):
    """C = 64 at recall 0.9 reduces the pass-1 partials (XLA's formula);
    the engine's top 10 keeps at least 0.9 of the same engine's with the
    exact top C."""
    ranks, _ = worlds
    P = int(ranks[2][0]["topc/P"])
    assert approx_topk_reduction_size(P, TOPC["n_candidates"], 0.9)[1] > 0
    _, ex_i = unsharded["exhaustive"]["plain"]
    for r in ranks[2]:
        exact, approx = r["topc/0.0/i"], r["topc/0.9/i"]
        hit = np.mean([len(set(exact[q]) & set(approx[q])) / K
                       for q in range(N_QUERIES)])
        vs_ex = np.mean([len(set(ex_i[q]) & set(approx[q])) / K
                         for q in range(N_QUERIES)])
        print(f"topc_recall=0.9 at C=64, P={P}: recall@10 {hit:.4f} "
              f"against the exact top-C, {vs_ex:.4f} against exhaustive")
        assert hit >= 0.9


# -- in one process --------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    """An in-process gloo world of one rank, destroyed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield make_mesh(device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("name", ["exhaustive", "d16", "p32_tiny8",
                                  "full_rows"])
def test_mesh_of_one_equals_the_unsharded_engine(world_of_one, unsharded,
                                                 name):
    """One shard: the exhaustive engine's results are the unsharded ones;
    the pruned engine's shard CSR has its own 8-bit scale (over every
    impact, as the reference's), so it is held as the reference holds a
    sharded pruned engine."""
    text, title = port_indices(zipf_corpus())
    qt, qw, tt, tw = _queries(text, title)
    eng = RetrievalEngine(text, title_index=title, mesh=world_of_one,
                          device="cpu", **CONFIGS[name])
    assert (eng.n_shards, eng.shard, eng.shard_size) == (1, 0,
                                                          eng.n_padded)
    for kind, got in (("plain", eng.search_encoded(qt, qw, k=K)),
                      ("entities", eng.search_encoded(
                          qt, qw, k=K, title_terms=tt, title_weights=tw))):
        us, ui = unsharded[name][kind]
        if name == "exhaustive":
            np.testing.assert_array_equal(got[1], ui)
            np.testing.assert_array_equal(got[0], us)
        else:
            assert_same_sets(*got, us, ui)


@pytest.mark.parametrize("name", ["exhaustive", "d16"])
def test_mesh_of_one_stream_passes_empty_batches(world_of_one, name):
    """A meshed engine's stream yields ``[0, k]`` results for an empty
    batch, and the non-empty batches' results are the stream's without
    it (every rank sees the same stream, so every rank skips the same
    merges)."""
    text, _ = port_indices(zipf_corpus(n_docs=400))
    eng = RetrievalEngine(text, mesh=world_of_one, device="cpu",
                          **CONFIGS[name])
    qt, qw = _queries(text, port_indices(zipf_corpus(n_docs=400))[1])[:2]
    batches = [(qt[:5], qw[:5]), (qt[5:12], qw[5:12])]
    got = list(eng.search_stream([[], batches[0], [], batches[1]], k=K))
    want = list(eng.search_stream(batches, k=K))
    assert [g[1].shape for g in got] == [(0, K), (5, K), (0, K), (7, K)]
    for (gs, gi), (ws, wi) in zip([got[1], got[3]], want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gs, ws)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("refusal", ["device_false", "deep_terms", "mix"])
def test_the_reference_refusals_stand(world_of_one, refusal):
    text, _ = port_indices(zipf_corpus(n_docs=200))
    docs = zipf_corpus(n_docs=200)
    j = JIndex.build(docs, params=JParams(quantize_norms=True),
                     pad_docs_to=64)
    jmesh = j_make_mesh(data=1, model=1, devices=jax.devices()[:1])
    kw = dict(device=False) if refusal == "device_false" else (
        dict(deep_terms=2) if refusal == "deep_terms" else {})
    if refusal == "mix":
        got = _message(lambda: MixEngine({"en": RetrievalEngine(
            text, mesh=world_of_one, device="cpu", **KNOBS)}, device="cpu"))
        want = _message(lambda: JMixEngine(
            {"en": JEngine(j, mesh=jmesh, use_pallas=False, **KNOBS)}))
    else:
        got = _message(lambda: RetrievalEngine(
            text, mesh=world_of_one, **{"device": "cpu", **KNOBS, **kw}))
        want = _message(lambda: JEngine(j, mesh=jmesh, **KNOBS, **kw))
    assert got == want


def test_a_mesh_must_be_a_device_mesh():
    text, _ = port_indices(zipf_corpus(n_docs=200))
    with pytest.raises(TypeError, match="DeviceMesh"):
        RetrievalEngine(text, mesh=object(), device="cpu")
