"""Spawned gloo worlds for the port's tests of meshed code
(tests/test_torch_mesh.py, tests/test_torch_sharded.py on the CPU; one
test of tests/test_torch_cuda.py on the card).

A :class:`World` starts one process per rank with ``torch.multiprocessing``'s
spawn context; each rank joins a gloo group through a file under the test's
``tmp_path`` (so pytest-xdist workers never share a port), runs a rank
program of this module, and returns its arrays through an ``.npz`` file.
Every collective is bounded: the group's timeout is :data:`TIMEOUT_S`, and
:meth:`World.join` terminates the ranks and fails the test when they
outlive its deadline. This module imports torch, numpy and the port, never
JAX: the ranks import it, not the test modules.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 60      # the gloo group's timeout for any collective
JOIN_S = 180        # a world's deadline, from its start


def _rank_main(rank: int, world: int, init_file: str, out_dir: str,
               fn: Callable, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        arrays = fn(rank, world, *args)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **arrays)
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


class World:
    """``world`` ranks running ``fn(rank, world, *args)`` -> dict of arrays,
    started at construction; :meth:`join` waits and returns each rank's
    arrays."""

    def __init__(self, fn: Callable, world: int, tmp_path: Path, *args):
        self.dir = Path(tmp_path)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.world = world
        self.start = time.monotonic()
        ctx = mp.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main, args=(
            r, world, str(self.dir / "init"), str(self.dir), fn, args))
            for r in range(world)]
        for p in self.procs:
            p.start()

    def join(self, deadline_s: float = JOIN_S) -> List[Dict[str, np.ndarray]]:
        for p in self.procs:
            p.join(max(deadline_s - (time.monotonic() - self.start), 0.1))
        stuck = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        if stuck:
            raise AssertionError(
                f"ranks {stuck} of a world of {self.world} outlived "
                f"{deadline_s} s and were terminated")
        errors = {r: (self.dir / f"rank{r}.err").read_text()
                  for r in range(self.world)
                  if (self.dir / f"rank{r}.err").exists()}
        codes = [p.exitcode for p in self.procs]
        if errors or any(codes):
            raise AssertionError(f"exit codes {codes}; "
                                 + "\n".join(f"rank {r}:\n{e}"
                                             for r, e in errors.items()))
        out = []
        for r in range(self.world):
            with np.load(self.dir / f"rank{r}.npz") as z:
                out.append({k: z[k] for k in z.files})
        return out


# -- the corpus the meshed-engine tests share ------------------------------------

N_DOCS = 1500  # > 512 per shard at S = 2, so every shard of S <= 2 is busy


def zipf_corpus(n_docs: int = N_DOCS, vocab: int = 400, doc_len: int = 12,
                seed: int = 0, max_rep: int = 3) -> List[str]:
    """Zipf docs with bounded within-doc repeats (tf <= max_rep keeps the
    delta16 3-bit tf field exact): tests/test_delta16_rows.py's recipe."""
    rng = np.random.RandomState(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    docs = []
    for _ in range(n_docs):
        words: List[str] = []
        counts: Dict[int, int] = {}
        while len(words) < doc_len:
            w = int(rng.choice(vocab, p=probs))
            if counts.get(w, 0) >= max_rep:
                continue
            counts[w] = counts.get(w, 0) + 1
            words.append(f"w{w}")
        docs.append(" ".join(words))
    return docs


def titles_of(docs: List[str]) -> List[str]:
    """The title field: each doc's first two words, as
    tests/test_pruned_retrieval.py builds titles."""
    return [" ".join(d.split()[:2]) for d in docs]


def query_texts(docs: List[str], n: int, seed: int):
    """``n`` doc sentences as queries and ``n`` titles as their entities."""
    rng = np.random.RandomState(seed)
    titles = titles_of(docs)
    return ([docs[i] for i in rng.randint(0, len(docs), n)],
            [[titles[i]] for i in rng.randint(0, len(docs), n)])


def port_indices(docs: List[str]):
    """The port's text index (stored doc lengths, quantized norms: delta16
    rows) and title index of ``docs``."""
    from kbner_tpu_torch.retrieval.index import BM25Index, BM25Params

    return (BM25Index.build(docs, params=BM25Params(quantize_norms=True),
                            pad_docs_to=64),
            BM25Index.build(titles_of(docs),
                            params=BM25Params(quantize_norms=False),
                            pad_docs_to=64))


# -- rank programs -----------------------------------------------------------------

def mesh_rank(rank: int, world: int, batch: Dict[str, np.ndarray],
              shapes) -> Dict[str, np.ndarray]:
    """parallel.mesh in a world: per ``(data, model)`` of ``shapes`` the
    mesh's coordinates, ``pad_batch_for_mesh`` and each ``shard_batch``
    entry's local rows; and whether a mismatched mesh raises."""
    from kbner_tpu_torch.parallel import (make_mesh, pad_batch_for_mesh,
                                          shard_batch)

    out: Dict[str, np.ndarray] = {}
    for data, model in shapes:
        tag = f"{data}x{model}"
        mesh = make_mesh(data=data, model=model, device_type="cpu")
        out[f"{tag}/coord"] = np.asarray(
            [mesh.get_local_rank("data"), mesh.get_local_rank("model")])
        padded = pad_batch_for_mesh(batch, mesh)
        for k, v in padded.items():
            out[f"{tag}/pad/{k}"] = v
            out[f"{tag}/local/{k}"] = shard_batch(
                {k: v}, mesh)[k].to_local().numpy()
    try:
        make_mesh(data=world + 1, model=1, device_type="cpu")
        out["mismatch"] = np.asarray("no error")
    except ValueError as e:
        out["mismatch"] = np.asarray(str(e))
    return out


def _search(engine, qt, qw, tt=None, tw=None, k: int = 10):
    return engine.search_encoded(qt, qw, k=k, title_terms=tt,
                                 title_weights=tw)


def engine_rank(rank: int, world: int, data: int, model: int,
                configs: Dict[str, dict], n_queries: int, seed: int,
                stream_config: str, topc: dict
                ) -> Dict[str, np.ndarray]:
    """Meshed engines over :func:`zipf_corpus` on a ``(data, model)``
    mesh: per config (engine keyword arguments) the top 10 of the plain
    queries (``{name}/s``, ``{name}/i``) and of the entity-boosted ones
    (``{name}/ts``, ``{name}/ti``), the engine's shard arrays
    (``{name}/arr/...``), ``search_stream`` over three batches against
    per-batch searches on ``stream_config``, and for ``topc`` (engine
    keyword arguments plus ``"recalls"``) the top 10 at each recall target
    on one engine, with the pass-1 width P it reduced."""
    from kbner_tpu_torch.parallel import make_mesh
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine

    docs = zipf_corpus()
    text, title = port_indices(docs)
    queries, ents = query_texts(docs, n_queries, seed)
    qt, qw = text.encode_queries(queries)
    tt, tw = title.encode_queries([" ".join(e) for e in ents],
                                  boosts=[2.0] * len(ents))
    mesh = make_mesh(data=data, model=model, device_type="cpu")
    out: Dict[str, np.ndarray] = {
        "coord": np.asarray([mesh.get_local_rank("data"),
                             mesh.get_local_rank("model")])}
    for name, kw in configs.items():
        eng = RetrievalEngine(text, title_index=title, mesh=mesh,
                              device="cpu", **kw)
        out[f"{name}/s"], out[f"{name}/i"] = _search(eng, qt, qw)
        out[f"{name}/ts"], out[f"{name}/ti"] = _search(eng, qt, qw, tt, tw)
        out[f"{name}/shard"] = np.asarray(
            [eng.n_shards, eng.shard, eng.shard_size, eng.n_padded])
        arrays = eng.fields if eng.mode == "exhaustive" else {
            **{f"rows/{f}": v for f, v in eng.rows.items()},
            **{f"csr/{f}": v for f, v in eng.csr.items()}}
        for f, tensors in arrays.items():
            for j, t in enumerate(tensors):
                out[f"{name}/arr/{f}/{j}"] = t.numpy()
        if name == stream_config:
            blocks = [text.encode_queries(query_texts(docs, 8, seed + b)[0])
                      for b in range(3)]
            for b, (s, i) in enumerate(eng.search_stream(blocks, k=10)):
                out[f"stream/{b}/s"], out[f"stream/{b}/i"] = s, i
            for b, blk in enumerate(blocks):
                out[f"batch/{b}/s"], out[f"batch/{b}/i"] = _search(eng, *blk)
            texts = [q for b in range(3)
                     for q in query_texts(docs, 8, seed + b)[0]]
            res = eng.search_texts_stream(texts, k=10, batch_size=8)
            out["texts_stream/i"] = np.asarray(
                [[d.doc_id for d in r] + [-1] * (10 - len(r)) for r in res])
            res = eng.search(queries, k=10,
                             entity_queries=[list(e) for e in ents])
            out["search/ti"] = np.asarray(
                [[d.doc_id for d in r] + [-1] * (10 - len(r)) for r in res])
    if topc:
        kw = {k: v for k, v in topc.items() if k != "recalls"}
        eng = RetrievalEngine(text, mesh=mesh, device="cpu", mode="pruned",
                              **kw)
        for r in topc["recalls"]:
            eng.topc_recall = r  # read at each search
            out[f"topc/{r}/s"], out[f"topc/{r}/i"] = _search(eng, qt, qw)
        keys, _, _, _ = eng._device_queries(eng._pack_queries(qt, qw))
        out["topc/P"] = np.asarray(keys.shape[1])
    return out


def card_engine_rank(rank: int, world: int, n_docs: int
                     ) -> Dict[str, np.ndarray]:
    """Meshed engines over a seeded synthetic KB on a ``(world, 1)`` mesh
    whose ranks share the card (gloo): the top 10 of 32 queries from the
    exhaustive and the pruned engine on the card and on the CPU, and the
    K1 and K2 launches of each search."""
    from kbner_tpu_torch.ops import bm25
    from kbner_tpu_torch.parallel import make_mesh
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.index import BM25Index
    from kbner_tpu_torch.retrieval.synth import (sentence_queries,
                                                 synth_wiki_docs)

    docs = synth_wiki_docs(n_docs, vocab=4000, n_topics=40, seed=5)
    index = BM25Index.build_encoded(docs, {f"w{i}": i for i in range(4000)})
    q, _ = sentence_queries(docs, 32, 64, seed=3)
    qt, qw = index.encode_queries(
        [" ".join(f"w{t}" for t in r[r >= 0]) for r in q])
    mesh = make_mesh(data=world, model=1, device_type="cuda")
    out: Dict[str, np.ndarray] = {}
    for mode, kw in (("exhaustive", {}), ("pruned", dict(
            rare_terms=16, posting_budget=6144, n_candidates=1024))):
        for dev in ("cuda", "cpu"):
            eng = RetrievalEngine(index, mode=mode, mesh=mesh, device=dev,
                                  **kw)
            before = (bm25.bm25_score_block.launches,
                      bm25.delta16_rescore.launches)
            s, i = eng.search_encoded(qt, qw, k=10)
            out[f"{mode}/{dev}/s"], out[f"{mode}/{dev}/i"] = s, i
            out[f"{mode}/{dev}/launches"] = np.asarray(
                [bm25.bm25_score_block.launches - before[0],
                 bm25.delta16_rescore.launches - before[1]])
    return out
