"""Spawned gloo worlds for the port's tests of meshed code
(tests/test_torch_mesh.py, tests/test_torch_sharded.py,
tests/test_torch_mesh_train.py and tests/test_torch_mesh_distill.py on
the CPU; three tests of tests/test_torch_cuda.py on the card).

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
    from kbner_tpu_torch.parallel import (local_rows, make_mesh,
                                          pad_batch_for_mesh, shard_batch)

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
            out[f"{tag}/rows/{k}"] = local_rows({k: v}, mesh)[k]
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


# -- sharded training (tests/test_torch_mesh_train.py) ----------------------------

TOY_VOCAB = 997
TOY_FOLDER = Path(__file__).parent / "fixtures" / "ner_toy"
TOY_ROWS = 7  # of ner_toy's 8 train sentences: odd, so data = 2 pads
RUN_CONFIG = dict(learning_rate=1e-3, lr_rate=3.0, batch_size=8,
                  warmup_fraction=0.0, seed=4, checkpoint=True)
ACC_CONFIG = dict(learning_rate=1e-2, lr_rate=3.0, accumulation_steps=2,
                  grad_clip=0.5, warmup_fraction=0.0, batch_size=4,
                  max_epochs=1)
ACC_ROWS = ((0, 4), (4, 6), (2, 6), (0, 2))  # the micro-batches' rows


def toy_corpus():
    """The ner_toy fixture through the port."""
    from kbner_tpu_torch.data.conll import load_column_corpus

    return load_column_corpus(TOY_FOLDER, {0: "text", 1: "ner"},
                              comment_symbol="# id")


def quality_corpus():
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus

    return make_quality_corpus(16, 4, 4, seed=1)


def toy_tagger(tree, tag_dict, use_crf: bool = True, dropout: bool = False,
               device="cpu"):
    """The port's tiny tagger (``XLMRConfig.tiny`` at the toy vocabulary)
    on ``device``: with a Flax tree (numpy leaves) its weights, else drawn
    from seed 0; ``dropout`` turns every dropout site on."""
    from kbner_tpu_torch import weights
    from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
    from kbner_tpu_torch.models.xlmr import XLMRConfig

    rates = (dict(hidden_dropout=0.1, attention_dropout=0.1)
             if dropout else {})
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=1000, **rates), tag_dict,
        use_crf=use_crf, locked_dropout=0.5 if dropout else 0.0,
        word_dropout=0.05 if dropout else 0.0)
    model = SequenceTagger(cfg, device=device, seed=0)
    if tree is not None:
        model.load_state_dict(weights.from_jax_params(tree, model))
    return model


class GradCapture:
    """Stands in for the optimizer in ``FinetuneTrainer.train_step``: its
    ``step`` keeps each parameter's gradient (after the trainer's
    gradient sync) instead of updating."""

    def __init__(self, model):
        self.model = model
        self.grads: Dict[str, torch.Tensor] = {}

    def step(self) -> bool:
        self.grads = {n: (p.grad if p.grad is not None
                          else torch.zeros_like(p)).detach().clone()
                      for n, p in self.model.named_parameters()}
        return True


def run_pair(make_trainer, base, epochs=(1, 2)):
    """A trainer from ``make_trainer()`` trains ``epochs[0]`` epochs with
    checkpoints under ``base``, then a fresh one resumes there to
    ``epochs[1]``; returns each run's history, full parameters, moments
    and update count, keyed ``run0/...`` and ``run1/...``."""
    from kbner_tpu_torch.parallel import gather_state_dict
    from kbner_tpu_torch.train import TrainConfig

    out = {}
    for run, n in enumerate(epochs):
        t = make_trainer()
        seen = {}
        save = t._save_checkpoint

        def keep(path, opt, *args, _save=save, _seen=seen):
            _seen["opt"] = opt
            return _save(path, opt, *args)

        t._save_checkpoint = keep
        res = t.train(base, TrainConfig(max_epochs=n, resume=run > 0,
                                        **RUN_CONFIG))
        out[f"run{run}/loss"] = np.asarray(res["history"]["train_loss"])
        out[f"run{run}/dev"] = np.asarray(res["history"]["dev_score"])
        for n_, v in gather_state_dict(t.model).items():
            out[f"run{run}/param/{n_}"] = v.detach().numpy()
        opt = seen["opt"]
        for key, named in opt.named_moments().items():
            for n_, v in named.items():
                if t.sharding is not None:
                    v = t.sharding.gather(n_, v)
                out[f"run{run}/{key}/{n_}"] = v.float().numpy()
        out[f"run{run}/count"] = np.asarray(opt.count)
    return out


def mesh_train_rank(rank: int, world: int, data: int, model: int,
                    fsdp: bool, trees: Dict[str, dict], out_dir: str
                    ) -> Dict[str, np.ndarray]:
    """Sharded training on a ``(data, model)`` mesh of the CPU, the
    tagger sharded by ``parallel.shard_params`` (``fsdp`` as given):
    per head of ``trees`` (``crf``, ``softmax``: Flax trees) the loss and
    every full gradient of ``FinetuneTrainer.train_step`` on
    :data:`TOY_ROWS` ner_toy sentences (padded to the data axis); parameters after two
    updates of accumulation 2 with clipping over :data:`ACC_ROWS`; a
    train run of one epoch and its resume to two with every dropout on
    and ``checkpoint: true`` under ``out_dir/run`` (:func:`run_pair`);
    and the refusal of a model that ``shard_params`` did not shard on
    the mesh."""
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.parallel import (gather_state_dict, make_mesh,
                                          shard_params)
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    mesh = make_mesh(data=data, model=model, device_type="cpu")
    tok = HashTokenizer(TOY_VOCAB)
    corpus = toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    out: Dict[str, np.ndarray] = {}

    def trainer_of(m, c=corpus, t=tags):
        return FinetuneTrainer(shard_params(m, mesh, fsdp), c, tok, t,
                               mesh=mesh, device="cpu")

    eb = encode_batch(corpus.train[:TOY_ROWS], tok, tags)
    for head, tree in trees.items():
        trainer = trainer_of(toy_tagger(tree, tags, use_crf=head == "crf"))
        cap = GradCapture(trainer.model)
        out[f"{head}/loss"] = np.asarray(float(trainer.train_step(
            eb, cap, TrainConfig(), None)))
        for n, g in cap.grads.items():
            out[f"{head}/grad/{n}"] = trainer.sharding.gather(n, g).numpy()
    trainer = trainer_of(toy_tagger(trees["crf"], tags))
    cfg = TrainConfig(**ACC_CONFIG)
    opt = trainer.make_optimizer(cfg)
    for lo, hi in ACC_ROWS:
        trainer.train_step(encode_batch(corpus.train[lo:hi], tok, tags),
                           opt, cfg, None)
    for n, v in gather_state_dict(trainer.model).items():
        out[f"acc/param/{n}"] = v.numpy()
    out["acc/count"] = np.asarray(opt.count)

    q = quality_corpus()
    q_tags = q.make_tag_dictionary("ner")
    out.update(run_pair(lambda: trainer_of(toy_tagger(
        None, q_tags, dropout=True), q, q_tags), Path(out_dir) / "run"))
    try:
        FinetuneTrainer(toy_tagger(None, tags), corpus, tok, tags, mesh=mesh,
                        device="cpu")
        out["plain"] = np.asarray("no error")
    except ValueError as e:
        out["plain"] = np.asarray(str(e))
    return out


CARD_LAYOUTS = {"dp": (2, 1, False), "tp": (1, 2, False),
                "fsdp": (2, 1, True)}


def card_train_rank(rank: int, world: int) -> Dict[str, np.ndarray]:
    """Two gloo ranks sharing the card: per layout of
    :data:`CARD_LAYOUTS` the float32 loss and every full gradient of one
    sharded ``train_step`` on :data:`TOY_ROWS` ner_toy sentences, the
    tagger drawn on the card from seed 0."""
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.parallel import make_mesh, shard_params
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    corpus = toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(TOY_VOCAB)
    eb = encode_batch(corpus.train[:TOY_ROWS], tok, tags)
    out: Dict[str, np.ndarray] = {}
    for name, (data, model, fsdp) in CARD_LAYOUTS.items():
        mesh = make_mesh(data=data, model=model, device_type="cuda")
        tagger = shard_params(toy_tagger(None, tags, device="cuda"), mesh,
                              fsdp)
        trainer = FinetuneTrainer(tagger, corpus, tok, tags, mesh=mesh)
        cap = GradCapture(trainer.model)
        out[f"{name}/loss"] = np.asarray(float(trainer.train_step(
            eb, cap, TrainConfig(), None)))
        for n, g in cap.grads.items():
            out[f"{name}/grad/{n}"] = trainer.sharding.gather(
                n, g).cpu().numpy()
    return out


# -- distillation and multi-view training on a mesh
# (tests/test_torch_mesh_distill.py) ------------------------------------------

MV_CONFIG = dict(multi_view=True, mv_kind="kl", mv_l2_weight=0.1)
KD_STEPS = {"logit": dict(temperature=2.0, interpolation=0.3),
            "posterior": dict(posterior=True, interpolation=0.3),
            "kbest": dict(kbest=2, interpolation=0.3)}
RUN_BASE = dict(learning_rate=1e-3, lr_rate=3.0, max_epochs=1,
                warmup_fraction=0.0, seed=4)
# one-epoch runs against the JAX trainers (dropout off); the JAX meshed
# distillation trainer runs at batch 4 only (at 3 its targets are not
# padded)
JAX_RUNS = {"f16": dict(teacher_cache="f16", batch_size=4),
            "lazy": dict(teacher_cache="lazy", batch_size=4,
                         interpolation=0.7),
            "kbest": dict(kbest=2, batch_size=4),
            "mv3": dict(batch_size=3, **MV_CONFIG),
            "mv4": dict(batch_size=4, **MV_CONFIG)}
# one-epoch runs at batch 3 (padded over data = 2) with every dropout on,
# against the port's single-process trainer on the same padded batches
PADDED_RUNS = {"f16": dict(teacher_cache="f16", batch_size=3),
               "f32": dict(teacher_cache="f32", batch_size=3,
                           temperature=2.0),
               "lazy": dict(teacher_cache="lazy", batch_size=3,
                            posterior=True),
               "kbest": dict(kbest=2, batch_size=3),
               "mv3": dict(batch_size=3, **MV_CONFIG)}
ROUTED = (0, 0, 1, 1)  # a batch's languages: each rank of data = 2 one


def with_contexts(records, make):
    """Each record followed by ``<EOS>`` and the first five words of the
    next as its retrieved context (tagged S-X), built with ``make(tokens,
    tags)``: fused sentences of either package's record class."""
    out = []
    for i, rec in enumerate(records):
        ctx = records[(i + 1) % len(records)].tokens[:5]
        out.append(make(list(rec.tokens) + ["<EOS>"] + list(ctx),
                        list(rec.tags["ner"]) + ["S-X"] * (len(ctx) + 1)))
    return out


def fused_toy_corpus():
    """ner_toy with contexts (:func:`with_contexts`) in its train split;
    its dev split as it is."""
    from kbner_tpu_torch.data.conll import Corpus, ListCorpus, SentenceRecord

    toy = toy_corpus()
    train = with_contexts(toy.train, lambda t, g: SentenceRecord(
        tokens=t, tags={"ner": g}))
    return ListCorpus([Corpus(train=train, dev=[], test=[],
                              name="TOY")])


def padded_trainer(cls, data: int):
    """``cls`` (a trainer class) whose training batches are padded to a
    multiple of ``data`` rows, as a mesh's data axis pads them, in one
    process: the single-process run that a meshed one must equal."""
    class Padded(cls):
        def _host_rows(self, arrays):
            rem = (-next(iter(arrays.values())).shape[0]) % data
            return {k: np.pad(v, [(0, rem)] + [(0, 0)] * (v.ndim - 1))
                    for k, v in arrays.items()}
    return Padded


def count_forwards(model, counts: List[int]):
    """Count ``model.emissions`` calls in ``counts[0]``."""
    inner = model.emissions

    def counted(*args, **kwargs):
        counts[0] += 1
        return inner(*args, **kwargs)
    model.emissions = counted
    return model


def kd_run(trainer, config, base) -> Dict[str, np.ndarray]:
    """One ``train`` of ``trainer`` under ``config`` (a DistillConfig or a
    TrainConfig) at ``base``: its epoch losses, dev scores, gathered
    parameters and update count; in one process also, per element,
    whether a step's gradient (as the optimizer takes it) was nonzero and
    under 1e-5 (``small/<name>``)."""
    from kbner_tpu_torch.parallel import gather_state_dict

    seen: Dict[str, object] = {}
    inner = trainer._step

    def step(loss_fn, opt, freeze=False):
        if "opt" not in seen and trainer.sharding is None:
            opt_step = opt.step

            def recorded():
                for n, p in trainer.model.named_parameters():
                    g = (p.grad if p.grad is not None
                         else torch.zeros_like(p)).abs()
                    small = (g > 0) & (g < 1e-5)
                    seen[n] = seen.get(n, small) | small
                return opt_step()
            opt.step = recorded
        seen["opt"] = opt
        return inner(loss_fn, opt, freeze)

    trainer._step = step
    res = trainer.train(base, config)
    out = {"loss": np.asarray(res["history"]["train_loss"]),
           "dev": np.asarray(res["history"]["dev_score"]),
           "count": np.asarray(seen.pop("opt").count)}
    for n, v in gather_state_dict(trainer.model).items():
        out[f"param/{n}"] = v.detach().numpy()
    out.update({f"small/{n}": g.numpy() for n, g in seen.items()})
    return out


def run_config(kw):
    """The DistillConfig or (multi-view) TrainConfig of a run's
    keywords."""
    from kbner_tpu_torch.train import TrainConfig
    from kbner_tpu_torch.train.distill import DistillConfig

    cls = TrainConfig if kw.get("multi_view") else DistillConfig
    return cls(**RUN_BASE, **kw)


def run_trainer(kw, student, corpus, tok, tags, teachers, cls=None,
                **extra):
    """The trainer of a run's keywords on the CPU: ``cls``, by default a
    FinetuneTrainer in multi-view mode, else a DistillationTrainer over
    ``teachers``."""
    from kbner_tpu_torch.train import FinetuneTrainer
    from kbner_tpu_torch.train.distill import DistillationTrainer

    if kw.get("multi_view"):
        return (cls or FinetuneTrainer)(student, corpus, tok, tags,
                                        device="cpu", **extra)
    return (cls or DistillationTrainer)(student, corpus, tok, tags,
                                        teachers=teachers, device="cpu",
                                        **extra)


def mesh_distill_rank(rank: int, world: int, data: int, model: int,
                      fsdp: bool, trees: Dict[str, dict],
                      steps: Dict[str, tuple], out_dir: str
                      ) -> Dict[str, np.ndarray]:
    """Distillation and multi-view training on a ``(data, model)`` mesh of
    the CPU, every student sharded by ``parallel.shard_params`` (``fsdp``
    as given), over :func:`fused_toy_corpus`:

      - ``step/<kind>/...``: the loss and every full gradient of one
        ``kd_step`` (:data:`KD_STEPS`, against the targets of ``steps``,
        given for the whole padded batch) or multi-view ``train_step``
        (``mv_crf``, ``mv_softmax``) on the first :data:`TOY_ROWS` fused
        sentences;
      - ``jax/<run>/...``: :data:`JAX_RUNS` from ``trees["crf"]`` with
        dropout off (:func:`kd_run`), taught by ``trees["teacher1"]``;
      - ``pad/<run>/...``: :data:`PADDED_RUNS` with every dropout on;
      - ``route/...``: this rank's rows of a batch in :data:`ROUTED`'s
        languages as two teachers (``teacher1``, ``teacher2``) emit them,
        cached (float32) and lazily, with each teacher's forwards, whole
        on each rank and sharded on the mesh; and the k-best targets of
        a batch of 3 (a padding row over data = 2);
      - ``refused/...``: a teacher sharded on another mesh, and a sharded
        teacher off a mesh."""
    from kbner_tpu_torch.data.corpus_ops import make_orig_view
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.parallel import make_mesh, shard_params
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
    from kbner_tpu_torch.train.distill import (DistillationTrainer,
                                               DistillConfig)

    mesh = make_mesh(data=data, model=model, device_type="cpu")
    tok = HashTokenizer(TOY_VOCAB)
    corpus = fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    out: Dict[str, np.ndarray] = {}

    def student(tree, **kw):
        return shard_params(toy_tagger(tree, tags, **kw), mesh, fsdp)

    def teacher(name):
        return toy_tagger(trees[name], tags)

    recs = corpus.train[:TOY_ROWS]
    eb = encode_batch(recs, tok, tags)
    orig = encode_batch([make_orig_view(r) for r in recs], tok, tags)
    for kind, target in steps.items():
        if kind.startswith("mv_"):
            head = kind[3:]
            trainer = FinetuneTrainer(
                student(trees[head], use_crf=head == "crf"), corpus, tok,
                tags, mesh=mesh, device="cpu")
            cap = GradCapture(trainer.model)
            loss = trainer.train_step((eb, orig), cap,
                                      TrainConfig(**MV_CONFIG), None)
        else:
            trainer = DistillationTrainer(student(trees["crf"]), corpus, tok,
                                          tags, mesh=mesh, device="cpu")
            cap = GradCapture(trainer.model)
            local = trainer._host_rows(dict(enumerate(target)))
            cached = (local[0], local[1]) if kind == "kbest" else local[0]
            loss = trainer.kd_step(eb, cached, cap,
                                   DistillConfig(**KD_STEPS[kind]), None)
        out[f"step/{kind}/loss"] = np.asarray(float(loss))
        for n, g in cap.grads.items():
            out[f"step/{kind}/grad/{n}"] = trainer.sharding.gather(
                n, g).numpy()

    for prefix, runs, dropout in (("jax", JAX_RUNS, False),
                                  ("pad", PADDED_RUNS, True)):
        for name, kw in runs.items():
            trainer = run_trainer(
                kw, student(trees["crf"], dropout=dropout), corpus, tok,
                tags, [teacher("teacher1")], mesh=mesh)
            got = kd_run(trainer, run_config(kw),
                         Path(out_dir) / prefix / name)
            out.update({f"{prefix}/{name}/{k}": v for k, v in got.items()})

    routed = [type(r)(tokens=r.tokens, tags=r.tags, lang_id=lang)
              for r, lang in zip(corpus.train, ROUTED)]
    r_eb = encode_batch(routed, tok, tags)
    for how in ("whole", "sharded"):
        counts = [[0], [0]]
        ts = [count_forwards(teacher(f"teacher{i + 1}"), c)
              for i, c in enumerate(counts)]
        if how == "sharded":
            ts = [shard_params(t, mesh, fsdp) for t in ts]
        trainer = DistillationTrainer(student(None), corpus, tok, tags,
                                      mesh=mesh, teachers=ts, device="cpu")
        out[f"route/{how}/cached"] = trainer._teacher_emissions(
            [r_eb], np.float32)[0]
        out[f"route/{how}/lazy"] = trainer._batch_emissions(r_eb).numpy()
        out[f"route/{how}/forwards"] = np.asarray([c[0] for c in counts])
    out["route/owners"] = trainer._owners(r_eb)
    out["coord"] = np.asarray([mesh.get_local_rank("data"),
                               mesh.get_local_rank("model")])
    trainer = DistillationTrainer(student(None), corpus, tok, tags,
                                  mesh=mesh, teachers=[teacher("teacher1")],
                                  device="cpu")
    paths, weights = trainer._teacher_kbest(
        [encode_batch(recs[:3], tok, tags)], 2)[0]
    out["route/kbest/paths"], out["route/kbest/weights"] = paths, weights

    other = make_mesh(data=data, model=model, device_type="cpu")
    for what, t_mesh, s_mesh in (("other_mesh", other, mesh),
                                 ("no_mesh", mesh, None)):
        try:
            DistillationTrainer(
                toy_tagger(None, tags) if s_mesh is None else student(None),
                corpus, tok, tags, mesh=s_mesh, device="cpu",
                teachers=[shard_params(teacher("teacher1"), t_mesh, fsdp)])
            out[f"refused/{what}"] = np.asarray("no error")
        except ValueError as e:
            out[f"refused/{what}"] = np.asarray(str(e))
    return out


def kd_targets(n_rows: int, n_words: int, n_tags: int, data: int
               ) -> np.ndarray:
    """Seeded teacher logits ``[n_rows, n_words, n_tags]`` padded with zero
    rows to a multiple of ``data``."""
    t = (2 * np.random.RandomState(4).standard_normal(
        (n_rows, n_words, n_tags))).astype(np.float32)
    return np.pad(t, [(0, (-n_rows) % data), (0, 0), (0, 0)])


def card_kd_rank(rank: int, world: int) -> Dict[str, np.ndarray]:
    """Two gloo ranks sharing the card, data-parallel: the float32 loss
    and every full gradient of one ``kd_step`` (logit distillation
    against :func:`kd_targets`) and of one multi-view ``train_step``, on
    the first :data:`TOY_ROWS` fused sentences (padded to the data axis),
    the tagger drawn on the card from seed 0."""
    from kbner_tpu_torch.data.corpus_ops import make_orig_view
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.parallel import make_mesh, shard_params
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
    from kbner_tpu_torch.train.distill import (DistillationTrainer,
                                               DistillConfig)

    corpus = fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(TOY_VOCAB)
    recs = corpus.train[:TOY_ROWS]
    eb = encode_batch(recs, tok, tags)
    orig = encode_batch([make_orig_view(r) for r in recs], tok, tags)
    mesh = make_mesh(data=world, model=1, device_type="cuda")
    out: Dict[str, np.ndarray] = {}
    for kind in ("kd", "mv"):
        tagger = shard_params(toy_tagger(None, tags, device="cuda"), mesh)
        if kind == "kd":
            trainer = DistillationTrainer(tagger, corpus, tok, tags,
                                          mesh=mesh)
            cap = GradCapture(trainer.model)
            cached = trainer._host_rows({"t": kd_targets(
                *eb.word_mask.shape, len(tags), world)})["t"]
            loss = trainer.kd_step(eb, cached, cap,
                                   DistillConfig(**KD_STEPS["logit"]), None)
        else:
            trainer = FinetuneTrainer(tagger, corpus, tok, tags, mesh=mesh)
            cap = GradCapture(trainer.model)
            loss = trainer.train_step((eb, orig), cap,
                                      TrainConfig(**MV_CONFIG), None)
        out[f"{kind}/loss"] = np.asarray(float(loss))
        for n, g in cap.grads.items():
            out[f"{kind}/grad/{n}"] = trainer.sharding.gather(
                n, g).cpu().numpy()
    return out
