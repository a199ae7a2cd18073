"""A fine-tuning cell: ``FinetuneTrainer.train_step`` over fused records.

Set-up draws the mix's fused records, builds the tagger with the run's
seeded float32 master weights, the trainer and its optimizer, and cuts the
records into batches of ``batch`` (a seeded permutation, each batch
encoded with the trainer's ``encode_batch``). It then takes the
``check_steps`` first steps on batches whose rows all differ, reading what
the judge compares (each step's loss, the first gradient as the
optimizer's first moment holds it after one step, the parameters' change
after the last), and ``warmup_steps`` more. The window takes steps back to
back, cycling over the batches, each ending when its loss reaches the
host; a traced run then takes two slices of ``trace_steps`` more under the
profiler (:func:`..trace.profile`), the second with the benchmark's spans.

``correct`` holds those first steps to the reference's, once the program's
state is freed: the reference follows the same batches with the same
dropout seeds from the same initial weights (:mod:`..reference`).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from .. import kb, reference, traffic, weights
from ..cell import Cell, log
from ..trace import profile, wrapped
from .serve_backlog import device_info, log_setup, make_tagger, tag_setup

B1 = 0.9  # the optimizer's first-moment decay
BLOCK = 8  # rows the reference takes through forward and backward at once


def leaf_norms(named) -> Dict[str, float]:
    return {n: float(t.detach().double().norm()) for n, t in named}


def run(cell: Cell) -> dict:
    from kbner_tpu_torch.data.conll import Corpus, ListCorpus, SentenceRecord
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.models import tagger as tagger_mod
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    p, model = cell.traffic, cell.config["model"]
    d = kb.ensure_docs(cell.config["kb"], cell.cache)
    raw = traffic.fused_records(p, cell.seed,
                                kb.topic_model(cell.config["kb"], d))
    records = [SentenceRecord(tokens=t, tags={"ner": g}) for t, g in raw]
    marks = [("imports and the records", time.perf_counter())]
    tokenizer, tag_dict = tag_setup(cell)
    tagger = make_tagger(cell, tag_dict, training=True,
                         locked_dropout=p["locked_dropout"],
                         word_dropout=p["word_dropout"])
    trainer = FinetuneTrainer(
        tagger, ListCorpus([Corpus(records, [], [], name="FUSED")]),
        tokenizer, tag_dict, device=cell.device)
    config = TrainConfig(
        learning_rate=p["lr"], lr_rate=p["lr_rate"], batch_size=p["batch"],
        max_epochs=p["epochs"], warmup_fraction=p["warmup_fraction"],
        grad_clip=p["grad_clip"], seed=cell.seed)
    opt = trainer.make_optimizer(config)
    groups = batch_rows(p, cell.seed)
    batches = [encode_batch([records[j] for j in g], tokenizer, tag_dict,
                            max_subtokens=p["max_subtokens"])
               for g in groups]
    rng = torch.Generator().manual_seed(cell.seed)
    marks.append(("trainer and batches", time.perf_counter()))

    # -- the first steps, through the window's own call and feed --------------
    start = {n: t.detach().clone() for n, t in tagger.named_parameters()}
    prog = {"loss": []}
    for s in range(p["check_steps"]):
        prog["loss"].append(float(trainer.train_step(batches[s], opt, config,
                                                     rng)))
        if s == 0:
            prog["grad"] = {n: v / (1.0 - B1) for n, v in leaf_norms(
                zip(opt.names, opt.mu)).items()}
    prog["change"] = leaf_norms((n, t - start[n])
                                for n, t in tagger.named_parameters())
    del start
    marks.append(("checked steps", time.perf_counter()))
    n_first = p["check_steps"] + p["warmup_steps"]
    for s in range(p["check_steps"], n_first):
        float(trainer.train_step(batches[s % len(batches)], opt, config, rng))
    cell.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - cell.t_start
    log_setup(cell, marks)

    # -- the window -----------------------------------------------------------
    real = [int(eb.attention_mask.sum()) for eb in batches]
    need = [train_flops(model, len(tag_dict),
                        eb.attention_mask.sum(1).tolist()) for eb in batches]
    s, tokens, flops = n_first, 0, 0.0
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    while time.perf_counter() < deadline:
        j = s % len(batches)
        loss = float(trainer.train_step(batches[j], opt, config, rng))
        if not math.isfinite(loss):
            raise RuntimeError(f"step {s}: loss {loss}")
        tokens += real[j]
        flops += need[j]
        s += 1
    window_s = time.perf_counter() - t0
    steps = s - n_first
    log(f"window: {steps} steps in {window_s:.3f} s")
    ctx = {"setup_s": setup_s, "window_s": window_s, "steps": steps,
           "tokens": tokens, "flops": flops}

    if cell.trace:
        spans = [(trainer, "train_step", "step"), (opt, "step", "optimizer"),
                 (tagger_mod, "crf_neg_log_likelihood", "crf")]
        n_slice = p["trace_steps"]
        cursor = [s]

        def body():
            lo = cursor[0]
            cursor[0] += n_slice
            for k in range(lo, lo + n_slice):
                float(trainer.train_step(batches[k % len(batches)], opt,
                                         config, rng))
            return n_slice

        with wrapped(spans):
            ctx["trace"] = profile(body, cell.sync)

    ctx["device"] = device_info(cell)
    del trainer, tagger, opt, batches
    gc.collect()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference_steps(cell, raw, groups)
    ctx["checks"] = compare(prog, ref)
    ctx["attempted"], ctx["failed"] = steps, 0
    log(f"reference: {p['check_steps']} steps in "
        f"{time.perf_counter() - t0:.1f} s; program losses {prog['loss']}, "
        f"reference {ref['loss']}")
    return ctx


def batch_rows(p: dict, seed: int) -> List[np.ndarray]:
    """The records of each batch: a permutation drawn from the seed, cut
    into ``batch``-row groups."""
    order = np.random.RandomState((seed + 2) % 2**32).permutation(
        p["records"])
    B = p["batch"]
    return [order[i:i + B] for i in range(0, len(order) - B + 1, B)]


def train_flops(model: dict, n_tags: int, lens: List[int]) -> float:
    """FLOPs of one step that its inputs need: ``6 N T + 12 L H sum
    S_b^2``."""
    n = weights.non_embedding_params(model, n_tags)
    return float(6 * n * sum(lens) + 12 * model["num_hidden_layers"]
                 * model["hidden_size"] * sum(x * x for x in lens))


def reference_steps(cell: Cell, raw, groups, quant=None, half=False
                    ) -> dict:
    """The reference's first ``check_steps`` steps: each step's loss, each
    leaf's first clipped gradient norm, each leaf's change after the last
    step. ``half`` takes the loss over the first half of each batch only
    (a planted fault)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p, model = cell.traffic, cell.config["model"]
    tags = traffic.tag_list()
    index = {t: j for j, t in enumerate(tags)}
    K = len(tags) + 2
    params = weights.make(model, K, cell.seed, cell.device)
    start = {n: t.clone() for n, t in params.items()}
    for t in params.values():
        t.requires_grad_(True)
    tagger = reference.Tagger(params, model, K - 2, K - 1, quant=quant)
    rng = torch.Generator().manual_seed(cell.seed)
    B = p["batch"]
    total = max(1, math.ceil(p["records"] / B)) * p["epochs"]
    warm = int(total * p["warmup_fraction"])
    state: dict = {}
    out = {"loss": []}
    for s in range(p["check_steps"]):
        rows = groups[s]
        sents = [raw[j][0] for j in rows]
        tag_ids = [[index.get(t, 0) for t in raw[j][1]] for j in rows]
        enc = {k: torch.from_numpy(v).to(cell.device) for k, v in
               reference.encode(sents, model["vocab_size"], tag_ids,
                                p["max_subtokens"]).items()}
        drops = reference.Drops(rng, model["num_hidden_layers"], cell.device,
                                model["hidden_dropout_prob"],
                                model["attention_probs_dropout_prob"],
                                p["word_dropout"])
        used = B // 2 if half else B
        loss = 0.0
        for lo in range(0, used, BLOCK):
            hi = min(lo + BLOCK, used)
            drops.start(B, slice(lo, hi))
            feats = tagger.features(enc["input_ids"][lo:hi],
                                    enc["attention_mask"][lo:hi],
                                    enc["word_starts"][lo:hi],
                                    enc["word_mask"][lo:hi], drops)
            nll = tagger.nll(tagger.emissions(feats),
                             enc["tag_ids"][lo:hi], enc["n_words"][lo:hi])
            part = nll.sum() / used
            part.backward()
            loss += float(part.detach())
        out["loss"].append(loss)
        grads = {n: t.grad for n, t in params.items()}
        if s == 0:
            norm = math.sqrt(sum(float(g.double().square().sum())
                                 for g in grads.values()))
            scale = 1.0 if norm < p["grad_clip"] else p["grad_clip"] / norm
            out["grad"] = {n: float(g.double().norm()) * scale
                           for n, g in grads.items()}
        lrs = {"encoder": reference.linear_schedule(p["lr"], warm, total, s),
               "head": reference.linear_schedule(p["lr"] * p["lr_rate"], warm,
                                                 total, s)}
        with torch.no_grad():
            reference.adamw(params, grads, state, lrs, p["grad_clip"])
        for t in params.values():
            t.grad = None
    out["change"] = {n: float((params[n].detach() - start[n]).double().norm())
                     for n in params}
    return out


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers: each step's loss as a share of the
    reference's (the worst step); each leaf's first-gradient norm and
    change norm against the reference's, as a share of the larger of the
    reference leaf's and the median leaf's (the worst leaf). Leaves whose
    reference gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    g_ref = ref["grad"]
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(prog["grad"][n] - g) / max(g, g_med)
               for n, g in g_ref.items())
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][n] for n in moved]))
    change = max(abs(prog["change"][n] - ref["change"][n])
                 / max(ref["change"][n], c_med) for n in moved)
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change}
