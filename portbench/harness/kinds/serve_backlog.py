"""A serve cell: one client with a backlog, as ``cli serve < file`` runs.

Set-up opens the configuration's saved KB with ``load_kb`` and builds the
exhaustive ``RetrievalEngine`` over it and the ``SequenceTagger`` with the
run's seeded weights, then serves ``warmup_batches`` micro-batches. The
window takes micro-batches of ``batch`` requests from the backlog back to
back through ``kbner_tpu_torch.serve.serve``; a request's latency runs
from when its micro-batch is taken to when its responses return. A traced
run then serves two slices of ``trace_batches`` more under the profiler
(:func:`..trace.profile`), the second with the benchmark's spans.

``correct`` judges a sample of the window's requests, drawn from the seed
with the longest sentence in it, once the program's state is freed:
retrieval against BM25 worked out again from the documents, the fusion of
the program's ranked documents against the reference's fusion of the same,
and each served tag path against the reference's Viterbi best over the
reference's float32 emissions (the gap by which the served path's score
lies below the best).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from .. import kb, reference, traffic, weights
from ..cell import Cell, log
from ..trace import profile, wrapped


def tag_setup(cell: Cell):
    """(tokenizer, tag dictionary) of the configuration, the dictionary
    checked against the benchmark's tag order."""
    from kbner_tpu_torch.data.dictionary import make_tag_dictionary
    from kbner_tpu_torch.data.subword import HashTokenizer

    tags = traffic.tag_list()
    tag_dict = make_tag_dictionary([tags])
    if tag_dict.get_items() != tags + ["<START>", "<STOP>"]:
        raise RuntimeError(f"tag dictionary order {tag_dict.get_items()}")
    return HashTokenizer(vocab_size=cell.config["model"]["vocab_size"]), \
        tag_dict


def encoder_config(model: dict, training: bool):
    from kbner_tpu_torch.models.xlmr import XLMRConfig

    return XLMRConfig(
        vocab_size=model["vocab_size"], hidden_size=model["hidden_size"],
        num_layers=model["num_hidden_layers"],
        num_heads=model["num_attention_heads"],
        intermediate_size=model["intermediate_size"],
        max_position_embeddings=model["max_position_embeddings"],
        type_vocab_size=model["type_vocab_size"],
        pad_token_id=model["pad_token_id"],
        layer_norm_eps=model["layer_norm_eps"],
        hidden_dropout=model["hidden_dropout_prob"],
        attention_dropout=model["attention_probs_dropout_prob"],
        dtype=getattr(torch, model["compute_dtype"]),
        param_dtype=torch.float32 if training else None)


def make_tagger(cell: Cell, tag_dict, training: bool, **tagger_kw):
    """The program's tagger, laid out on the meta device and filled with the
    run's seeded weights (no draw of its own)."""
    from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig

    model = cell.config["model"]
    tcfg = TaggerConfig.for_tag_dictionary(
        encoder_config(model, training), tag_dict,
        relearn_embeddings=cell.config["tagger"]["relearn_embeddings"],
        **tagger_kw)
    tagger = SequenceTagger(tcfg, device="meta").to_empty(device=cell.device)
    w = weights.make(model, len(tag_dict), cell.seed, cell.device)
    own = tagger.state_dict()
    if sorted(own) != sorted(w) or any(own[k].shape != w[k].shape
                                       for k in w):
        raise RuntimeError("the tagger's layout is not the configuration's")
    with torch.no_grad():
        for name, t in own.items():
            t.copy_(w[name])
    del w
    return tagger


def run(cell: Cell) -> dict:
    from kbner_tpu_torch import serve as serve_mod
    from kbner_tpu_torch.models import tagger as tagger_mod
    from kbner_tpu_torch.ops import bm25 as bm25_mod
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.pipeline import load_kb

    p, eng = cell.traffic, cell.config["engine"]
    kb_path, built = kb.ensure_saved_kb(cell.config["kb"], cell.cache)
    docs_dir = kb_path.parent
    marks = [("imports and the KB's files", time.perf_counter())]
    text_index, store, title_index, _ = load_kb(kb_path)
    marks.append(("load_kb", time.perf_counter()))
    engine = RetrievalEngine(text_index, store=store, title_index=title_index,
                             mode=eng["mode"], device=cell.device)
    marks.append(("engine", time.perf_counter()))
    tokenizer, tag_dict = tag_setup(cell)
    tagger = make_tagger(cell, tag_dict, training=False).eval()
    marks.append(("tagger", time.perf_counter()))
    reqs = traffic.backlog(p, cell.seed, kb.topic_model(cell.config["kb"],
                                                        docs_dir))
    marks.append(("backlog", time.perf_counter()))
    B = p["batch"]
    batches = [reqs[i:i + B] for i in range(0, len(reqs) - B + 1, B)]

    captured: List[tuple] = []
    fuse = serve_mod.fuse_contexts

    def capture(records, results, tok, **kw):
        out = fuse(records, results, tok, **kw)
        captured.append((results, out))
        return out

    def serve(batch, timings=None):
        return serve_mod.serve(batch, engine, tagger, tokenizer, tag_dict,
                               k=eng["k"], mode=eng["fusion"], batch_size=B,
                               timings=timings)

    n_warm = p["warmup_batches"]
    for b in batches[:n_warm]:
        serve(b)
    cell.sync()
    marks.append(("warm-up", time.perf_counter()))
    setup_s = time.perf_counter() - cell.t_start
    log_setup(cell, marks)

    # -- the window -----------------------------------------------------------
    serve_mod.fuse_contexts = capture
    stage: Dict[str, float] = {}
    lat, responses = [], []
    i = n_warm
    t0 = time.perf_counter()
    deadline = t0 + cell.seconds
    try:
        while time.perf_counter() < deadline:
            if i >= len(batches):
                raise RuntimeError("the backlog ran out inside the window")
            tb = time.perf_counter()
            responses.append(serve(batches[i], stage))
            lat.extend([(time.perf_counter() - tb) * 1e3]
                       * len(responses[-1]))
            i += 1
        window_s = time.perf_counter() - t0
    finally:
        serve_mod.fuse_contexts = fuse
    window = batches[n_warm:i]
    log(f"window: {len(window)} micro-batches of {B} in {window_s:.3f} s")

    ctx = {"setup_s": setup_s, "kb_built": built, "window_s": window_s,
           "sentences": sum(len(r) for r in responses),
           "latencies_ms": lat, "batches": len(window),
           "stage_s": stage}
    # the encoder's inputs as the window fed them: real subtokens per row
    lens = [reference.encoded_length(rec.tokens)
            for _, fused in captured for rec in fused]
    ctx["flops"] = forward_flops(cell.config["model"], len(tag_dict), lens)

    # -- the traced slice ---------------------------------------------------
    if cell.trace:
        shapes = []
        k1 = bm25_mod.bm25_score_block

        def k1_rec(qt, qw, dt, di):
            shapes.append((qt, qw, dt, di))
            return k1(qt, qw, dt, di)

        # the program counts launches on the name it calls K1 by: this
        k1_rec.launches = 0
        spans = [(engine, "search", "retrieve"),
                 (serve_mod, "fuse_contexts", "fuse"),
                 (serve_mod, "predict", "tag"),
                 (tagger_mod, "crf_decode", "crf_decode")]
        n_slice = p["trace_batches"]
        if i + 2 * n_slice > len(batches):
            raise RuntimeError("the backlog ran out before the traced slices")
        cursor = [i]

        def body():
            lo = cursor[0]
            cursor[0] += n_slice
            for b in batches[lo:lo + n_slice]:
                serve(b)
            return n_slice

        bm25_mod.bm25_score_block = k1_rec
        try:
            with wrapped(spans):
                ctx["trace"] = profile(body, cell.sync)
        finally:
            bm25_mod.bm25_score_block = k1
        nonpad = {}
        ctx["k1_launches"] = []
        for qt, qw, dt, di in shapes:
            key = (dt.data_ptr(), tuple(dt.shape))
            if key not in nonpad:
                nonpad[key] = int((dt >= 0).sum())
            ctx["k1_launches"].append(dict(
                Q=qt.shape[0], Lq=qt.shape[1], Ld=dt.shape[0], N=dt.shape[1],
                nonpad=nonpad[key]))
        del shapes

    ctx["device"] = device_info(cell)
    # -- free the program, then judge -----------------------------------------
    del engine, tagger, text_index, title_index
    store.close()
    del store
    gc.collect()
    if cell.device != "cpu":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sample = draw_sample(window, cell.seed)
    ctx["checks"] = judge(cell, docs_dir, window, responses, captured,
                          sample)
    ctx["attempted"] = ctx["sentences"]
    ctx["failed"] = sum(not well_formed(req, resp)
                        for batch, out in zip(window, responses)
                        for req, resp in zip(batch, out))
    log(f"reference: {len(sample)} requests judged in "
        f"{time.perf_counter() - t0:.1f} s")
    return ctx


def log_setup(cell: Cell, marks) -> None:
    """Seconds of each set-up phase, on standard error."""
    t, parts = cell.t_start, []
    for name, at in marks:
        parts.append(f"{name} {at - t:.2f}")
        t = at
    log("set-up s: " + ", ".join(parts))


def forward_flops(model: dict, n_tags: int, lens: List[int]) -> float:
    """Forward FLOPs the encoder's inputs need: ``2 N T + 4 L H sum S_b^2``
    (N the parameters outside the embeddings, T the real subtokens, S_b
    each row's real length)."""
    n = weights.non_embedding_params(model, n_tags)
    return float(2 * n * sum(lens) + 4 * model["num_hidden_layers"]
                 * model["hidden_size"] * sum(s * s for s in lens))


def device_info(cell: Cell) -> dict:
    if cell.device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


SAMPLE = 256  # requests judged a run: some thousands of tagged words
BLOCK = 16  # sentences the reference encodes at once


def draw_sample(window, seed: int):
    """``(batch, row)`` of ``SAMPLE`` window requests drawn from the
    seed, the longest sentence among them."""
    pos = [(b, r) for b, batch in enumerate(window)
           for r in range(len(batch))]
    longest = max(pos, key=lambda x: len(window[x[0]][x[1]]["tokens"]))
    rng = np.random.RandomState((seed + 1) % 2**32)
    rest = [x for x in pos if x != longest]
    pick = rng.choice(len(rest), size=min(SAMPLE - 1, len(rest)),
                      replace=False)
    return [longest] + [rest[j] for j in sorted(pick)]


def reference_tagger(cell: Cell, n_tags: int, quant=None):
    """The reference over the run's weights as served: the encoder's
    rounded to the configuration's storage dtype, the head in float32."""
    model = cell.config["model"]
    w = weights.make(model, n_tags, cell.seed, cell.device)
    store = getattr(torch, model["compute_dtype"])
    for name, t in w.items():
        if name.startswith("encoder."):
            w[name] = t.to(store).float()
    return reference.Tagger(w, model, n_tags - 2, n_tags - 1, quant=quant)


def well_formed(req: dict, resp: dict) -> bool:
    """A response to ``req``: its id and words, one known tag a word."""
    known = set(traffic.tag_list())
    return (resp.get("id") == req["id"] and resp["tokens"] == req["tokens"]
            and len(resp["tags"]) == len(req["tokens"])
            and all(t in known for t in resp["tags"]))


def judge(cell: Cell, docs_dir, window, responses, captured, sample):
    """The compared numbers over the sampled requests."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    eng, model = cell.config["engine"], cell.config["model"]
    docs = kb.docs(docs_dir)
    bm = reference.BM25(docs, cell.device)
    tags = traffic.tag_list()
    index = {t: j for j, t in enumerate(tags)}
    rank_gap = score_gap = 0.0
    fusion_bad = 0
    fused_ref, served = [], []
    for b, r in sample:
        req = window[b][r]
        results, fused = captured[b][0][r], captured[b][1][r]
        scores = bm.scores(" ".join(req["tokens"]))
        ref_ids, ref_top = bm.topk(scores, eng["k"])
        got = [d.doc_id for d in results]
        rank_gap = max(rank_gap, retrieval_gap(got, scores, ref_top))
        for d in results:
            s = float(scores[d.doc_id])
            score_gap = max(score_gap, abs(d.score - s) / max(s, 1e-30))
        ref = reference.fuse(req["tokens"], [docs[d] for d in got],
                             eng["budget"])
        fusion_bad += int(list(fused.tokens) != ref)
        fused_ref.append(ref)
        resp = responses[b][r]
        served.append([index[t] for t in resp["tags"]]
                      if well_formed(req, resp) else None)
    del bm
    gap = viterbi_gaps(cell, fused_ref, served, len(tags) + 2)
    checks = {"retrieval_rank_gap": rank_gap,
              "retrieval_score_gap": score_gap,
              "fusion_mismatches": float(fusion_bad),
              "viterbi_gap": max(gap)}
    return checks


def retrieval_gap(got: List[int], scores: torch.Tensor, ref_top) -> float:
    """How far the returned list falls from the exact top k, as a share of
    the exact k-th score: a returned document below the cut, a document
    out of order, a duplicate or a wrong count reads 1 or its distance."""
    if len(got) != len(ref_top) or len(set(got)) != len(got):
        return 1.0
    if not len(got):
        return 0.0
    kth = float(ref_top[-1])
    s = scores[torch.as_tensor(got, device=scores.device)].cpu().numpy()
    below = max(0.0, float((kth - s).max()) / kth)
    order = max(0.0, float(np.diff(s).max()) / kth) if len(s) > 1 else 0.0
    return max(below, order)


def viterbi_gaps(cell: Cell, fused, served, n_tags: int, quant=None
                 ) -> List[float]:
    """Per sampled sentence, the reference's best path score less the
    score of the served path (``served`` None: infinity). With ``quant``,
    the served path is instead the Viterbi path of the reference computed
    in that precision (the control)."""
    ref = reference_tagger(cell, n_tags)
    low = reference_tagger(cell, n_tags, quant) if quant else None
    vocab = cell.config["model"]["vocab_size"]
    out = []
    with torch.no_grad():
        for lo in range(0, len(fused), BLOCK):
            part = fused[lo:lo + BLOCK]
            enc = {k: torch.from_numpy(v).to(cell.device)
                   for k, v in reference.encode(part, vocab).items()}
            args = (enc["input_ids"], enc["attention_mask"],
                    enc["word_starts"], enc["word_mask"])
            em = ref.emissions(ref.features(*args))
            em_low = low.emissions(low.features(*args)) if low else None
            for j in range(len(part)):
                n = int(enc["n_words"][j])
                _, best = ref.viterbi(em[j], n)
                path = (low.viterbi(em_low[j], n)[0] if low
                        else served[lo + j])
                out.append(float("inf") if path is None
                           else best - ref.path_score(em[j, :n], path))
    return out
