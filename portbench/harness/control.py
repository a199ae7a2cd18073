"""The controls and planted faults that the limits are set against.

The control is the reference put in the program's place and computed one
precision below the configuration's bfloat16 (float8 e4m3 matmuls,
``reference.Tagger(quant="fp8")``), read with the same comparison as a
run, at the cell's own sizes and seeds:

- a serve cell: over the requests of the first ``WINDOW_BATCHES``
  micro-batches after the warm-up (a run's window), the same sample that a
  run draws: the control's retrieval (BM25 over impacts rounded to
  bfloat16, one precision below the index's float32, summed in float32)
  against the float64 reference; then, retrieved and fused by the
  reference, the gap of the control's Viterbi path under the float32
  reference;
- a fine-tuning cell: the control's first steps against the float32
  reference's, and a planted fault (each batch's loss taken over its first
  half only) the same way.

    python3 -m portbench.harness.control --workload <cell> --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import kb, reference, traffic
from .cell import make_cell, manifest
from .kinds import finetune_fused, serve_backlog


WINDOW_BATCHES = 150  # about a window's micro-batches at run_seconds


def serve_control(cell) -> dict:
    p, eng = cell.traffic, cell.config["engine"]
    d = kb.ensure_docs(cell.config["kb"], cell.cache)
    reqs = traffic.backlog(p, cell.seed, kb.topic_model(cell.config["kb"], d))
    B, w = p["batch"], p["warmup_batches"]
    window = [reqs[i:i + B] for i in range(w * B, (w + WINDOW_BATCHES) * B,
                                            B)]
    sample = serve_backlog.draw_sample(window, cell.seed)
    docs = kb.docs(d)
    bm = reference.BM25(docs, cell.device)
    fused = []
    rank_gap = score_gap = 0.0
    for b, r in sample:
        toks = window[b][r]["tokens"]
        scores = bm.scores(" ".join(toks))
        ids, top = bm.topk(scores, eng["k"])
        fused.append(reference.fuse(toks, [docs[i] for i in ids],
                                    eng["budget"]))
        low = bm.scores(" ".join(toks), low=True)
        low_ids, low_top = bm.topk(low, eng["k"])
        rank_gap = max(rank_gap, serve_backlog.retrieval_gap(
            low_ids.tolist(), scores, top))
        ref = scores[torch.as_tensor(low_ids, device=scores.device)]
        score_gap = max(score_gap, float(
            ((torch.as_tensor(low_top, device=ref.device) - ref).abs()
             / ref).max()) if len(low_ids) else 0.0)
    del bm
    gaps = serve_backlog.viterbi_gaps(cell, fused, None,
                                      len(traffic.tag_list()) + 2,
                                      quant="fp8")
    return {"retrieval_rank_gap": rank_gap, "retrieval_score_gap": score_gap,
            "viterbi_gap": max(gaps)}


def train_control(cell) -> dict:
    p = cell.traffic
    d = kb.ensure_docs(cell.config["kb"], cell.cache)
    raw = traffic.fused_records(p, cell.seed,
                                kb.topic_model(cell.config["kb"], d))
    groups = finetune_fused.batch_rows(p, cell.seed)
    ref = finetune_fused.reference_steps(cell, raw, groups)
    out = {}
    for label, kw in (("fp8", {"quant": "fp8"}), ("half_batch",
                                                   {"half": True})):
        low = finetune_fused.reference_steps(cell, raw, groups, **kw)
        out[label] = finetune_fused.compare(low, ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    bench = manifest()
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        cell = make_cell(bench, args.workload, seed, 0.0, False, t0)
        fn = (serve_control if cell.traffic["kind"] == "serve_backlog"
              else train_control)
        out = fn(cell)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
