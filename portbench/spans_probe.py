"""A probe of the program's spans (``kbner_tpu_torch/utils/spans.py``) at
a cell's size; not one of the benchmark's cells, and no metric reads it.

    python3 portbench/spans_probe.py --workload large.serve.exh \
        --seed <n> [--blocks 6 --block 20] [--out DIR] [--tiny]

It sets the cell up as the cell's kind does, then serves micro-batches (or
takes steps) in blocks, each block twice over the same units, once with
the spans off and once on, which first alternating: the host ms per unit
both ways (the cost of tracing) and, from the blocks with the spans on,
each span's host ms per unit, the counts, and how much of each parent its
children cover. Last, one slice with the spans on under
``torch.profiler`` (CPU and CUDA): the device ms under each ``kbner.*``
range, the idle gaps named by the innermost ``kbner.*`` span open at
their midpoint (the ranges' own annotations on the device are not work),
and what the benchmark's ``Trace`` reads from the same events. It prints
a summary line, and with ``--out DIR`` writes the whole result to
``DIR/<cell>-<seed>.json``.
``--tiny`` runs ``tests/bench_tiny.py``'s sizes on the CPU, as a rehearsal.
"""

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

T0 = time.perf_counter()
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, record_function  # noqa: E402

from kbner_tpu_torch.utils import spans  # noqa: E402
from portbench.harness import cell as cells, kb, traffic  # noqa: E402
from portbench.harness import trace as bench_trace  # noqa: E402

SLICE = "probe.slice"


def log(*a):
    print(f"[{time.perf_counter() - T0:8.1f}s]", *a, file=sys.stderr,
          flush=True)


def make(workload, seed, tiny):
    if tiny:
        sys.path.insert(0, str(REPO / "portbench" / "tests"))
        import bench_tiny
        _, c = bench_tiny.make(workload, REPO / "portbench" / ".cache" /
                               "tiny", seed=seed)
        return c
    bench = cells.manifest()
    return cells.make_cell(bench, workload, seed, 0.0, True,
                           time.perf_counter(), device="cuda")


def sync(cell):
    if cell.device != "cpu":
        torch.cuda.synchronize()


# -- the units --------------------------------------------------------------

def serve_units(cell):
    from kbner_tpu_torch import serve as serve_mod
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.pipeline import load_kb
    from portbench.harness.kinds.serve_backlog import make_tagger, tag_setup

    p, eng = cell.traffic, cell.config["engine"]
    kb_path, _ = kb.ensure_saved_kb(cell.config["kb"], cell.cache)
    text_index, store, title_index, _ = load_kb(kb_path)
    engine = RetrievalEngine(text_index, store=store, title_index=title_index,
                             mode=eng["mode"], device=cell.device)
    tokenizer, tag_dict = tag_setup(cell)
    tagger = make_tagger(cell, tag_dict, training=False).eval()
    reqs = traffic.backlog(p, cell.seed, kb.topic_model(cell.config["kb"],
                                                        kb_path.parent))
    B = p["batch"]
    batches = [reqs[i:i + B] for i in range(0, len(reqs) - B + 1, B)]
    cursor = [0]

    def unit(stage=None):
        b = batches[cursor[0] % len(batches)]
        cursor[0] += 1
        return serve_mod.serve(b, engine, tagger, tokenizer, tag_dict,
                               k=eng["k"], mode=eng["fusion"], batch_size=B,
                               timings=stage)

    return unit, p["warmup_batches"], cursor


def train_units(cell):
    from kbner_tpu_torch.data.conll import Corpus, ListCorpus, SentenceRecord
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
    from portbench.harness.kinds.finetune_fused import batch_rows
    from portbench.harness.kinds.serve_backlog import make_tagger, tag_setup

    p = cell.traffic
    d = kb.ensure_docs(cell.config["kb"], cell.cache)
    raw = traffic.fused_records(p, cell.seed,
                                kb.topic_model(cell.config["kb"], d))
    records = [SentenceRecord(tokens=t, tags={"ner": g}) for t, g in raw]
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
    batches = [encode_batch([records[j] for j in g], tokenizer, tag_dict,
                            max_subtokens=p["max_subtokens"])
               for g in batch_rows(p, cell.seed)]
    rng = torch.Generator().manual_seed(cell.seed)
    cursor = [0]

    def unit(stage=None):
        eb = batches[cursor[0] % len(batches)]
        cursor[0] += 1
        return float(trainer.train_step(eb, opt, config, rng))

    return unit, p["check_steps"] + p["warmup_steps"], cursor


# -- reductions -------------------------------------------------------------

def tree(blocks, units):
    """Per name: ms per unit; coverage of each parent by its children
    (``blocks``: lists from ``spans.collect()``, parents index their own)."""
    ms = defaultdict(float)
    counts = defaultdict(lambda: defaultdict(int))
    cover = defaultdict(list)
    for kept in blocks:
        kids = defaultdict(float)
        for s in kept:
            ms[s.name] += (s.end - s.start) / 1e6
            for k, v in s.counts.items():
                counts[s.name][k] += v
            if s.parent is not None:
                kids[s.parent] += s.end - s.start
        for i, c in kids.items():
            s = kept[i]
            cover[s.name].append(c / max(s.end - s.start, 1))
    return ({n: v / units for n, v in ms.items()},
            {n: dict(c) for n, c in counts.items()},
            {n: {"share": sum(v) / len(v), "min": min(v), "n": len(v)}
             for n, v in cover.items()})


def paired(off, on):
    """On less off over the same units: mean, its standard error, and the
    share of the off mean."""
    d = [b - a for a, b in zip(off, on)]
    m = statistics.mean(d)
    se = statistics.stdev(d) / len(d) ** 0.5
    return {"mean": m, "se": se, "share": m / statistics.mean(off),
            "median": statistics.median(d)}


def merged(intervals):
    out = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def is_annotation(e):
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith(("kbner.", "portbench.", "probe.")))


class Innermost:
    def __init__(self, events):
        rows = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in events)
        self.starts = [r[0] for r in rows]
        self.rows = rows

    def at(self, t, look=4000):
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(i - 1 - look, -1), -1):
            if self.rows[j][1] >= t:
                return self.rows[j][2]
        return None


def device_reduce(events, units, window_s):
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    dev_all = [e for e in events if e.device_type != DeviceType.CPU]
    dev = [e for e in dev_all if not is_annotation(e)]
    outer = [e for e in cpu if e.name == SLICE]
    lo, hi = outer[0].time_range.start, outer[0].time_range.end
    under = defaultdict(float)
    for e in cpu:
        if e.name.startswith("kbner."):
            under[e.name] += e.device_time_total / 1e3
    # autograd runs the backward on a thread of its own, outside the
    # main thread's ranges: its ops' own device time within each
    # kbner.train.backward interval
    main = outer[0].thread
    bwd = sorted((e.time_range.start, e.time_range.end) for e in cpu
                 if e.name == "kbner.train.backward")
    other = 0.0
    for e in cpu:
        if e.thread != main and not is_annotation(e) and any(
                a <= e.time_range.start <= b for a, b in bwd):
            other += getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
    under["autograd thread within kbner.train.backward"] = other / 1e3
    under["all device ops"] = sum(e.time_range.elapsed_us()
                                  for e in dev) / 1e3
    busy = merged((max(e.time_range.start, lo), min(e.time_range.end, hi))
                  for e in dev)
    busy_ann = merged((max(e.time_range.start, lo),
                       min(e.time_range.end, hi)) for e in dev_all)
    gaps, last = [], lo
    for a, b in busy + [[hi, hi]]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    named = Innermost(e for e in cpu if e.name.startswith("kbner."))
    ops = Innermost(e for e in cpu if not is_annotation(e)
                    and e.name != SLICE)
    by = defaultdict(float)
    by_span = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        sp, op = named.at(mid), ops.at(mid)
        name = sp or "outside kbner spans"
        by_span[name] += (b - a) / 1e6
        if op is not None:
            name += " / " + op
        by[name] += (b - a) / 1e6
    idle = sum(b - a for a, b in gaps) / 1e6
    span_s = (hi - lo) / 1e6
    return {
        "device_ms_under": {n: v / units for n, v in under.items()},
        "threads": sorted({e.thread for e in cpu}),
        "slice_s": span_s, "window_s": window_s,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "busy_s_counting_annotations": sum(b - a for a, b in busy_ann) / 1e6,
        "idle_s": idle,
        "idle_by_span": dict(sorted(by_span.items(), key=lambda x: -x[1])),
        "idle_gaps_top": sorted(by.items(), key=lambda x: -x[1])[:25],
        "annotation_events_on_device": sorted({e.name for e in dev_all
                                               if is_annotation(e)})[:40],
    }


def bench_trace_reading(events, units, window_s):
    """What the benchmark's Trace (as it stands) reads from a slice in
    which the program's spans were on."""
    tr = bench_trace.Trace([e for e in events], window_s, events, units)
    return {"busy_s": tr.busy_s, "gaps": sorted(tr.gaps.items(),
                                                key=lambda x: -x[1])[:10]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--block", type=int, default=20)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    if args.tiny:
        torch.set_num_threads(2)
    cell = make(args.workload, args.seed, args.tiny)
    serve_kind = cell.traffic["kind"] == "serve_backlog"
    unit, n_warm, cursor = (serve_units if serve_kind else train_units)(cell)
    for _ in range(n_warm):
        unit()
    sync(cell)
    log(f"{args.workload}: set-up {time.perf_counter() - T0:.1f} s")

    off_ms, on_ms, kept_all = [], [], []
    stage = {"off": {}, "on": {}}
    n_on = 0
    for r in range(args.blocks):
        start = cursor[0]
        # the same units off and on, which first alternating
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            cursor[0] = start
            if mode == "on":
                spans.enable()
            for _ in range(args.block):
                t = time.perf_counter()
                unit(stage[mode] if serve_kind else None)
                (off_ms if mode == "off" else on_ms).append(
                    (time.perf_counter() - t) * 1e3)
            if mode == "on":
                spans.disable()
                kept_all.append(spans.collect())
                n_on += args.block
    sync(cell)
    n_off = args.blocks * args.block
    per_name, counts, cover = tree(kept_all, n_on)
    res = {
        "workload": args.workload, "seed": args.seed,
        "device": (torch.cuda.get_device_name(0) if cell.device != "cpu"
                   else "cpu"),
        "units_off": n_off, "units_on": n_on,
        "off_ms_mean": statistics.mean(off_ms),
        "on_ms_mean": statistics.mean(on_ms),
        "off_ms_median": statistics.median(off_ms),
        "on_ms_median": statistics.median(on_ms),
        "off_block_means": [statistics.mean(off_ms[i:i + args.block])
                            for i in range(0, n_off, args.block)],
        "on_block_means": [statistics.mean(on_ms[i:i + args.block])
                           for i in range(0, n_on, args.block)],
        "spans_per_unit": sum(map(len, kept_all)) / n_on,
        "paired_ms": paired(off_ms, on_ms),
        "span_ms_per_unit": per_name, "counts": counts, "coverage": cover,
        "stage_ms": {m: {k: v * 1e3 / n_off for k, v in st.items()}
                     for m, st in stage.items()},
    }
    enc = counts.get("kbner.tag.encode") or counts.get("kbner.train.upload")
    if enc:
        res["pad_pct"] = 100 * (1 - enc["subtokens"] / enc["slots"])
    del kept_all
    gc.collect()

    # the profiled slice, spans on
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cell.device != "cpu" else [])
    sync(cell)
    with torch.profiler.profile(activities=acts) as prof:
        spans.enable()
        with record_function(SLICE):
            t = time.perf_counter()
            for _ in range(args.block):
                unit()
            sync(cell)
            window_s = time.perf_counter() - t
        spans.disable()
    kept = spans.collect()
    res["profiled_spans_ms_per_unit"] = tree([kept], args.block)[0]
    events = prof.events()
    res["profiled"] = device_reduce(events, args.block, window_s)
    res["bench_trace_with_spans_on"] = bench_trace_reading(
        events, args.block, window_s)
    if cell.device != "cpu":
        res["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / f"{args.workload}-{args.seed}.json").write_text(
            json.dumps(res, indent=1, default=str))
    short = {k: res[k] for k in ("workload", "seed", "off_ms_mean",
                                 "on_ms_mean", "paired_ms", "off_block_means",
                                 "on_block_means", "spans_per_unit",
                                 "coverage")}
    short["pad_pct"] = res.get("pad_pct")
    short["span_ms"] = {k: round(v, 3) for k, v in per_name.items()}
    short["dev_ms"] = {k: round(v, 3) for k, v in
                       res["profiled"]["device_ms_under"].items()}
    short["idle_by_span"] = res["profiled"]["idle_by_span"]
    short["busy"] = [res["profiled"]["busy_s"],
                     res["profiled"]["busy_s_counting_annotations"],
                     res["profiled"]["slice_s"]]
    short["bench_trace"] = res["bench_trace_with_spans_on"]
    print(json.dumps(short, default=str))
    log(f"done in {time.perf_counter() - T0:.1f} s")


if __name__ == "__main__":
    main()
