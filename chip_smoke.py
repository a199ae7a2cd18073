#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``kbner_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``kbner_tpu_torch/csrc`` with
``nvcc`` (one compiler per source, started together), holds each against
its plain PyTorch version on the card, and then serves retrieval-augmented
NER through ``kbner_tpu_torch.serve.serve`` twice over 1M synthetic wiki
sentences held on the card, each with a title field as ``cli serve``
builds it: with the exhaustive engine (K1, ``bm25_score.cu``) and with the
pruned engine (K2, ``delta16_rescore.cu``), each followed by context
fusion and an XLM-R-large + CRF tagger at full width and depth (random
weights from a seed, bfloat16, a 250002-entry hash vocabulary). The pruned
top-10 is held against the exhaustive one. Then the same queries go
through entity-boosted retrieval (the title field) in both engines,
through a pruned engine over packed32 rows, and through the two-operand
pruned top-k over a two-array field (K3, ``bm25_rescore.cu``), each held
against exhaustive. Each kernel is timed at the shape its path gives it
twice: eager (back-to-back wrapper calls between CUDA events, which can
read the host's enqueue rate) and on the device (the calls captured in a
CUDA graph and replayed between CUDA events, with their operands warm in
L2); K2 and K3 also one call at a time after the L2 cache is cleared, and
beside an empty kernel on their grid (the launch floor). Last comes the
training path: XLM-R large + CRF (float32 master parameters, bfloat16
compute) fine-tuned through ``FinetuneTrainer.train`` on quality-corpus
sentences fused with the exhaustive engine's contexts, once with the
recipe's batch 1 and accumulation 4 and once at batch 16 for three epochs;
the best checkpoint is then served through the serve path in bfloat16 and
held to the trainer's own prediction. Then the offline KB stage runs
through the CLI: a dump ingested, a twentieth of the KB indexed from JSONL
and held to the in-memory index, the KB saved and reopened, the native
host runtime (``kbner_tpu_torch/native``, built with g++) held to its
numpy twins on an eighth of the KB and the pruned engine built both
ways, four ``cli retrieve`` runs over CoNLL splits, the native analyzer
held to the Python one on 5,000 multilingual sentences, a 25,000-doc zh
KB indexed with IK and searched both ways, deep pass-1 windows held
against the plain pruned engine, retrieval with the trained model's seeds and
BERTScore reranking, and ``cli serve`` from the saved KB. Last, the MIX
track: a ru KB beside the en and zh ones, ``cli retrieve --route mix``
through one MixEngine over the three (K2 once per language and batch, on
global ids), held to the per-engine fan-out and, for recall, to the
exhaustive fan-out (K1), then with entity clauses; and ``cli multistage``
of two stages, the second starting from the first's exported encoder.
This stage and every later one train XLM-R large's width cut to
``CUT_LAYERS`` of its 24 layers. Last, the recipe's ACE step: ``cli
train`` with ``trainer: ReinforcementTrainer`` over the published stack
(XLM-R frozen, word vectors, a char-BiLSTM and two Flair char-LMs) on KB
sentences fused through K1, the stack held between the card and the CPU,
and ``cli ensemble``, ``evaluate`` and ``speed``. Last, knowledge
distillation: KB sentences in documents fused through K1, two XLM-R
teachers trained by ``cli train`` (one with stride windows, one with
document windows and transition attention), four students distilled from
them per language (float16 and float32 caches, lazy teachers, k-best
paths), ``cli parse`` of a student and SWAF over three systems' test
files. Last, the collection-scale index and pretrained weights: the 1M
docs stream-built in four chunks and held to the one-shot index, saved in
shards and reopened, and served once through an exhaustive (K1) and a
pruned (K2) engine held to the first engines and to the float64 oracle;
then an HF checkpoint of a seeded encoder (XLM-R large's width at
``CUT_LAYERS`` layers) loaded onto the card bit for bit, and ``cli
parity`` over MultiCoNER-layout folders from it. Last, the parser and
classifier families: a seeded UD treebank, KB sentences fused through K1
and fastText documents through ``cli train``, ``test`` and (for the tree
parser) ``parse`` under ``targets: dependency`` (with the projective
tree CRF), ``enhancedud``, ``ner_dp``, ``classification`` (GRU pooling)
and ``regression``, with a float32 parser held between the card and the
CPU, the tree CRF's marginals held to float64 and a learning probe. Last,
the ACE stack's ELMo and BPEmb members at their published widths (the
5.5B ELMo's cell 4096, projection 512 and 2,048 filters; BPEmb's 50 x
100,000) from seeded weight files: ``cli train`` with the ACE trainer
over the six-member stack and ``cli test`` on it, one step split by
member, ELMo's features and a pooled Flair table held between the card
and the CPU, and the MFVI head's loss, gradients and decode over XLM-R
word features held the same way. Last, the sharded retrieval engine:
two gloo ranks on the card (NCCL refuses two ranks on one card), each
opening the saved 1M KB and holding its shard of a meshed exhaustive
(K1) and a meshed pruned (K2) engine, serve two batches whose merged
top-10 is held to the unsharded engines' on every rank; then the pruned
engine's pass-1 top-C taken approximately (``topc_recall``) at a C that
XLA's formula reduces, held to the exact top-C's recall. Last, sharded
training on two gloo ranks on the card, XLM-R large's width at
``CUT_LAYERS`` layers: ``FinetuneTrainer.train`` data-parallel over 4g's
fused records with ``checkpoint: true``, one tensor-parallel step and
one FSDP step (``parallel.shard_params``), each held to a single-rank
trainer on the same global batches, and the data-parallel run's
``checkpoint.msgpack`` and ``best-model.msgpack`` reopened unsharded and
held to the ranks' gathered state bit for bit. Right after the HF
tokenizer's phase comes the last of ``kbner_tpu``'s public surface: the
tagger's, the parser's and the classifier's quality gates trained on the
card to the reference's bars, the port's walkthrough
(``examples/end_to_end_torch.py``) on the card through K1 held to the
same run on the CPU, and ``SGDW`` steps over the trained XLM-R-large
checkpoint's float32 parameters held to the same steps on the CPU. It
prints what it measured on the lines before the last and exits non-zero
on any failure.
Its last line is one JSON object naming the device.

It needs CUDA and the rest of the repository beside it: without either it
fails before printing a result.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# main-path sizes
N_DOCS = 1_000_000      # synthetic wiki sentences in the index
N_TOPICS = 20_000       # wiki pages: about 50 sentences each
BATCH = 32              # serve micro-batch (cli serve --batch_size default)
N_BATCHES = 4
K = 10                  # retrieved contexts per sentence (cli serve --k)
MAX_QUERY_TERMS = 64    # Lq of the kernel (encode_queries default)
HASH_VOCAB = 250002     # XLM-R's vocabulary size
DEVICE = "cuda"
KERNELS = ("bm25_score", "delta16_rescore",
           "bm25_rescore")  # csrc/<name>.cu
# the pruned engine's knobs as bench.py tunes them (bench.py:381-389)
PRUNED_KNOBS = dict(rare_terms=16, posting_budget=6144, n_candidates=1024,
                    tiny_width=384, tiny_pack=False, tiny_df_cap=128,
                    tiny_cols_floor=512, d16_width_floor=32)
MIN_RECALL = 0.9        # pruned top-10 against the exhaustive top-10
SCORE_RTOL = 1e-2       # delta16 saturates tf > 7; f16 tiny sums

# the H100 SXM rates the bound is taken against: HBM bytes/s from NVIDIA's
# data sheet, and int32 operations/s on the CUDA cores. The data sheet's
# 67 TFLOP/s float32 counts an FMA as two operations on 128 float32 lanes
# per SM; Hopper's SM has 64 int32 lanes (NVIDIA H100 architecture
# whitepaper), so int32 issues at 67e12 / 4 operations/s.
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 67e12 / 4

# K1, K2 and K3 against their plain versions: float32 sums in another
# order (K3 also expf against torch.exp, each within an ulp)
RTOL, ATOL = 1e-5, 1e-6
L2_FLUSH_BYTES = 256 << 20  # read before a cold call: 5x the H100's 50 MB L2
TITLE_BOOST = 2.0       # ES match(title=entity, boost=2.0)
WRAPPERS = ("bm25_score_block", "delta16_rescore", "bm25_rescore")

NER_TAGS = [f"{p}-{t}" for t in ("PER", "LOC", "ORG", "MISC")
            for p in ("B", "I", "E", "S")]


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_line() -> str:
    """The host CPU as /proc/cpuinfo names it (model name, vendor,
    family/model/stepping, MHz) and its core count: the host-clock
    figures of phase 4h are the host's. The model name alone can read
    "unknown" in a virtual machine; the other fields still tell hosts
    apart."""
    import os

    keys = ("model name", "vendor_id", "cpu family", "model", "stepping",
            "cpu MHz", "bogomips")
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                key = key.strip()
                if key in keys and key not in info:
                    info[key] = value.strip()
                if not line.strip() and info:
                    break
    except OSError:
        pass
    return (f"{info.get('model name', 'unknown')} ("
            + ", ".join(f"{k} {info[k]}" for k in keys[1:] if k in info)
            + f"), {os.cpu_count()} cores")


def time_cuda_ms(fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls, from CUDA
    events, after one warm-up call (the eager timer). The host enqueues
    each call while the events run, so for a call shorter than its
    wrapper's host work this reads the enqueue rate, not the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_device_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls that run back to
    back on the card, free of the host's enqueue rate: the calls are
    captured in a CUDA graph (the wrappers launch on the current stream,
    which is the capture stream, and allocate from the graph's pool) and
    the graph is replayed between CUDA events. One warm-up call first, so
    the kernel's library is loaded before capture. The capture runs in
    relaxed mode, so the host-side CUDA calls a launcher makes on each call
    (K1's queries the device and sets a kernel attribute) are not checked
    against it."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def floor_ms(_kernels, name: str, sizes) -> float:
    """Device time (:func:`time_device_ms`, 200 calls) of the empty kernel
    that ``csrc/<name>.cu`` launches on its kernel's grid, block and shared
    memory at these sizes: the least a launch of the kernel can take."""
    import ctypes

    import torch

    fn = getattr(_kernels.load(name), f"{name}_floor_launch")
    fn.argtypes = [ctypes.c_int] * len(sizes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch():
        err = fn(*sizes, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name}_floor_launch: CUDA error {err}")

    return time_device_ms(launch, iters=200)


def time_cold_ms(fn, reps: int = 20) -> float:
    """Median device time of one call of ``fn`` with its operands out of
    L2: a sum over a 256 MB buffer evicts them, and then one call,
    captured in a CUDA graph, replays between CUDA events. The sum is
    still running on the card when the host enqueues the replay, so the
    events time the call and not the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                       device="cuda")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.sum()
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def assert_same_topk(got, want, k: int) -> None:
    """Top-k of two score matrices agree: equal k-th scores within the
    tolerance, and equal id sets above the k-th score (ties at the k-th
    score may be broken either way)."""
    import torch

    gs, gi = torch.topk(got, k, dim=1)
    ws, wi = torch.topk(want, k, dim=1)
    torch.testing.assert_close(gs, ws, rtol=RTOL, atol=ATOL)
    kth = torch.minimum(gs[:, -1:], ws[:, -1:])
    for q in range(got.shape[0]):
        above = kth[q, 0] + ATOL + RTOL * kth[q, 0].abs()
        a = set(gi[q][gs[q] > above].tolist())
        b = set(wi[q][ws[q] > above].tolist())
        if a != b:
            raise AssertionError(f"query {q}: top-{k} ids differ: "
                                 f"{sorted(a ^ b)}")


# K2's edge cases: (Q, C, kind, long_doc). Kind None is the random rows of
# synth_rescore_operands (with a segment over 128 slots, R2 = 2, where
# long_doc is set); every other kind is one of synth_k2_operands'
D16_CASES = (
    (5, 300, None, 0),          # ragged Q and C
    (8, 128, None, 140),        # a segment over 128 slots: R2 = 2
    (3, 77, None, 140),
    (32, 1024, None, 0),        # the serve shape
    (32, 1024, "collide", 0),   # ids on one hash slot
    (32, 1024, "repeat", 0),    # a term in 4 query slots, two build chunks
    (8, 128, "wide", 0),        # W = 256
    (2, 64, "max_terms", 0),    # W = 6144: over 48 KB of shared memory
    (5, 300, "unaligned", 0),   # segments at odd offsets, R2 = 3
    (32, 1024, "max_gap", 0),   # gaps of 8190, 8191, 8192, 16382, ...
)


def check_delta16_cases(bm25, synth, device) -> float:
    """K2 against its plain version on :data:`D16_CASES`: rows with
    continuation slots, invalid candidates at id 0, -1 query pads, and the
    kernel's traps. Returns the largest absolute difference."""
    import torch

    worst = 0.0
    for Q, C, kind, long_doc in D16_CASES:
        if kind is None:
            ops = synth.synth_rescore_operands(Q + C, Q, C, long_doc=long_doc)
            want_r2 = 2 if long_doc else 1
        else:
            ops = synth.synth_k2_operands(Q + C, Q, C, kind)
            want_r2 = 3 if kind == "unaligned" else 1
        qt, qw, cand, flat, off, lens, nc, k1, b, avgdl, r2 = ops
        if r2 != want_r2:
            raise AssertionError(f"K2 case {(Q, C, kind)}: expected "
                                 f"R2={want_r2}, got {r2}")
        ops = [torch.from_numpy(x).to(device)
               for x in (qt, qw, cand, flat.view(np.int16), off, lens, nc)]
        got = bm25.delta16_rescore(*ops, k1, b, avgdl, r2)
        want = bm25.delta16_rescore_ref(*ops, k1, b, avgdl, r2)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        if not bool((want > 0).any()):
            raise AssertionError(f"K2 case {(Q, C, kind)} matched no query "
                                 "term")
        worst = max(worst, float((got - want).abs().max()))
    return worst


# K1's edge cases: (Q, Lq, Ld, N, doc-axis offset into a wider array, kind
# of operands: "random" puts weights and impacts under -1 pads on both
# sides, every other kind is one of synth_k1_operands')
K1_CASES = (
    (5, 7, 9, 1000, 0, "random"),       # ragged in both block dimensions
    (33, 70, 52, 4099, 0, "random"),    # two query tiles, two term tiles
    (1, 1, 1, 1, 0, "random"),
    (64, 64, 3, 257, 131, "random"),    # a doc-axis slice
    (4, 64, 52, 3000, 0, "big_ids"),    # ids near 2^31 - 1
    (32, 64, 52, 3000, 0, "collide"),   # ids on one hash slot / low bits
    (32, 64, 52, 3000, 0, "shared"),    # one term in every query slot
    (32, 64, 52, 3000, 0, "repeat"),    # a term repeated within a query
    (32, 130, 52, 3000, 0, "index"),    # Lq = 130: three term tiles
    (33, 64, 52, 3000, 0, "index"),     # Q = 33: two query tiles
    (32, 64, 52, 4099, 1, "index"),     # slices unaligned for 16-byte
    (32, 64, 52, 4099, 2, "repeat"),    # copies, N not a multiple of 4
    (32, 64, 52, 4099, 3, "index"),
    (32, 64, 52, 100, 0, "index"),      # N smaller than one doc tile
    (32, 64, 2, 5000, 0, "index"),      # the title field's Ld
)


def check_kernel_cases(bm25, synth_k1_operands, device) -> float:
    """K1 against its plain version on :data:`K1_CASES`. Returns the
    largest absolute difference."""
    import torch

    rng = np.random.RandomState(0)
    worst = 0.0
    for Q, Lq, Ld, N, off, kind in K1_CASES:
        if kind == "random":
            qt = rng.randint(-2, 40, size=(Q, Lq)).astype(np.int32)
            qt[:, -1] = -1
            qw = rng.rand(Q, Lq).astype(np.float32)
            dt = rng.randint(-1, 40, size=(Ld, N + off)).astype(np.int32)
            di = rng.rand(Ld, N + off).astype(np.float32)
        else:
            qt, qw, dt, di = synth_k1_operands(Q + N + off, Q, Lq, Ld,
                                               N + off, kind)
        ops = [torch.from_numpy(x).to(device) for x in (qt, qw, dt, di)]
        ops[2], ops[3] = ops[2][:, off:], ops[3][:, off:]
        got = bm25.bm25_score_block(*ops)
        want = bm25.bm25_score_block_ref(*ops)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        if kind != "random" and not bool((want > 0).any()):
            raise AssertionError(f"K1 case {(Q, Lq, Ld, N, off, kind)} "
                                 "matched no query term")
        worst = max(worst, float((got - want).abs().max()))
    return worst


# K3's edge cases: (Q, C, Lq, Ld, kind of synth_k3_operands, vocab)
K3_CASES = (
    (5, 300, 12, 20, "random", 40),     # ragged Q and C
    (5, 300, 64, 52, "random", 40),
    (3, 77, 1, 130, "random", 40),      # three passes over a row
    (2, 64, 64, 1, "random", 40),
    (1, 1, 1, 1, "random", 40),
    (32, 1024, 64, 52, "random", 40),   # the serve shape
    (32, 1024, 64, 52, "collide", 40),  # ids on one hash slot
    (32, 1024, 64, 52, "pads", 40),     # -1 query slots meet coded pads
    (5, 300, 12, 13, "pads", 40),       # Ld = 13: rows not 16-byte wide
    (2, 64, 6144, 52, "random", 20000),  # Lq = 6144: over 48 KB shared
)


def check_rescore_cases(bm25, synth_k3_operands, device) -> float:
    """K3 against its plain version on :data:`K3_CASES`: codes 0 and
    65535, candidates at id 0 and N - 1, a repeated query term, -1 pads on
    both sides under nonzero codes, and the kernel's traps. Returns the
    largest absolute difference."""
    import torch

    worst = 0.0
    for Q, C, Lq, Ld, kind, vocab in K3_CASES:
        qt, qw, cand, dt, codes, lo, step = synth_k3_operands(
            Q + C + Ld, Q, C, Lq, Ld, vocab=vocab, kind=kind)
        ops = [torch.from_numpy(x).to(device)
               for x in (qt, qw, cand, dt, codes.view(np.int16))]
        got = bm25.bm25_rescore(*ops, lo, step)
        want = bm25.bm25_rescore_ref(*ops, lo, step)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        if not bool((want > 0).any()):
            raise AssertionError(f"K3 case {(Q, C, Lq, Ld, kind)} matched no "
                                 "query term")
        worst = max(worst, float((got - want).abs().max()))
    return worst


def measure_k1(bm25, qt, qw, dt, di) -> dict:
    """K1 against its plain version on these operands (scores within the
    tolerance, top-K ids equal within ties), its time and the plain one's
    (CUDA events), and its bound: the larger of the bytes the function
    must move (each operand read once, the [Q, N] scores written once) at
    the HBM rate, and one int32 lookup of each non-pad doc slot per query
    at the int32 rate."""
    import torch

    got = bm25.bm25_score_block(qt, qw, dt, di)
    want = bm25.bm25_score_block_ref(qt, qw, dt, di)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    err = float((got - want).abs().max())
    assert_same_topk(got, want, K)
    del got, want
    ms = time_cuda_ms(lambda: bm25.bm25_score_block(qt, qw, dt, di),
                      iters=20)
    dev_ms = time_device_ms(lambda: bm25.bm25_score_block(qt, qw, dt, di),
                            iters=20)
    cold_ms = time_cold_ms(lambda: bm25.bm25_score_block(qt, qw, dt, di))
    plain_ms = time_cuda_ms(lambda: bm25.bm25_score_block_ref(qt, qw, dt, di),
                            iters=3)
    Q, N = qt.shape[0], dt.shape[1]
    n_bytes = qt.nbytes + qw.nbytes + dt.nbytes + di.nbytes + Q * N * 4
    n_ops = Q * int((dt >= 0).sum())
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_INT32_OPS_PER_S * 1e3
    return dict(ms=ms, dev_ms=dev_ms, cold_ms=cold_ms, plain_ms=plain_ms,
                err=err, bytes=n_bytes, ops=n_ops,
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def reset_counts(bm25) -> None:
    for name in WRAPPERS:
        getattr(bm25, name).launches = 0


def counts(bm25) -> dict:
    return {name: getattr(bm25, name).launches for name in WRAPPERS}


def expect_counts(label, got: dict, want: dict) -> None:
    """The run launched exactly the kernels ``want`` names (a count, or
    None for at least one) and no other."""
    for name, n in got.items():
        need = want.get(name, 0)
        if (n < 1) if need is None else (n != need):
            raise AssertionError(f"{label}: {name} launched {n} times, "
                                 f"expected {'>= 1' if need is None else need}")


def serve_batches(serve, engine, batches, tagger, tokenizer, tag_dict):
    """Serve every micro-batch through ``engine``; returns (responses,
    per-stage ms per batch, ms per batch, peak allocated GB)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    stage_ms = {"retrieve": [], "fuse": [], "tag": []}
    batch_ms = []
    responses = []
    for batch in batches:
        timings = {}
        t0 = time.perf_counter()
        responses.extend(serve(batch, engine, tagger, tokenizer, tag_dict,
                               k=K, batch_size=BATCH, timings=timings))
        batch_ms.append((time.perf_counter() - t0) * 1e3)
        for key in stage_ms:
            stage_ms[key].append(timings[key] * 1e3)
    return (responses, stage_ms, batch_ms,
            torch.cuda.max_memory_allocated() / 1e9)


def report_serve(label, responses, batches, stage_ms, batch_ms, peak_gb,
                 launches, card) -> float:
    """Print one path's serve timings; returns requests/s after the first
    batch."""
    log(f"serve ({label}): {len(responses)} requests in {len(batches)} "
        f"micro-batches of {BATCH}; {launches}; peak allocated "
        f"{peak_gb:.2f} GB ({card})")
    for key, vals in stage_ms.items():
        name = "tag (encode+decode)" if key == "tag" else key
        log(f"  stage {name:19s} ms per batch: "
            + ", ".join(f"{v:.1f}" for v in vals))
    log("  batch total               ms per batch: "
        + ", ".join(f"{v:.1f}" for v in batch_ms))
    steady = batch_ms[1:]
    rate = BATCH * len(steady) / (sum(steady) / 1e3)
    log(f"  after the first batch: {rate:.1f} requests/s, "
        f"{np.mean(steady):.1f} ms per batch")
    return rate


def check_responses(requests, responses, tag_dict, eos) -> None:
    """Each response echoes its request, has one tag per token from the
    tag dictionary, and carries no retrieved-context token."""
    if len(responses) != len(requests):
        raise AssertionError(f"{len(responses)} responses to "
                             f"{len(requests)} requests")
    for req, resp in zip(requests, responses):
        if resp["id"] != req["id"] or resp["tokens"] != req["tokens"]:
            raise AssertionError(f"response {resp['id']} does not echo its "
                                 "request")
        if len(resp["tags"]) != len(resp["tokens"]):
            raise AssertionError(f"response {resp['id']}: "
                                 f"{len(resp['tags'])} tags for "
                                 f"{len(resp['tokens'])} tokens")
        if eos in resp["tokens"]:
            raise AssertionError(f"response {resp['id']} carries retrieved "
                                 "context tokens")
        bad = [t for t in resp["tags"] if t not in tag_dict]
        if bad:  # the context tag S-X is not in the dictionary either
            raise AssertionError(f"response {resp['id']}: tags {bad} are "
                                 "not in the tag dictionary")


def delta16_need(d16) -> tuple:
    """What delta16_rescore needs on these arguments, each byte once:
    (bytes, int32 operations). Bytes are the 32-byte sectors the
    candidates' segments occupy (slots [off, off + len) of 2 bytes, each
    distinct sector once), each distinct candidate's offset, length and
    norm code, the candidate ids, the query block and the output;
    operations are one lookup of each segment slot per candidate."""
    import torch

    qt, qw, cand, flat, off, lens, normc = d16[:7]
    ids = cand.long().flatten()
    o, n = off[ids].long(), lens[ids].long()
    n_slots = int(n.sum())
    o, n = o[n > 0], n[n > 0]
    n_sectors = 0
    if n.numel():
        first = o * 2 // 32
        span = ((o + n) * 2 - 1) // 32 - first + 1
        step = torch.arange(int(span.max()), device=o.device)
        sectors = (first[:, None] + step)[step < span[:, None]]
        n_sectors = int(torch.unique(sectors).numel())
    n_docs = int(torch.unique(ids).numel())
    n_bytes = (n_sectors * 32
               + n_docs * (off.element_size() + lens.element_size()
                           + normc.element_size())
               + cand.nbytes + qt.nbytes + qw.nbytes + cand.numel() * 4)
    return n_bytes, n_slots


def sector_bytes(start, n_bytes: int) -> int:
    """Bytes of the distinct 32-byte sectors that rows of ``n_bytes``
    starting at byte offsets ``start`` occupy, each sector once."""
    import torch

    first = start // 32
    span = (start + n_bytes - 1) // 32 - first + 1
    step = torch.arange(int(span.max()), device=start.device)
    sectors = (first[:, None] + step)[step < span[:, None]]
    return int(torch.unique(sectors).numel()) * 32


def rescore_need(args) -> tuple:
    """What bm25_rescore needs on these arguments, each byte once: (bytes,
    int32 operations). Bytes are the distinct 32-byte sectors of the
    distinct candidates' term rows (Ld int32) and code rows (Ld 16-bit
    codes), the candidate ids, the query block and the output; operations
    are one lookup of each row slot per candidate in the query's term set
    (every slot: a -1 pad matches a -1 query pad)."""
    import torch

    qt, qw, cand, dterms, dcodes = args[:5]
    Ld = dterms.shape[1]
    docs = torch.unique(cand.long().flatten())
    n_bytes = (sector_bytes(docs * Ld * 4, Ld * 4)
               + sector_bytes(docs * Ld * 2, Ld * 2)
               + cand.nbytes + qt.nbytes + qw.nbytes + cand.numel() * 4)
    return n_bytes, cand.numel() * Ld


def retrieve_breakdown(engine, index, batch, bm25) -> dict:
    """Where one batch's retrieve stage goes, in ms: query analysis and
    encoding, the engine's host preparation (pruned: rare terms, the tiny
    exact block, the remapped query block), the device search with its
    copies (host clock, ending on the host), the device work alone (CUDA
    events over 20 runs on prepared operands), and rendering the result
    records. Run it after the served run on one of its batches: the pruned
    query blocks' never-shrink widths are then those that run left."""
    import torch

    def wall(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3

    (qt, qw), enc = wall(lambda: index.encode_queries(
        [" ".join(r["tokens"]) for r in batch],
        max_query_terms=MAX_QUERY_TERMS))
    out = {"encode": enc}
    if engine.mode == "pruned":
        packed, out["host prep"] = wall(lambda: engine._pack_queries(qt, qw))
        keys, fields, (t_doc, t_ex), kw = engine._device_queries(packed)
        out["device"] = time_cuda_ms(lambda: bm25.bm25_pruned_topk_packed(
            keys, fields, n_real_docs=index.n_docs, k=K, tiny_doc=t_doc,
            tiny_ex=t_ex, **kw), iters=20)
    else:
        fields = [(torch.from_numpy(qt).to(engine.device),
                   torch.from_numpy(qw).to(engine.device),
                   *engine.fields["text"])]
        out["device"] = time_cuda_ms(lambda: bm25.bm25_topk(fields, k=K),
                                     iters=20)
    (scores, ids), out["search"] = wall(
        lambda: engine.search_encoded(qt, qw, k=K))
    _, out["render"] = wall(lambda: engine._materialize(scores, ids))
    return out


def tie_check(bm25, dt_t, di_t, qt, qw, card) -> None:
    """Equal scores at the K-th place, on the card at the serve shape: each
    of BATCH queries is one of the KB's most frequent terms alone (weight 1,
    the other MAX_QUERY_TERMS slots padded), so runs of documents with one
    tf and one norm code share a score across the K-th place. ``bm25_topk``
    on the card is held, ids and scores, to the first K of a stable
    descending sort of the same K1 scores on the CPU (``lax.top_k``'s ids
    and order), and timed on these queries; then on the served batch's
    queries ``qt``/``qw`` against K1 and a bare ``torch.topk`` (the
    selection before the repair, ties at the cut left to it), in turns
    (CUDA events, eager)."""
    import torch

    dev = dt_t.device
    terms = torch.topk(torch.bincount(dt_t[dt_t >= 0]), BATCH).indices
    one_t = torch.full((BATCH, MAX_QUERY_TERMS), -1, dtype=torch.int32,
                       device=dev)
    one_w = torch.zeros((BATCH, MAX_QUERY_TERMS), dtype=torch.float32,
                        device=dev)
    one_t[:, 0], one_w[:, 0] = terms.to(torch.int32), 1.0
    fields = [(one_t, one_w, dt_t, di_t)]
    got_s, got_i = bm25.bm25_topk(fields, k=K)
    scores = bm25.bm25_score_block(one_t, one_w, dt_t, di_t).cpu()
    top = torch.topk(scores, K + 1, dim=1).values
    tied = int((top[:, K - 1] == top[:, K]).sum())
    want_s, want_i = torch.sort(scores, dim=1, descending=True, stable=True)
    if tied == 0:
        raise AssertionError("tie check: no crafted query ties at the "
                             f"{K}-th place")
    if not (torch.equal(got_s.cpu(), want_s[:, :K])
            and torch.equal(got_i.cpu(), want_i[:, :K])):
        raise AssertionError("tie check: bm25_topk on the card differs from "
                             "the stable sort's first K on the CPU")
    run = int((scores == top[:, K - 1:K]).sum())
    ms = time_cuda_ms(lambda: bm25.bm25_topk(fields, k=K), iters=20)
    log(f"tie check (Q={BATCH} one-term queries, Lq={MAX_QUERY_TERMS}, "
        f"N={dt_t.shape[1]}): {tied} of {BATCH} rows tie at the {K}-th "
        f"place ({run} documents carry those rows' {K}-th scores); "
        f"bm25_topk on the card equals the CPU's stable sort, ids and "
        f"scores; {ms:.4f} ms a search (CUDA events, eager) ({card})")
    served = [(qt, qw, dt_t, di_t)]
    top = torch.topk(bm25.bm25_score_block(qt, qw, dt_t, di_t), K + 1,
                     dim=1).values
    served_tied = int((top[:, K - 1] == top[:, K]).sum())
    exact, bare = [], []
    for fn, out in ((bm25.bm25_topk, exact), (None, bare), (None, bare),
                    (bm25.bm25_topk, exact)):
        out.append(time_cuda_ms(
            (lambda: fn(served, k=K)) if fn else
            (lambda: torch.topk(bm25.bm25_score_block(qt, qw, dt_t, di_t),
                                K, dim=1)), iters=20))
    log(f"the served batch's exhaustive search ({qt.shape[0]} queries, "
        f"{served_tied} rows tied at the {K}-th place): bm25_topk "
        + ", ".join(f"{v:.4f}" for v in exact) + " ms; K1 + a bare "
        f"torch.topk " + ", ".join(f"{v:.4f}" for v in bare) + " ms, in "
        f"turns (CUDA events, eager) ({card})")


def held_against_exact(label, exact, got, score_rtol=SCORE_RTOL,
                       why="") -> None:
    """Print and check recall@K of ``got`` against the exhaustive
    ``exact`` (one (scores, ids) per batch), and the largest relative
    score difference of documents in both lists against ``score_rtol``
    (None: printed with ``why`` there is no bar). Recall counts the
    queries whose exhaustive top-k has a positive score."""
    recalls, worst = [], 0.0
    for (es, ei), (gs, gi) in zip(exact, got):
        for q in range(ei.shape[0]):
            want = {int(d): float(x) for d, x in zip(ei[q], es[q]) if x > 0}
            found = {int(d): float(x) for d, x in zip(gi[q], gs[q])
                     if d >= 0 and x > 0}
            if not want:
                continue
            both = want.keys() & found.keys()
            recalls.append(len(both) / len(want))
            for d in both:
                worst = max(worst, abs(found[d] - want[d]) / abs(want[d]))
    recall = float(np.mean(recalls))
    bar = f"bar {score_rtol}" if score_rtol is not None else f"no bar: {why}"
    log(f"{label} vs exhaustive on {len(recalls)} queries: recall@{K} "
        f"{recall:.4f} (bar {MIN_RECALL}); scores of docs in both top-{K} "
        f"lists differ by at most {worst:.3g} relative ({bar})")
    if recall < MIN_RECALL:
        raise AssertionError(f"{label} recall@{K} {recall:.4f} is below "
                             f"{MIN_RECALL}")
    if score_rtol is not None and worst > score_rtol:
        raise AssertionError(f"{label} scores differ from exhaustive by "
                             f"{worst:.3g} relative")


def pruned_device_breakdown(bm25, engine, n_real, packed) -> str:
    """Device time (CUDA events, 5 runs) of one batch's pruned search on
    operands prepared from ``packed`` (the output of ``_pack_queries``):
    pass 1 + pass 2 in all, and each field's pass 2 alone."""
    keys, fields, (t_doc, t_ex), kw = engine._device_queries(packed)
    total = time_cuda_ms(lambda: bm25.bm25_pruned_topk_packed(
        keys, fields, n_real_docs=n_real, k=K, tiny_doc=t_doc, tiny_ex=t_ex,
        **kw), iters=5)
    _, _, ops = bm25.pass2_operands(keys, fields, **kw)
    parts = [f"pass 1 + pass 2 {total:.3f}"]
    for name, (fn, args) in zip(("text", "title"), ops):
        ms = time_cuda_ms(lambda: fn(*args), iters=5)
        parts.append(f"{name} pass 2 ({fn.__name__}, Lq={args[0].shape[1]}) "
                     f"{ms:.3f}")
    return ", ".join(parts)


# the training phase: XLM-R large + CRF fine-tuned on context-fused
# quality-corpus sentences, with the recipe's optimizer settings
# (configs/en_v3_preretrieved.yaml)
RECIPE = dict(learning_rate=5e-6, lr_rate=10000.0, warmup_fraction=0.1)
N_RECIPE = 32           # (a): batch 1, accumulation 4 -> 8 optimizer steps
N_WIDE = 64             # (b): batch 16, three epochs
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16, NVIDIA data sheet


def training_records(engine, requests, n, seed):
    """``n`` quality-corpus sentences (gold BIOES tags), each fused with
    the top-K contexts the engine retrieves for one served query (the
    corpus's words are not in the synthetic KB), context tagged S-X as
    a BIOES column file reads it."""
    from kbner_tpu_torch.data.conll import SentenceRecord
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.retrieval.fusion import fuse_contexts

    corpus = make_quality_corpus(n_train=n, n_dev=0, n_test=BATCH,
                                 seed=seed)
    queries = [requests[i % len(requests)] for i in range(n)]
    results = engine.search([" ".join(q["tokens"]) for q in queries], k=K)
    fused = fuse_contexts(corpus.train, results,
                          HashTokenizer(vocab_size=HASH_VOCAB))
    out = [SentenceRecord(tokens=r.tokens, tags={"ner": [
        "S-X" if t == "B-X" else t for t in r.tags["ner"]]}) for r in fused]
    return out, corpus.test_list[0]


def run_training(trainer, config, base_path, sync):
    """``trainer.train`` with each step timed on the host clock between
    device syncs; returns (result, [(ms, subtokens, loss) per step])."""
    steps = []
    inner = trainer.train_step

    def timed(item, opt, cfg, rng, freeze=False):
        sync()
        t0 = time.perf_counter()
        loss = inner(item, opt, cfg, rng, freeze)
        sync()
        steps.append(((time.perf_counter() - t0) * 1e3,
                      int(item.attention_mask.sum()), float(loss)))
        return loss

    trainer.train_step = timed
    try:
        result = trainer.train(base_path, config)
    finally:
        del trainer.train_step
    return result, steps


def optimizer_steps(steps, k):
    """(ms, subtokens) per optimizer step from micro-steps, k per step."""
    return [(sum(s[0] for s in steps[i:i + k]),
             sum(s[1] for s in steps[i:i + k]))
            for i in range(0, len(steps) - k + 1, k)]


def stage_split(trainer, batch, config, time_ms):
    """One step of ``batch`` split into the encoder's forward (with the
    word features and the emission head), the CRF's forward + backward
    (the NLL on detached emissions), the encoder's backward, and the
    optimizer update, each timed by ``time_ms`` after one warm-up pass of
    all four; and the whole ``train_step`` on the same batch."""
    import torch

    from kbner_tpu_torch.ops.crf import crf_neg_log_likelihood

    model = trainer.model
    cfg = model.config
    arrays = trainer._to_device(batch)
    rng = torch.Generator().manual_seed(1)
    opt = trainer.make_optimizer(config)
    trans = model._batch_transitions(arrays)
    out = {}

    def encoder_forward():
        out["em"] = model.emissions(arrays, rng)

    def crf():
        em = out["em"].detach().requires_grad_()
        nll = crf_neg_log_likelihood(em, arrays["tag_ids"],
                                     arrays["crf_mask"], trans.detach(),
                                     cfg.start_idx, cfg.stop_idx)
        nll.mean().backward()
        out["grad"] = em.grad

    def encoder_backward():
        out["em"].backward(out["grad"])

    stages = {"encoder forward": encoder_forward,
              "CRF forward + backward": crf,
              "encoder backward": encoder_backward,
              "optimizer update": opt.step}
    for fn in stages.values():  # warm-up: gradients and moments allocated
        fn()
    ms = {name: time_ms(fn) for name, fn in stages.items()}
    ms["whole step (train_step)"] = time_ms(
        lambda: trainer.train_step(batch, opt, config, rng))
    model.zero_grad(set_to_none=True)
    del opt, out
    return ms


def profile_step(trainer, batch, config, sync, n_top: int = 6):
    """One ``train_step`` of ``batch`` under ``torch.profiler``, tracing
    the device alone (the host's operators, ~10^5 in an LSTM step, take
    the profiler a minute): (wall ms under the profiler, the device time
    of its kernels in ms, [(kernel, ms, launches)] of the ``n_top``
    largest). The kernel time is None when the trace holds no device
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    opt = trainer.make_optimizer(config)
    rng = torch.Generator().manual_seed(2)
    trainer.train_step(batch, opt, config, rng)  # warm-up
    sync()
    with profile(activities=[ProfilerActivity.CUDA if torch.cuda.is_available()
                             else ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(batch, opt, config, rng)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del opt
    # the kernels themselves: an operator's entry repeats its kernels' time
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        return wall_ms, None, []

    def ms(e):
        return e.self_device_time_total / 1e3

    top = sorted(kernels, key=ms, reverse=True)[:n_top]
    return (wall_ms, sum(ms(e) for e in kernels),
            [(e.key.replace("void ", "").replace("at::native::", ""),
              ms(e), e.count) for e in top])


def event_ms(fn) -> float:
    """One call of ``fn`` between CUDA events, in ms."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


LEARN_STEPS = 4


def dropout_free_loss(trainer, recs, config) -> float:
    """The mean dropout-free loss of the batches ``recs`` makes."""
    import torch

    batches = trainer._make_train_batches(recs, config, 0)
    with torch.no_grad():
        return float(np.mean([float(trainer.model.loss(
            trainer._to_device(b))) for b in batches]))


def learning_probe(tcfg, recs, tokenizer, tag_dict, dev) -> tuple:
    """``(loss before, loss after)`` of the first batch of ``recs``: a
    tagger fresh from seed 0 takes ``LEARN_STEPS`` optimizer steps on it
    at the recipe's encoder lr for every parameter (lr_rate 1, no
    warmup), dropout off; both losses dropout-free."""
    import torch

    from kbner_tpu_torch.data.conll import Corpus, ListCorpus
    from kbner_tpu_torch.models.tagger import SequenceTagger
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    model = SequenceTagger(tcfg, device=dev, seed=0)
    trainer = FinetuneTrainer(model, ListCorpus([Corpus(
        recs, [], [], name="FUSED")]), tokenizer, tag_dict, device=dev)
    config = TrainConfig(learning_rate=RECIPE["learning_rate"], lr_rate=1.0,
                         batch_size=16, warmup_fraction=0.0,
                         use_inverse_sqrt=True)
    opt = trainer.make_optimizer(config)
    batch = trainer._make_train_batches(recs, config, 0)[0]
    arrays = trainer._to_device(batch)
    with torch.no_grad():
        before = float(model.loss(arrays))
    for _ in range(LEARN_STEPS):
        trainer.train_step(batch, opt, config, None)
    with torch.no_grad():
        after = float(model.loss(arrays))
    return before, after


def training_phase(engine, requests, bm25, dev, card, tokenizer,
                   enc_config, tmp) -> None:
    """Train XLM-R large + CRF through ``FinetuneTrainer.train`` on fused
    records ((a) the recipe's batch 1 with accumulation 4, (b) batch 16
    for three epochs) under ``tmp/a`` and ``tmp/b``, then serve (b)'s
    best-model.msgpack through the port's serve path and hold its tags to
    the trainer's own prediction in the serving dtype."""
    import dataclasses

    import torch

    from pathlib import Path

    from kbner_tpu_torch.cli import serving_tagger
    from kbner_tpu_torch.config import ServeConfig
    from kbner_tpu_torch.data.conll import ListCorpus, Corpus, write_column_file
    from kbner_tpu_torch.eval.metrics import evaluate_spans
    from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
    from kbner_tpu_torch.serve import request_record, serve
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig

    def sync():
        torch.cuda.synchronize()

    reset_counts(bm25)
    t0 = time.perf_counter()
    recipe_recs, _ = training_records(engine, requests, N_RECIPE, seed=7)
    wide_recs, test = training_records(engine, requests, N_WIDE, seed=8)
    expect_counts("the training records' retrieval", counts(bm25),
                  {"bm25_score_block": None})
    n_ctx = sum("<EOS>" in r.tokens for r in wide_recs)
    log(f"training records: {N_RECIPE} + {N_WIDE} quality-corpus sentences "
        f"fused with the exhaustive engine's top {K} contexts "
        f"({n_ctx}/{N_WIDE} carry context; launches {counts(bm25)}); made "
        f"in {time.perf_counter() - t0:.1f} s (set-up)")

    tag_dict = ListCorpus([Corpus(wide_recs, [], [])]).make_tag_dictionary(
        "ner")
    # phase 4p trains on (b)'s fused records from this file
    write_column_file(Path(tmp) / MESH_FOLDER / "train.txt", wide_recs)
    # the recipe's tagger: word dropout 0.1, no locked dropout, and no
    # embedding2nn re-projection (the reference config that
    # configs/en_v3_preretrieved.yaml translates is a "norelearn" run)
    tcfg = TaggerConfig.for_tag_dictionary(
        enc_config, tag_dict, locked_dropout=0.0, word_dropout=0.1,
        relearn_embeddings=False)
    runs = (("a", recipe_recs, dict(batch_size=1, accumulation_steps=4,
                                    max_epochs=1)),
            ("b", wide_recs, dict(batch_size=16, max_epochs=3)))
    for label, recs, kw in runs:
        t0 = time.perf_counter()
        model = SequenceTagger(tcfg, device=dev, seed=0)
        trainer = FinetuneTrainer(model, ListCorpus([Corpus(
            recs, [], [], name="FUSED")]), tokenizer, tag_dict,
            device=dev)
        config = TrainConfig(**RECIPE, **kw)
        sync()
        setup_s = time.perf_counter() - t0
        if label == "b":
            recs_before = dropout_free_loss(trainer, recs, config)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, steps = run_training(trainer, config, f"{tmp}/{label}",
                                     sync)
        total_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [s[2] for s in steps]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"training ({label}): a loss is not "
                                 f"finite: {losses}")
        opt_steps = optimizer_steps(steps, kw.get("accumulation_steps",
                                                  1))
        step_ms = float(np.median([ms for ms, _ in opt_steps[2:]]))
        tok_s = (sum(t for _, t in opt_steps[2:])
                 / (sum(ms for ms, _ in opt_steps[2:]) / 1e3))
        history = result["history"]["train_loss"]
        B = kw["batch_size"]
        log(f"training ({label}): XLM-R ({enc_config.num_layers} layers, "
            f"hidden {enc_config.hidden_size}, vocab "
            f"{enc_config.vocab_size}, {enc_config.dtype} compute over "
            f"{enc_config.param_dtype} parameters), batch {B}, accumulation "
            f"{kw.get('accumulation_steps', 1)}, {len(recs)} fused "
            f"records, {kw['max_epochs']} epoch(s), "
            f"{len(opt_steps)} optimizer steps ({len(steps)} micro-"
            f"steps): {step_ms:.1f} ms per optimizer step (median after "
            f"the first two), {tok_s:.0f} subtokens/s, peak allocated "
            f"{peak_gb:.2f} GB; epoch mean losses "
            + ", ".join(f"{v:.4f}" for v in history)
            + f"; first and last step losses {losses[0]:.4f}, "
            f"{losses[-1]:.4f}; train() {total_s:.1f} s with the "
            f"checkpoint writes, model set-up {setup_s:.1f} s ({card})")
        if label == "a":
            del model, trainer
            continue
        # (b)'s epoch means and its records' dropout-free loss are
        # printed, not held: from random weights the head's x10000 lr
        # overshoots, in the reference's trainer as in the port's
        # (tests/test_torch_train.py::
        # test_recipe_head_lr_run_matches_jax_trainer holds the port's run
        # of this schedule to the JAX trainer's, loss by loss, at a small
        # width), so they do not measure learning. The step's wiring on
        # the card is held by a probe: a tagger fresh from the same seed
        # takes LEARN_STEPS steps at the encoder's lr for every group on
        # (b)'s first batch, dropout off, and must lower its loss
        recs_after = dropout_free_loss(trainer, recs, config)
        learn_before, learn_after = learning_probe(tcfg, recs, tokenizer,
                                                   tag_dict, dev)
        if not learn_after < learn_before:
            raise AssertionError(
                f"training (b): {LEARN_STEPS} steps at lr "
                f"{RECIPE['learning_rate']} did not lower the batch's loss "
                f"{learn_before:.4f} ({learn_after:.4f})")
        log(f"training (b), learning: (b)'s {len(recs)} records, dropout "
            f"off, mean loss {recs_before:.4f} before its {len(steps)} "
            f"steps at the recipe's lr and {recs_after:.4f} after; a tagger "
            f"fresh from seed 0, {LEARN_STEPS} Adam steps at lr "
            f"{RECIPE['learning_rate']} for every group (no head "
            f"multiplier, no warmup) on (b)'s first batch of {B}, dropout "
            f"off: its loss {learn_before:.4f} -> {learn_after:.4f} "
            f"({card})")
        # one step of (b), split by stage with CUDA events
        torch.cuda.empty_cache()
        batch = trainer._make_train_batches(recs, config, 0)[0]
        split = stage_split(trainer, batch, config, event_ms)
        n_tok = int(batch.attention_mask.sum())
        Bb, Sb = batch.input_ids.shape
        enc = enc_config
        n_matmul = sum(p.numel() for n, p in model.named_parameters()
                       if "embeddings" not in n)
        flops = (6 * n_matmul * Bb * Sb
                 + 12 * enc.num_layers * Bb * Sb * Sb * enc.hidden_size)
        mfu = flops / (step_ms / 1e3) / PEAK_BF16_FLOPS
        log(f"training (b), one step of batch 16 (B={Bb}, S={Sb}, "
            f"{n_tok} real subtokens, W={batch.word_mask.shape[1]} words,"
            f" {int(batch.crf_mask.sum(1).max())} in the CRF at most), "
            "ms by CUDA events: "
            + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
            + f" ({card})")
        wall_ms, dev_ms, top = profile_step(trainer, batch, config, sync)
        step_ev = split["whole step (train_step)"]
        if dev_ms is None:
            log(f"training (b), one step under torch.profiler: "
                f"{wall_ms:.1f} ms; the trace holds no device kernels, "
                f"so the device's busy share is not measured ({card})")
        else:
            log(f"training (b), one step under torch.profiler "
                f"({wall_ms:.1f} ms with the profiler's own cost): its "
                f"kernels take {dev_ms:.1f} ms on the device, "
                f"{dev_ms / step_ev:.1%} of the {step_ev:.1f} ms step "
                f"without the profiler (idle "
                f"{max(0.0, 1 - dev_ms / step_ev):.1%}); largest: "
                + "; ".join(f"{name[:70]} {ms:.1f} ms x{n}"
                            for name, ms, n in top) + f" ({card})")
        log(f"training (b): model FLOPs per step = 6*N*B*S + 12*L*B*S^2*H"
            f" = 6*{n_matmul / 1e6:.1f}M*{Bb}*{Sb} + 12*{enc.num_layers}"
            f"*{Bb}*{Sb}^2*{enc.hidden_size} = {flops:.3e} (N: the "
            f"parameters outside the embedding tables); at "
            f"{step_ms:.1f} ms per step that is {mfu:.1%} of the "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s bf16 dense peak "
            f"({card})")

        # serve the best model: ServeConfig -> bf16 tagger
        served_cfg = ServeConfig(
            name="trained", tokenizer={"type": "hash",
                                       "vocab_size": HASH_VOCAB},
            model={"encoder": "large"}, target_dir=f"{tmp}/{label}")
        tagger = serving_tagger(served_cfg, tag_dict, dev)
        if any(p.dtype != enc.dtype for p in tagger.encoder.parameters()):
            raise AssertionError("the served encoder is not stored in "
                                 f"{enc.dtype}")
        reqs = [{"id": i, "tokens": r.tokens} for i, r in enumerate(test)]
        responses = serve(reqs, engine, tagger, tokenizer, tag_dict,
                          k=K, batch_size=BATCH)
        # the trainer's prediction with its model cast to bf16
        cast = SequenceTagger(dataclasses.replace(
            tcfg, encoder=served_cfg.make_encoder_config(tokenizer)),
            device=dev)
        trainer.load(f"{tmp}/{label}/best-model.msgpack")
        cast.load_state_dict(trainer.model.state_dict())
        fused = fuse_served(engine, tokenizer,
                            [request_record(r) for r in reqs])
        want = FinetuneTrainer(cast, trainer.corpus, tokenizer, tag_dict,
                               device=dev).predict(fused, BATCH)
        got = [r["tags"] for r in responses]
        if got != [w[:len(r["tokens"])] for w, r in zip(want, reqs)]:
            raise AssertionError("served tags differ from "
                                 "FinetuneTrainer.predict in bf16")
        f1 = evaluate_spans([r.tags["ner"] for r in test],
                            got).micro_avg_f_score()
        log(f"served best-model.msgpack (bf16 storage) for {len(reqs)} "
            f"held-out quality sentences through serve() with the "
            f"exhaustive engine: tags equal FinetuneTrainer.predict with "
            f"the model cast to bf16; span F1 against gold {f1:.4f} "
            f"after {len(opt_steps)} steps from random weights ({card})")
        del model, trainer, tagger, cast
    torch.cuda.empty_cache()


# the offline KB stage: cli ingest-dump -> cli index -> a saved 1M-doc KB
# -> cli retrieve into fused CoNLL files -> cli serve --index_dir
N_DUMP_PAGES = 2000
N_SERVE_KB_DOCS = 20_000  # cli serve --kb [--store] builds its KB at start
# cli index's JSONL: the first twentieth of the KB, to leave room in the
# smoke's time limit for phases 4l and 4p
N_INDEX_DOCS = 50_000
# MultiCoNER EN's splits (15,300 / 800 / 217,818) cut to two cli retrieve
# batches of train (the deep-window check's queries), an eighth of the dev
# and 250 test sentences, to leave room in the smoke's time limit for
# phases 4k, 4l and 4p
SPLITS = {"train": 2_048, "dev": 100, "test": 250}
RETRIEVE_BATCH = 1024   # retrieve_for_records' queries per search
RETRIEVE_RUNS = (("exhaustive", []), ("pruned", ["--engine_mode", "pruned"]),
                 ("exhaustive + entities", ["--with_entity"]),
                 ("pruned + entities", ["--engine_mode", "pruned",
                                        "--with_entity"]))


def synth_dump(path, n_pages: int, seed: int) -> int:
    """A bz2 MediaWiki export of ``n_pages`` pages: articles with links
    (plain, piped, to redirects, to files and categories), templates,
    references, headings, lists and tables, and one redirect page for
    every tenth article. Returns the number of redirects."""
    import bz2
    from xml.sax.saxutils import escape

    rng = np.random.RandomState(seed)
    words = [f"word{i}" for i in range(500)]

    def sentence():
        w = [words[i] for i in rng.randint(0, len(words),
                                           rng.randint(5, 14))]
        return " ".join(w).capitalize()

    n_red = 0
    pages = []
    for i in range(n_pages):
        a, b, c = rng.randint(0, n_pages, 3)
        text = (f"{{{{Infobox thing|name=Page {i}|see=[[Page {a}]]}}}}\n"
                f"'''Page {i}''' is a [[Page {a}]] of [[Page {b}|the "
                f"{words[b % 500]}]]. {sentence()} [[Redirect {c // 10}]]."
                f"<ref>A cite {i}</ref> {sentence()}.\n"
                f"== Section ==\n* {sentence()} [[Page {c}]] here.\n"
                f"{{| class=\"wikitable\"\n| cell || cell\n|}}\n"
                f"{sentence()}! {sentence()}? [[File:F{i}.jpg|thumb|x]]"
                f"[[Category:C{i % 7}]]")
        pages.append((f"Page {i}", text, None))
        if i % 10 == 0:
            pages.append((f"Redirect {i // 10}", f"#REDIRECT [[Page {i}]]",
                          f"Page {i}"))
            n_red += 1
    xml = ['<mediawiki xmlns="http://www.mediawiki.org/xml/export-0.10/" '
           'xml:lang="en">']
    for title, text, red in pages:
        r = f'<redirect title="{escape(red)}" />' if red else ""
        xml.append(f"<page><title>{escape(title)}</title><ns>0</ns>{r}"
                   f"<id>1</id><revision><id>2</id><text xml:space="
                   f'"preserve">{escape(text)}</text></revision></page>')
    xml.append("</mediawiki>")
    with bz2.open(path, "wt", encoding="utf-8") as f:
        f.write("".join(xml))
    return n_red


def kb_rows(docs, title_docs, lo: int, hi: int):
    """Parsed-wiki records of docs [lo, hi), as (sentence, paragraph,
    title, url): the rendered sentence (also the paragraph), its first two
    words as the title, a URL per doc."""
    words = [f"w{t}" for t in range(int(docs.max()) + 1)]
    out = []
    for i, (row, title) in enumerate(zip(docs[lo:hi].tolist(),
                                         title_docs[lo:hi].tolist()), lo):
        sentence = " ".join([words[t] for t in row if t >= 0])
        out.append((sentence, sentence, " ".join([words[t] for t in title]),
                    f"https://en.wikipedia.org/wiki/Doc_{i}"))
    return out


def assert_same_results(label, want, got, rtol=RTOL, atol=ATOL) -> None:
    """Two engines' (scores, ids) per batch agree: scores within the
    tolerance (the kernels' by default), ids equal above each row's last
    score."""
    if len(want) != len(got):
        raise AssertionError(f"{label}: {len(got)} batches, not "
                             f"{len(want)}")
    for (ws, wi), (gs, gi) in zip(want, got):
        np.testing.assert_allclose(gs, ws, rtol=rtol, atol=atol,
                                   err_msg=label)
        for q in range(ws.shape[0]):
            cut = min(ws[q, -1], gs[q, -1])
            # a row with fewer than K hits ends in -inf: every hit counts
            if np.isfinite(cut):
                cut += atol + rtol * abs(cut)
            if set(wi[q][ws[q] > cut]) != set(gi[q][gs[q] > cut]):
                raise AssertionError(f"{label}: query {q}'s top-{K} ids "
                                     "differ")


def retrieval_recall(exact_path, got_path) -> float:
    """Recall@K of a retrieval file against another, by document URL,
    over the queries whose exact list is not empty."""
    from kbner_tpu_torch.retrieval.pipeline import read_retrieval_file

    exact = read_retrieval_file(exact_path)
    got = read_retrieval_file(got_path)
    recalls = [len({d.url for d in docs} & {d.url for d in got[q]})
               / len(docs) for q, docs in exact.items() if docs]
    return float(np.mean(recalls))


def query_blocks(path):
    """A retrieval file as its query blocks, each a (query, sorted context
    lines) pair."""
    blocks = []
    for block in path.read_text(encoding="utf-8").split("\n\n"):
        if block.strip():
            query, *lines = block.split("\n")
            blocks.append((query, sorted(lines)))
    return blocks


def k1_at_retrieve_shape(bm25, engine, queries, entities, dev,
                         per_tile: int = 2, seed: int = 0,
                         every_row: bool = False) -> str:
    """K1 at one ``cli retrieve`` batch (the queries and entity clauses of
    ``retrieve_for_records``) on ``engine``'s text and title fields, or on
    its text field alone where ``entities`` is None. The kernel scores
    every row; the plain version scores ``per_tile`` random rows of each
    32-query tile of the kernel (every row with ``every_row``), over the
    whole doc axis, held at RTOL/ATOL with top-K ids equal within ties.
    Returns the report: error, time (CUDA events) and bound per field."""
    import torch

    Q = len(queries)
    blocks = [("text", engine.text_index.encode_queries(
        list(queries), max_query_terms=MAX_QUERY_TERMS))]
    if entities is not None:
        blocks.append(("title", engine.title_index.encode_queries(
            [" ".join(e) for e in entities],
            max_query_terms=MAX_QUERY_TERMS, boosts=[TITLE_BOOST] * Q)))
    rng = np.random.RandomState(seed)
    rows = (range(Q) if every_row else
            sorted({min(t + o, Q - 1) for t in range(0, Q, 32)
                    for o in rng.randint(0, 32, per_tile)}))
    rows = torch.tensor(list(rows), device=dev)
    parts = []
    for name, (q_t, q_w) in blocks:
        dt, di = engine.fields[name]
        q_t = torch.as_tensor(np.asarray(q_t, np.int32), device=dev)
        q_w = torch.as_tensor(np.asarray(q_w, np.float32), device=dev)
        got = bm25.bm25_score_block(q_t, q_w, dt, di)[rows]
        want = torch.cat([bm25.bm25_score_block_ref(q_t[r], q_w[r], dt, di)
                          for r in rows.split(32)])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        assert_same_topk(got, want, K)
        if not bool((want > 0).any()):
            raise AssertionError(f"K1 at the retrieve shape ({name}) matched "
                                 "no query term")
        err = float((got - want).abs().max())
        del got, want
        ms = time_cuda_ms(lambda: bm25.bm25_score_block(q_t, q_w, dt, di),
                          iters=5)
        N = dt.shape[1]
        n_bytes = (q_t.nbytes + q_w.nbytes + dt.nbytes + di.nbytes
                   + q_t.shape[0] * N * 4)
        bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        ops_ms = (q_t.shape[0] * int((dt >= 0).sum())
                  / PEAK_INT32_OPS_PER_S * 1e3)
        parts.append(
            f"{name} (Q={q_t.shape[0]} Lq={q_t.shape[1]} Ld={dt.shape[0]} "
            f"N={N}): {rows.numel()} rows from all {-(-Q // 32)} query "
            f"tiles equal the plain version (max abs err {err:.3g}), top-{K} "
            f"ids equal within ties; kernel {ms:.3f} ms (CUDA events, 5 "
            f"calls), bound {max(bytes_ms, ops_ms):.3f} ms by "
            f"{'bytes' if bytes_ms >= ops_ms else 'operations'}")
    return "; ".join(parts)


def k2_at_retrieve_shape(bm25, engine, queries, entities=None) -> str:
    """K2 on the pass-2 operands that the pruned ``engine`` packs for one
    ``cli retrieve`` batch of sentence queries (``search_stream``), or,
    with ``entities``, of sentence queries and their title-boosted entity
    clauses (``mix_search --with_entity``), held to its plain version at
    RTOL/ATOL with top-K ids equal within ties. Returns the report: error,
    time (CUDA events) and bound."""
    import torch

    qt, qw = engine.text_index.encode_queries(
        list(queries), max_query_terms=MAX_QUERY_TERMS)
    title = ()
    if entities is not None:
        title = engine.title_index.encode_queries(
            [" ".join(e) for e in entities],
            max_query_terms=MAX_QUERY_TERMS,
            boosts=[TITLE_BOOST] * len(entities))
    keys, fields, _, kw = engine._device_queries(engine._pack_queries(
        qt, qw, *title))
    _, _, ops = bm25.pass2_operands(keys, fields, **kw)
    fn, args = ops[0]
    if fn is not bm25.delta16_rescore:
        raise AssertionError(f"the text field's pass 2 is {fn.__name__}, "
                             "not delta16_rescore")
    got = fn(*args)
    want = bm25.delta16_rescore_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert_same_topk(got, want, K)
    err = float((got - want).abs().max())
    ms = time_cuda_ms(lambda: fn(*args), iters=20)
    n_bytes, n_ops = delta16_need(args)
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = n_ops / PEAK_INT32_OPS_PER_S * 1e3
    Q, C = args[2].shape
    return (f"Q={Q} W={args[0].shape[1]} C={C} R2={args[-1]}: equals the "
            f"plain version (max abs err {err:.3g}), top-{K} ids equal "
            f"within ties; kernel {ms:.4f} ms (CUDA events, 20 calls, "
            f"eager), bound {max(bytes_ms, ops_ms):.5f} ms by "
            f"{'bytes' if bytes_ms >= ops_ms else 'operations'}")


def stream_against_per_batch(engine, queries):
    """``queries`` in ``cli retrieve``'s 1024-query batches through the
    pruned ``engine``'s ``search_stream`` and through a per-batch loop
    (encode, ``search_encoded``), timed in turns: per-batch, stream,
    per-batch, stream, after one per-batch pass that grows the engine's
    never-shrink query widths to this traffic's, so every run packs
    alike. Every run's scores must equal the first's exactly, with ids
    equal within ties. Returns (per-batch seconds, stream seconds)."""
    import torch

    batches = [list(queries[i:i + RETRIEVE_BATCH])
               for i in range(0, len(queries), RETRIEVE_BATCH)]

    def per_batch():
        return [engine.search_encoded(*engine.text_index.encode_queries(
            b, max_query_terms=MAX_QUERY_TERMS), k=K) for b in batches]

    def stream():
        return list(engine.search_stream(batches, k=K,
                                         max_query_terms=MAX_QUERY_TERMS))

    per_batch()
    secs = {per_batch: [], stream: []}
    runs = []
    for fn in (per_batch, stream, per_batch, stream):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs.append(fn())
        secs[fn].append(time.perf_counter() - t0)
    for got in runs[1:]:
        for (ws, _), (gs, _) in zip(runs[0], got):
            if not np.array_equal(ws, gs):
                raise AssertionError("search_stream and per-batch search "
                                     "give different scores")
        assert_same_results("search_stream against per-batch search",
                            runs[0], got, rtol=0.0, atol=0.0)
    return secs[per_batch], secs[stream]


def stream_native_against_twin(engine, queries, native):
    """``search_stream`` over ``queries`` in ``cli retrieve``'s batches on
    the pruned ``engine``, with the native tiny gather and with its numpy
    twin swapped in, timed in turns: native, twin, native, twin. Each
    side's runs agree exactly; native against twin within SCORE_RTOL
    (float64 sums against float32 in posting order, then packed as the
    engine packs tiny sums), ids within ties.
    Returns (native seconds, twin seconds)."""
    import torch

    batches = [list(queries[i:i + RETRIEVE_BATCH])
               for i in range(0, len(queries), RETRIEVE_BATCH)]
    secs = {"native": [], "twin": []}
    runs = {"native": [], "twin": []}
    for which in ("native", "twin", "native", "twin"):
        saved = native.gather_tiny_exact
        if which == "twin":
            native.gather_tiny_exact = native.gather_tiny_exact_ref
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[which].append(list(engine.search_stream(
                batches, k=K, max_query_terms=MAX_QUERY_TERMS)))
            secs[which].append(time.perf_counter() - t0)
        finally:
            native.gather_tiny_exact = saved
    for which, (a, b) in runs.items():
        assert_same_results(f"search_stream ({which} tiny gather) run to "
                            "run", a, b, rtol=0.0, atol=0.0)
    assert_same_results("search_stream, native tiny gather against its "
                        "twin", runs["native"][0], runs["twin"][0],
                        rtol=SCORE_RTOL)
    return secs["native"], secs["twin"]


def run_cli(cli, argv, stdin=None):
    """``cli.main(argv)`` with ``stdin`` (a string) as its standard input
    and its standard output captured: (return value, output)."""
    import contextlib
    import io

    out = io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin or "")
    try:
        with contextlib.redirect_stdout(out):
            ret = cli.main(argv)
    finally:
        sys.stdin = saved
    return ret, out.getvalue()


# the host runtime's checks in phase 4h: the analyzer's multilingual
# corpus, the zh KB indexed with IK over the builtin lexicon, and the deep
# windows of the pruned engine (4096 postings for the 4 rarest terms)
N_ML_SENTENCES = 5_000  # the Python analyzer takes ~55 s per 100k
N_ZH_DOCS = 25_000  # cut, with N_RU_DOCS, to pay for phase 4r
ZH_SPLITS = {"train": 500, "dev": 150, "test": 150}
DEEP = dict(deep_terms=4, deep_cap=4096)
N_DEEP_QUERIES = 2 * RETRIEVE_BATCH
# docs of the 1M KB each native entry point meets its numpy twin on (an
# eighth of the KB, to keep the smoke inside its time; the whole pruned
# engine is built both ways over cli index's KB)
N_TWIN_DOCS = 125_000
TINY_RTOL = 1e-6        # float32 tiny sums in posting order vs float64
ML_WORDS = (
    # Latin with diacritics and the UAX#29 joins
    "café naïve résumé Zürich Ångström façade São Kraków Düsseldorf "
    "jalapeño Straße don't U.S.A. 3.14 1,000 foo_bar e-mail example.com "
    # Cyrillic, Greek (capital sigma lowers by context), Turkish dotted İ
    "Москва Санкт-Петербург Пушкин объём ЖУРНАЛ ёлка Київ ΟΔΥΣΣΕΥΣ "
    "Σίσυφος ΑΘΗΝΑΣ λόγος ΣΟΦΟΣ Ελλάς İstanbul DİYARBAKIR İzmir ılık "
    # Arabic (with its digits), Han, Kana, Hangul
    "القاهرة مكتبة العربية ٣٫١٤ محمد 北京大学 中文分词 東京 人工智能 研究生 "
    "カタカナ ひらがな テキスト 東京タワー すし 한국어 텍스트 "
    "the of and in city river").split()
ML_PUNCT = [" ", " ", " ", ", ", ". ", " — ", " (", ") ", "; ", "'", "·"]


def multilingual_sentences(n: int, seed: int):
    """``n`` seeded sentences of 6-17 words over Latin with diacritics,
    Cyrillic, Greek, Arabic, Han, Kana and Hangul words, dotted İ and
    final sigma, with punctuation and combining marks between them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(6, 18)
        w = rng.randint(0, len(ML_WORDS), k)
        p = rng.randint(0, len(ML_PUNCT), k)
        parts = []
        for i in range(k):
            word = ML_WORDS[w[i]]
            if rng.rand() < 0.05:
                word += "́"  # a combining acute accent (WB4)
            parts.append(word + ML_PUNCT[p[i]])
        out.append("".join(parts))
    return out


def zh_word_rows(n: int, seed: int):
    """``n`` seeded zh sentences as word lists: 6-14 words of the builtin
    lexicon, a third of them with a Latin word or a number among them."""
    from kbner_tpu_torch.retrieval.analyzer import builtin_zh_lexicon

    words = [w.strip() for w in builtin_zh_lexicon().read_text(
        encoding="utf-8").splitlines()
        if w.strip() and not w.startswith("#")]
    latin = ["Google", "ACL", "2022", "U.S.A", "Wikipedia", "3.14"]
    rng = np.random.RandomState(seed)
    rows = []
    for _ in range(n):
        k = rng.randint(6, 15)
        row = [words[i] for i in rng.randint(0, len(words), k)]
        if rng.rand() < 0.33:
            row.insert(rng.randint(0, k), latin[rng.randint(len(latin))])
        rows.append(row)
    return rows


def timed(fn):
    """(result of ``fn()``, its seconds on the host clock)."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def pruned_engine(text, title, store, dev):
    """The pruned engine ``cli retrieve`` builds over a saved KB (text and
    title index, doc store), the indexes' CSRs built anew; returns when
    the card has it."""
    import torch

    from kbner_tpu_torch.retrieval.engine import RetrievalEngine

    text._csr = title._csr = None
    eng = RetrievalEngine(text, store=store, title_index=title,
                          mode="pruned", device=dev)
    torch.cuda.synchronize()
    return eng


def numpy_twins(native):
    """A context in which the engine's and the index's host-side code
    (the build, and the tiny gather of every pruned batch) calls the
    numpy twins of the native runtime (``<entry point>_ref``)."""
    import contextlib

    names = ("build_csr", "csr_cap", "compact_tiny", "pack_ragged",
             "delta16_rows", "gather_tiny_exact")

    @contextlib.contextmanager
    def swap():
        saved = {n: getattr(native, n) for n in names}
        for n in names:
            setattr(native, n, getattr(native, f"{n}_ref"))
        try:
            yield
        finally:
            for n, fn in saved.items():
                setattr(native, n, fn)

    return swap()


def same_arrays(label, got, want) -> None:
    for a, b in zip(got, want):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{label}: the native result differs from "
                                 "its numpy twin")


def native_against_twins(index, queries, cap: int, tiny_cap: int,
                         card: str, n_docs: int = N_TWIN_DOCS) -> None:
    """Phase 4h (b): each postings helper of the native runtime on the
    first ``n_docs`` docs of the 1M KB's arrays beside its numpy twin,
    once each, native first: equal arrays (the tiny gather within
    TINY_RTOL of its float64 twin). Before it the whole pruned engine is
    built both ways over ``cli index``'s KB of :data:`N_INDEX_DOCS` docs,
    and natively over the saved 1M KB."""
    from kbner_tpu_torch import native
    from kbner_tpu_torch.retrieval import engine as eng

    dt, di = index.doc_terms[:n_docs], index.doc_impacts[:n_docs]
    V = len(index.vocab)
    times = {}

    def pair(name, fn, twin):
        got, t_native = timed(fn)
        want, t_twin = timed(twin)
        times[name] = (t_native, t_twin)
        return got, want

    csr, want = pair("build_csr", lambda: native.build_csr(dt, di, V),
                     lambda: native.build_csr_ref(dt, di, V))
    same_arrays("build_csr", csr, want)
    del want
    got, want = pair("csr_cap",
                     lambda: native.csr_cap(*csr, cap, tiny_cap),
                     lambda: native.csr_cap_ref(*csr, cap, tiny_cap))
    same_arrays("csr_cap", got, want)
    df = csr[3]
    rows, want = pair("compact_tiny",
                      lambda: native.compact_tiny(dt, di, df, tiny_cap),
                      lambda: native.compact_tiny_ref(dt, di, df, tiny_cap))
    same_arrays("compact_tiny", rows, want)
    del got, want
    dt2, di2 = rows
    # delta16 rows as the engine builds them: remap, norms, placement
    remap, _ = eng._nontiny_remap(df, tiny_cap)
    remap = remap.astype(np.int32)
    p = index.params
    dl = np.zeros(dt2.shape[0], np.int64)
    dl[:min(n_docs, len(index.doc_dl))] = index.doc_dl[:n_docs]
    norm = (p.k1 * (1.0 - p.b + p.b * dl / index.avgdl)).astype(np.float32)
    (lens, emit), t_lens = timed(
        lambda: native.delta16_rows(dt2, di2, remap, index.idf, norm))
    fields, t_fields = timed(lambda: native.delta16_fields_ref(
        dt2, di2, remap, index.idf, norm))
    if not np.array_equal(lens[:dt2.shape[0]], fields[4]):
        raise AssertionError("delta16_rows: slot counts differ from the "
                             "numpy twin's")
    off, nr = eng._place_length_groups(fields[4], 128,
                                       int(fields[4].max()))
    flats = [np.zeros(nr * 128, np.uint16) for _ in range(3)]
    _, t_emit = timed(lambda: emit(off, flats[0]))
    _, t_pack = timed(lambda: native.pack_delta16(*fields[:4], off,
                                                  flats[1]))
    _, t_pack_ref = timed(lambda: native.pack_delta16_ref(*fields[:4], off,
                                                          flats[2]))
    same_arrays("delta16_rows / pack_delta16", flats[:2], flats[1:])
    times["delta16_rows (counts + emit)"] = (t_lens + t_emit,
                                             t_fields + t_pack_ref)
    times["pack_delta16"] = (t_pack, t_pack_ref)
    del flats, fields
    code_bits = 32 - max(int(np.ceil(np.log2(V + 2))), 1)
    term_lo, step = eng._term_scale_from_csr(index, code_bits)
    lens2 = (dt2 >= 0).sum(axis=1)
    off2, nr2 = eng._place_length_groups(lens2, 128, dt2.shape[1])
    args = (dt2, di2, off2, 32 - code_bits, 0.0, step, (1 << code_bits) - 2)
    flats = [np.full(nr2 * 128, -1, np.int32) for _ in range(2)]
    pair("pack_ragged",
         lambda: native.pack_ragged(*args, flats[0], term_lo=term_lo),
         lambda: native.pack_ragged_ref(*args, flats[1], term_lo=term_lo))
    same_arrays("pack_ragged", flats[:1], flats[1:])
    del flats, rows, dt2, di2
    qt, qw = index.encode_queries(queries, max_query_terms=MAX_QUERY_TERMS)
    is_tiny = (qt >= 0) & (df[np.maximum(qt, 0)] <= tiny_cap)
    got, want = pair(
        "tiny_exact",
        lambda: native.gather_tiny_exact(*csr[:3], qt, qw, is_tiny),
        lambda: native.gather_tiny_exact_ref(*csr[:3], qt, qw, is_tiny))
    n_entries, worst = 0, 0.0
    for q in range(qt.shape[0]):
        order = np.argsort(got[0][q])
        real = got[0][q][order] >= 0
        if not np.array_equal(got[0][q][order][real],
                              want[0][q][want[0][q] >= 0]):
            raise AssertionError("tiny_exact: docs differ from the twin's")
        for i in (1, 2):
            a = got[i][q][order][real].astype(np.float64)
            b = want[i][q][want[0][q] >= 0].astype(np.float64)
            worst = max(worst, float((np.abs(a - b) / np.abs(b)).max(
                initial=0.0)))
        n_entries += int(real.sum())
    if worst > TINY_RTOL:
        raise AssertionError(f"tiny_exact: {worst:.3g} relative from its "
                             f"float64 twin (bar {TINY_RTOL})")
    log(f"native runtime against its numpy twins on the 1M KB's first "
        f"{dt.shape[0]} x {dt.shape[1]} doc rows ({len(csr[1])} postings; "
        f"cap {cap}, tiny "
        f"df <= {tiny_cap}; tiny_exact over {len(queries)} cli retrieve "
        f"queries, {n_entries} (query, doc) sums, largest relative gap "
        f"{worst:.3g}, bar {TINY_RTOL}), every other result array_equal; "
        "seconds native / numpy (host clock, one call each): "
        + "; ".join(f"{k} {a:.3f} / {b:.3f} ({b / max(a, 1e-9):.1f}x)"
                    for k, (a, b) in times.items()) + f" ({card})")


def analyzer_against_python(card: str, ascii_texts,
                            n: int = N_ML_SENTENCES) -> None:
    """Phase 4h (c), first half: the native batch analyzer on ``n``
    seeded multilingual sentences, and on the ASCII KB sentences
    ``ascii_texts``, in both modes against the Python analyzers, token
    for token, each timed once."""
    from kbner_tpu_torch import native
    from kbner_tpu_torch.retrieval.analyzer import (cjk_analyze,
                                                    standard_analyze)

    corpora = {"multilingual": multilingual_sentences(n, seed=31),
               "ASCII": list(ascii_texts)}
    (_, t_tables) = timed(native.analyzer_tables)
    parts = []
    for name, texts in corpora.items():
        for mode, python in (("standard", standard_analyze),
                             ("cjk", cjk_analyze)):
            want, t_py = timed(lambda: [python(t) for t in texts])
            got, t_nat = timed(lambda: native.analyze_docs(texts, mode=mode))
            if got != want:
                bad = next(i for i, (a, b) in enumerate(zip(got, want))
                           if a != b)
                raise AssertionError(
                    f"analyze_docs ({mode}) differs from the Python "
                    f"analyzer on {texts[bad]!r}")
            n_tok = sum(map(len, want))
            parts.append(f"{name} {mode}: {n_tok} tokens, Python "
                         f"{t_py:.2f} s, native {t_nat:.2f} s "
                         f"({t_py / t_nat:.1f}x)")
    n_ascii = sum(t.isascii() for t in corpora["multilingual"])
    log(f"analyze_docs on {n} multilingual sentences ({n_ascii} of them "
        f"ASCII; Latin with diacritics, Cyrillic, Greek, Arabic, Han, Kana, "
        f"Hangul, dotted I, final sigma, combining marks) and on "
        f"{len(ascii_texts)} ASCII KB sentences: tokens equal the Python "
        f"analyzers' in both modes; " + "; ".join(parts)
        + f"; Unicode tables ready in {t_tables:.2f} s (host clock) ({card})")


def zh_stage(cli, bm25, tmp, model_cfg, device, dev, card,
             n_docs: int = N_ZH_DOCS, splits=None) -> None:
    """Phase 4h (c), second half: ``cli index --lang zh --ik_dict
    builtin`` over ``n_docs`` seeded zh documents, then ``cli retrieve
    --lang zh`` of CoNLL splits of zh KB sentences against it, exhaustive
    and pruned: sentences/s, launches, pruned recall@K against
    exhaustive. Then K1 and K2 at this path's shapes, each held to its
    plain version: K1 on the zh KB's text and title fields for one
    ``cli retrieve`` batch of the train split with its gold entity
    clauses, K2 on the pruned engine's pass-2 operands for that batch."""
    import json

    from kbner_tpu_torch.data.conll import (SentenceRecord, read_column_file,
                                            write_column_file)
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.fusion import extract_entities
    from kbner_tpu_torch.retrieval.pipeline import load_kb, sentence_query

    splits = splits or ZH_SPLITS
    rows = zh_word_rows(n_docs, seed=41)
    with open(tmp / "zh.jsonl", "w", encoding="utf-8") as f:
        for i, row in enumerate(rows):
            text = "".join(row)
            f.write(json.dumps({"title": row[0], "sentence": text,
                                "paragraph": text,
                                "url": f"https://zh.wikipedia.org/wiki/{i}"},
                               ensure_ascii=False) + "\n")
    (stats, _), index_s = timed(lambda: run_cli(cli, [
        "index", "--kb", str(tmp / "zh.jsonl"), "--out", str(tmp / "zhkb"),
        "--lang", "zh", "--ik_dict", "builtin"]))
    meta = json.loads((tmp / "zhkb" / "meta.json").read_text())
    if meta != {"lang": "zh", "ik_dict": "ik.dic", "ik_smart": False}:
        raise AssertionError(f"cli index --lang zh: meta.json {meta}")
    log(f"cli index --lang zh --ik_dict builtin: {n_docs} zh docs from "
        f"JSONL in {index_s:.1f} s ({n_docs / index_s:.0f} docs/s; IK "
        "segmentation in Python) split " + ", ".join(
            f"{k} {v:.1f} s" for k, v in stats.items() if k != "docs")
        + f" ({card})")
    rng = np.random.RandomState(42)
    data = tmp / "zh-conll"
    for split, n in splits.items():
        recs = []
        for i, d in enumerate(rng.randint(0, n_docs, n)):
            toks = rows[d][:8]
            recs.append(SentenceRecord(
                tokens=toks, tags={"ner": ["B-PER"] + ["O"] * (len(toks) - 1)},
                comment=f"# id {split}-{i}"))
        write_column_file(data / f"{split}.txt", recs)
    outs, parts = {}, []
    for mode in ("exhaustive", "pruned"):
        reset_counts(bm25)
        (st, _), wall = timed(lambda: run_cli(cli, [
            "retrieve", "--index_dir", str(tmp / "zhkb"), "--lang", "zh",
            "--data_folder", str(data), "--out", str(tmp / f"zh-{mode}"),
            "--engine_mode", mode, "--tokenizer_config", str(model_cfg),
            *device]))
        got = counts(bm25)
        expect_counts(f"cli retrieve --lang zh ({mode})", got,
                      {"delta16_rescore": None} if mode == "pruned"
                      else {"bm25_score_block": None})
        outs[mode] = tmp / f"zh-{mode}"
        n_sent = sum(t["sentences"] for t in st.values())
        secs = sum(v for t in st.values() for k, v in t.items()
                   if k != "sentences")
        parts.append(f"{mode}: {n_sent} sentences in {wall:.1f} s with the "
                     f"KB open and the engine build ({n_sent / secs:.0f} "
                     f"sentences/s over the splits' stages), launches {got}")
    recall = min(retrieval_recall(outs["exhaustive"] / f"{s}.retrieval.tsv",
                                  outs["pruned"] / f"{s}.retrieval.tsv")
                 for s in splits)
    log("cli retrieve --lang zh over the IK-indexed KB: " + "; ".join(parts)
        + f"; pruned against exhaustive recall@{K} {recall:.4f} in the "
        f"worst split (bar {MIN_RECALL}) ({card})")
    if recall < MIN_RECALL:
        raise AssertionError(f"cli retrieve --lang zh (pruned) recall@{K} "
                             f"{recall:.4f} is below {MIN_RECALL}")
    # K1 and K2 at the zh path's shapes, on the engines cli retrieve builds
    text, store, title, _ = load_kb(tmp / "zhkb")
    recs = read_column_file(data / "train.txt", {0: "text", 1: "ner"},
                            comment_symbol="# id")[:RETRIEVE_BATCH]
    queries = [sentence_query(r, "zh") for r in recs]
    exhaustive = RetrievalEngine(text, store=store, title_index=title,
                                 device=dev)
    k1 = k1_at_retrieve_shape(bm25, exhaustive, queries,
                              [extract_entities(r) for r in recs], dev)
    del exhaustive
    pruned = RetrievalEngine(text, store=store, title_index=title,
                             mode="pruned", device=dev)
    k2 = k2_at_retrieve_shape(bm25, pruned, queries)
    del pruned
    store.close()
    log(f"bm25_score_block at one cli retrieve --lang zh batch of the train "
        f"split, the zh KB's fields, entity clauses from gold seeds: {k1}; "
        f"delta16_rescore on the zh pruned engine's pass-2 operands for "
        f"that batch: {k2} ({card})")


def recall_at_k(exact, got) -> float:
    """Mean recall@K of ``got`` against ``exact`` (one (scores, ids) per
    batch) over the queries whose exact top-k has a positive score."""
    recalls = []
    for (es, ei), (gs, gi) in zip(exact, got):
        for q in range(ei.shape[0]):
            want = {int(d) for d, x in zip(ei[q], es[q]) if x > 0}
            if want:
                found = {int(d) for d, x in zip(gi[q], gs[q])
                         if d >= 0 and x > 0}
                recalls.append(len(want & found) / len(want))
    return float(np.mean(recalls))


def batch_results(engine, queries, entities=None):
    """(scores, ids) of ``engine.search_encoded`` per ``cli retrieve``
    batch of sentence queries, with title-boosted entity clauses where
    ``entities`` is given."""
    out = []
    for i in range(0, len(queries), RETRIEVE_BATCH):
        qt, qw = engine.text_index.encode_queries(
            queries[i:i + RETRIEVE_BATCH], max_query_terms=MAX_QUERY_TERMS)
        tt = tw = None
        if entities is not None:
            ents = [" ".join(e) for e in entities[i:i + RETRIEVE_BATCH]]
            tt, tw = engine.title_index.encode_queries(
                ents, max_query_terms=MAX_QUERY_TERMS,
                boosts=[TITLE_BOOST] * len(ents))
        out.append(engine.search_encoded(qt, qw, k=K, title_terms=tt,
                                         title_weights=tw))
    return out


def kb_stage_phase(engine, docs, title_docs, encoded, exact, requests, bm25,
                   dev, card, tmp, model_dir, encoder="large", splits=None,
                   n_dump_pages=N_DUMP_PAGES, n_serve_kb=N_SERVE_KB_DOCS,
                   n_index=N_INDEX_DOCS,
                   n_ml=N_ML_SENTENCES, n_zh=N_ZH_DOCS, zh_splits=None
                   ):
    """The recipe's first stage through the port's CLI: (a) ``cli
    ingest-dump`` on a synthetic dump and ``cli index`` on a JSONL of the
    first ``n_index`` KB sentences, reopened and held to an exhaustive
    engine over ``build_encoded``'s index of those docs; the main path's KB
    (``engine``'s indices and rendered docs) saved with ``save_kb``,
    reopened with ``load_kb`` and held to ``engine``; (b) the native host
    runtime against its numpy twins on that KB, and the pruned engine
    built both ways; ``cli retrieve --index_dir`` over CoNLL splits of KB
    sentences in four engine settings; (c) the native analyzer against
    the Python one on ``n_ml`` multilingual sentences, and a zh KB of
    ``n_zh`` docs through ``cli index`` and ``cli retrieve``; (d) deep
    pass-1 windows against the plain pruned engine; then ``cli retrieve``
    with the trained model in ``model_dir`` predicting the entity seeds,
    and with BERTScore reranking; ``cli serve --index_dir`` and ``--kb
    --store`` (over the first ``n_serve_kb`` docs) held to the in-memory
    engine. Returns the pruned engine over the saved KB, which phase 4q's
    pruned ``cli retrieve`` shares, and its open doc store."""
    import json
    from pathlib import Path

    import torch

    import kbner_tpu_torch.cli as cli
    from kbner_tpu_torch.cli import serving_tagger
    from kbner_tpu_torch.config import ServeConfig
    from kbner_tpu_torch.data.conll import (SentenceRecord, read_column_file,
                                            write_column_file)
    from kbner_tpu_torch.data.dictionary import Dictionary
    from kbner_tpu_torch.data.subword import HashTokenizer, subtoken_length
    from kbner_tpu_torch.retrieval.docstore import PackedDocStore
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.fusion import extract_entities
    from kbner_tpu_torch.retrieval.index import BM25Index
    from kbner_tpu_torch.retrieval.pipeline import (load_kb, save_kb,
                                                    sentence_query)
    from kbner_tpu_torch import native
    from kbner_tpu_torch.retrieval.synth import sentence_queries
    from kbner_tpu_torch.serve import serve
    from kbner_tpu_torch.train import FinetuneTrainer

    splits = splits or SPLITS
    tmp = Path(tmp)
    index, title_index = engine.text_index, engine.title_index
    device = ["--device", str(dev)]

    # -- (a) cli ingest-dump, cli index -------------------------------------
    t0 = time.perf_counter()
    n_red = synth_dump(tmp / "dump.xml.bz2", n_dump_pages, seed=11)
    dump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(cli, ["ingest-dump", "--dump", str(tmp / "dump.xml.bz2"),
                  "--out", str(tmp / "wiki.jsonl")])
    ingest_s = time.perf_counter() - t0
    recs = [json.loads(line) for line in
            (tmp / "wiki.jsonl").read_text(encoding="utf-8").splitlines()]
    titles = {r["title"] for r in recs}
    anchored = sum("<e:Page " in r["paragraph"] for r in recs)
    if (len(titles) != n_dump_pages or anchored == 0
            or any("<e:Redirect " in r["paragraph"] for r in recs)
            or any("{{" in r["sentence"] or "<ref" in r["sentence"]
                   for r in recs)):
        raise AssertionError("cli ingest-dump: the JSONL misses pages, "
                             "anchors, or kept markup or an unresolved "
                             "redirect")
    log(f"cli ingest-dump: {n_dump_pages} articles and {n_red} redirects "
        f"(bz2, written in {dump_s:.1f} s, set-up) -> {len(recs)} sentence "
        f"records in {ingest_s:.2f} s ({len(recs) / ingest_s:.0f} records/s"
        f"), {anchored} with link anchors, every link through a redirect "
        "resolved")

    # cli index over the first n_index KB sentences, from JSONL
    rows, render_s = timed(lambda: kb_rows(docs, title_docs, 0,
                                           index.n_docs))
    t0 = time.perf_counter()
    keys = ("sentence", "paragraph", "title", "url")
    with open(tmp / "kb.jsonl", "w", encoding="utf-8") as f:
        f.writelines(json.dumps(dict(zip(keys, r))) + "\n"
                     for r in rows[:n_index])
    with open(tmp / "kb-serve.jsonl", "w", encoding="utf-8") as f:
        f.writelines(json.dumps(dict(zip(keys, r))) + "\n"
                     for r in rows[:n_serve_kb])
    jsonl_s = time.perf_counter() - t0
    (stats, _), index_s = timed(lambda: run_cli(cli, [
        "index", "--kb", str(tmp / "kb.jsonl"), "--out",
        str(tmp / "kb-jsonl")]))
    (text_j, store_j, title_j, _), open_s = timed(
        lambda: load_kb(tmp / "kb-jsonl"))
    from_jsonl = RetrievalEngine(text_j, store=store_j, title_index=title_j,
                                 device=dev)
    texts = [" ".join(r["tokens"]) for r in requests]
    cut = BM25Index.build_encoded(docs[:n_index], index.vocab)
    on_cut = RetrievalEngine(cut, device=dev)
    assert_same_results(
        "cli index from JSONL against build_encoded",
        [on_cut.search_encoded(*cut.encode_queries(
            texts[i:i + BATCH], max_query_terms=MAX_QUERY_TERMS), k=K)
         for i in range(0, len(texts), BATCH)],
        [from_jsonl.search_encoded(*text_j.encode_queries(
            texts[i:i + BATCH], max_query_terms=MAX_QUERY_TERMS), k=K)
         for i in range(0, len(texts), BATCH)])
    del on_cut, cut
    log(f"cli index: {stats['docs']} docs from JSONL in {index_s:.1f} s "
        f"({stats['docs'] / index_s:.0f} docs/s; rendered in {render_s:.1f} "
        f"s and written as JSONL in {jsonl_s:.1f} s, set-up): text index "
        f"analysis {stats['analysis']:.1f} s (native, standard), "
        f"vocabulary {stats['vocabulary']:.1f} s (sorted unique tokens), "
        f"layout {stats['layout']:.1f} s; title index {stats['title']:.1f} "
        f"s; reading the JSONL and the packed doc store {stats['read']:.1f} "
        f"s; save {stats['save']:.1f} s; reopened with load_kb in "
        f"{open_s:.2f} s; the top-{K} of the {len(texts)} served queries "
        f"equals an exhaustive engine's over build_encoded's index of the "
        f"same docs, by doc id within ties ({card})")
    # the pruned engine as cli retrieve builds it, over this KB through the
    # numpy twins and then natively (each with its own CSR build)
    del from_jsonl
    with numpy_twins(native):
        twin, twin_s = timed(lambda: pruned_engine(text_j, title_j, store_j,
                                                   dev))
    native_eng, native_s = timed(lambda: pruned_engine(text_j, title_j,
                                                       store_j, dev))
    for name in ("text", "title"):
        for a, b in zip(native_eng.rows[name] + native_eng.csr[name],
                        twin.rows[name] + twin.csr[name]):
            if not torch.equal(a, b):
                raise AssertionError(f"the pruned engine's {name} arrays "
                                     "differ between its native and numpy "
                                     "builds")
    log(f"pruned engine over cli index's {text_j.n_docs} docs (cli "
        f"retrieve's knobs): built in {native_s:.1f} s with the native "
        f"runtime, {twin_s:.1f} s with its numpy twins (host clock, twins "
        f"first, each with its CSR build); every row and CSR array on the "
        f"card equal ({card})")
    del twin, native_eng, text_j, title_j
    store_j.close()

    # -- (b) the full-size saved KB ----------------------------------------
    kb_dir = tmp / "kb1m"
    t0 = time.perf_counter()
    store = PackedDocStore.build(kb_dir / "kb.docs", rows)
    save_kb(kb_dir, index, store, title_index)
    store.close()
    save_s = time.perf_counter() - t0
    ascii_texts = [r[0] for r in rows[:n_ml]]
    del rows
    t0 = time.perf_counter()
    text1m, store1m, title1m, _ = load_kb(kb_dir)
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reopened = RetrievalEngine(text1m, store=store1m, title_index=title1m,
                               device=dev)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    assert_same_results("the saved 1M KB", exact,
                        [reopened.search_encoded(*e, k=K) for e in encoded])
    hits = [(int(d), float(x)) for s_b, i_b in exact
            for d, x in zip(i_b.ravel(), s_b.ravel()) if x > 0]
    t0 = time.perf_counter()
    for d, x in hits:
        store1m.materialize(d, x)
    mat_us = (time.perf_counter() - t0) / len(hits) * 1e6
    sizes = {p.name: p.stat().st_size for p in kb_dir.iterdir()}
    log(f"saved KB: {index.n_docs} docs rendered in {render_s:.1f} s "
        f"(set-up); PackedDocStore.build and save_kb in {save_s:.1f} s "
        f"({sizes['kb.docs'] / 1e6:.1f} "
        f"MB kb.docs, {sizes['text.idx'] / 1e6:.1f} MB text.idx, "
        f"{sizes['title.idx'] / 1e6:.1f} MB title.idx); load_kb "
        f"{open_s:.2f} s, upload to the card {upload_s:.2f} s; its top-{K} "
        f"for the {sum(e[0].shape[0] for e in encoded)} served queries equals "
        f"the in-memory engine's; materialize {mat_us:.2f} us per hit over "
        f"{len(hits)} hits (host clock, page cache warm)")

    # -- (c) cli retrieve --index_dir -----------------------------------------
    data = tmp / "conll"
    seed = 20
    for split, n in splits.items():
        rows, _ = sentence_queries(docs, n, q_len=MAX_QUERY_TERMS, seed=seed)
        seed += 1
        write_column_file(data / f"{split}.txt", [SentenceRecord(
            tokens=[f"w{t}" for t in r[r >= 0]],
            tags={"ner": ["B-PER", "I-PER"] + ["O"] * (int((r >= 0).sum())
                                                      - 2)},
            comment=f"# id {split}-{i}") for i, r in enumerate(rows)])
    # K1 and K2 at the retrieve shape, on one batch of the train split
    train_recs = read_column_file(data / "train.txt", {0: "text", 1: "ner"},
                                  comment_symbol="# id")
    queries = [sentence_query(r) for r in train_recs]
    first = train_recs[:RETRIEVE_BATCH]
    log("bm25_score_block at one cli retrieve batch of the train split, "
        "the saved KB's fields, entity clauses from gold seeds: "
        + k1_at_retrieve_shape(bm25, reopened, queries[:RETRIEVE_BATCH],
                               [extract_entities(r) for r in first], dev)
        + f" ({card})")
    # (d)'s exhaustive reference: the first train batches, with and
    # without their gold entity clauses
    deep_q = queries[:N_DEEP_QUERIES]
    deep_e = [extract_entities(r) for r in train_recs[:N_DEEP_QUERIES]]
    deep_exact = {"served": batch_results(reopened, deep_q),
                  "with entities": batch_results(reopened, deep_q, deep_e)}
    del reopened

    # -- (b) the native runtime against its numpy twins ----------------------
    # the pruned engine built natively as cli retrieve builds it (both ways
    # over cli index's KB above); it serves both pruned cli runs below
    torch.cuda.synchronize()
    pruned, pruned_s = timed(lambda: pruned_engine(text1m, title1m, store1m,
                                                   dev))
    log(f"pruned engine over the saved 1M KB (cli retrieve's knobs): built "
        f"in {pruned_s:.1f} s with the native runtime, its CSR build "
        f"included (host clock) ({card})")
    native_against_twins(index, queries[:RETRIEVE_BATCH],
                         pruned.per_term_cap, pruned.tiny_cap, card)
    log(f"delta16_rescore on search_stream's operands for one cli retrieve "
        f"batch of the train split (the pruned engine over the saved KB): "
        + k2_at_retrieve_shape(bm25, pruned, queries[:RETRIEVE_BATCH])
        + f" ({card})")
    loop_s, stream_s = stream_against_per_batch(pruned, queries)
    log(f"search_stream against a per-batch loop (encode, search_encoded) "
        f"over the train split's {len(queries)} sentence queries in "
        f"{RETRIEVE_BATCH}-query batches on that engine, timed in turns "
        f"(host clock): per-batch {loop_s[0]:.3f}, {loop_s[1]:.3f} s; "
        f"stream {stream_s[0]:.3f}, {stream_s[1]:.3f} s; every run's scores "
        f"equal the first's exactly, ids within ties ({card})")
    nat_s, twin_s = stream_native_against_twin(pruned, queries, native)
    log(f"search_stream over the same {len(queries)} queries with the "
        f"native tiny gather and with its numpy twin, timed in turns (host "
        f"clock): native {nat_s[0]:.3f}, {nat_s[1]:.3f} s; twin "
        f"{twin_s[0]:.3f}, {twin_s[1]:.3f} s; scores equal run to run, "
        f"native against twin within rtol {SCORE_RTOL}, ids within ties "
        f"({card})")
    model_cfg = tmp / "model.yaml"
    model_cfg.write_text(json.dumps({
        "name": "kb-stage", "tokenizer": {"type": "hash",
                                          "vocab_size": HASH_VOCAB},
        "model": {"encoder": encoder}, "target_dir": str(model_dir)}))
    tokenizer = HashTokenizer(vocab_size=HASH_VOCAB)
    common = ["retrieve", "--index_dir", str(kb_dir), "--tokenizer_config",
              str(model_cfg), *device]
    outs = {}
    engine_class = cli.RetrievalEngine

    def shared_pruned(*args, mode="exhaustive", **kwargs):
        if mode == "pruned":
            return pruned
        return engine_class(*args, mode=mode, **kwargs)

    cli.RetrievalEngine = shared_pruned
    try:
        for label, extra in RETRIEVE_RUNS:
            out = tmp / f"fused-{len(outs)}"
            outs[label] = out
            reset_counts(bm25)
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            stats, _ = run_cli(cli, [*common, "--data_folder", str(data),
                                     "--out", str(out), *extra])
            wall = time.perf_counter() - t0
            got = counts(bm25)
            is_pruned = "--engine_mode" in extra
            expect_counts(f"cli retrieve ({label})", got,
                          {"delta16_rescore": None} if is_pruned
                          else {"bm25_score_block": None})
            peak = torch.cuda.max_memory_allocated() / 1e9
            for split in splits:
                fused = read_column_file(out / f"{split}.txt",
                                         {0: "text", 1: "ner"},
                                         comment_symbol="# id")
                # the fusion budget's count: <EOS> is one subtoken
                longest = max(subtoken_length(tokenizer, [
                    w for w in r.tokens if w != "<EOS>"])
                    + ("<EOS>" in r.tokens) for r in fused)
                n_ctx = sum("<EOS>" in r.tokens for r in fused)
                if (len(fused) != splits[split] or longest > 510
                        or n_ctx == 0):
                    raise AssertionError(
                        f"cli retrieve ({label}) {split}: {len(fused)} "
                        f"fused sentences, {n_ctx} with context, longest "
                        f"{longest} subtokens")
            split_s = {split: sum(v for k, v in t.items()
                                  if k != "sentences")
                       for split, t in stats.items()}
            log(f"cli retrieve --index_dir ({label}): {wall:.1f} s, of "
                f"which {wall - sum(split_s.values()):.1f} s opening the KB "
                + ("and handing over the shared pruned engine" if is_pruned
                   else "and building the engine")
                + f"; launches {got}; peak allocated "
                f"{peak:.2f} GB; per split: " + "; ".join(
                    f"{split} {t['sentences']} sentences "
                    f"{t['sentences'] / split_s[split]:.0f}/s (retrieve "
                    f"{t['retrieve']:.2f} s, write {t['write']:.2f} s, "
                    f"fuse {t['fuse']:.2f} s, read {t['read']:.2f} s)"
                    for split, t in stats.items())
                + f"; every fused file parses, every sentence within 510 "
                f"subtokens ({card})")
    finally:
        cli.RetrievalEngine = engine_class
    for ex_label, pr_label in (("exhaustive", "pruned"),
                               ("exhaustive + entities",
                                "pruned + entities")):
        recall = min(retrieval_recall(outs[ex_label] / f"{s}.retrieval.tsv",
                                      outs[pr_label] / f"{s}.retrieval.tsv")
                     for s in splits)
        log(f"cli retrieve: {pr_label} against {ex_label}, recall@{K} "
            f"{recall:.4f} in the worst split (bar {MIN_RECALL})")
        if recall < MIN_RECALL:
            raise AssertionError(f"cli retrieve ({pr_label}) recall@{K} "
                                 f"{recall:.4f} is below {MIN_RECALL}")

    # -- (c) the native analyzer, and a zh KB --------------------------------
    analyzer_against_python(card, ascii_texts, n_ml)
    zh_stage(cli, bm25, tmp, model_cfg, device, dev, card, n_zh, zh_splits)

    # -- (d) deep pass-1 windows, beside the shared pruned engine ----------
    t0 = time.perf_counter()
    deep = RetrievalEngine(text1m, store=store1m, title_index=title1m,
                           mode="pruned", device=dev, **DEEP)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    parts = []
    for label, exact_b in deep_exact.items():
        ents = deep_e if label == "with entities" else None
        r_plain = recall_at_k(exact_b, batch_results(pruned, deep_q, ents))
        reset_counts(bm25)
        r_deep = recall_at_k(exact_b, batch_results(deep, deep_q, ents))
        expect_counts(f"deep windows ({label})", counts(bm25),
                      {"delta16_rescore": len(exact_b)})
        parts.append(f"{label} {r_deep:.4f} (plain pruned {r_plain:.4f})")
        if r_deep < MIN_RECALL:
            raise AssertionError(f"deep windows ({label}) recall@{K} "
                                 f"{r_deep:.4f} is below {MIN_RECALL}")
    csr_bytes = [sum(t.nbytes for t in e.csr["text"])
                 for e in (pruned, deep)]
    log(f"deep windows (deep_terms={deep.deep_terms}, deep_cap="
        f"{deep.deep_cap}, per_term_cap={deep.per_term_cap}) on the saved 1M "
        f"KB, built in {build_s:.1f} s: recall@{K} against "
        f"exhaustive over the first {len(deep_q)} train queries: "
        + ", ".join(parts) + f"; text CSR on the card {csr_bytes[1] / 1e6:.1f}"
        f" MB, {csr_bytes[0] / 1e6:.1f} MB without deep windows ({card})")
    log("delta16_rescore on the deep engine's pass-2 operands for one cli "
        "retrieve batch of the train split: "
        + k2_at_retrieve_shape(bm25, deep, queries[:RETRIEVE_BATCH])
        + f" ({card})")
    del deep

    # -- (d) the trained model's seeds, and BERTScore reranking -------------
    held = tmp / "conll-held"
    for split in ("dev", "test"):
        write_column_file(held / f"{split}.txt",
                          read_column_file(data / f"{split}.txt",
                                           {0: "text", 1: "ner"},
                                           comment_symbol="# id"))
    reset_counts(bm25)
    t0 = time.perf_counter()
    stats, _ = run_cli(cli, [*common, "--data_folder", str(held), "--out",
                             str(tmp / "seeded"), "--with_entity",
                             "--model_config", str(model_cfg)])
    seeded_s = time.perf_counter() - t0
    got = counts(bm25)
    expect_counts("cli retrieve --model_config", got,
                  {"bm25_score_block": None})
    log(f"cli retrieve --with_entity --model_config (XLM-R large from "
        f"phase 4g's best-model.msgpack predicts the entity seeds of dev "
        f"and test): {seeded_s:.1f} s with the checkpoint load; seeds "
        + ", ".join(f"{s} {t['seeds']:.2f} s" for s, t in stats.items())
        + f"; launches {got} ({card})")
    dev_only = tmp / "conll-dev"
    write_column_file(dev_only / "dev.txt", read_column_file(
        data / "dev.txt", {0: "text", 1: "ner"}, comment_symbol="# id"))
    embed_ms = []
    inner = FinetuneTrainer.embed_texts

    def timed_embed(self, texts, batch_size=64):
        out = {}
        embed_ms.append(event_ms(lambda: out.setdefault(
            "v", inner(self, texts, batch_size))))
        return out["v"]

    FinetuneTrainer.embed_texts = timed_embed
    torch.cuda.reset_peak_memory_stats()
    try:
        stats, _ = run_cli(cli, [*common, "--data_folder", str(dev_only),
                                 "--out", str(tmp / "reranked"), "--rerank",
                                 "bertscore", "--model_config",
                                 str(model_cfg)])
    finally:
        FinetuneTrainer.embed_texts = inner
    before = query_blocks(outs["exhaustive"] / "dev.retrieval.tsv")
    after = query_blocks(tmp / "reranked" / "dev.retrieval.tsv")
    if before != after:
        raise AssertionError("a BERTScore-reranked list is not a "
                             "permutation of the exhaustive one")
    moved = sum(a != b for a, b in zip(
        (tmp / "reranked" / "dev.retrieval.tsv").read_text().split("\n\n"),
        (outs["exhaustive"] / "dev.retrieval.tsv").read_text().split(
            "\n\n")))
    n_texts = sum(1 + len(lines) for _, lines in before)
    log(f"cli retrieve --rerank bertscore (dev, {len(before)} sentences): "
        f"every reranked list is a permutation of the exhaustive one, "
        f"{moved} reordered; the encoder embeds {n_texts} texts in "
        f"{sum(embed_ms):.1f} ms on the card (CUDA events) in "
        f"{len(embed_ms)} call(s) of up to 1024 queries with their "
        f"contexts, rerank stage {stats['dev']['rerank']:.2f} s, peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB with "
        f"the model and the 1M-doc engines resident ({card})")

    # -- (e) cli serve --index_dir, and --kb --store --------------------------
    batch = requests[:BATCH]
    stdin = "\n".join(json.dumps(r) for r in batch) + "\n"
    reset_counts(bm25)
    t0 = time.perf_counter()
    _, out = run_cli(cli, ["serve", "--config", str(model_cfg),
                           "--index_dir", str(kb_dir), *device], stdin)
    serve_s = time.perf_counter() - t0
    served = counts(bm25)
    expect_counts("cli serve --index_dir", served,
                  {"bm25_score_block": None})
    got = [json.loads(line) for line in out.splitlines()]
    config = ServeConfig.from_file(model_cfg)
    tag_dict = Dictionary.load(Path(model_dir) / "tag_dictionary.json")
    tagger = serving_tagger(config, tag_dict, dev)
    want = serve(batch, engine, tagger, config.make_tokenizer(), tag_dict,
                 k=K, batch_size=BATCH)
    if got != json.loads(json.dumps(want)):
        raise AssertionError("cli serve --index_dir answers differ from "
                             "the in-memory engine's")
    small = [{"id": i, "tokens": t.split()}
             for i, t in enumerate(texts[:BATCH])]
    stdin_small = "\n".join(json.dumps(r) for r in small) + "\n"
    answers = [run_cli(cli, ["serve", "--config", str(model_cfg), "--kb",
                             str(tmp / "kb-serve.jsonl"), *opt, *device],
                       stdin_small)[1]
               for opt in ([], ["--store", str(tmp / "serve.docs")])]
    if answers[0] != answers[1] or not answers[0]:
        raise AssertionError("cli serve --kb --store answers differ from "
                             "--kb's")
    log(f"cli serve --index_dir (the saved 1M KB, the trained checkpoint in "
        f"bf16): {len(got)} requests in {serve_s:.1f} s with the KB open and "
        f"the checkpoint load, launches {served}; responses equal serve() "
        f"on the in-memory engine with the same tagger; --kb --store over "
        f"the first {n_serve_kb} docs' JSONL answers as --kb does ({card})")
    return pruned, store1m



# phase 4q: the port's own tokenizer.json reader on the served and the
# offline path, over 4h's saved 1M KB with 4g's trained checkpoint (XLM-R
# large, 250,002 vocabulary rows, so the HF ids index it as they stand)
HF_PIECES = 249_997     # + 4 specials + <mask>: XLM-R's 250,002 ids
ROBERTA_MERGES = 50_004  # + 4 specials, 256 bytes, <mask>: roberta-base's
MBERT_PIECES = 119_443   # + 104 specials: bert-base-multilingual-cased's


def encoded_pieces(tokenizer, rec, max_subtokens: int = 512) -> list:
    """The ids ``encode_batch`` gives ``rec``: CLS, each word's pieces
    (``<EOS>`` as SEP) while they fit, SEP."""
    from kbner_tpu_torch.data.conll import EOS_MARKER

    ids = [tokenizer.cls_id]
    for w in rec.tokens:
        piece = ([tokenizer.sep_id] if w == EOS_MARKER
                 else tokenizer.encode_word(w))
        if len(ids) + len(piece) + 1 > max_subtokens:
            break
        ids += piece
    return ids + [tokenizer.sep_id]


def tokenizer_rates(make, words):
    """A tokenizer directory read by ``make()`` and ``encode_word`` over
    ``words``, uncached (each distinct word once) and cached (host
    clock): the tokenizer and the summary."""
    tok, load_s = timed(make)
    distinct = sorted(set(words))
    _, cold_s = timed(lambda: [tok.encode_word(w) for w in distinct])
    _, warm_s = timed(lambda: [tok.encode_word(w) for w in words])
    pieces = sum(map(tok.word_length, words))
    return tok, (f"read by HFTokenizer in {load_s:.2f} s; encode_word over 4h's "
            f"en dev split ({len(words)} words, {len(distinct)} distinct, "
            f"{pieces / len(words):.2f} pieces a word): uncached "
            f"{len(distinct) / cold_s:.0f} words/s, cached "
            f"{len(words) / warm_s:.0f} words/s (host clock; "
            f"{host_line()})")


def hf_tokenizer_phase(cli, bm25, dev, card, tmp, engine, requests,
                       model_dir, pruned, n_pieces=HF_PIECES,
                       roberta_merges=ROBERTA_MERGES,
                       mbert_pieces=MBERT_PIECES) -> None:
    """(a) the seeded XLM-R-shaped tokenizer (``synth_tokenizer``) written
    and read by ``HFTokenizer``, and ``encode_word`` over 4h's en dev
    split, uncached and cached (host clock); (b) ``cli serve --config``
    with ``tokenizer: {type: hf, dir}`` over ``--index_dir`` (exhaustive),
    one micro-batch (:func:`hf_serve_run`); (c) ``cli retrieve
    --hf_tokenizer`` over the dev split, exhaustive (K1) and pruned (K2, on
    4h's pruned engine over the same KB, handed over as 4h's pruned runs
    get it): every fused sentence within 510 subtokens by the HF
    tokenizer's count, the sentences whose fusion differs from 4h's
    hash-proxy files counted; (d) (b) with the seeded RoBERTa-shaped
    ByteLevel BPE (roberta-base's 50,265 ids); (e) (c)'s pruned run with
    the seeded mBERT-shaped WordPiece (BertNormalizer, BertPreTokenizer;
    119,547 ids)."""
    from pathlib import Path

    from kbner_tpu_torch.data.conll import read_column_file, write_column_file
    from kbner_tpu_torch.data.subword import HFTokenizer
    from kbner_tpu_torch.data.synth_tokenizer import (
        write_mbert_like_tokenizer, write_roberta_like_tokenizer,
        write_xlmr_like_tokenizer)

    t_phase = time.perf_counter()
    tmp = Path(tmp)
    kb_dir = tmp / "kb1m"
    device = ["--device", str(dev)]
    dev_recs = read_column_file(tmp / "conll" / "dev.txt",
                                {0: "text", 1: "ner"}, comment_symbol="# id")
    words = [w for r in dev_recs for w in r.tokens]

    # -- (a) the tokenizer ----------------------------------------------------
    tok_dir, write_s = timed(lambda: write_xlmr_like_tokenizer(
        tmp / "hf-tok", n_pieces=n_pieces, seed=0))
    tok, rates = tokenizer_rates(lambda: HFTokenizer(str(tok_dir)), words)
    if tok.vocab_size != n_pieces + 5 or tok.encode_word("<mask>") != [
            n_pieces + 4]:
        raise AssertionError(f"phase 4q: the synth tokenizer has "
                             f"{tok.vocab_size} ids, <mask> "
                             f"{tok.encode_word('<mask>')}")
    log(f"phase 4q (a): the synth XLM-R tokenizer ({tok.vocab_size} ids, "
        f"Precompiled charsmap, WhitespaceSplit + Metaspace) written in "
        f"{write_s:.2f} s and " + rates)

    # -- (b) cli serve with tokenizer: {type: hf, dir} --------------------
    log("phase 4q (b): " + hf_serve_run(
        cli, bm25, dev, card, tmp, engine, requests, model_dir, tok_dir,
        "model-hf.yaml"))

    # -- (c) cli retrieve --hf_tokenizer -------------------------------------
    data = tmp / "conll-hf"
    write_column_file(data / "dev.txt", dev_recs)
    engine_class = cli.RetrievalEngine

    def shared_pruned(*args, mode="exhaustive", **kwargs):
        if mode == "pruned":
            return pruned
        return engine_class(*args, mode=mode, **kwargs)

    def retrieve(runs, tok_dir, tokenizer, tag):
        cli.RetrievalEngine = shared_pruned
        try:
            return [hf_retrieve_run(cli, bm25, tmp, i, label, extra, kb_dir,
                                    tok_dir, data, dev_recs, tokenizer,
                                    device, tag)
                    for i, (label, extra) in runs]
        finally:
            cli.RetrievalEngine = engine_class

    parts = retrieve(list(enumerate(RETRIEVE_RUNS[:2])), tok_dir, tok, "")
    log(f"phase 4q (c): cli retrieve --index_dir --hf_tokenizer over 4h's en "
        f"dev split: " + "; ".join(parts) + f"; every fused sentence within "
        f"510 subtokens by the HF tokenizer's count ({card})")

    # -- (d) cli serve with a RoBERTa-shaped ByteLevel BPE -------------------
    rob_dir, write_s = timed(lambda: write_roberta_like_tokenizer(
        tmp / "hf-roberta", n_merges=roberta_merges, seed=0))
    rob, rates = tokenizer_rates(lambda: HFTokenizer(str(rob_dir)), words)
    if (rob.vocab_size, rob.cls_id, rob.sep_id, rob.pad_id) != (
            roberta_merges + 261, 0, 2, 1):
        raise AssertionError(f"phase 4q (d): the synth RoBERTa tokenizer "
                             f"has {rob.vocab_size} ids, cls/sep/pad "
                             f"{rob.cls_id}/{rob.sep_id}/{rob.pad_id}")
    log(f"phase 4q (d): the synth RoBERTa tokenizer ({rob.vocab_size} ids, "
        f"{roberta_merges} merges, ByteLevel) written in {write_s:.2f} s and "
        + rates)
    log("phase 4q (d): " + hf_serve_run(
        cli, bm25, dev, card, tmp, engine, requests, model_dir, rob_dir,
        "model-hf-roberta.yaml"))

    # -- (e) pruned cli retrieve with an mBERT-shaped WordPiece -------------
    bert_dir, write_s = timed(lambda: write_mbert_like_tokenizer(
        tmp / "hf-mbert", n_pieces=mbert_pieces, seed=0))
    bert, rates = tokenizer_rates(lambda: HFTokenizer(str(bert_dir)), words)
    if (bert.vocab_size, bert.cls_id, bert.sep_id, bert.pad_id) != (
            mbert_pieces + 104, 101, 102, 0):
        raise AssertionError(f"phase 4q (e): the synth mBERT tokenizer "
                             f"has {bert.vocab_size} ids, cls/sep/pad "
                             f"{bert.cls_id}/{bert.sep_id}/{bert.pad_id}")
    log(f"phase 4q (e): the synth mBERT tokenizer ({bert.vocab_size} ids, "
        f"WordPiece, BertNormalizer + BertPreTokenizer) written in "
        f"{write_s:.2f} s and " + rates)
    parts = retrieve([(1, RETRIEVE_RUNS[1])], bert_dir, bert, "-mbert")
    log(f"phase 4q (e): cli retrieve --index_dir --hf_tokenizer (mBERT) "
        f"over 4h's en dev split: " + "; ".join(parts) + f"; every fused "
        f"sentence within 510 subtokens by that tokenizer's count ({card})")
    log(f"phase 4q in {time.perf_counter() - t_phase:.1f} s")


def hf_serve_run(cli, bm25, dev, card, tmp, engine, requests, model_dir,
                 tok_dir, cfg_name) -> str:
    """``cli serve --config`` with ``tokenizer: {type: hf, dir: tok_dir}``
    over ``--index_dir`` (exhaustive), one micro-batch: K1 launched, the
    answers equal ``serve()`` with ``config.make_tokenizer()`` on the
    in-memory engine and the CLI's tagger, and every row the encoder got
    is CLS, the HF pieces of its fused words, SEP; its summary."""
    import json
    from pathlib import Path

    import torch

    import kbner_tpu_torch.serve as serve_mod
    from kbner_tpu_torch.config import ServeConfig
    from kbner_tpu_torch.data.dictionary import Dictionary
    from kbner_tpu_torch.data.subword import HFTokenizer

    raw = json.loads((tmp / "model.yaml").read_text())
    raw["tokenizer"] = {"type": "hf", "dir": str(tok_dir)}
    hf_cfg = tmp / cfg_name
    hf_cfg.write_text(json.dumps(raw))
    batch = requests[:BATCH]
    stdin = "\n".join(json.dumps(r) for r in batch) + "\n"
    seen, taggers = [], []
    make_batches, serving_tagger = serve_mod.make_batches, cli.serving_tagger

    def recorded(*args, **kwargs):
        for eb in make_batches(*args, **kwargs):
            seen.append(eb)
            yield eb

    def kept(*args, **kwargs):
        taggers.append(serving_tagger(*args, **kwargs))
        return taggers[-1]

    serve_mod.make_batches, cli.serving_tagger = recorded, kept
    try:
        reset_counts(bm25)
        (_, out), serve_s = timed(lambda: run_cli(cli, [
            "serve", "--config", str(hf_cfg), "--index_dir",
            str(tmp / "kb1m"), "--device", str(dev)], stdin))
        served = counts(bm25)
        expect_counts(f"phase 4q cli serve ({Path(tok_dir).name})", served,
                      {"bm25_score_block": None})
        config = ServeConfig.from_file(hf_cfg)
        tag_dict = Dictionary.load(Path(model_dir) / "tag_dictionary.json")
        want = serve_mod.serve(batch, engine, taggers[0],
                               config.make_tokenizer(), tag_dict, k=K,
                               batch_size=BATCH)
    finally:
        serve_mod.make_batches = make_batches
        cli.serving_tagger = serving_tagger
    got = [json.loads(line) for line in out.splitlines()]
    if len(got) != len(batch) or got != json.loads(json.dumps(want)):
        raise AssertionError(f"phase 4q: cli serve with {tok_dir} answers "
                             "differ from serve() on the in-memory engine")
    fresh = HFTokenizer(str(tok_dir))
    n_rows = n_ids = 0
    for eb in seen:
        for b, rec in enumerate(eb.records):
            ids = eb.input_ids[b][eb.attention_mask[b] > 0].tolist()
            if ids != encoded_pieces(fresh, rec):
                raise AssertionError(f"phase 4q: row {b} of a served batch "
                                     f"is not {tok_dir}'s pieces")
            n_rows, n_ids = n_rows + 1, n_ids + len(ids)
    del taggers
    torch.cuda.empty_cache()
    return (f"cli serve --index_dir (the saved 1M KB, the trained "
            f"checkpoint in bf16) with tokenizer: {{type: hf, dir: "
            f"{Path(tok_dir).name}}}: {len(got)} requests in {serve_s:.1f} s "
            f"with the KB open and the checkpoint load, launches {served}; "
            f"responses equal serve() on the in-memory engine with "
            f"config.make_tokenizer(); the encoder got {n_rows} rows, "
            f"{n_ids} ids, each row CLS, the HF pieces of its fused words, "
            f"SEP ({card})")


def hf_retrieve_run(cli, bm25, tmp, i, label, extra, kb_dir, tok_dir, data,
                    dev_recs, tokenizer, device, tag: str = "") -> str:
    """One ``cli retrieve --hf_tokenizer`` run of phase 4q (c) or (e),
    checked; its summary."""
    from kbner_tpu_torch.data.conll import read_column_file
    from kbner_tpu_torch.data.subword import subtoken_length

    out_dir = tmp / f"fused-hf{tag}-{i}"
    reset_counts(bm25)
    _, wall = timed(lambda: run_cli(cli, [
        "retrieve", "--index_dir", str(kb_dir), "--hf_tokenizer",
        str(tok_dir), "--data_folder", str(data), "--out", str(out_dir),
        *device, *extra]))
    got = counts(bm25)
    expect_counts(f"phase 4q cli retrieve --hf_tokenizer ({label})", got,
                  {"delta16_rescore": None} if extra
                  else {"bm25_score_block": None})
    fused = read_column_file(out_dir / "dev.txt", {0: "text", 1: "ner"},
                             comment_symbol="# id")
    longest = max(subtoken_length(tokenizer, [
        w for w in r.tokens if w != "<EOS>"]) + ("<EOS>" in r.tokens)
        for r in fused)
    n_ctx = sum("<EOS>" in r.tokens for r in fused)
    if len(fused) != len(dev_recs) or longest > 510 or n_ctx == 0:
        raise AssertionError(
            f"phase 4q cli retrieve --hf_tokenizer ({label}): {len(fused)} "
            f"fused sentences, {n_ctx} with context, longest {longest} "
            "subtokens")
    # 4h's run in the same setting measured the budget with the hash proxy
    # (fused-0 exhaustive, fused-1 pruned)
    proxy = read_column_file(tmp / f"fused-{i}" / "dev.txt",
                             {0: "text", 1: "ner"}, comment_symbol="# id")
    differ = sum(a.tokens != b.tokens for a, b in zip(fused, proxy))
    return (f"{label} {wall:.1f} s, launches {got}, longest {longest} "
            f"subtokens, {n_ctx} with context, {differ} of {len(fused)} "
            f"fused otherwise than with the hash proxy "
            f"({sum(len(r.tokens) for r in fused)} words fused against "
            f"{sum(len(r.tokens) for r in proxy)})")


# phase 4r: the last of kbner_tpu's public surface on the card: the three
# quality gates at the reference's sizes, its end-to-end walkthrough
# (examples/end_to_end_torch.py) through K1 against the same run on the
# CPU, and SGDW over 4g's trained XLM-R-large checkpoint
GATES = (("tagger", "run_quality_gate", "held-out span F1", 0.95),
         ("parser", "run_parser_quality_gate", "held-out UAS", 0.9),
         ("classifier", "run_classifier_quality_gate", "held-out accuracy",
          0.95))
SGDW_STEPS = 3
SGDW_RTOL, SGDW_ATOL = 1e-6, 1e-9  # the same float32 roundings, op by op
# seeded normals per step, laid end to end over the leaves: a leaf within
# one pass of the block is a view of it; only the longer ones (the word
# embeddings) and those that wrap are copies
SGDW_GRAD_BLOCK = 1 << 24


def walkthrough_module():
    """``examples/end_to_end_torch.py`` of this checkout, imported."""
    import importlib.util
    from pathlib import Path

    path = (Path(__file__).resolve().parent / "examples"
            / "end_to_end_torch.py")
    spec = importlib.util.spec_from_file_location("end_to_end_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ranked(results, k: int):
    """Per-query ``RetrievedDoc`` lists as ``[(scores [Q, k], ids [Q,
    k])]``, short rows padded with -inf and -1."""
    scores = np.full((len(results), k), -np.inf, np.float32)
    ids = np.full((len(results), k), -1, np.int64)
    for q, docs in enumerate(results):
        scores[q, :len(docs)] = [d.score for d in docs]
        ids[q, :len(docs)] = [d.doc_id for d in docs]
    return [(scores, ids)]


def checkpoint_leaves(tree) -> list:
    """The arrays of a checkpoint's tree, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in checkpoint_leaves(tree[key])]
    return [np.asarray(tree)]


def tiled_grads(block, shapes) -> list:
    """Gradients of ``shapes`` from ``block``'s values repeated end to end
    over the leaves laid end to end (each a view of ``block`` where it
    does not wrap)."""
    out, off, size = [], 0, block.numel()
    for shape in shapes:
        n = int(np.prod(shape))
        start = off % size
        if start + n <= size:
            out.append(block[start:start + n].view(shape))
        else:
            reps = -(-(start + n) // size)
            out.append(block.repeat(reps)[start:start + n].view(shape))
        off += n
    return out


def surface_phase(bm25, dev, card, tmp) -> dict:
    """(a) the tagger's, the parser's and the classifier's quality gates
    on the card, each held to the reference's bar; (b) the walkthrough's
    ``main`` on the card (K1 launched) and on the CPU: the KB, the
    retrieved ids (within ties) and scores, the fused train records and
    the v4 dev records equal; (c) ``SGDW`` (momentum 0.9, weight decay
    0.01, ``exp_anneal_schedule(5e-6, 0.5)``) for ``SGDW_STEPS`` steps
    over the float32 parameters of 4g's ``b/best-model.msgpack`` on the
    card and on the CPU from the same seeded gradients: parameters,
    momenta and each parameter's total update held card to CPU. Returns
    the walkthrough's K1 launches."""
    import warnings

    import torch

    from kbner_tpu_torch import checkpoint
    from kbner_tpu_torch.data import quality_fixture
    from kbner_tpu_torch.train import SGDW, exp_anneal_schedule

    t_phase = time.perf_counter()

    # -- (a) the quality gates ----------------------------------------------
    for family, fn, metric, bar in GATES:
        torch.cuda.reset_peak_memory_stats()
        value, secs = timed(lambda: getattr(quality_fixture, fn)(device=dev))
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"phase 4r (a): the {family} quality gate ({fn}, the "
            f"reference's sizes) on the card: {metric} {value:.4f} (bar "
            f"{bar}), {secs:.1f} s, peak allocated {peak_gb:.3f} GB ({card})")
        if not value >= bar:
            raise AssertionError(f"phase 4r: the {family} quality gate "
                                 f"reads {metric} {value:.4f} < {bar}")

    # -- (b) the walkthrough through K1, card against CPU --------------------
    walk = walkthrough_module()
    reset_counts(bm25)
    gpu, gpu_s = timed(lambda: walk.main(device=dev,
                                         work_dir=tmp / "walk-cuda"))
    launched = counts(bm25)
    expect_counts("phase 4r walkthrough", launched,
                  {"bm25_score_block": None})
    cpu, cpu_s = timed(lambda: walk.main(device="cpu",
                                         work_dir=tmp / "walk-cpu"))
    if gpu["n_sentences"] != cpu["n_sentences"]:
        raise AssertionError("phase 4r walkthrough: the KBs differ")
    assert_same_results("phase 4r walkthrough retrieval",
                        ranked(cpu["results"], 3), ranked(gpu["results"], 3))
    for split in ("fused", "v4"):
        if [r.tokens for r in gpu[split]] != [r.tokens for r in cpu[split]]:
            raise AssertionError(f"phase 4r walkthrough: the {split} "
                                 "records differ between the card and the "
                                 "CPU")
    if not (gpu["work"] / "ner.html").exists():
        raise AssertionError("phase 4r walkthrough wrote no ner.html")
    log(f"phase 4r (b): examples/end_to_end_torch.py main() on the card "
        f"{gpu_s:.1f} s (launches {launched}), on the CPU {cpu_s:.1f} s: "
        f"{gpu['n_sentences']} KB sentences, {len(gpu['fused'])} fused train "
        f"and {len(gpu['v4'])} v4 dev records equal token for token, the "
        f"retrieved ids equal within ties and scores within rtol {RTOL}, "
        f"atol {ATOL}; train span F1 {gpu['f1']:.4f} on the card, "
        f"{cpu['f1']:.4f} on the CPU ({card})")

    # -- (c) SGDW at full width over 4g's checkpoint --------------------------
    tree, load_s = timed(lambda: checkpoint.load(
        tmp / "b" / "best-model.msgpack"))
    start = checkpoint_leaves(tree.get("params", tree))
    del tree
    if any(a.dtype != np.float32 for a in start):
        raise AssertionError("phase 4r: 4g's checkpoint holds parameters "
                             "that are not float32")
    n_params = sum(a.size for a in start)
    shapes = [a.shape for a in start]
    with warnings.catch_warnings():
        # the loaded arrays are read-only; these tensors are only read
        warnings.simplefilter("ignore", UserWarning)
        start = [torch.from_numpy(a) for a in start]
    torch.cuda.reset_peak_memory_stats()
    on_card = [torch.nn.Parameter(t.to(dev, copy=True)) for t in start]
    on_cpu = [torch.nn.Parameter(t.clone()) for t in start]
    opts = [SGDW(ps, lr=exp_anneal_schedule(5e-6, 0.5), momentum=0.9,
                 weight_decay=0.01) for ps in (on_card, on_cpu)]
    gen = torch.Generator().manual_seed(0)
    step_ms, cpu_step_s = [], []
    for _ in range(SGDW_STEPS):
        block = torch.randn(SGDW_GRAD_BLOCK, generator=gen)
        for ps, grads in ((on_card, tiled_grads(block.to(dev), shapes)),
                          (on_cpu, tiled_grads(block, shapes))):
            for p, g in zip(ps, grads):
                p.grad = g
        step_ms.append(event_ms(opts[0].step))
        cpu_step_s.append(timed(opts[1].step)[1])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    worst = {"parameters": 0.0, "momenta": 0.0, "updates": 0.0}
    t_check = time.perf_counter()
    for pg, pc, p0 in zip(on_card, on_cpu, start):
        pairs = (("parameters", pg.detach().cpu(), pc.detach()),
                 ("momenta", opts[0].state[pg]["momentum_buffer"].cpu(),
                  opts[1].state[pc]["momentum_buffer"]))
        for what, got, want in pairs:
            if torch.equal(got, want):  # the expected case: one pass
                continue
            torch.testing.assert_close(got, want, rtol=SGDW_RTOL,
                                       atol=SGDW_ATOL,
                                       msg=f"phase 4r SGDW {what}")
            worst[what] = max(worst[what], float((got - want).abs().max()))
        got, want = pairs[0][1:]
        if torch.equal(want, p0):
            raise AssertionError("phase 4r: SGDW left a parameter as it was")
        if not torch.equal(got, want):
            worst["updates"] = max(worst["updates"], float(
                ((got - p0) - (want - p0)).abs().max()
                / (want - p0).abs().max()))
    check_s = time.perf_counter() - t_check
    if worst["updates"] > SGDW_RTOL:
        raise AssertionError(f"phase 4r: SGDW's update on the card differs "
                             f"from the CPU's by {worst['updates']:.3g} of "
                             f"its largest")
    moved_bytes = 5 * 4 * n_params  # p, g, m read; p, m written
    log(f"phase 4r (c): SGDW (momentum 0.9, weight decay 0.01, lr "
        f"exp_anneal_schedule(5e-6, 0.5)) over 4g's best-model.msgpack "
        f"({n_params} float32 parameters in {len(start)} leaves, read in "
        f"{load_s:.1f} s), {SGDW_STEPS} steps from seeded CPU gradients: "
        f"card against CPU worst abs err parameters "
        f"{worst['parameters']:.3g}, momenta {worst['momenta']:.3g} (rtol "
        f"{SGDW_RTOL}, atol {SGDW_ATOL}), total update {worst['updates']:.3g} "
        f"of its largest; ms per step on the card "
        + ", ".join(f"{v:.2f}" for v in step_ms)
        + f" (CUDA events; bound {moved_bytes / PEAK_BYTES_PER_S * 1e3:.2f} "
        f"ms by bytes, {moved_bytes / 1e9:.1f} GB), on the CPU "
        + ", ".join(f"{v:.2f}" for v in cpu_step_s)
        + f" s (host clock); checked in {check_s:.1f} s; peak allocated "
        f"{peak_gb:.2f} GB ({card})")
    del on_card, on_cpu, opts, start
    log(f"phase 4r in {time.perf_counter() - t_phase:.1f} s")
    return {"k1_launches": launched["bm25_score_block"]}


# phase 4i: MIX retrieval over three saved language KBs, and staged
# fine-tuning; after 4h in the same temporary directory (its en and zh
# KBs, its CoNLL splits and its model config)
N_RU_DOCS = 25_000
RU_SPLITS = {"train": 300, "dev": 100, "test": 100}
MIX_CHECK = (512, 256, 256)  # en, zh, ru queries of the held-equal batch
CYRILLIC = "абвгдежзиклмнопрстуфхцчшщэюя"
STAGE_RECORDS = (48, 16, 16)  # train, dev, test sentences per language
DE_WORDS = {"visited": "besuchte", "yesterday": "gestern", "hired":
            "stellte", "in": "in", "the": "das", "office": "Büro", "of":
            "von", "is": "ist", "and": "und", "met": "trafen", "at": "bei",
            "reports": "Berichte", "from": "aus", "mention": "nennen",
            "opened": "eröffnete", "a": "ein", "plant": "Werk", "near":
            "nahe"}


# 4i's multistage, 4j, 4k, 4l's checkpoint and cli parity, and 4m's
# targets but the tree parser train XLM-R large's width (hidden 1024, 16
# heads, FFN 4096, vocabulary 250002) cut to CUT_LAYERS of its 24 layers,
# through an HF config.json that model.encoder names: a depth cut that
# keeps the smoke within its time limit on the slower of the card
# machine's hosts (the whole run took 1,279.8 s there at full depth,
# 1,139.5 s at 8 layers once phase 4r came, 1,158.9 s at 6 once phase
# 4q's RoBERTa and mBERT runs came, and 1,137.2 s at 4)
CUT_LAYERS = 2


def cut_encoder(tmp) -> str:
    """A directory holding the ``config.json`` of XLM-R large cut to
    ``CUT_LAYERS`` layers, for ``model.encoder``."""
    import dataclasses

    from kbner_tpu_torch.models.xlmr import XLMRConfig

    path = tmp / f"xlmr-large-{CUT_LAYERS}-layers"
    write_hf_config(path, dataclasses.replace(
        XLMRConfig.large(vocab_size=HASH_VOCAB), num_layers=CUT_LAYERS))
    return str(path)


def encoder_label(encoder: str) -> str:
    """A named size as named; a config directory as its depth."""
    from pathlib import Path

    if encoder in ("tiny", "base", "large"):
        return encoder
    n = json.loads((Path(encoder) / "config.json").read_text())[
        "num_hidden_layers"]
    return f"large width, {n} of 24 layers"


def cyrillic_word(i: int) -> str:
    """Term id ``i`` as a distinct Cyrillic word (base 28, two letters at
    least)."""
    base, out = len(CYRILLIC), ""
    i += len(CYRILLIC)
    while i:
        i, r = divmod(i, base)
        out = CYRILLIC[r] + out
    return out


def ru_kb(n: int, seed: int):
    """``n`` seeded ru KB sentences: topical Zipf text
    (:func:`synth_wiki_docs`, as the en KB's) in Cyrillic words, each
    followed by the first four words of one of
    :func:`multilingual_sentences`. Returns (texts, term ids [n, L] with
    -1 pads, the words of the term ids)."""
    from kbner_tpu_torch.retrieval.synth import synth_wiki_docs

    docs = synth_wiki_docs(n, vocab=200_000, n_topics=n // 50, seed=seed)
    words = [cyrillic_word(t) for t in range(int(docs.max()) + 1)]
    texts = [" ".join([words[t] for t in row if t >= 0] + ml.split()[:4])
             for row, ml in zip(docs.tolist(),
                                multilingual_sentences(n, seed))]
    return texts, docs, words


@contextlib.contextmanager
def watch_stages():
    """While open, ``FinetuneTrainer.load_encoder`` records after each
    load ``(path, largest difference between the encoder and the export
    it read, arrays compared)`` and ``FinetuneTrainer.train`` the seconds
    of each call (ending in a synchronize). Yields the two lists."""
    import torch

    from kbner_tpu_torch import checkpoint, weights
    from kbner_tpu_torch.train import FinetuneTrainer

    seen, stage_s = [], []
    load_encoder, train = FinetuneTrainer.load_encoder, FinetuneTrainer.train

    def checked_load(self, path):
        load_encoder(self, path)
        tree = weights.to_jax_params(self.model.state_dict(),
                                     self.model.config)["params"]["encoder"]
        export = checkpoint.load(path)
        flat = {}

        def walk(a, b, key=""):
            if isinstance(a, dict):
                if set(a) != set(b):
                    raise AssertionError(f"encoder keys differ at {key}")
                for k in a:
                    walk(a[k], b[k], f"{key}/{k}")
            else:
                flat[key] = float(np.abs(np.asarray(a, np.float64)
                                         - np.asarray(b, np.float64)).max())
        walk(tree, export)
        seen.append((path, max(flat.values()), len(flat)))

    def timed_train(self, base_path, config):
        t0 = time.perf_counter()
        result = train(self, base_path, config)
        torch.cuda.synchronize()
        stage_s.append(time.perf_counter() - t0)
        return result

    FinetuneTrainer.load_encoder = checked_load
    FinetuneTrainer.train = timed_train
    try:
        yield seen, stage_s
    finally:
        FinetuneTrainer.load_encoder = load_encoder
        FinetuneTrainer.train = train


def stage_corpora(tmp, seed: int):
    """The staged-training corpora: an en and a de column corpus of the
    quality fixture's sentences (the de one with German function words),
    made from ``seed``. Returns their folders."""
    from kbner_tpu_torch.data.conll import SentenceRecord, write_column_file
    from kbner_tpu_torch.data.quality_fixture import make_quality_corpus
    from kbner_tpu_torch.data.tag_schemes import bioes_to_bio

    folders = []
    for i, lang in enumerate(("en", "de")):
        corpus = make_quality_corpus(*STAGE_RECORDS, seed=seed + i).corpora[0]
        folder = tmp / f"stage-{lang}"
        for split in ("train", "dev", "test"):
            words = DE_WORDS if lang == "de" else {}
            # written in BIO, as column corpora come
            write_column_file(folder / f"{split}.txt", [SentenceRecord(
                tokens=[words.get(t, t) for t in r.tokens],
                tags={"ner": bioes_to_bio(r.tags["ner"])})
                for r in getattr(corpus, split)])
        folders.append(folder)
    return folders


def mix_stage_phase(cli, bm25, dev, card, tmp, model_cfg, encoder="large",
                    n_ru=N_RU_DOCS, ru_splits=None, mix_check=MIX_CHECK
                    ) -> dict:
    """Phase 4i, after 4h in its directory ``tmp`` (its saved 1M en KB
    ``kb1m``, its zh KB ``zhkb``, its CoNLL splits and ``model_cfg``):
    (a) a ru KB of ``n_ru`` seeded docs through ``cli index --lang ru``;
    (b) ``cli retrieve --route mix --engine_mode pruned`` over the three
    KBs and splits of en, zh and ru sentences: one MixEngine over the
    concatenated languages, one K2 launch per language and batch; the
    MixEngine held to ``mix_search`` over the languages' pruned engines
    on the card for one batch of the three languages, K2 held to its plain
    version on every language step's operands (global ids), K1 held to
    its plain version on each language's exhaustive engine at that
    batch, the route's recall@K against ``mix_search`` over exhaustive
    engines (K1); (c) ``--route mix --with_entity``, the per-engine route
    with title boosts, K2 held to its plain version on each language's
    engine of the run at two of its batches; (d) ``cli multistage`` of two stage configs, multilingual en +
    de then monolingual en, XLM-R at full width, the second stage's
    encoder at load held equal to the first stage's export. Returns the
    K2 launches of the MixEngine route and the K1 launches of the
    exhaustive fan-out."""
    import json
    import math

    import torch

    from kbner_tpu_torch.data.conll import (SentenceRecord, read_column_file,
                                            write_column_file)
    from kbner_tpu_torch.data.subword import HashTokenizer, subtoken_length
    from kbner_tpu_torch.retrieval import engine as engine_mod
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine, mix_search
    from kbner_tpu_torch.retrieval.pipeline import sentence_query
    from kbner_tpu_torch.retrieval.synth import sentence_queries

    ru_splits = ru_splits or RU_SPLITS
    device = ["--device", str(dev)]
    out = {}

    # -- (a) the ru KB -------------------------------------------------------
    texts, ru_docs, ru_words = ru_kb(n_ru, seed=51)
    with open(tmp / "ru.jsonl", "w", encoding="utf-8") as f:
        for i, (text, row) in enumerate(zip(texts, ru_docs)):
            f.write(json.dumps({"title": " ".join(ru_words[t]
                                                  for t in row[:2]),
                                "sentence": text, "paragraph": text,
                                "url": f"https://ru.wikipedia.org/wiki/{i}"},
                               ensure_ascii=False) + "\n")
    (stats, _), index_s = timed(lambda: run_cli(cli, [
        "index", "--kb", str(tmp / "ru.jsonl"), "--out", str(tmp / "rukb"),
        "--lang", "ru"]))
    log(f"cli index --lang ru: {n_ru} docs (topical Zipf sentences in "
        f"Cyrillic words, each with four words of a multilingual sentence) "
        f"from JSONL in {index_s:.1f} s ({n_ru / index_s:.0f} docs/s) "
        f"({card})")

    # -- (b) the MIX route -----------------------------------------------------
    data = tmp / "mix-conll"
    seed = 52
    split_langs = {}
    for split in ("train", "dev", "test"):
        en = read_column_file(tmp / "conll" / f"{split}.txt",
                              {0: "text", 1: "ner"}, comment_symbol="# id")
        zh = read_column_file(tmp / "zh-conll" / f"{split}.txt",
                              {0: "text", 1: "ner"}, comment_symbol="# id")
        q_ids, _ = sentence_queries(ru_docs, ru_splits[split],
                                    q_len=MAX_QUERY_TERMS, seed=seed)
        seed += 1
        ru = [SentenceRecord(
            tokens=[ru_words[t] for t in q[q >= 0]],
            tags={"ner": ["B-PER", "I-PER"] + ["O"] * (int((q >= 0).sum())
                                                      - 2)},
            comment=f"# id ru-{split}-{i}") for i, q in enumerate(q_ids)]
        write_column_file(data / f"{split}.txt", en + zh + ru)
        split_langs[split] = (["en"] * len(en) + ["zh"] * len(zh)
                              + ["ru"] * len(ru))
    kbs = [f"en={tmp / 'kb1m'}", f"zh={tmp / 'zhkb'}", f"ru={tmp / 'rukb'}"]
    common = ["retrieve", "--route", "mix", "--data_folder", str(data),
              "--tokenizer_config", str(model_cfg), *device,
              *[a for kb in kbs for a in ("--index_dir", kb)]]
    n_batches = sum(math.ceil(len(v) / cli.RETRIEVE_BATCH)
                    for v in split_langs.values())
    made = {}
    mix_class = engine_mod.MixEngine

    def capture(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        made["mix"] = mix_class(*args, **kwargs)
        torch.cuda.synchronize()
        made["build_s"] = time.perf_counter() - t0
        return made["mix"]

    engine_mod.MixEngine = capture
    reset_counts(bm25)
    torch.cuda.reset_peak_memory_stats()
    try:
        (st, _), wall = timed(lambda: run_cli(cli, [
            *common, "--engine_mode", "pruned", "--out",
            str(tmp / "mix-pruned")]))
    finally:
        engine_mod.MixEngine = mix_class
    got = counts(bm25)
    mix = made.get("mix")
    if mix is None:
        raise AssertionError("cli retrieve --route mix --engine_mode pruned "
                             "did not go through a MixEngine")
    M = len(mix.langs)
    expect_counts("cli retrieve --route mix (MixEngine)", got,
                  {"delta16_rescore": M * n_batches})
    out["mix_launches"] = got["delta16_rescore"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_lang = sum(sum(a.nbytes for a in e.rows["text"] + e.csr["text"])
                   for e in mix.engines.values())
    last_r2 = mix.engines[mix.langs[-1]]._row_meta["text"][4]
    pad = (mix._r2 - last_r2) * mix._dev[0].shape[1] * 2
    if mix.nbytes != per_lang + pad:
        raise AssertionError(f"MixEngine holds {mix.nbytes} bytes on the "
                             f"card, not the languages' {per_lang} + {pad}")
    split_s = {s: sum(v for k, v in t.items() if k != "sentences")
               for s, t in st.items()}
    log(f"cli retrieve --route mix --engine_mode pruned over {M} saved KBs "
        f"({', '.join(f'{lang} {e.text_index.n_docs}' for lang, e in mix.engines.items())} "
        f"docs): {wall:.1f} s, of which {wall - sum(split_s.values()):.1f} s "
        f"opening the KBs and building the host engines and the MixEngine "
        f"(MixEngine {made['build_s']:.2f} s: concatenation and upload of "
        f"{sum(e.n_padded for e in mix.engines.values())} docs, "
        f"{mix.nbytes / 1e6:.1f} MB on the card = the languages' rows and "
        f"CSRs, {per_lang / 1e6:.1f} MB, + {pad} bytes of guard rows, r2 "
        f"{mix._r2}); K2 launches {got['delta16_rescore']} = {M} languages x "
        f"{n_batches} batches; peak allocated {peak:.2f} GB; per split: "
        + "; ".join(
            f"{s} {t['sentences']} sentences ({len(split_langs[s])} en+zh+ru"
            f", {math.ceil(t['sentences'] / cli.RETRIEVE_BATCH)} batches) "
            f"{t['sentences'] / split_s[s]:.0f}/s (retrieve "
            f"{t['retrieve']:.2f} s, write {t['write']:.2f} s, fuse "
            f"{t['fuse']:.2f} s, read {t['read']:.2f} s)"
            for s, t in st.items()) + f" ({card})")
    tokenizer = HashTokenizer(vocab_size=HASH_VOCAB)
    for split, n in ((s, len(v)) for s, v in split_langs.items()):
        fused = read_column_file(tmp / "mix-pruned" / f"{split}.txt",
                                 {0: "text", 1: "ner"},
                                 comment_symbol="# id")
        longest = max(subtoken_length(tokenizer, [
            w for w in r.tokens if w != "<EOS>"]) + ("<EOS>" in r.tokens)
            for r in fused)
        if len(fused) > n or longest > 510 or not any(
                "<EOS>" in r.tokens for r in fused):
            raise AssertionError(f"cli retrieve --route mix {split}: "
                                 f"{len(fused)} fused of {n}, longest "
                                 f"{longest} subtokens")

    # the MixEngine against the per-engine fan-out on the card, one batch
    # of the three languages' train queries
    train = read_column_file(data / "train.txt", {0: "text", 1: "ner"},
                             comment_symbol="# id")
    by_lang = {lang: [sentence_query(r, "mix") for r, l in zip(
        train, split_langs["train"]) if l == lang] for lang in mix.langs}
    batch = [q for lang, n in zip(("en", "zh", "ru"), mix_check)
             for q in by_lang[lang][:n]]
    t0 = time.perf_counter()
    # the MixEngine ships the tiny sums as float16: so do these engines
    card_engines = {lang: RetrievalEngine(
        e.text_index, store=e.store, mode="pruned", device=dev,
        tiny_pack=False) for lang, e in mix.engines.items()}
    torch.cuda.synchronize()
    fan_build_s = time.perf_counter() - t0
    d16_args = []
    inner = bm25.delta16_rescore

    def keep(*args):
        d16_args.append(args)
        return inner(*args)

    # the wrapper counts its launches on the name it is bound to: these
    # comparison launches go to keep.launches and count nowhere
    keep.launches = 0
    bm25.delta16_rescore = keep
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got_mix = mix.search_texts(batch, k=K)
        mix_s = time.perf_counter() - t0
    finally:
        bm25.delta16_rescore = inner
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_mix = mix_search(card_engines, batch, k=K)
    fan_s = time.perf_counter() - t0
    n_hits = 0
    for q, (g, w) in enumerate(zip(got_mix, want_mix)):
        gs = np.array([d.score for _, d in g])
        ws = np.array([d.score for _, d in w])
        np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=ATOL,
                                   err_msg=f"MixEngine query {q}")
        cut = gs[-1] * (1 + RTOL) + ATOL if len(gs) else 0.0
        if ({(lang, d.doc_id) for lang, d in g if d.score > cut}
                != {(lang, d.doc_id) for lang, d in w if d.score > cut}):
            raise AssertionError(f"MixEngine query {q}: (lang, doc_id) "
                                 "differ from mix_search's")
        n_hits += len(g)
    langs_hit = sorted({lang for row in got_mix for lang, _ in row})
    if len(d16_args) != M or langs_hit != sorted(mix.langs):
        raise AssertionError(f"MixEngine batch: {len(d16_args)} K2 calls, "
                             f"hits from {langs_hit}")
    log(f"MixEngine.search_texts against mix_search over the {M} languages' "
        f"pruned engines on the card (built in {fan_build_s:.1f} s), one "
        f"batch of {len(batch)} train queries ({'/'.join(map(str, mix_check))} "
        f"en/zh/ru): {n_hits} hits from {langs_hit}, (lang, doc_id) equal "
        f"within ties, scores within rtol {RTOL}; host clock "
        f"{mix_s * 1e3:.1f} ms against {fan_s * 1e3:.1f} ms ({card})")
    # K2 on each language step's operands: global candidate ids into the
    # concatenated rows
    parts, k2_ms = [], {}
    for (lang, (_, _, _, n_real, doc_b, _)), args in zip(
            zip(mix.langs, mix._scalars), d16_args):
        cand = args[2]
        real = cand[(cand >= doc_b) & (cand < doc_b + n_real)]
        want = bm25.delta16_rescore_ref(*args)
        got_k2 = inner(*args)
        torch.cuda.synchronize()
        torch.testing.assert_close(got_k2, want, rtol=RTOL, atol=ATOL)
        if int(real.numel()) == 0 and doc_b > 0:
            raise AssertionError(f"K2's {lang} step has no global id")
        err = float((got_k2 - want).abs().max())
        eager = time_cuda_ms(lambda: inner(*args), iters=20)
        dev_ms = time_device_ms(lambda: inner(*args), iters=200)
        plain = time_cuda_ms(lambda: bm25.delta16_rescore_ref(*args),
                             iters=3)
        n_bytes, n_ops = delta16_need(args)
        b_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
        o_ms = n_ops / PEAK_INT32_OPS_PER_S * 1e3
        k2_ms[lang] = (dev_ms, eager, plain, max(b_ms, o_ms))
        parts.append(
            f"{lang} (ids {doc_b}..{doc_b + n_real - 1}, Q={cand.shape[0]} "
            f"W={args[0].shape[1]} C={cand.shape[1]} R2={args[-1]}): max abs "
            f"err {err:.3g}; {dev_ms:.4f} ms on the device (CUDA graph, L2 "
            f"warm), {eager:.4f} ms eager, plain {plain:.3f} ms, bound "
            f"{max(b_ms, o_ms):.5f} ms by "
            f"{'bytes' if b_ms >= o_ms else 'operations'}")
    out["k2_mix"] = k2_ms
    log("delta16_rescore on the MixEngine's concatenated operands, one "
        "language step each, equal to the plain version (RTOL/ATOL): "
        + "; ".join(parts) + f" ({card})")
    del card_engines

    # recall@K of the MIX route against the exhaustive fan-out (K1)
    exhaustive = {lang: RetrievalEngine(e.text_index, store=e.store,
                                        device=dev)
                  for lang, e in mix.engines.items()}
    # K1 on every language's text field at the fan-out's shape: the same
    # 1024 mixed queries go to every engine
    log(f"bm25_score_block at the MIX fan-out's shape, the held-equal batch "
        f"of {len(batch)} en/zh/ru train queries on each language's "
        f"exhaustive engine: " + "; ".join(
            f"{lang} {k1_at_retrieve_shape(bm25, e, batch, None, dev)}"
            for lang, e in exhaustive.items()) + f" ({card})")
    reset_counts(bm25)
    recalls = {lang: [] for lang in mix.langs}
    t0 = time.perf_counter()
    for split in ("train", "dev", "test"):
        recs = read_column_file(data / f"{split}.txt", {0: "text", 1: "ner"},
                                comment_symbol="# id")
        queries = [sentence_query(r, "mix") for r in recs]
        got_urls = [[line.split("\t")[4] for line in lines]
                    for _, lines in query_blocks(
                        tmp / "mix-pruned" / f"{split}.retrieval.tsv")]
        for i in range(0, len(queries), cli.RETRIEVE_BATCH):
            rows_x = mix_search(exhaustive, queries[i:i + cli.RETRIEVE_BATCH],
                                k=K)
            for row, urls, lang in zip(
                    rows_x, got_urls[i:i + cli.RETRIEVE_BATCH],
                    split_langs[split][i:i + cli.RETRIEVE_BATCH]):
                want = {d.url for _, d in row}
                if want:
                    recalls[lang].append(len(want & set(urls)) / len(want))
    exh_s = time.perf_counter() - t0
    got = counts(bm25)
    expect_counts("mix_search over exhaustive engines", got,
                  {"bm25_score_block": M * n_batches})
    out["k1_mix_launches"] = got["bm25_score_block"]
    recall = float(np.mean(sum(recalls.values(), [])))
    log(f"cli retrieve --route mix (MixEngine) against mix_search over "
        f"exhaustive engines (K1, {got['bm25_score_block']} launches = {M} "
        f"languages x {n_batches} batches, {exh_s:.1f} s): recall@{K} "
        f"{recall:.4f} over {sum(map(len, recalls.values()))} queries (bar "
        f"{MIN_RECALL}); by the query's language "
        + ", ".join(f"{lang} {np.mean(r):.4f} ({len(r)})"
                    for lang, r in recalls.items() if r) + f" ({card})")
    if recall < MIN_RECALL:
        raise AssertionError(f"--route mix recall@{K} {recall:.4f} is below "
                             f"{MIN_RECALL}")
    mix_langs = list(mix.langs)
    del exhaustive, mix, made
    torch.cuda.empty_cache()

    # -- (c) --with_entity: the per-engine route with title boosts -----------
    fan_out, calls = engine_mod.mix_search, []

    def capture_fan_out(engines, queries, *args, **kwargs):
        calls.append((engines, list(queries), kwargs.get("entity_queries")))
        return fan_out(engines, queries, *args, **kwargs)

    engine_mod.mix_search = capture_fan_out
    reset_counts(bm25)
    try:
        (st, _), wall = timed(lambda: run_cli(cli, [
            *common, "--engine_mode", "pruned", "--with_entity", "--out",
            str(tmp / "mix-entity")]))
    finally:
        engine_mod.mix_search = fan_out
    got = counts(bm25)
    expect_counts("cli retrieve --route mix --with_entity", got,
                  {"delta16_rescore": M * n_batches})
    split_s = {s: sum(v for k, v in t.items() if k != "sentences")
               for s, t in st.items()}
    n_title = sum("<hit>" in line.split(" ---#--- ")[-1]
                  for line in (tmp / "mix-entity" / "train.retrieval.tsv")
                  .read_text(encoding="utf-8").splitlines()
                  if " ---#--- " in line)
    if n_title == 0:
        raise AssertionError("--route mix --with_entity: no title hit")
    log(f"cli retrieve --route mix --engine_mode pruned --with_entity "
        f"(mix_search over {M} pruned engines with title fields, built in "
        f"the run): {wall:.1f} s; launches {got}; per split: " + "; ".join(
            f"{s} {t['sentences'] / split_s[s]:.0f} sentences/s "
            f"(retrieve {t['retrieve']:.2f} s)" for s, t in st.items())
        + f"; {n_title} train contexts with a title hit ({card})")
    # K2 on each language's own pruned engine of that run, at two train
    # batches (sentence queries with their entity clauses): the first (en)
    # and the one that holds the first ru query (zh and ru)
    engines = calls[0][0]
    if len(calls) != n_batches or sorted(engines) != sorted(mix_langs):
        raise AssertionError("--route mix --with_entity: the fan-out ran "
                             f"{len(calls)} batches over {sorted(engines)}")
    langs_t = split_langs["train"]
    for b in sorted({0, langs_t.index("ru") // cli.RETRIEVE_BATCH}):
        _, queries, entities = calls[b]
        if entities is None:
            raise AssertionError("--route mix --with_entity: no entity "
                                 "clauses")
        in_batch = sorted(set(langs_t[b * cli.RETRIEVE_BATCH:
                                      (b + 1) * cli.RETRIEVE_BATCH]))
        log(f"delta16_rescore on each language's pruned engine of the "
            f"--with_entity route, train batch {b} ({len(queries)} "
            f"{'/'.join(in_batch)} queries with their entity clauses): "
            + "; ".join(
                f"{lang} {k2_at_retrieve_shape(bm25, e, queries, entities)}"
                for lang, e in engines.items()) + f" ({card})")
    del engines, calls
    torch.cuda.empty_cache()

    # -- (d) cli multistage ---------------------------------------------------
    en_dir, de_dir = stage_corpora(tmp, seed=61)
    configs = []
    for name, folders, extra in (
            ("stage1", (en_dir, de_dir), {"resample_smooth": 0.7,
                                          "save_finetuned_encoder": True}),
            ("stage2", (en_dir,), {})):
        path = tmp / f"{name}.json"
        path.write_text(json.dumps({
            "name": name, "corpora": [{
                "name": f.name, "data_folder": str(f),
                "column_format": {"0": "text", "1": "ner"}}
                for f in folders],
            "tokenizer": {"type": "hash", "vocab_size": HASH_VOCAB},
            "model": {"encoder": encoder},
            "train": {"learning_rate": 5e-6, "lr_rate": 10000.0,
                      "batch_size": 8, "max_epochs": 1, "seed": 3, **extra},
            "target_dir": str(tmp / name)}))
        configs.append(path)
    torch.cuda.reset_peak_memory_stats()
    with watch_stages() as (seen, stage_s):
        (results, _), wall = timed(lambda: run_cli(cli, [
            "multistage", *map(str, configs), *device]))
    export = tmp / "stage1" / "finetuned-encoder.msgpack"
    if (len(results) != 2 or len(seen) != 1 or seen[0][0] != export
            or seen[0][1] != 0.0):
        raise AssertionError(f"cli multistage: {len(results)} stages, "
                             f"encoder loads {seen}")
    losses = [r["history"]["train_loss"][0] for r in results]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"cli multistage: train losses {losses}")
    log(f"cli multistage (XLM-R {encoder_label(encoder)}, float32 masters with bf16 "
        f"compute, batch 8, one epoch each; stage 1 en + de with "
        f"resample_smooth 0.7, stage 2 en from stage 1's export): "
        f"{wall:.1f} s in all, stages {stage_s[0]:.1f} s and "
        f"{stage_s[1]:.1f} s (training, evaluation and checkpoints), train "
        f"losses {losses[0]:.4f} and {losses[1]:.4f}; the export "
        f"{export.stat().st_size / 1e9:.3f} GB; stage 2's encoder at load "
        f"against stage 1's export: max abs diff {seen[0][1]} over "
        f"{seen[0][2]} arrays; peak allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    return out


# phase 4j: the recipe's last two steps -- the ACE search over the published
# stack (configs/multistage_ace_ensemble.yaml), then cli ensemble, evaluate
# and speed
ACE_SPLITS = {"train": 48, "dev": 16, "test": 16}  # cut of 4h's splits
ACE_STACK = [{"type": "transformer", "fine_tune": False},
             {"type": "word", "dim": 300},
             {"type": "char_bilstm", "char_dim": 32, "hidden": 64},
             {"type": "flair", "embed_dim": 32, "hidden": 512}]
ACE_EPISODES = 1        # the published search runs 30
ACE_EPOCHS = 1          # the published training runs 150
# sentences of the card-vs-CPU stack (4j) and ELMo (4n) checks: one (two
# until phase 4q came) to leave room in the smoke's time limit
N_FEATURE_CHECK = 1
# float32 on both sides, sums in another order: the XLM-R layers and
# 1024-step LSTMs. The largest error read on an H100 (700 W) was 1.07e-05,
# XLM-R large's features at 24 layers; the LSTM members' 1.8e-07 and below
FEATURE_RTOL, FEATURE_ATOL = 1e-4, 1e-4


def run_ace_train(cli, cfg, device):
    """``cli train`` of the ACE config ``cfg``, each
    ``FinetuneTrainer.train`` (the episodes, then the final training)
    timed on the host clock after a sync, and the ``(trainer, specs)``
    that ``cli._build_ace`` built kept for the step's split: (result, wall
    s, [s per training], (trainer, specs), peak allocated GB)."""
    import torch

    from kbner_tpu_torch.train import FinetuneTrainer

    train_s, built = [], []
    train, build = FinetuneTrainer.train, cli._build_ace

    def timed_train(self, base_path, config):
        t0 = time.perf_counter()
        result = train(self, base_path, config)
        torch.cuda.synchronize()
        train_s.append(time.perf_counter() - t0)
        return result

    def kept_build(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    FinetuneTrainer.train, cli._build_ace = timed_train, kept_build
    torch.cuda.reset_peak_memory_stats()
    try:
        (result, _), wall = timed(lambda: run_cli(cli, ["train", "--config",
                                                        str(cfg), *device]))
    finally:
        FinetuneTrainer.train, cli._build_ace = train, build
    return (result, wall, train_s, built[0],
            torch.cuda.max_memory_allocated() / 1e9)


def ace_stage_phase(cli, bm25, dev, card, tmp, encoder="large",
                    splits=None, stack=None, n_check=N_FEATURE_CHECK
                    ) -> dict:
    """Phase 4j, after 4i in its directory ``tmp`` (4h's saved KB
    ``kb1m``, its CoNLL splits ``conll`` and ``model.yaml``, 4g's model
    ``b``, 4i's stage configs and models): (a) a cut of 4h's splits fused
    through ``cli retrieve`` with the exhaustive engine (K1, one launch
    per split, counted), then K1 held to its plain version at each
    split's shape, every row, on the KB opened as ``cli retrieve`` opens
    it;
    (b) ``cli train`` with ``trainer: ReinforcementTrainer`` over the
    published stack (XLM-R frozen, word 300, char-BiLSTM 32/64, Flair
    32/512), batch 32, CRF, ``ACE_EPISODES`` episodes of ``ACE_EPOCHS``
    epoch and the final training, each episode timed, one optimizer step
    split by member with CUDA events; (c) the stack's features for
    ``n_check`` sentences on the card against the same module on the CPU,
    float32 on both sides, the ACE run's weights; (d) ``cli parse`` of
    4i's two stage models and 4g's served model on the en stage test
    split, ``cli ensemble`` of the three, ``cli evaluate`` of the
    ensemble joined with gold and of the ACE run's test file, ``cli
    speed`` on 4i's stage-2 config. Returns K1's launches in (a)."""
    import dataclasses

    import torch

    from kbner_tpu_torch import checkpoint, weights
    from kbner_tpu_torch.config import ExperimentConfig, ServeConfig
    from kbner_tpu_torch.data.conll import (ListCorpus, SentenceRecord,
                                            read_column_file,
                                            write_column_file)
    from kbner_tpu_torch.data.dictionary import Dictionary
    from kbner_tpu_torch.data.encode import make_batches
    from kbner_tpu_torch.eval.metrics import evaluate_spans
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.pipeline import load_kb, sentence_query
    from kbner_tpu_torch.train import FinetuneTrainer

    splits = splits or ACE_SPLITS
    device = ["--device", str(dev)]
    t_phase = time.perf_counter()

    # -- (a) the corpus, fused through K1 -------------------------------------
    raw, fused = tmp / "ace-raw", tmp / "ace-conll"
    queries = {}
    for split, n in splits.items():
        cut = read_column_file(tmp / "conll" / f"{split}.txt",
                               {0: "text", 1: "ner"},
                               comment_symbol="# id")[:n]
        write_column_file(raw / f"{split}.txt", cut)
        queries[split] = [sentence_query(r) for r in cut]
    reset_counts(bm25)
    _, wall = timed(lambda: run_cli(cli, [
        "retrieve", "--index_dir", str(tmp / "kb1m"), "--data_folder",
        str(raw), "--out", str(fused), "--tokenizer_config",
        str(tmp / "model.yaml"), *device]))
    got = counts(bm25)
    # one launch per split: each holds fewer queries than a batch
    expect_counts("the ACE corpus's cli retrieve", got,
                  {"bm25_score_block": len(splits)})
    text_index, store, title_index, _ = load_kb(tmp / "kb1m")
    engine = RetrievalEngine(text_index, store=store,
                             title_index=title_index, device=dev)
    held = "; ".join(
        f"{split} "
        + k1_at_retrieve_shape(bm25, engine, q, None, dev, every_row=True)
        for split, q in queries.items())
    del engine
    store.close()
    torch.cuda.empty_cache()
    recs = {s: read_column_file(fused / f"{s}.txt", {0: "text", 1: "ner"},
                                comment_symbol="# id") for s in splits}
    n_ctx = sum("<EOS>" in r.tokens for r in recs["train"])
    if any(len(recs[s]) != n for s, n in splits.items()) or n_ctx == 0:
        raise AssertionError(f"ACE corpus: {[len(v) for v in recs.values()]}"
                             f" fused sentences, {n_ctx} with context")
    words = [len(r.tokens) for r in recs["train"]]
    chars = [sum(map(len, r.tokens)) + len(r.tokens) - 1
             for r in recs["train"]]
    log(f"ACE corpus: {'/'.join(map(str, splits.values()))} train/dev/test "
        f"KB sentences (gold B-PER I-PER) fused by cli retrieve with the "
        f"exhaustive engine in {wall:.1f} s; launches {got}; train: "
        f"{n_ctx}/{splits['train']} with context, {max(words)} words and "
        f"{max(chars)} characters at most; bm25_score_block at each "
        f"split's retrieve shape on kb1m's text field: {held} ({card})")

    # -- (b) cli train with the ACE trainer -----------------------------------
    run = tmp / "ace"
    cfg = tmp / "ace.json"
    stack = stack or ACE_STACK
    cfg.write_text(json.dumps({
        "name": "en-ace-stack",
        "corpora": [{"name": "ACE", "data_folder": str(fused),
                     "column_format": {"0": "text", "1": "ner"},
                     "comment_symbol": "# id", "tag_to_bioes": "ner"}],
        "tag_layer": "ner",
        "tokenizer": {"type": "hash", "vocab_size": HASH_VOCAB},
        "model": {"encoder": encoder, "remat": True,
                  "remat_policy": "dots_saveable", "use_crf": True,
                  "embeddings": stack},
        "ace": {"episodes": ACE_EPISODES, "controller_lr": 0.1,
                "reward_kind": "plain"},
        "train": {"learning_rate": 0.1, "lr_rate": 1.0, "batch_size": 32,
                  "max_epochs": ACE_EPOCHS},
        "trainer": "ReinforcementTrainer", "target_dir": str(run)}))

    def describe(members):
        return " + ".join(
            f"XLM-R {encoder_label(encoder)} frozen" if m["type"] == "transformer" else
            f"word {m['dim']}" if m["type"] == "word" else
            f"char-BiLSTM {m['char_dim']}/{m['hidden']}"
            if m["type"] == "char_bilstm" else
            f"Flair {m['embed_dim']}/{m['hidden']}" for m in members)

    result, wall, train_s, (trainer, specs), peak_gb = run_ace_train(
        cli, cfg, device)
    history = result["history"]
    state = json.loads((run / "training_state.json").read_text())
    tested = json.loads((run / "test_results.json").read_text())["ACE"]
    losses = result["final"]["history"]["train_loss"]
    if (len(history) != ACE_EPISODES or len(train_s) != ACE_EPISODES + 1
            or state["best_action"] != result["best_action"]
            or not all(0.0 <= h["f1"] <= 1.0 for h in history)
            or not np.isfinite(losses).all()
            or not 0.0 <= tested["micro_f1"] <= 1.0):
        raise AssertionError(f"cli train (ACE): history {history}, "
                             f"{len(train_s)} trainings, state {state}, "
                             f"final losses {losses}, test {tested}")
    log(f"cli train, trainer: ReinforcementTrainer ({describe(stack)}, CRF, "
        f"batch 32; "
        f"cuts: {ACE_EPISODES} episodes of {ACE_EPOCHS} epoch, "
        f"{splits['train']} train sentences): {wall:.1f} s in all; "
        + "; ".join(f"episode {h['episode']} mask {h['mask']} dev F1 "
                    f"{h['f1']:.4f} in {s:.1f} s"
                    for h, s in zip(history, train_s))
        + f"; best action {result['best_action']}; final training "
        f"{train_s[-1]:.1f} s, losses {', '.join(f'{v:.4f}' for v in losses)}"
        f"; test micro F1 {tested['micro_f1']:.4f}; peak allocated "
        f"{peak_gb:.2f} GB ({card})")

    # one optimizer step of the run's largest train batch, split by member,
    # on the trained tagger that cli train built
    config = ExperimentConfig.from_file(cfg)
    trainer.selection = np.ones(len(specs), np.float32)
    train_config = config.make_train_config()
    batch = max(trainer._make_train_batches(trainer.corpus.train,
                                            train_config, 0),
                key=lambda eb: eb.input_ids.shape[0])
    arrays = trainer._to_device(batch)
    members = trainer.model.stack.members
    flair = members[3]
    lengths = arrays["char_stream_mask"].sum(-1)

    def fwd_bwd(fn):
        def step():
            fn().float().sum().backward()
            trainer.model.zero_grad(set_to_none=True)
        return step

    opt = trainer.make_optimizer(train_config)
    rng = torch.Generator().manual_seed(1)
    parts = {
        "XLM-R forward (frozen)": lambda: members[0](arrays),
        "char-BiLSTM forward + backward": fwd_bwd(lambda: members[2](arrays)),
        "Flair forward LM forward + backward": fwd_bwd(
            lambda: flair.fwd(arrays["char_stream"], lengths)),
        "Flair backward LM forward + backward": fwd_bwd(
            lambda: flair.bwd(arrays["char_stream"], lengths)),
        "whole step (train_step)": lambda: trainer.train_step(
            batch, opt, train_config, rng)}
    for fn in parts.values():  # warm-up
        fn()
    split = {name: event_ms(fn) for name, fn in parts.items()}
    wall_ms, dev_ms, top = profile_step(trainer, batch, train_config,
                                        torch.cuda.synchronize)
    B, S = batch.input_ids.shape
    busy = ("not measured (the trace holds no device kernels)"
            if dev_ms is None else
            f"{dev_ms:.1f} ms of device kernels in {wall_ms:.1f} ms under "
            f"torch.profiler, idle {max(0.0, 1 - dev_ms / wall_ms):.1%}; "
            "largest: " + "; ".join(f"{n[:60]} {ms:.1f} ms x{c}"
                                    for n, ms, c in top))
    log(f"ACE optimizer step (B={B}, S={S} subtokens, W="
        f"{batch.word_mask.shape[1]} words, T="
        f"{arrays['char_stream'].shape[1]} stream characters), ms by CUDA "
        f"events: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; one step under the profiler: {busy} ({card})")
    del trainer, specs, opt, arrays, members, flair
    torch.cuda.empty_cache()

    # -- (c) the stack on the card against the CPU, float32 -------------------
    f32 = dataclasses.replace(config)
    f32.make_train_encoder_config = lambda tok: config.make_encoder_config(
        tok, dtype=torch.float32, param_dtype=torch.float32)
    tree = checkpoint.load(run / "best-model.msgpack")
    feats = []
    for where in ("cpu", dev):
        t, specs = cli._build_ace(f32, where)
        t.model.load_state_dict(weights.from_jax_params(tree, t.model))
        t.selection = np.ones(len(stack), np.float32)  # every member
        eb = make_batches(recs["train"][:n_check], t.tokenizer, None,
                          n_check)[0]
        with torch.no_grad():
            feats.append(t.model._extract_features(t._to_device(eb)).cpu())
        del t
    del tree
    widths = np.cumsum([0] + [spec.dim for spec in specs])
    errs = [float((feats[1][..., a:b] - feats[0][..., a:b]).abs().max())
            for a, b in zip(widths[:-1], widths[1:])]
    torch.testing.assert_close(feats[1], feats[0], rtol=FEATURE_RTOL,
                               atol=FEATURE_ATOL)
    log(f"the stack's features on the card against the CPU (float32 on "
        f"both, the ACE run's best-model.msgpack, every member selected, "
        f"{n_check} train sentence(s), "
        f"{tuple(feats[0].shape)}): max abs err per member "
        + ", ".join(f"{e:.3g}" for e in errs)
        + f" (rtol {FEATURE_RTOL}, atol {FEATURE_ATOL}) ({card})")
    del feats, specs
    torch.cuda.empty_cache()

    # -- (d) cli parse, ensemble, evaluate, speed -----------------------------
    ens = tmp / "ensemble"
    test_file = tmp / "stage-en" / "test.txt"
    gold = read_column_file(test_file, {0: "text", 1: "ner"})
    preds = []
    for name in ("stage1", "stage2"):
        run_cli(cli, ["parse", "--config", str(tmp / f"{name}.json"),
                      "--target_dir", str(test_file), "--out_dir",
                      str(ens / name), "--keep_order", *device])
        preds.append(ens / name / "test.conllu")
    # 4g's recipe tagger has no embedding2nn, which cli parse's tagger
    # always has: it is served as cli serve loads it, and its predictions
    # are written as cli parse writes them
    served = ServeConfig.from_file(tmp / "model.yaml")
    tag_dict = Dictionary.load(tmp / "b" / "tag_dictionary.json")
    tagger = cli.serving_tagger(served, tag_dict, dev)
    recs_b = read_column_file(test_file, {0: "text", 1: "ner"})
    for rec, pred in zip(recs_b, FinetuneTrainer(
            tagger, ListCorpus([]), served.make_tokenizer(), tag_dict,
            device=dev).predict(recs_b, sort_by_length=False)):
        rec.tags["pred"] = pred
    preds.append(ens / "b" / "test.conllu")
    write_column_file(preds[-1], recs_b, layers=("pred",))
    del tagger
    out_file = ens / "ens.conll"
    run_cli(cli, ["ensemble", *map(str, preds), "--out", str(out_file)])
    systems = [[r.tags["pred"] for r in read_column_file(
        p, {0: "text", 1: "pred"})] for p in preds + [out_file]]
    if any(len(s) != len(gold) for s in systems):
        raise AssertionError(f"cli ensemble: {[len(s) for s in systems]} "
                             f"sentences against {len(gold)}")
    joined = ens / "gold_pred.tsv"
    write_column_file(joined, [SentenceRecord(tokens=g.tokens, tags={
        "gold": g.tags["ner"], "pred": p}) for g, p in zip(gold, systems[-1])],
        layers=("gold", "pred"))
    scores = {}
    for label, path in (("ensemble", joined),
                        ("ACE test", run / "test.ACE.tsv")):
        _, text = run_cli(cli, ["evaluate", str(path)])
        scores[label] = json.loads(text.strip().splitlines()[-1])
        if not 0.0 <= scores[label]["micro_f1"] <= 1.0:
            raise AssertionError(f"cli evaluate ({label}): {scores[label]}")
    f1s = [evaluate_spans([g.tags["ner"] for g in gold], s).micro_avg_f_score()
           for s in systems[:-1]]
    _, text = run_cli(cli, ["speed", "--config", str(tmp / "stage2.json"),
                            *device])
    speed = json.loads(text.strip().splitlines()[-1])
    if not speed["sentences_per_second"] > 0:
        raise AssertionError(f"cli speed: {speed}")
    log(f"cli ensemble of three systems on the en stage test split "
        f"({len(gold)} sentences: cli parse of 4i's stage 1 and stage 2 "
        f"models, 4g's model served in bf16), span micro F1 against gold "
        + ", ".join(f"{f:.4f}" for f in f1s) + "; cli evaluate of the "
        f"ensemble joined with gold: {scores['ensemble']}; of the ACE run's "
        f"test.ACE.tsv: {scores['ACE test']}; cli speed on 4i's stage-2 "
        f"config (XLM-R {encoder_label(encoder)}, its test split): {speed} ({card})")
    log(f"phase 4j in {time.perf_counter() - t_phase:.1f} s")
    return {"k1_launches": got["bm25_score_block"]}


# phase 4k: knowledge distillation from two XLM-R teachers, then SWAF
KD_SPLITS = {"train": 64, "dev": 16, "test": 16}  # cut of 4h's splits
KD_DOC_SIZES = (4, 8)   # sentences per document of the KD corpus
KD_BATCH = 16
KD_STRIDE = 128         # teacher A's window budget, cut from 510
KD_STUDENTS = (("a", dict(teacher_cache="f16", temperature=2.0)),
               ("b", dict(posterior=True, teacher_cache="f32")),
               ("c", dict(teacher_cache="lazy")),
               ("d", dict(kbest=4)))


def kd_stage_phase(cli, bm25, dev, card, tmp, encoder="large",
                   splits=None) -> dict:
    """Phase 4k, after 4i in its directory ``tmp`` (4h's saved KB
    ``kb1m`` and CoNLL splits ``conll``, 4i's de stage corpus
    ``stage-de``): (a) a cut of 4h's splits grouped into documents of
    4-8 sentences (``-DOCSTART-`` lines) fused through ``cli retrieve``
    with the exhaustive engine (K1, one launch per split, each held to its
    plain version at its shape, every row); (b) two teachers through ``cli
    train``: A over the fused en split and the de stage corpus with
    ``stride_windows`` at 128 subtokens, B over the unfused en split (the
    fused files carry no document marks) and the de corpus (one document
    per sentence) with ``doc_context`` and an enhanced CRF with transition
    attention; (c) four students through ``cli train`` with ``trainer:
    DistillationTrainer`` and ``teachers: [A, B]`` routed per language
    (f16 cache with temperature 2, posterior with an f32 cache, lazy,
    k-best 4 from A), each step timed with CUDA events, and the
    fine-tuner's step on the same batches; (d) ``cli parse`` of student
    (a) and ``cli train`` with ``trainer: SWAFTrainer`` over the de test
    files of A, B and (a). All share one tag dictionary, written into each
    target directory first. Returns K1's launches in (a)."""
    from pathlib import Path

    import torch

    from kbner_tpu_torch.config import ExperimentConfig
    from kbner_tpu_torch.data.conll import (SentenceRecord, read_column_file,
                                            write_column_file)
    from kbner_tpu_torch.data.dictionary import make_tag_dictionary
    from kbner_tpu_torch.data.encode import make_batches
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.data.windows import split_long_record
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.pipeline import load_kb, sentence_query
    from kbner_tpu_torch.train.distill import DistillationTrainer

    splits = splits or KD_SPLITS
    device = ["--device", str(dev)]
    t_phase = time.perf_counter()
    rng = np.random.RandomState(71)
    fmt = {0: "text", 1: "ner"}

    def docstart():
        return SentenceRecord(tokens=["-DOCSTART-"], tags={"ner": ["O"]})

    # -- (a) the corpus in documents, fused through K1 ------------------------
    raw, fused = tmp / "kd-raw", tmp / "kd-conll"
    queries, n_docs = {}, {}
    for split, n in splits.items():
        cut = read_column_file(tmp / "conll" / f"{split}.txt", fmt,
                               comment_symbol="# id")[:n]
        out, i = [], 0
        while i < len(cut):
            size = int(rng.randint(KD_DOC_SIZES[0], KD_DOC_SIZES[1] + 1))
            out += [docstart()] + cut[i:i + size]
            i += size
        write_column_file(raw / f"{split}.txt", out)
        back = read_column_file(raw / f"{split}.txt", fmt,
                                comment_symbol="# id")
        n_docs[split] = len({r.doc_id for r in back})
        if [r.tokens for r in back] != [r.tokens for r in cut]:
            raise AssertionError(f"KD corpus ({split}): the documents read "
                                 "back differ from the sentences written")
        queries[split] = [sentence_query(r) for r in cut]
    reset_counts(bm25)
    _, wall = timed(lambda: run_cli(cli, [
        "retrieve", "--index_dir", str(tmp / "kb1m"), "--data_folder",
        str(raw), "--out", str(fused), "--tokenizer_config",
        str(tmp / "model.yaml"), *device]))
    got = counts(bm25)
    expect_counts("the KD corpus's cli retrieve", got,
                  {"bm25_score_block": len(splits)})
    text_index, store, title_index, _ = load_kb(tmp / "kb1m")
    engine = RetrievalEngine(text_index, store=store,
                             title_index=title_index, device=dev)
    held = "; ".join(
        f"{split} "
        + k1_at_retrieve_shape(bm25, engine, q, None, dev, every_row=True)
        for split, q in queries.items())
    del engine
    store.close()
    torch.cuda.empty_cache()
    fused_recs = {s: read_column_file(fused / f"{s}.txt", fmt,
                                      comment_symbol="# id") for s in splits}
    n_ctx = sum("<EOS>" in r.tokens for r in fused_recs["train"])
    fused_docs = len({r.doc_id for s in fused_recs.values() for r in s})
    if (any(len(fused_recs[s]) != n for s, n in splits.items())
            or n_ctx == 0):
        raise AssertionError(f"KD corpus: {[len(v) for v in fused_recs.values()]}"
                             f" fused sentences, {n_ctx} with context")
    log(f"KD corpus: {'/'.join(map(str, splits.values()))} train/dev/test KB "
        f"sentences in {'/'.join(map(str, n_docs.values()))} documents of "
        f"{KD_DOC_SIZES[0]}-{KD_DOC_SIZES[1]} sentences, fused by cli "
        f"retrieve with the exhaustive engine in {wall:.1f} s; launches "
        f"{got}; {n_ctx}/{splits['train']} train sentences with context; the"
        f" fused files hold {fused_docs} document(s) (cli retrieve drops the"
        f" -DOCSTART- marks, so teacher B's doc_context reads the unfused "
        f"split); bm25_score_block at each split's retrieve shape on kb1m's "
        f"text field: {held} ({card})")

    # -- (b) the configs, one tag dictionary, the two teachers -----------------
    de, de_docs = tmp / "stage-de", tmp / "kd-de-docs"
    for split in ("train", "dev", "test"):
        write_column_file(de_docs / f"{split}.txt", [
            rec for r in read_column_file(de / f"{split}.txt", fmt)
            for rec in (docstart(), r)])

    def corpus(name, folder):
        return {"name": name, "data_folder": str(folder),
                "column_format": {"0": "text", "1": "ner"},
                "comment_symbol": "# id", "tag_to_bioes": "ner"}

    train = {**RECIPE, "batch_size": KD_BATCH, "max_epochs": 1}
    common = {"tag_layer": "ner", "tokenizer": {"type": "hash",
                                                "vocab_size": HASH_VOCAB}}
    configs = {
        "A": {**common, "name": "kd-teacher-a",
              "corpora": [corpus("EN", fused), corpus("DE", de)],
              "model": {"encoder": encoder},
              "data": {"stride_windows": True, "max_subtokens": KD_STRIDE},
              "train": train, "target_dir": str(tmp / "kd-teacher-a")},
        "B": {**common, "name": "kd-teacher-b",
              "corpora": [corpus("EN", raw), corpus("DE", de_docs)],
              "model": {"encoder": encoder, "enhanced_crf": True,
                        "transition_attention": True},
              "data": {"doc_context": True},
              "train": train, "target_dir": str(tmp / "kd-teacher-b")}}
    paths = {k: tmp / f"kd-teacher-{k.lower()}.json" for k in ("A", "B")}
    for label, kw in KD_STUDENTS:
        configs[label] = {
            **common, "name": f"kd-student-{label}",
            "corpora": [corpus("EN", fused), corpus("DE", de)],
            "model": {"encoder": encoder}, "trainer": "DistillationTrainer",
            "teachers": [str(paths["A"]), str(paths["B"])],
            "train": {**train, **kw},
            "target_dir": str(tmp / f"kd-student-{label}")}
        paths[label] = tmp / f"kd-student-{label}.json"
    tokenizer = HashTokenizer(vocab_size=HASH_VOCAB)
    prepared = {}
    for key in ("A", "B"):
        cfg = ExperimentConfig.from_dict(configs[key])
        prepared[key] = cfg.prepare_corpus(cfg.load_corpus(), tokenizer)
    tag_dict = make_tag_dictionary(
        r.tags["ner"] for c in prepared.values() for corp in c.corpora
        for split in (corp.train, corp.dev, corp.test) for r in split)
    for key, raw_cfg in configs.items():
        paths[key].write_text(json.dumps(raw_cfg))
        tag_dict.save(Path(raw_cfg["target_dir"]) / "tag_dictionary.json")

    a_recs = [r for c in prepared["A"].corpora
              for split in (c.train, c.dev, c.test) for r in split]
    pieces = [len(split_long_record(r, tokenizer, KD_STRIDE, 16))
              for r in a_recs]
    n_split = sum(p > 1 for p in pieces)
    if n_split == 0:
        raise AssertionError("teacher A: no record exceeds the window "
                             "budget")
    grown = [len(w.tokens) - len(r.tokens) for w, r in zip(
        prepared["B"].corpora[0].train,
        read_column_file(raw / "train.txt", fmt, comment_symbol="# id"))]
    if not any(grown):
        raise AssertionError("teacher B: no document window holds a "
                             "neighbour")
    teachers = {}
    for key in ("A", "B"):
        torch.cuda.reset_peak_memory_stats()
        (result, _), wall = timed(lambda: run_cli(
            cli, ["train", "--config", str(paths[key]), *device]))
        run = Path(configs[key]["target_dir"])
        tested = json.loads((run / "test_results.json").read_text())
        losses = result["history"]["train_loss"]
        if not np.isfinite(losses).all() or set(tested) != {"EN", "DE"}:
            raise AssertionError(f"teacher {key}: losses {losses}, test "
                                 f"{tested}")
        teachers[key] = (result, tested, wall,
                         torch.cuda.max_memory_allocated() / 1e9)
        # the students load best-model.msgpack; 2.2 GB less on the disk
        (run / "final-model.msgpack").unlink()
    res, tested, wall, peak = teachers["A"]
    log(f"teacher A (cli train, XLM-R {encoder_label(encoder)}, CRF, stride_windows at "
        f"{KD_STRIDE} subtokens, stride 16 words; EN fused + DE, batch "
        f"{KD_BATCH}, 1 epoch): {n_split} of {len(a_recs)} records split "
        f"into {sum(p for p in pieces if p > 1)} windows (train, dev and "
        f"test; training and evaluate split them alike); {wall:.1f} s with "
        f"the build, checkpoints and final_test; loss "
        f"{res['history']['train_loss'][0]:.4f}; stitched evaluate span "
        f"micro F1 dev {res['history']['dev_score'][0]:.4f}, test EN "
        f"{tested['EN']['micro_f1']:.4f}, DE {tested['DE']['micro_f1']:.4f}"
        f" (random weights, one epoch); peak allocated {peak:.2f} GB "
        f"({card})")
    res, tested, wall, peak = teachers["B"]
    log(f"teacher B (cli train, XLM-R {encoder_label(encoder)}, enhanced CRF over 2 "
        f"languages with transition attention, doc_context at 510 "
        f"subtokens; EN unfused in documents + DE one sentence per "
        f"document): {sum(g > 0 for g in grown)}/{len(grown)} EN train "
        f"windows hold neighbours, {np.mean(grown):.1f} neighbour words on "
        f"average; {wall:.1f} s; loss {res['history']['train_loss'][0]:.4f}"
        f"; test span micro F1 EN {tested['EN']['micro_f1']:.4f}, DE "
        f"{tested['DE']['micro_f1']:.4f} (random weights); peak allocated "
        f"{peak:.2f} GB ({card})")

    # -- (c) four students -------------------------------------------------------
    kd_step = DistillationTrainer.kd_step
    emissions = DistillationTrainer._teacher_emissions
    kbest = DistillationTrainer._teacher_kbest
    events, caches = [], []

    def timed_step(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = kd_step(self, *args, **kwargs)
        end.record()
        events.append((start, end))
        return loss

    def timed_cache(fn, describe):
        def wrapped(self, batches, *args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, batches, *args, **kwargs)
            torch.cuda.synchronize()
            caches.append((time.perf_counter() - t0, describe(out)))
            return out
        return wrapped

    def emission_bytes(out):
        return (sum(a.nbytes for a in out), out[0].dtype)

    def kbest_bytes(out):
        for _, w in out:
            if not np.allclose(w.sum(-1), 1.0, rtol=1e-5):
                raise AssertionError("k-best weights do not sum to 1")
        return (sum(p.nbytes + w.nbytes for p, w in out), out[0][0].dtype)

    students = {}
    DistillationTrainer.kd_step = timed_step
    DistillationTrainer._teacher_emissions = timed_cache(emissions,
                                                         emission_bytes)
    DistillationTrainer._teacher_kbest = timed_cache(kbest, kbest_bytes)
    try:
        for label, kw in KD_STUDENTS:
            events.clear()
            caches.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            (result, _), wall = timed(lambda: run_cli(
                cli, ["train", "--config", str(paths[label]), *device]))
            peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.synchronize()
            step_ms = [s.elapsed_time(e) for s, e in events]
            run = Path(configs[label]["target_dir"])
            tested = json.loads((run / "test_results.json").read_text())
            losses = result["history"]["train_loss"]
            if (not np.isfinite(losses).all() or set(tested) != {"EN", "DE"}
                    or len(step_ms) < 3):
                raise AssertionError(f"student {label}: losses {losses}, "
                                     f"{len(step_ms)} steps, test {tested}")
            students[label] = dict(kw=kw, wall=wall, peak=peak,
                                   steps=step_ms, caches=list(caches),
                                   loss=losses[0], tested=tested)
            # (a)'s best model is parsed below
            for name in ("best-model.msgpack", "final-model.msgpack")[
                    label == "a":]:
                (run / name).unlink()
    finally:
        DistillationTrainer.kd_step = kd_step
        DistillationTrainer._teacher_emissions = emissions
        DistillationTrainer._teacher_kbest = kbest
    (t16, (b16, d16)), = students["a"]["caches"]
    (t32, (b32, d32)), = students["b"]["caches"]
    if (d16, d32) != (np.float16, np.float32) or b16 * 2 != b32:
        raise AssertionError(f"teacher caches: {b16} B {d16}, {b32} B {d32}")

    # the fine-tuner's step on the same batches, in the same order
    config = ExperimentConfig.from_file(paths["a"])
    ft = cli._build(config, dev)
    train_config = config.make_train_config()
    batches = make_batches(ft.corpus.train, ft.tokenizer, ft.tag_dict,
                           KD_BATCH, shuffle=False, tag_layer="ner",
                           max_subtokens=train_config.max_subtokens)
    opt = ft.make_optimizer(train_config)
    step_rng = torch.Generator().manual_seed(0)
    ft_events = []
    for b_idx in np.random.RandomState(train_config.seed).permutation(
            len(batches)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ft.train_step(batches[b_idx], opt, train_config, step_rng)
        end.record()
        ft_events.append((start, end))
    torch.cuda.synchronize()
    ft_ms = float(np.median([s.elapsed_time(e) for s, e in ft_events[2:]]))
    shapes = sorted({tuple(b.input_ids.shape) for b in batches})
    del ft, opt
    torch.cuda.empty_cache()

    def med(label):
        return float(np.median(students[label]["steps"][2:]))

    for label, kw in KD_STUDENTS:
        s = students[label]
        cache = ("; k-best cache " if "kbest" in kw else "; cache ") + (
            ", ".join(f"{sec:.2f} s, {nb / 1e6:.2f} MB of host {dt}"
                      for sec, (nb, dt) in s["caches"])
            if s["caches"] else "none (the teachers emit per step)")
        log(f"student ({label}) cli train, trainer: DistillationTrainer, "
            f"{kw}, teachers [A, B] per language, XLM-R {encoder_label(encoder)}, batch "
            f"{KD_BATCH}, 1 epoch of {len(s['steps'])} steps: {s['wall']:.1f}"
            f" s with the builds of student and teachers, checkpoints and "
            f"final_test{cache}; {med(label):.1f} ms per KD optimizer step "
            f"(CUDA events, median after the first two; steps "
            + ", ".join(f"{v:.1f}" for v in s["steps"])
            + f"); loss {s['loss']:.4f}; test span micro F1 EN "
            f"{s['tested']['EN']['micro_f1']:.4f}, DE "
            f"{s['tested']['DE']['micro_f1']:.4f} (random weights); peak "
            f"allocated {s['peak']:.2f} GB ({card})")
    log(f"KD step against the fine-tune step on the same {len(batches)} "
        f"batches (shapes {shapes}), in the same order, CUDA events, "
        f"median after the first two: fine-tune {ft_ms:.1f} ms; KD "
        + ", ".join(f"({label}) {med(label):.1f}" for label, _ in
                    KD_STUDENTS)
        + f" ms; the lazy step (c) {med('c') - med('a'):+.1f} ms against "
        f"the f16-cached step (a), {med('c') - med('b'):+.1f} against the "
        f"f32 posterior step (b); teacher caching f16 {t16:.2f} s for "
        f"{b16 / 1e6:.2f} MB, f32 {t32:.2f} s for {b32 / 1e6:.2f} MB of "
        f"host memory; peak allocated lazy {students['c']['peak']:.2f} GB "
        f"against cached {students['a']['peak']:.2f} GB ({card})")

    # -- (d) cli parse of student (a), SWAF over three systems --------------
    parse_dir = tmp / "kd-parse"
    _, wall_parse = timed(lambda: run_cli(cli, [
        "parse", "--config", str(paths["a"]), "--target_dir",
        str(fused / "test.txt"), "--out_dir", str(parse_dir), "--keep_order",
        *device]))
    parsed = read_column_file(parse_dir / "test.conllu", {0: "text",
                                                         1: "pred"},
                              comment_symbol="# id")
    if [r.tokens for r in parsed] != [r.tokens for r in fused_recs["test"]]:
        raise AssertionError("cli parse of student (a): the sentences "
                             "differ from the fused test split")
    files = [str(Path(configs[k]["target_dir"]) / "test.DE.tsv")
             for k in ("A", "B", "a")]
    texts = [[r.tokens for r in read_column_file(f, {0: "text", 1: "gold",
                                                     2: "pred"})]
             for f in files]
    if texts[1] != texts[0] or texts[2] != texts[0]:
        raise AssertionError("SWAF: the systems' de test files differ in "
                             "their sentences")
    swaf_cfg = tmp / "kd-swaf.json"
    swaf_cfg.write_text(json.dumps({
        "name": "kd-swaf", "trainer": "SWAFTrainer",
        "systems": {"dev": files, "test": files},
        "train": {"max_epochs": 200, "learning_rate": 0.01},
        "target_dir": str(tmp / "kd-swaf")}))
    (swaf, printed), wall_swaf = timed(lambda: run_cli(
        cli, ["train", "--config", str(swaf_cfg), *device]))
    combined = read_column_file(tmp / "kd-swaf" / "test.swaf.tsv",
                                {0: "text", 1: "pred"})
    if (json.loads(printed.strip().splitlines()[-1]) != swaf
            or not np.isfinite(swaf["final_loss"])
            or not 0.0 <= swaf["test_micro_f1"] <= 1.0
            or [r.tokens for r in combined] != texts[0]):
        raise AssertionError(f"SWAF: {swaf}, {len(combined)} sentences")
    system_f1 = ", ".join(f"{t['DE']['micro_f1']:.4f}" for t in (
        teachers["A"][1], teachers["B"][1], students["a"]["tested"]))
    log(f"cli parse of student (a) on the fused en test split: "
        f"{len(parsed)} sentences in {wall_parse:.1f} s; cli train, "
        f"trainer: SWAFTrainer over the de test files of A, B and (a) "
        f"({len(texts[0])} sentences, 200 Adam steps at 0.01): "
        f"{wall_swaf:.1f} s, final loss {swaf['final_loss']:.4f}, combined "
        f"test span micro F1 {swaf['test_micro_f1']:.4f} against the "
        f"systems' {system_f1} (all from random weights) ({card})")
    log(f"phase 4k in {time.perf_counter() - t_phase:.1f} s")
    return {"k1_launches": got["bm25_score_block"]}


# phase 4l: the collection-scale index and a pretrained XLM-R checkpoint
N_STREAM_CHUNKS = 4     # bench.py's big build streams 5 x 4,194,304 docs
N_SHARDS = 4
N_ORACLE_QUERIES = 2    # score_oracle is O(Q x Lq x N x Ld) on the host
# cli parity's MultiCoNER-layout folders, cut from 4h's and 4i's splits:
# sentences per language of stage 1 (en, zh, ru), and of stage 2 (en)
PARITY_MULTI = {"train": 16, "dev": 8, "test": 8}
PARITY_EN = {"train": 32, "dev": 16, "test": 16}
MULTI_FOLDER = "MULTI_Multilingual_conll_rank_eos_doc_full_wiki_v3"
EN_FOLDER = "EN-English_conll_rank_eos_doc_full_wiki_v3"


def row_pairs(index) -> np.ndarray:
    """Each row's (term, impact bits) pairs, sorted: what a row holds,
    whatever the order of its terms."""
    return np.sort(index.doc_terms.astype(np.int64) * (1 << 32)
                   + index.doc_impacts.view(np.int32), axis=1)


def streamed_index_phase(bm25, dev, card, tmp, docs, index, encoded_s,
                         texts, exact, pruned, n_chunks=N_STREAM_CHUNKS,
                         n_shards=N_SHARDS) -> dict:
    """Phase 4l (a): ``docs`` cut into ``n_chunks`` chunks, each trimmed
    to its own widest row, stream-built and held equal to ``index`` (the
    ``build_encoded`` index of phase 4a, built in ``encoded_s`` s); saved
    in ``n_shards`` shards and reopened equal; an exhaustive and a pruned
    engine over the reopened index, each serving the 32 queries ``texts``
    once (K1, K2), held to 4a's engines' results ``exact`` and
    ``pruned``, to each other (recall@10) and to ``score_oracle``. Returns
    the two launch counts."""
    import torch

    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.index import BM25Index

    cuts = np.linspace(0, len(docs), n_chunks + 1).astype(int)

    def chunks():
        for lo, hi in zip(cuts[:-1], cuts[1:]):
            c = docs[lo:hi]
            yield c[:, :int(np.flatnonzero((c >= 0).any(0)).max()) + 1]

    widths = [c.shape[1] for c in chunks()]
    streamed, stream_s = timed(lambda: BM25Index.build_streaming(
        chunks(), index.vocab))
    if (streamed.n_docs, streamed.avgdl, streamed.doc_terms.shape) != (
            index.n_docs, index.avgdl, index.doc_terms.shape):
        raise AssertionError(
            f"build_streaming: {streamed.n_docs} docs, avgdl "
            f"{streamed.avgdl}, layout {streamed.doc_terms.shape} against "
            f"{index.n_docs}, {index.avgdl}, {index.doc_terms.shape}")
    for name in ("idf", "doc_dl"):
        if not np.array_equal(getattr(streamed, name), getattr(index, name)):
            raise AssertionError(f"build_streaming: {name} differs from "
                                 "build_encoded's")
    if not np.array_equal(row_pairs(streamed), row_pairs(index)):
        raise AssertionError("build_streaming: a row's (term, impact) pairs "
                             "differ from build_encoded's")
    reordered = int((streamed.doc_terms != index.doc_terms).any(1).sum())
    capped = int((index.doc_terms[:, -1] >= 0).sum())
    log(f"build_streaming over {n_chunks} chunks of 4a's docs (widths "
        f"{widths}, {streamed.n_docs} docs, vocabulary {len(index.vocab)}): "
        f"{stream_s:.1f} s against build_encoded's {encoded_s:.1f} s in 4a "
        f"(host clock); idf, avgdl and doc_dl equal, every row's (term, "
        f"impact) "
        f"pairs equal after sorting by term; {reordered} rows hold their "
        f"terms in another order ({capped} rows fill the Ld="
        f"{index.doc_terms.shape[1]} cap, where the order is free)")

    sharded = tmp / "sharded"
    _, save_s = timed(lambda: streamed.save_sharded(sharded, n_shards))
    n_bytes = sum(f.stat().st_size for f in sharded.iterdir())
    reopened, load_s = timed(lambda: BM25Index.load_sharded(sharded))
    same = (reopened.n_docs == streamed.n_docs
            and reopened.avgdl == streamed.avgdl
            and reopened.params == streamed.params
            and reopened.vocab == streamed.vocab
            and all(np.array_equal(getattr(reopened, n), getattr(streamed, n))
                    for n in ("idf", "doc_terms", "doc_impacts", "doc_dl")))
    if not same:
        raise AssertionError("load_sharded: the reopened index differs from "
                             "the one saved")
    log(f"save_sharded ({n_shards} shards) {save_s:.2f} s, "
        f"{n_bytes / 1e6:.1f} MB on disk; load_sharded {load_s:.2f} s; the "
        f"reopened arrays, statistics and vocabulary equal (host clock)")

    t0 = time.perf_counter()
    ex = RetrievalEngine(reopened, device=dev)
    pr = RetrievalEngine(reopened, mode="pruned", device=dev, **PRUNED_KNOBS)
    torch.cuda.synchronize()
    engines_s = time.perf_counter() - t0
    qt, qw = reopened.encode_queries(texts, max_query_terms=MAX_QUERY_TERMS)
    reset_counts(bm25)
    got_ex = ex.search_encoded(qt, qw, k=K)
    ex_counts = counts(bm25)
    reset_counts(bm25)
    got_pr = pr.search_encoded(qt, qw, k=K)
    pr_counts = counts(bm25)
    expect_counts("the reopened index's exhaustive engine", ex_counts,
                  {"bm25_score_block": 1})
    expect_counts("the reopened index's pruned engine", pr_counts,
                  {"delta16_rescore": 1})
    assert_same_results("exhaustive over the reopened index against 4a's",
                        [exact], [got_ex])
    assert_same_results("pruned over the reopened index against 4a's",
                        [pruned], [got_pr])
    recall = recall_at_k([got_ex], [got_pr])
    if recall < MIN_RECALL:
        raise AssertionError(f"pruned recall@{K} {recall:.4f} over the "
                             f"reopened index, bar {MIN_RECALL}")
    k1 = k1_at_retrieve_shape(bm25, ex, texts, None, dev, every_row=True)
    k2 = k2_at_retrieve_shape(bm25, pr, texts)
    oracle, oracle_s = timed(lambda: reopened.score_oracle(
        texts[:N_ORACLE_QUERIES]))
    dt, di = ex.fields["text"]
    rows = bm25.bm25_score_block(
        torch.from_numpy(qt[:N_ORACLE_QUERIES]).to(dev),
        torch.from_numpy(qw[:N_ORACLE_QUERIES]).to(dev), dt, di).cpu().numpy()
    n = oracle.shape[1]
    np.testing.assert_allclose(rows[:, :n], oracle, rtol=RTOL, atol=ATOL,
                               err_msg="K1 against score_oracle")
    if rows[:, n:].any() or not (oracle > 0).any():
        raise AssertionError("K1 against score_oracle: a score on a pad "
                             "doc, or no match")
    log(f"engines over the reopened index, built in {engines_s:.1f} s: one "
        f"serve batch of {len(texts)} queries, launches exhaustive "
        f"{ex_counts}, pruned {pr_counts}; both top-{K} lists equal 4a's "
        f"engines' within ties; pruned recall@{K} against exhaustive "
        f"{recall:.4f} (bar {MIN_RECALL}); bm25_score_block: {k1}; "
        f"delta16_rescore: {k2}; score_oracle (float64, host, "
        f"{oracle_s:.1f} s) of {N_ORACLE_QUERIES} queries equals K1's rows "
        f"over all {n} docs (rtol {RTOL}, atol {ATOL}) ({card})")
    return {"k1": ex_counts["bm25_score_block"],
            "k2": pr_counts["delta16_rescore"]}


def hf_name(key: str) -> str:
    """The HF xlm-roberta name of an ``XLMREncoder`` state-dict key."""
    parts = key.split(".")
    embeddings = {"word_embeddings": "embeddings.word_embeddings",
                  "position_embeddings": "embeddings.position_embeddings",
                  "token_type_embeddings": "embeddings.token_type_embeddings",
                  "embeddings_ln": "embeddings.LayerNorm"}
    if parts[0] in embeddings:
        return f"{embeddings[parts[0]]}.{parts[-1]}"
    _, i, *module, leaf = parts
    module = {("attention", "query"): "attention.self.query",
              ("attention", "key"): "attention.self.key",
              ("attention", "value"): "attention.self.value",
              ("attention", "out"): "attention.output.dense",
              ("attention_ln",): "attention.output.LayerNorm",
              ("intermediate",): "intermediate.dense",
              ("output",): "output.dense",
              ("output_ln",): "output.LayerNorm"}[tuple(module)]
    return f"encoder.layer.{i}.{module}.{leaf}"


def write_hf_config(path, cfg) -> None:
    """``path/config.json`` of an XLM-R config under HF's field names."""
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps({
        "architectures": ["XLMRobertaForMaskedLM"],
        "model_type": "xlm-roberta", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "type_vocab_size": cfg.type_vocab_size,
        "pad_token_id": cfg.pad_token_id,
        "layer_norm_eps": cfg.layer_norm_eps, "hidden_act": "gelu",
        "hidden_dropout_prob": 0.1, "attention_probs_dropout_prob": 0.1}))


def write_hf_checkpoint(path, state, cfg) -> int:
    """An HF xlm-roberta directory, written independently of the port's
    reader: ``config.json`` under HF's field names and
    ``model.safetensors`` (a little-endian u64 header length, the JSON
    header padded to 8 bytes, then each tensor's float32 bytes) under
    ``roberta.``-prefixed names. Returns the tensor bytes written."""
    write_hf_config(path, cfg)
    header, offset = {}, 0
    for key, t in state.items():
        header[f"roberta.{hf_name(key)}"] = {
            "dtype": "F32", "shape": list(t.shape),
            "data_offsets": [offset, offset + 4 * t.numel()]}
        offset += 4 * t.numel()
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path / "model.safetensors", "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for t in state.values():
            f.write(t.detach().float().contiguous().cpu().numpy()
                    .astype("<f4", copy=False).data)
    return offset


def write_multiconer(path, records) -> None:
    """Records as a MultiCoNER column file: token, two placeholder
    part-of-speech columns, the ner tag."""
    from kbner_tpu_torch.data.conll import SentenceRecord, write_column_file

    write_column_file(path, [SentenceRecord(
        tokens=r.tokens, tags={"pos": ["_"] * len(r.tokens),
                               "upos": ["_"] * len(r.tokens),
                               "ner": r.tags["ner"]},
        comment=r.comment) for r in records], layers=("pos", "upos", "ner"))


def checkpoint_phase(cli, dev, card, tmp, enc_cfg=None) -> None:
    """Phase 4l (b): an HF directory written from a seeded encoder
    (``enc_cfg``; XLM-R large's width at ``CUT_LAYERS`` of its 24 layers
    by default), loaded onto the card with ``load_hf_checkpoint`` and
    held bit-equal to its source; then ``cli parity --weights`` over
    MultiCoNER-layout folders cut from 4h's and 4i's splits (stage 1 en +
    zh + ru, stage 2 en, one epoch each), each stage's encoder held to the
    checkpoint at build and stage 2's to stage 1's export at load."""
    import dataclasses

    import torch

    from kbner_tpu_torch.data.conll import read_column_file
    from kbner_tpu_torch.models.embedders import TransformerWordEmbedder
    from kbner_tpu_torch.models.xlmr import XLMRConfig, load_hf_checkpoint

    enc_cfg = enc_cfg or dataclasses.replace(
        XLMRConfig.large(param_dtype=torch.float32), num_layers=CUT_LAYERS)
    member = TransformerWordEmbedder(enc_cfg, device=dev)
    member.reset_parameters(torch.Generator(device=dev).manual_seed(7))
    state = member.encoder.state_dict()
    ckpt = tmp / "xlmr-hf"
    n_bytes, write_s = timed(lambda: write_hf_checkpoint(ckpt, state,
                                                         enc_cfg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    loaded = load_hf_checkpoint(ckpt, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() - before) / 1e9
    if loaded.keys() != state.keys() or not all(
            loaded[k].dtype == torch.float32 and torch.equal(loaded[k], v)
            for k, v in state.items()):
        raise AssertionError("load_hf_checkpoint: a tensor differs from the "
                             "checkpoint's source")
    del loaded
    log(f"HF checkpoint of XLM-R ({enc_cfg.num_layers} layers, hidden "
        f"{enc_cfg.hidden_size}, vocab {enc_cfg.vocab_size}; seeded "
        f"weights): config.json + model.safetensors, {len(state)} F32 "
        f"tensors under roberta. keys, {n_bytes / 1e9:.3f} GB, written in "
        f"{write_s:.1f} s by the smoke's own writer; load_hf_checkpoint onto "
        f"the card {load_s:.2f} s ({n_bytes / 1e9 / load_s:.2f} GB/s, page "
        f"cache warm), peak {peak_gb:.2f} GB allocated above what was "
        f"resident; every tensor bit-equal to its source ({card})")

    # MultiCoNER-layout folders: stage 1 en + zh + ru, stage 2 other en
    fmt = {0: "text", 1: "ner"}
    data = tmp / "parity-data"
    for split in ("train", "dev", "test"):
        en, zh, mix = (read_column_file(tmp / d / f"{split}.txt", fmt,
                                        comment_symbol="# id")
                       for d in ("conll", "zh-conll", "mix-conll"))
        ru = [r for r in mix if r.comment.startswith("# id ru-")]
        n = PARITY_MULTI[split]
        write_multiconer(data / MULTI_FOLDER / f"{split}.txt",
                         en[:n] + zh[:n] + ru[:n])
        write_multiconer(data / EN_FOLDER / f"{split}.txt",
                         en[n:n + PARITY_EN[split]])
    built = []
    load_weights = cli._load_encoder_weights

    def checked_weights(model, weights_dir):
        load_weights(model, weights_dir)
        own = model.encoder.state_dict()
        built.append(all(torch.equal(own[k], v) for k, v in state.items()))

    out = tmp / "parity"
    cli._load_encoder_weights = checked_weights
    torch.cuda.reset_peak_memory_stats()
    try:
        with watch_stages() as (seen, stage_s):
            (summary, printed), wall = timed(lambda: run_cli(cli, [
                "parity", "--weights", str(ckpt), "--data", str(data),
                "--out", str(out), "--hash_vocab", str(HASH_VOCAB),
                "--epochs_stage1", "1", "--epochs_stage2", "1",
                "--device", str(dev)]))
    finally:
        cli._load_encoder_weights = load_weights
    export = out / "stage1" / "finetuned-encoder.msgpack"
    keys = {"parity", "stage1_best_dev", "stage2_best_dev", "test_results",
            "conlleval_micro_f1"}
    if (summary is None or set(summary) != keys or summary["parity"] != "ran"
            or json.loads(printed[printed.index("{"):]) != summary
            or not (out / "stage2" / "test.parity-stage2-en.tsv").exists()
            or summary["conlleval_micro_f1"] < 0.0):
        raise AssertionError(f"cli parity: summary {summary}")
    if built != [True, True] or len(stage_s) != 2:
        raise AssertionError(f"cli parity: encoder equal to the checkpoint "
                             f"at each build {built}, {len(stage_s)} stages")
    if len(seen) != 1 or seen[0][0] != export or seen[0][1] != 0.0:
        raise AssertionError(f"cli parity: stage 2's encoder loads {seen}")
    log(f"cli parity --weights (hash tokenizer: the directory holds no "
        f"tokenizer files; stage 1 en + zh + ru {PARITY_MULTI}, stage 2 en "
        f"{PARITY_EN} per split, MultiCoNER's 4 columns, 1 epoch each, "
        f"lr 5e-6 with the head at x10000, remat): {wall:.1f} s in all, "
        f"stages {stage_s[0]:.1f} s and {stage_s[1]:.1f} s (training, "
        f"evaluation and checkpoints); both stages' encoders equal the "
        f"checkpoint at build; stage 2's encoder at load against stage 1's "
        f"export: max abs diff {seen[0][1]} over {seen[0][2]} arrays; peak "
        f"allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
        f"summary {json.dumps(summary)} (F1 from random weights says "
        f"nothing of the recipe's quality) ({card})")


# phase 4m: the parser and classifier families through cli train, test and
# parse: a seeded UD treebank, KB sentences fused through K1 for span NER,
# and fastText documents
UD_RELS = ("acl advcl advmod amod appos aux case cc ccomp clf compound conj "
           "cop csubj dep det discourse dislocated expl fixed flat goeswith "
           "iobj list mark nmod nsubj nummod obj obl orphan parataxis punct "
           "reparandum root vocative xcomp").split()  # the 37 UD relations
# a seeded treebank's splits (EWT's 12,544 train), halved to leave room in
# the smoke's time limit for phase 4p
PARSE_SPLITS = {"train": 128, "dev": 32, "test": 32}
PARSE_WORDS = (8, 40)   # words per treebank sentence
SECOND_HEAD = 0.1       # share of words with a second head in DEPS
NER_DP_SPLITS = {"train": 64, "dev": 16, "test": 16}  # cut of 4h's splits
PARSE_BATCH = 16
CHECK_LAYERS = 2        # the float32 card-vs-CPU parser's depth
N_CHECK_SENTENCES = 4


def _projective(rng, lo: int, hi: int, head: int, heads) -> None:
    """A random projective subtree over words ``lo..hi`` under ``head``:
    a random word of the span takes ``head``, the two sides recurse."""
    if lo > hi:
        return
    r = int(rng.randint(lo, hi + 1))
    heads[r - 1] = head
    _projective(rng, lo, r - 1, r, heads)
    _projective(rng, r + 1, hi, r, heads)


def synth_treebank(n: int, seed: int):
    """``n`` seeded UD sentences: each a list of 10-column CoNLL-U rows
    over Zipf words ``w<id>``, a random single-root projective tree of
    ``PARSE_WORDS`` words labelled from the 37 UD relations, and a DEPS
    column holding each word's head and, for about ``SECOND_HEAD`` of the
    words, a second one."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        size = int(rng.randint(PARSE_WORDS[0], PARSE_WORDS[1] + 1))
        heads = [0] * size
        _projective(rng, 1, size, 0, heads)
        words = np.minimum(rng.zipf(1.3, size), 20_000)
        rows = []
        for i, (h, w) in enumerate(zip(heads, words), 1):
            rel = "root" if h == 0 else UD_RELS[rng.randint(len(UD_RELS))]
            while rel == "root" and h != 0:
                rel = UD_RELS[rng.randint(len(UD_RELS))]
            deps = {h: rel}
            if rng.rand() < SECOND_HEAD:
                h2 = int(rng.randint(0, size + 1))
                if h2 not in (h, i):
                    deps[h2] = UD_RELS[rng.randint(len(UD_RELS))]
            cell = "|".join(f"{k}:{v}" for k, v in sorted(deps.items()))
            rows.append(f"{i}\tw{w}\t_\t_\t_\t_\t{h}\t{rel}\t{cell}\t_")
        out.append(rows)
    return out


def is_tree(heads) -> bool:
    """One word on ROOT and every head chain reaches it."""
    heads = [int(h) for h in heads]
    if sum(h == 0 for h in heads) != 1:
        return False
    for d in range(1, len(heads) + 1):
        seen, x = set(), d
        while x != 0:
            if x in seen or not 0 <= x - 1 < len(heads):
                return False
            seen.add(x)
            x = heads[x - 1]
    return True


def parse_corpora(tmp, splits) -> dict:
    """The treebank (``ud``, 10-column CoNLL-U files read as column
    corpora) and fastText folders of its sentences (``clf``: a length
    class, ``reg``: the length over 40). Returns the treebank's rows per
    split."""
    bank = {}
    for i, (split, n) in enumerate(splits.items()):
        bank[split] = synth_treebank(n, seed=90 + i)
        for name in ("ud", "clf", "reg"):
            (tmp / name).mkdir(parents=True, exist_ok=True)
        (tmp / "ud" / f"{split}.txt").write_text(
            "".join("\n".join(rows) + "\n\n" for rows in bank[split]))
        clf, reg = [], []
        for rows in bank[split]:
            words = " ".join(r.split("\t")[1] for r in rows)
            size = len(rows)
            label = "short" if size < 18 else "mid" if size < 30 else "long"
            clf.append(f"__label__{label} {words}")
            reg.append(f"__label__{size / 40:.3f} {words}")
        (tmp / "clf" / f"{split}.txt").write_text("\n".join(clf) + "\n")
        (tmp / "reg" / f"{split}.txt").write_text("\n".join(reg) + "\n")
    return bank


def parser_check_batch(bank_rows, rel_dict, tokenizer, unannotated, seed):
    """The encoded batch of the first ``N_CHECK_SENTENCES`` treebank
    sentences with their gold arrays, a share ``unannotated`` of the
    heads made ``_``."""
    from kbner_tpu_torch.data.conll import SentenceRecord
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.models.biaffine import encode_dependency_arrays

    rng = np.random.RandomState(seed)
    recs = []
    for rows in bank_rows[:N_CHECK_SENTENCES]:
        cols = [r.split("\t") for r in rows]
        recs.append(SentenceRecord(tokens=[c[1] for c in cols], tags={
            "head": ["_" if rng.rand() < unannotated else c[6]
                     for c in cols],
            "deprel": [c[7] for c in cols]}))
    eb = encode_batch(recs, tokenizer)
    encode_dependency_arrays(eb, rel_dict=rel_dict)
    return eb.arrays()


def parser_against_cpu(dev, enc_cfg, bank_rows, rel_dict, tokenizer) -> str:
    """One float32 biaffine parser (``enc_cfg``: XLM-R large's width at
    ``CHECK_LAYERS`` layers), its biaffine weights drawn non-zero, on the
    card and on the CPU with the same weights, under ``ce``, ``crf`` and
    ``partial``: ``s_arc``, the loss and every parameter's gradient held
    at rtol 1e-3 with an atol of 1e-4 of the CPU tensor's largest
    magnitude (float32 sums in another order over width 1024); the
    attention key biases' gradients, 0 in exact arithmetic (a key bias
    shifts every score of a softmax row alike), within 1e-6 on both
    devices. Returns the report."""
    import dataclasses

    import torch

    from kbner_tpu_torch.models.biaffine import BiaffineConfig, BiaffineParser

    parts = []
    cfg = BiaffineConfig(enc_cfg, num_rels=len(rel_dict))
    cpu = BiaffineParser(cfg, device="cpu", seed=0)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(1)
        for p in (cpu.arc_attn.weight, cpu.rel_attn.weight):
            p.normal_(0.0, 0.05, generator=gen)
    gpu = BiaffineParser(cfg, device=dev, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    for arc_loss, partial in (("ce", False), ("crf", False), ("crf", True)):
        # the arc loss is read from the config at each call
        cpu.config = gpu.config = dataclasses.replace(
            cfg, arc_loss=arc_loss, partial=partial)
        cpu.zero_grad(set_to_none=True)
        gpu.zero_grad(set_to_none=True)
        arrays = parser_check_batch(bank_rows, rel_dict, tokenizer,
                                    0.3 if partial else 0.0, seed=5)
        if partial and not (arrays["heads"] < 0).any():
            raise AssertionError("the partial check batch has no "
                                 "unannotated head")
        b_cpu = {k: torch.from_numpy(v) for k, v in arrays.items()}
        b_gpu = {k: v.to(dev) for k, v in b_cpu.items()}
        worst = {}

        def held(name, got, want):
            want = want.detach().float()
            got = got.detach().float().cpu()
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=1e-3,
                                       atol=1e-4 * scale + 1e-12, msg=name)
            worst[name] = float((got - want).abs().max()) / max(scale, 1e-30)

        held("s_arc", gpu.scores(b_gpu)[0], cpu.scores(b_cpu)[0])
        l_cpu, l_gpu = cpu.loss(b_cpu), gpu.loss(b_gpu)
        l_cpu.backward()
        l_gpu.backward()
        l_cpu, l_gpu = l_cpu.detach(), l_gpu.detach()
        held("loss", l_gpu, l_cpu)
        n_params, key_bias = 0, 0.0
        for (name, p), q in zip(cpu.named_parameters(), gpu.parameters()):
            if name.endswith("attention.key.bias"):
                key_bias = max(key_bias, float(p.grad.abs().max()),
                               float(q.grad.abs().max()))
                if key_bias > 1e-6:
                    raise AssertionError(f"{name}: gradient {key_bias:.3g}, "
                                         "0 in exact arithmetic")
                continue
            held(name, q.grad, p.grad)
            n_params += 1
        key = max(worst, key=worst.get)
        parts.append(f"{arc_loss}{' partial' if partial else ''}: loss "
                     f"{float(l_gpu):.5f} (CPU {float(l_cpu):.5f}), s_arc "
                     f"and {n_params} gradients held, largest error "
                     f"{worst[key]:.2e} of its tensor's scale ({key}); key "
                     f"bias gradients <= {key_bias:.2e}")
    del cpu, gpu
    torch.cuda.empty_cache()
    return "; ".join(parts)


def tree_crf_on_card(dev, word_mask, reps: int = 5) -> dict:
    """The tree CRF at one train batch's shape (``word_mask`` [B, W], the
    grid n = W + 1) on random scores: the marginals on the card held to
    float64 on the CPU (atol 1e-4), and the ms (CUDA events, median of
    ``reps``) of the loss forward and backward and of the marginals."""
    import torch

    from kbner_tpu_torch.ops.tree_crf import tree_crf_loss, tree_crf_marginals

    B, W = word_mask.shape
    rng = np.random.RandomState(4)
    scores = torch.from_numpy((3 * rng.randn(B, W + 1, W + 1)).astype(
        np.float32))
    wm = torch.from_numpy(np.asarray(word_mask))
    got = tree_crf_marginals(scores.to(dev), wm.to(dev)).cpu()
    want = tree_crf_marginals(scores.double(), wm)
    err = float((got.double() - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"tree-CRF marginals on the card differ from "
                             f"float64 on the CPU by {err:.3g}")
    s_dev, wm_dev = scores.to(dev), wm.to(dev)
    heads = torch.zeros((B, W), dtype=torch.long, device=dev)

    def loss_step():
        s = s_dev.detach().requires_grad_(True)
        tree_crf_loss(s, wm_dev, heads).sum().backward()

    loss_ms = float(np.median([event_ms(loss_step) for _ in range(reps)]))
    marg_ms = float(np.median([event_ms(lambda: tree_crf_marginals(
        s_dev, wm_dev)) for _ in range(reps)]))
    return dict(B=B, n=W + 1, err=err, loss_ms=loss_ms, marg_ms=marg_ms)


def parse_stage_phase(cli, bm25, dev, card, tmp, cut, encoder="large",
                      splits=None, ner_splits=None, check_cfg=None) -> dict:
    """Phase 4m, after 4l in its directory ``tmp`` (4h's saved KB ``kb1m``,
    CoNLL splits ``conll`` and ``model.yaml``): (a) a seeded UD treebank
    and fastText documents of its sentences; (b) a cut of 4h's splits
    fused through ``cli retrieve`` with the exhaustive engine (K1, one
    launch per split, each held to its plain version at its shape, every
    row) for span NER; (c) a float32 biaffine parser at ``check_cfg``
    (XLM-R large's width, ``CHECK_LAYERS`` layers) on the card against the
    CPU under ``ce``, ``crf`` and ``partial``; (d) ``cli train``, ``cli
    test`` and, for the tree parser, ``cli parse`` of every parsing and
    classification target (``dependency`` with the tree CRF through
    ``encoder``, the others through ``cut``), each step timed with CUDA
    events, the parsed test split held to be trees, each target's
    checkpoints deleted before the next; the tree CRF at the first train
    batch's shape against float64 on the CPU, and a learning probe of the
    tree parser. Returns K1's launches in (b)."""
    import dataclasses
    from pathlib import Path

    import torch

    from kbner_tpu_torch.config import ExperimentConfig
    from kbner_tpu_torch.data.conll import read_column_file, write_column_file
    from kbner_tpu_torch.models.xlmr import XLMRConfig
    from kbner_tpu_torch.retrieval.engine import RetrievalEngine
    from kbner_tpu_torch.retrieval.pipeline import load_kb, sentence_query
    from kbner_tpu_torch.train import parser_trainer as pt
    from kbner_tpu_torch.train.optim import make_finetune_optimizer

    splits = splits or PARSE_SPLITS
    ner_splits = ner_splits or NER_DP_SPLITS
    check_cfg = check_cfg or dataclasses.replace(XLMRConfig.large(
        vocab_size=HASH_VOCAB, dtype=torch.float32,
        param_dtype=torch.float32, hidden_dropout=0.0,
        attention_dropout=0.0), num_layers=CHECK_LAYERS)
    device = ["--device", str(dev)]
    t_phase = time.perf_counter()

    # -- (a) the treebank and the documents -----------------------------------
    bank, wall_bank = timed(lambda: parse_corpora(tmp, splits))
    n_second = sum(r.split("\t")[8].count("|") for s in bank.values()
                   for rows in s for r in rows)
    n_words = sum(len(rows) for s in bank.values() for rows in s)
    log(f"treebank: {'/'.join(map(str, splits.values()))} train/dev/test "
        f"sentences of {PARSE_WORDS[0]}-{PARSE_WORDS[1]} words ({n_words} "
        f"words), random projective trees over the {len(UD_RELS)} UD "
        f"relations, {n_second} second heads in DEPS "
        f"({n_second / n_words:.1%} of the words); fastText length classes "
        f"and lengths of the same sentences; written in {wall_bank:.1f} s")

    # -- (b) the span-NER corpus, fused through K1 ---------------------------
    fmt = {0: "text", 1: "ner"}
    raw, fused = tmp / "ner-dp-raw", tmp / "ner-dp-conll"
    queries = {}
    for split, n in ner_splits.items():
        cut_recs = read_column_file(tmp / "conll" / f"{split}.txt", fmt,
                                    comment_symbol="# id")[:n]
        write_column_file(raw / f"{split}.txt", cut_recs)
        queries[split] = [sentence_query(r) for r in cut_recs]
    reset_counts(bm25)
    _, wall_fuse = timed(lambda: run_cli(cli, [
        "retrieve", "--index_dir", str(tmp / "kb1m"), "--data_folder",
        str(raw), "--out", str(fused), "--tokenizer_config",
        str(tmp / "model.yaml"), *device]))
    got = counts(bm25)
    expect_counts("the span-NER corpus's cli retrieve", got,
                  {"bm25_score_block": len(ner_splits)})
    text_index, store, title_index, _ = load_kb(tmp / "kb1m")
    engine = RetrievalEngine(text_index, store=store,
                             title_index=title_index, device=dev)
    held_k1 = "; ".join(
        f"{split} " + k1_at_retrieve_shape(bm25, engine, q, None, dev,
                                           every_row=True)
        for split, q in queries.items())
    del engine
    store.close()
    torch.cuda.empty_cache()
    fused_train = read_column_file(fused / "train.txt", fmt,
                                   comment_symbol="# id")
    n_ctx = sum("<EOS>" in r.tokens for r in fused_train)
    if len(fused_train) != ner_splits["train"] or n_ctx == 0:
        raise AssertionError(f"span-NER corpus: {len(fused_train)} fused "
                             f"train sentences, {n_ctx} with context")
    log(f"span-NER corpus: {'/'.join(map(str, ner_splits.values()))} "
        f"train/dev/test KB sentences fused by cli retrieve with the "
        f"exhaustive engine in {wall_fuse:.1f} s; launches {got}; "
        f"{n_ctx}/{len(fused_train)} train sentences with context, up to "
        f"{max(len(r.tokens) for r in fused_train)} words; bm25_score_block"
        f" at each split's retrieve shape on kb1m's text field: {held_k1} "
        f"({card})")

    # -- (c) the configs; the parser on the card against the CPU ------------
    def corpus(name, folder, **kw):
        return {"name": name, "data_folder": str(folder), **kw}

    ud = corpus("UD", tmp / "ud", column_format={
        "1": "text", "6": "head", "7": "deprel", "8": "deps"},
        tag_to_bioes=None)
    common = {"tokenizer": {"type": "hash", "vocab_size": HASH_VOCAB},
              "train": {**RECIPE, "batch_size": PARSE_BATCH,
                        "max_epochs": 1}}
    configs = {
        "dependency": {"corpora": [ud], "data": {"n_buckets": 4},
                       "model": {"encoder": encoder, "arc_loss": "crf"}},
        "enhancedud": {"corpora": [ud], "data": {"dep_layer": "deps"},
                       "model": {"encoder": cut}},
        "ner_dp": {"corpora": [corpus(
            "EN", fused, column_format={"0": "text", "1": "ner"},
            comment_symbol="# id", tag_to_bioes="ner")],
            "model": {"encoder": cut}},
        "classification": {"corpora": [corpus("CLF", tmp / "clf",
                                              format="fasttext")],
                           "model": {"encoder": cut, "pooling": "rnn"}},
        "regression": {"corpora": [corpus("REG", tmp / "reg",
                                          format="fasttext")],
                       "model": {"encoder": cut}}}
    paths = {}
    for target, raw_cfg in configs.items():
        raw_cfg.update(common, name=f"parse-{target}", targets=target,
                       target_dir=str(tmp / f"parse-{target}"))
        paths[target] = tmp / f"parse-{target}.json"
        paths[target].write_text(json.dumps(raw_cfg))

    dep_cfg = ExperimentConfig.from_file(paths["dependency"])
    tokenizer = dep_cfg.make_tokenizer()
    rel_dict = pt.build_rel_dictionary(dep_cfg.load_corpus().train)
    t0 = time.perf_counter()
    held_parser = parser_against_cpu(dev, check_cfg, bank["test"], rel_dict,
                                     tokenizer)
    log(f"biaffine parser on the card against the CPU (float32, XLM-R "
        f"width {check_cfg.hidden_size}, {check_cfg.num_layers} layers, "
        f"vocab {check_cfg.vocab_size}, {len(rel_dict)} relations, "
        f"{N_CHECK_SENTENCES} treebank sentences): {held_parser}; "
        f"{time.perf_counter() - t0:.1f} s ({card})")

    # -- (d) cli train, test and parse of every target ---------------------
    train_step = pt._TaskTrainer.train_step
    mst_decode, fallback = pt.mst_decode, pt.single_root_eisner
    events, repairs, trees = [], [], []

    def timed_step(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = train_step(self, *args, **kwargs)
        end.record()
        events.append((start, end))
        return loss

    def counted_mst(s_arc, word_mask):
        repairs.append(s_arc.shape[0])
        return mst_decode(s_arc, word_mask)

    def counted_fallback(scores):
        trees.append(1)
        return fallback(scores)

    runs = {}
    pt._TaskTrainer.train_step = timed_step
    pt.mst_decode, pt.single_root_eisner = counted_mst, counted_fallback
    try:
        for target in cli.PARSER_TARGETS:
            events.clear()
            repairs.clear()
            trees.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            (result, printed), wall = timed(lambda: run_cli(
                cli, ["train", "--config", str(paths[target]), *device]))
            peak = torch.cuda.max_memory_allocated() / 1e9
            torch.cuda.synchronize()
            step_ms = [s.elapsed_time(e) for s, e in events]
            scores = json.loads(printed.strip().splitlines()[-1])
            run_dir = Path(configs[target]["target_dir"])
            history = json.loads((run_dir / "history.json").read_text())
            if (len(step_ms) < 3 or not np.isfinite(history[0]["loss"])
                    or not all(np.isfinite(v) for v in scores.values())):
                raise AssertionError(f"{target}: {len(step_ms)} steps, "
                                     f"history {history}, test {scores}")
            (_, printed), wall_test = timed(lambda: run_cli(
                cli, ["test", "--config", str(paths[target]), *device]))
            tested = json.loads(printed[printed.index("{"):])
            name = configs[target]["corpora"][0]["name"]
            if set(tested) != {name} or set(tested[name]) != set(scores):
                raise AssertionError(f"{target}: cli test printed {tested}")
            for k, v in scores.items():
                if abs(tested[name][k] - v) > 0.02 * max(1.0, abs(v)):
                    raise AssertionError(f"{target}: cli test {k} "
                                         f"{tested[name][k]} against cli "
                                         f"train's {v}")
            runs[target] = dict(wall=wall, wall_test=wall_test, peak=peak,
                                steps=step_ms, loss=history[0]["loss"],
                                dev={k: v for k, v in history[0].items()
                                     if k not in ("epoch", "loss")},
                                test=scores, repairs=sum(repairs),
                                trees=sum(trees))
            if target == "dependency":
                parse_dir = tmp / "parse-out"
                repairs.clear()
                trees.clear()
                _, wall_parse = timed(lambda: run_cli(cli, [
                    "parse", "--config", str(paths[target]), "--target_dir",
                    str(tmp / "ud" / "test.txt"), "--out_dir",
                    str(parse_dir), *device]))
                parsed = read_column_file(
                    parse_dir / "test.conllu",
                    {0: "text", 1: "head", 2: "deprel"})
                gold = [[r.split("\t")[1] for r in rows]
                        for rows in bank["test"]]
                if [r.tokens for r in parsed] != gold:
                    raise AssertionError("cli parse: the parsed sentences "
                                         "differ from the test split")
                bad = [i for i, r in enumerate(parsed)
                       if not is_tree(r.tags["head"])]
                if bad:
                    raise AssertionError(f"cli parse: sentences {bad[:10]} "
                                         "are not single-root trees")
                runs[target].update(wall_parse=wall_parse,
                                    parse_repairs=sum(repairs),
                                    parse_trees=sum(trees),
                                    n_parsed=len(parsed))
            drop_checkpoints(tmp)
    finally:
        pt._TaskTrainer.train_step = train_step
        pt.mst_decode, pt.single_root_eisner = mst_decode, fallback

    # -- (e) the tree CRF at a train batch's shape; a learning probe -----
    corpus_d, _, model, trainer = cli._build_parser(dep_cfg, dev)
    batches = trainer._encode(list(corpus_d.train), PARSE_BATCH,
                              seed=dep_cfg.make_train_config().seed)
    widest = max(batches, key=lambda b: b.word_mask.shape[1])
    crf = tree_crf_on_card(dev, widest.word_mask)
    opt = make_finetune_optimizer(model.named_parameters(),
                                  lr=RECIPE["learning_rate"], lr_rate=1.0,
                                  use_inverse_sqrt=True)
    arrays = trainer._to_device(widest)
    with torch.no_grad():
        before = float(model.loss(arrays))
    for _ in range(LEARN_STEPS):
        trainer.train_step(widest, opt, None)
    with torch.no_grad():
        after = float(model.loss(arrays))
    if not after < before:
        raise AssertionError(f"the tree parser's learning probe: loss "
                             f"{before:.5f} -> {after:.5f}")
    del corpus_d, model, trainer, opt, arrays
    torch.cuda.empty_cache()
    log(f"tree CRF at the widest train batch's shape (B={crf['B']}, grid "
        f"n={crf['n']}: {crf['n'] - 1} inside steps, a Python loop of "
        f"launches): loss forward and backward {crf['loss_ms']:.2f} ms, "
        f"marginals (decode) {crf['marg_ms']:.2f} ms per batch (CUDA "
        f"events, median of 5); marginals on the card against float64 on "
        f"the CPU max abs err {crf['err']:.2e} (atol 1e-4); learning probe "
        f"(XLM-R {encoder_label(encoder)}, tree CRF, {LEARN_STEPS} steps at "
        f"lr {RECIPE['learning_rate']} for every parameter on that batch, "
        f"dropout off): loss {before:.5f} -> {after:.5f} ({card})")

    for target in cli.PARSER_TARGETS:
        r = runs[target]
        enc = encoder if target == "dependency" else cut
        extra = ""
        if target == "dependency":
            extra = (f"; cli parse of the test split: {r['n_parsed']} "
                     f"sentences in {r['wall_parse']:.1f} s, every one a "
                     f"single-root tree; MST repairs {r['parse_repairs']}, "
                     f"of which the MST left {r['parse_trees']} without a "
                     f"single-root tree (single_root_eisner's then); cli "
                     f"train's evaluations {r['repairs']} and "
                     f"{r['trees']}")
        log(f"{target} (cli train, XLM-R {encoder_label(enc)}, float32 "
            f"masters, bf16 compute, batch {PARSE_BATCH}, 1 epoch of "
            f"{len(r['steps'])} steps): {r['wall']:.1f} s with the build, "
            f"evaluation and checkpoints, cli test {r['wall_test']:.1f} s; "
            f"{float(np.median(r['steps'][2:])):.1f} ms per train step (CUDA "
            f"events, median after the first two); loss {r['loss']:.4f}; dev "
            + ", ".join(f"{k} {v:.4f}" for k, v in r["dev"].items())
            + "; test " + ", ".join(f"{k} {v:.4f}"
                                    for k, v in r["test"].items())
            + f" (random weights){extra}; peak allocated {r['peak']:.2f} GB "
            f"({card})")
    log(f"phase 4m in {time.perf_counter() - t_phase:.1f} s")
    return {"k1_launches": got["bm25_score_block"]}


# phase 4n: the ACE stack's ELMo and BPEmb members at their published
# widths -- allennlp's elmo_2x4096_512_2048cnn_2xhighway_5.5B_options.json
# (the 5.5B ELMo that configs/multistage_ace_ensemble.yaml's reference
# config stacks) and flair's BytePairEmbeddings(language, dim=50,
# syllables=100000) -- from seeded weights; the pooled Flair table; MFVI
ELMO_55B = {"type": "elmo", "char_encoding": "elmo_bytes", "char_dim": 16,
            "n_highway": 2,
            "filters": [[1, 32], [2, 32], [3, 64], [4, 128], [5, 256],
                        [6, 512], [7, 1024]],
            "cell_dim": 4096, "proj_dim": 512, "num_layers": 2,
            "mode": "all"}
BPE_PIECES, BPE_DIM = 100_000, 50
ELMO_EPISODES = 1       # the published search runs 30
MFVI_BATCH, MFVI_RANK = 16, 64
ELMO_SEED = 15
# the pooled Flair table's card-against-CPU check over the dev split's 16
# sentences, not train's 48: the CPU's LMs take seconds a call, and the
# time pays for phase 4r
POOLED_SPLIT = "dev"
# the ELMo member's trained weights, float64 on the card against the CPU,
# within this share of the largest |feature| (hundreds of float64 ulps):
# their token layer reaches ~1e5 and cancels, so float32 strays from
# float64 by 0.03-0.2 there on either side; float64 on an H100 (700 W)
# read 3.3e-15 of it
ELMO_F64_REL = 1e-13


def bpemb_vectors(path, records, n_pieces: int, dim: int, seed: int) -> int:
    """A word2vec text file of ``n_pieces`` pieces of ``dim`` floats:
    ``<unk>`` (zeros), the pieces ``BPEVocab.build`` makes of ``records``
    (every character and every word), then seeded filler pieces; vectors
    normal(0, 0.1) from ``default_rng(seed)``. Returns the corpus's piece
    count."""
    import io

    from kbner_tpu_torch.models.embedders import BPEVocab

    pieces = [p for p in BPEVocab.build(records, dim=1, max_words=10 ** 7
                                        ).pieces if p != "<unk>"]
    n_corpus = len(pieces)
    if n_corpus >= n_pieces:
        raise ValueError(f"the corpus makes {n_corpus} pieces, the file "
                         f"holds {n_pieces}")
    pieces += [f"▁filler{i}" for i in range(n_pieces - 1 - n_corpus)]
    matrix = np.random.default_rng(seed).normal(
        0.0, 0.1, (len(pieces), dim)).astype(np.float32)
    buf = io.BytesIO()
    np.savetxt(buf, matrix, fmt="%.6f")
    rows = buf.getvalue().decode().splitlines()
    with open(path, "w", encoding="utf-8") as f:
        f.write(f"{n_pieces} {dim}\n<unk> {' '.join(['0'] * dim)}\n")
        f.writelines(f"{p} {r}\n" for p, r in zip(pieces, rows))
    return n_corpus


def elmo_module(spec, device):
    """The ELMo member ``spec`` describes (as ``cli._build_ace`` builds
    it, on allennlp's byte ids)."""
    from kbner_tpu_torch.data.encode import ELMO_CHAR_VOCAB
    from kbner_tpu_torch.models.embedders import ELMoEmbedder

    return ELMoEmbedder(
        ELMO_CHAR_VOCAB, spec["char_dim"],
        filters=[tuple(f) for f in spec["filters"]],
        n_highway=spec["n_highway"], proj_dim=spec["proj_dim"],
        num_layers=spec["num_layers"], mode=spec["mode"],
        cell_dim=spec["cell_dim"], conv_activation="relu",
        input_key="elmo_char_ids", device=device)


def elmo_stage_phase(cli, bm25, dev, card, tmp, encoder="large", elmo=None,
                     n_pieces=BPE_PIECES, mfvi_batch=MFVI_BATCH) -> dict:
    """Phase 4n, after 4m in its directory ``tmp`` (4j's fused ACE splits
    ``ace-conll``): (a) the seeded inputs: a BPEmb word2vec text file of
    ``n_pieces`` x 50 and the ELMo member's float32 weights at ``elmo``'s
    widths (the 5.5B ELMo's by default) through ``save_npz``; (b) ``cli
    train`` with ``trainer: ReinforcementTrainer`` over 4j's stack plus
    both members (ELMo spliced through ``load_npz``), ``ELMO_EPISODES``
    episode of ``ACE_EPOCHS`` epoch and the final training, each timed;
    one optimizer step split by member with CUDA events (ELMo's char CNN
    and its bi-LM apart, BPEmb), and one step under the profiler; (c)
    ``cli test`` on the result: its ``test.ACE.tsv`` byte-equal to the
    one ``cli train`` wrote; (d) the ELMo member's features for
    ``N_FEATURE_CHECK`` sentences on the card against the CPU: the seeded
    weights in float32 at ``FEATURE_RTOL``/``ATOL``, the run's trained
    weights in float64 within ``ELMO_F64_REL`` of the largest feature, and
    each float32 side's error per output layer against float64; (e)
    ``build_pooled_flair_table`` over the ``POOLED_SPLIT`` split with the
    run's Flair member: mean, min and max on the card, the mean held to
    the CPU's; (f) ``MFVIHead``
    (second and third order, rank ``MFVI_RANK``, parameters normal with
    variance 1/fan-in so that pair and triple messages weigh) over
    ``encoder``'s word features at B=``mfvi_batch``: loss forward and
    backward and decode, card against CPU in float32. No kernel lies on this path: the phase
    launches none (the corpus was fused through K1 in 4j)."""
    import torch

    from kbner_tpu_torch import checkpoint, weights
    from kbner_tpu_torch.config import ExperimentConfig
    from kbner_tpu_torch.data.conll import read_column_file
    from kbner_tpu_torch.data.encode import (add_classic_features,
                                             build_char_vocab, make_batches)
    from kbner_tpu_torch.models.embedders import (FlairLMEmbedder,
                                                  TransformerWordEmbedder,
                                                  build_pooled_flair_table)
    from kbner_tpu_torch.ops.mfvi import MFVIHead

    elmo_spec = dict(elmo or ELMO_55B)
    device = ["--device", str(dev)]
    t_phase = time.perf_counter()
    reset_counts(bm25)
    # all of 4j's splits: a train split of one batch would take only the
    # schedule's first step, whose learning rate is 0
    fused = tmp / "ace-conll"
    recs = {s: read_column_file(fused / f"{s}.txt", {0: "text", 1: "ner"},
                                comment_symbol="# id")
            for s in ("train", "dev", "test")}

    # -- (a) the seeded inputs ------------------------------------------------
    vec = tmp / "bpemb.w2v.txt"
    (n_corpus, ), wall_vec = timed(lambda: (bpemb_vectors(
        vec, [r for v in recs.values() for r in v], n_pieces, BPE_DIM,
        ELMO_SEED), ))
    wfile = tmp / "elmo-weights.npz"
    module = elmo_module(elmo_spec, dev)
    module.reset_parameters(torch.Generator(device=dev).manual_seed(ELMO_SEED))
    n_params = sum(p.numel() for p in module.parameters())
    n_lstm = sum(p.numel() for n, p in module.named_parameters()
                 if n.startswith(("fwd", "bwd")))
    _, wall_npz = timed(lambda: module.save_npz(wfile))
    del module
    log(f"ELMo/BPEmb inputs: BPEmb word2vec text of {n_pieces:,} pieces x "
        f"{BPE_DIM} ({n_corpus:,} from the corpus, the rest seeded filler; "
        f"{vec.stat().st_size / 1e6:.1f} MB in {wall_vec:.1f} s); the ELMo "
        f"member (cell {elmo_spec['cell_dim']}, projection "
        f"{elmo_spec['proj_dim']}, {sum(c for _, c in elmo_spec['filters'])}"
        f" filters, {elmo_spec['n_highway']} highways, 261 byte ids): "
        f"{n_params:,} float32 parameters ({n_lstm:,} in the LSTMs), "
        f"seeded, through save_npz: {wfile.stat().st_size / 1e6:.1f} MB in "
        f"{wall_npz:.1f} s ({time.perf_counter() - t_phase:.1f} s into 4n)")

    # -- (b) cli train with the ACE trainer -----------------------------------
    run = tmp / "elmo-ace"
    cfg = tmp / "elmo-ace.json"
    stack = ACE_STACK + [dict(elmo_spec, weights=str(wfile)),
                         {"type": "bpemb", "dim": BPE_DIM,
                          "vectors": str(vec)}]
    cfg.write_text(json.dumps({
        "name": "en-ace-elmo-bpemb",
        "corpora": [{"name": "ACE", "data_folder": str(fused),
                     "column_format": {"0": "text", "1": "ner"},
                     "comment_symbol": "# id", "tag_to_bioes": "ner"}],
        "tag_layer": "ner",
        "tokenizer": {"type": "hash", "vocab_size": HASH_VOCAB},
        "model": {"encoder": encoder, "remat": True,
                  "remat_policy": "dots_saveable", "use_crf": True,
                  "embeddings": stack},
        "ace": {"episodes": ELMO_EPISODES, "controller_lr": 0.1,
                "reward_kind": "plain"},
        "train": {"learning_rate": 0.1, "lr_rate": 1.0, "batch_size": 32,
                  "max_epochs": ACE_EPOCHS},
        "trainer": "ReinforcementTrainer", "target_dir": str(run)}))
    result, wall, train_s, (trainer, specs), peak_gb = run_ace_train(
        cli, cfg, device)
    history = result["history"]
    tested = json.loads((run / "test_results.json").read_text())["ACE"]
    losses = result["final"]["history"]["train_loss"]
    if (len(history) != ELMO_EPISODES or len(train_s) != ELMO_EPISODES + 1
            or not all(0.0 <= h["f1"] <= 1.0 for h in history)
            or not np.isfinite(losses).all()
            or not 0.0 <= tested["micro_f1"] <= 1.0):
        raise AssertionError(f"cli train (ACE, ELMo, BPEmb): history "
                             f"{history}, {len(train_s)} trainings, final "
                             f"losses {losses}, test {tested}")
    log(f"cli train, trainer: ReinforcementTrainer (4j's stack + ELMo "
        f"(cell {elmo_spec['cell_dim']}, projection {elmo_spec['proj_dim']}; "
        f"npz) + BPEmb {BPE_DIM} x {n_pieces:,}, CRF, batch 32; "
        f"cuts: {ELMO_EPISODES} episode of {ACE_EPOCHS} epoch, "
        f"{'/'.join(str(len(v)) for v in recs.values())} train/dev/test "
        f"sentences of 4j's, XLM-R "
        f"{encoder_label(encoder)}): {wall:.1f} s in all; "
        + "; ".join(f"episode {h['episode']} mask {h['mask']} dev F1 "
                    f"{h['f1']:.4f} in {s:.1f} s"
                    for h, s in zip(history, train_s))
        + f"; final training {train_s[-1]:.1f} s, losses "
        f"{', '.join(f'{v:.4f}' for v in losses)}; test micro F1 "
        f"{tested['micro_f1']:.4f}; peak allocated {peak_gb:.2f} GB ({card})")

    # one optimizer step of the run's largest train batch, split by member,
    # on the trained tagger that cli train built
    config = ExperimentConfig.from_file(cfg)
    trainer.selection = np.ones(len(specs), np.float32)
    train_config = config.make_train_config()
    batch = max(trainer._make_train_batches(trainer.corpus.train,
                                            train_config, 0),
                key=lambda eb: eb.input_ids.shape[0])
    arrays = trainer._to_device(batch)
    members = trainer.model.stack.members
    elmo_m, bpemb = members[4], members[5]
    tok = elmo_m.tokens(arrays).detach().requires_grad_()

    def fwd_bwd(fn):
        def step():
            fn().float().sum().backward()
            trainer.model.zero_grad(set_to_none=True)
        return step

    opt = trainer.make_optimizer(train_config)
    rng = torch.Generator().manual_seed(1)
    # cli train ran every part in this process: no warm-up but the step's
    parts = {
        "ELMo char CNN + highways + projection forward + backward": fwd_bwd(
            lambda: elmo_m.tokens(arrays)),
        "ELMo bi-LM (4 LSTMP stacks) forward + backward": fwd_bwd(
            lambda: elmo_m.contextual(tok, arrays["word_mask"])),
        "BPEmb forward + backward": fwd_bwd(lambda: bpemb(arrays)),
        "whole step (train_step)": lambda: trainer.train_step(
            batch, opt, train_config, rng)}
    parts["whole step (train_step)"]()  # the optimizer's state
    split = {name: event_ms(fn) for name, fn in parts.items()}
    torch.cuda.reset_peak_memory_stats()
    wall_ms, dev_ms, top = profile_step(trainer, batch, train_config,
                                        torch.cuda.synchronize)
    step_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    B, S = batch.input_ids.shape
    W = batch.word_mask.shape[1]
    busy = ("not measured (the trace holds no device kernels)"
            if dev_ms is None else
            f"{dev_ms:.1f} ms of device kernels in {wall_ms:.1f} ms under "
            f"torch.profiler, idle {max(0.0, 1 - dev_ms / wall_ms):.1%}; "
            "largest: " + "; ".join(f"{n[:60]} {ms:.1f} ms x{c}"
                                    for n, ms, c in top))
    log(f"ACE + ELMo + BPEmb optimizer step (B={B}, S={S} subtokens, W={W} "
        f"words, T={arrays['char_stream'].shape[1]} stream characters, "
        f"ELMo window {tuple(arrays['elmo_char_ids'].shape)}), ms by CUDA "
        f"events: " + ", ".join(f"{k} {v:.1f}" for k, v in split.items())
        + f"; peak allocated in a step {step_peak_gb:.2f} GB; one step "
        f"under the profiler: {busy} ({card}; {time.perf_counter() - t_phase:.1f}"
        f" s into 4n)")
    del trainer, specs, opt, arrays, members, elmo_m, bpemb, tok
    torch.cuda.empty_cache()

    # -- (c) cli test on the result -------------------------------------------
    # the tags per word that cli train's final test wrote: cli test rewrites
    # the file, and a wrong checkpoint or selection changes the tags even
    # where both score 0
    tsv = run / "test.ACE.tsv"
    trained_tsv = tsv.read_bytes()
    (_, printed), wall_test = timed(lambda: run_cli(
        cli, ["test", "--config", str(cfg), *device]))
    again = json.loads(printed[printed.index("{"):])["ACE"]
    if tsv.read_bytes() != trained_tsv or again != tested:
        raise AssertionError(f"cli test: {again} and test.ACE.tsv against "
                             f"cli train's {tested}")
    log(f"cli test on the result in {wall_test:.1f} s (the stack under the "
        f"best action {result['best_action']}): {again}, test.ACE.tsv "
        f"({len(trained_tsv):,} bytes) byte-equal to cli train's ({card}; "
        f"{time.perf_counter() - t_phase:.1f} s into 4n)")

    # -- (d) the ELMo member on the card against the CPU ----------------------
    tree = checkpoint.load(run / "best-model.msgpack")["params"]["stack"]
    eb = make_batches(recs["train"][:N_FEATURE_CHECK],
                      config.make_tokenizer(), None, N_FEATURE_CHECK)[0]
    add_classic_features(eb, elmo_bytes=True)
    loads = {"seeded": lambda m: m.load_npz(wfile),
             "trained": lambda m: m.load_state_dict(
                 weights.member_from_jax_params(tree["members_4"], m))}
    # (weights, side, dtype, cuDNN on): cuDNN off on the card tells the
    # char CNN's convolutions from the matmuls in the card's float32 error
    runs = [("seeded", "cpu", torch.float64, True),
            ("seeded", "cpu", torch.float32, True),
            ("seeded", dev, torch.float32, True),
            ("seeded", dev, torch.float32, False),
            ("trained", "cpu", torch.float64, True),
            ("trained", dev, torch.float64, True),
            ("trained", "cpu", torch.float32, True),
            ("trained", dev, torch.float32, True)]
    feats, cudnn_was = {}, torch.backends.cudnn.enabled
    for label, where, dtype, cudnn in runs:
        m = elmo_module(elmo_spec, where)
        loads[label](m)
        # the flag alone: cudnn.flags() would also reset allow_tf32 to True
        torch.backends.cudnn.enabled = cudnn
        try:
            with torch.no_grad():
                feats[label, str(where), dtype, cudnn] = m.to(dtype)({
                    k: torch.from_numpy(v).to(where)
                    for k, v in eb.arrays().items()}).double().cpu()
        finally:
            torch.backends.cudnn.enabled = cudnn_was
        del m
    # the seeded weights: float32 on both sides within the features'
    # tolerance. Under the trained ones (AdamW steps at 4j's lr 0.1 move
    # every weight by ~0.1) float32 on either side strays from float64 in
    # the token layer, so the card is held to the CPU there in float64
    seed32 = {w: feats["seeded", w, torch.float32, True]
              for w in ("cpu", str(dev))}
    torch.testing.assert_close(seed32[str(dev)], seed32["cpu"],
                               rtol=FEATURE_RTOL, atol=FEATURE_ATOL)
    f64_atol = ELMO_F64_REL * float(
        feats["trained", "cpu", torch.float64, True].abs().max())
    torch.testing.assert_close(feats["trained", str(dev), torch.float64, True],
                               feats["trained", "cpu", torch.float64, True],
                               rtol=0.0, atol=f64_atol)
    elmo_err = float((seed32[str(dev)] - seed32["cpu"]).abs().max())
    f64_err = float((feats["trained", str(dev), torch.float64, True]
                     - feats["trained", "cpu", torch.float64, True]
                     ).abs().max())
    per_layer = elmo_spec["proj_dim"] * 2

    def per_layer_max(x):
        return "/".join(f"{float(x[..., i:i + per_layer].abs().max()):.3g}"
                        for i in range(0, x.shape[-1], per_layer))

    def layer_errs(key):
        """max abs err against float64 on the CPU, per output layer."""
        return per_layer_max(feats[key]
                             - feats[key[0], "cpu", torch.float64, True])

    log(f"the ELMo member on the card against the CPU ({N_FEATURE_CHECK} "
        f"train sentence(s), {tuple(seed32['cpu'].shape)}): the seeded "
        f"weights (load_npz), float32, card against CPU max abs err "
        f"{elmo_err:.3g} "
        f"(rtol {FEATURE_RTOL}, atol {FEATURE_ATOL}); the run's trained "
        f"weights (best-model.msgpack), float64, card against CPU "
        f"{f64_err:.3g} (atol {ELMO_F64_REL} x the largest |feature|, "
        f"{f64_atol:.3g}); float32 against float64 per"
        f" output layer (token/bi-LM 1/bi-LM 2): seeded CPU "
        f"{layer_errs(('seeded', 'cpu', torch.float32, True))}, card "
        f"{layer_errs(('seeded', str(dev), torch.float32, True))}, card "
        f"without cuDNN "
        f"{layer_errs(('seeded', str(dev), torch.float32, False))}; trained"
        f" CPU {layer_errs(('trained', 'cpu', torch.float32, True))}, card "
        f"{layer_errs(('trained', str(dev), torch.float32, True))}; max "
        f"|feature| per layer, float64: seeded "
        f"{per_layer_max(feats['seeded', 'cpu', torch.float64, True])}, "
        f"trained "
        f"{per_layer_max(feats['trained', 'cpu', torch.float64, True])} "
        f"({card}; "
        f"{time.perf_counter() - t_phase:.1f} s into 4n)")
    del feats, seed32

    # -- (e) the pooled Flair table, card against CPU -------------------------
    flair_spec = ACE_STACK[3]
    char_vocab = build_char_vocab(recs["train"])
    pooled = {}
    # every pooling on the card, the mean on the CPU too (the three pool
    # the same features; the CPU's LMs take seconds a call)
    for side, where, poolings in (("card", dev, ("mean", "min", "max")),
                                  ("cpu", "cpu", ("mean",))):
        m = FlairLMEmbedder(len(char_vocab), flair_spec["embed_dim"],
                            flair_spec["hidden"], device=where)
        m.load_state_dict(weights.member_from_jax_params(tree["members_3"],
                                                         m))
        for pooling in poolings:
            (vocab, table), sec = timed(lambda: build_pooled_flair_table(
                m, recs[POOLED_SPLIT], config.make_tokenizer(), char_vocab,
                pooling=pooling))
            pooled[pooling, side] = (table, sec)
        del m
    del tree
    (cpu_t, cpu_s), (dev_t, dev_s) = pooled["mean", "cpu"], pooled[
        "mean", "card"]
    np.testing.assert_allclose(dev_t, cpu_t, rtol=FEATURE_RTOL,
                               atol=FEATURE_ATOL)
    lo, hi = pooled["min", "card"][0], pooled["max", "card"][0]
    if not ((lo <= dev_t + 1e-6).all() and (dev_t <= hi + 1e-6).all()):
        raise AssertionError("pooled Flair tables: min <= mean <= max fails")
    pool_err = float(np.abs(dev_t - cpu_t).max())
    log(f"build_pooled_flair_table over the {POOLED_SPLIT} split "
        f"({len(vocab):,} "
        f"words x {dev_t.shape[1]}, the run's Flair member): mean on the "
        f"card against the CPU max abs err {pool_err:.3g} (rtol "
        f"{FEATURE_RTOL}, atol {FEATURE_ATOL}), min <= mean <= max; "
        + ", ".join(f"{k} {pooled[k, 'card'][1]:.2f} s on the card"
                    for k in ("mean", "min", "max"))
        + f", mean {cpu_s:.2f} s on the CPU ({card}; "
        f"{time.perf_counter() - t_phase:.1f} s into 4n)")

    # -- (f) MFVI over XLM-R word features, card against CPU ------------------
    f32 = config.make_encoder_config(config.make_tokenizer(),
                                     dtype=torch.float32,
                                     param_dtype=torch.float32)
    xlmr = TransformerWordEmbedder(f32, device=dev)
    xlmr.reset_parameters(torch.Generator(device=dev).manual_seed(ELMO_SEED))
    corpus = config.load_corpus()  # the tags in BIOES, as trained
    tag_dict = corpus.make_tag_dictionary("ner")
    eb = make_batches(corpus.train[:mfvi_batch], config.make_tokenizer(),
                      tag_dict, mfvi_batch, tag_layer="ner")[0]
    arr = {k: torch.from_numpy(v).to(dev) for k, v in eb.arrays().items()}
    with torch.no_grad():
        word_feats = xlmr(arr).float()
    del xlmr
    H, K = word_feats.shape[-1], len(tag_dict)
    # seeded emissions from the features: unary = feats @ emit
    emit = torch.randn(H, K, generator=torch.Generator().manual_seed(
        ELMO_SEED)) * H ** -0.5
    mfvi_out = []
    for third in (False, True):
        got = {}
        for side, where in (("cpu", "cpu"), ("card", dev)):
            head = MFVIHead(H, K, rank=MFVI_RANK, use_third_order=third,
                            device=where, seed=ELMO_SEED)
            if side == "card":
                head.load_state_dict(got["cpu"]["state"])
            else:  # unit-scale factors, so that the messages matter
                gen = torch.Generator().manual_seed(ELMO_SEED)
                with torch.no_grad():
                    for prm in head.parameters():
                        prm.copy_(torch.randn(prm.shape, generator=gen)
                                  * prm.shape[-1] ** -0.5)
            f_in = word_feats.to(where).clone().requires_grad_()
            unary = (f_in.detach() @ emit.to(where)).requires_grad_()
            args = (arr["tag_ids"].to(where), arr["word_mask"].to(where))
            loss = head.loss(f_in, unary, *args)
            loss.backward()
            with torch.no_grad():
                tags = head.decode(f_in, unary, args[1])
            got[side] = dict(
                state={k: v.detach().cpu().clone()
                       for k, v in head.state_dict().items()},
                loss=loss.detach().cpu(), tags=tags.cpu(),
                grads={n: p.grad.detach().cpu().clone()
                       for n, p in head.named_parameters()},
                f_grad=f_in.grad.cpu().clone(),
                u_grad=unary.grad.cpu().clone())
            if side == "card":  # the timed call after the checked one
                got[side]["ms"] = event_ms(
                    lambda: head.loss(f_in, unary, *args).backward())
            del head, f_in, unary
        c, d = got["cpu"], got["card"]
        errs = {"loss": float((d["loss"] - c["loss"]).abs())}
        torch.testing.assert_close(d["loss"], c["loss"], rtol=FEATURE_RTOL,
                                   atol=FEATURE_ATOL)
        for name in c["grads"]:
            torch.testing.assert_close(d["grads"][name], c["grads"][name],
                                       rtol=FEATURE_RTOL, atol=FEATURE_ATOL)
        for key in ("f_grad", "u_grad"):
            torch.testing.assert_close(d[key], c[key], rtol=FEATURE_RTOL,
                                       atol=FEATURE_ATOL)
        errs["grads"] = max(float((d["grads"][n] - c["grads"][n]).abs().max())
                            for n in c["grads"])
        n_diff = int((d["tags"] != c["tags"]).sum())
        if n_diff:
            raise AssertionError(f"MFVI decode: {n_diff} tags differ")
        mfvi_out.append(
            f"{'third' if third else 'second'} order: loss {float(c['loss']):.5f}"
            f" (abs err {errs['loss']:.2e}), parameter gradients max abs err "
            f"{errs['grads']:.2e}, decode equal ({c['tags'].numel()} tags), "
            f"loss forward + backward {d['ms']:.2f} ms on the card")
    log(f"MFVIHead (rank {MFVI_RANK}, 3 iterations) over XLM-R "
        f"{encoder_label(encoder)} word features (float32, seeded weights, "
        f"B={tuple(word_feats.shape)[0]}, W={tuple(word_feats.shape)[1]}, "
        f"K={K}), card against CPU (rtol {FEATURE_RTOL}, atol "
        f"{FEATURE_ATOL}): " + "; ".join(mfvi_out) + f" ({card})")
    del word_feats, emit, arr
    torch.cuda.empty_cache()
    expect_counts("phase 4n", counts(bm25), {})
    for f in (wfile, vec):
        f.unlink()
    log(f"phase 4n in {time.perf_counter() - t_phase:.1f} s")
    return {"elmo_err": elmo_err, "pool_err": pool_err}


# phase 4o: the sharded retrieval engines in a world of gloo ranks on the
# one card (NCCL refuses two ranks on one GPU), and the pass-1
# approximate top-C
SHARDS = 2              # data shards, one gloo rank each, all on cuda:0
SHARD_TIMEOUT_S = 300   # the gloo group's timeout, and the world's deadline
MERGE_ITERS = 20        # merges timed per rank (each one all-gather)
TOPC_C = 64             # a top-C that XLA's formula reduces at P ~ 6,656
TOPC_RECALL = 0.95


def _sharded_rank_run(rank: int, world: int, tmp,
                      device_type: str = "cuda") -> dict:
    """Phase 4o, one rank: 4h's saved KB ``kb1m`` opened with ``load_kb``,
    a meshed exhaustive and a meshed pruned engine (4a's pruned knobs,
    the title field) over shard ``rank`` of ``world``, each serving the
    two batches of ``sharded-inputs.npz`` (batch 0 plain, batch 1 with
    entity clauses); then K1 at its shard's shape and K2 on its shard's
    rows held to their plain versions, and the merge timed alone. Returns
    the arrays the parent holds. (``device_type="cpu"`` rehearses it in
    one process on the CPU, with the CUDA calls stubbed.)"""
    import torch
    import torch.distributed as dist

    from kbner_tpu_torch.ops import bm25
    from kbner_tpu_torch.parallel import make_mesh
    from kbner_tpu_torch.retrieval.engine import (RetrievalEngine,
                                                  merge_shard_topk)
    from kbner_tpu_torch.retrieval.pipeline import load_kb

    mesh = make_mesh(data=world, model=1, device_type=device_type)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    torch.cuda.reset_peak_memory_stats(dev)
    (text, store, title, _), load_s = timed(lambda: load_kb(tmp / "kb1m"))
    ex, ex_s = timed(lambda: RetrievalEngine(
        text, store=store, title_index=title, mesh=mesh, device=dev))
    pr, pr_s = timed(lambda: RetrievalEngine(
        text, store=store, title_index=title, mesh=mesh, device=dev,
        mode="pruned", **PRUNED_KNOBS))
    torch.cuda.synchronize(dev)
    z = np.load(tmp / "sharded-inputs.npz")
    blocks = [(z["qt0"], z["qw0"], None, None),
              (z["qt1"], z["qw1"], z["tt1"], z["tw1"])]
    out = {"shard": [ex.n_shards, ex.shard, ex.shard_size, ex.n_padded],
           "seconds": [load_s, ex_s, pr_s],
           "backend": dist.get_backend(ex._group)}
    # the batches twice: the first pass pays each CUDA module's first load
    # in this process (cold), the second is timed warm and counted
    for label, eng in (("ex", ex), ("pr", pr)):
        for run in ("cold", "warm"):
            reset_counts(bm25)
            for b, (qt, qw, tt, tw) in enumerate(blocks):
                t0 = time.perf_counter()
                s_b, i_b = eng.search_encoded(qt, qw, k=K, title_terms=tt,
                                              title_weights=tw)
                out[f"{label}/{b}/{run}_ms"] = (time.perf_counter()
                                                - t0) * 1e3
                out[f"{label}/{b}/s"], out[f"{label}/{b}/i"] = s_b, i_b
        out[f"{label}/launches"] = [counts(bm25)[w] for w in WRAPPERS]
    # K1 at the shard's [Ld, N / S] shape, K2 on the shard's rows
    qt = torch.from_numpy(z["qt0"]).to(dev)
    qw = torch.from_numpy(z["qw0"]).to(dev)
    dt, di = ex.fields["text"]
    got = bm25.bm25_score_block(qt, qw, dt, di)
    want = bm25.bm25_score_block_ref(qt, qw, dt, di)
    torch.cuda.synchronize(dev)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert_same_topk(got, want, K)
    out["k1"] = [float((got - want).abs().max()),
                 time_cuda_ms(lambda: bm25.bm25_score_block(qt, qw, dt, di),
                              iters=20), dt.shape[0], dt.shape[1]]
    del got, want
    keys, fields, _, kw = pr._device_queries(pr._pack_queries(z["qt0"],
                                                              z["qw0"]))
    _, _, ops = bm25.pass2_operands(keys, fields, **kw)
    fn, args = ops[0]
    if fn is not bm25.delta16_rescore:
        raise AssertionError(f"the shard's text pass 2 is {fn.__name__}")
    got = fn(*args)
    want = bm25.delta16_rescore_ref(*args)
    torch.cuda.synchronize(dev)
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    out["k2"] = [float((got - want).abs().max()),
                 time_cuda_ms(lambda: fn(*args), iters=20),
                 args[2].shape[1], args[3].shape[0], args[-1]]
    # the merge alone: one all-gather of [Q, 2k] and the top k
    s_m = torch.from_numpy(out["ex/0/s"]).to(dev)
    i_m = torch.from_numpy(out["ex/0/i"]).to(dev)
    merge_shard_topk(s_m, i_m, K, ex._group)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(MERGE_ITERS):
        merge_shard_topk(s_m, i_m, K, ex._group)
    torch.cuda.synchronize(dev)
    out["merge_ms"] = (time.perf_counter() - t0) * 1e3 / MERGE_ITERS
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out


def world_rank(rank: int, world: int, tmp: str, out_dir: str, run,
               timeout_s: float) -> None:
    """A spawned rank of phases 4o and 4p: joins the gloo world through a
    file under ``out_dir``, runs ``run(rank, world, tmp)`` and writes its
    result (or its traceback) there."""
    import datetime
    import pickle
    import traceback
    from pathlib import Path

    import torch.distributed as dist

    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{Path(out_dir) / 'init'}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = run(rank, world, Path(tmp))
        (Path(out_dir) / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    except BaseException:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(run, tmp, world: int, label: str, timeout_s: float) -> list:
    """Run ``run`` in ``world`` spawned gloo ranks (:func:`world_rank`,
    under ``tmp/<label>-world``) and return each rank's result; ranks
    still alive at the deadline are terminated and the phase fails, as
    it does when a rank fails."""
    import pickle

    import torch.multiprocessing as mp

    out_dir = tmp / f"{label}-world"
    out_dir.mkdir()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=world_rank, args=(
        r, world, str(tmp), str(out_dir), run, timeout_s))
        for r in range(world)]
    start = time.monotonic()
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(max(timeout_s - (time.monotonic() - start), 1.0))
    stuck = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
    errors = [(out_dir / f"rank{r}.err").read_text() for r in range(world)
              if (out_dir / f"rank{r}.err").exists()]
    if stuck or errors or any(proc.exitcode for proc in procs):
        raise AssertionError(
            f"phase {label}: ranks {stuck} outlived {timeout_s} s; exit "
            f"codes {[proc.exitcode for proc in procs]}\n"
            + "\n".join(errors))
    return [pickle.loads((out_dir / f"rank{r}.pkl").read_bytes())
            for r in range(world)]


def sharded_stage_phase(bm25, dev, card, tmp, index, encoded, ent_blocks,
                        exact, boosted, pruned_out, boost_ms) -> dict:
    """Phase 4o, after 4n in its directory ``tmp`` (4h's saved KB
    ``kb1m``, written from 4a's index and title index): a world of
    :data:`SHARDS` gloo ranks on the card, each with its shard of a meshed
    exhaustive and a meshed pruned engine (:func:`_sharded_rank_run`),
    serves 4a's batch 0 and batch 1 with its entity clauses; every rank's
    merged top-10 is held to 4a's unsharded exhaustive results (``exact``,
    ``boosted``: ids within ties, scores at the kernels' tolerance) and
    the pruned one's recall@10 to the bar against them, with its recall
    against 4a's unsharded pruned results printed. Then the pass-1
    approximate top-C on an unsharded pruned engine over 4a's index at C =
    :data:`TOPC_C`: its recall@10 against the same knobs with the exact
    top-C, both engines' against exhaustive, and ``approx_max_k``'s
    device time against ``_top_sorted``'s at that P. Returns the per-rank
    launches and errors."""
    import torch

    from kbner_tpu_torch.retrieval.engine import RetrievalEngine

    t_phase = time.perf_counter()
    (qt0, qw0), (qt1, qw1) = encoded[:2]
    tt1, tw1 = ent_blocks[1]
    np.savez(tmp / "sharded-inputs.npz", qt0=qt0, qw0=qw0, qt1=qt1, qw1=qw1,
             tt1=tt1, tw1=tw1)
    ranks, world_s = timed(lambda: spawn_world(
        _sharded_rank_run, tmp, SHARDS, "4o", SHARD_TIMEOUT_S))
    r0 = ranks[0]
    for r, got in enumerate(ranks):
        for key in (f"{e}/{b}/{x}" for e in ("ex", "pr") for b in (0, 1)
                    for x in ("s", "i")):
            if not np.array_equal(got[key], r0[key]):
                raise AssertionError(f"phase 4o: rank {r}'s {key} differs "
                                     "from rank 0's")
        ex_l, pr_l = list(got["ex/launches"]), list(got["pr/launches"])
        if ex_l != [3, 0, 0] or pr_l != [0, 2, 0]:
            raise AssertionError(
                f"phase 4o: rank {r} launched {ex_l} (exhaustive) and "
                f"{pr_l} (pruned) of {list(WRAPPERS)}; expected K1 once a "
                "field and batch, K2 once a batch")
    sharded_ex = [(r0["ex/0/s"], r0["ex/0/i"]), (r0["ex/1/s"], r0["ex/1/i"])]
    sharded_pr = [(r0["pr/0/s"], r0["pr/0/i"]), (r0["pr/1/s"], r0["pr/1/i"])]
    unsharded_ex = [exact[0], boosted["exhaustive"][1]]
    assert_same_results("phase 4o: sharded exhaustive against 4a's "
                        "unsharded", unsharded_ex, sharded_ex)
    recall = recall_at_k(unsharded_ex, sharded_pr)
    if recall < MIN_RECALL:
        raise AssertionError(f"phase 4o: sharded pruned recall@{K} "
                             f"{recall:.4f}, bar {MIN_RECALL}")
    vs_pruned = recall_at_k([pruned_out[0], boosted["pruned"][1]],
                            sharded_pr)
    geo = [list(map(int, r["shard"])) for r in ranks]
    log(f"phase 4o: a world of {len(ranks)} gloo ranks on the one card "
        f"(backend {r0['backend']}; the merge all-gathers its CUDA "
        f"tensors, which gloo stages through host memory), "
        f"spawned, built and served in {world_s:.1f} s (host clock); "
        f"shards (S, s, ss, N padded) {geo}; per rank load_kb, exhaustive "
        f"and pruned builds "
        + "; ".join(", ".join(f"{x:.1f}" for x in r["seconds"])
                    for r in ranks)
        + f" s; every rank returned the same merged top-{K}; sharded "
        f"exhaustive equals 4a's unsharded (batch 0 plain, batch 1 with "
        f"entities) within ties at rtol {RTOL}, atol {ATOL}; sharded pruned "
        f"recall@{K} {recall:.4f} against exhaustive (bar {MIN_RECALL}), "
        f"{vs_pruned:.4f} against 4a's unsharded pruned ({card})")
    def per_batch(label, run):
        return "; ".join(f"{float(r[f'{label}/0/{run}_ms']):.2f}, "
                         f"{float(r[f'{label}/1/{run}_ms']):.2f}"
                         for r in ranks)

    log("phase 4o ms per batch (host clock, search_encoded with its "
        "all-gather and copies; batch 0 plain, batch 1 with entities), per "
        f"rank, warm: exhaustive {per_batch('ex', 'warm')}, pruned "
        f"{per_batch('pr', 'warm')}; the first pass (each CUDA module's "
        f"first load in the rank): exhaustive {per_batch('ex', 'cold')}, "
        f"pruned {per_batch('pr', 'cold')}"
        + f"; unsharded (4e, batch 1 with entities): exhaustive "
        f"{boost_ms['exhaustive'][1]:.2f}, pruned {boost_ms['pruned'][1]:.2f}"
        f"; the merge alone (one all-gather of [{qt0.shape[0]}, {2 * K}] "
        f"int64 and the top {K}, {MERGE_ITERS} calls) "
        + ", ".join(f"{float(r['merge_ms']):.3f}" for r in ranks)
        + " ms; peak allocated per rank "
        + ", ".join(f"{float(r['peak_gb']):.2f}" for r in ranks)
        + f" GB ({card})")
    log("phase 4o kernels per rank: bm25_score_block at the shard's "
        + "; ".join(f"[Ld={int(r['k1'][2])}, N={int(r['k1'][3])}] max abs "
                    f"err {r['k1'][0]:.3g}, {r['k1'][1]:.4f} ms eager"
                    for r in ranks)
        + "; delta16_rescore on the shard's rows "
        + "; ".join(f"C={int(r['k2'][2])}, NR={int(r['k2'][3])}, "
                    f"R2={int(r['k2'][4])}: max abs err {r['k2'][0]:.3g}, "
                    f"{r['k2'][1]:.4f} ms eager" for r in ranks)
        + f"; each held to its plain version (rtol {RTOL}, atol {ATOL}) "
        f"({card})")

    # -- the pass-1 approximate top-C ------------------------------------
    t0 = time.perf_counter()
    topc = RetrievalEngine(index, mode="pruned", device=dev,
                           **dict(PRUNED_KNOBS, n_candidates=TOPC_C))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    outs = {}
    for r in (0.0, TOPC_RECALL):
        topc.topc_recall = r  # read at each search
        outs[r] = [topc.search_encoded(qt, qw, k=K) for qt, qw in encoded]
    keys, _, _, kw = topc._device_queries(topc._pack_queries(*encoded[0]))
    P = keys.shape[1]
    reduced, log2 = bm25.approx_topk_reduction_size(P, TOPC_C, TOPC_RECALL)
    if log2 == 0:
        raise AssertionError(f"phase 4o: XLA's formula does not reduce at "
                             f"P={P}, C={TOPC_C}")
    kept = recall_at_k(outs[0.0], outs[TOPC_RECALL])
    if kept < TOPC_RECALL:
        raise AssertionError(f"phase 4o: topc_recall={TOPC_RECALL} keeps "
                             f"recall@{K} {kept:.4f} of the exact top-C")
    srt = torch.sort(keys, dim=1).values
    valid = srt != bm25.KEY_PAD
    partial = bm25._run_partials(
        srt >> 8, torch.where(valid, bm25._dequantize(
            srt & 0xFF, kw["imp_lo"], kw["imp_step"]), 0.0), valid,
        kw["max_dup_shifts"])
    approx_ms = time_cuda_ms(
        lambda: bm25.approx_max_k(partial, TOPC_C, TOPC_RECALL), iters=20)
    exact_ms = time_cuda_ms(lambda: bm25._top_sorted(partial, TOPC_C),
                            iters=20)
    n_valid = int(torch.isfinite(partial).sum(1).float().mean())
    log(f"phase 4o topc_recall: a pruned engine over 4a's index with 4a's "
        f"knobs at C={TOPC_C}, built in {build_s:.1f} s; P={P} pass-1 keys "
        f"({n_valid} documents a query on average), XLA's formula at "
        f"{TOPC_RECALL}: {reduced} bins, log2_reduction {log2}; recall@{K} "
        f"against the exact top-C {kept:.4f} (bar {TOPC_RECALL}); against "
        f"exhaustive: exact top-C {recall_at_k(exact, outs[0.0]):.4f}, "
        f"approximate {recall_at_k(exact, outs[TOPC_RECALL]):.4f}; device "
        f"ms over the [{partial.shape[0]}, {P}] partials (CUDA events, 20 "
        f"calls): approx_max_k {approx_ms:.4f}, _top_sorted {exact_ms:.4f} "
        f"({card})")
    del topc, keys, partial
    log(f"phase 4o in {time.perf_counter() - t_phase:.1f} s")
    return {"k1": [int(r["ex/launches"][0]) for r in ranks],
            "k2": [int(r["pr/launches"][1]) for r in ranks],
            "k1_err": max(float(r["k1"][0]) for r in ranks),
            "k2_err": max(float(r["k2"][0]) for r in ranks)}

# phase 4p: sharded training on two gloo ranks on the one card (NCCL
# refuses two ranks on one GPU), XLM-R large's width at CUT_LAYERS layers
MESH_FOLDER = "4g-fused"  # 4g (b)'s fused records, written by 4g
MESH_RECORDS = 32       # two steps at global batch 16
MESH_CONFIG = dict(learning_rate=RECIPE["learning_rate"], lr_rate=1.0,
                   batch_size=16, max_epochs=1, warmup_fraction=0.0,
                   use_inverse_sqrt=True, checkpoint=True)
MESH_LAYOUTS = (("dp", 2, 1, False), ("tp", 1, 2, False),
                ("fsdp", 2, 1, True))
# (d)-(g): distillation and multi-view training in the same world, each
# (name, layout, data, model, fsdp, config): (d) DistillationTrainer.train
# of 2 steps over the teachers' float16 cache, (e) one FSDP KD step with
# lazy teachers, (f) one TP KD step on the first teacher's 2 best paths,
# (g) one multi-view step
MESH_KD_RUNS = (("d", "dp", 2, 1, False, dict(teacher_cache="f16")),
                ("e", "fsdp", 2, 1, True, dict(teacher_cache="lazy")),
                ("f", "tp", 1, 2, False, dict(kbest=2)),
                ("g", "dp", 2, 1, False, dict(multi_view=True, mv_kind="kl",
                                              mv_l2_weight=0.1)))
MESH_TIMEOUT_S = 300    # the gloo group's timeout, and the world's deadline
# bfloat16 compute on half the rows (DP, FSDP) or half the heads and
# features (TP) rounds each GEMM differently from the single rank's:
MESH_LOSS_RTOL = 1e-2   # the mean loss of a step
MESH_NORM_RTOL = 2e-2   # the step's global gradient norm (the clip's)
MESH_MU_RTOL = 5e-2     # ||mu - mu_1|| / ||mu_1|| over the model
MESH_NU_RTOL = 1e-1     # the same of nu (squares: twice mu's error)
# an Adam update moves an element by at most ~1.01 lr at steps 1 and 2,
# so two runs stay within 2.02 lr a step; a slice in the wrong place or
# a stale weight differs by the weights' own size (~1e-2)
MESH_STEP_BOUND = 2.02
# the first step's gradient leaf by leaf, ||g - g_1|| / ||g_1|| of the
# worst leaf: the model's norms above are the largest leaves' and would
# not see a small leaf (a LayerNorm, a bias, the head, the transitions)
# go wrong. The data-parallel run also reads rank 0's gradient before
# the average over 'data' (a control: what a leaf whose average went
# missing would read), and its least leaf must read above the bar. At
# full width sound runs read 2.94e-03 (DP, FSDP) and 1.37e-02 (TP, an
# attention projection), the control 7.98e-02 at its least leaf (a
# layer norm): the bar sits between, ~2x from each.
MESH_LEAF_RTOL = 3e-2
# a key bias adds one constant to all of a query's scores, which the
# softmax takes out: its exact gradient is zero and the computed one is
# rounding, so it is held by its size against its layer's query bias's
# gradient instead: the largest ratio over the layers (~2e-03 in the
# single rank and each layout at full width) must stay under the bar
ZERO_GRAD_LEAF = "attention.key.bias"


def leaf_errors(got, want) -> dict:
    """``||got[k] - want[k]|| / ||want[k]||`` of each leaf ``k`` of
    ``want`` (0 where both are zero)."""
    import torch

    out = {}
    for k, w in want.items():
        d = float(torch.linalg.vector_norm((got[k] - w).float()))
        n = float(torch.linalg.vector_norm(w.float()))
        out[k] = d / n if n else (0.0 if d == 0 else float("inf"))
    return out


def _mesh_rank_run(rank: int, world: int, tmp) -> dict:
    """Phase 4p, one rank: XLM-R large + CRF (float32 masters, bfloat16
    compute, dropout off) from seed 0 over 4g's fused records, per layout
    of :data:`MESH_LAYOUTS` sharded by ``shard_params`` on its mesh:
    ``FinetuneTrainer.train`` data-parallel (two steps,
    ``checkpoint: true``), one ``train_step`` tensor-parallel and one
    FSDP. Each step's ms, loss, global norm and the host ms of its
    collectives (each timed between device syncs) are kept, and the
    first step's gradients and the final state are gathered. Rank 0 also
    runs the single-rank trainer on the same batches and holds each
    layout to it (rank 1 runs its first step only, to load its kernels
    before the first sharded step); after the data-parallel run rank 0
    reopens ``checkpoint.msgpack`` and ``best-model.msgpack`` and holds
    them to the gathered state bit for bit. Returns the numbers the
    parent prints."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from kbner_tpu_torch import weights
    from kbner_tpu_torch.data.conll import Corpus, ListCorpus, read_column_file
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
    from kbner_tpu_torch.models.xlmr import XLMRConfig
    from kbner_tpu_torch.parallel import (gather_state_dict, make_mesh,
                                          shard_params)
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig, optim

    recs = read_column_file(tmp / MESH_FOLDER / "train.txt",
                            {0: "text", 1: "ner"})[:MESH_RECORDS]
    corpus = ListCorpus([Corpus(recs, [], [], name="FUSED")])
    tag_dict = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(vocab_size=HASH_VOCAB)
    enc = dataclasses.replace(
        XLMRConfig.large(vocab_size=HASH_VOCAB, param_dtype=torch.float32),
        num_layers=CUT_LAYERS, hidden_dropout=0.0, attention_dropout=0.0)
    tcfg = TaggerConfig.for_tag_dictionary(
        enc, tag_dict, locked_dropout=0.0, word_dropout=0.0,
        relearn_embeddings=False)
    config = TrainConfig(**MESH_CONFIG)
    lr = config.learning_rate
    make_mesh(data=world, model=1)  # sets this rank's card
    dev = torch.device("cuda", torch.cuda.current_device())

    def sync():
        torch.cuda.synchronize(dev)

    # the smoke's own instruments: collectives timed between device
    # syncs, and each global norm the optimizer takes
    comm = {"ms": 0.0, "calls": 0}

    def timed_collective(fn):
        def run(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            comm["ms"] += (time.perf_counter() - t0) * 1e3
            comm["calls"] += 1
            return out
        return run

    for op in ("all_reduce", "all_gather", "reduce_scatter"):
        setattr(dist, op, timed_collective(getattr(dist, op)))
    norms = []
    global_norm = optim.FinetuneOptimizer._global_norm

    def keep_norm(self, grads):
        n = global_norm(self, grads)
        norms.append(float(n))
        return n

    optim.FinetuneOptimizer._global_norm = keep_norm

    def local_grads(model):
        return {n: p.grad.detach().clone()
                for n, p in model.named_parameters() if p.grad is not None}

    def gathered(trainer, named):
        """Every rank's slices of ``named`` gathered (a collective on a
        sharded model); rank 0 keeps them."""
        sh = trainer.sharding
        full = {n: sh.gather(n, t) if sh is not None else t
                for n, t in named.items()}
        return full if rank == 0 else None

    def timed_steps(trainer, steps, seen):
        """Time each step of ``trainer`` (its ``_step``, which
        ``train_step`` and ``kd_step`` run); keep the first step's
        gradients (as its optimizer meets them) in ``seen["grads"]``,
        gathered after the step's timed window."""
        inner = trainer._step

        def step(loss_fn, opt, freeze=False):
            seen["opt"] = opt
            first = not steps
            if first:
                opt_step = opt.step

                def keep_then_step():
                    seen["local"] = local_grads(trainer.model)
                    opt.step = opt_step
                    return opt_step()
                opt.step = keep_then_step
            sync()
            comm.update(ms=0.0, calls=0)
            t0 = time.perf_counter()
            loss = inner(loss_fn, opt, freeze)
            sync()
            steps.append(((time.perf_counter() - t0) * 1e3, float(loss),
                          comm["ms"], comm["calls"], norms[-1]))
            if first:
                seen["grads"] = gathered(trainer, seen.pop("local"))
            return loss
        trainer._step = step

    def moments_of(trainer, opt):
        named = opt.named_moments()
        if trainer.sharding is not None:
            named = {k: {n: trainer.sharding.gather(n, t)
                         for n, t in v.items()} for k, v in named.items()}
        return named

    # the single-rank trainer on the same global batches: rank 0 keeps it
    # to hold the layouts to; rank 1 runs its first step, so that both
    # ranks reach the first sharded step with their kernels loaded
    ref = {"steps": [], "state": [], "moments": []}
    model = SequenceTagger(tcfg, device=dev, seed=0)
    trainer = FinetuneTrainer(model, corpus, tok, tag_dict, device=dev)
    opt = trainer.make_optimizer(config)
    rng = torch.Generator().manual_seed(config.seed)
    seen_ref = {}
    timed_steps(trainer, ref["steps"], seen_ref)
    for i, batch in enumerate(trainer._make_train_batches(recs, config, 0)):
        if rank and i:
            break
        trainer.train_step(batch, opt, config, rng)
        if rank == 0:
            ref["state"].append({n: p.detach().clone()
                                 for n, p in model.named_parameters()})
            ref["moments"].append({k: {n: t.clone() for n, t in
                                       v.items()} for k, v in
                                   opt.named_moments().items()})
    ref["grads"] = seen_ref["grads"]
    del trainer, model, opt, seen_ref
    dist.barrier()

    def worst_of(errors, n=3, least=False):
        return sorted(((v, k) for k, v in errors.items()),
                      reverse=not least)[:n]

    def held(steps, state, moments, grads, unaveraged, base=None):
        """The layout's distances from the single-rank run (``base``, by
        default the one of (a)-(c)) after as many steps, and its first
        step's gradient's leaf by leaf (the parent holds them to their
        bars)."""
        base = ref if base is None else base
        n = len(steps)
        want = base["state"][n - 1]
        worst = max(float((state[k] - w).abs().max()) for k, w in
                    want.items())
        half = sum(int(((state[k] - w).abs() > lr / 2).sum())
                   for k, w in want.items())
        total = sum(w.numel() for w in want.values())
        rel = {}
        for key in ("mu", "nu"):
            num = sum(float((moments[key][k].float()
                             - w.float()).square().sum())
                      for k, w in base["moments"][n - 1][key].items())
            den = sum(float(w.float().square().sum())
                      for w in base["moments"][n - 1][key].values())
            rel[key] = (num / den) ** 0.5
        loss_rel = [abs(a[1] - b[1]) / abs(b[1])
                    for a, b in zip(steps, base["steps"])]
        norm_rel = [abs(a[4] - b[4]) / b[4]
                    for a, b in zip(steps, base["steps"])]
        exact = {k: g for k, g in base["grads"].items()
                 if not k.endswith(ZERO_GRAD_LEAF)}
        leaves = worst_of(leaf_errors(grads, exact))
        control = (worst_of(leaf_errors(unaveraged, exact), least=True)
                   if unaveraged is not None else [])
        zero = [max(float(torch.linalg.vector_norm(g[k]) /
                          torch.linalg.vector_norm(g[k.replace(
                              ".key.", ".query.")]))
                    for k in g if k.endswith(ZERO_GRAD_LEAF))
                for g in (grads, base["grads"])]
        return [max(loss_rel), max(norm_rel), worst / (lr * n), half / total,
                rel["mu"], rel["nu"], leaves, control, zero]

    out = {"ref/steps": ref["steps"]}
    for label, data, model_n, fsdp in MESH_LAYOUTS:
        mesh = make_mesh(data=data, model=model_n)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tagger = shard_params(SequenceTagger(tcfg, device=dev, seed=0), mesh,
                              fsdp)
        trainer = FinetuneTrainer(tagger, corpus, tok, tag_dict, mesh=mesh,
                                  device=dev)
        sync()
        build_s = time.perf_counter() - t0
        steps, seen = [], {}
        timed_steps(trainer, steps, seen)
        if label == "dp" and rank == 0:
            # the control: rank 0's first gradient before the average
            sync_gradients = trainer.sharding.sync_gradients

            def keep_then_sync(model):
                seen.setdefault("unaveraged", local_grads(model))
                return sync_gradients(model)
            trainer.sharding.sync_gradients = keep_then_sync
        t0 = time.perf_counter()
        if label == "dp":
            trainer.train(tmp / "mesh-dp", config)
        else:
            trainer.train_step(trainer._make_train_batches(recs, config, 0)[0],
                               trainer.make_optimizer(config), config, None)
        run_s = time.perf_counter() - t0
        state = gather_state_dict(trainer.model)
        moments = moments_of(trainer, seen["opt"])
        out[f"{label}/steps"] = steps
        out[f"{label}/seconds"] = [build_s, run_s]
        out[f"{label}/peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        if rank == 0:
            out[f"{label}/held"] = held(steps, state, moments,
                                        seen["grads"],
                                        seen.get("unaveraged"))
        if rank == 0 and label == "dp":
            t0 = time.perf_counter()
            run = tmp / "mesh-dp"
            blob = weights.checkpoint.load(run / "checkpoint.msgpack")
            reopened = weights.from_jax_params(blob["params"], tagger)
            count, _, named = optim.from_optax_state(
                blob["opt_state"], seen["opt"], tagger)
            best = weights.load_params(run / "best-model.msgpack", tagger)
            for k, v in state.items():
                for what, got in (("checkpoint.msgpack", reopened[k]),
                                  ("best-model.msgpack", best[k])):
                    if not torch.equal(got, v.cpu()):
                        raise AssertionError(f"phase 4p: {what}'s {k} is "
                                             "not the gathered state")
            for key, by_name in moments.items():
                for k, v in by_name.items():
                    if not torch.equal(named[key][k].to(v.dtype), v.cpu()):
                        raise AssertionError(f"phase 4p: checkpoint.msgpack"
                                             f"'s {key} of {k} differs")
            if count != seen["opt"].count:
                raise AssertionError(f"phase 4p: checkpoint count {count}")
            out["reopen"] = [time.perf_counter() - t0, len(state),
                             (run / "checkpoint.msgpack").stat().st_size]
            del blob, reopened, named, best
        del trainer, tagger, state, moments, seen
        torch.cuda.empty_cache()
        dist.barrier()
    del ref
    out.update(_mesh_kd_runs(rank, tmp, recs, tok, tag_dict, tcfg, dev, sync,
                             timed_steps, held, moments_of))
    return out


def _mesh_kd_runs(rank, tmp, recs, tok, tag_dict, tcfg, dev, sync,
                  timed_steps, held, moments_of) -> dict:
    """Phase 4p (d)-(g), one rank, in :func:`_mesh_rank_run`'s world and
    with its instruments: the records split into two languages, two
    teachers at the student's width (seeds 1 and 2) routed per sentence,
    and per run of :data:`MESH_KD_RUNS` the student (seed 0) sharded on
    its layout's mesh: (d) ``DistillationTrainer.train`` (2 steps), (e)-(f)
    one ``kd_step``, (g) one multi-view ``train_step``. Rank 0 first runs
    the same steps in one process on the same batches and holds the run
    to them as (a)-(c) are held. Returns the numbers the parent prints
    under ``kd/<run>/...``."""
    import gc

    import torch
    import torch.distributed as dist

    from kbner_tpu_torch.data.conll import Corpus, ListCorpus
    from kbner_tpu_torch.data.encode import make_batches
    from kbner_tpu_torch.models.tagger import SequenceTagger
    from kbner_tpu_torch.parallel import (gather_state_dict, make_mesh,
                                          shard_params)
    from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
    from kbner_tpu_torch.train.distill import (DistillationTrainer,
                                               DistillConfig)

    half = len(recs) // 2
    corpus = ListCorpus([Corpus(recs[:half], [], [], name="FUSED-A"),
                         Corpus(recs[half:], [], [], name="FUSED-B")])
    langs = np.bincount([r.lang_id for r in corpus.train]).tolist()
    t0 = time.perf_counter()
    teachers = [SequenceTagger(tcfg, device=dev, seed=seed)
                for seed in (1, 2)]
    sync()
    out = {"kd/teachers_s": time.perf_counter() - t0, "kd/langs": langs}
    base_cfg = dict(MESH_CONFIG, checkpoint=False)
    # the train split's batches as DistillationTrainer.train makes them,
    # in the order its first epoch visits them
    batches = make_batches(corpus.train, tok, tag_dict,
                           base_cfg["batch_size"], shuffle=False,
                           tag_layer="ner")
    order = np.random.RandomState(TrainConfig(**base_cfg).seed).permutation(
        len(batches))
    forwards = []

    def timed_forwards(teacher):
        inner = teacher.emissions

        def emissions(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            em = inner(*args, **kwargs)
            sync()
            forwards.append((time.perf_counter() - t0) * 1e3)
            return em
        teacher.emissions = emissions

    def steps_of(trainer, cfg, opt, mv):
        """The single rank's steps, and (e)-(g)'s on the mesh: (d) both
        batches over the teachers' float16 cache in the epoch's order,
        (e)-(g) the first batch."""
        if mv:
            trainer.train_step(trainer._make_train_batches(
                corpus.train, cfg, 0)[0], opt, cfg, None)
        elif cfg.kbest:
            eb = batches[order[0]]
            trainer.kd_step(eb, trainer._teacher_kbest([eb], cfg.kbest)[0],
                            opt, cfg, None)
        elif cfg.teacher_cache == "lazy":
            trainer.kd_step(batches[order[0]], None, opt, cfg, None)
        else:
            cached = trainer._teacher_emissions(batches)
            for b in order:
                trainer.kd_step(batches[b], cached[b], opt, cfg, None)

    for name, label, data, model_n, fsdp, kw in MESH_KD_RUNS:
        mv = kw.get("multi_view", False)
        cfg = (TrainConfig if mv else DistillConfig)(**base_cfg, **kw)
        cls, extra = ((FinetuneTrainer, {}) if mv else
                      (DistillationTrainer, {"teachers": teachers}))
        lazy = kw.get("teacher_cache") == "lazy"
        if lazy or kw.get("kbest"):
            for teacher in teachers:
                teacher.to(dev)
        base = {"steps": [], "state": [], "moments": []}
        if rank == 0:
            single = cls(SequenceTagger(tcfg, device=dev, seed=0), corpus,
                         tok, tag_dict, device=dev, **extra)
            seen_ref = {}
            timed_steps(single, base["steps"], seen_ref)
            opt = single.make_optimizer(cfg)
            inner = single._step

            def keep(loss_fn, opt_, freeze=False, _inner=inner,
                     _single=single):
                loss = _inner(loss_fn, opt_, freeze)
                base["state"].append({n: p.detach().clone() for n, p in
                                      _single.model.named_parameters()})
                base["moments"].append({k: {n: t.clone() for n, t in
                                            v.items()} for k, v in
                                        opt_.named_moments().items()})
                return loss
            single._step = keep
            steps_of(single, cfg, opt, mv)
            base["grads"] = seen_ref["grads"]
            del single, opt, seen_ref, keep
            gc.collect()
        dist.barrier()
        mesh = make_mesh(data=data, model=model_n)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        tagger = shard_params(SequenceTagger(tcfg, device=dev, seed=0), mesh,
                              fsdp)
        trainer = cls(tagger, corpus, tok, tag_dict, mesh=mesh, device=dev,
                      **extra)
        sync()
        build_s = time.perf_counter() - t0
        steps, seen = [], {}
        timed_steps(trainer, steps, seen)
        if lazy:
            forwards.clear()
            for teacher in teachers:
                timed_forwards(teacher)
        t0 = time.perf_counter()
        if name == "d":
            trainer.train(tmp / "mesh-kd", cfg)
            files = sorted(p.name for p in (tmp / "mesh-kd").iterdir())
        else:
            steps_of(trainer, cfg, trainer.make_optimizer(cfg), mv)
            files = []
        run_s = time.perf_counter() - t0
        for teacher in teachers:
            teacher.__dict__.pop("emissions", None)
        state = gather_state_dict(trainer.model)
        moments = moments_of(trainer, seen["opt"])
        key = f"kd/{name}"
        out[f"{key}/steps"] = steps
        out[f"{key}/seconds"] = [build_s, run_s]
        out[f"{key}/peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
        out[f"{key}/forwards"] = list(forwards)
        out[f"{key}/files"] = files
        if rank == 0:
            out[f"{key}/held"] = held(steps, state, moments, seen["grads"],
                                      None, base)
        forwards.clear()
        del trainer, tagger, state, moments, seen, base
        # the step wrappers close over their trainers: collect the cycles
        # so that each run's model and moments leave the card
        gc.collect()
        torch.cuda.empty_cache()
        dist.barrier()
    return out


def _mesh_held(key, ranks, what, card, notes="") -> list:
    """Hold a 4p run (``key``: a layout, or ``kd/<run>``) to its bars
    against the single rank and log it: each rank's steps, then the
    distances. Returns the failures."""
    r0 = ranks[0]
    failed = []
    if any([s[1] for s in r[f"{key}/steps"]] != [
            s[1] for s in r0[f"{key}/steps"]] for r in ranks):
        failed.append(f"{key}: the ranks' losses differ")
    (loss_rel, norm_rel, worst, flipped, mu_rel, nu_rel, leaves,
     control, zero) = r0[f"{key}/held"]
    for name, got, bar in (
            ("loss rel", loss_rel, MESH_LOSS_RTOL),
            ("global norm rel", norm_rel, MESH_NORM_RTOL),
            ("parameters apart (lr a step)", worst, MESH_STEP_BOUND),
            ("mu rel", mu_rel, MESH_MU_RTOL),
            ("nu rel", nu_rel, MESH_NU_RTOL),
            (f"first-step gradient of {leaves[0][1]}", leaves[0][0],
             MESH_LEAF_RTOL),
            ("key biases' gradient over the query biases'", zero[0],
             MESH_LEAF_RTOL)):
        if not got <= bar:
            failed.append(f"{key}: {name} {got:.3g} over {bar}")
    if control and not control[0][0] > MESH_LEAF_RTOL:
        failed.append(f"{key}: the control's {control[0][1]} reads "
                      f"{control[0][0]:.3g}, not above {MESH_LEAF_RTOL}")
    log(f"phase 4p {what} (XLM-R large's width, {CUT_LAYERS} layers, "
        f"float32 masters, bfloat16 compute, global batch "
        f"{MESH_CONFIG['batch_size']}): "
        + "; ".join(
            f"rank {i}: steps "
            + ", ".join(f"{s[0]:.1f} ms (loss {s[1]:.4f}, norm "
                        f"{s[4]:.4f}; {s[3]} collectives {s[2]:.1f} "
                        f"ms)" for s in r[f"{key}/steps"])
            + f", build {r[f'{key}/seconds'][0]:.1f} s, run "
            f"{r[f'{key}/seconds'][1]:.1f} s, peak allocated "
            f"{r[f'{key}/peak_gb']:.2f} GB" for i, r in enumerate(ranks))
        + notes
        + f"; against the single rank on the same batches: loss rel "
        f"{loss_rel:.2e} (bar {MESH_LOSS_RTOL}), global norm rel "
        f"{norm_rel:.2e} (bar {MESH_NORM_RTOL}), parameters at most "
        f"{worst:.3g} lr a step apart (bar {MESH_STEP_BOUND}), "
        f"{flipped:.3%} of them over lr/2 apart, mu rel {mu_rel:.2e} "
        f"(bar {MESH_MU_RTOL}), nu rel {nu_rel:.2e} (bar "
        f"{MESH_NU_RTOL}); the first step's gradient, worst leaves: "
        + ", ".join(f"{k} {v:.2e}" for v, k in leaves)
        + f" (bar {MESH_LEAF_RTOL}); key biases (zero gradient in "
        f"exact arithmetic): largest ||g|| over its query bias's "
        f"{zero[0]:.2e} (bar {MESH_LEAF_RTOL}), the single rank's "
        f"{zero[1]:.2e}"
        + ("; control, rank 0's gradient before the average over "
           "'data', least leaves: "
           + ", ".join(f"{k} {v:.2e}" for v, k in control)
           + " (must read above the bar)" if control else "")
        + f" ({card})")
    return failed


KD_WHAT = {"d": "DistillationTrainer.train, float16 teacher cache",
           "e": "one KD step, lazy teachers",
           "f": "one KD step on the first teacher's 2 best paths",
           "g": "one multi-view step (kl, L2 weight 0.1)"}


def mesh_stage_phase(bm25, card, tmp) -> None:
    """Phase 4p, after 4o in its directory ``tmp`` (4g's fused records in
    :data:`MESH_FOLDER`): a world of two gloo ranks on the card runs
    :func:`_mesh_rank_run`; prints each run's step ms, collective ms,
    peak memory and its distance from the single rank: (a)-(c) per
    layout, (d)-(g) distillation and multi-view training."""
    t_phase = time.perf_counter()
    reset_counts(bm25)
    ranks, world_s = timed(lambda: spawn_world(_mesh_rank_run, tmp, 2, "4p",
                                               MESH_TIMEOUT_S))
    r0 = ranks[0]
    failed = []
    for label, data, model, fsdp in MESH_LAYOUTS:
        failed += _mesh_held(label, ranks, f"{label} (data={data}, "
                             f"model={model}, fsdp={fsdp})", card)
    log("phase 4p single rank (the same batches, one process): steps "
        + "; ".join(f"rank {i}: " + ", ".join(
            f"{s[0]:.1f} ms (loss {s[1]:.4f})" for s in r["ref/steps"])
            for i, r in enumerate(ranks))
        + f" (rank 0 runs both and keeps its states, rank 1 the first to "
        f"load its kernels) ({card})")
    reopen_s, n_leaves, n_bytes = r0["reopen"]
    log(f"phase 4p: dp's checkpoint.msgpack ({n_bytes / 1e9:.2f} GB) and "
        f"best-model.msgpack reopened unsharded in {reopen_s:.1f} s: "
        f"{n_leaves} parameters and their mu and nu equal the ranks' "
        f"gathered state bit for bit ({card})")
    langs = r0["kd/langs"]
    log(f"phase 4p (d)-(g): the {sum(langs)} records split into "
        f"{len(langs)} languages ({', '.join(map(str, langs))} sentences), "
        f"two teachers at the student's width (seeds 1 and 2, built in "
        f"{r0['kd/teachers_s']:.1f} s) routed per sentence ({card})")
    for name, label, data, model, fsdp, kw in MESH_KD_RUNS:
        key = f"kd/{name}"
        notes = ""
        if name == "d":
            files = r0[f"{key}/files"]
            if files != ["best-model.msgpack", "final-model.msgpack",
                         "tag_dictionary.json"]:
                failed.append(f"{key}: rank 0 wrote {files}")
            notes = f"; rank 0 wrote {', '.join(files)}"
        if kw.get("teacher_cache") == "lazy":
            notes = "; teacher forwards " + "; ".join(
                f"rank {i}: {len(ms)} of "
                + ", ".join(f"{t:.1f}" for t in ms)
                + f" ms, {sum(ms) / len(r[f'{key}/steps']):.1f} ms a step"
                for i, r in enumerate(ranks) for ms in [r[f"{key}/forwards"]])
        failed += _mesh_held(key, ranks, f"({name}) {KD_WHAT[name]} "
                             f"({label}: data={data}, model={model}, "
                             f"fsdp={fsdp})", card, notes)
    log(f"phase 4p: the world spawned, ran and held in {world_s:.1f} s "
        f"(host clock) ({card})")
    if failed:
        raise AssertionError("phase 4p against the single rank: "
                             + "; ".join(failed))
    expect_counts("phase 4p", counts(bm25), {})
    log(f"phase 4p in {time.perf_counter() - t_phase:.1f} s")


def drop_checkpoints(tmp) -> None:
    """Delete the checkpoints (``*.msgpack``) under ``tmp``: the phases
    that wrote them have checked them and no later phase reads them, so
    the next phases' checkpoints reuse their room and the run's peak disk
    use stays that of its largest phases."""
    files = list(tmp.rglob("*.msgpack"))
    n_bytes = sum(f.stat().st_size for f in files)
    for f in files:
        f.unlink()
    log(f"deleted {len(files)} checked checkpoints, {n_bytes / 1e9:.1f} GB")


def fuse_served(engine, tokenizer, records):
    """The records ``serve`` fuses: each searched with its own tokens."""
    from kbner_tpu_torch.retrieval.fusion import fuse_contexts

    results = engine.search([" ".join(r.tokens) for r in records], k=K)
    return fuse_contexts(records, results, tokenizer)


class RenderedDocs:
    """Document texts rendered on demand from term ids as ``w<id>``
    words, so 1M sentences need no host strings until retrieved."""

    def __init__(self, docs: np.ndarray):
        self.docs = docs

    def __len__(self) -> int:
        return self.docs.shape[0]

    def __getitem__(self, i: int) -> str:
        row = self.docs[i]
        return " ".join(f"w{t}" for t in row[row >= 0])


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on an NVIDIA GPU", file=sys.stderr)
        return 1

    from pathlib import Path

    import kbner_tpu_torch.cli as cli
    from kbner_tpu_torch.data.conll import EOS_MARKER
    from kbner_tpu_torch.data.dictionary import make_tag_dictionary
    from kbner_tpu_torch.data.encode import encode_batch
    from kbner_tpu_torch.data.subword import HashTokenizer
    from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
    from kbner_tpu_torch.models.xlmr import XLMRConfig
    from kbner_tpu_torch.ops import _kernels, bm25
    from kbner_tpu_torch.ops.crf import crf_decode
    from kbner_tpu_torch.retrieval.engine import DocStore, RetrievalEngine
    from kbner_tpu_torch.retrieval.fusion import fuse_contexts
    from kbner_tpu_torch.retrieval.index import BM25Index, log_quantize
    from kbner_tpu_torch.retrieval import synth
    from kbner_tpu_torch.retrieval.synth import (sentence_queries,
                                                 synth_k1_operands,
                                                 synth_k3_operands,
                                                 synth_wiki_docs)
    from kbner_tpu_torch.serve import predict, request_record, serve

    # -- 1. device -----------------------------------------------------------
    card = card_line()
    log(card)
    log(f"host: {host_line()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    dev = torch.device(DEVICE)

    # -- 2. build -------------------------------------------------------------
    def build(name):
        t0 = time.perf_counter()
        return _kernels.build(name), time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as ex:
        builds = dict(zip(KERNELS, ex.map(build, KERNELS)))
    for name, (report, sec) in builds.items():
        log(f"build: {name}.cu with nvcc for sm_90a in {sec:.2f} s "
            "(set-up, built in parallel)")
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    # -- 3a. K1 against plain on edge shapes ---------------------------------
    err_cases = check_kernel_cases(bm25, synth_k1_operands, dev)
    log(f"bm25_score_block vs plain on {len(K1_CASES)} cases (ragged Q and "
        f"N, Q=33, Lq=70 and 130, doc-axis slices at offsets 1, 2, 3 and "
        f"131, N below a tile, Ld=2, -1-padded, ids near 2^31-1, hash "
        f"collisions, one term in every query slot, repeated terms): max "
        f"abs err {err_cases:.3g} (rtol {RTOL}, atol {ATOL})")
    d16_err_cases = check_delta16_cases(bm25, synth, dev)
    log(f"delta16_rescore vs plain on {len(D16_CASES)} cases (R2=1, 2 and "
        f"3 / ragged (Q=5, C=300) / id-0 / -1-padded, with continuation "
        f"slots; ids on one hash slot, a term in 4 query slots, W=256 and "
        f"6144, segments at odd offsets, gaps 8190-16383): max abs err "
        f"{d16_err_cases:.3g} (rtol {RTOL}, atol {ATOL})")
    k3_err_cases = check_rescore_cases(bm25, synth_k3_operands, dev)
    log(f"bm25_rescore vs plain on {len(K3_CASES)} cases (ragged (Q=5, "
        f"C=300) / Ld=1, 13, 20, 52, 130 / Lq=1, 12, 64, 6144 / codes 0 and "
        f"65535 / ids 0 and N-1 / repeated and -1-padded terms over "
        f"-1-padded coded rows / ids on one hash slot): max abs err "
        f"{k3_err_cases:.3g} (rtol {RTOL}, atol {ATOL})")

    # -- 4a. set-up of the main path -----------------------------------------
    t0 = time.perf_counter()
    docs = synth_wiki_docs(N_DOCS, n_topics=N_TOPICS, seed=0)
    vocab_size = int(docs.max()) + 1
    vocab = {f"w{i}": i for i in range(vocab_size)}
    index, encoded_s = timed(lambda: BM25Index.build_encoded(docs, vocab))
    # the title field: the first two terms of each doc, as
    # tests/test_pruned_retrieval.py builds titles
    title_docs = docs[:, :2]
    title_index = BM25Index.build_encoded(title_docs, vocab)
    store = DocStore(RenderedDocs(docs), titles=RenderedDocs(title_docs))
    engine = RetrievalEngine(index, store=store, title_index=title_index,
                             device=dev)
    dt_t, di_t = engine.fields["text"]
    tdt_t, tdi_t = engine.fields["title"]
    log(f"KB: {index.n_docs} docs, vocabulary {vocab_size}, index "
        f"[Ld={dt_t.shape[0]}, N={dt_t.shape[1]}] int32+float32 = "
        f"{(dt_t.nbytes + di_t.nbytes) / 1e9:.3f} GB on the card, title "
        f"index [Ld={tdt_t.shape[0]}, N={tdt_t.shape[1]}] = "
        f"{(tdt_t.nbytes + tdi_t.nbytes) / 1e9:.3f} GB; built in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    q_ids, src = sentence_queries(docs, BATCH * N_BATCHES,
                                  q_len=MAX_QUERY_TERMS, seed=1)
    requests = [{"id": i, "tokens": [f"w{t}" for t in row[row >= 0]]}
                for i, row in enumerate(q_ids)]
    batches = [requests[i:i + BATCH]
               for i in range(0, len(requests), BATCH)]

    t0 = time.perf_counter()
    tokenizer = HashTokenizer(vocab_size=HASH_VOCAB)
    tag_dict = make_tag_dictionary([NER_TAGS])
    enc_cfg = XLMRConfig.large(vocab_size=HASH_VOCAB)
    tagger = SequenceTagger(
        TaggerConfig.for_tag_dictionary(enc_cfg, tag_dict), device=dev,
        seed=0)
    tagger.eval()
    n_params = sum(p.numel() for p in tagger.parameters())
    torch.cuda.synchronize()
    log(f"tagger: XLM-R large ({enc_cfg.num_layers} layers, hidden "
        f"{enc_cfg.hidden_size}, {enc_cfg.num_heads} heads, FFN "
        f"{enc_cfg.intermediate_size}, vocab {enc_cfg.vocab_size}, "
        f"{enc_cfg.dtype}) + CRF over {len(tag_dict)} tags, "
        f"{n_params / 1e6:.1f} M parameters, random weights from seed 0; "
        f"made in {time.perf_counter() - t0:.1f} s (set-up)")

    # -- 3b. K1 against plain at the main path's shapes ----------------------
    qt_np, qw_np = index.encode_queries(
        [" ".join(r["tokens"]) for r in batches[0]],
        max_query_terms=MAX_QUERY_TERMS)
    qt = torch.from_numpy(qt_np).to(dev)
    qw = torch.from_numpy(qw_np).to(dev)
    k1 = measure_k1(bm25, qt, qw, dt_t, di_t)
    Q, Lq = qt.shape
    Ld, N = dt_t.shape
    k1_floor_ms = floor_ms(_kernels, "bm25_score", (Q, Lq, N))
    log(f"bm25_score_block at the serve shape Q={Q} Lq={Lq} Ld={Ld} N={N} "
        f"({card}): kernel {k1['dev_ms']:.4f} ms on the device "
        f"(CUDA graph), {k1['cold_ms']:.4f} ms after an L2 flush, "
        f"launch floor {k1_floor_ms:.5f} ms, {k1['ms']:.4f} ms eager, plain "
        f"{k1['plain_ms']:.3f} ms, bound {k1['bound_ms']:.4f} ms by "
        f"{k1['bound_by']} ({k1['bytes'] / 1e6:.1f} MB = "
        f"{k1['bytes_ms']:.4f} ms; {k1['ops'] / 1e9:.3f} G int32 lookups = "
        f"{k1['ops_ms']:.4f} ms), {k1['bound_ms'] / k1['dev_ms']:.1%} of the "
        f"bound; max abs err "
        f"{k1['err']:.3g}, top-{K} ids equal within ties")
    # the adds the kernel does on this data: one per (slot, query) match
    n_match = sum(int(torch.isin(dt_t, qt[q][qt[q] >= 0]).sum())
                  for q in range(Q))
    scores = bm25.bm25_score_block(qt, qw, dt_t, di_t)
    topk_ms = time_cuda_ms(lambda: torch.topk(scores, K, dim=1), iters=20)
    del scores
    log(f"bm25_score_block's work on this data: {n_match} (slot, query) "
        f"matches = {n_match / k1['ops']:.2%} of the {k1['ops']} (non-pad "
        f"slot, query) pairs; torch.topk(scores, {K}) over the [{Q}, {N}] "
        f"scores {topk_ms:.4f} ms ({card})")
    tie_check(bm25, dt_t, di_t, qt, qw, card)
    # the title field: each query's entity is its source sentence's title
    tt_np, tw_np = title_index.encode_queries(
        [" ".join(f"w{t}" for t in title_docs[s]) for s in src[:BATCH]],
        max_query_terms=MAX_QUERY_TERMS, boosts=[TITLE_BOOST] * BATCH)
    k1_title = measure_k1(bm25, torch.from_numpy(tt_np).to(dev),
                          torch.from_numpy(tw_np).to(dev), tdt_t, tdi_t)
    log(f"bm25_score_block on the title field Q={BATCH} "
        f"Lq={MAX_QUERY_TERMS} Ld={tdt_t.shape[0]} N={tdt_t.shape[1]} "
        f"({card}): kernel {k1_title['dev_ms']:.4f} ms on the device "
        f"(CUDA graph), {k1_title['ms']:.4f} ms eager, plain "
        f"{k1_title['plain_ms']:.3f} ms, bound {k1_title['bound_ms']:.4f} ms "
        f"by {k1_title['bound_by']} ({k1_title['bytes'] / 1e6:.1f} MB; "
        f"{k1_title['ops'] / 1e6:.1f} M lookups), "
        f"{k1_title['bound_ms'] / k1_title['dev_ms']:.1%} of the bound; max "
        f"abs "
        f"err {k1_title['err']:.3g}")

    # -- 4b. the exhaustive path: serve micro-batches ------------------------
    reset_counts(bm25)
    responses, stage_ms, batch_ms, peak_gb = serve_batches(
        serve, engine, batches, tagger, tokenizer, tag_dict)
    served = counts(bm25)
    launches = served["bm25_score_block"]
    ex_rate = report_serve("exhaustive", responses, batches, stage_ms,
                           batch_ms, peak_gb, f"launches {served}", card)
    expect_counts("the exhaustive path", served, {"bm25_score_block": None})
    check_responses(requests, responses, tag_dict, EOS_MARKER)
    # the fused records of the first batch, made again outside the counted
    # run: at least one sentence carried retrieved context into the tagger
    orig = [request_record(r) for r in batches[0]]
    results = engine.search([" ".join(r.tokens) for r in orig], k=K)
    fused = fuse_contexts(orig, results, tokenizer)
    n_fused = sum(EOS_MARKER in r.tokens for r in fused)
    if n_fused == 0:
        raise AssertionError("no request of the first batch was fused with "
                             "retrieved context")
    hit = np.mean([int(s) in {d.doc_id for d in res}
                   for s, res in zip(src[:BATCH], results)])
    sub_len = max(len(encode_batch([r], tokenizer).input_ids[0])
                  for r in fused)
    log(f"fusion: {n_fused}/{len(fused)} sentences of the first batch carry "
        f"context, longest {sub_len} subtokens; the query's source "
        f"sentence is in its top {K} for {hit:.0%} of them")

    # the large tagger's emissions on the first fused batch are finite, and
    # where the tag stage's time goes on that batch: the encoder with the
    # emission head, then the CRF's Viterbi loop over the words
    eb = encode_batch(fused, tokenizer)
    arrays = {k: torch.from_numpy(v).to(dev) for k, v in eb.arrays().items()}
    with torch.no_grad():
        em = tagger.emissions(arrays)
        enc_ms = time_cuda_ms(lambda: tagger.emissions(arrays), iters=3)
    if not bool(torch.isfinite(em).all()):
        raise AssertionError("XLM-R large emissions are not finite")
    trans = tagger.transition_matrix().detach()
    cfg = tagger.config
    crf_ms = time_cuda_ms(lambda: crf_decode(
        em, arrays["crf_mask"], trans, cfg.start_idx, cfg.stop_idx), iters=3)
    B, S = eb.input_ids.shape
    log(f"tagger: emissions {tuple(em.shape)} finite; on this batch "
        f"(B={B}, S={S} subtokens, W={eb.word_mask.shape[1]} words) the "
        f"encoder + emission head take {enc_ms:.1f} ms and the CRF decode "
        f"{crf_ms:.1f} ms ({card})")

    # a small reference: a float32 tiny tagger on the card and on the CPU,
    # same weights, the first batch's fused records
    tiny_tok = HashTokenizer(vocab_size=1000)
    tiny_cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(max_position_embeddings=514), tag_dict)
    cpu_tagger = SequenceTagger(tiny_cfg, device="cpu", seed=0).eval()
    gpu_tagger = SequenceTagger(tiny_cfg, device=dev, seed=1).eval()
    gpu_tagger.load_state_dict(cpu_tagger.state_dict())
    eb = encode_batch(fused, tiny_tok)
    with torch.no_grad():
        em_cpu = cpu_tagger.emissions(
            {k: torch.from_numpy(v) for k, v in eb.arrays().items()})
        em_gpu = gpu_tagger.emissions(
            {k: torch.from_numpy(v).to(dev) for k, v in eb.arrays().items()})
    em_err = float((em_gpu.cpu() - em_cpu).abs().max())
    if em_err > 1e-4:
        raise AssertionError(f"tiny tagger emissions differ by {em_err:.3g} "
                             "between the card and the CPU")
    tags_cpu = predict(fused, cpu_tagger, tiny_tok, tag_dict)
    tags_gpu = predict(fused, gpu_tagger, tiny_tok, tag_dict)
    if tags_cpu != tags_gpu:
        raise AssertionError("tiny tagger tags differ between the card and "
                             "the CPU")
    log(f"tagger reference (tiny, float32, same weights): card vs CPU "
        f"emissions max abs err {em_err:.3g} (atol 1e-4), CRF tags equal")

    # -- 4c. set-up of the pruned path ----------------------------------------
    t0 = time.perf_counter()
    pruned = RetrievalEngine(index, store=store, title_index=title_index,
                             mode="pruned", device=dev, **PRUNED_KNOBS)
    torch.cuda.synchronize()
    flat, off, lens, normc = pruned.rows["text"]
    csr_off, csr_packed = pruned.csr["text"]
    t_bytes = sum(x.nbytes for x in pruned.rows["title"])
    tcsr_bytes = sum(x.nbytes for x in pruned.csr["title"])
    log(f"pruned engine: built in {time.perf_counter() - t0:.1f} s from the "
        f"same index and title index (set-up); "
        f"R2={pruned._row_meta['text'][4]}, non-tiny terms "
        f"T'={pruned.n_nontiny} (tiny: df <= {pruned.tiny_cap}), longest "
        f"segment {pruned.max_seg} slots; on the card: delta16 rows "
        f"{tuple(flat.shape)} {flat.nbytes / 1e6:.1f} MB, off/len/normc "
        f"{(off.nbytes + lens.nbytes + normc.nbytes) / 1e6:.1f} MB, CSR "
        f"{(csr_off.nbytes + csr_packed.nbytes) / 1e6:.1f} MB "
        f"(window cap {pruned.per_term_cap}); title packed32 rows "
        f"{pruned._row_meta['title'][:2]} + off/len {t_bytes / 1e6:.1f} MB, "
        f"title CSR {tcsr_bytes / 1e6:.1f} MB")

    # -- 4d. the pruned path: serve micro-batches ----------------------------
    reset_counts(bm25)
    p_responses, p_stage_ms, p_batch_ms, p_peak_gb = serve_batches(
        serve, pruned, batches, tagger, tokenizer, tag_dict)
    served = counts(bm25)
    d16_launches = served["delta16_rescore"]
    p_rate = report_serve("pruned", p_responses, batches, p_stage_ms,
                          p_batch_ms, p_peak_gb, f"launches {served}", card)
    expect_counts("the pruned path", served, {"delta16_rescore": None})
    check_responses(requests, p_responses, tag_dict, EOS_MARKER)
    log("retrieve stage, ms per batch: exhaustive "
        + ", ".join(f"{v:.1f}" for v in stage_ms["retrieve"])
        + "; pruned " + ", ".join(f"{v:.1f}" for v in p_stage_ms["retrieve"])
        + f"; requests/s after the first batch: exhaustive {ex_rate:.1f}, "
        f"pruned {p_rate:.1f} ({card})")

    # -- 3c. K2 against plain at the main path's shapes ----------------------
    # the arguments the served search hands K2 for the first batch, made
    # after the served run so its never-shrink query widths stay as served
    keys, fields, _, kw = pruned._device_queries(
        pruned._pack_queries(qt_np, qw_np))
    _, cand_valid, ((fn, d16),) = bm25.pass2_operands(keys, fields, **kw)
    if fn is not bm25.delta16_rescore:
        raise AssertionError(f"the pruned text field's pass 2 is {fn}")
    got = bm25.delta16_rescore(*d16)
    want = bm25.delta16_rescore_ref(*d16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    d16_err_main = float((got - want).abs().max())
    del got, want, keys, fields
    d16_eager_ms = time_cuda_ms(lambda: bm25.delta16_rescore(*d16),
                                iters=200)
    d16_ms = time_device_ms(lambda: bm25.delta16_rescore(*d16), iters=200)
    d16_cold_ms = time_cold_ms(lambda: bm25.delta16_rescore(*d16))
    d16_plain_ms = time_cuda_ms(lambda: bm25.delta16_rescore_ref(*d16),
                                iters=10)
    Q2, W2 = d16[0].shape
    C2 = d16[2].shape[1]
    d16_floor_ms = floor_ms(_kernels, "delta16_rescore", (Q2, W2, C2))
    d16_bytes, d16_ops = delta16_need(d16)
    d16_bytes_ms = d16_bytes / PEAK_BYTES_PER_S * 1e3
    d16_ops_ms = d16_ops / PEAK_INT32_OPS_PER_S * 1e3
    d16_bound_ms = max(d16_bytes_ms, d16_ops_ms)
    d16_bound_by = "bytes" if d16_bytes_ms >= d16_ops_ms else "operations"
    log(f"delta16_rescore at the serve shape Q={Q2} W={W2} C={C2} "
        f"R2={d16[-1]} ({int(cand_valid.sum())} valid candidates) ({card}): "
        f"kernel {d16_ms:.4f} ms on the device (CUDA graph, L2 warm), "
        f"{d16_cold_ms:.4f} ms after an L2 flush, {d16_eager_ms:.4f} ms "
        f"eager, launch floor {d16_floor_ms:.5f} ms, "
        f"plain {d16_plain_ms:.3f} ms, bound "
        f"{d16_bound_ms:.5f} ms by {d16_bound_by} ({d16_bytes / 1e6:.3f} MB "
        f"= {d16_bytes_ms:.5f} ms; {d16_ops / 1e6:.3f} M int32 lookups = "
        f"{d16_ops_ms:.5f} ms); max abs err {d16_err_main:.3g}")

    for label, eng in (("exhaustive", engine), ("pruned", pruned)):
        parts = retrieve_breakdown(eng, index, batches[1], bm25)
        log(f"retrieve breakdown ({label}, batch 2), ms: "
            + ", ".join(f"{k} {v:.2f}" for k, v in parts.items())
            + " (search = host prep + device + copies, host clock; device "
            f"by CUDA events) ({card})")

    # the pruned top-10 against the exhaustive top-10 on the same queries,
    # outside the counted runs
    encoded = [index.encode_queries([" ".join(r["tokens"]) for r in batch],
                                    max_query_terms=MAX_QUERY_TERMS)
               for batch in batches]
    exact = [engine.search_encoded(qt_b, qw_b, k=K) for qt_b, qw_b in encoded]
    pruned_out = [pruned.search_encoded(qt_b, qw_b, k=K)
                  for qt_b, qw_b in encoded]
    held_against_exact("pruned", exact, pruned_out)

    # -- 4e. entity-boosted retrieval: the title field -----------------------
    # each query's entity is the title of its source sentence; exhaustive
    # (K1 on both fields) against pruned (K2 on text, packed32 title rows in
    # plain torch, a second rare-term block from the title CSR)
    ents = [" ".join(f"w{t}" for t in title_docs[s]) for s in src]
    ent_blocks = [title_index.encode_queries(
        ents[i:i + BATCH], max_query_terms=MAX_QUERY_TERMS,
        boosts=[TITLE_BOOST] * len(ents[i:i + BATCH]))
        for i in range(0, len(ents), BATCH)]
    boosted, boost_ms = {}, {}
    for label, eng in (("exhaustive", engine), ("pruned", pruned)):
        reset_counts(bm25)
        outs, ms = [], []
        for (qt_b, qw_b), (tt, tw) in zip(encoded, ent_blocks):
            t0 = time.perf_counter()
            outs.append(eng.search_encoded(qt_b, qw_b, k=K, title_terms=tt,
                                           title_weights=tw))
            ms.append((time.perf_counter() - t0) * 1e3)
        boosted[label], boost_ms[label] = outs, ms
        expect_counts(
            f"entity-boosted {label} retrieval", counts(bm25),
            {"bm25_score_block": 2 * len(encoded)} if label == "exhaustive"
            else {"delta16_rescore": len(encoded)})
    changed = sum(int(set(a[1][q]) != set(b[1][q]))
                  for a, b in zip(exact, boosted["exhaustive"])
                  for q in range(a[1].shape[0]))
    if changed == 0:
        raise AssertionError("the title boost changed no exhaustive top-10")
    log(f"entity-boosted retrieval (title boost {TITLE_BOOST}, entity = the "
        f"source sentence's title): the boost changed the exhaustive top-"
        f"{K} of {changed}/{len(ents)} queries; ms per batch of {BATCH} "
        f"(host clock, search with copies): exhaustive "
        + ", ".join(f"{v:.2f}" for v in boost_ms["exhaustive"])
        + "; pruned " + ", ".join(f"{v:.2f}" for v in boost_ms["pruned"])
        + f" ({card})")
    log("entity-boosted pruned search, batch 2, device ms: "
        + pruned_device_breakdown(bm25, pruned, index.n_docs,
                                  pruned._pack_queries(*encoded[1],
                                                       *ent_blocks[1]))
        + f" ({card})")
    held_against_exact(
        "entity-boosted pruned", boosted["exhaustive"], boosted["pruned"],
        score_rtol=None, why=f"tiny_width={pruned.tiny_width} keeps a "
        "query's largest tiny-term sums only, so a document reached through "
        "its title can lack its own; the served engine's knobs")

    # -- 4f. packed32 rows, and the two-operand pruned top-k with K3 ---------
    t0 = time.perf_counter()
    p32 = RetrievalEngine(index, mode="pruned", device=dev,
                          row_layout="packed32", compact_rows=False,
                          **PRUNED_KNOBS)
    torch.cuda.synchronize()
    log(f"packed32 engine: built in {time.perf_counter() - t0:.1f} s "
        f"(set-up); rows {p32._row_meta['text']} (layout, term bits, lo, "
        f"step, R2), {sum(x.nbytes for x in p32.rows['text']) / 1e6:.1f} "
        f"MB; CSR {sum(x.nbytes for x in p32.csr['text']) / 1e6:.1f} MB")
    reset_counts(bm25)
    p32_out, p32_ms = [], []
    for qt_b, qw_b in encoded:
        t0 = time.perf_counter()
        p32_out.append(p32.search_encoded(qt_b, qw_b, k=K))
        p32_ms.append((time.perf_counter() - t0) * 1e3)
    expect_counts("the packed32 engine", counts(bm25), {})
    log("packed32 engine: ms per batch (host clock) "
        + ", ".join(f"{v:.2f}" for v in p32_ms) + "; batch 2, device ms: "
        + pruned_device_breakdown(bm25, p32, index.n_docs,
                                  p32._pack_queries(*encoded[1]))
        + f" ({card})")
    held_against_exact("packed32 pruned", exact, p32_out)

    # a two-array field of the same index: term ids [N_padded, Ld] and
    # 16-bit log codes, fed from the packed32 engine's CSR and rare terms
    n_pad = p32.n_padded - index.doc_terms.shape[0]
    codes16, lo16, step16 = log_quantize(
        np.pad(index.doc_impacts, ((0, n_pad), (0, 0))), bits=16)
    dterms = torch.from_numpy(np.pad(index.doc_terms, ((0, n_pad), (0, 0)),
                                     constant_values=-1)).to(dev)
    dcodes = torch.from_numpy(codes16.view(np.int16)).to(dev)
    del codes16
    csr_lo, csr_step = p32._csr_scale["text"]
    opts = dict(n_candidates=p32.n_candidates,
                max_dup_shifts=p32.rare_terms)

    def two_operand_pool(qt_b, qw_b):
        rare = torch.from_numpy(p32._select_rare_terms(qt_b)).to(dev)
        cd, ci = bm25.gather_pruned_candidates(
            rare, *p32.csr["text"], p32.per_term_cap, csr_lo, csr_step)
        field = (torch.from_numpy(qt_b).to(dev),
                 torch.from_numpy(qw_b).to(dev), dterms, dcodes, lo16,
                 step16)
        return cd, ci, (field,)

    reset_counts(bm25)
    two_out, two_ms = [], []
    for qt_b, qw_b in encoded:
        t0 = time.perf_counter()
        s_b, i_b = bm25.bm25_pruned_topk(*two_operand_pool(qt_b, qw_b),
                                         n_real_docs=index.n_docs, k=K,
                                         **opts)
        two_out.append((s_b.cpu().numpy(), i_b.cpu().numpy()))
        two_ms.append((time.perf_counter() - t0) * 1e3)
    two_counts = counts(bm25)
    k3_launches = two_counts["bm25_rescore"]
    expect_counts("the two-operand path", two_counts,
                  {"bm25_rescore": len(encoded)})
    log(f"two-operand pruned top-k over a two-array field ([N={dterms.shape[0]}, "
        f"Ld={dterms.shape[1]}] int32 + 16-bit codes, "
        f"{(dterms.nbytes + dcodes.nbytes) / 1e6:.1f} MB on the card): "
        f"launches {two_counts}; ms per batch (host clock) "
        + ", ".join(f"{v:.2f}" for v in two_ms) + f" ({card})")
    held_against_exact("two-operand (K3)", exact, two_out)

    # -- 3d. K3 against plain on the operands the two-operand path hands it
    _, cand_valid, _, ((fn, k3args),) = bm25.pass2_operands_two_operand(
        *two_operand_pool(*encoded[0]), **opts)
    if fn is not bm25.bm25_rescore:
        raise AssertionError(f"the two-array field's pass 2 is {fn}")
    got = bm25.bm25_rescore(*k3args)
    want = bm25.bm25_rescore_ref(*k3args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    k3_err_main = float((got - want).abs().max())
    del got, want
    k3_eager_ms = time_cuda_ms(lambda: bm25.bm25_rescore(*k3args),
                               iters=200)
    k3_ms = time_device_ms(lambda: bm25.bm25_rescore(*k3args), iters=200)
    k3_cold_ms = time_cold_ms(lambda: bm25.bm25_rescore(*k3args))
    k3_plain_ms = time_cuda_ms(lambda: bm25.bm25_rescore_ref(*k3args),
                               iters=10)
    Q3, Lq3 = k3args[0].shape
    C3 = k3args[2].shape[1]
    k3_floor_ms = floor_ms(_kernels, "bm25_rescore", (Q3, Lq3, C3))
    k3_bytes, k3_ops = rescore_need(k3args)
    k3_bytes_ms = k3_bytes / PEAK_BYTES_PER_S * 1e3
    k3_ops_ms = k3_ops / PEAK_INT32_OPS_PER_S * 1e3
    k3_bound_ms = max(k3_bytes_ms, k3_ops_ms)
    k3_bound_by = "bytes" if k3_bytes_ms >= k3_ops_ms else "operations"
    log(f"bm25_rescore on the two-operand path's operands Q={Q3} Lq={Lq3} "
        f"C={C3} Ld={k3args[3].shape[1]} ({int(cand_valid.sum())} valid "
        f"candidates, {int(torch.unique(k3args[2]).numel())} distinct) "
        f"({card}): kernel {k3_ms:.4f} ms on the device (CUDA graph, L2 "
        f"warm), {k3_cold_ms:.4f} ms after an L2 flush, {k3_eager_ms:.4f} "
        f"ms eager, launch floor {k3_floor_ms:.5f} ms, plain "
        f"{k3_plain_ms:.3f} ms, bound "
        f"{k3_bound_ms:.5f} ms by {k3_bound_by} ({k3_bytes / 1e6:.3f} MB = "
        f"{k3_bytes_ms:.5f} ms; {k3_ops / 1e6:.3f} M int32 lookups = "
        f"{k3_ops_ms:.5f} ms); max abs err {k3_err_main:.3g}")

    # -- 4g. the training path ------------------------------------------------
    del tagger, pruned, p32, dterms, dcodes
    torch.cuda.empty_cache()
    log(f"phases 1-4f in {time.perf_counter() - t_start:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t_phase = time.perf_counter()
        training_phase(engine, requests, bm25, dev, card, tokenizer,
                       XLMRConfig.large(vocab_size=HASH_VOCAB,
                                        param_dtype=torch.float32), tmp)
        log(f"phase 4g in {time.perf_counter() - t_phase:.1f} s")
        torch.cuda.empty_cache()
        # -- 4h. the offline KB stage, with 4g's trained model -------------
        t_phase = time.perf_counter()
        pruned_1m, store_1m = kb_stage_phase(
            engine, docs, title_docs, encoded, exact, requests, bm25, dev,
            card, tmp, f"{tmp}/b")
        log(f"phase 4h in {time.perf_counter() - t_phase:.1f} s")
        # -- 4q. the HF tokenizer over 4h's saved KB and 4g's checkpoint ---
        torch.cuda.empty_cache()
        hf_tokenizer_phase(cli, bm25, dev, card, Path(tmp), engine, requests,
                           f"{tmp}/b", pruned_1m)
        del pruned_1m
        store_1m.close()
        # -- 4r. the quality gates, the walkthrough through K1, SGDW -------
        torch.cuda.empty_cache()
        surface = surface_phase(bm25, dev, card, Path(tmp))
        # -- 4i. MIX retrieval over three language KBs, staged training ----
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        cut = cut_encoder(Path(tmp))
        mix = mix_stage_phase(cli, bm25, dev, card, Path(tmp),
                              Path(tmp) / "model.yaml", encoder=cut)
        log(f"phase 4i in {time.perf_counter() - t_phase:.1f} s")
        # -- 4j. ACE over the published stack, ensemble, evaluate, speed ----
        torch.cuda.empty_cache()
        ace = ace_stage_phase(cli, bm25, dev, card, Path(tmp), encoder=cut)
        drop_checkpoints(Path(tmp))
        # -- 4k. distillation from two teachers, SWAF ----------------------
        torch.cuda.empty_cache()
        kd = kd_stage_phase(cli, bm25, dev, card, Path(tmp), encoder=cut)
        drop_checkpoints(Path(tmp))
        # -- 4l. the streamed, sharded index; a pretrained checkpoint -------
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        stream = streamed_index_phase(
            bm25, dev, card, Path(tmp), docs, index, encoded_s,
            [" ".join(r["tokens"]) for r in batches[0]], exact[0],
            pruned_out[0])
        checkpoint_phase(cli, dev, card, Path(tmp))
        log(f"phase 4l in {time.perf_counter() - t_phase:.1f} s")
        drop_checkpoints(Path(tmp))
        # -- 4m. the parser and classifier families --------------------------
        torch.cuda.empty_cache()
        parse = parse_stage_phase(cli, bm25, dev, card, Path(tmp), cut,
                                  encoder=cut)
        drop_checkpoints(Path(tmp))
        # -- 4n. ELMo and BPEmb at published widths, pooled Flair, MFVI -------
        torch.cuda.empty_cache()
        elmo_stage_phase(cli, bm25, dev, card, Path(tmp), encoder=cut)
        drop_checkpoints(Path(tmp))
        # -- 4o. the sharded engines on gloo ranks; topc_recall -------------
        torch.cuda.empty_cache()
        shard = sharded_stage_phase(bm25, dev, card, Path(tmp), index,
                                    encoded, ent_blocks, exact, boosted,
                                    pruned_out, boost_ms)
        # -- 4p. sharded training on gloo ranks: DP, TP, FSDP -----------------
        torch.cuda.empty_cache()
        mesh_stage_phase(bm25, card, Path(tmp))
        drop_checkpoints(Path(tmp))

    # -- 5. kernels ----------------------------------------------------------
    kernels = [{
        "name": "bm25_score_block",
        "route": "cuda",
        "source": "kbner_tpu_torch/csrc/bm25_score.cu",
        "replaces": "kbner_tpu/ops/bm25.py:84",
        "launches": launches,
        "mix_launches": mix["k1_mix_launches"],
        "ace_launches": ace["k1_launches"],
        "kd_launches": kd["k1_launches"],
        "stream_launches": stream["k1"],
        "parse_launches": parse["k1_launches"],
        "shard_launches": shard["k1"],
        "walkthrough_launches": surface["k1_launches"],
        "max_abs_err": max(err_cases, k1["err"], k1_title["err"],
                           shard["k1_err"]),
        "ms": k1["dev_ms"],
        "cold_ms": k1["cold_ms"],
        "eager_ms": k1["ms"],
        "launch_floor_ms": k1_floor_ms,
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": None,
    }, {
        "name": "delta16_rescore",
        "route": "cuda",
        "source": "kbner_tpu_torch/csrc/delta16_rescore.cu",
        "replaces": "kbner_tpu/ops/bm25.py:248",
        "launches": d16_launches,
        "mix_launches": mix["mix_launches"],
        "stream_launches": stream["k2"],
        "shard_launches": shard["k2"],
        "max_abs_err": max(d16_err_cases, d16_err_main, shard["k2_err"]),
        "ms": d16_ms,
        "cold_ms": d16_cold_ms,
        "eager_ms": d16_eager_ms,
        "launch_floor_ms": d16_floor_ms,
        "plain_ms": d16_plain_ms,
        "bound_ms": d16_bound_ms,
        "bound_by": d16_bound_by,
        "library_ms": None,
    }, {
        "name": "bm25_rescore",
        "route": "cuda",
        "source": "kbner_tpu_torch/csrc/bm25_rescore.cu",
        "replaces": "kbner_tpu/ops/bm25.py:157",
        "launches": k3_launches,
        "max_abs_err": max(k3_err_cases, k3_err_main),
        "ms": k3_ms,
        "cold_ms": k3_cold_ms,
        "eager_ms": k3_eager_ms,
        "launch_floor_ms": k3_floor_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": k3_bound_ms,
        "bound_by": k3_bound_by,
        "library_ms": None,
    }]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
