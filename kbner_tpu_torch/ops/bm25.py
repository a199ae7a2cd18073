"""BM25 scoring (counterpart of ``kbner_tpu/ops/bm25.py``): exhaustive
match-and-accumulate with a running top-k, and the two-pass pruned top-k
over every pass-2 row layout of the reference.

The index is laid out as dense padded per-document (term id, impact) slots,
transposed to ``[Ld, N]`` so the document axis is the contiguous one, and
scoring is

  score[q, d] = sum_l sum_j impacts[j, d] * w[q, l] * [terms[j, d] == qt[q, l]]

with negative ids (doc pad -1, query pad / OOV -2) never matching.

Two implementations with the same semantics:
  * :func:`bm25_score_block_ref` — plain PyTorch, the CPU path and the
    reference the kernel is held against;
  * :func:`bm25_score_block` — the wrapper of the hand-written CUDA kernel
    ``csrc/bm25_score.cu``. It takes the plain version only for CPU
    tensors; for CUDA tensors it launches the kernel or raises.

Multi-field queries (ES ``bool.should`` over text and title) are score sums
over fields; :func:`bm25_topk` adds them before the top-k.

The pruned path (:func:`bm25_pruned_topk_packed`) pools pass-1 candidates
as int64 sort keys ``(doc << 8) | code8`` (the reference's uint32 keys,
widened: torch has no ``>>`` for uint32 on the CPU), keeps the top C by
their summed codes, and rescores them over the engine's pass-2 rows: the
delta16 rows with K2 (:func:`delta16_rescore_ref` is its plain version,
:func:`delta16_rescore` the wrapper of ``csrc/delta16_rescore.cu``), the
packed32 rows in plain PyTorch, as the reference leaves them to XLA. The
two-operand pruned top-k (:func:`bm25_pruned_topk`, fed by
:func:`gather_pruned_candidates`) pools (doc, impact) pairs instead and
rescores a two-array field (term ids plus 16-bit log codes) with K3
(:func:`bm25_rescore_ref`, :func:`bm25_rescore`,
``csrc/bm25_rescore.cu``). Every wrapper follows K1's rule.
"""

from __future__ import annotations

import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import _kernels

# One field's operands: (q_terms [Q, Lq] int32, q_weights [Q, Lq] float32,
#                        doc_terms_t [Ld, N] int32, doc_impacts_t [Ld, N] f32)
FieldOperands = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def bm25_score_block_ref(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    doc_terms_t: torch.Tensor,
    doc_impacts_t: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch scores ``[Q, N]`` float32 (counterpart of
    ``bm25_score_block_xla``). One ``[Q, Ld, N]`` compare per query-term
    slot, so memory stays at one slot's match tile."""
    Q, Lq = q_terms.shape
    N = doc_terms_t.shape[1]
    out = torch.zeros((Q, N), dtype=torch.float32, device=doc_terms_t.device)
    for l in range(Lq):
        t = q_terms[:, l, None, None]  # [Q, 1, 1]
        match = (doc_terms_t.unsqueeze(0) == t) & (t >= 0)  # [Q, Ld, N]
        contrib = torch.where(match, doc_impacts_t.unsqueeze(0), 0.0).sum(1)
        out += q_weights[:, l, None] * contrib
    return out


_NAMES = ("q_terms", "q_weights", "doc_terms_t", "doc_impacts_t")


def _check_device(qt, qw, dt, di) -> None:
    dev = dt.device
    for name, x in zip(_NAMES, (qt, qw, dt, di)):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(
                f"bm25_score_block: {name} is on {x.device}; all operands "
                "must lie on one CUDA device (or all on the CPU)")


def _check_layout(qt, qw, dt, di) -> None:
    """Shapes, types and strides the kernel takes."""
    for name, x in zip(_NAMES, (qt, qw, dt, di)):
        if x.dim() != 2:
            raise ValueError(f"bm25_score_block: {name} must be 2-D, got "
                             f"shape {tuple(x.shape)}")
    for name, x, want in zip(_NAMES, (qt, qw, dt, di),
                             (torch.int32, torch.float32, torch.int32,
                              torch.float32)):
        if x.dtype != want:
            raise ValueError(f"bm25_score_block: {name} must be {want}, "
                             f"got {x.dtype}")
    if qt.shape != qw.shape:
        raise ValueError("bm25_score_block: q_terms and q_weights differ in "
                         f"shape: {tuple(qt.shape)} vs {tuple(qw.shape)}")
    if dt.shape != di.shape:
        raise ValueError("bm25_score_block: doc_terms_t and doc_impacts_t "
                         f"differ in shape: {tuple(dt.shape)} vs "
                         f"{tuple(di.shape)}")
    if not (qt.is_contiguous() and qw.is_contiguous()):
        raise ValueError("bm25_score_block: query operands must be "
                         "contiguous")
    if dt.stride() != di.stride() or dt.stride(1) != 1 \
            or dt.stride(0) < dt.shape[1]:
        raise ValueError(
            "bm25_score_block: doc operands must be row-major with unit "
            "column stride and equal strides (a doc-axis slice of a "
            f"contiguous [Ld, N] array); got {dt.stride()} and "
            f"{di.stride()}")
    if max(qt.shape[0], qt.shape[1], dt.shape[0], dt.shape[1]) >= 2**31:
        raise ValueError("bm25_score_block: a dimension exceeds int32")


def _launcher():
    lib = _kernels.load("bm25_score")
    fn = lib.bm25_score_block_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def bm25_score_block(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    doc_terms_t: torch.Tensor,
    doc_impacts_t: torch.Tensor,
) -> torch.Tensor:
    """Scores ``[Q, N]`` float32. CUDA tensors go through the hand-written
    kernel (``csrc/bm25_score.cu``) on the current stream; CPU tensors
    through :func:`bm25_score_block_ref`. ``bm25_score_block.launches``
    counts kernel launches."""
    ops = (q_terms, q_weights, doc_terms_t, doc_impacts_t)
    if all(x.device.type == "cpu" for x in ops):
        return bm25_score_block_ref(*ops)
    _check_device(*ops)
    _check_layout(*ops)
    Q, Lq = q_terms.shape
    Ld, N = doc_terms_t.shape
    out = torch.empty((Q, N), dtype=torch.float32, device=doc_terms_t.device)
    if Q == 0 or N == 0:
        return out
    launch = _launcher()
    stream = torch.cuda.current_stream(doc_terms_t.device).cuda_stream
    err = launch(q_terms.data_ptr(), q_weights.data_ptr(),
                 doc_terms_t.data_ptr(), doc_impacts_t.data_ptr(),
                 out.data_ptr(), Q, Lq, Ld, N, doc_terms_t.stride(0), stream)
    if err != 0:
        raise RuntimeError(
            f"bm25_score_block: kernel launch failed with CUDA error {err}")
    bm25_score_block.launches += 1
    return out


bm25_score_block.launches = 0


def _score_fields(fields: Sequence[FieldOperands], start: int,
                  width: int) -> torch.Tensor:
    """Sum of per-field scores over documents ``[start, start + width)``."""
    total = None
    for qt, qw, dtt, dit in fields:
        s = bm25_score_block(qt, qw, dtt[:, start:start + width],
                             dit[:, start:start + width])
        total = s if total is None else total + s
    return total


def merge_topk(
    scores_a: torch.Tensor, ids_a: torch.Tensor,
    scores_b: torch.Tensor, ids_b: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two per-query top-k lists -> top-k of the union, the earlier
    position first among equal scores (``lax.top_k`` over the
    concatenation: list a's entries before list b's)."""
    scores = torch.cat([scores_a, scores_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1)
    top_scores, idx = _top_sorted(scores, k)
    return top_scores, torch.gather(ids, 1, idx)


def _ties_by_id(scores: torch.Tensor, ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A top-k's rows with each run of equal scores in ascending id order
    (``torch.topk`` promises no order among equals)."""
    ids, perm = torch.sort(ids, dim=1)
    scores, perm2 = torch.sort(torch.gather(scores, 1, perm), dim=1,
                               descending=True, stable=True)
    return scores, torch.gather(ids, 1, perm2)


# tied rows refilled at once: bounds the [rows, N] temporaries of a refill
REFILL_ROWS = 64


def _row_topk(scores: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``k`` of a stable descending sort of each row of
    ``scores`` [Q, N] (``lax.top_k``'s set and order), without sorting
    the row: ``torch.topk`` takes k + 1, and only in the rows whose k-th
    and (k+1)-th scores are equal is the tied run refilled from the lowest
    positions that carry that score (a smallest-k over the row's int32
    positions, N elsewhere). Finding those rows waits for the device
    once."""
    n = scores.shape[1]
    if not 0 < k < n:
        return _top_sorted(scores, min(k, n))
    top_s, top_i = torch.topk(scores, k + 1, dim=1)
    s, i = _ties_by_id(top_s[:, :k], top_i[:, :k])
    tied = torch.nonzero(top_s[:, k - 1] == top_s[:, k]).flatten()
    if tied.numel():
        t = top_s[tied, k - 1:k]                     # [R, 1] the k-th score
        pos = torch.arange(n, dtype=torch.int32, device=scores.device)
        lowest = torch.cat([
            torch.topk(torch.where(scores[rows] == tr, pos, n), k, dim=1,
                       largest=False).values
            for rows, tr in zip(tied.split(REFILL_ROWS),
                                t.split(REFILL_ROWS))]).long()
        above = (s[tied] > t).sum(dim=1, keepdim=True)   # kept as they are
        j = torch.arange(k, device=scores.device)
        keep = j < above
        s[tied] = torch.where(keep, s[tied], t)
        i[tied] = torch.where(keep, i[tied], torch.gather(
            lowest, 1, (j - above).clamp(min=0)))
    return s, i


def bm25_topk(
    fields: Sequence[FieldOperands],
    k: int = 10,
    doc_chunk: Optional[int] = None,
    id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k BM25 (scores float32, doc ids int64) per query over the whole
    collection.

    ``fields`` is a non-empty sequence of per-field operands whose scores
    are added. With ``doc_chunk`` the document axis is scanned in pieces of
    that size with a running top-k merge, bounding memory at
    ``[Q, doc_chunk]`` instead of ``[Q, N]``. ``id_offset`` shifts the
    returned ids. The result is ``lax.top_k``'s, ids and order: where
    equal scores straddle the k-th place the lowest ids among them are
    kept, and equal scores come back lower id first (chunked, the running
    list holds lower ids than every later chunk, and the merge prefers it).
    """
    fields = tuple(fields)
    Q = fields[0][0].shape[0]
    N = fields[0][2].shape[1]

    if doc_chunk is None or doc_chunk >= N:
        top_scores, top_ids = _row_topk(_score_fields(fields, 0, N), k)
        return top_scores, top_ids + id_offset

    if N % doc_chunk != 0:
        raise ValueError(f"N={N} must be a multiple of doc_chunk={doc_chunk}")
    dev = fields[0][2].device
    run_scores = torch.full((Q, k), float("-inf"), dtype=torch.float32,
                            device=dev)
    run_ids = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, N, doc_chunk):
        c_scores, c_ids = _row_topk(_score_fields(fields, start, doc_chunk),
                                    min(k, doc_chunk))
        run_scores, run_ids = merge_topk(
            run_scores, run_ids, c_scores, c_ids + (start + id_offset), k)
    return run_scores, run_ids


# -- two-pass pruned search (MaxScore-style) -----------------------------------

KEY_PAD = 0xFFFFFFFF  # pad of the pass-1 sort keys: sorts after every key
LANES = 128           # slots per row of the CSR and of the delta16 rows


def _delta16_norm(code: torch.Tensor, k1: float, b: float,
                  avgdl: float) -> torch.Tensor:
    """BM25 length norm from the 1-byte Lucene norm code, in float32 as
    the reference computes it: dl = (bits | 8) << shift."""
    code = code.to(torch.int32)
    bits = (code & 7).to(torch.float32)
    shift = (code >> 3) - 1
    dl = torch.where(shift < 0, bits,
                     (bits + 8.0) * torch.exp2(shift.to(torch.float32)))
    return k1 * ((1.0 - b) + b * dl / avgdl)


def delta16_rescore_ref(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    cand: torch.Tensor,
    flat: torch.Tensor,
    doc_off: torch.Tensor,
    doc_len: torch.Tensor,
    norm_code: torch.Tensor,
    k1: float,
    b: float,
    avgdl: float,
    r2: int,
) -> torch.Tensor:
    """Plain PyTorch pass-2 BM25 ``[Q, C]`` float32 of each candidate
    ``cand [Q, C]`` over its delta16 segment (counterpart of the delta16
    branch of ``_rescore_candidates``, any ``r2 >= 1``).

    Each 16-bit slot is ``(gap13 << 3) | tf3``; the term ids of a segment
    are the inclusive prefix sum of its gaps over the ``r2`` covering rows
    (gaps before the segment start zeroed), a slot counts when it lies in
    ``[off, off + len)`` with tf > 0, and a matched slot adds
    ``qw * tf / (tf + norm)``."""
    Q, C = cand.shape
    lanes = flat.shape[1]
    ids = cand.long()
    off = doc_off[ids].long()
    ln = doc_len[ids].long()
    norm = _delta16_norm(norm_code[ids], k1, b, avgdl)  # [Q, C]
    row = (off // lanes)[:, :, None] + torch.arange(r2, device=cand.device)
    v = flat[row].to(torch.int32) & 0xFFFF  # [Q, C, r2, lanes]
    lane = torch.arange(lanes, device=cand.device)
    g = row[..., None] * lanes + lane  # global slot index
    after = g >= off[:, :, None, None]
    seg = after & (g < (off + ln)[:, :, None, None])
    S = r2 * lanes  # slots of the covering rows, in order
    gap = torch.where(after, v >> 3, 0).reshape(Q, C, S)
    tid = torch.cumsum(gap, dim=-1)
    tf3 = (v & 7).reshape(Q, C, S)
    valid = seg.reshape(Q, C, S) & (tf3 > 0)
    tf = tf3.to(torch.float32)
    dt_rows = torch.where(valid, tid, -1)
    di_rows = torch.where(valid, tf / (tf + norm[:, :, None]), 0.0)
    total = torch.zeros((Q, C), dtype=torch.float32, device=cand.device)
    for w in range(q_terms.shape[1]):
        t = q_terms[:, w].long()[:, None, None]
        m = (dt_rows == t) & (t >= 0)
        total = total + q_weights[:, w, None] * torch.where(
            m, di_rows, 0.0).sum(-1)
    return total


_D16_NAMES = ("q_terms", "q_weights", "cand", "flat", "doc_off", "doc_len",
              "norm_code")
_D16_TYPES = (torch.int32, torch.float32, torch.int32, torch.int16,
              torch.int32, torch.int32, torch.uint8)
_D16_MAX_TERMS = 6144  # a 16384-entry term table: 128 KB of shared memory


def _check_d16_device(ops) -> None:
    dev = ops[3].device
    for name, x in zip(_D16_NAMES, ops):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(
                f"delta16_rescore: {name} is on {x.device}; all operands "
                "must lie on one CUDA device (or all on the CPU)")


def _check_d16_layout(ops, r2: int) -> None:
    """Shapes, types and strides K2 takes."""
    for name, x, want in zip(_D16_NAMES, ops, _D16_TYPES):
        if x.dtype != want:
            raise ValueError(f"delta16_rescore: {name} must be {want}, got "
                             f"{x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"delta16_rescore: {name} must be contiguous")
    qt, qw, cand, flat, off, ln, nc = ops
    if qt.dim() != 2 or qt.shape != qw.shape:
        raise ValueError("delta16_rescore: q_terms and q_weights must be "
                         f"[Q, W], got {tuple(qt.shape)} and "
                         f"{tuple(qw.shape)}")
    if cand.dim() != 2 or cand.shape[0] != qt.shape[0]:
        raise ValueError(f"delta16_rescore: cand must be [Q, C] with "
                         f"Q={qt.shape[0]}, got {tuple(cand.shape)}")
    if flat.dim() != 2 or flat.shape[1] != LANES:
        raise ValueError(f"delta16_rescore: flat must be [NR, {LANES}], got "
                         f"{tuple(flat.shape)}")
    if flat.data_ptr() % 8:
        raise ValueError("delta16_rescore: flat must be 8-byte aligned")
    if not (off.dim() == ln.dim() == nc.dim() == 1
            and off.shape == ln.shape == nc.shape):
        raise ValueError("delta16_rescore: doc_off, doc_len and norm_code "
                         "must be [N] each")
    if qt.shape[1] > _D16_MAX_TERMS:
        raise ValueError(f"delta16_rescore: W={qt.shape[1]} query terms "
                         f"exceed {_D16_MAX_TERMS}")
    if qt.shape[0] >= 65536 or cand.shape[1] >= 2**31 or r2 < 1:
        raise ValueError(f"delta16_rescore: Q={qt.shape[0]} must be below "
                         f"65536 and r2={r2} at least 1")


def _d16_launcher():
    lib = _kernels.load("delta16_rescore")
    fn = lib.delta16_rescore_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, f, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def delta16_rescore(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    cand: torch.Tensor,
    flat: torch.Tensor,
    doc_off: torch.Tensor,
    doc_len: torch.Tensor,
    norm_code: torch.Tensor,
    k1: float,
    b: float,
    avgdl: float,
    r2: int,
) -> torch.Tensor:
    """Pass-2 scores ``[Q, C]`` float32 of :func:`delta16_rescore_ref`.
    CUDA tensors go through the hand-written kernel
    (``csrc/delta16_rescore.cu``, which gathers the rows itself) on the
    current stream; CPU tensors through the plain version.
    ``delta16_rescore.launches`` counts kernel launches."""
    ops = (q_terms, q_weights, cand, flat, doc_off, doc_len, norm_code)
    if all(x.device.type == "cpu" for x in ops):
        return delta16_rescore_ref(*ops, k1, b, avgdl, r2)
    _check_d16_device(ops)
    _check_d16_layout(ops, r2)
    Q, W = q_terms.shape
    C = cand.shape[1]
    out = torch.empty((Q, C), dtype=torch.float32, device=cand.device)
    if Q == 0 or C == 0:
        return out
    launch = _d16_launcher()
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    # 1 - b in double and then float32, as the reference folds it
    err = launch(*(x.data_ptr() for x in ops), out.data_ptr(), Q, W, C,
                 r2, k1, 1.0 - b, b, avgdl, stream)
    if err != 0:
        raise RuntimeError(
            f"delta16_rescore: kernel launch failed with CUDA error {err}")
    delta16_rescore.launches += 1
    return out


delta16_rescore.launches = 0


def _f32(x) -> float:
    """``x`` rounded to float32, as the reference rounds its scales."""
    return float(torch.tensor(float(x), dtype=torch.float32))


def _dequantize(code: torch.Tensor, lo: float, step: float) -> torch.Tensor:
    """``exp(lo + (code - 1) * step)`` where ``code > 0``, else 0, in
    float32 in the reference's order (``lo`` and ``step`` rounded to
    float32 first)."""
    c = code.to(torch.float32)
    return torch.where(code > 0,
                       torch.exp(_f32(lo) + (c - 1.0) * _f32(step)), 0.0)


def _match_sum(q_terms: torch.Tensor, q_weights: torch.Tensor,
               dt_rows: torch.Tensor, di_rows: torch.Tensor) -> torch.Tensor:
    """``sum_l qw[:, l] * sum_j [dt_rows == qt[:, l]] * di_rows`` over
    candidate rows ``[Q, C, S]`` -> ``[Q, C]``: the reference's last loop
    of ``_rescore_candidates``. Ids are compared raw (a -1 query pad
    matches a -1 row pad, which must carry 0)."""
    Q, C = dt_rows.shape[:2]
    total = torch.zeros((Q, C), dtype=torch.float32, device=dt_rows.device)
    for l in range(q_terms.shape[1]):
        m = dt_rows == q_terms[:, l].to(dt_rows.dtype)[:, None, None]
        total = total + q_weights[:, l, None] * torch.where(
            m, di_rows, 0.0).sum(-1)
    return total


def bm25_rescore_ref(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    cand: torch.Tensor,
    doc_terms: torch.Tensor,
    doc_codes: torch.Tensor,
    lo: float,
    step: float,
) -> torch.Tensor:
    """Plain PyTorch pass-2 BM25 ``[Q, C]`` float32 of each candidate
    ``cand [Q, C]`` over the two-array layout (counterpart of
    ``bm25_rescore_pallas`` and of the two-array branch of
    ``_rescore_candidates``): its doc-major row of term ids ``doc_terms
    [N, Ld]`` int32 and 16-bit log codes ``doc_codes [N, Ld]`` (int16
    holding the raw bits, read as unsigned), dequantized as
    ``exp(lo + (code - 1) * step)``."""
    ids = cand.long()
    codes = doc_codes[ids].to(torch.int32) & 0xFFFF
    return _match_sum(q_terms, q_weights, doc_terms[ids],
                      _dequantize(codes, lo, step))


_K3_NAMES = ("q_terms", "q_weights", "cand", "doc_terms", "doc_codes")
_K3_TYPES = (torch.int32, torch.float32, torch.int32, torch.int32,
             torch.int16)
_K3_MAX_TERMS = 6144  # a 16384-entry term table: 128 KB of shared memory


def _check_k3_device(ops) -> None:
    dev = ops[3].device
    for name, x in zip(_K3_NAMES, ops):
        if x.device != dev or dev.type != "cuda":
            raise ValueError(
                f"bm25_rescore: {name} is on {x.device}; all operands must "
                "lie on one CUDA device (or all on the CPU)")


def _check_k3_layout(ops) -> None:
    """Shapes, types and strides K3 takes."""
    for name, x, want in zip(_K3_NAMES, ops, _K3_TYPES):
        if x.dtype != want:
            raise ValueError(f"bm25_rescore: {name} must be {want}, got "
                             f"{x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"bm25_rescore: {name} must be 2-D, got shape "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"bm25_rescore: {name} must be contiguous")
    qt, qw, cand, dt, dc = ops
    if qt.shape != qw.shape:
        raise ValueError("bm25_rescore: q_terms and q_weights must be "
                         f"[Q, Lq], got {tuple(qt.shape)} and "
                         f"{tuple(qw.shape)}")
    if cand.shape[0] != qt.shape[0]:
        raise ValueError(f"bm25_rescore: cand must be [Q, C] with "
                         f"Q={qt.shape[0]}, got {tuple(cand.shape)}")
    if dt.shape != dc.shape:
        raise ValueError("bm25_rescore: doc_terms and doc_codes must be "
                         f"[N, Ld] each, got {tuple(dt.shape)} and "
                         f"{tuple(dc.shape)}")
    if qt.shape[1] > _K3_MAX_TERMS:
        raise ValueError(f"bm25_rescore: Lq={qt.shape[1]} query terms "
                         f"exceed {_K3_MAX_TERMS}")
    if qt.shape[0] >= 65536 or max(cand.shape[1], dt.shape[1]) >= 2**31:
        raise ValueError(f"bm25_rescore: Q={qt.shape[0]} must be below "
                         "65536 and C, Ld below 2**31")


def _k3_launcher():
    lib = _kernels.load("bm25_rescore")
    fn = lib.bm25_rescore_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def bm25_rescore(
    q_terms: torch.Tensor,
    q_weights: torch.Tensor,
    cand: torch.Tensor,
    doc_terms: torch.Tensor,
    doc_codes: torch.Tensor,
    lo: float,
    step: float,
) -> torch.Tensor:
    """Pass-2 scores ``[Q, C]`` float32 of :func:`bm25_rescore_ref`. CUDA
    tensors go through the hand-written kernel (``csrc/bm25_rescore.cu``,
    which gathers each candidate's rows itself) on the current stream;
    CPU tensors through the plain version. ``cand`` must hold ids in
    ``[0, N)``. ``bm25_rescore.launches`` counts kernel launches."""
    ops = (q_terms, q_weights, cand, doc_terms, doc_codes)
    if all(x.device.type == "cpu" for x in ops):
        return bm25_rescore_ref(*ops, lo, step)
    _check_k3_device(ops)
    _check_k3_layout(ops)
    Q, Lq = q_terms.shape
    C = cand.shape[1]
    out = torch.empty((Q, C), dtype=torch.float32, device=cand.device)
    if Q == 0 or C == 0:
        return out
    launch = _k3_launcher()
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = launch(*(x.data_ptr() for x in ops), out.data_ptr(), Q, Lq, C,
                 doc_terms.shape[1], _f32(lo), _f32(step), stream)
    if err != 0:
        raise RuntimeError(
            f"bm25_rescore: kernel launch failed with CUDA error {err}")
    bm25_rescore.launches += 1
    return out


bm25_rescore.launches = 0


def _rescore_packed32(q_terms, q_weights, cand, flat, doc_off, doc_len,
                      term_bits: int, lo: float, step: float,
                      r2: int) -> torch.Tensor:
    """Pass 2 over ragged packed32 rows (``(code << term_bits) | term``
    int32 slots, each document a segment ``[off, off + len)`` of the flat
    ``[NR, lanes]`` rows, read through its ``r2`` covering rows) in plain
    PyTorch, as the reference leaves it to XLA. Slots outside the segment
    keep their ids but carry 0. Codes come out of a logical shift."""
    Q, C = cand.shape
    lanes = flat.shape[1]
    ids = cand.long()
    off = doc_off[ids].long()
    ln = doc_len[ids].long()
    rows = (off // lanes)[:, :, None] + torch.arange(r2, device=cand.device)
    v = flat[torch.clamp(rows, max=flat.shape[0] - 1)]  # [Q, C, r2, lanes]
    g = rows[..., None] * lanes + torch.arange(lanes, device=cand.device)
    seg = (g >= off[:, :, None, None]) & (g < (off + ln)[:, :, None, None])
    dt_rows = (v & ((1 << term_bits) - 1)).reshape(Q, C, -1)
    code = (v.long() & 0xFFFFFFFF) >> term_bits
    di_rows = torch.where(seg, _dequantize(code, lo, step), 0.0)
    return _match_sum(q_terms, q_weights, dt_rows, di_rows.reshape(Q, C, -1))


def _rescore_packed_dense(q_terms, q_weights, cand, packed_rows,
                          term_bits: int, lo: float,
                          step: float) -> torch.Tensor:
    """Pass 2 over dense packed rows ``[N, Ld]`` int32 ``(code <<
    term_bits) | term`` (pad -1) in plain PyTorch: one row gather, codes
    from a logical shift."""
    rows = packed_rows[cand.long()]  # [Q, C, Ld]
    code = (rows.long() & 0xFFFFFFFF) >> term_bits
    return _match_sum(q_terms, q_weights, rows & ((1 << term_bits) - 1),
                      _dequantize(code, lo, step))


def _rescore_f32(q_terms, q_weights, cand, doc_terms,
                 doc_impacts) -> torch.Tensor:
    """Pass 2 over the float32 layout (``doc_terms`` / ``doc_impacts``
    ``[N, Ld]``) in plain PyTorch."""
    ids = cand.long()
    return _match_sum(q_terms, q_weights, doc_terms[ids], doc_impacts[ids])


def _clamped(safe_ids: torch.Tensor, per_doc: torch.Tensor) -> torch.Tensor:
    """Candidate ids as int32, those outside the doc axis of ``per_doc``
    clamped into it, as an XLA gather clamps them (the pad
    slots of an aligned CSR window re-encode to a key of doc 0xFFFFFF that
    pass 1 keeps; its score is masked afterwards)."""
    return torch.clamp(safe_ids, 0, per_doc.shape[0] - 1).to(
        torch.int32).contiguous()


def _rescore_operands(safe_ids: torch.Tensor, fields: Sequence[tuple],
                      ragged_rows: Sequence[int]) -> List[tuple]:
    """Pass 2 of every field as ``(function, arguments)``, dispatched on
    the field's layout as the reference's ``_rescore_candidates`` does:

    * 9-tuple delta16 ``(qt, qw, flat, off, len, norm_code, k1, b,
      avgdl)`` -> K2 (:func:`delta16_rescore`);
    * 8-tuple ragged packed32 ``(qt, qw, flat, off, len, term_bits, lo,
      step)`` -> plain PyTorch;
    * 6-tuple whose 4th entry is a scalar, the dense packed form ``(qt,
      qw, packed_rows, term_bits, lo, step)`` -> plain PyTorch;
    * 6-tuple two-array ``(qt, qw, doc_terms, doc_codes, lo, step)`` ->
      K3 (:func:`bm25_rescore`);
    * 4-tuple float32 ``(qt, qw, doc_terms, doc_impacts)`` -> plain.

    ``ragged_rows[f]`` is field f's count of covering rows (default 1)."""
    ops = []
    for f, field in enumerate(fields):
        r2 = ragged_rows[f] if f < len(ragged_rows) else 1
        qt, qw = field[:2]
        if len(field) == 9:
            flat, off, ln, nc, k1, b, avgdl = field[2:]
            ops.append((delta16_rescore, (qt, qw, _clamped(safe_ids, off),
                                          flat, off, ln, nc, k1, b, avgdl,
                                          r2)))
        elif len(field) == 8:
            flat, off, ln, term_bits, lo, step = field[2:]
            ops.append((_rescore_packed32, (qt, qw, _clamped(safe_ids, off),
                                            flat, off, ln, term_bits, lo,
                                            step, r2)))
        elif len(field) == 6 and not (torch.is_tensor(field[3])
                                      and field[3].dim() > 0):
            rows, term_bits, lo, step = field[2:]
            ops.append((_rescore_packed_dense,
                        (qt, qw, _clamped(safe_ids, rows), rows,
                         int(term_bits), lo, step)))
        elif len(field) == 6:
            dterms, dcodes, lo, step = field[2:]
            ops.append((bm25_rescore, (qt, qw, _clamped(safe_ids, dterms),
                                       dterms, dcodes, lo, step)))
        elif len(field) == 4:
            dterms, dimps = field[2:]
            ops.append((_rescore_f32, (qt, qw, _clamped(safe_ids, dterms),
                                       dterms, dimps)))
        else:
            raise ValueError(f"field {f}: no pass-2 layout has "
                             f"{len(field)} operands")
    return ops


def _sum_pass2(safe_ids: torch.Tensor, rescore: Sequence[tuple]
               ) -> torch.Tensor:
    """The sum over fields of the ``(function, arguments)`` pairs of
    :func:`_rescore_operands`: ``[Q, C]`` float32."""
    total = torch.zeros(safe_ids.shape, dtype=torch.float32,
                        device=safe_ids.device)
    for fn, args in rescore:
        total = total + fn(*args)
    return total


def _rescore_candidates(safe_ids: torch.Tensor, fields: Sequence[tuple],
                        ragged_rows: Sequence[int] = ()) -> torch.Tensor:
    """Pass-2 scores ``[Q, C]`` of the candidates ``safe_ids`` summed over
    the fields (counterpart of the reference's ``_rescore_candidates``,
    every layout of :func:`_rescore_operands`)."""
    return _sum_pass2(safe_ids,
                      _rescore_operands(safe_ids, fields, ragged_rows))


def _top_sorted(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` largest of each row, lower index first among equals (the
    order ``lax.top_k`` gives; ``torch.topk`` promises none)."""
    vals, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], pos[:, :n]


def approx_topk_reduction_size(input_size: int, k: int, recall_target: float,
                               rank: int = 2) -> Tuple[int, int]:
    """XLA's reduction size of an approximate top-k (``ApproxTopK``'s
    ``approx_top_k_reduction_output_size`` with ``aggregate_to_topk``
    false): ``(reduced_size, log2_reduction)``. The last axis of an
    operand of ``rank`` dimensions is folded into ``reduced_size`` bins,
    ``2 ** log2_reduction`` elements each, so that a top-k element shares
    its bin with no other top-k element with probability about
    ``recall_target`` (``(1 - 1/M) ** (k - 1) ~ exp((1 - k) / M)`` for M
    bins, arXiv 2206.14286). ``reduced_size`` is a multiple of the TPU
    tiling (128 lanes, 1024 for rank 1) and ``log2_reduction`` 0 means
    no reduction. The target is rounded to float32 first, as XLA takes
    it."""
    tiling = 1024 if rank == 1 else 128
    if input_size <= tiling:
        return input_size, 0
    r = float(np.float32(recall_target))
    if not 0.0 < r <= 1.0:
        raise ValueError(f"recall_target {recall_target} is not in (0, 1]")
    if r == 1.0:
        return input_size, 0
    if k == 1:
        # a single maximum: fold down to one tile
        log2 = (-(-input_size // tiling) - 1).bit_length()
    else:
        m = min(max(int((1.0 - k) / math.log(r)), tiling), input_size)
        log2 = (input_size // m).bit_length() - 1
    if log2 == 0:
        return input_size, 0
    per_bin = -(-input_size // (1 << log2))
    return -(-per_bin // tiling) * tiling, log2


def approx_max_k(x: torch.Tensor, k: int, recall_target: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The approximate ``k`` largest of each row of ``x [Q, P]`` (the
    counterpart of ``lax.approx_max_k`` as the TPU computes it): values
    and positions, largest first, lower position first among equals.

    Where :func:`approx_topk_reduction_size` gives no reduction this is
    the exact top-k in ``lax.top_k``'s order. Otherwise the row is folded
    into ``reduced_size`` bins -- positions ``i`` and ``j`` share a bin
    when ``i % reduced_size == j % reduced_size`` -- each bin keeps its
    maximum (the lowest position among equal maxima), and the exact top-k
    of those maxima is returned, so two large elements that share a bin
    cost one of them (arXiv 2206.14286's PartialReduce)."""
    Q, P = x.shape
    reduced, log2 = approx_topk_reduction_size(P, k, recall_target, rank=2)
    if log2 == 0:
        return _top_sorted(x, min(k, P))
    fold = 1 << log2
    xp = torch.nn.functional.pad(x, (0, reduced * fold - P),
                                 value=float("-inf"))
    xb = xp.reshape(Q, fold, reduced)
    slot = torch.argmax(xb, dim=1)  # the first maximum of each bin
    bin_max = torch.gather(xb, 1, slot[:, None, :])[:, 0, :]
    pos = slot * reduced + torch.arange(reduced, device=x.device)
    top, at = _top_sorted(bin_max, min(k, reduced))
    return top, torch.gather(pos, 1, at)


def select_candidates(
    cand_keys: torch.Tensor,
    n_candidates: int,
    max_dup_shifts: int = 16,
    imp_lo: float = 0.0,
    imp_step: float = 1.0,
    topc_recall: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass-1 top-C of :func:`bm25_pruned_topk_packed`: the documents of
    ``cand_keys [Q, P]`` int64 ``(doc << 8) | code8`` (pad
    :data:`KEY_PAD`) with the ``C = min(n_candidates, P)`` largest summed
    codes. The keys are sorted so a document's entries are adjacent; a
    segmented doubling scan sums their decoded codes (``exp(imp_lo +
    (code - 1) * imp_step)``) into a ranking partial at each run start.
    ``topc_recall > 0`` takes the top C with :func:`approx_max_k` at that
    recall target instead of exactly. Returns (cand_ids [Q, C] int64,
    cand_valid [Q, C] bool)."""
    keys = torch.sort(cand_keys, dim=1).values
    doc = keys >> 8
    valid = keys != KEY_PAD
    code = keys & 0xFF
    imp = torch.where(valid, _dequantize(code, imp_lo, imp_step), 0.0)
    partial = _run_partials(doc, imp, valid, max_dup_shifts)
    C = min(n_candidates, cand_keys.shape[1])
    if topc_recall > 0.0:
        part_scores, pos = approx_max_k(partial, C, topc_recall)
    else:
        part_scores, pos = _top_sorted(partial, C)
    return torch.gather(doc, 1, pos), torch.isfinite(part_scores)


def _run_partials(doc: torch.Tensor, imp: torch.Tensor, valid: torch.Tensor,
                  max_dup_shifts: int) -> torch.Tensor:
    """Ranking partials of doc-sorted pass-1 entries ``[Q, P]``: at each
    valid run start the sum of its run's ``imp``, -inf elsewhere. A
    segmented doubling scan: after the step at offset s, summed[i] holds
    the sum of imp over the run from i on, up to 2s entries, so runs up to
    ``max_dup_shifts`` long sum fully."""
    Q, P = doc.shape
    summed = imp
    s = 1
    while s < max_dup_shifts and s < P:
        match = doc[:, s:] == doc[:, :-s]
        summed = torch.cat([
            summed[:, :P - s] + torch.where(match, summed[:, s:], 0.0),
            summed[:, P - s:]], dim=1)
        s *= 2
    run_start = torch.cat([torch.ones((Q, 1), dtype=torch.bool,
                                      device=doc.device),
                           doc[:, 1:] != doc[:, :-1]], dim=1)
    return torch.where(run_start & valid, summed, float("-inf"))


def pass2_operands(
    cand_keys: torch.Tensor,
    fields: Sequence[tuple],
    n_candidates: int = 512,
    max_dup_shifts: int = 16,
    imp_lo: float = 0.0,
    imp_step: float = 1.0,
    ragged_rows: Sequence[int] = (),
    rescore_id_offset: int = 0,
    topc_recall: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor, List[tuple]]:
    """Pass 1 of :func:`bm25_pruned_topk_packed` and what it hands pass 2:
    (cand_ids [Q, C] int64, cand_valid [Q, C] bool, one ``(function,
    arguments)`` per field from :func:`_rescore_operands`, invalid
    candidates at id 0; pass 2 reads the rows of ``id +
    rescore_id_offset``)."""
    cand_ids, cand_valid = select_candidates(
        cand_keys, n_candidates, max_dup_shifts, imp_lo, imp_step,
        topc_recall)
    safe_ids = torch.where(cand_valid, cand_ids, 0)
    return cand_ids, cand_valid, _rescore_operands(
        safe_ids + rescore_id_offset, fields, ragged_rows)


def _final_topk(total: torch.Tensor, cand_ids: torch.Tensor,
                cand_valid: torch.Tensor, n_real_docs: Optional[int],
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top k of the rescored candidates, padding documents (id >=
    ``n_real_docs``) and invalid candidates dropped; ids -1 where fewer
    than k score."""
    if n_real_docs is not None:
        cand_valid = cand_valid & (cand_ids < n_real_docs)
    total = torch.where(cand_valid, total, float("-inf"))
    top_scores, idx = _top_sorted(total, min(k, cand_ids.shape[1]))
    top_ids = torch.gather(cand_ids, 1, idx)
    top_ids = torch.where(torch.isfinite(top_scores), top_ids, -1)
    return top_scores, top_ids


def bm25_pruned_topk_packed(
    cand_keys: torch.Tensor,
    fields: Sequence[tuple],
    n_real_docs: Optional[int] = None,
    k: int = 10,
    n_candidates: int = 512,
    max_dup_shifts: int = 16,
    imp_lo: float = 0.0,
    imp_step: float = 1.0,
    tiny_doc: Optional[torch.Tensor] = None,
    tiny_ex: Optional[torch.Tensor] = None,
    ragged_rows: Sequence[int] = (),
    topc_recall: float = 0.0,
    rescore_id_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass top-k (scores float32, doc ids int64, -1 where fewer than
    k candidates score) from pooled pass-1 keys ``cand_keys [Q, P]``.

    The top ``n_candidates`` of :func:`select_candidates` are rescored by
    pass 2 plus the exact f32 ``tiny_ex`` sums of the host-gathered
    ``tiny_doc`` block, padding documents (id >= ``n_real_docs``) are
    dropped, and the top k remain.

    ``rescore_id_offset`` shifts the candidate ids only for the pass-2 row
    lookup and in the returned ids: a ``MixEngine`` concatenates every
    language's pass-2 rows into one structure, while the pass-1 keys, the
    ``n_real_docs`` bound and the ``tiny_doc`` match stay in the
    language's own ids.

    ``topc_recall > 0`` selects the top C with :func:`approx_max_k` at
    that recall target (the reference's ``lax.approx_max_k``): a
    candidate missed near the top-C cut rarely reaches the top k, since
    C is much larger than k.
    """
    cand_ids, cand_valid, rescore = pass2_operands(
        cand_keys, fields, n_candidates, max_dup_shifts, imp_lo, imp_step,
        ragged_rows, rescore_id_offset, topc_recall)
    safe_ids = torch.where(cand_valid, cand_ids, 0)

    total = _sum_pass2(safe_ids, rescore)
    if tiny_doc is not None:
        # exact tiny-term sums of the candidates: a [Q, C, T] match
        m = (safe_ids[:, :, None] == tiny_doc[:, None, :]) & (
            tiny_doc[:, None, :] >= 0)
        total = total + torch.where(m, tiny_ex[:, None, :], 0.0).sum(-1)
    top_scores, top_ids = _final_topk(total, cand_ids, cand_valid,
                                      n_real_docs, k)
    if rescore_id_offset:
        top_ids = torch.where(top_ids >= 0, top_ids + rescore_id_offset, -1)
    return top_scores, top_ids


def gather_pruned_candidate_keys(
    rare_terms: torch.Tensor,
    offsets: torch.Tensor,
    packed_rows: torch.Tensor,
    per_term_cap: int,
    reencode: bool = False,
    lo_src: float = 0.0,
    step_src: float = 1.0,
    lo_dst: float = 0.0,
    step_dst: float = 1.0,
    aligned: bool = False,
) -> torch.Tensor:
    """Pass-1 window gather: for each of the ``rare_terms [Q, M]`` (-1
    pad), its first ``per_term_cap`` postings of the packed CSR
    (``offsets [V+1]`` int32, ``packed_rows [NR, 128]`` int32 ``(code8 <<
    24) | doc``) as int64 sort keys ``(doc << 8) | code8``, pad
    :data:`KEY_PAD`; returns ``[Q, M * R * 128]``. ``reencode`` moves the
    codes from the source log scale to the destination one (clipped to
    [1, 255]); ``aligned`` means every window starts on a row boundary,
    so one fewer covering row is read."""
    Q, M = rare_terms.shape
    cap = per_term_cap
    R = (cap + LANES - 1) // LANES + (0 if aligned else 1)
    safe = torch.clamp(rare_terms, min=0).long()
    o = offsets[safe].long()
    dfq = offsets[safe + 1].long() - o
    eff = torch.where(rare_terms >= 0, torch.clamp(dfq, max=cap), 0)
    rows = (o >> 7)[:, :, None] + torch.arange(R, device=o.device)
    p_rows = packed_rows[rows]  # [Q, M, R, 128]
    d = (p_rows & 0xFFFFFF).long()
    code = ((p_rows >> 24) & 0xFF).long()
    if reencode:
        cf = code.to(torch.float32)
        re = torch.clamp(torch.round(
            (lo_src + (cf - 1.0) * step_src - lo_dst) / step_dst) + 1.0,
            1.0, 255.0)
        code = torch.where(code > 0, re.long(), code)
    lane = torch.arange(LANES, device=o.device)
    g = rows[..., None] * LANES + lane
    in_win = (g >= o[:, :, None, None]) & (g < (o + eff)[:, :, None, None])
    keys = torch.where(in_win, (d << 8) | code, KEY_PAD)
    return keys.reshape(Q, M * R * LANES)


DOC_SENTINEL = 2**31 - 2  # pad doc of the two-operand pool: sorts last


def select_candidates_two_operand(
    cand_doc: torch.Tensor,
    cand_imp: torch.Tensor,
    n_candidates: int,
    max_dup_shifts: int = 16,
    exact_by_sign: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Pass-1 top-C of :func:`bm25_pruned_topk`: the pool ``cand_doc
    [Q, P]`` (-1 pad) with impacts ``cand_imp [Q, P]`` is sorted by doc
    with a stable sort carrying the impacts, runs are summed by the
    segmented doubling scan, and the ``C = min(n_candidates, P)`` largest
    run sums are kept. With ``exact_by_sign`` negative impacts are exact
    contributions: their magnitude ranks, and the third result holds each
    candidate's exact part (the run start's ``max(-imp, 0)``), else None.
    Returns (cand_ids [Q, C] int64, cand_valid [Q, C] bool, exact)."""
    doc = torch.where(cand_doc < 0, DOC_SENTINEL, cand_doc.long())
    doc, order = torch.sort(doc, dim=1, stable=True)
    enc = torch.gather(cand_imp, 1, order)
    imp = enc.abs() if exact_by_sign else enc
    partial = _run_partials(doc, imp, doc != DOC_SENTINEL, max_dup_shifts)
    part_scores, pos = _top_sorted(partial, min(n_candidates, doc.shape[1]))
    exact = None
    if exact_by_sign:
        # by the ordering contract each run's one exact (negative) entry
        # sits at the run start, where the top-C positions point
        exact = torch.gather(torch.clamp(-enc, min=0.0), 1, pos)
    return torch.gather(doc, 1, pos), torch.isfinite(part_scores), exact


def pass2_operands_two_operand(
    cand_doc: torch.Tensor,
    cand_imp: torch.Tensor,
    fields: Sequence[tuple],
    n_candidates: int = 512,
    max_dup_shifts: int = 16,
    ragged_rows: Sequence[int] = (),
    exact_by_sign: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], List[tuple]]:
    """Pass 1 of :func:`bm25_pruned_topk` and what it hands pass 2:
    (cand_ids, cand_valid, exact part or None, one ``(function,
    arguments)`` per field from :func:`_rescore_operands`, invalid
    candidates at id 0)."""
    cand_ids, cand_valid, exact = select_candidates_two_operand(
        cand_doc, cand_imp, n_candidates, max_dup_shifts, exact_by_sign)
    safe_ids = torch.where(cand_valid, cand_ids, 0)
    return cand_ids, cand_valid, exact, _rescore_operands(
        safe_ids, fields, ragged_rows)


def bm25_pruned_topk(
    cand_doc: torch.Tensor,
    cand_imp: torch.Tensor,
    fields: Sequence[tuple],
    n_real_docs: Optional[int] = None,
    k: int = 10,
    n_candidates: int = 512,
    max_dup_shifts: int = 16,
    ragged_rows: Sequence[int] = (),
    exact_by_sign: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-operand two-pass top-k (counterpart of the reference's
    ``bm25_pruned_topk``): pass 1 pools the gathered (doc, impact) pairs
    of :func:`gather_pruned_candidates`, pass 2 rescores the top
    ``n_candidates`` over every field (any layout of
    :func:`_rescore_operands`; the two-array one goes through K3), plus
    the exact parts of ``exact_by_sign``; padding documents (id >=
    ``n_real_docs``) are dropped. Returns (scores [Q, k] float32, ids
    [Q, k] int64, -1 where fewer than k candidates score)."""
    cand_ids, cand_valid, exact, rescore = pass2_operands_two_operand(
        cand_doc, cand_imp, fields, n_candidates, max_dup_shifts,
        ragged_rows, exact_by_sign)
    total = _sum_pass2(cand_ids, rescore)
    if exact is not None:
        total = total + exact
    return _final_topk(total, cand_ids, cand_valid, n_real_docs, k)


def gather_pruned_candidates(
    rare_terms: torch.Tensor,
    offsets: torch.Tensor,
    packed_rows: torch.Tensor,
    per_term_cap: int,
    imp_lo: float,
    imp_step: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass-1 window gather of the two-operand pool: each of the
    ``rare_terms [Q, M]`` (-1 pad) contributes its first ``per_term_cap``
    postings of the packed CSR (``offsets [V+1]`` int32, ``packed_rows
    [NR, 128]`` int32 ``(code8 << 24) | doc``) as (cand_doc [Q, P] int32
    with -1 pads, cand_imp [Q, P] float32 dequantized with ``exp(imp_lo
    + (code - 1) * imp_step)``), P = M * (cap // 128 + 2) * 128. The
    covering rows are clamped to the CSR's rows, as an XLA gather
    clamps them."""
    Q, M = rare_terms.shape
    cap = per_term_cap
    R = (cap + LANES - 1) // LANES + 1  # +1 row for any start in a row
    safe = torch.clamp(rare_terms, min=0).long()
    o = offsets[safe].long()
    dfq = offsets[safe + 1].long() - o
    eff = torch.where(rare_terms >= 0, torch.clamp(dfq, max=cap), 0)
    rows = (o >> 7)[:, :, None] + torch.arange(R, device=o.device)
    p_rows = packed_rows[torch.clamp(rows, max=packed_rows.shape[0] - 1)]
    code = (p_rows.long() & 0xFFFFFFFF) >> 24
    lane = torch.arange(LANES, device=o.device)
    g = rows[..., None] * LANES + lane
    valid = (g >= o[:, :, None, None]) & (g < (o + eff)[:, :, None, None])
    cand_doc = torch.where(valid, p_rows & 0xFFFFFF, -1)
    cand_imp = torch.where(valid, _dequantize(code, imp_lo, imp_step), 0.0)
    return cand_doc.reshape(Q, -1), cand_imp.reshape(Q, -1)
