"""BM25 scoring (counterpart of ``kbner_tpu/ops/bm25.py``): exhaustive
match-and-accumulate with a running top-k, and the two-pass pruned top-k
over delta16 rows.

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
their summed codes, and rescores them exactly over the engine's delta16
rows with K2: :func:`delta16_rescore_ref` is its plain version and
:func:`delta16_rescore` the wrapper of ``csrc/delta16_rescore.cu``, with
the same rule as K1's wrapper.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

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
    """Merge two per-query top-k lists -> top-k of the union."""
    scores = torch.cat([scores_a, scores_b], dim=1)
    ids = torch.cat([ids_a, ids_b], dim=1)
    top_scores, idx = torch.topk(scores, k, dim=1)
    return top_scores, torch.gather(ids, 1, idx)


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
    returned ids. Ties may come back in another order than ``lax.top_k``
    gives them.
    """
    fields = tuple(fields)
    Q = fields[0][0].shape[0]
    N = fields[0][2].shape[1]

    if doc_chunk is None or doc_chunk >= N:
        scores = _score_fields(fields, 0, N)
        top_scores, top_ids = torch.topk(scores, min(k, N), dim=1)
        return top_scores, top_ids + id_offset

    if N % doc_chunk != 0:
        raise ValueError(f"N={N} must be a multiple of doc_chunk={doc_chunk}")
    dev = fields[0][2].device
    run_scores = torch.full((Q, k), float("-inf"), dtype=torch.float32,
                            device=dev)
    run_ids = torch.full((Q, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, N, doc_chunk):
        scores = _score_fields(fields, start, doc_chunk)
        c_scores, c_ids = torch.topk(scores, min(k, doc_chunk), dim=1)
        run_scores, run_ids = merge_topk(
            run_scores, run_ids, c_scores, c_ids + (start + id_offset), k)
    return run_scores, run_ids


# -- two-pass pruned search (MaxScore-style) -----------------------------------

KEY_PAD = 0xFFFFFFFF  # pad of the pass-1 sort keys: sorts after every key
LANES = 128           # slots per row of the CSR and of the delta16 rows

# One delta16 text field: (q_terms [Q, W] int32 remapped ids (-1 pad),
#   q_weights [Q, W] float32 with idf folded in, flat [NR, 128] int16 rows
#   of 16-bit slots, doc_off [N] int32, doc_len [N] int32,
#   norm_code [N] uint8, k1, b, avgdl)
Delta16Field = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor, torch.Tensor, float, float, float]


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
_D16_MAX_TERMS = 6144  # W * 8 bytes of staged query terms in 48 KB


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


def _rescore_operands(safe_ids: torch.Tensor,
                      fields: Sequence[Delta16Field],
                      ragged_rows: Sequence[int]) -> List[tuple]:
    """The :func:`delta16_rescore` arguments of pass 2, one tuple per
    field (the counterpart of the reference's ``_rescore_candidates``).
    Ids past the doc axis are clamped to its last document, as an XLA
    gather clamps them (the pad slots of an aligned CSR window re-encode
    to a key of doc 0xFFFFFF that pass 1 keeps; its score is masked
    afterwards)."""
    ops = []
    for f, field in enumerate(fields):
        if len(field) != 9:
            raise NotImplementedError(
                "only the delta16 row layout is ported; the packed32 and "
                "two-array layouts (K3) are ROADMAP A2 and A4")
        qt, qw, flat, off, ln, nc, k1, b, avgdl = field
        r2 = ragged_rows[f] if f < len(ragged_rows) else 1
        cand = torch.clamp(safe_ids, max=off.shape[0] - 1).to(
            torch.int32).contiguous()
        ops.append((qt, qw, cand, flat, off, ln, nc, k1, b, avgdl, r2))
    return ops


def _top_sorted(x: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``n`` largest of each row, lower index first among equals (the
    order ``lax.top_k`` gives; ``torch.topk`` promises none)."""
    vals, pos = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :n], pos[:, :n]


def select_candidates(
    cand_keys: torch.Tensor,
    n_candidates: int,
    max_dup_shifts: int = 16,
    imp_lo: float = 0.0,
    imp_step: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass-1 top-C of :func:`bm25_pruned_topk_packed`: the documents of
    ``cand_keys [Q, P]`` int64 ``(doc << 8) | code8`` (pad
    :data:`KEY_PAD`) with the ``C = min(n_candidates, P)`` largest summed
    codes. The keys are sorted so a document's entries are adjacent; a
    segmented doubling scan sums their decoded codes (``exp(imp_lo +
    (code - 1) * imp_step)``) into a ranking partial at each run start.
    Returns (cand_ids [Q, C] int64, cand_valid [Q, C] bool)."""
    Q, P = cand_keys.shape
    keys = torch.sort(cand_keys, dim=1).values
    doc = keys >> 8
    code = (keys & 0xFF).to(torch.float32)
    valid = keys != KEY_PAD
    imp = torch.where(valid & (code > 0),
                      torch.exp(imp_lo + (code - 1.0) * imp_step), 0.0)

    # after the step at offset s, summed[i] holds the sum of imp over the
    # run from i on, up to 2s entries
    summed = imp
    s = 1
    while s < max_dup_shifts and s < P:
        match = doc[:, s:] == doc[:, :-s]
        summed = torch.cat([
            summed[:, :P - s] + torch.where(match, summed[:, s:], 0.0),
            summed[:, P - s:]], dim=1)
        s *= 2
    run_start = torch.cat([torch.ones((Q, 1), dtype=torch.bool,
                                      device=keys.device),
                           doc[:, 1:] != doc[:, :-1]], dim=1)
    partial = torch.where(run_start & valid, summed, float("-inf"))
    part_scores, pos = _top_sorted(partial, min(n_candidates, P))
    return torch.gather(doc, 1, pos), torch.isfinite(part_scores)


def pass2_operands(
    cand_keys: torch.Tensor,
    fields: Sequence[Delta16Field],
    n_candidates: int = 512,
    max_dup_shifts: int = 16,
    imp_lo: float = 0.0,
    imp_step: float = 1.0,
    ragged_rows: Sequence[int] = (),
) -> Tuple[torch.Tensor, torch.Tensor, List[tuple]]:
    """Pass 1 of :func:`bm25_pruned_topk_packed` and what it hands pass 2:
    (cand_ids [Q, C] int64, cand_valid [Q, C] bool, one tuple of
    :func:`delta16_rescore` arguments per field, invalid candidates at
    id 0)."""
    cand_ids, cand_valid = select_candidates(
        cand_keys, n_candidates, max_dup_shifts, imp_lo, imp_step)
    safe_ids = torch.where(cand_valid, cand_ids, 0)
    return cand_ids, cand_valid, _rescore_operands(safe_ids, fields,
                                                   ragged_rows)


def bm25_pruned_topk_packed(
    cand_keys: torch.Tensor,
    fields: Sequence[Delta16Field],
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two-pass top-k (scores float32, doc ids int64, -1 where fewer than
    k candidates score) from pooled pass-1 keys ``cand_keys [Q, P]``.

    The top ``n_candidates`` of :func:`select_candidates` are rescored by
    pass 2 plus the exact f32 ``tiny_ex`` sums of the host-gathered
    ``tiny_doc`` block, padding documents (id >= ``n_real_docs``) are
    dropped, and the top k remain.
    """
    if topc_recall > 0.0:
        raise NotImplementedError(
            "topc_recall > 0 (approx_max_k) has no torch counterpart; the "
            "exact top-C is the ported path (ROADMAP A4)")
    cand_ids, cand_valid, rescore = pass2_operands(
        cand_keys, fields, n_candidates, max_dup_shifts, imp_lo, imp_step,
        ragged_rows)
    safe_ids = torch.where(cand_valid, cand_ids, 0)

    total = torch.zeros(cand_ids.shape, dtype=torch.float32,
                        device=cand_ids.device)
    for args in rescore:
        total = total + delta16_rescore(*args)
    if tiny_doc is not None:
        # exact tiny-term sums of the candidates: a [Q, C, T] match
        m = (safe_ids[:, :, None] == tiny_doc[:, None, :]) & (
            tiny_doc[:, None, :] >= 0)
        total = total + torch.where(m, tiny_ex[:, None, :], 0.0).sum(-1)

    if n_real_docs is not None:
        cand_valid = cand_valid & (cand_ids < n_real_docs)
    total = torch.where(cand_valid, total, float("-inf"))
    top_scores, idx = _top_sorted(total, min(k, cand_ids.shape[1]))
    top_ids = torch.gather(cand_ids, 1, idx)
    top_ids = torch.where(torch.isfinite(top_scores), top_ids, -1)
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


def bm25_pruned_topk(*args, **kwargs):
    """The two-operand pruned top-k of the reference is not ported."""
    raise NotImplementedError(
        "bm25_pruned_topk (two-operand candidates) is not ported; the "
        "engine uses bm25_pruned_topk_packed (ROADMAP A4)")


def gather_pruned_candidates(*args, **kwargs):
    """The two-operand pass-1 gather of the reference is not ported."""
    raise NotImplementedError(
        "gather_pruned_candidates (two-operand candidates) is not ported; "
        "the engine uses gather_pruned_candidate_keys (ROADMAP A4)")
