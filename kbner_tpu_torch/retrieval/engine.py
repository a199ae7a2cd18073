"""Retrieval engine: device-resident BM25 index, batched top-k, sharded
over a mesh or not (counterpart of ``kbner_tpu/retrieval/engine.py``).

Two modes, each over the text field and an optional title field for
entity-boosted queries:

* ``exhaustive``: the padded impact arrays of each field live in device
  memory transposed to ``[Ld, N]``; a query batch is scored against every
  document by the CUDA kernel behind ``ops.bm25.bm25_topk``.
* ``pruned``: two-pass MaxScore-style search. Pass 1 reads the capped,
  impact-ordered windows of each query's rarest terms from a packed CSR
  per field on the device and pools them with the host-gathered exact
  sums of the "tiny" text terms (df <= ``tiny_cap``, left out of every
  device array); the top ``n_candidates`` by pooled partial score are
  rescored over each field's document rows: gap-coded 16-bit ("delta16")
  text rows by the CUDA kernel behind ``ops.bm25.delta16_rescore``, or
  packed32 rows (``(code << term_bits) | term``, per-term log scale; the
  title field's always) in plain PyTorch, as the reference leaves them to
  XLA.

Only the top-k ids and scores come back. Document texts stay on the host
and are materialized into result records with the reference's
retrieval-file fields (sentence/paragraph/title/score/url).

Sharded (``mesh=parallel.make_mesh(...)``): the document axis is cut into
one contiguous shard per coordinate of the mesh's data axis, each rank
holds its shard's arrays on its device and searches them with the same
kernels (K1 on its ``[Ld, N / S]`` slice; pass 1 over its own CSR and K2
over its own rows, with the full index's scales and remaps), and the
ranks all-gather their shard top-k over the data axis and merge it, so
every rank returns the global top-k (the reference's ``shard_map`` and
``all_gather``). A meshed search is a collective: every rank calls it
with the same queries, in the same order.

Across languages (the recipe's MIX track, one query searched in every
language's KB): :func:`mix_search` fans a batch out to each language's
engine and merges by score; :class:`MixEngine` holds the languages'
pruned arrays concatenated on the device and runs the pruned search of
each language on global ids; :func:`langwiki_search` routes each query to
its own language's engine.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..ops.bm25 import (KEY_PAD, _top_sorted, bm25_pruned_topk_packed,
                        bm25_topk, gather_pruned_candidate_keys)
from ..utils.spans import span
from .index import BM25Index, long_to_int4

_DOC_PAD = 512  # the doc axis is padded to a multiple of this on upload
# ln(64) of headroom per code step, so summed tiny contributions do not
# clip to pass-1 code 255
_RANK_HEADROOM = float(np.log(64.0)) / 254.0


def _rank_step(csr_step: float, dtype=np.float64) -> float:
    """The pooled pass-1 keys' ranking step: a CSR's log step plus
    :data:`_RANK_HEADROOM`, summed in ``dtype`` (float32 where the scale
    travels as float32 scalars, as in :class:`MixEngine`)."""
    return float(dtype(csr_step) + dtype(_RANK_HEADROOM))


def _tiny_keys(t_doc: torch.Tensor, t_ex: torch.Tensor, rank_lo: float,
               rank_step: float) -> torch.Tensor:
    """The tiny block's pass-1 keys ``(doc << 8) | code`` [Q, T] int64:
    each exact sum's log code on the ranking scale, clamped to 1..255;
    KEY_PAD where the doc is -1 or the sum is not positive."""
    code = torch.clamp(torch.round(
        (torch.log(torch.clamp(t_ex, min=1e-30)) - rank_lo) / rank_step)
        + 1.0, 1.0, 255.0).long()
    return torch.where((t_doc >= 0) & (t_ex > 0), (t_doc << 8) | code,
                       KEY_PAD)


@dataclasses.dataclass
class RetrievedDoc:
    doc_id: int
    score: float
    sentence: str = ""
    paragraph: str = ""
    title: str = ""
    url: str = ""


@dataclasses.dataclass
class DocStore:
    """Host-side document payloads, aligned with index doc ids. Any
    sequence works for a field (a list, or a lazy sequence that renders a
    document when indexed)."""

    sentences: Sequence[str]
    paragraphs: Optional[Sequence[str]] = None
    titles: Optional[Sequence[str]] = None
    urls: Optional[Sequence[str]] = None

    def materialize(self, doc_id: int, score: float) -> RetrievedDoc:
        def get(lst):
            return lst[doc_id] if lst is not None and doc_id < len(lst) else ""

        return RetrievedDoc(
            doc_id=doc_id,
            score=score,
            sentence=get(self.sentences),
            paragraph=get(self.paragraphs),
            title=get(self.titles),
            url=get(self.urls),
        )


# -- pass-2 row layout (delta16) -----------------------------------------------

def _place_length_groups(lens: np.ndarray, lanes: int, max_seg: int
                         ) -> Tuple[np.ndarray, int]:
    """Segment packing: docs grouped by segment length in ascending order;
    equal-length segments tile ``lanes``-wide rows exactly (no segment
    straddles a row boundary), longer ones start on a row boundary.
    Returns (off [N] int64 slot offsets, total rows including the guard
    rows a covering read of ``max_seg`` slots needs)."""
    N = len(lens)
    off = np.zeros(max(N, 1), dtype=np.int64)
    cursor = 0
    for L in np.unique(lens).tolist():
        idx = np.nonzero(lens == L)[0]
        if L == 0:
            continue
        if L <= lanes:
            c = lanes // L
            r = np.arange(len(idx), dtype=np.int64)
            off[idx] = cursor + (r // c) * lanes + (r % c) * L
            cursor += ((len(idx) + c - 1) // c) * lanes
        else:
            per = ((L + lanes - 1) // lanes) * lanes
            off[idx] = cursor + np.arange(len(idx), dtype=np.int64) * per
            cursor += len(idx) * per
    r2 = 1 if max_seg <= lanes else (max_seg + lanes - 1) // lanes
    return off, cursor // lanes + r2


DELTA16_GAP_BITS = 13          # slot = (gap13 << 3) | tf3
# the 13-bit gap's largest value (8191), tf's cap (tfNorm is about flat
# past 7) and the continuation slot (tf = 0)
DELTA16_MAX_GAP = native.DELTA16_MAX_GAP
DELTA16_TF_CAP = native.DELTA16_TF_CAP
DELTA16_CONT = native.DELTA16_CONT


def _nontiny_remap(df: np.ndarray, tiny_cap: int
                   ) -> Tuple[np.ndarray, int]:
    """Dense df-descending remap of the non-tiny (df > tiny_cap) terms:
    remap[orig] in [0, T') for non-tiny terms, -1 otherwise. Frequent terms
    get small ids, so the within-doc gaps of sorted ids stay mostly under
    the 13-bit field."""
    nont = df > tiny_cap
    Tp = int(nont.sum())
    remap = np.full(len(df), -1, np.int64)
    order = np.argsort(-df[nont], kind="stable")
    ids = np.empty(Tp, np.int64)
    ids[order] = np.arange(Tp)
    remap[nont] = ids
    return remap, Tp


def _pack_doc_rows_delta16(
    dt: np.ndarray,
    di: np.ndarray,
    remap: np.ndarray,
    idf: np.ndarray,
    norm: np.ndarray,
    lanes: int = 128,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Delta-encoded 16-bit pass-2 rows from left-packed doc arrays
    ``dt``/``di`` [N, L] (tiny terms already dropped), the dense remap, the
    idf and the per-doc float32 norms ``k1 * (1 - b + b * dl / avgdl)``.

    Per document the surviving terms are sorted by remapped id and stored
    as gaps: one uint16 slot ``(gap13 << 3) | min(tf, 7)`` per posting,
    preceded by ``gap // 8191`` continuation slots (tf = 0, gap field 8191)
    when a gap overflows the field. tf is recovered exactly from the
    impact: ``x = imp / idf = tf / (tf + norm)``.

    Returns (flat [NR, lanes] uint16, off [N] int32 slot offsets,
    lens [N] uint8|int32 slot counts, r2 covering rows).
    """
    lens, emit = native.delta16_rows(dt, di, remap, idf, norm)
    lens = lens[:dt.shape[0]]
    max_seg = int(lens.max(initial=0))
    off, nr = _place_length_groups(lens, lanes, max(max_seg, 1))
    if off.max(initial=0) + max_seg >= 2**31:
        raise ValueError("delta16 layout exceeds int32 offsets; shard more")
    flat = np.zeros(nr * lanes, dtype=np.uint16)
    emit(off, flat)
    r2 = 1 if max_seg <= lanes else (max_seg + lanes - 1) // lanes
    lens_dtype = np.uint8 if max_seg < 256 else np.int32
    return (flat.reshape(nr, lanes), off.astype(np.int32),
            lens.astype(lens_dtype), r2)


def _drop_tiny_slots(dt: np.ndarray, di: np.ndarray, df: np.ndarray,
                     tiny_cap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Left-compacted copies of the padded doc arrays without the slots of
    tiny terms (df <= tiny_cap): the host scores those exactly, so the
    pass-2 rows need not carry them."""
    return native.compact_tiny(dt, di, df, tiny_cap)


def _pow2_width(n: int, start: int) -> int:
    """The least ``start * 2**i`` that is at least ``n``."""
    w = start
    while w < n:
        w *= 2
    return w


# -- pass-2 row layout (packed32) ----------------------------------------------

def _pack_doc_rows_ragged(
    dt: np.ndarray,
    di: np.ndarray,
    vocab_size: int,
    lanes: int = 128,
    scale=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, float, float, int]:
    """Ragged packed32 pass-2 rows from left-packed doc arrays ``dt``/``di``
    [N, Ld] (pad -1): one int32 ``(code << term_bits) | term`` per real
    slot, segments placed by :func:`_place_length_groups` (none straddles
    a row boundary).

    ``scale`` is None (one log scale from the impacts' range), ``(lo,
    step)``, or ``(term_lo [V], step)``: per-term log bases, so codes
    store ``ln(imp) - term_lo[t]``, the rows decode with lo = 0 and the
    base rides the query weight (:meth:`RetrievalEngine._fold_weights`).

    Returns (flat [NR, lanes] int32 with -1 pads, off [N] int32, lens [N]
    uint8|int32, term_bits, lo, step, r2 covering rows)."""
    N, Ld = dt.shape
    term_bits = max(int(np.ceil(np.log2(vocab_size + 2))), 1)
    code_bits = 32 - term_bits
    if code_bits < 8:
        raise ValueError(
            f"vocab {vocab_size} leaves {code_bits} impact bits; "
            "shard the vocabulary or use the two-array layout")
    levels = (1 << code_bits) - 2
    term_lo = None
    if scale is not None and np.ndim(scale[0]) == 1:
        term_lo, step = scale
        lo = 0.0
    elif scale is not None:
        lo, step = scale
    else:
        pos = di[di > 0]
        if len(pos):
            lo = float(np.log(float(pos.min())))
            hi = float(np.log(float(pos.max())))
            step = max((hi - lo) / max(levels, 1), 1e-12)
        else:
            lo, step = 0.0, 1.0

    valid = dt >= 0
    lens = valid.sum(axis=1).astype(np.int64)
    off, nr = _place_length_groups(lens, lanes, max(Ld, 1))
    r2 = 1 if Ld <= lanes else (Ld + lanes - 1) // lanes
    if off.max(initial=0) + Ld >= 2**31:
        raise ValueError("ragged layout exceeds int32 offsets; shard more")

    flat = np.full(nr * lanes, -1, dtype=np.int32)
    native.pack_ragged(dt, di, off, term_bits, lo, step, levels, flat,
                       term_lo=term_lo)
    lens_dtype = np.uint8 if Ld < 256 else np.int32
    return (flat.reshape(nr, lanes), off.astype(np.int32),
            lens.astype(lens_dtype), term_bits, lo, step, r2)


def _term_scale_from_csr(index: BM25Index, code_bits: int
                         ) -> Tuple[np.ndarray, float]:
    """Per-term log bases ``term_lo [V]`` float32 and the one step of the
    per-term row quantization: from the impact-ordered CSR a term's
    largest impact is its first posting and its smallest its last."""
    offsets, _, p_imp, df = index.csr
    V = len(df)
    term_lo = np.zeros(V, np.float32)
    levels = (1 << code_bits) - 2
    if len(p_imp) == 0:
        return term_lo, 1.0
    has = df > 0
    mins = p_imp[np.maximum(offsets[1:] - 1, 0)]
    maxs = p_imp[np.minimum(offsets[:-1], len(p_imp) - 1)]
    lnmin = np.zeros(V)
    lnmax = np.zeros(V)
    np.log(mins, out=lnmin, where=has & (mins > 0))
    np.log(maxs, out=lnmax, where=has & (maxs > 0))
    term_lo[has] = lnmin[has].astype(np.float32)
    rng = float((lnmax - lnmin).max(initial=0.0))
    return term_lo, max(rng / max(levels, 1), 1e-12)


# -- the shards of a meshed engine ---------------------------------------------
#
# Functions of the shard count S, the shard size ss and the full index's
# arrays padded to S * ss docs, so that each can be held against the
# reference without a world. Shard s holds docs [s * ss, (s + 1) * ss) with
# shard-local ids; a shared constant (the covering rows r2, the row and CSR
# widths, the scales) is taken over every shard, the arrays are built for
# ``shards`` only (all by default) and stacked [len(shards), ...].

def _shards(S: int, shards) -> List[int]:
    return list(range(S)) if shards is None else list(shards)


def shard_rows_delta16(dt_rows: np.ndarray, di_rows: np.ndarray,
                       remap: np.ndarray, idf: np.ndarray, norm: np.ndarray,
                       S: int, ss: int, shards=None, lanes: int = 128):
    """Each shard's delta16 pass-2 rows (:func:`_pack_doc_rows_delta16` of
    its docs) under the full index's remap, idf and norms: (flat [n, NR,
    lanes] uint16, off [n, ss] int32, lens [n, ss] int32, r2). r2 is the
    largest shard's covering rows and NR the widest shard's rows plus r2
    guard rows, so a covering read from any segment stays in bounds."""
    lens_all, _ = native.delta16_rows(dt_rows, di_rows, remap, idf, norm)
    r2, nr_max = 1, 0
    for s in range(S):
        seg = lens_all[s * ss:(s + 1) * ss]
        max_seg = int(seg.max(initial=0))
        _, nr = _place_length_groups(seg, lanes, max(max_seg, 1))
        nr_max = max(nr_max, nr)
        r2 = max(r2, -(-max_seg // lanes))
    ids = _shards(S, shards)
    flat = np.zeros((len(ids), nr_max + r2, lanes), np.uint16)
    off = np.zeros((len(ids), ss), np.int32)
    lens = np.zeros((len(ids), ss), np.int32)
    for j, s in enumerate(ids):
        sl = slice(s * ss, (s + 1) * ss)
        f, off[j], ln, _ = _pack_doc_rows_delta16(
            dt_rows[sl], di_rows[sl], remap, idf, norm[sl], lanes=lanes)
        flat[j, :f.shape[0]] = f
        lens[j] = ln
    return flat, off, lens, r2


def shard_rows_packed32(dt_rows: np.ndarray, di_rows: np.ndarray,
                        vocab_size: int, scale, S: int, ss: int,
                        shards=None, lanes: int = 128):
    """Each shard's packed32 pass-2 rows (:func:`_pack_doc_rows_ragged` of
    its docs) on the full index's per-term scale ``(term_lo, step)``:
    (flat [n, NR, lanes] int32 with -1 pads, off [n, ss] int32, lens [n,
    ss] uint8|int32, term_bits, step, r2), NR the widest shard's rows (its
    guard rows included)."""
    Ld = dt_rows.shape[1]
    counts = (dt_rows >= 0).sum(axis=1)
    nr_max = max(_place_length_groups(counts[s * ss:(s + 1) * ss], lanes,
                                      max(Ld, 1))[1] for s in range(S))
    ids = _shards(S, shards)
    parts = [_pack_doc_rows_ragged(dt_rows[s * ss:(s + 1) * ss],
                                   di_rows[s * ss:(s + 1) * ss], vocab_size,
                                   lanes=lanes, scale=scale) for s in ids]
    flat = np.full((len(ids), nr_max, lanes), -1, np.int32)
    for j, part in enumerate(parts):
        flat[j, :part[0].shape[0]] = part[0]
    off = np.stack([part[1] for part in parts])
    lens = np.stack([part[2] for part in parts])
    _, _, _, term_bits, _, step, r2 = parts[0]
    return flat, off, lens, term_bits, step, r2


def shard_csr(dt_padded: np.ndarray, di_padded: np.ndarray, vocab_size: int,
              cap: int, S: int, ss: int, gdf: Optional[np.ndarray] = None,
              tiny_cap: int = 0, shards=None, lanes: int = 128,
              guard: int = 32):
    """Each shard's pass-1 CSR over its own docs (shard-local ids): per
    term its postings by impact, largest first (ties in doc order), capped
    at ``cap``, packed ``(code8 << 24) | doc`` on one 8-bit log scale over
    every impact of the index. With the global dfs ``gdf`` the terms with
    df <= ``tiny_cap`` are left out of every shard (the host scores
    them). Returns (offsets [n, V + 1] int32, packed [n, NR, lanes] int32
    with -1 pads, lo, step), NR the largest shard's rows plus ``guard``."""
    from .index import log_quantize, pack_postings

    if ss >= 0xFFFFFF:
        raise ValueError(f"shard size {ss} needs > 24-bit doc ids")
    _, lo, step = log_quantize(
        di_padded[dt_padded >= 0].astype(np.float32), bits=8)

    def kept(s):
        sl_t = dt_padded[s * ss:(s + 1) * ss]
        valid = sl_t >= 0
        if gdf is not None:
            valid &= np.where(valid, gdf[np.maximum(sl_t, 0)] > tiny_cap,
                              False)
        return sl_t, valid

    rows = 0
    for s in range(S):
        sl_t, valid = kept(s)
        df = np.bincount(sl_t[valid], minlength=vocab_size)
        rows = max(rows, -(-int(np.minimum(df, cap).sum()) // lanes))
    ids = _shards(S, shards)
    offs = np.zeros((len(ids), vocab_size + 1), np.int32)
    packed = np.full((len(ids), (rows + guard) * lanes), -1, np.int32)
    for j, s in enumerate(ids):
        sl_t, valid = kept(s)
        terms = sl_t[valid]
        docs = np.nonzero(valid)[0].astype(np.int32)
        imps = di_padded[s * ss:(s + 1) * ss][valid].astype(np.float32)
        order = np.lexsort((-imps, terms))
        df = np.bincount(terms[order], minlength=vocab_size)
        start = np.concatenate([[0], np.cumsum(df)])
        keep = np.arange(len(order)) - np.repeat(start[:-1], df) < cap
        order = order[keep]
        np.cumsum(np.minimum(df, cap), out=offs[j, 1:])
        pk, _, _ = pack_postings(docs[order], imps[order], lanes=lanes,
                                 guard_rows=0, scale=(lo, step))
        packed[j, :pk.size] = pk.ravel()
    return offs, packed.reshape(len(ids), rows + guard, lanes), lo, step


def slice_tiny_per_shard(t_doc: np.ndarray, t_ex: np.ndarray, S: int,
                         ss: int) -> Tuple[Optional[np.ndarray], int]:
    """The tiny exact block [Q, T] (global doc ids, -1 pads) cut per shard:
    [S, Q, 2 * Tb] int32, per shard ``Tb`` shard-local doc columns (-1
    pads, in the block's order) then ``Tb`` bitcast negated float32 sums;
    ``Tb`` the widest (shard, query) count bucketed to a power of two of
    at least 128. Returns (block, Tb), or (None, 0) without entries."""
    Q, T = t_doc.shape
    m = t_doc >= 0
    if T == 0 or not m.any():
        return None, 0
    qidx = np.broadcast_to(np.arange(Q)[:, None], t_doc.shape)
    key = (t_doc[m] // ss) * Q + qidx[m]
    counts = np.bincount(key, minlength=S * Q)
    Tb = _pow2_width(int(counts.max(initial=0)), 128)
    order = np.argsort(key, kind="stable")
    ksort = key[order]
    run_off = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos = np.arange(len(ksort)) - run_off[ksort]
    out_doc = np.full((S, Q, Tb), -1, np.int32)
    out_ex = np.zeros((S, Q, Tb), np.float32)
    s_i, q_i = ksort // Q, ksort % Q
    out_doc[s_i, q_i, pos] = (t_doc[m][order] - s_i * ss).astype(np.int32)
    out_ex[s_i, q_i, pos] = t_ex[m][order]
    return np.concatenate([out_doc, (-out_ex).view(np.int32)], axis=2), Tb


def merge_shard_topk(scores: torch.Tensor, ids: torch.Tensor, k: int,
                     group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The top k over every rank's shard top-k (scores [Q, k'] float32,
    global ids [Q, k'] int64): one ``all_gather`` over ``group`` of [Q,
    2k'] int64 (the ids, then the scores' bits), laid out [Q, S * k'] in
    shard order, then the top k, lower position first among equal scores
    (the reference's ``all_gather`` and ``lax.top_k``). A collective:
    every rank of ``group`` calls it, with the same Q and k'. The tensors
    stay on their device: NCCL gathers them there, and gloo (the one-card
    worlds: NCCL refuses two ranks on one card) takes CUDA tensors too,
    staging them through host memory itself."""
    import torch.distributed as dist

    Q, kk = scores.shape
    if Q == 0:
        return scores[:, :k], ids[:, :k]
    buf = torch.cat([ids.long(),
                     scores.contiguous().view(torch.int32).long()], dim=1)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    every = torch.stack(parts, dim=1)  # [Q, S, 2k']
    all_ids = every[:, :, :kk].reshape(Q, -1)
    all_scores = every[:, :, kk:].to(torch.int32).view(
        torch.float32).reshape(Q, -1)
    top, pos = _top_sorted(all_scores, min(k, all_scores.shape[1]))
    return top, torch.gather(all_ids, 1, pos)


def _upload_tree(tree, device: torch.device, stream):
    """Start the upload of every numpy array in ``tree`` (nested lists and
    tuples; anything else passes as is) on ``stream`` from pinned
    buffers. Returns (the same structure over device tensors, the event
    recorded after the copies, the device tensors)."""
    on_side = []

    def put(x):
        if isinstance(x, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(
                device, non_blocking=True)
            on_side.append(t)
            return t
        if isinstance(x, (list, tuple)):
            return type(x)(put(y) for y in x)
        return x

    with torch.cuda.stream(stream):
        tree = put(tree)
        uploaded = torch.cuda.Event()
        uploaded.record(stream)
    return tree, uploaded, on_side


def _pipelined(batches, encode, pack, run, device: torch.device,
               workers: int, depth: int):
    """Yield ``run(pack(encode(b)))`` pulled to numpy (a tuple of arrays)
    for each batch ``b``, in order, with three stages overlapping:
    ``workers`` prep threads run ``encode`` at once and ``pack`` in batch
    order (a pack may grow never-shrink widths), then start the packed
    arrays' upload from pinned buffers on a side stream; ``run`` launches
    the kernels on the caller's thread, on its current stream, which waits
    for the batch's upload event; each result is copied into pinned
    buffers and pulled by its own thread after a CUDA event, with at most
    ``depth`` batches dispatched and not yet yielded."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    packed_to = threading.Condition()
    n_packed = [0]

    def prep(i, b):
        err = None
        try:
            enc = encode(b)
        except BaseException as e:  # noqa: BLE001 (re-raised below)
            err = e
        with packed_to:  # batch i packs after batch i - 1
            packed_to.wait_for(lambda: n_packed[0] == i)
            try:
                if err is None:
                    packed = pack(enc)
            finally:
                n_packed[0] += 1
                packed_to.notify_all()
        if err is not None:
            raise err
        if not cuda:
            return packed, None, []
        return _upload_tree(packed, device, side)

    def pull(done, host):
        done.synchronize()
        return tuple(h.numpy() for h in host)

    with ThreadPoolExecutor(max_workers=max(workers, 1)) as ex, \
            ThreadPoolExecutor(max_workers=max(depth, 1) + 1) as pulls:
        preps: deque = deque()
        pending: deque = deque()

        def dispatch():
            packed, uploaded, on_side = preps.popleft().result()
            if cuda:
                cur = torch.cuda.current_stream(device)
                cur.wait_event(uploaded)
                for t in on_side:  # allocated on the side stream
                    t.record_stream(cur)
            out = run(packed)
            if not cuda:
                pending.append(pulls.submit(
                    lambda: tuple(t.numpy() for t in out)))
                return
            host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                     pin_memory=True) for t in out)
            for h, t in zip(host, out):
                h.copy_(t, non_blocking=True)
            done = torch.cuda.Event()
            done.record(cur)
            pending.append(pulls.submit(pull, done, host))

        for i, b in enumerate(batches):
            preps.append(ex.submit(prep, i, b))
            if len(preps) > max(workers, 1):
                dispatch()
                if len(pending) > depth:
                    yield pending.popleft().result()
        while preps:
            dispatch()
            if len(pending) > depth:
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()


class RetrievalEngine:
    """BM25 query execution over one language's index (text field, plus an
    optional title field for entity-boosted queries).

    ``doc_chunk`` (exhaustive) scans the document axis in pieces of that
    size (a multiple of 512) with a running top-k, bounding the score
    buffer at ``[Q, doc_chunk]``; by default the whole axis is scored at
    once. The pruned knobs keep the reference's names and defaults:
    ``rare_terms`` pass-1 terms per query, each read to ``posting_budget
    // rare_terms`` postings, terms above ``df_cap`` skipped in pass 1,
    ``n_candidates`` rescored; ``compact_rows`` moves the terms with df <=
    ``min(tiny_df_cap, per-term cap, df_cap)`` to the host-exact block,
    capped at ``tiny_width`` entries per query and shipped as log codes
    (``tiny_pack``), float16 (``tiny_f16``) or float32. The query-block
    widths are powers of two that never shrink below ``tiny_cols_floor``,
    ``d16_width_floor`` or an earlier batch's width; they set P and so C =
    min(n_candidates, P), as in the reference. ``row_layout`` picks the
    text field's pass-2 rows: ``"delta16"``, ``"packed32"``, or
    ``"auto"`` (delta16 on an index with stored doc lengths and quantized
    norms, else packed32); ``align_windows`` pads each term's CSR range to
    whole rows. ``deep_terms`` of each query's rarest selected terms read
    ``deep_cap`` postings in pass 1 instead of ``posting_budget //
    rare_terms`` (the text CSR then keeps up to ``deep_cap`` per term).
    The host side (CSR, rows, the tiny terms' exact sums) is built by the
    native runtime, ``kbner_tpu_torch/native``. ``topc_recall > 0`` takes
    the pass-1 top C with ``ops.bm25.approx_max_k`` at that recall target.

    With ``mesh`` (a ``DeviceMesh`` with a ``"data"`` dimension, from
    ``parallel.make_mesh``) the engine holds and searches the shard at its
    data coordinate (``n_shards`` shards of ``shard_size`` docs, the doc
    axis padded to ``n_shards * 512``) and merges the shards' top k over
    the data axis; each rank builds the engine from the same full index.
    Every search of a meshed engine is a collective: all ranks of the
    mesh call it with the same queries in the same order (the stream's
    collectives are issued from the caller's thread, in batch order).
    As in the reference, a mesh refuses ``device=False`` and
    ``deep_terms``, and its shards' pass-1 windows are never row-aligned
    (``align_windows`` has no effect there).
    """

    def __init__(
        self,
        text_index: BM25Index,
        store: Optional[DocStore] = None,
        title_index: Optional[BM25Index] = None,
        doc_chunk: Optional[int] = None,
        mode: str = "exhaustive",
        device="cuda",
        mesh=None,
        rare_terms: int = 12,
        posting_budget: int = 4096,
        df_cap: Optional[int] = None,
        n_candidates: int = 512,
        compact_rows: bool = True,
        tiny_df_cap: int = 64,
        tiny_width: int = 0,
        tiny_pack: bool = True,
        tiny_f16: bool = True,
        row_layout: str = "auto",
        tiny_cols_floor: int = 0,
        d16_width_floor: int = 0,
        topc_recall: float = 0.0,
        align_windows: bool = True,
        deep_terms: int = 0,
        deep_cap: int = 0,
    ):
        if mode not in ("exhaustive", "pruned"):
            raise ValueError(f"unknown engine mode {mode!r}")
        if device is False and (mesh is not None or mode != "pruned"):
            raise ValueError(
                "device=False supports only the unsharded pruned engine")
        if deep_terms and (mode != "pruned" or mesh is not None):
            raise ValueError("deep_terms>0 supports only the unsharded "
                             "pruned engine")
        self.mode = mode
        self._init_mesh(mesh)
        self.text_index = text_index
        self.title_index = title_index
        self.store = store
        self.doc_chunk = doc_chunk
        if mode == "pruned":
            self._init_pruned(
                rare_terms, posting_budget, df_cap, n_candidates,
                compact_rows, tiny_df_cap, tiny_width, tiny_pack, tiny_f16,
                row_layout, tiny_cols_floor, d16_width_floor, topc_recall,
                align_windows, deep_terms, deep_cap)
        # device=False keeps the pruned arrays on the host (numpy) for a
        # MixEngine to concatenate and upload once; search methods raise
        self.device = None if device is False else resolve_device(device)
        # field name -> device (doc_terms_t [Ld, N] int32,
        # doc_impacts_t [Ld, N] float32), the exhaustive kernel's operands
        # (N the shard's docs on a meshed engine)
        self.fields = {}
        # pruned, per field name: device pass-2 rows, their layout
        # (_row_meta), the per-term log bases of packed32 rows (_term_lo),
        # the device CSR (offsets, packed rows) and its log scale
        self.rows, self._row_meta, self._term_lo = {}, {}, {}
        self.csr, self._csr_scale = {}, {}
        self._upload()

    def _init_mesh(self, mesh) -> None:
        """The engine's place on ``mesh`` (None: unsharded): its shard of
        the document axis is its coordinate on the mesh's data axis, and
        its merges gather over that axis's group. Ranks that share a data
        coordinate hold the same shard."""
        self.mesh = mesh
        self.n_shards, self.shard, self._group = 1, 0, None
        if mesh is None:
            return
        from torch.distributed.device_mesh import DeviceMesh

        from ..parallel.mesh import DATA_AXIS, data_size

        if not (isinstance(mesh, DeviceMesh) and mesh.mesh_dim_names
                and DATA_AXIS in mesh.mesh_dim_names):
            raise TypeError(
                f"mesh must be a DeviceMesh with a {DATA_AXIS!r} dimension "
                f"(parallel.make_mesh), got {type(mesh).__name__}")
        self.n_shards = data_size(mesh)
        self.shard = mesh.get_local_rank(DATA_AXIS)
        self._group = mesh.get_group(DATA_AXIS)

    def _init_pruned(self, rare_terms, posting_budget, df_cap, n_candidates,
                     compact_rows, tiny_df_cap, tiny_width, tiny_pack,
                     tiny_f16, row_layout, tiny_cols_floor, d16_width_floor,
                     topc_recall, align_windows, deep_terms,
                     deep_cap) -> None:
        """The pruned knobs and the values derived from them, as the
        reference derives them."""
        idx = self.text_index
        if row_layout not in ("auto", "delta16", "packed32"):
            raise ValueError(f"unknown row_layout {row_layout!r}")
        d16_ok = idx.doc_dl is not None and idx.params.quantize_norms
        if row_layout == "delta16" and not d16_ok:
            raise ValueError(
                "row_layout='delta16' needs an index built with stored "
                "doc lengths and quantize_norms=True")
        # the text field's pass-2 rows: delta16 where the index allows it
        # and the caller did not ask for packed32; the title field's are
        # always packed32
        self._row_d16 = row_layout != "packed32" and d16_ok
        self.rare_terms = rare_terms
        self.posting_budget = posting_budget
        self.df_cap = df_cap if df_cap is not None else max(
            256, idx.n_docs // 20)
        self.n_candidates = n_candidates
        # > 0: the pass-1 top-C by ops.bm25.approx_max_k at this recall
        # target (read at each search)
        self.topc_recall = topc_recall
        self.per_term_cap = max(1, posting_budget // rare_terms)
        # deep windows: the deep_terms rarest selected terms of a query
        # read deep_cap postings in pass 1 instead of per_term_cap, and the
        # text CSR keeps min(df, deep_cap) postings per term
        self.deep_terms = int(deep_terms)
        self.deep_cap = max(int(deep_cap), self.per_term_cap)
        if self.deep_terms > rare_terms:
            raise ValueError("deep_terms must be <= rare_terms")
        self.compact_rows = compact_rows
        self.tiny_cap = (min(tiny_df_cap, self.per_term_cap, self.df_cap)
                         if compact_rows else 0)
        self.tiny_width = tiny_width
        self._want_tiny_pack = tiny_pack
        self.tiny_f16 = tiny_f16
        # row-aligned pass-1 windows; a meshed engine's shard CSRs keep the
        # packed layout, as the reference's do
        self._csr_aligned = align_windows and self.mesh is None
        # never-shrink width floors of the query blocks
        self._d16_w_floor = d16_width_floor
        self._t_cols_floor = tiny_cols_floor
        self._tiny_pack: Optional[Tuple[int]] = None  # (docbits,)

    # -- device residency -----------------------------------------------------

    def _upload(self) -> None:
        """Pad the doc axis of every field to one shared multiple of
        ``n_shards * _DOC_PAD`` and put the mode's arrays of this engine's
        shard (all of it when unsharded) on the device: a contiguous
        ``[Ld, shard_size]`` copy of each field for the exhaustive mode."""
        fields = {"text": self.text_index}
        if self.title_index is not None:
            fields["title"] = self.title_index
        pad_to = self.n_shards * _DOC_PAD
        n_padded = max(idx.doc_terms.shape[0] for idx in fields.values())
        n_padded = -(-n_padded // pad_to) * pad_to
        self.n_padded = n_padded
        self.shard_size = ss = n_padded // self.n_shards
        mine = slice(self.shard * ss, (self.shard + 1) * ss)
        for name, idx in fields.items():
            n = idx.doc_terms.shape[0]
            dt = np.pad(idx.doc_terms, ((0, n_padded - n), (0, 0)),
                        constant_values=-1)
            di = np.pad(idx.doc_impacts, ((0, n_padded - n), (0, 0)))
            if self.mode == "pruned":
                self._upload_pruned(name, idx, dt, di)
                continue
            self.fields[name] = tuple(
                torch.from_numpy(np.ascontiguousarray(a[mine].T)).to(
                    self.device) for a in (dt, di))

    def _put(self, x) -> torch.Tensor:
        """A host array on the engine's device (a tensor passes as is); a
        ``device=False`` engine keeps it on the host."""
        if isinstance(x, torch.Tensor):
            return x
        if self.device is None:
            return np.ascontiguousarray(x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _require_device(self) -> None:
        if self.device is None:
            raise ValueError(
                "engine built with device=False (host arrays only): search "
                "through the MixEngine that owns it")

    def _upload_pruned(self, name: str, idx: BM25Index, dt: np.ndarray,
                       di: np.ndarray) -> None:
        """One field's pass-2 rows and capped packed CSR, from its doc
        arrays ``dt``/``di`` padded to ``n_padded`` docs. The text field
        takes delta16 rows (int16 slots, int32 offsets and lengths, uint8
        norm codes) where ``_row_d16`` allows, else packed32 rows (int32
        slots, offsets, lengths) on a per-term log scale, without its tiny
        slots under compact rows; the title field always takes full
        packed32 rows. ``_row_meta[name]`` is the reference's
        ``("d16", k1, b, avgdl, r2)`` or ``("p32", term_bits, lo, step,
        r2)``."""
        n_padded = self.n_padded
        if name == "text" and self.compact_rows and self._want_tiny_pack:
            # one int32 per tiny entry, (code << docbits) | doc, when the
            # doc id leaves at least 9 code bits
            docbits = max(int(np.ceil(np.log2(max(n_padded, 2)))), 1)
            if 32 - docbits >= 9:
                self._tiny_pack = (docbits,)
        df = idx.csr[3]
        text = name == "text"
        dt_rows, di_rows = dt, di
        if text and self.compact_rows:
            dt_rows, di_rows = _drop_tiny_slots(dt, di, df, self.tiny_cap)
        put = self._put
        # a meshed engine builds its own shard's rows and CSR from the full
        # index's scales and remaps (S, ss: its place on the mesh)
        S, ss, mine = self.n_shards, self.shard_size, [self.shard]
        if text and self._row_d16:
            remap, self.n_nontiny = _nontiny_remap(df, self.tiny_cap)
            self._d16_remap = remap
            p = idx.params
            dl = np.zeros(n_padded, np.int64)
            dl[: len(idx.doc_dl)] = idx.doc_dl
            norm = (p.k1 * (1.0 - p.b + p.b * dl / idx.avgdl)).astype(
                np.float32)
            lut_max = int(dl.max(initial=0)) + 1
            lut = np.fromiter((long_to_int4(i) for i in range(lut_max)),
                              np.uint8, count=lut_max)
            normc = lut[dl]
            if self.mesh is None:
                flat, off, lens, r2 = _pack_doc_rows_delta16(
                    dt_rows, di_rows, remap, idx.idf, norm)
            else:
                flat, off, lens, r2 = shard_rows_delta16(
                    dt_rows, di_rows, remap, idx.idf, norm, S, ss, mine)
                flat, off, lens = flat[0], off[0], lens[0]
                normc = normc[self.shard * ss:(self.shard + 1) * ss]
            self._row_meta[name] = ("d16", float(p.k1), float(p.b),
                                    float(idx.avgdl), r2)
            # the rows are stored as int16 and read as uint16: the kernel
            # takes the raw 16 bits, the plain version widens with & 0xFFFF
            self.rows[name] = (put(flat.view(np.int16)), put(off),
                               put(lens.astype(np.int32)), put(normc))
        else:
            code_bits = 32 - max(int(np.ceil(np.log2(len(idx.vocab) + 2))),
                                 1)
            term_lo, t_step = _term_scale_from_csr(idx, code_bits)
            self._term_lo[name] = term_lo
            if self.mesh is None:
                flat, off, lens, tb, lo, step, r2 = _pack_doc_rows_ragged(
                    dt_rows, di_rows, len(idx.vocab),
                    scale=(term_lo, t_step))
            else:
                flat, off, lens, tb, step, r2 = shard_rows_packed32(
                    dt_rows, di_rows, len(idx.vocab), (term_lo, t_step), S,
                    ss, mine)
                flat, off, lens, lo = flat[0], off[0], lens[0], 0.0
            self._row_meta[name] = ("p32", tb, lo, step, r2)
            self.rows[name] = (put(flat), put(off),
                               put(lens.astype(np.int32)))
        if text:
            self.max_seg = int(lens.max(initial=0))
        # the device never looks up a tiny text term, so its postings leave
        # the text CSR; the title CSR keeps every term
        if self.mesh is None:
            off32, packed, clo, cstep = idx.csr_rows_packed(
                cap=self.deep_cap if text and self.deep_terms
                else self.per_term_cap, min_df=self.tiny_cap if text else 0,
                align_windows=self._csr_aligned)
        else:
            off32, packed, clo, cstep = shard_csr(
                dt, di, len(idx.vocab), self.per_term_cap, S, ss,
                gdf=df if text and self.compact_rows and self.tiny_cap > 0
                else None, tiny_cap=self.tiny_cap, shards=mine)
            off32, packed = off32[0], packed[0]
        self._csr_scale[name] = (clo, cstep)
        self.csr[name] = (put(off32), put(packed))

    # -- host query preparation (pruned) --------------------------------------

    def _select_rare_terms(self, q_terms: np.ndarray,
                           index: Optional[BM25Index] = None,
                           df_cap: Optional[int] = None,
                           df_floor: int = 0) -> np.ndarray:
        """Per query: the ``rare_terms`` lowest-df in-vocab terms of
        ``index`` (the text index by default) with df_floor < df <=
        ``df_cap`` (the engine's by default): pass-1 term selection. With
        compact rows ``df_floor`` leaves out the tiny terms, whose exact
        sums arrive in the host block."""
        df = (index or self.text_index).csr[3]
        cap = df_cap if df_cap is not None else self.df_cap
        big = np.iinfo(np.int64).max
        term_df = np.where(q_terms >= 0, df[np.maximum(q_terms, 0)], big)
        term_df = np.where((term_df <= cap) & (term_df > df_floor),
                           term_df, big)
        order = np.argsort(term_df, axis=1, kind="stable")[:, :self.rare_terms]
        rare = np.take_along_axis(q_terms, order, axis=1).astype(np.int32)
        rare[np.take_along_axis(term_df, order, axis=1) == big] = -1
        return rare

    def _gather_tiny_exact(self, q_terms: np.ndarray, q_weights: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host exact block of the tiny terms: per query, every posting of
        every tiny query term, summed by doc in float32 in posting order,
        docs in the order first seen (``native.gather_tiny_exact``).
        Returns (doc [Q, T] int32, imp [Q, T], exact [Q, T]) with -1/0
        padding, T a multiple of 128."""
        offsets, p_doc, p_imp, df = self.text_index.csr
        is_tiny = (q_terms >= 0) & (df[np.maximum(q_terms, 0)]
                                    <= self.tiny_cap)
        return native.gather_tiny_exact(offsets, p_doc, p_imp, q_terms,
                                        q_weights, is_tiny)

    def _tiny_block(self, q_terms: np.ndarray, q_weights: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """The tiny exact block, capped at ``tiny_width`` entries per query
        (the largest exact sums are kept)."""
        t_doc, _, t_ex = self._gather_tiny_exact(q_terms, q_weights)
        if self.tiny_width and t_doc.shape[1] > self.tiny_width:
            W = self.tiny_width
            idx = np.argpartition(-t_ex, W - 1, axis=1)[:, :W]
            t_doc = np.take_along_axis(t_doc, idx, axis=1)
            t_ex = np.take_along_axis(t_ex, idx, axis=1)
        return t_doc, t_ex

    def _remap_queries_d16(self, qt: np.ndarray, qw: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """The text field's pass-2 query block (the reference's
        ``_text_query_block`` for delta16 rows): terms remapped into the
        rows' dense id space with idf folded into the weights, left-packed
        (tiny and OOV slots dropped) to a power-of-two width of at least
        8."""
        Q, L = qt.shape
        safe = np.maximum(qt, 0)
        q2 = np.where(qt >= 0, self._d16_remap[safe], -1)
        w2 = (qw * self.text_index.idf[safe]).astype(np.float32)
        valid = q2 >= 0
        W = min(_pow2_width(int(valid.sum(axis=1).max(initial=1)), 8), L)
        W = max(W, min(self._d16_w_floor, L))
        self._d16_w_floor = max(self._d16_w_floor, W)
        out_t = np.full((Q, W), -1, np.int32)
        out_w = np.zeros((Q, W), np.float32)
        rows, _ = np.nonzero(valid)
        pos = (np.cumsum(valid, axis=1) - 1)[valid]
        out_t[rows, pos] = q2[valid]
        out_w[rows, pos] = w2[valid]
        return out_t, out_w

    def _text_query_block(self, qt: np.ndarray, qw: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """The text field's pass-2 query block in the layout of its rows:
        remapped and left-packed for delta16 rows, the raw ids with the
        per-term bases folded into the weights for packed32 rows."""
        if self._row_d16:
            return self._remap_queries_d16(qt, qw)
        return (np.ascontiguousarray(qt, np.int32),
                self._fold_weights(qt, qw, "text"))

    def _fold_weights(self, qt: np.ndarray, qw: np.ndarray,
                      field: str) -> np.ndarray:
        """Query weights with the per-term row base folded in: a matched
        packed32 slot decodes as ``exp((code - 1) * step)``, so the
        contribution ``w * imp`` is ``(w * exp(term_lo[t])) * exp((code -
        1) * step)``. Negative ids never match a slot, so their weight is
        irrelevant."""
        tl = self._term_lo.get(field)
        if tl is None:
            return np.ascontiguousarray(qw, np.float32)
        return np.ascontiguousarray(qw * np.exp(tl[np.maximum(qt, 0)]),
                                    np.float32)

    def _pack_queries(self, q_terms: np.ndarray, q_weights: np.ndarray,
                      title_terms: Optional[np.ndarray] = None,
                      title_weights: Optional[np.ndarray] = None):
        """Host half of a pruned search: the rare-term blocks, the tiny
        exact block in its wire encoding (power-of-two width, never
        shrinking), and one query block per field. Separate arrays, not
        the reference's single upload.

        With title terms a second rare block, selected from the title
        index with its own df cap (title rows are never compacted), drives
        candidate generation from the title CSR: ES ``bool.should`` finds
        a document through either field. Returns (rares, tiny, blocks):
        ``rares`` one [Q, M] block per CSR, ``tiny`` None, ``("pack", enc
        int64, lo, step)``, ``("f16", doc, ex float16)`` or ``("f32", doc,
        ex float32)``, ``blocks`` one (terms, weights) per field. On an
        engine meshed over S > 1 shards the tiny block is its own shard's
        slice of :func:`slice_tiny_per_shard` (shard-local ids, float32
        sums)."""
        df_floor = self.tiny_cap if self.compact_rows else 0
        rares = [self._select_rare_terms(q_terms, df_floor=df_floor)]
        blocks = [self._text_query_block(q_terms, q_weights)]
        if title_terms is not None:
            tcap = max(256, self.title_index.n_docs // 20)
            rares.append(self._select_rare_terms(
                title_terms, index=self.title_index, df_cap=tcap))
            blocks.append((np.ascontiguousarray(title_terms, np.int32),
                           self._fold_weights(title_terms, title_weights,
                                              "title")))
        tiny = None
        if self.compact_rows and self.n_shards > 1:
            block, Tb = slice_tiny_per_shard(
                *self._tiny_block(q_terms, q_weights), self.n_shards,
                self.shard_size)
            if block is not None:
                t_doc = block[self.shard, :, :Tb]
                t_ex = -block[self.shard, :, Tb:].view(np.float32)
                tiny = ("f32", t_doc, np.where(t_doc >= 0, t_ex,
                                               np.float32(0)))
        elif self.compact_rows:
            t_doc, t_ex = self._tiny_block(q_terms, q_weights)
            t_cols = t_doc.shape[1]
            if t_cols:
                bucket = max(_pow2_width(t_cols, 256), self._t_cols_floor)
                self._t_cols_floor = max(self._t_cols_floor, bucket)
                pad = bucket - t_cols
                t_doc = np.pad(t_doc, ((0, 0), (0, pad)), constant_values=-1)
                t_ex = np.pad(t_ex, ((0, 0), (0, pad)))
                if self._tiny_pack is not None:
                    tiny = self._encode_tiny_pack(t_doc, t_ex)
                elif self.tiny_f16:
                    tiny = ("f16", t_doc, t_ex.astype(np.float16))
                else:
                    tiny = ("f32", t_doc, t_ex)
        return rares, tiny, blocks

    def _encode_tiny_pack(self, t_doc: np.ndarray, t_ex: np.ndarray):
        """One 32-bit word per tiny entry, ``(log_code << docbits) | doc``,
        on a per-batch log scale from the batch's exact-sum range; pads
        are code 0 with an all-ones doc."""
        docbits = self._tiny_pack[0]
        levels = (1 << (32 - docbits)) - 2
        p = t_ex > 0
        if p.any():
            lo = float(np.log(float(t_ex[p].min())))
            hi = float(np.log(float(t_ex[p].max())))
            step = max((hi - lo) / max(levels, 1), 1e-12)
        else:
            lo, step = 0.0, 1.0
        code = np.zeros(t_ex.shape, np.uint32)
        code[p] = np.clip(np.rint((np.log(t_ex[p]) - lo) / step),
                          0, levels).astype(np.uint32) + 1
        docmask = (1 << docbits) - 1
        enc = (code << docbits) | np.where(
            t_doc >= 0, t_doc, docmask).astype(np.uint32)
        # the scale travels as float32, as in the reference's upload
        return ("pack", enc.astype(np.int64), float(np.float32(lo)),
                float(np.float32(step)))

    # -- search ---------------------------------------------------------------

    def _unpack_tiny(self, tiny) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device decode of the tiny block: (doc [Q, T] int64 with -1
        pads, exact sums [Q, T] float32)."""
        kind = tiny[0]
        if kind == "pack":
            _, enc, t_lo, t_step = tiny
            enc = self._put(enc)
            docbits = self._tiny_pack[0]
            d = enc & ((1 << docbits) - 1)
            code = (enc >> docbits).to(torch.float32)
            ex = torch.where(code > 0,
                             torch.exp(t_lo + (code - 1.0) * t_step), 0.0)
            return torch.where(ex > 0, d, -1), ex
        _, t_doc, t_ex = tiny
        return (self._put(t_doc).long(), self._put(t_ex).to(torch.float32))

    def _field(self, name: str, terms: np.ndarray,
               weights: np.ndarray) -> tuple:
        """One field's pass-2 operands: the query block on the device, the
        field's rows and the scalars of its layout (the 9-tuple delta16 or
        the 8-tuple packed32 form of ``ops.bm25._rescore_operands``)."""
        meta = self._row_meta[name]
        return (self._put(terms), self._put(weights), *self.rows[name],
                *meta[1:4])

    def _device_queries(self, packed):
        """One batch's pruned-search operands on the device, from the
        output of :meth:`_pack_queries`: the pooled pass-1 keys [Q, P]
        int64 (the text windows, the title windows, then the tiny block's
        keys), the pass-2 fields (text, then title), the decoded tiny block
        (or None, None) and the pass-1 keyword arguments of
        ``bm25_pruned_topk_packed`` (those ``pass2_operands`` takes
        too)."""
        rares, tiny, blocks = packed
        names = ("text", "title")[:len(blocks)]
        # one ranking scale for every key: the text CSR's with headroom;
        # the title windows are re-encoded onto it
        rank_lo, csr_step = self._csr_scale["text"]
        rank_step = _rank_step(csr_step)
        key_blocks = []
        for name, rare in zip(names, rares):
            lo, step = self._csr_scale[name]
            rare = self._put(rare)
            windows = [(rare, self.per_term_cap)]
            if name == "text" and self.deep_terms:
                # selection is df-ascending: the first deep_terms columns
                # are the rarest terms, read to deep_cap
                windows = [(rare[:, :self.deep_terms], self.deep_cap),
                           (rare[:, self.deep_terms:], self.per_term_cap)]
            for cols, cap in windows:
                key_blocks.append(gather_pruned_candidate_keys(
                    cols, *self.csr[name], cap, reencode=True, lo_src=lo,
                    step_src=step, lo_dst=rank_lo, step_dst=rank_step,
                    aligned=self._csr_aligned))
        t_doc = t_ex = None
        if tiny is not None:
            t_doc, t_ex = self._unpack_tiny(tiny)
            key_blocks.append(_tiny_keys(t_doc, t_ex, rank_lo, rank_step))
        fields = tuple(self._field(name, *block)
                       for name, block in zip(names, blocks))
        # a doc enters the pool at most once per window of each rare block
        # and once from the host-deduplicated tiny block
        kwargs = dict(n_candidates=self.n_candidates,
                      max_dup_shifts=(self.rare_terms * len(rares)
                                      + (tiny is not None)),
                      imp_lo=rank_lo, imp_step=rank_step,
                      ragged_rows=tuple(self._row_meta[n][4] for n in names),
                      topc_recall=self.topc_recall)
        return torch.cat(key_blocks, dim=1), fields, (t_doc, t_ex), kwargs

    def _run_pruned(self, packed, k: int) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """Pooled pass 1 and pass 2 of one batch from the output of
        :meth:`_pack_queries`, on the device: scores [Q, k] float32 and ids
        [Q, k] int64 (-1 where fewer score). A meshed engine searches its
        shard, makes its ids global and merges every shard's top k
        (:meth:`_merge`)."""
        keys, fields, (t_doc, t_ex), kwargs = self._device_queries(packed)
        n_real = (self.text_index.n_docs if self.mesh is None
                  else self.shard_size)
        scores, ids = bm25_pruned_topk_packed(
            keys, fields, n_real_docs=n_real, k=k, tiny_doc=t_doc,
            tiny_ex=t_ex, **kwargs)
        if self.mesh is not None:
            ids = torch.where(ids >= 0, ids + self.shard * self.shard_size,
                              -1)
        return self._merge(scores, ids, k)

    def _merge(self, scores: torch.Tensor, ids: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The top k over every shard's (scores, global ids): one
        all-gather over the mesh's data axis (:func:`merge_shard_topk`);
        an unsharded engine's results pass as they are."""
        if self.mesh is None:
            return scores, ids
        return merge_shard_topk(scores, ids, k, self._group)

    def _search_device(self, q_terms: np.ndarray, q_weights: np.ndarray,
                       k: int, title_terms: Optional[np.ndarray] = None,
                       title_weights: Optional[np.ndarray] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k of pre-encoded queries as tensors on the engine's device
        (scores [Q, k] float32, ids [Q, k] int64), not yet pulled."""
        self._require_device()
        if title_terms is not None and self.title_index is None:
            raise ValueError("engine built without a title index")
        with span("kbner.retrieve.score", docs=self.text_index.n_docs):
            if self.mode == "pruned":
                if title_terms is not None:
                    title_terms = np.asarray(title_terms)
                    title_weights = np.asarray(title_weights)
                return self._run_pruned(self._pack_queries(
                    np.asarray(q_terms), np.asarray(q_weights), title_terms,
                    title_weights), k)

            def put(x, dtype):
                return torch.as_tensor(np.asarray(x, dtype=dtype),
                                       device=self.device)

            fields = [(put(q_terms, np.int32), put(q_weights, np.float32),
                       *self.fields["text"])]
            if title_terms is not None:
                fields.append((put(title_terms, np.int32),
                               put(title_weights, np.float32),
                               *self.fields["title"]))
            return self._merge(*bm25_topk(
                fields, k=k, doc_chunk=self.doc_chunk,
                id_offset=self.shard * self.shard_size), k)

    def search_encoded(
        self,
        q_terms: np.ndarray,
        q_weights: np.ndarray,
        k: int = 10,
        title_terms: Optional[np.ndarray] = None,
        title_weights: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over pre-encoded queries. Returns (scores, ids) [Q, k]."""
        scores, ids = self._search_device(q_terms, q_weights, k, title_terms,
                                          title_weights)
        with span("kbner.retrieve.pull"):
            return scores.cpu().numpy(), ids.cpu().numpy()

    def search_stream(self, batches, k: int = 10, workers: int = 3,
                      depth: int = 2, max_query_terms: int = 64):
        """Pipelined search over an iterable of batches, yielding
        ``(scores, ids)`` numpy arrays per batch, in order.

        A batch is ``(q_terms, q_weights)`` or a list of raw query strings.
        In pruned mode three stages overlap (:func:`_pipelined`):
        ``workers`` prep threads analyze and encode batch i+1, pack it on
        the host (in batch order, so the never-shrink query widths grow as
        per-batch calls grow them) and start its upload while the card
        runs batch i; the results come back through pinned buffers, with
        at most ``depth`` batches dispatched and not yet yielded.
        Exhaustive mode searches each batch with :meth:`search_encoded`.
        On a meshed engine the merges run on the caller's thread, in batch
        order, so every rank must consume the stream. An empty batch (no
        query strings, or query arrays of no rows) yields empty ``[0, k]``
        results in its place and searches nothing.
        """
        self._require_device()

        def encode(b):
            if len(b) and isinstance(b[0], str):
                b = self.text_index.encode_queries(
                    list(b), max_query_terms=max_query_terms)
            if not len(b):
                return None
            qt, qw = (np.asarray(x) for x in b)
            return (qt, qw) if len(qt) else None

        def none_found(on):
            return (torch.zeros((0, k), dtype=torch.float32, device=on),
                    torch.zeros((0, k), dtype=torch.int64, device=on))

        if self.mode != "pruned":
            return (tuple(t.numpy() for t in none_found("cpu")) if e is None
                    else self.search_encoded(*e, k=k)
                    for e in map(encode, batches))
        return _pipelined(
            batches, encode, lambda e: e and self._pack_queries(*e),
            lambda packed: (none_found(self.device) if packed is None
                            else self._run_pruned(packed, k)),
            self.device, workers, depth)

    def search(
        self,
        queries: Sequence[str],
        k: int = 10,
        entity_queries: Optional[Sequence[Sequence[str]]] = None,
        title_boost: float = 2.0,
        max_query_terms: int = 64,
    ) -> List[List[RetrievedDoc]]:
        """BM25 sentence retrieval, optionally entity-boosted.

        ``entity_queries[i]`` lists entity surface forms for query i; their
        terms hit the title field with ``title_boost`` (ES bool.should with
        match(title=entity, boost=2.0)).
        """
        with span("kbner.retrieve.analyze", queries=len(queries)) as s:
            q_terms, q_weights = self.text_index.encode_queries(
                list(queries), max_query_terms=max_query_terms)
            t_terms = t_weights = None
            if entity_queries is not None:
                if self.title_index is None:
                    raise ValueError("entity queries need a title index")
                joined = [" ".join(ents) for ents in entity_queries]
                t_terms, t_weights = self.title_index.encode_queries(
                    joined, max_query_terms=max_query_terms,
                    boosts=[title_boost] * len(joined))
            if s:
                s.add("terms", np.count_nonzero(q_weights))
        scores, ids = self.search_encoded(
            q_terms, q_weights, k=k, title_terms=t_terms,
            title_weights=t_weights)
        return self._materialize(scores, ids)

    def _materialize(self, scores: np.ndarray, ids: np.ndarray
                     ) -> List[List[RetrievedDoc]]:
        """Result records per query; padding docs, non-matches (score <= 0)
        and the -1 fill of a short top-k are dropped."""
        results: List[List[RetrievedDoc]] = []
        n_real = self.text_index.n_docs
        with span("kbner.retrieve.materialize") as sp:
            for qi in range(ids.shape[0]):
                row = []
                for r in range(ids.shape[1]):
                    d, s = int(ids[qi, r]), float(scores[qi, r])
                    if d < 0 or d >= n_real or s <= 0.0:
                        continue
                    if self.store is not None:
                        row.append(self.store.materialize(d, s))
                    else:
                        row.append(RetrievedDoc(doc_id=d, score=s))
                results.append(row)
            if sp:
                sp.add("docs_returned", sum(map(len, results)))
        return results

    def search_texts_stream(self, queries: Sequence[str], k: int = 10,
                            batch_size: int = 1024,
                            max_query_terms: int = 64,
                            ) -> List[List[RetrievedDoc]]:
        """Text queries through :meth:`search_stream` in chunks of
        ``batch_size`` raw strings, which its prep threads analyze and
        encode while the card searches the previous chunk."""
        batches = [list(queries[i:i + batch_size])
                   for i in range(0, len(queries), batch_size)]
        out: List[List[RetrievedDoc]] = []
        for scores, ids in self.search_stream(
                batches, k=k, max_query_terms=max_query_terms):
            out.extend(self._materialize(scores, ids))
        return out


def langwiki_search(
    engines: Dict[str, RetrievalEngine],
    queries: Sequence[str],
    langs: Sequence[str],
    k: int = 10,
) -> List[List[RetrievedDoc]]:
    """Language-routed search (the reference's ``langwiki`` setting for
    multilingual training: one index per language, each sentence queried
    in its own language's). A query whose language has no engine gets no
    results."""
    by_lang: Dict[str, List[int]] = {}
    for i, lang in enumerate(langs):
        by_lang.setdefault(lang, []).append(i)
    out: List[List[RetrievedDoc]] = [[] for _ in queries]
    for lang, idxs in by_lang.items():
        eng = engines.get(lang)
        if eng is None:
            continue
        for i, res in zip(idxs, eng.search([queries[i] for i in idxs],
                                           k=k)):
            out[i] = res
    return out


def mix_search(
    engines: Dict[str, RetrievalEngine],
    queries: Sequence[str],
    k: int = 10,
    entity_queries: Optional[Sequence[Sequence[str]]] = None,
    title_boost: float = 2.0,
    max_query_terms: int = 64,
) -> List[List[Tuple[str, RetrievedDoc]]]:
    """The MIX track's fan-out: every query searched in every language's
    engine and the results merged by score (the reference's wildcard
    ``*wiki_v1`` msearch). ``entity_queries`` adds the title-boosted
    clauses on every engine that has a title index. Every engine's batch
    is dispatched before any result is pulled; the merge is a stable sort
    by score, so equal scores keep the engines' order, then their rank."""
    dispatched = []
    for lang, eng in engines.items():
        q_terms, q_weights = eng.text_index.encode_queries(
            list(queries), max_query_terms=max_query_terms)
        t_terms = t_weights = None
        if entity_queries is not None and eng.title_index is not None:
            joined = [" ".join(ents) for ents in entity_queries]
            t_terms, t_weights = eng.title_index.encode_queries(
                joined, max_query_terms=max_query_terms,
                boosts=[title_boost] * len(joined))
        dispatched.append((lang, eng, eng._search_device(
            q_terms, q_weights, k, t_terms, t_weights)))
    per_engine = {lang: eng._materialize(scores.cpu().numpy(),
                                         ids.cpu().numpy())
                  for lang, eng, (scores, ids) in dispatched}
    merged: List[List[Tuple[str, RetrievedDoc]]] = []
    for qi in range(len(queries)):
        rows = [(lang, doc) for lang, res in per_engine.items()
                for doc in res[qi]]
        rows.sort(key=lambda x: -x[1].score)
        merged.append(rows[:k])
    return merged


def _host(x) -> np.ndarray:
    """A host copy of an engine array (numpy, or a tensor anywhere)."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class MixEngine:
    """The MIX track's search over several languages' pruned engines as
    one structure on the card (counterpart of the reference's
    ``MixEngine``, its wildcard ``*wiki_v1`` msearch).

    The languages' pass-2 delta16 rows, slot offsets, lengths and norm
    codes are concatenated along the doc axis (offsets rebased to global
    slots), and their packed pass-1 CSRs along the row axis (offset tables
    rebased to global elements, one after another behind per-language
    vocabulary bases), so the card holds the sum of the languages'
    arrays, not M copies of the largest. A batch runs the pruned search of
    :class:`RetrievalEngine` once per language: pass 1 over the language's
    CSR, pass 2 through K2 (``ops.bm25.delta16_rescore``) on the
    concatenated rows with the candidates shifted to global ids
    (``rescore_id_offset``), one launch per language; the per-language
    top-k lists merge on the card in ``lax.top_k``'s order (language,
    then rank, among equal scores).

    Build the engines with ``device=False`` so their arrays stay on the
    host until this class uploads the concatenation once to ``device``.
    ``topc_recall > 0`` takes each language's pass-1 top C with
    ``ops.bm25.approx_max_k``, as :class:`RetrievalEngine` does.
    """

    # never-shrink floors of the query blocks' widths, the reference's
    W_FLOOR = 64         # remapped delta16 query terms
    T_COLS_FLOOR = 512   # tiny-block entries

    def __init__(self, engines: Dict[str, RetrievalEngine],
                 n_candidates: int = 512, device="cuda",
                 topc_recall: float = 0.0):
        if not engines:
            raise ValueError("MixEngine needs at least one engine")
        self.device = resolve_device(device)
        self.langs = list(engines)
        self.engines = engines
        e0 = engines[self.langs[0]]
        for lang, e in engines.items():
            if e.mode != "pruned" or not e._row_d16 or not e.compact_rows:
                raise ValueError(
                    f"engine {lang!r}: MixEngine needs pruned mode with "
                    "delta16 rows and compact_rows")
            if e.mesh is not None:
                raise ValueError(
                    f"engine {lang!r}: MixEngine concatenates unsharded "
                    "engines (shard the mix group over languages instead)")
            if (e.rare_terms, e.per_term_cap) != (
                    e0.rare_terms, e0.per_term_cap):
                raise ValueError("engines must share pass-1 knobs "
                                 "(rare_terms, posting budget)")
            p, p0 = e.text_index.params, e0.text_index.params
            if (p.k1, p.b) != (p0.k1, p0.b):
                raise ValueError("engines must share BM25 params")
            if e._csr_aligned != e0._csr_aligned:
                raise ValueError("engines must share align_windows")
            # every language's remapped query block comes out as wide
            e._d16_w_floor = max(e._d16_w_floor, self.W_FLOOR)
        self.rare_terms = e0.rare_terms
        self.per_term_cap = e0.per_term_cap
        self.n_candidates = n_candidates
        self.topc_recall = topc_recall
        self._csr_aligned = e0._csr_aligned
        self._k1 = float(e0.text_index.params.k1)
        self._b = float(e0.text_index.params.b)
        self._t_cols_floor = self.T_COLS_FLOOR
        self._r2 = max(e._row_meta["text"][4] for e in engines.values())

        flats, offs, lens, normcs, csr_offs, csr_pks = [], [], [], [], [], []
        # per language: avgdl, CSR lo and step (float32, as the reference
        # carries them), real docs, doc base, vocabulary base
        self._scalars = []
        rows = elems = docs = ventries = 0
        for lang in self.langs:
            e = engines[lang]
            flat, off, ln, normc = (_host(a) for a in e.rows["text"])
            co, cp = (_host(a) for a in e.csr["text"])
            lo, step = e._csr_scale["text"]
            self._scalars.append((
                float(np.float32(e.text_index.avgdl)), float(np.float32(lo)),
                float(np.float32(step)), e.text_index.n_docs, docs,
                ventries))
            flats.append(flat)
            offs.append(off.astype(np.int64) + rows * flat.shape[1])
            lens.append(ln)
            normcs.append(normc)
            csr_offs.append(co.astype(np.int64) + elems)
            csr_pks.append(cp)
            rows += flat.shape[0]
            elems += cp.size
            docs += off.shape[0]
            ventries += co.shape[0]
        if max(offs[-1].max(initial=0), csr_offs[-1].max(initial=0)) \
                >= 2**31:
            raise ValueError("concatenated mix layout exceeds int32 "
                             "offsets; shard the mix group")
        # a covering read of r2 rows from the last language's last segment
        # may pass its own guard rows when an earlier language's r2 is
        # larger: the plain pass 2 reads them (K2 reads only the segment)
        last_r2 = engines[self.langs[-1]]._row_meta["text"][4]
        flats.append(np.zeros((self._r2 - last_r2, flats[0].shape[1]),
                              flats[0].dtype))
        self._doc_base = np.asarray([s[4] for s in self._scalars], np.int64)
        self._dev = tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (np.concatenate(flats), np.concatenate(offs).astype(
                np.int32), np.concatenate(lens), np.concatenate(normcs),
                      np.concatenate(csr_offs).astype(np.int32),
                      np.concatenate(csr_pks)))

    @property
    def nbytes(self) -> int:
        """Bytes of the concatenated structure on the device."""
        return sum(t.nbytes for t in self._dev)

    # -- query packing ---------------------------------------------------------

    def _encode(self, queries: Sequence[str], max_query_terms: int = 64):
        """Each language's analysis and encoding of ``queries``."""
        return [self.engines[lang].text_index.encode_queries(
            list(queries), max_query_terms=max_query_terms)
            for lang in self.langs]

    def _pack(self, encoded) -> tuple:
        """Host half of a batch from :meth:`_encode`'s output, one [M, Q,
        ...] array per operand: rare term ids [M, Q, RM] int32, the tiny
        block's docs [M, Q, T] int32 (-1 pads) and exact sums [M, Q, T]
        float16, and the remapped delta16 query block, terms [M, Q, W]
        int32 and idf-folded weights [M, Q, W] float32. T and W are
        never-shrink powers of two shared by every language."""
        per = []
        t_max, w_max = 1, self.W_FLOOR
        for lang, (qt, qw) in zip(self.langs, encoded):
            e = self.engines[lang]
            rare = e._select_rare_terms(qt, df_floor=e.tiny_cap)
            t_doc, t_ex = e._tiny_block(qt, qw)
            qt2, qw2 = e._remap_queries_d16(qt, qw)
            per.append((rare, t_doc, t_ex, qt2, qw2))
            t_max = max(t_max, t_doc.shape[1])
            w_max = max(w_max, qt2.shape[1])
        t_cols = max(_pow2_width(t_max, 256), self._t_cols_floor)
        self._t_cols_floor = t_cols
        M, Q = len(self.langs), encoded[0][0].shape[0]
        rare_all = np.empty((M, Q, self.rare_terms), np.int32)
        t_doc_all = np.full((M, Q, t_cols), -1, np.int32)
        t_ex_all = np.zeros((M, Q, t_cols), np.float16)
        qt_all = np.full((M, Q, w_max), -1, np.int32)
        qw_all = np.zeros((M, Q, w_max), np.float32)
        for li, (rare, t_doc, t_ex, qt2, qw2) in enumerate(per):
            rare_all[li] = rare
            t_doc_all[li, :, :t_doc.shape[1]] = t_doc
            t_ex_all[li, :, :t_ex.shape[1]] = t_ex
            qt_all[li, :, :qt2.shape[1]] = qt2
            qw_all[li, :, :qw2.shape[1]] = qw2
        return rare_all, t_doc_all, t_ex_all, qt_all, qw_all

    def pack_batch(self, queries: Sequence[str],
                   max_query_terms: int = 64) -> tuple:
        """:meth:`_pack` of ``queries``, each analyzed once per language
        with that language's analyzer."""
        return self._pack(self._encode(queries, max_query_terms))

    # -- device search ---------------------------------------------------------

    def _search(self, packed, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """One batch on the device: the pruned search of every language in
        turn, then the merge of their top-k lists. Returns (scores [Q, k]
        float32, global ids [Q, k] int64, -1 where fewer score)."""
        rare, t_doc, t_ex, qt, qw = (
            x if isinstance(x, torch.Tensor)
            else torch.from_numpy(x).to(self.device) for x in packed)
        flat, off, ln, normc, csr_off, csr_pk = self._dev
        scores, ids = [], []
        for li, (avgdl, lo, step, n_real, doc_b, voc_b) in enumerate(
                self._scalars):
            # the ranking scale of the pooled keys: the language's CSR
            # scale with headroom, summed in float32
            rank_step = _rank_step(step, np.float32)
            r = rare[li]
            keys = gather_pruned_candidate_keys(
                torch.where(r >= 0, r + voc_b, -1), csr_off, csr_pk,
                self.per_term_cap, reencode=True, lo_src=lo, step_src=step,
                lo_dst=lo, step_dst=rank_step, aligned=self._csr_aligned)
            td = t_doc[li].long()
            ex = torch.where(td >= 0, t_ex[li].to(torch.float32), 0.0)
            s, i = bm25_pruned_topk_packed(
                torch.cat([keys, _tiny_keys(td, ex, lo, rank_step)], dim=1),
                ((qt[li], qw[li], flat, off, ln, normc, self._k1, self._b,
                  avgdl),),
                n_real_docs=n_real, k=k, n_candidates=self.n_candidates,
                max_dup_shifts=self.rare_terms + 1, imp_lo=lo,
                imp_step=rank_step, tiny_doc=td, tiny_ex=ex,
                ragged_rows=(self._r2,), rescore_id_offset=doc_b,
                topc_recall=self.topc_recall)
            scores.append(s)
            ids.append(i)
        s, i = torch.cat(scores, dim=1), torch.cat(ids, dim=1)
        top, pos = _top_sorted(s, k)
        return top, torch.gather(i, 1, pos)

    # -- public API ------------------------------------------------------------

    def search_texts(self, queries: Sequence[str], k: int = 10,
                     max_query_terms: int = 64
                     ) -> List[List[Tuple[str, RetrievedDoc]]]:
        """MIX retrieval of raw-string queries: per query the top ``k``
        over every language, as (language, document) by score."""
        scores, ids = self._search(
            self.pack_batch(queries, max_query_terms=max_query_terms), k)
        return self._materialize(scores.cpu().numpy(), ids.cpu().numpy())

    def search_texts_stream(self, query_batches, k: int = 10,
                            workers: int = 3, depth: int = 2,
                            max_query_terms: int = 64):
        """Pipelined MIX search over batches of raw-string queries,
        yielding each batch's merged results in order: prep threads
        encode and pack batch i+1 and upload it while the card searches
        batch i (:func:`_pipelined`)."""
        for scores, ids in _pipelined(
                query_batches,
                lambda qs: self._encode(qs, max_query_terms), self._pack,
                lambda packed: self._search(packed, k), self.device,
                workers, depth):
            yield self._materialize(scores, ids)

    def _materialize(self, scores: np.ndarray, ids: np.ndarray
                     ) -> List[List[Tuple[str, RetrievedDoc]]]:
        """Global ids to (language, record) through the doc bases; -1
        fills, padding docs and non-matches (score <= 0) are dropped."""
        out: List[List[Tuple[str, RetrievedDoc]]] = []
        for qi in range(ids.shape[0]):
            row = []
            for r in range(ids.shape[1]):
                g, s = int(ids[qi, r]), float(scores[qi, r])
                if g < 0 or s <= 0.0:
                    continue
                li = int(np.searchsorted(self._doc_base, g,
                                         side="right")) - 1
                lang = self.langs[li]
                eng = self.engines[lang]
                d = g - int(self._doc_base[li])
                if d >= eng.text_index.n_docs:
                    continue
                if eng.store is not None:
                    row.append((lang, eng.store.materialize(d, s)))
                else:
                    row.append((lang, RetrievedDoc(doc_id=d, score=s)))
            out.append(row)
        return out
