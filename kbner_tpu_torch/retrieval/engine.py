"""Retrieval engine: device-resident BM25 index, batched top-k
(counterpart of ``kbner_tpu/retrieval/engine.py``, unsharded).

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
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..device import resolve_device
from ..ops.bm25 import (KEY_PAD, bm25_pruned_topk_packed, bm25_topk,
                        gather_pruned_candidate_keys)
from .index import BM25Index, long_to_int4

_DOC_PAD = 512  # the doc axis is padded to a multiple of this on upload


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
    native runtime, ``kbner_tpu_torch/native``.
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
        if mesh is not None:
            raise NotImplementedError(
                "a sharded engine (mesh) is not ported yet (ROADMAP A4)")
        if device is False:
            raise NotImplementedError(
                "device=False (host arrays for a MixEngine) is not ported "
                "yet (ROADMAP A4)")
        if deep_terms and mode != "pruned":
            raise ValueError("deep_terms>0 supports only the unsharded "
                             "pruned engine")
        self.mode = mode
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
        self.device = resolve_device(device)
        # field name -> device (doc_terms_t [Ld, N] int32,
        # doc_impacts_t [Ld, N] float32), the exhaustive kernel's operands
        self.fields = {}
        # pruned, per field name: device pass-2 rows, their layout
        # (_row_meta), the per-term log bases of packed32 rows (_term_lo),
        # the device CSR (offsets, packed rows) and its log scale
        self.rows, self._row_meta, self._term_lo = {}, {}, {}
        self.csr, self._csr_scale = {}, {}
        self._upload()

    def _init_pruned(self, rare_terms, posting_budget, df_cap, n_candidates,
                     compact_rows, tiny_df_cap, tiny_width, tiny_pack,
                     tiny_f16, row_layout, tiny_cols_floor, d16_width_floor,
                     topc_recall, align_windows, deep_terms,
                     deep_cap) -> None:
        """The pruned knobs and the values derived from them, as the
        reference derives them; what a later slice ports raises here."""
        idx = self.text_index
        if topc_recall > 0.0:
            raise NotImplementedError(
                "topc_recall > 0 (approx_max_k) has no torch counterpart; "
                "the exact top-C is the ported path (ROADMAP A4)")
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
        self._csr_aligned = align_windows
        # never-shrink width floors of the query blocks
        self._d16_w_floor = d16_width_floor
        self._t_cols_floor = tiny_cols_floor
        self._tiny_pack: Optional[Tuple[int]] = None  # (docbits,)

    # -- device residency -----------------------------------------------------

    def _upload(self) -> None:
        """Pad the doc axis of every field to one shared multiple of
        ``_DOC_PAD`` and put the mode's arrays on the device."""
        fields = {"text": self.text_index}
        if self.title_index is not None:
            fields["title"] = self.title_index
        n_padded = max(idx.doc_terms.shape[0] for idx in fields.values())
        n_padded = -(-n_padded // _DOC_PAD) * _DOC_PAD
        self.n_padded = n_padded
        for name, idx in fields.items():
            n = idx.doc_terms.shape[0]
            dt = np.pad(idx.doc_terms, ((0, n_padded - n), (0, 0)),
                        constant_values=-1)
            di = np.pad(idx.doc_impacts, ((0, n_padded - n), (0, 0)))
            if self.mode == "pruned":
                self._upload_pruned(name, idx, dt, di)
                continue
            self.fields[name] = (
                torch.from_numpy(np.ascontiguousarray(dt.T)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(di.T)).to(self.device))

    def _put(self, x) -> torch.Tensor:
        """A host array on the engine's device (a tensor passes as is)."""
        if isinstance(x, torch.Tensor):
            return x
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

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
        if text and self.compact_rows:
            dt, di = _drop_tiny_slots(dt, di, df, self.tiny_cap)
        put = self._put
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
            flat, off, lens, r2 = _pack_doc_rows_delta16(dt, di, remap,
                                                          idx.idf, norm)
            self._row_meta[name] = ("d16", float(p.k1), float(p.b),
                                    float(idx.avgdl), r2)
            # the rows are stored as int16 and read as uint16: the kernel
            # takes the raw 16 bits, the plain version widens with & 0xFFFF
            self.rows[name] = (put(flat.view(np.int16)), put(off),
                               put(lens.astype(np.int32)), put(lut[dl]))
        else:
            code_bits = 32 - max(int(np.ceil(np.log2(len(idx.vocab) + 2))),
                                 1)
            term_lo, t_step = _term_scale_from_csr(idx, code_bits)
            self._term_lo[name] = term_lo
            flat, off, lens, tb, lo, step, r2 = _pack_doc_rows_ragged(
                dt, di, len(idx.vocab), scale=(term_lo, t_step))
            self._row_meta[name] = ("p32", tb, lo, step, r2)
            self.rows[name] = (put(flat), put(off),
                               put(lens.astype(np.int32)))
        if text:
            self.max_seg = int(lens.max(initial=0))
        # the device never looks up a tiny text term, so its postings leave
        # the text CSR; the title CSR keeps every term
        off32, packed, clo, cstep = idx.csr_rows_packed(
            cap=self.deep_cap if text and self.deep_terms
            else self.per_term_cap, min_df=self.tiny_cap if text else 0,
            align_windows=self._csr_aligned)
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
        ex float32)``, ``blocks`` one (terms, weights) per field."""
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
        if self.compact_rows:
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
        # one ranking scale for every key: the text CSR's, with ln(64) of
        # headroom so summed tiny contributions do not clip to code 255;
        # the title windows are re-encoded onto it
        rank_lo, csr_step = self._csr_scale["text"]
        rank_step = csr_step + float(np.log(64.0)) / 254.0
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
            code = torch.clamp(torch.round(
                (torch.log(torch.clamp(t_ex, min=1e-30)) - rank_lo)
                / rank_step) + 1.0, 1.0, 255.0).long()
            ok = (t_doc >= 0) & (t_ex > 0)
            key_blocks.append(torch.where(ok, (t_doc << 8) | code, KEY_PAD))
        fields = tuple(self._field(name, *block)
                       for name, block in zip(names, blocks))
        # a doc enters the pool at most once per window of each rare block
        # and once from the host-deduplicated tiny block
        kwargs = dict(n_candidates=self.n_candidates,
                      max_dup_shifts=(self.rare_terms * len(rares)
                                      + (tiny is not None)),
                      imp_lo=rank_lo, imp_step=rank_step,
                      ragged_rows=tuple(self._row_meta[n][4] for n in names))
        return torch.cat(key_blocks, dim=1), fields, (t_doc, t_ex), kwargs

    def _search_pruned(self, q_terms: np.ndarray, q_weights: np.ndarray,
                       k: int, title_terms: Optional[np.ndarray] = None,
                       title_weights: Optional[np.ndarray] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pooled pass 1 and pass 2 of one batch on the device: scores
        [Q, k] float32 and ids [Q, k] int64 (-1 where fewer score). Without
        title terms the text field is searched alone."""
        keys, fields, (t_doc, t_ex), kwargs = self._device_queries(
            self._pack_queries(q_terms, q_weights, title_terms,
                               title_weights))
        return bm25_pruned_topk_packed(
            keys, fields, n_real_docs=self.text_index.n_docs, k=k,
            tiny_doc=t_doc, tiny_ex=t_ex, **kwargs)

    def search_encoded(
        self,
        q_terms: np.ndarray,
        q_weights: np.ndarray,
        k: int = 10,
        title_terms: Optional[np.ndarray] = None,
        title_weights: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over pre-encoded queries. Returns (scores, ids) [Q, k]."""
        if self.mode == "pruned":
            if title_terms is not None:
                if self.title_index is None:
                    raise ValueError("engine built without a title index")
                title_terms = np.asarray(title_terms)
                title_weights = np.asarray(title_weights)
            scores, ids = self._search_pruned(
                np.asarray(q_terms), np.asarray(q_weights), k, title_terms,
                title_weights)
            return scores.cpu().numpy(), ids.cpu().numpy()

        def put(x, dtype):
            return torch.as_tensor(np.asarray(x, dtype=dtype),
                                   device=self.device)

        fields = [(put(q_terms, np.int32), put(q_weights, np.float32),
                   *self.fields["text"])]
        if title_terms is not None:
            if "title" not in self.fields:
                raise ValueError("engine built without a title index")
            fields.append((put(title_terms, np.int32),
                           put(title_weights, np.float32),
                           *self.fields["title"]))
        scores, ids = bm25_topk(fields, k=k, doc_chunk=self.doc_chunk)
        return scores.cpu().numpy(), ids.cpu().numpy()

    def search_stream(self, batches, k: int = 10, workers: int = 3,
                      depth: int = 2, max_query_terms: int = 64):
        """Pipelined search over an iterable of batches, yielding
        ``(scores, ids)`` numpy arrays per batch, in order.

        A batch is ``(q_terms, q_weights)`` or a list of raw query strings.
        In pruned mode three stages overlap: ``workers`` prep threads
        analyze and encode batch i+1, pack it on the host (in batch order,
        so the never-shrink query widths grow as per-batch calls grow
        them) and start its upload, from pinned buffers on a side stream,
        while the card runs batch i; the results come back through pinned
        buffers, each pulled by its own thread after a CUDA event, with at
        most ``depth`` batches dispatched and not yet yielded. Every kernel
        launches on the caller's thread, on its current stream, which
        waits for each batch's upload event. Exhaustive mode searches each
        batch with :meth:`search_encoded`.
        """
        def encode(b):
            if b and isinstance(b[0], str):
                b = self.text_index.encode_queries(
                    list(b), max_query_terms=max_query_terms)
            return b

        if self.mode != "pruned":
            for b in batches:
                qt, qw = encode(b)
                yield self.search_encoded(qt, qw, k=k)
            return

        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        cuda = self.device.type == "cuda"
        side = torch.cuda.Stream(self.device) if cuda else None
        packed_to = threading.Condition()
        n_packed = [0]

        def prep(i, b):
            err = None
            try:
                qt, qw = (np.asarray(x) for x in encode(b))
            except BaseException as e:  # noqa: BLE001 (re-raised below)
                err = e
            with packed_to:  # batch i packs after batch i - 1
                packed_to.wait_for(lambda: n_packed[0] == i)
                try:
                    if err is None:
                        packed = self._pack_queries(qt, qw)
                finally:
                    n_packed[0] += 1
                    packed_to.notify_all()
            if err is not None:
                raise err
            if not cuda:
                return packed, None, []
            return self._upload_packed(packed, side)

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
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(uploaded)
                    for t in on_side:  # allocated on the side stream
                        t.record_stream(cur)
                keys, fields, (t_doc, t_ex), kw = self._device_queries(
                    packed)
                out = bm25_pruned_topk_packed(
                    keys, fields, n_real_docs=self.text_index.n_docs, k=k,
                    tiny_doc=t_doc, tiny_ex=t_ex, **kw)
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

    def _upload_packed(self, packed, stream):
        """Start the upload of :meth:`_pack_queries`' host arrays on
        ``stream`` from pinned buffers. Returns (the same structure over
        device tensors, the event recorded after the copies, the device
        tensors)."""
        on_side = []

        def put(x):
            if not isinstance(x, np.ndarray):
                return x
            t = torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(
                self.device, non_blocking=True)
            on_side.append(t)
            return t

        rares, tiny, blocks = packed
        with torch.cuda.stream(stream):
            packed = ([put(r) for r in rares],
                      None if tiny is None else tuple(put(x) for x in tiny),
                      [tuple(put(x) for x in blk) for blk in blocks])
            uploaded = torch.cuda.Event()
            uploaded.record(stream)
        return packed, uploaded, on_side

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
