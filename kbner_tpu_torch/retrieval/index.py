"""BM25 index with Lucene-compatible statistics (counterpart of
``kbner_tpu/retrieval/index.py``).

The index is built on the host and laid out as dense padded arrays for
device-side scoring:

  doc_terms   [N, Ld] int32   term ids per document, pad = -1
  doc_impacts [N, Ld] float32 precomputed per-(term, doc) BM25 contribution

Precomputed impacts (idf x tf-norm) turn query scoring into a plain
match-and-accumulate over the slots (``ops/bm25.py``). Scoring matches
Lucene 8 / ES 7.x BM25:

  idf(t)      = ln(1 + (N - df + 0.5) / (df + 0.5))
  tfNorm(t,d) = tf / (tf + k1 * (1 - b + b * dl/avgdl))      (k1=1.2, b=0.75)
  score(q,d)  = sum_{t in q} boost(t) * idf(t) * tfNorm(t, d)

``quantize_norms=True`` reproduces Lucene's one-byte document-length
encoding. A collection too large to hold raw is built chunk by chunk
(:meth:`BM25Index.build_streaming`). The file format of
:meth:`BM25Index.save` and the directory layout of
:meth:`BM25Index.save_sharded` are the JAX package's, so an index saved by
either package opens in the other. Documents and
query batches analyzed by the standard or bigram analyzer go through the
native batch analyzer, and the CSR is built and capped natively
(``kbner_tpu_torch/native``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pickle
import time
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from .. import native
from .analyzer import cjk_analyze, standard_analyze

PAD_TERM = -1  # padding slot in doc_terms
OOV_TERM = -2  # query term absent from the index vocabulary

log = logging.getLogger("kbner_tpu_torch")


def log_quantize(imps: np.ndarray, bits: int
                 ) -> Tuple[np.ndarray, float, float]:
    """Log-domain impact quantization: ``(codes, lo, step)``. Code 0 is
    impact 0 (padding); positive impacts map to codes ``1 .. 2**bits - 1``
    linearly in log space. Dequantize with ``exp(lo + (code - 1) * step)``.
    """
    pos = imps > 0
    codes = np.zeros(imps.shape, dtype=np.uint16 if bits <= 16 else np.uint32)
    if not pos.any():
        return codes, 0.0, 1.0
    logs = np.log(imps[pos])
    lo = float(logs.min())
    levels = (1 << bits) - 2
    step = max((float(logs.max()) - lo) / max(levels, 1), 1e-12)
    codes[pos] = np.clip(
        np.rint((logs - lo) / step), 0, levels).astype(codes.dtype) + 1
    return codes, lo, step


def pack_postings(p_doc: np.ndarray, p_imp: np.ndarray, lanes: int = 128,
                  guard_rows: int = 32,
                  scale: Optional[Tuple[float, float]] = None,
                  ) -> Tuple[np.ndarray, float, float]:
    """Row-block postings into one int32 word each, ``(code8 << 24) |
    doc_id`` (doc ids must fit 24 bits); padding slots are -1. ``scale``
    is a given ``(lo, step)``, so that the shards of an index share one
    8-bit log scale; by default it is the impacts' own. Returns (packed
    [NR, lanes] int32, lo, step)."""
    nnz = len(p_doc)
    if nnz and int(p_doc.max()) >= 0xFFFFFF:
        raise ValueError(
            f"doc id {int(p_doc.max())} needs > 24 bits; shard the index "
            "(per-shard ids are local)")
    if scale is None:
        codes, lo, step = log_quantize(p_imp, bits=8)
    else:
        lo, step = scale
        codes = np.zeros(p_imp.shape, np.uint16)
        pos = p_imp > 0
        codes[pos] = np.clip(np.rint((np.log(p_imp[pos]) - lo) / step),
                             0, (1 << 8) - 2).astype(np.uint16) + 1
    nr = (nnz + lanes - 1) // lanes + guard_rows
    packed = np.full((nr * lanes,), -1, dtype=np.int32)
    packed[:nnz] = ((codes.astype(np.uint32) << 24)
                    | p_doc.astype(np.uint32)).view(np.int32)
    return packed.reshape(nr, lanes), lo, step


def long_to_int4(i: int) -> int:
    """Lucene SmallFloat.longToInt4: lossy 4-mantissa-bit integer encoding."""
    if i < 0:
        raise ValueError("negative value")
    num_bits = i.bit_length()
    if num_bits < 4:
        return i
    shift = num_bits - 4
    encoded = (i >> shift) & 0x07
    encoded |= (shift + 1) << 3
    return encoded


def int4_to_long(i: int) -> int:
    """Inverse (lossy) of :func:`long_to_int4`."""
    bits = i & 0x07
    shift = (i >> 3) - 1
    if shift == -1:
        return bits
    return (bits | 0x08) << shift


def quantize_doc_length(dl: int) -> int:
    """Round-trip a document length through Lucene's 1-byte norm encoding."""
    return int4_to_long(long_to_int4(dl))


def quantize_doc_lengths(dls: np.ndarray) -> np.ndarray:
    """Vectorized :func:`quantize_doc_length` through a lookup table."""
    if dls.size == 0:
        return dls
    table = np.asarray(
        [quantize_doc_length(i) for i in range(int(dls.max()) + 1)],
        dtype=np.int64)
    return table[dls]


@dataclasses.dataclass
class BM25Params:
    k1: float = 1.2
    b: float = 0.75
    quantize_norms: bool = True


def _row_width(nt: np.ndarray, n_runs: int,
               max_doc_terms: int | str | None) -> Tuple[int, int]:
    """``(ld, ld_full)``: the layout's row width under ``max_doc_terms``
    (``"auto"``: the 99.5th percentile of distinct terms per doc, at
    least 32; None: no cap) and the widest row's distinct terms."""
    ld_full = int(nt.max()) if n_runs else 1
    if max_doc_terms == "auto":
        ld = min(ld_full,
                 max(32, int(np.percentile(nt, 99.5)))) if n_runs else 1
    elif max_doc_terms is None:
        ld = ld_full
    else:
        ld = min(ld_full, int(max_doc_terms))
    ld = max(ld, 1)
    if ld < ld_full:
        log.info("build: capped %d docs to %d distinct terms (max %d)",
                 int((nt > ld).sum()), ld, ld_full)
    return ld, ld_full


class BM25Index:
    """Single-field BM25 index over a document collection."""

    def __init__(
        self,
        vocab: Dict[str, int],
        idf: np.ndarray,
        doc_terms: np.ndarray,
        doc_impacts: np.ndarray,
        n_docs: int,
        avgdl: float,
        params: BM25Params,
        analyzer: Callable[[str], List[str]] = standard_analyze,
        doc_dl: Optional[np.ndarray] = None,
    ):
        self.vocab = vocab
        self.idf = idf
        self.doc_terms = doc_terms
        self.doc_impacts = doc_impacts
        self.n_docs = n_docs
        self.avgdl = avgdl
        self.params = params
        self.analyzer = analyzer  # documents' and queries' analyzer
        self.doc_dl = doc_dl  # per-doc (quantized) length in the norm
        # seconds of build's analysis, vocabulary and layout steps
        self.build_seconds: Dict[str, float] = {}
        self._csr = None  # lazy (offsets, postings_doc, postings_imp, df)
        # lazy (sorted key array, their ids) for batch lookup, set in one
        # assignment: encode_queries runs on several threads at once
        self._vocab_sorted = None

    # -- term-major postings (pass 1 of the pruned engine) --------------------

    @property
    def csr(self):
        """Term-major CSR postings (offsets [V+1] int64, doc ids [NNZ]
        int32, impacts [NNZ] float32, df [V] int64), built lazily from the
        padded doc arrays. Postings within a term are impact-descending
        (ties in doc order), so a capped prefix holds the term's
        highest-impact documents."""
        if self._csr is None:
            self._csr = native.build_csr(self.doc_terms, self.doc_impacts,
                                         len(self.vocab))
        return self._csr

    def csr_rows(self, lanes: int = 128, guard_rows: int = 32):
        """Row-blocked postings: the CSR postings padded to whole
        ``lanes``-wide rows plus ``guard_rows``, so any window's covering
        rows exist. Returns (offsets int32 [V+1], doc rows [NR, lanes]
        int32 pad -1, impact rows [NR, lanes] float32)."""
        offsets, p_doc, p_imp, _ = self.csr
        nnz = len(p_doc)
        nr = (nnz + lanes - 1) // lanes + guard_rows
        pd = np.full((nr * lanes,), -1, dtype=np.int32)
        pd[:nnz] = p_doc
        pi = np.zeros((nr * lanes,), dtype=np.float32)
        pi[:nnz] = p_imp
        return (offsets.astype(np.int32), pd.reshape(nr, lanes),
                pi.reshape(nr, lanes))

    def csr_capped(self, cap: int, min_df: int = 0):
        """CSR truncated to each term's ``cap`` highest-impact postings,
        dropping terms with df <= ``min_df`` entirely (pass 1 never reads
        past its window, and never looks up the tiny terms the host scores
        exactly). Returns (offsets int64 [V+1], doc ids, impacts)."""
        offsets, p_doc, p_imp, df = self.csr
        if (cap <= 0 or (df <= cap).all()) and min_df <= 0:
            return offsets, p_doc, p_imp
        return native.csr_cap(offsets, p_doc, p_imp, df, cap, min_df)

    def csr_rows_packed(self, lanes: int = 128, guard_rows: int = 32,
                        cap: int = 0, min_df: int = 0,
                        align_windows: bool = False):
        """Packed row-blocked postings, one int32 ``(impact8 << 24) |
        doc_id`` per posting, of :meth:`csr_capped`. ``align_windows`` pads
        every term's range to whole ``lanes``-wide rows, so each pass-1
        window starts on a row boundary and needs ``ceil(cap / lanes)``
        covering rows instead of ``cap // lanes + 1``. Returns (offsets
        int32 [V+1], packed [NR, lanes] int32, lo, step)."""
        offsets, p_doc, p_imp = self.csr_capped(cap, min_df=min_df)
        if not align_windows:
            return (offsets.astype(np.int32),) + pack_postings(
                p_doc, p_imp, lanes=lanes, guard_rows=guard_rows)
        df = np.diff(offsets)
        padded = ((df + lanes - 1) // lanes) * lanes
        new_off = np.zeros(len(offsets), dtype=np.int64)
        np.cumsum(padded, out=new_off[1:])
        total = int(new_off[-1])
        codes, lo, step = log_quantize(p_imp.astype(np.float32), bits=8)
        nr = (total + lanes - 1) // lanes + guard_rows
        packed = np.full((nr * lanes,), -1, dtype=np.int32)
        pos = (np.repeat(new_off[:-1], df)
               + (np.arange(len(p_doc)) - np.repeat(offsets[:-1], df)))
        packed[pos] = ((codes.astype(np.uint32) << 24)
                       | p_doc.astype(np.uint32)).view(np.int32)
        return (new_off.astype(np.int32), packed.reshape(nr, lanes),
                lo, step)

    # -- construction ---------------------------------------------------------

    @classmethod
    def build(
        cls,
        docs: Sequence[str],
        analyzer: Callable[[str], List[str]] = standard_analyze,
        params: Optional[BM25Params] = None,
        max_doc_terms: int | str | None = "auto",
        pad_docs_to: int = 128,
    ) -> "BM25Index":
        """Analyze each document, then lay out the padded impact arrays in
        one vectorized pass (:meth:`build_encoded`).

        Over 256 documents, the standard and bigram analyzers run in the
        native batch analyzer, in chunks of 2**18 documents (its buffers
        take about 40 times the input's bytes). The vocabulary is the
        sorted unique tokens, as the reference builds it. The seconds of
        the three steps (analysis, vocabulary, layout) are kept in
        ``build_seconds``.

        ``max_doc_terms`` caps distinct terms per document (lowest-impact
        overflow dropped); ``"auto"`` caps at the 99.5th percentile of
        per-doc distinct-term counts. ``pad_docs_to`` pads N up to a
        multiple; padding rows have no terms and never match.
        """
        params = params or BM25Params()
        t0 = time.perf_counter()
        if analyzer in (standard_analyze, cjk_analyze) and len(docs) > 256:
            mode = "cjk" if analyzer is cjk_analyze else "standard"
            chunk = 1 << 18
            analyzed = []
            for i in range(0, len(docs), chunk):
                analyzed.extend(native.analyze_docs(
                    list(docs[i:i + chunk]), mode=mode))
        else:
            analyzed = [analyzer(doc) for doc in docs]
        t1 = time.perf_counter()
        n_docs = len(docs)
        doc_lens = np.fromiter(
            (len(t) for t in analyzed), np.int64, count=n_docs)
        total = int(doc_lens.sum())
        flat = np.empty(total, dtype=object)
        pos = 0
        for terms in analyzed:
            flat[pos:pos + len(terms)] = terms
            pos += len(terms)
        del analyzed
        if total:
            # sorted-unique vocabulary + vectorized token->id mapping
            uniq, flat_ids = np.unique(flat, return_inverse=True)
            vocab = {t: i for i, t in enumerate(uniq.tolist())}
        else:
            vocab = {}
            flat_ids = np.zeros(0, dtype=np.int64)
        del flat
        t2 = time.perf_counter()

        max_len = int(doc_lens.max()) if n_docs else 1
        tok = np.full((max(n_docs, 1), max(max_len, 1)), -1, dtype=np.int32)
        row = np.repeat(np.arange(n_docs), doc_lens)
        offsets = np.cumsum(doc_lens) - doc_lens
        col = np.arange(total) - np.repeat(offsets, doc_lens)
        tok[row, col] = flat_ids
        index = cls.build_encoded(
            tok[:n_docs], vocab, params=params, max_doc_terms=max_doc_terms,
            pad_docs_to=pad_docs_to, analyzer=analyzer, doc_lens=doc_lens)
        index.build_seconds = {"analysis": t1 - t0, "vocabulary": t2 - t1,
                               "layout": time.perf_counter() - t2}
        return index

    @staticmethod
    def _term_runs(
        tok: np.ndarray, V: int,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Reduce a raw ``[n, L]`` id block (pad < 0) to per-(doc, term)
        runs: ``(term_of_run, tf, doc_of_run, nt)`` with ``nt`` = distinct
        terms per doc."""
        n_docs = tok.shape[0]
        valid = tok >= 0
        # group equal terms within each row; pads sort to the end
        dtype = np.int32 if V < 2**31 - 1 else np.int64
        BIG = dtype(2**31 - 1) if dtype == np.int32 else np.int64(2**62)
        sorted_terms = np.sort(
            np.where(valid, tok, BIG).astype(dtype), axis=1)
        svalid = sorted_terms != BIG
        run_start = svalid.copy()
        run_start[:, 1:] &= sorted_terms[:, 1:] != sorted_terms[:, :-1]

        flat_start = run_start.ravel()
        flat_valid = svalid.ravel()
        n_runs = int(flat_start.sum())
        run_id = np.cumsum(flat_start, dtype=np.int32) - 1
        tf = np.bincount(
            run_id[flat_valid], minlength=max(n_runs, 1)).astype(np.float32)
        starts = np.nonzero(flat_start)[0]
        term_of_run = sorted_terms.ravel()[starts]
        doc_of_run = (starts // max(tok.shape[1], 1)).astype(np.int32)
        nt = np.bincount(doc_of_run, minlength=max(n_docs, 1))
        return term_of_run, tf[:n_runs], doc_of_run, nt

    @classmethod
    def build_streaming(
        cls,
        chunks: Iterable[np.ndarray],
        vocab: Dict[str, int],
        params: Optional[BM25Params] = None,
        max_doc_terms: int | str | None = "auto",
        pad_docs_to: int = 128,
        analyzer: Callable[[str], List[str]] = standard_analyze,
    ) -> "BM25Index":
        """Chunked two-phase build for collection-scale ingests: the
        arrays of :meth:`build_encoded` on the concatenated input, without
        ever holding the raw corpus.

        ``chunks`` is an iterable of ``[n_i, L_i]`` int32 id arrays (pad
        < 0; widths may differ, each below 65536 so a tf fits uint16).
        Phase 1 draws one chunk at a time and reduces it to run triplets
        (term id int32, tf uint16, doc id int64) through
        :meth:`_term_runs`, accumulating df and doc lengths; phase 2
        computes idf, avgdl and the norms once and scatters each chunk's
        impacts into the padded layout, freeing its triplets. Peak host
        memory is one raw chunk, the triplets and the final layout. Under
        a ``max_doc_terms`` cap both builds keep each row's highest-impact
        terms, but the order of a row's kept terms may differ (scores are
        order-invariant)."""
        params = params or BM25Params()
        V = len(vocab)
        df = np.zeros(V, dtype=np.int64)
        runs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        all_dl: List[np.ndarray] = []
        all_nt: List[np.ndarray] = []
        n_docs = 0
        for tok in chunks:
            tok = np.asarray(tok)
            if tok.shape[1] >= 1 << 16:
                raise ValueError("chunk width >= 65536 overflows uint16 tf")
            t, tf, d, nt = cls._term_runs(tok, V)
            df += np.bincount(t, minlength=V)
            # tf exact in uint16: tf <= row width
            runs.append((t, tf.astype(np.uint16), d.astype(np.int64) + n_docs))
            all_dl.append((tok >= 0).sum(axis=1).astype(np.int64))
            all_nt.append(nt[:tok.shape[0]])
            n_docs += tok.shape[0]
            del tok
        doc_lens = (np.concatenate(all_dl) if all_dl
                    else np.zeros(0, np.int64))
        nt = (np.concatenate(all_nt).astype(np.int64) if all_nt
              else np.zeros(0, np.int64))
        del all_dl, all_nt
        return cls._layout(runs, df, doc_lens, nt, vocab, params,
                           max_doc_terms, pad_docs_to, analyzer)

    @classmethod
    def _layout(
        cls,
        runs: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
        df: np.ndarray,
        doc_lens: np.ndarray,
        nt: np.ndarray,
        vocab: Dict[str, int],
        params: BM25Params,
        max_doc_terms: int | str | None,
        pad_docs_to: int,
        analyzer: Callable[[str], List[str]],
    ) -> "BM25Index":
        """Phase 2 of both builds: idf, avgdl and the norms once, then each
        block of run triplets ``(term, tf, global doc id)``, doc-grouped in
        ascending doc order, scattered into the padded layout and freed.
        ``doc_lens`` are the per-doc term counts of the length norm, ``nt``
        the distinct terms per doc."""
        n_docs = len(doc_lens)
        n_runs = int(nt.sum())
        # Lucene's avgdl is the true mean term count; the per-doc dl in the
        # norm is the (optionally) quantized stored value
        avgdl = float(doc_lens.mean()) if n_docs else 1.0
        idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5)).astype(
            np.float32)
        dl = (quantize_doc_lengths(doc_lens) if params.quantize_norms
              else doc_lens)
        norm = (params.k1 * (1.0 - params.b + params.b * dl / avgdl)
                ).astype(np.float32)
        ld, ld_full = _row_width(nt, n_runs, max_doc_terms)

        n_pad = ((n_docs + pad_docs_to - 1) // pad_docs_to) * pad_docs_to
        n_pad = max(n_pad, pad_docs_to)
        doc_terms = np.full((n_pad, ld), PAD_TERM, dtype=np.int32)
        doc_impacts = np.zeros((n_pad, ld), dtype=np.float32)
        cum = np.cumsum(nt) - nt  # global run offset of each doc's block
        while runs:
            # pop front: each block's triplets are freed after its scatter
            t, tf, d = runs.pop(0)
            tf = tf.astype(np.float32, copy=False)
            impact = idf[t] * tf / (tf + norm[d])
            if ld < ld_full:
                # the highest-impact terms of over-long docs (a stable
                # sort keeps doc blocks in ascending doc order, so the
                # global cum[] offsets stay valid)
                order = np.lexsort((-impact, d))
                t, d, impact = t[order], d[order], impact[order]
            pos = np.arange(len(t), dtype=np.int64) - (
                cum[d] - cum[d[0]] if len(d) else 0)
            keep = pos < ld
            doc_terms[d[keep], pos[keep]] = t[keep]
            doc_impacts[d[keep], pos[keep]] = impact[keep]
        return cls(vocab, idf, doc_terms, doc_impacts, n_docs, avgdl, params,
                   analyzer, doc_dl=np.asarray(dl, dtype=np.int32))

    @classmethod
    def build_encoded(
        cls,
        doc_token_ids: np.ndarray,
        vocab: Dict[str, int],
        params: Optional[BM25Params] = None,
        max_doc_terms: int | str | None = "auto",
        pad_docs_to: int = 128,
        analyzer: Callable[[str], List[str]] = standard_analyze,
        doc_lens: Optional[np.ndarray] = None,
    ) -> "BM25Index":
        """Vectorized build from pre-analyzed term ids ``[N, L]`` (pad < 0):
        per-row sort groups equal terms, run-length stats give tf/df, and the
        padded impact layout is one fancy-index scatter.

        ``doc_lens`` overrides the per-doc total term count used in the
        BM25 length norm (defaults to the number of valid slots per row).
        """
        params = params or BM25Params()
        tok = np.asarray(doc_token_ids)
        n_docs = tok.shape[0]
        V = len(vocab)
        if doc_lens is None:
            doc_lens = (tok >= 0).sum(axis=1).astype(np.int64)
        doc_lens = np.asarray(doc_lens, dtype=np.int64)
        term_of_run, tf, doc_of_run, nt = cls._term_runs(tok, V)
        df = np.bincount(term_of_run, minlength=V)
        return cls._layout(
            [(term_of_run, tf, doc_of_run)], df, doc_lens,
            nt[:n_docs].astype(np.int64), vocab, params, max_doc_terms,
            pad_docs_to, analyzer)

    # -- queries --------------------------------------------------------------

    def _analyze_queries(self, queries: Sequence[str]) -> List[List[str]]:
        """The tokens of each query, by the index's analyzer: through the
        native batch analyzer for more than 16 queries where that is the
        standard or the bigram analyzer."""
        if self.analyzer in (standard_analyze, cjk_analyze) \
                and len(queries) > 16:
            mode = "cjk" if self.analyzer is cjk_analyze else "standard"
            return native.analyze_docs(list(queries), mode=mode)
        return [self.analyzer(q) for q in queries]

    def _lookup_terms(self, tokens: np.ndarray) -> np.ndarray:
        """Vectorized vocab lookup of a flat token array (object dtype of
        str): binary search over the sorted key array (built lazily once).
        OOV tokens map to ``OOV_TERM``."""
        if len(self.vocab) == 0 or len(tokens) == 0:
            return np.full(len(tokens), OOV_TERM, np.int64)
        if self._vocab_sorted is None:
            keys = np.array(list(self.vocab.keys()))
            ids = np.fromiter(self.vocab.values(), np.int64,
                              count=len(self.vocab))
            order = np.argsort(keys)
            self._vocab_sorted = (keys[order], ids[order])
        keys, key_ids = self._vocab_sorted
        # the fixed-width cast of the reference: a token longer than every
        # key is cut to the key width, so it can match a key it begins with
        try:
            toks = tokens.astype(keys.dtype) if keys.dtype.kind == "U" \
                else tokens
            pos = np.searchsorted(keys, toks)
        except (TypeError, ValueError):  # mixed key types: dict fallback
            return np.fromiter(
                (self.vocab.get(t, OOV_TERM) for t in tokens), np.int64,
                count=len(tokens))
        pos_c = np.minimum(pos, len(keys) - 1)
        hit = keys[pos_c] == toks
        return np.where(hit, key_ids[pos_c], OOV_TERM)

    def encode_queries(
        self,
        queries: Sequence[str],
        max_query_terms: int = 64,
        boosts: Optional[Sequence[float]] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Queries -> (term ids [Q, Lq] int32, weights [Q, Lq] float32).

        Duplicate query terms become one slot with weight = multiplicity
        (Lucene scores one TermQuery clause per occurrence). Out-of-vocabulary
        terms get ``OOV_TERM`` and never match. A uniform per-query boost
        multiplies the weights. Queries with more distinct terms than
        ``max_query_terms`` keep the highest-idf terms; OOV terms are dropped
        before any in-vocab term. Pad slots are ``OOV_TERM`` with weight 0.
        """
        Q = len(queries)
        q_terms = np.full((Q, max_query_terms), OOV_TERM, dtype=np.int32)
        q_weights = np.zeros((Q, max_query_terms), dtype=np.float32)
        if Q == 0:
            return q_terms, q_weights
        analyzed = self._analyze_queries(queries)
        lens = np.fromiter((len(t) for t in analyzed), np.int64, count=Q)
        total = int(lens.sum())
        if total == 0:
            return q_terms, q_weights
        flat = np.empty(total, dtype=object)
        pos = 0
        for toks in analyzed:
            flat[pos:pos + len(toks)] = toks
            pos += len(toks)
        ids = self._lookup_terms(flat)  # [total], OOV -> OOV_TERM
        qi = np.repeat(np.arange(Q, dtype=np.int64), lens)
        V = max(len(self.vocab), 1)
        idk = np.where(ids >= 0, ids, V)  # OOV bucket at V
        uk, counts = np.unique(qi * (V + 1) + idk, return_counts=True)
        uq, ut = uk // (V + 1), uk % (V + 1)
        idf_u = np.where(ut < V, self.idf[np.minimum(ut, V - 1)], -np.inf)
        order = np.lexsort((-idf_u, uq))  # per query, rarest first
        uq, ut, counts = uq[order], ut[order], counts[order]
        per_q = np.bincount(uq, minlength=Q)
        slot = np.arange(len(uq)) - np.repeat(
            np.cumsum(per_q) - per_q, per_q)
        keep = slot < max_query_terms
        n_dropped = int((~keep).sum())
        uq, ut, counts, slot = uq[keep], ut[keep], counts[keep], slot[keep]
        b = (np.asarray(boosts, np.float32)[uq]
             if boosts is not None else 1.0)
        q_terms[uq, slot] = np.where(ut < V, ut, OOV_TERM).astype(np.int32)
        q_weights[uq, slot] = counts.astype(np.float32) * b
        if n_dropped:
            log.info("encode_queries: dropped %d lowest-idf query terms over "
                     "%d queries (max_query_terms=%d)", n_dropped, Q,
                     max_query_terms)
        return q_terms, q_weights

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(
                {
                    "vocab": self.vocab,
                    "idf": self.idf,
                    "doc_terms": self.doc_terms,
                    "doc_impacts": self.doc_impacts,
                    "n_docs": self.n_docs,
                    "avgdl": self.avgdl,
                    "params": dataclasses.asdict(self.params),
                    "doc_dl": self.doc_dl,
                },
                f,
                protocol=4,
            )

    @classmethod
    def load(cls, path: str | Path,
             analyzer: Callable[[str], List[str]] = standard_analyze
             ) -> "BM25Index":
        """Open an index written by :meth:`save`, its queries analyzed by
        ``analyzer``. The file is a pickle: open only files this program
        wrote."""
        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(
            vocab=d["vocab"], idf=d["idf"], doc_terms=d["doc_terms"],
            doc_impacts=d["doc_impacts"], n_docs=d["n_docs"],
            avgdl=d["avgdl"], params=BM25Params(**d["params"]),
            analyzer=analyzer, doc_dl=d.get("doc_dl"),
        )

    def save_sharded(self, dir_path: str | Path, n_shards: int) -> None:
        """Write the index as ``n_shards`` doc-range shards
        (``shardNNN.npz``: ``doc_terms``, ``doc_impacts``, ``doc_dl``) that
        share the global statistics, saved once (``vocab.pkl``,
        ``idf.npy``, ``shards.json``): the JAX package's layout, so a
        directory written by either package opens in the other."""
        p = Path(dir_path)
        p.mkdir(parents=True, exist_ok=True)
        per = -(-self.n_docs // max(n_shards, 1))
        for i in range(n_shards):
            lo, hi = i * per, min((i + 1) * per, self.n_docs)
            np.savez(
                p / f"shard{i:03d}.npz",
                doc_terms=self.doc_terms[lo:hi],
                doc_impacts=self.doc_impacts[lo:hi],
                doc_dl=(self.doc_dl[lo:hi] if self.doc_dl is not None
                        else np.zeros(0, np.int32)))
        with open(p / "vocab.pkl", "wb") as f:
            pickle.dump(self.vocab, f, protocol=4)
        np.save(p / "idf.npy", self.idf)
        (p / "shards.json").write_text(json.dumps({
            "n_shards": n_shards, "n_docs": self.n_docs,
            "docs_per_shard": per, "ld": int(self.doc_terms.shape[1]),
            "n_padded": int(self.doc_terms.shape[0]),
            "avgdl": self.avgdl, "has_dl": self.doc_dl is not None,
            "params": dataclasses.asdict(self.params)}))

    @classmethod
    def load_sharded(cls, dir_path: str | Path,
                     analyzer: Callable[[str], List[str]] = standard_analyze
                     ) -> "BM25Index":
        """Open a :meth:`save_sharded` directory. The padded layout is
        allocated once and each shard copied in and freed, so peak memory
        is the layout plus one shard. ``vocab.pkl`` is a pickle: open only
        directories this program wrote."""
        p = Path(dir_path)
        meta = json.loads((p / "shards.json").read_text())
        with open(p / "vocab.pkl", "rb") as f:
            vocab = pickle.load(f)
        idf = np.load(p / "idf.npy")
        n_docs, ld = meta["n_docs"], meta["ld"]
        doc_terms = np.full((meta["n_padded"], ld), PAD_TERM, dtype=np.int32)
        doc_impacts = np.zeros((meta["n_padded"], ld), dtype=np.float32)
        doc_dl = np.zeros(n_docs, np.int32) if meta["has_dl"] else None
        per = meta["docs_per_shard"]
        for i in range(meta["n_shards"]):
            with np.load(p / f"shard{i:03d}.npz") as z:
                lo = i * per
                hi = lo + z["doc_terms"].shape[0]
                doc_terms[lo:hi] = z["doc_terms"]
                doc_impacts[lo:hi] = z["doc_impacts"]
                if doc_dl is not None:
                    doc_dl[lo:hi] = z["doc_dl"]
        return cls(
            vocab=vocab, idf=idf, doc_terms=doc_terms,
            doc_impacts=doc_impacts, n_docs=n_docs, avgdl=meta["avgdl"],
            params=BM25Params(**meta["params"]), analyzer=analyzer,
            doc_dl=doc_dl)

    # -- reference scoring ----------------------------------------------------

    def score_oracle(self, queries: Sequence[str],
                     boosts: Optional[Sequence[float]] = None) -> np.ndarray:
        """Exact float64 host scoring of every (padded) doc, ``[Q, N]``:
        the reference the kernels and engines are held to. O(Q x Lq x N x
        Ld); a few queries at a time."""
        q_terms, q_weights = self.encode_queries(queries, boosts=boosts)
        scores = np.zeros((len(queries), self.doc_terms.shape[0]),
                          dtype=np.float64)
        for qi in range(len(queries)):
            for j in range(q_terms.shape[1]):
                t = q_terms[qi, j]
                if t < 0:
                    continue
                match = self.doc_terms == t  # [N, Ld]
                scores[qi] += q_weights[qi, j] * (
                    self.doc_impacts * match).sum(axis=1)
        return scores
