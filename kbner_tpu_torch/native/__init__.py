"""The retrieval engine's native host runtime (counterpart of
``kbner_tpu/native``): the batch UAX#29 analyzer and the postings helpers
that build the engine's arrays and gather the tiny terms' exact sums.

Two C++ sources with plain C interfaces, ``postings.cc`` and
``analyzer.cc``, are compiled with ``g++ -O3 -shared -fPIC`` at first use
into ``kbner_tpu_torch/_build/`` (listed in ``.gitignore``) and bound with
``ctypes``. A library's file name carries a hash of its source and the
flags, and it is written to a temporary file and moved into place, so
processes that build at the same moment each load a whole library. A
failed build raises with the compiler's output: nothing falls back to
numpy. The analyzer's Unicode tables are generated from the port's own
``retrieval/analyzer.py`` and cached in the same directory, keyed by a
hash of that file and the interpreter's Unicode version.

Every entry point has a numpy twin, named ``<entry point>_ref``, that
computes the same arrays the way the port did before this runtime; the
tests hold each pair equal. Callers use the native functions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import unicodedata
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: dict = {}  # source name -> bound CDLL, one per process

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_u16p = ctypes.POINTER(ctypes.c_uint16)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64, _f64 = ctypes.c_int64, ctypes.c_double

_SIGNATURES = {
    "postings": {
        "gather_postings": ([_i64p, _i32p, _f32p, _i32p, _i64, _i64, _i64,
                             _i64, _i32p, _f32p], None),
        "tiny_exact": ([_i64p, _i32p, _f32p, _i32p, _f32p, _u8p, _i64, _i64,
                        _i64, _i32p, _f32p, _f32p], _i64),
        "build_csr": ([_i32p, _f32p, _i64, _i64, _i64, _i64p, _i64p, _i32p,
                       _f32p], None),
        "compact_tiny": ([_i32p, _f32p, _i64p, _i64, _i64, _i64, _i64, _i32p,
                          _f32p, _i32p], None),
        "pack_ragged": ([_i32p, _f32p, _i64p, _i64, _i64, _i64, _f64, _f64,
                         _i64, _f32p, _i32p], None),
        "csr_cap": ([_i64p, _i32p, _f32p, _i64, _i64, _i64, _i64p, _i32p,
                     _f32p], None),
        "pack_delta16": ([_i32p, _i32p, _i32p, _u8p, _i64p, _i64, _i64,
                          _u16p], None),
        "delta16_lens": ([_i32p, _f32p, _i32p, _f32p, _f32p, _i64, _i64,
                          _i64p], None),
        "delta16_emit": ([_i32p, _f32p, _i32p, _f32p, _f32p, _i64p, _i64,
                          _i64, _u16p], None),
    },
    "analyzer": {
        "analyze_batch": ([ctypes.c_char_p, _i64, _i64p, _i64, _u8p, _u32p,
                           ctypes.c_int32, _u8p, _i64, _i64p, _i64p, _u8p,
                           _i64, _i64p], _i64),
    },
}


# -- build and load -----------------------------------------------------------

def library_path(name: str) -> Path:
    """Where the built library of ``<name>.cc`` lives."""
    src = (_DIR / f"{name}.cc").read_bytes()
    digest = hashlib.sha256(src + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``<name>.cc`` with g++ unless it is built already; returns
    the library's path. Raises with the compiler's output if g++ fails
    or is missing."""
    out = library_path(name)
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(_DIR / f"{name}.cc"), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: kbner_tpu_torch's native host runtime is built "
            f"from kbner_tpu_torch/native/{name}.cc at first use") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {name}.cc:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``<name>.cc``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, (args, res) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
            _loaded[name] = lib
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype)


# -- the CSR ------------------------------------------------------------------

def build_csr(doc_terms: np.ndarray, doc_impacts: np.ndarray,
              vocab_size: int):
    """The impact-ordered term-major CSR of padded doc arrays ``[N, Ld]``
    (pad < 0): (offsets int64 [V+1], doc ids int32 [NNZ], impacts float32
    [NNZ], df int64 [V]), each term's postings by impact descending, ties
    in doc order."""
    dt = _c(doc_terms, np.int32)
    di = _c(doc_impacts, np.float32)
    N, Ld = dt.shape
    V = int(vocab_size)
    valid = dt >= 0
    nnz = int(valid.sum())
    if nnz and int(dt.max()) >= V:
        raise ValueError(f"term id {int(dt.max())} is not below the "
                         f"vocabulary size {V}")
    offsets = np.zeros(V + 1, np.int64)
    df = np.zeros(V, np.int64)
    out_doc = np.empty(nnz, np.int32)
    out_imp = np.empty(nnz, np.float32)
    load("postings").build_csr(
        _ptr(dt, ctypes.c_int32), _ptr(di, ctypes.c_float), N, Ld, V,
        _ptr(offsets, ctypes.c_int64), _ptr(df, ctypes.c_int64),
        _ptr(out_doc, ctypes.c_int32), _ptr(out_imp, ctypes.c_float))
    return offsets, out_doc, out_imp, df


def build_csr_ref(doc_terms: np.ndarray, doc_impacts: np.ndarray,
                  vocab_size: int):
    """Numpy twin of :func:`build_csr`: one stable lexsort."""
    valid = doc_terms >= 0
    terms = doc_terms[valid]
    docs = np.nonzero(valid)[0].astype(np.int32)
    imps = doc_impacts[valid].astype(np.float32)
    order = np.lexsort((-imps, terms))
    df = np.bincount(terms[order], minlength=vocab_size)
    offsets = np.zeros(vocab_size + 1, dtype=np.int64)
    np.cumsum(df, out=offsets[1:])
    return offsets, docs[order], imps[order], df.astype(np.int64)


def _capped_df(df: np.ndarray, cap: int, min_df: int) -> np.ndarray:
    df_c = np.asarray(df, np.int64).copy()
    if cap > 0:
        np.minimum(df_c, cap, out=df_c)
    if min_df > 0:
        df_c[np.asarray(df) <= min_df] = 0
    return df_c


def csr_cap(offsets: np.ndarray, p_doc: np.ndarray, p_imp: np.ndarray,
            df: np.ndarray, cap: int, min_df: int):
    """The CSR cut to each term's ``cap`` first (highest-impact) postings
    (``cap`` <= 0: all), without the terms of df <= ``min_df``: (offsets
    int64 [V+1], doc ids, impacts)."""
    off = _c(offsets, np.int64)
    pd = _c(p_doc, np.int32)
    pi = _c(p_imp, np.float32)
    V = len(off) - 1
    out_off = np.zeros(V + 1, np.int64)
    np.cumsum(_capped_df(df, cap, min_df), out=out_off[1:])
    nnz = int(out_off[-1])
    out_doc = np.empty(nnz, np.int32)
    out_imp = np.empty(nnz, np.float32)
    load("postings").csr_cap(
        _ptr(off, ctypes.c_int64), _ptr(pd, ctypes.c_int32),
        _ptr(pi, ctypes.c_float), V, cap, min_df,
        _ptr(out_off, ctypes.c_int64), _ptr(out_doc, ctypes.c_int32),
        _ptr(out_imp, ctypes.c_float))
    return out_off, out_doc, out_imp


def csr_cap_ref(offsets: np.ndarray, p_doc: np.ndarray, p_imp: np.ndarray,
                df: np.ndarray, cap: int, min_df: int):
    """Numpy twin of :func:`csr_cap`: a keep mask over every posting."""
    pos = (np.arange(len(p_doc), dtype=np.int64)
           - np.repeat(offsets[:-1], df))
    keep = np.ones(len(p_doc), bool)
    if cap > 0:
        keep &= pos < cap
    if min_df > 0:
        keep &= ~np.repeat(df <= min_df, df)
    off_c = np.zeros(len(offsets), dtype=np.int64)
    np.cumsum(_capped_df(df, cap, min_df), out=off_c[1:])
    return off_c, p_doc[keep], p_imp[keep]


# -- doc rows -----------------------------------------------------------------

def compact_tiny(doc_terms: np.ndarray, doc_impacts: np.ndarray,
                 df: np.ndarray, tiny_cap: int):
    """Left-compacted copies ``(dt2 int32 [N, Ld2] pad -1, di2 float32)``
    of the doc arrays without the slots of terms with df <= ``tiny_cap``;
    Ld2 is the longest row left (at least 1)."""
    dt = _c(doc_terms, np.int32)
    di = _c(doc_impacts, np.float32)
    dfc = _c(df, np.int64)
    N, Ld = dt.shape
    lens = np.empty(N, np.int32)
    lib = load("postings")
    lib.compact_tiny(_ptr(dt, ctypes.c_int32), _ptr(di, ctypes.c_float),
                     _ptr(dfc, ctypes.c_int64), tiny_cap, N, Ld, 0,
                     _i32p(), _f32p(), _ptr(lens, ctypes.c_int32))
    ld2 = max(int(lens.max(initial=0)), 1)
    dt2 = np.full((N, ld2), -1, np.int32)
    di2 = np.zeros((N, ld2), np.float32)
    lib.compact_tiny(_ptr(dt, ctypes.c_int32), _ptr(di, ctypes.c_float),
                     _ptr(dfc, ctypes.c_int64), tiny_cap, N, Ld, ld2,
                     _ptr(dt2, ctypes.c_int32), _ptr(di2, ctypes.c_float),
                     _ptr(lens, ctypes.c_int32))
    return dt2, di2


def compact_tiny_ref(doc_terms: np.ndarray, doc_impacts: np.ndarray,
                     df: np.ndarray, tiny_cap: int):
    """Numpy twin of :func:`compact_tiny`."""
    keep = doc_terms >= 0
    keep[keep] = df[doc_terms[keep]] > tiny_cap
    ld = max(int(keep.sum(axis=1).max(initial=0)), 1)
    n = doc_terms.shape[0]
    dt2 = np.full((n, ld), -1, dtype=np.int32)
    di2 = np.zeros((n, ld), dtype=np.float32)
    rows = np.nonzero(keep)[0]
    cols = (np.cumsum(keep, axis=1) - 1)[keep]
    dt2[rows, cols] = doc_terms[keep]
    di2[rows, cols] = doc_impacts[keep]
    return dt2, di2


def pack_ragged(doc_terms: np.ndarray, doc_impacts: np.ndarray,
                off: np.ndarray, term_bits: int, lo: float, step: float,
                levels: int, flat: np.ndarray,
                term_lo: Optional[np.ndarray] = None) -> None:
    """Quantize and pack the ragged packed32 rows into ``flat`` (int32,
    pre-filled -1) in place: slot l of doc d at ``off[d] + l``, ``(code <<
    term_bits) | term`` with code ``1 + rint((ln imp - base) / step)``
    clipped to ``[1, levels + 1]`` (0 for impact 0), base ``term_lo[t]``
    or else ``lo``."""
    dt = _c(doc_terms, np.int32)
    di = _c(doc_impacts, np.float32)
    offc = _c(off, np.int64)
    if flat.dtype != np.int32 or not flat.flags.c_contiguous:
        raise ValueError("flat must be a C-contiguous int32 array")
    N, Ld = dt.shape
    valid = dt >= 0
    last = Ld - 1 - np.argmax(valid[:, ::-1], axis=1)  # last real column
    if valid.any() and int((offc[:N] + last)[valid.any(axis=1)].max()) \
            >= flat.size:
        raise ValueError("a slot lands past the end of flat")
    tl = (_ptr(_c(term_lo, np.float32), ctypes.c_float)
          if term_lo is not None else _f32p())
    load("postings").pack_ragged(
        _ptr(dt, ctypes.c_int32), _ptr(di, ctypes.c_float),
        _ptr(offc, ctypes.c_int64), N, Ld, term_bits, float(lo),
        float(step), levels, tl, _ptr(flat, ctypes.c_int32))


def pack_ragged_ref(doc_terms: np.ndarray, doc_impacts: np.ndarray,
                    off: np.ndarray, term_bits: int, lo: float, step: float,
                    levels: int, flat: np.ndarray,
                    term_lo: Optional[np.ndarray] = None) -> None:
    """Numpy twin of :func:`pack_ragged` (float64 logs)."""
    valid = doc_terms >= 0
    codes = np.zeros(doc_terms.shape, np.uint32)
    p = valid & (doc_impacts > 0)
    base = (term_lo[np.maximum(doc_terms, 0)][p].astype(np.float64)
            if term_lo is not None else lo)
    codes[p] = np.clip(
        np.rint((np.log(doc_impacts[p].astype(np.float64)) - base) / step),
        0, levels).astype(np.uint32) + 1
    packed = ((codes << term_bits)
              | (doc_terms.astype(np.uint32) & ((1 << term_bits) - 1))
              ).view(np.int32)
    pos = off[:, None] + np.arange(doc_terms.shape[1], dtype=np.int64)
    flat.reshape(-1)[pos[valid]] = packed[valid]


def pack_delta16(rem: np.ndarray, tf: np.ndarray, n_cont: np.ndarray,
                 valid: np.ndarray, off: np.ndarray, flat: np.ndarray
                 ) -> None:
    """Write the delta16 slot stream into ``flat`` (uint16) in place: per
    valid (doc, j) posting, ``n_cont`` continuation slots then ``(rem <<
    3) | tf``, from the doc's ``off`` cursor."""
    N, L = rem.shape
    remc, tfc, ncc = (_c(x, np.int32) for x in (rem, tf, n_cont))
    vc = _c(valid, np.uint8)
    offc = _c(off, np.int64)
    if flat.dtype != np.uint16 or not flat.flags.c_contiguous:
        raise ValueError("flat must be a C-contiguous uint16 array")
    per_doc = np.where(vc > 0, ncc.astype(np.int64) + 1, 0).sum(axis=1)
    if N and int((offc[:N] + per_doc).max()) > flat.size:
        raise ValueError("a segment runs past the end of flat")
    load("postings").pack_delta16(
        _ptr(remc, ctypes.c_int32), _ptr(tfc, ctypes.c_int32),
        _ptr(ncc, ctypes.c_int32), _ptr(vc, ctypes.c_uint8),
        _ptr(offc, ctypes.c_int64), N, L, _ptr(flat, ctypes.c_uint16))


DELTA16_MAX_GAP = 8191
DELTA16_CONT = np.uint16(DELTA16_MAX_GAP << 3)  # continuation: tf = 0
DELTA16_TF_CAP = 7


def pack_delta16_ref(rem: np.ndarray, tf: np.ndarray, n_cont: np.ndarray,
                     valid: np.ndarray, off: np.ndarray, flat: np.ndarray
                     ) -> None:
    """Numpy twin of :func:`pack_delta16`: one repeat per posting and a
    last-of-group test."""
    valid = valid.astype(bool)
    slots_per = np.where(valid, 1 + n_cont, 0).astype(np.int64)
    lens = slots_per.sum(axis=1)
    pv, jv = np.nonzero(valid)
    reps = slots_per[pv, jv]
    tot = int(reps.sum())
    pidx = np.repeat(np.arange(len(pv)), reps)
    ends = np.cumsum(reps)
    is_real = np.arange(tot) == np.repeat(ends - 1, reps)
    vals = np.where(
        is_real,
        (rem[pv, jv][pidx].astype(np.uint32) << 3)
        | tf[pv, jv][pidx].astype(np.uint32),
        np.uint32(DELTA16_CONT)).astype(np.uint16)
    # slot position within its doc (slots are doc-major)
    doc_of_slot = pv[pidx]
    first_global = np.repeat(np.cumsum(lens) - lens, lens)
    slot_in_doc = np.arange(tot) - first_global
    flat.reshape(-1)[off[doc_of_slot] + slot_in_doc] = vals


def delta16_rows(dt: np.ndarray, di: np.ndarray, remap: np.ndarray,
                 idf: np.ndarray, norm: np.ndarray
                 ) -> Tuple[np.ndarray, Callable[[np.ndarray, np.ndarray],
                                                 None]]:
    """The delta16 row transform of left-packed doc arrays ``[N, L]``
    (tiny terms dropped), the dense remap [V] (-1 = absent), idf [V] and
    the per-doc norms [N]: ``(lens, emit)``, ``lens`` [N] int64 slot
    counts and ``emit(off, flat)`` writing each doc's slots at ``off[d]``
    into ``flat`` (uint16) in place. Per doc the remapped ids are sorted
    and stored as 13-bit gaps with a 3-bit tf recovered from the impact
    (``tf = norm * x / (1 - x)``, ``x = imp / idf``, in [1, 7])."""
    N, L = dt.shape
    dtc = _c(dt, np.int32)
    dic = _c(di, np.float32)
    rmc = _c(remap, np.int32)
    idfc = _c(idf, np.float32)
    nrmc = _c(norm, np.float32)
    if N and dtc.size and int(dtc.max()) >= len(rmc):
        raise ValueError("a term id is not below the remap's length")
    lens = np.zeros(max(N, 1), np.int64)
    lib = load("postings")
    lib.delta16_lens(_ptr(dtc, ctypes.c_int32), _ptr(dic, ctypes.c_float),
                     _ptr(rmc, ctypes.c_int32), _ptr(idfc, ctypes.c_float),
                     _ptr(nrmc, ctypes.c_float), N, L,
                     _ptr(lens, ctypes.c_int64))

    def emit(off: np.ndarray, flat: np.ndarray) -> None:
        offc = _c(off, np.int64)
        if flat.dtype != np.uint16 or not flat.flags.c_contiguous:
            raise ValueError("flat must be a C-contiguous uint16 array")
        if N and int((offc[:N] + lens[:N]).max()) > flat.size:
            raise ValueError("a segment runs past the end of flat")
        lib.delta16_emit(
            _ptr(dtc, ctypes.c_int32), _ptr(dic, ctypes.c_float),
            _ptr(rmc, ctypes.c_int32), _ptr(idfc, ctypes.c_float),
            _ptr(nrmc, ctypes.c_float), _ptr(offc, ctypes.c_int64), N, L,
            _ptr(flat, ctypes.c_uint16))

    return lens, emit


def delta16_fields_ref(dt: np.ndarray, di: np.ndarray, remap: np.ndarray,
                       idf: np.ndarray, norm: np.ndarray):
    """The fields of :func:`pack_delta16` for the rows
    :func:`delta16_rows` transforms, in numpy: ``(rem, tf, n_cont, valid,
    lens)``, each [N, L] in each row's id order but ``lens`` [N]."""
    N, L = dt.shape
    valid = dt >= 0
    rm = np.where(valid, remap[np.maximum(dt, 0)].astype(np.int64),
                  np.int64(2**62))
    rm = np.where(rm < 0, np.int64(2**62), rm)  # tiny terms are skipped
    order = np.argsort(rm, axis=1, kind="stable")
    rm_s = np.take_along_axis(rm, order, axis=1)
    di_s = np.take_along_axis(di, order, axis=1)
    orig_s = np.take_along_axis(dt, order, axis=1)
    v_s = rm_s < 2**62
    idf_s = idf[np.maximum(orig_s, 0)].astype(np.float64)
    x = np.where(v_s, di_s / np.maximum(idf_s, 1e-30), 0.0)
    x = np.clip(x, 0.0, 1.0 - 1e-9)
    tf = np.clip(np.rint(norm[:, None] * x / (1.0 - x)).astype(np.int64),
                 1, DELTA16_TF_CAP)
    prev = np.concatenate([np.zeros((N, 1), np.int64), rm_s[:, :-1]], axis=1)
    # the first valid slot's gap is the id itself
    gaps = np.where(v_s, rm_s - np.where(v_s, prev, 0), 0)
    n_cont = gaps // DELTA16_MAX_GAP
    rem = gaps - n_cont * DELTA16_MAX_GAP  # in [0, MAX_GAP)
    lens = np.where(v_s, 1 + n_cont, 0).sum(axis=1)
    return rem, tf, n_cont, v_s, lens


def delta16_rows_ref(dt: np.ndarray, di: np.ndarray, remap: np.ndarray,
                     idf: np.ndarray, norm: np.ndarray):
    """Numpy twin of :func:`delta16_rows`: :func:`delta16_fields_ref` (a
    stable per-row argsort, the gaps and tf as [N, L] arrays) and
    :func:`pack_delta16_ref`."""
    rem, tf, n_cont, valid, lens = delta16_fields_ref(dt, di, remap, idf,
                                                      norm)

    def emit(off: np.ndarray, flat: np.ndarray) -> None:
        pack_delta16_ref(rem, tf, n_cont, valid, off, flat)

    return lens, emit


# -- the exact block of the tiny terms ----------------------------------------

def gather_tiny_exact(offsets, p_doc, p_imp, q_terms, q_weights, is_tiny):
    """Per query, every posting of every tiny query term (``is_tiny``)
    summed by doc: (doc [Q, T] int32 pad -1, impact sums [Q, T] float32,
    weighted sums [Q, T] float32), T the largest distinct-doc count
    rounded up to a multiple of 128. Sums are float32 in posting order;
    docs are listed in the order first seen. Holds no state: calls may
    run at once on several threads."""
    Q, L = q_terms.shape
    offsets = _c(offsets, np.int64)
    qt = _c(q_terms, np.int32)
    tiny = _c(is_tiny, np.uint8)
    if Q and L and int(qt.max()) >= len(offsets) - 1:
        raise ValueError("a query term is not below the CSR's vocabulary")
    safe = np.maximum(qt, 0)
    n_post = np.where((tiny != 0) & (qt >= 0),
                      offsets[safe + 1] - offsets[safe], 0).sum(axis=1)
    # every query's posting count bounds its distinct docs
    cap = ((int(n_post.max(initial=0)) + 127) // 128) * 128
    out_doc = np.full((Q, cap), -1, np.int32)
    out_imp = np.zeros((Q, cap), np.float32)
    out_ex = np.zeros((Q, cap), np.float32)
    max_docs = int(load("postings").tiny_exact(
        _ptr(offsets, ctypes.c_int64),
        _ptr(_c(p_doc, np.int32), ctypes.c_int32),
        _ptr(_c(p_imp, np.float32), ctypes.c_float),
        _ptr(qt, ctypes.c_int32),
        _ptr(_c(q_weights, np.float32), ctypes.c_float),
        _ptr(tiny, ctypes.c_uint8), Q, L, cap,
        _ptr(out_doc, ctypes.c_int32), _ptr(out_imp, ctypes.c_float),
        _ptr(out_ex, ctypes.c_float)))
    if max_docs < 0:
        raise RuntimeError("tiny_exact: a query's postings exceed its row")
    T = ((max_docs + 127) // 128) * 128
    if T < cap:  # docs shared by several of a query's terms
        return tuple(np.ascontiguousarray(a[:, :T])
                     for a in (out_doc, out_imp, out_ex))
    return out_doc, out_imp, out_ex


def gather_tiny_exact_ref(offsets, p_doc, p_imp, q_terms, q_weights,
                          is_tiny):
    """Numpy twin of :func:`gather_tiny_exact`: one flat gather and a
    unique over (query, doc) keys, so docs come in ascending order and
    the sums are float64, rounded to float32."""
    Q = q_terms.shape[0]
    qidx, tpos = np.nonzero(is_tiny)
    if len(qidx) == 0:
        z = np.zeros((Q, 0), np.float32)
        return np.full((Q, 0), -1, np.int32), z, z
    terms = q_terms[qidx, tpos].astype(np.int64)
    ws = q_weights[qidx, tpos].astype(np.float32)
    dfs = offsets[terms + 1] - offsets[terms]
    total = int(dfs.sum())
    cum = np.cumsum(dfs) - dfs
    flat = (np.repeat(offsets[terms], dfs)
            + (np.arange(total) - np.repeat(cum, dfs)))
    docs = p_doc[flat].astype(np.int64)
    imps = p_imp[flat]
    key = (np.repeat(qidx.astype(np.int64), dfs) << 31) | docs
    uniq, inv = np.unique(key, return_inverse=True)
    s_imp = np.bincount(inv, weights=imps).astype(np.float32)
    s_ex = np.bincount(inv, weights=imps * np.repeat(ws, dfs)).astype(
        np.float32)
    uq = uniq >> 31
    counts = np.bincount(uq, minlength=Q)
    T = ((int(counts.max(initial=0)) + 127) // 128) * 128
    pos = np.arange(len(uniq)) - np.repeat(np.cumsum(counts) - counts,
                                           counts)
    out_doc = np.full((Q, T), -1, np.int32)
    out_imp = np.zeros((Q, T), np.float32)
    out_ex = np.zeros((Q, T), np.float32)
    out_doc[uq, pos] = (uniq & ((1 << 31) - 1)).astype(np.int32)
    out_imp[uq, pos] = s_imp
    out_ex[uq, pos] = s_ex
    return out_doc, out_imp, out_ex


def gather_postings(offsets: np.ndarray, postings_doc: np.ndarray,
                    postings_imp: np.ndarray, q_terms: np.ndarray,
                    budget: int, df_cap: int = 0):
    """Each query's terms' posting ranges concatenated into ``[Q,
    budget]`` buffers (doc pad -1, impact pad 0): query slots < 0 and
    terms with df above ``df_cap`` (when > 0) skipped, each range cut
    where the budget ends."""
    Q, M = q_terms.shape
    out_doc = np.full((Q, budget), -1, dtype=np.int32)
    out_imp = np.zeros((Q, budget), dtype=np.float32)
    offsets = _c(offsets, np.int64)
    qt = _c(q_terms, np.int32)
    if (qt >= len(offsets) - 1).any():
        raise ValueError("a query term is not below the CSR's vocabulary")
    load("postings").gather_postings(
        _ptr(offsets, ctypes.c_int64),
        _ptr(_c(postings_doc, np.int32), ctypes.c_int32),
        _ptr(_c(postings_imp, np.float32), ctypes.c_float),
        _ptr(qt, ctypes.c_int32), Q, M, budget, df_cap,
        _ptr(out_doc, ctypes.c_int32), _ptr(out_imp, ctypes.c_float))
    return out_doc, out_imp


def gather_postings_ref(offsets: np.ndarray, postings_doc: np.ndarray,
                        postings_imp: np.ndarray, q_terms: np.ndarray,
                        budget: int, df_cap: int = 0):
    """Loop twin of :func:`gather_postings`."""
    Q, M = q_terms.shape
    out_doc = np.full((Q, budget), -1, dtype=np.int32)
    out_imp = np.zeros((Q, budget), dtype=np.float32)
    for q in range(Q):
        used = 0
        for m in range(M):
            t = int(q_terms[q, m])
            if t < 0 or used >= budget:
                continue
            lo, hi = int(offsets[t]), int(offsets[t + 1])
            if df_cap > 0 and hi - lo > df_cap:
                continue
            n = min(hi - lo, budget - used)
            out_doc[q, used:used + n] = postings_doc[lo:lo + n]
            out_imp[q, used:used + n] = postings_imp[lo:lo + n]
            used += n
    return out_doc, out_imp


# -- the batch analyzer -------------------------------------------------------

_UNI_MAX = 0x110000
_LOWER_SENTINEL = np.uint32(0xFFFFFFFF)
_tables: Optional[Tuple[np.ndarray, np.ndarray]] = None


def tables_path() -> Path:
    """Where the analyzer's Unicode tables are cached: keyed by the
    classifier's source and the interpreter's Unicode version."""
    from ..retrieval import analyzer

    src = Path(analyzer.__file__).read_bytes()
    digest = hashlib.sha256(
        src + unicodedata.unidata_version.encode()).hexdigest()
    return BUILD_DIR / f"uax29-{digest[:16]}.npz"


def _make_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(word-break class uint8 [0x110000], simple lowercase uint32
    [0x110000]) from the Python analyzer's ``_wb_class`` and
    ``str.lower``. A codepoint whose lowercase is not one character (İ),
    and capital sigma (its lowercase depends on context), map to the
    sentinel: the native analyzer flags their tokens and Python lowers
    those whole."""
    from ..retrieval.analyzer import _wb_class

    wb = np.zeros(_UNI_MAX, np.uint8)
    lower = np.arange(_UNI_MAX, dtype=np.uint32)
    for cp in range(_UNI_MAX):
        ch = chr(cp)
        wb[cp] = _wb_class(ch)
        lc = ch.lower()
        if len(lc) != 1 or cp == 0x3A3:
            lower[cp] = _LOWER_SENTINEL
        else:
            lower[cp] = ord(lc)
    return wb, lower


def analyzer_tables() -> Tuple[np.ndarray, np.ndarray]:
    """The native analyzer's Unicode tables, generated once (about 2 s)
    and cached on disk (about 5.5 MB), written atomically."""
    global _tables
    if _tables is not None:
        return _tables
    with _lock:
        if _tables is None:
            path = tables_path()
            if path.is_file():
                with np.load(path) as z:
                    tables = (np.ascontiguousarray(z["wb"], np.uint8),
                              np.ascontiguousarray(z["lower"], np.uint32))
            else:
                tables = _make_tables()
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_suffix(
                    f".{os.getpid()}.{threading.get_ident()}.tmp")
                with open(tmp, "wb") as f:
                    np.savez_compressed(f, wb=tables[0], lower=tables[1])
                os.replace(tmp, path)
            _tables = tables
    return _tables


def analyze_docs(docs: Sequence[str], mode: str = "standard"
                 ) -> List[List[str]]:
    """The tokens of each document, token for token those of
    ``retrieval/analyzer.py``'s ``standard_analyze`` (``mode="cjk"``:
    ``cjk_analyze``, with the Han bigrams), analyzed in one native call."""
    if mode not in ("standard", "cjk"):
        raise ValueError(f"unknown analyzer mode {mode!r}")
    lib = load("analyzer")
    wb, lower = analyzer_tables()
    enc = [d.encode("utf-8", "surrogatepass") for d in docs]
    offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    blob = b"".join(enc)
    n_bytes = len(blob)
    # a token's bytes are at most its input's plus one per codepoint that
    # lowers into a longer encoding; a cjk bigram repeats two Han chars;
    # every token ends in a NUL
    out_cap = 4 * n_bytes + 64
    tok_cap = 2 * n_bytes + 8
    out_text = np.empty(out_cap, np.uint8)
    tok_offsets = np.zeros(tok_cap + 1, np.int64)
    tok_doc = np.empty(tok_cap, np.int64)
    tok_flags = np.empty(tok_cap, np.uint8)
    out_len = ctypes.c_int64(0)
    n_tok = lib.analyze_batch(
        blob, n_bytes, _ptr(offsets, ctypes.c_int64), len(enc),
        _ptr(wb, ctypes.c_uint8), _ptr(lower, ctypes.c_uint32),
        1 if mode == "cjk" else 0, _ptr(out_text, ctypes.c_uint8), out_cap,
        _ptr(tok_offsets, ctypes.c_int64), _ptr(tok_doc, ctypes.c_int64),
        _ptr(tok_flags, ctypes.c_uint8), tok_cap, ctypes.byref(out_len))
    if n_tok < 0:
        raise RuntimeError(
            f"analyze_batch overflowed its output ({out_cap} bytes, "
            f"{tok_cap} tokens) over {len(enc)} docs of {n_bytes} bytes")
    # every token ends in a NUL, which no token holds (class OTHER breaks
    # a token): one decode and one split
    toks = out_text[: out_len.value].tobytes().decode("utf-8").split("\x00")
    for i in np.nonzero(tok_flags[:n_tok])[0]:
        toks[i] = toks[i].lower()
    counts = np.bincount(tok_doc[:n_tok], minlength=len(enc))
    out = []
    pos = 0
    for c in counts.tolist():
        out.append(toks[pos:pos + c])
        pos += c
    return out
