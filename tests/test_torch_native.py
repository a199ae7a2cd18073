"""The port's native host runtime (``kbner_tpu_torch/native``) against its
numpy twins and against ``kbner_tpu.native`` on the same seeded arrays:
the postings helpers exactly (the tiny gather's float64 twin within a
float32 tolerance), the batch analyzer token for token against the Python
analyzers in both modes, and the build: several processes building at
once, and a failed g++ build raising.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import kbner_tpu.native as jnative
from kbner_tpu_torch import native
from kbner_tpu_torch.retrieval import engine as tengine
from kbner_tpu_torch.retrieval.analyzer import cjk_analyze, standard_analyze
from kbner_tpu_torch.retrieval.synth import synth_delta16_docs

from test_analyzer_lucene_golden import GOLDEN
from test_native_analyzer import EDGE_CASES

REPO = Path(__file__).resolve().parents[1]
# the float64 twin of the tiny gather against float32 sums in posting order
TINY_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def arrays():
    """Left-packed doc rows [N, Ld] over a vocabulary of V, 20% pads."""
    rng = np.random.default_rng(0)
    N, Ld, V = 5000, 20, 3000
    dt = np.where(rng.random((N, Ld)) < 0.8,
                  rng.integers(0, V, (N, Ld)), -1).astype(np.int32)
    order = np.argsort(dt < 0, axis=1, kind="stable")
    dt = np.take_along_axis(dt, order, axis=1)
    di = ((rng.random((N, Ld)).astype(np.float32) + 0.01)
          * (dt >= 0)).astype(np.float32)
    return dt, di, V


@pytest.fixture(scope="module")
def csr(arrays):
    return native.build_csr(*arrays)


def assert_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


# -- the CSR ------------------------------------------------------------------

def test_build_csr_matches_twin_and_jax(arrays, csr):
    assert_equal(csr, native.build_csr_ref(*arrays))
    assert_equal(csr, jnative.build_csr(*arrays))
    off, _, p_imp, df = csr
    assert (df > 1).any()
    for v in np.nonzero(df > 1)[0][:50]:  # impact-descending per term
        assert (np.diff(p_imp[off[v]:off[v + 1]]) <= 0).all()


def test_build_csr_refuses_ids_beyond_the_vocabulary(arrays):
    dt, di, V = arrays
    with pytest.raises(ValueError, match="vocabulary"):
        native.build_csr(dt, di, int(dt.max()))


@pytest.mark.parametrize("cap,min_df", [(8, 0), (8, 3), (0, 3), (0, 0),
                                        (1, 0), (10_000, 2)])
def test_csr_cap_matches_twin_and_jax(csr, cap, min_df):
    got = native.csr_cap(*csr, cap, min_df)
    assert_equal(got, native.csr_cap_ref(*csr, cap, min_df))
    assert_equal(got, jnative.csr_cap(*csr, cap, min_df))


@pytest.mark.parametrize("tiny_cap", [0, 5, 9, 10_000])
def test_compact_tiny_matches_twin_and_jax(arrays, csr, tiny_cap):
    dt, di, _ = arrays
    got = native.compact_tiny(dt, di, csr[3], tiny_cap)
    assert_equal(got, native.compact_tiny_ref(dt, di, csr[3], tiny_cap))
    assert_equal(got, jnative.compact_tiny(dt, di, csr[3], tiny_cap))


# -- ragged packed32 rows --------------------------------------------------------

def _ragged_args(dt, di, V, kind, csr=None):
    term_bits = max(int(np.ceil(np.log2(V + 2))), 1)
    levels = (1 << (32 - term_bits)) - 2
    lens = (dt >= 0).sum(axis=1)
    off, nr = tengine._place_length_groups(lens, 128, dt.shape[1])
    term_lo = None
    lo, step = -3.25, 0.001
    if kind == "per_term":
        off_c, _, p_imp, df = csr
        term_lo = np.zeros(V, np.float32)
        has = df > 0
        term_lo[has] = np.log(p_imp[off_c[1:] - 1][has]).astype(np.float32)
        lo, step = 0.0, 2e-5
    return (dt, di, off, term_bits, lo, step, levels), term_lo, nr * 128


@pytest.mark.parametrize("kind", ["global", "per_term"])
def test_pack_ragged_matches_twin_and_jax(arrays, csr, kind):
    dt, di, V = arrays
    args, term_lo, size = _ragged_args(dt, di, V, kind, csr)
    outs = [np.full(size, -1, np.int32) for _ in range(3)]
    native.pack_ragged(*args, outs[0], term_lo=term_lo)
    native.pack_ragged_ref(*args, outs[1], term_lo=term_lo)
    assert jnative.pack_ragged(*args, outs[2], term_lo=term_lo)
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])
    assert (outs[0] >= 0).sum() == (dt >= 0).sum()


def test_pack_ragged_keeps_interior_pads_at_their_column():
    """A -1 between real slots: the port's native pack follows its numpy
    twin (each slot at its column, so the slot after the pad falls out of
    its two-slot segment into the next one's first place, where the next
    doc's write wins, in numpy as in the native loop); kbner_tpu's native
    pack left-packs instead."""
    dt = np.asarray([[5, -1, 7], [3, 4, -1], [-1, 6, 2]], np.int32)
    di = np.asarray([[0.5, 0.0, 2.0], [1.0, 3.0, 0.0], [0.0, 0.25, 4.0]],
                    np.float32)
    off = np.asarray([0, 2, 4], np.int64)
    args = (dt, di, off, 5, -2.0, 0.01, (1 << 27) - 2)
    got, twin, jax_native = (np.full(8, -1, np.int32) for _ in range(3))
    native.pack_ragged(*args, got)
    native.pack_ragged_ref(*args, twin)
    jnative.pack_ragged(*args, jax_native)
    np.testing.assert_array_equal(got, twin)
    assert (got & 31).tolist()[:7] == [5, 31, 3, 4, 31, 6, 2]
    assert (jax_native & 31).tolist()[:6] == [5, 7, 3, 4, 6, 2]


def test_pack_ragged_refuses_a_flat_too_short(arrays):
    dt, di, V = arrays
    args, _, size = _ragged_args(dt, di, V, "global")
    with pytest.raises(ValueError, match="past the end"):
        native.pack_ragged(*args, np.full(size // 4, -1, np.int32))
    with pytest.raises(ValueError, match="int32"):
        native.pack_ragged(*args, np.full(size, -1, np.int64))


# -- delta16 rows -------------------------------------------------------------------

@pytest.mark.parametrize("long_doc", [0, 140])
def test_delta16_rows_match_twin_and_jax(long_doc):
    dt, di, remap, idf, norm = synth_delta16_docs(7, long_doc=long_doc)[:5]
    remap = remap.astype(np.int32)
    got = native.delta16_rows(dt, di, remap, idf, norm)
    twin = native.delta16_rows_ref(dt, di, remap, idf, norm)
    want = jnative.delta16_rows(dt, di, remap, idf, norm)
    N = dt.shape[0]
    np.testing.assert_array_equal(got[0][:N], twin[0])
    np.testing.assert_array_equal(got[0], want[0])
    off, nr = tengine._place_length_groups(got[0][:N], 128,
                                           int(got[0].max()))
    flats = [np.zeros(nr * 128, np.uint16) for _ in range(3)]
    for (_, emit), flat in zip((got, twin, want), flats):
        emit(off, flat)
    np.testing.assert_array_equal(flats[0], flats[1])
    np.testing.assert_array_equal(flats[0], flats[2])
    assert ((flats[0] & 7) == 0).any()  # continuation slots occur


def test_delta16_rows_skip_tiny_terms_as_the_reference_does():
    dt, di, remap, idf, norm = synth_delta16_docs(3)[:5]
    remap = remap.astype(np.int32).copy()
    remap[np.unique(dt[dt >= 0])[::3]] = -1
    got = native.delta16_rows(dt, di, remap, idf, norm)
    twin = native.delta16_rows_ref(dt, di, remap, idf, norm)
    np.testing.assert_array_equal(got[0][:dt.shape[0]], twin[0])
    np.testing.assert_array_equal(
        got[0], jnative.delta16_rows(dt, di, remap, idf, norm)[0])


def test_pack_delta16_matches_twin_and_jax():
    rng = np.random.default_rng(4)
    N, L = 300, 12
    valid = rng.random((N, L)) < 0.7
    rem = rng.integers(0, 8191, (N, L)).astype(np.int32)
    tf = rng.integers(1, 8, (N, L)).astype(np.int32)
    n_cont = np.where(rng.random((N, L)) < 0.1,
                      rng.integers(1, 3, (N, L)), 0).astype(np.int32)
    lens = np.where(valid, 1 + n_cont, 0).sum(axis=1)
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64) * 2
    flats = [np.zeros(int(off[-1] + lens[-1]) + 8, np.uint16)
             for _ in range(3)]
    native.pack_delta16(rem, tf, n_cont, valid, off, flats[0])
    native.pack_delta16_ref(rem, tf, n_cont, valid, off, flats[1])
    assert jnative.pack_delta16(rem, tf, n_cont, valid, off, flats[2])
    np.testing.assert_array_equal(flats[0], flats[1])
    np.testing.assert_array_equal(flats[0], flats[2])
    assert (flats[0] == native.DELTA16_CONT).sum() == n_cont[valid].sum()
    with pytest.raises(ValueError, match="past the end"):
        native.pack_delta16(rem, tf, n_cont, valid, off,
                            np.zeros(10, np.uint16))


# -- the tiny terms' exact block, and the posting gather ---------------------------

def _tiny_inputs(csr, seed, Q=24, L=16, tiny_cap=20):
    rng = np.random.default_rng(seed)
    V = len(csr[3])
    qt = np.where(rng.random((Q, L)) < 0.8, rng.integers(0, V, (Q, L)),
                  -2).astype(np.int32)
    qw = rng.random((Q, L)).astype(np.float32) * 3
    is_tiny = (qt >= 0) & (csr[3][np.maximum(qt, 0)] <= tiny_cap)
    return qt, qw, is_tiny


def test_gather_tiny_exact_matches_jax_and_twin(arrays, csr):
    n_docs = arrays[0].shape[0]
    for seed in range(3):
        qt, qw, is_tiny = _tiny_inputs(csr, seed)
        got = native.gather_tiny_exact(*csr[:3], qt, qw, is_tiny)
        want = jnative.gather_tiny_exact(*csr[:3], qt, qw, is_tiny, n_docs)
        assert_equal(got, want)
        twin = native.gather_tiny_exact_ref(*csr[:3], qt, qw, is_tiny)
        assert twin[0].shape == got[0].shape and got[0].shape[1] == 128
        for q in range(qt.shape[0]):
            order = np.argsort(got[0][q])
            real = got[0][q][order] >= 0
            tw = twin[0][q] >= 0
            np.testing.assert_array_equal(got[0][q][order][real],
                                          twin[0][q][tw])
            for i in (1, 2):
                np.testing.assert_allclose(got[i][q][order][real],
                                           twin[i][q][tw], rtol=TINY_RTOL)
    qt, qw, _ = _tiny_inputs(csr, 9)
    none = native.gather_tiny_exact(*csr[:3], qt, qw,
                                    np.zeros(qt.shape, bool))
    assert none[0].shape == (qt.shape[0], 0)


def test_gather_tiny_exact_on_threads_at_once(arrays, csr):
    """The gather holds no state between calls: eight threads, each
    gathering its own batch at the same moment, get what one thread gets
    alone, and docs shared by many terms of a query (tiny_cap above
    every df) are summed once per posting."""
    from concurrent.futures import ThreadPoolExecutor

    n_docs = arrays[0].shape[0]
    batches = [_tiny_inputs(csr, 20 + i, Q=64, tiny_cap=10**9)
               for i in range(8)]
    want = [jnative.gather_tiny_exact(*csr[:3], *b, n_docs) for b in batches]
    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda b: native.gather_tiny_exact(*csr[:3], *b),
                            batches * 4))
    for i, g in enumerate(got):
        assert_equal(g, want[i % len(batches)])
    assert max(g[0].shape[1] for g in got) > 128


@pytest.mark.parametrize("budget,df_cap", [(64, 0), (16, 4), (500, 9)])
def test_gather_postings_matches_twin_and_jax(csr, budget, df_cap):
    qt, _, _ = _tiny_inputs(csr, 1, Q=10, L=8)
    off, p_doc, p_imp, _ = csr
    got = native.gather_postings(off, p_doc, p_imp, qt, budget, df_cap)
    assert_equal(got, native.gather_postings_ref(off, p_doc, p_imp, qt,
                                                 budget, df_cap))
    assert_equal(got, jnative.gather_postings(off, p_doc, p_imp, qt, budget,
                                              df_cap))


# -- the batch analyzer --------------------------------------------------------

GOLDEN_TEXTS = [text for text, _ in GOLDEN]
POOL = list("abcXYZ019 .,'-_·̈;") + [
    "中", "文", "北", "京", "カ", "ナ", "あ", "한", "İ", "Σ", "σ", "ß", "é",
    "ж", "Д", "ψ", "ع", "ب", "\U00020000", "‍", "́", "’", "😀",
    "\ud800"]


def random_unicode(seed, n=400):
    rng = np.random.RandomState(seed)
    return ["".join(POOL[rng.randint(len(POOL))]
                    for _ in range(rng.randint(0, 40))) for _ in range(n)]


@pytest.mark.parametrize("mode,python", [("standard", standard_analyze),
                                         ("cjk", cjk_analyze)])
@pytest.mark.parametrize("source", ["golden", "edge", "random"])
def test_analyze_docs_matches_python_and_jax(mode, python, source):
    docs = {"golden": GOLDEN_TEXTS, "edge": EDGE_CASES,
            "random": random_unicode(0)}[source]
    got = native.analyze_docs(docs, mode=mode)
    assert got == [python(d) for d in docs]
    encodable = [d for d in docs if "\ud800" not in d]
    assert native.analyze_docs(encodable, mode=mode) == \
        jnative.analyze_docs(encodable, mode=mode)
    if source == "golden" and mode == "standard":
        assert got == [want for _, want in GOLDEN]


def test_analyze_docs_on_empty_input_and_unknown_mode():
    assert native.analyze_docs([]) == []
    assert native.analyze_docs(["", " "]) == [[], []]
    with pytest.raises(ValueError, match="mode"):
        native.analyze_docs(["x"], mode="ik")


def test_unicode_tables_come_from_the_port_classifier():
    from kbner_tpu_torch.retrieval.analyzer import _wb_class

    wb, lower = native.analyzer_tables()
    assert wb.shape == lower.shape == (0x110000,)
    for cp in (0x41, 0x5F, 0x2E, 0x4E2D, 0x30AB, 0x301, 0x1F600, 0x130):
        assert wb[cp] == _wb_class(chr(cp))
    assert lower[0x41] == ord("a") and lower[0x130] == 0xFFFFFFFF
    assert lower[0x3A3] == 0xFFFFFFFF  # capital sigma: context-dependent
    assert native.tables_path().parent == native.BUILD_DIR


# -- the build ----------------------------------------------------------------------

BUILD_AND_USE = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    import kbner_tpu_torch.native as n
    n.BUILD_DIR = Path(sys.argv[1])
    dt = np.asarray([[2, 0, -1], [1, 2, 2]], np.int32)
    off, docs, imps, df = n.build_csr(dt, np.ones(dt.shape, np.float32), 3)
    assert docs.tolist() == [0, 1, 0, 1, 1], docs
    assert n.analyze_docs(["Don't stop, U.S.A 北京"], mode="cjk") == [
        ["don't", "stop", "u.s.a", "北", "京", "北京"]]
    print(n.library_path("postings").name, n.tables_path().name)
""")


def test_first_build_by_four_processes_at_once(tmp_path):
    """Four processes find no library and no tables and build them into
    one directory at the same moment; each loads a whole library and
    working tables, and only the finished files are left."""
    build_dir = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_AND_USE,
                               str(build_dir)], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    assert len({out for out, _ in outs}) == 1
    names = sorted(p.name for p in build_dir.iterdir())
    lib, tables = outs[0][0].split()
    assert names == sorted([lib, tables, native.library_path(
        "analyzer").name])


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O3", "-shared", "-fPIC",
                                              "-DBROKEN", "-include",
                                              "no_such_header.h"))
    with pytest.raises(RuntimeError, match="g.. failed for postings.cc"):
        native.build("postings")
    assert list(tmp_path.iterdir()) == []  # no half-written library
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g.. not found"):
        native.build("postings")


def test_library_name_follows_source_and_flags(monkeypatch):
    a = native.library_path("postings")
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O2", "-shared", "-fPIC"))
    b = native.library_path("postings")
    assert a != b and a.parent == b.parent == native.BUILD_DIR
    assert native.library_path("analyzer") != a
