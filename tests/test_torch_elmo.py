"""The PyTorch port's ELMo member against kbner_tpu's on the same numpy
inputs: its features and every parameter's gradient against ``jax.grad``
in both topologies and all four layer modes (even convolution widths,
pad words, words of no character, ids past the table); the HDF5 reader
against h5py and ``load_hdf5`` against kbner_tpu's on the JAX test's
bilm-tf file (tests/test_elmo_hdf5.py), with ``h5py`` unimportable too;
npz weight files crossing both ways.

Tolerances, float32 on the CPU: features rtol 1e-5, atol 1e-6;
gradients rtol 1e-4, atol 1e-5 (sums over characters, words and 4 gates
in another order than XLA's); the numpy bilm oracle within 1e-5; weights
read from files bit for bit.
"""

import sys
from pathlib import Path

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.models.embedders import ELMoEmbedder as JELMo
from kbner_tpu_torch import weights
from kbner_tpu_torch.models.embedders import ELMoEmbedder, ELMoLSTMP
from kbner_tpu_torch.models.hdf5 import Group, HDF5Error, HDF5File

sys.path.insert(0, str(Path(__file__).parent))
from test_elmo_hdf5 import (CELL, CHAR_D, CHAR_V, FILTERS, LAYERS,  # noqa: E402
                            N_HIGH, PROJ, numpy_bilm, write_bilm_hdf5)

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
ORACLE_TOL = 1e-5
MODES = ("all", "top", "average", "mix")
# widths 2 and 4 pad SAME unevenly; the native topology's C is 7, so the
# VALID widths of the bilm-tf one leave 4 to 7 positions
WIDTHS = ((1, 3), (2, 4), (4, 2))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(seed=0, key="char_ids", V=20, C=7):
    """Ragged sentences (pad words), a word of no character, and ids past
    the table (clamped)."""
    rng = np.random.RandomState(seed)
    B, W = 3, 5
    ids = rng.randint(0, V + 3, size=(B, W, C)).astype(np.int32)
    mask = (rng.rand(B, W, C) > 0.3).astype(np.int32)
    mask[0, 1] = 0
    word_mask = np.ones((B, W), np.int32)
    word_mask[1, 3:] = 0
    word_mask[2, 1:] = 0
    return {key: ids, key.replace("ids", "mask"): mask,
            "word_mask": word_mask}


def _perturbed(params, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)


def _pair(kw, arrays, seed=0):
    jm, pm = JELMo(**kw), ELMoEmbedder(**kw)
    params = _perturbed(jm.init(jax.random.PRNGKey(seed), {
        k: jnp.asarray(v) for k, v in arrays.items()}), seed + 1)
    pm.load_state_dict(weights.member_from_jax_params(params, pm),
                       strict=True)
    return jm, params, pm


def _kw(bilm, mode, **over):
    kw = dict(char_vocab_size=20, char_dim=4, filters=WIDTHS, n_highway=2,
              proj_dim=5, num_layers=2, mode=mode)
    if bilm:
        kw.update(cell_dim=6, conv_activation="relu",
                  input_key="elmo_char_ids")
    kw.update(over)
    return kw


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bilm", [False, True], ids=["native", "bilm"])
def test_features_and_gradients_match_flax(bilm, mode):
    arrays = _batch(3, "elmo_char_ids" if bilm else "char_ids")
    jm, params, pm = _pair(_kw(bilm, mode), arrays, seed=4)
    jarrays = {k: jnp.asarray(v) for k, v in arrays.items()}
    got = pm({k: torch.from_numpy(v) for k, v in arrays.items()})
    want = np.asarray(jm.apply(params, jarrays))
    assert got.shape == want.shape == (3, 5, pm.out_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    assert not got[1, 3:].any() and not got[2, 1:].any()  # pad words
    w = np.random.RandomState(5).randn(*want.shape).astype(np.float32)
    grads = jax.grad(lambda p: jnp.sum(jm.apply(p, jarrays) * w))(params)
    (got * torch.from_numpy(w)).sum().backward()
    want_g = weights.member_from_jax_params(
        jax.tree_util.tree_map(np.asarray, grads), pm)
    named = dict(pm.named_parameters())
    assert named.keys() == want_g.keys()
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("bilm", [False, True], ids=["native", "bilm"])
def test_tree_crosses_both_ways_with_flax_names(bilm):
    """The member's Flax tree is the Flax ``init``'s, leaf for leaf."""
    arrays = _batch(6, "elmo_char_ids" if bilm else "char_ids")
    _, params, pm = _pair(_kw(bilm, "mix"), arrays, seed=7)
    tree = weights.member_to_jax_params(pm.state_dict(), pm)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params["params"])
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        np.array_equal, tree, params["params"]))


def test_drawn_like_flax():
    """Every parameter's draw has Flax's mean and spread (conv kernels
    lecun-normal over width x input channels, LSTMP kernels over their
    rows, zero biases, the table normal(0, 1/D))."""
    kw = _kw(True, "all", char_dim=16, filters=((2, 64), (5, 64)),
             proj_dim=32, cell_dim=64, char_vocab_size=261)
    pm = ELMoEmbedder(**kw)
    pm.reset_parameters(torch.Generator().manual_seed(0))
    params = JELMo(**kw).init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in _batch(
            0, "elmo_char_ids", 261, 50).items()})
    want = weights.member_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params), pm)
    for name, p in pm.state_dict().items():
        w = want[name]
        assert float(p.std()) == pytest.approx(float(w.std()), rel=0.1,
                                               abs=1e-6), name
        assert abs(float(p.mean()) - float(w.mean())) < 0.05, name


def test_lstmp_projects_every_step_input_at_once():
    """The cell's loop equals a step-by-step numpy LSTMP (tf gate order,
    forget bias 1, clips of 3) in both directions, within each row's
    length."""
    rng = np.random.RandomState(8)
    n, T, D, Cd, P = 3, 6, 4, 5, 3
    x = rng.randn(n, T, D).astype(np.float32)
    lengths = np.array([6, 2, 4])
    for reverse in (False, True):
        cell = ELMoLSTMP(D, Cd, P, reverse=reverse)
        with torch.no_grad():
            for t in (cell.W_0, cell.B, cell.W_P_0):
                t.copy_(torch.from_numpy(
                    rng.randn(*t.shape).astype(np.float32)))
        got = cell(torch.from_numpy(x), torch.from_numpy(lengths))
        W, B, Wp = (t.detach().numpy() for t in (cell.W_0, cell.B,
                                                  cell.W_P_0))
        sig = lambda v: 1 / (1 + np.exp(-v))  # noqa: E731
        for b in range(n):
            L = lengths[b]
            seq = x[b, :L][::-1] if reverse else x[b, :L]
            c, h = np.zeros(Cd), np.zeros(P)
            outs = []
            for t in range(L):
                i, j, f, o = np.split(np.concatenate([seq[t], h]) @ W + B, 4)
                c = np.clip(sig(f + 1) * c + sig(i) * np.tanh(j), -3, 3)
                h = np.clip((sig(o) * np.tanh(c)) @ Wp, -3, 3)
                outs.append(h)
            outs = np.stack(outs)[::-1] if reverse else np.stack(outs)
            np.testing.assert_allclose(got[b, :L].detach().numpy(), outs,
                                       rtol=1e-5, atol=1e-6)


# -- the HDF5 reader ------------------------------------------------------------------

def _bilm(**over):
    kw = dict(char_vocab_size=CHAR_V, char_dim=CHAR_D, filters=FILTERS,
              n_highway=N_HIGH, proj_dim=PROJ, num_layers=LAYERS,
              mode="all", cell_dim=CELL, conv_activation="relu")
    kw.update(over)
    return kw


def _oracle_batch(rng):
    B, W, C = 2, 6, 7
    char_ids = rng.randint(0, CHAR_V, size=(B, W, C)).astype(np.int32)
    return char_ids, {"char_ids": char_ids,
                      "char_mask": np.ones((B, W, C), np.int32),
                      "word_mask": np.ones((B, W), np.int32)}


def test_load_hdf5_equals_the_reference_bit_for_bit(tmp_path):
    rng = np.random.RandomState(0)
    path = tmp_path / "elmo_weights.hdf5"
    write_bilm_hdf5(path, rng)
    char_ids, arrays = _oracle_batch(rng)
    jm = JELMo(**_bilm())
    want = JELMo.load_hdf5(path, jm.init(jax.random.PRNGKey(0), {
        k: jnp.asarray(v) for k, v in arrays.items()}))
    pm = ELMoEmbedder(**_bilm())
    pm.reset_parameters(torch.Generator().manual_seed(0))
    tree = pm.load_hdf5(path)
    for got in (tree, weights.member_to_jax_params(pm.state_dict(), pm)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want["params"])
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(
            np.array_equal, got, want["params"]))
    out = pm({k: torch.from_numpy(v) for k, v in arrays.items()})
    with h5py.File(path, "r") as f:
        oracle = numpy_bilm(f, char_ids)
    np.testing.assert_allclose(out.detach().numpy(), oracle,
                               rtol=ORACLE_TOL, atol=ORACLE_TOL)


def test_load_hdf5_needs_no_h5py(tmp_path, monkeypatch):
    rng = np.random.RandomState(1)
    path = tmp_path / "elmo_weights.hdf5"
    write_bilm_hdf5(path, rng)
    with h5py.File(path, "r") as f:
        want = np.asarray(f["RNN_1/RNN/MultiRNNCell/Cell1/LSTMCell/W_0"])
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError):
        import h5py as _  # noqa: F401
    pm = ELMoEmbedder(**_bilm())
    pm.load_hdf5(path)
    np.testing.assert_array_equal(pm.bwd1.W_0.detach().numpy(), want)


def test_load_hdf5_checks_shapes(tmp_path):
    path = tmp_path / "elmo_weights.hdf5"
    write_bilm_hdf5(path, np.random.RandomState(2))
    with pytest.raises(ValueError, match="vs model"):
        ELMoEmbedder(**_bilm(proj_dim=PROJ + 1)).load_hdf5(path)


def _layouts(path, rng, userblock=0):
    """Datasets of every kind the reader reads, in several groups (after
    a user block of ``userblock`` bytes: the superblock then sits there)."""
    with h5py.File(path, "w", userblock_size=userblock) as f:
        f["f32"] = rng.randn(3, 4).astype(np.float32)
        f["g/f64be"] = rng.randn(5).astype(">f8")
        f["g/h/i16"] = rng.randint(-5, 5, size=(2, 3, 4)).astype(np.int16)
        f["g/h/u8"] = rng.randint(0, 255, size=(9,)).astype(np.uint8)
        f["g/i64be"] = rng.randint(-9, 9, size=(2, 2)).astype(">i8")
        f["f16"] = rng.randn(4, 2).astype(np.float16)
        f["scalar"] = np.float64(3.5)
        f.create_dataset("chunked", data=rng.randn(37, 11).astype(
            np.float32), chunks=(8, 5))
        # enough chunks for B-tree nodes above the leaves
        f.create_dataset("chunked_deep", data=rng.randn(900, 70).astype(
            np.float32), chunks=(8, 7))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        ds = h5py.h5d.create(f.id, b"compact", h5py.h5t.NATIVE_INT32,
                             h5py.h5s.create_simple((6,)), dcpl)
        ds.write(h5py.h5s.ALL, h5py.h5s.ALL, np.arange(6, dtype=np.int32))
        for i in range(40):  # more members than one symbol node holds
            f[f"many/x{i}"] = np.full(3, i, np.float32)


def _read_all(path):
    """Every dataset of the file by its path, through the group listing."""
    out = {}

    def walk(group, prefix):
        for key in group.keys():
            node = group[key]
            if isinstance(node, Group):
                walk(node, f"{prefix}{key}/")
            else:
                out[prefix + key] = node[()]

    with HDF5File(path) as f:
        walk(f, "")
    return out


@pytest.mark.parametrize("userblock", [0, 512])
def test_reader_equals_h5py_on_every_layout_it_reads(tmp_path, userblock):
    path = tmp_path / "layouts.h5"
    _layouts(path, np.random.RandomState(3), userblock)
    got = _read_all(path)
    with h5py.File(path, "r") as f:
        want = {}
        f.visititems(lambda k, v: want.__setitem__(k, v[()]) if isinstance(
            v, h5py.Dataset) else None)
    assert got.keys() == want.keys() and len(got) == 50
    for k, v in want.items():
        assert got[k].dtype == v.dtype.newbyteorder("="), k
        assert got[k].shape == np.shape(v), k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with HDF5File(path) as f:
        assert sorted(f.keys()) == sorted(h5py.File(path, "r").keys())
        assert "g/h/i16" in f and "g/nope" not in f
        assert f["chunked"].shape == (37, 11)


def test_chunked_unfiltered_weights_load(tmp_path):
    """A weight file whose arrays are chunked (no filter) loads as the
    contiguous one does."""
    plain, chunked = tmp_path / "plain.hdf5", tmp_path / "chunked.hdf5"
    write_bilm_hdf5(plain, np.random.RandomState(4))
    with h5py.File(plain, "r") as src, h5py.File(chunked, "w") as dst:
        def copy(name, obj):
            if isinstance(obj, h5py.Dataset):
                data = obj[()]
                dst.create_dataset(name, data=data, chunks=tuple(
                    max(1, s // 3) for s in data.shape))
        src.visititems(copy)
    with h5py.File(chunked, "r") as f:
        assert f["CNN_proj/W_proj"].chunks is not None
    a, b = ELMoEmbedder(**_bilm()), ELMoEmbedder(**_bilm())
    a.load_hdf5(plain)
    b.load_hdf5(chunked)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("kind", ["gzip", "shuffle", "latest"])
def test_unread_layouts_raise_naming_the_dataset(tmp_path, kind):
    path = tmp_path / "w.hdf5"
    write_bilm_hdf5(path, np.random.RandomState(5))
    bad = tmp_path / "bad.hdf5"
    opts = {"gzip": dict(compression="gzip"), "shuffle": dict(
        shuffle=True, chunks=True), "latest": {}}[kind]
    with h5py.File(path, "r") as src, h5py.File(
            bad, "w", libver="latest" if kind == "latest" else "earliest"
    ) as dst:
        def copy(name, obj):
            if isinstance(obj, h5py.Dataset):
                dst.create_dataset(name, data=obj[()], **(
                    opts if name == "CNN_proj/W_proj" else {}))
        src.visititems(copy)
    match = ("version 2 object headers|superblock version"
             if kind == "latest" else "'/CNN_proj/W_proj'.*filter pipeline")
    with pytest.raises(HDF5Error, match=match):
        ELMoEmbedder(**_bilm()).load_hdf5(bad)


def test_reader_refuses_files_that_are_not_hdf5(tmp_path):
    path = tmp_path / "x.hdf5"
    path.write_bytes(b"not an hdf5 file" * 64)
    with pytest.raises(HDF5Error, match="no HDF5 signature"):
        HDF5File(path)


# -- npz weight files -------------------------------------------------------------------

@pytest.mark.parametrize("bilm", [False, True], ids=["native", "bilm"])
def test_npz_crosses_both_ways(tmp_path, bilm):
    arrays = _batch(9, "elmo_char_ids" if bilm else "char_ids")
    kw = _kw(bilm, "mix" if bilm else "all")
    jm, params, pm = _pair(kw, arrays, seed=10)
    sub = params["params"]
    # the JAX package's file into the port
    jpath = tmp_path / "jax.npz"
    JELMo.save_npz(jpath, sub)
    other = ELMoEmbedder(**kw)
    other.load_npz(jpath)
    for (name, x), y in zip(pm.state_dict().items(),
                            other.state_dict().values()):
        assert torch.equal(x, y), name
    # the port's file into the JAX package
    ppath = tmp_path / "port.npz"
    pm.save_npz(ppath)
    with np.load(ppath) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
    like = _perturbed(sub, 11)
    back = JELMo.load_npz(ppath, like)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda x, y: np.array_equal(np.asarray(x), y), back, sub))
    with pytest.raises(ValueError, match="shape mismatch"):
        ELMoEmbedder(**dict(kw, proj_dim=6)).load_npz(ppath)
