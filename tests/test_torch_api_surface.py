"""The last small pieces of kbner_tpu's public surface in the port, each
against the reference on the same inputs: ``Dictionary.from_items`` and
``get_items``, ``SentenceRecord.get_tags``, ``EncodedBatch.num_sentences``
and ``ELMoLSTMPCell`` (against Flax's cell on the same weights, carried
under the names ``weights.py`` keeps for bilm-tf cells: ``W_0``, ``B``,
``W_P_0`` as they are, 8 steps from a zero carry, float32 rtol 1e-5);
every name of each package ``__init__``'s ``__all__``, imported in a
fresh process that then holds no JAX and no built kernel; and the new
entry points' default device, the card.

``tests/test_torch_parity_surface.py`` checks by name that nothing of
the reference's surface is missing; this file checks behaviour."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu.data.dictionary import Dictionary as JDictionary
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models.embedders import ELMoLSTMPCell as JCell
from kbner_tpu_torch.data import (Dictionary, HashTokenizer, encode_batch,
                                  quality_fixture)
from kbner_tpu_torch.models.embedders import ELMoLSTMPCell

REPO = Path(__file__).resolve().parents[1]
PACKAGES = ("data", "models", "ops", "retrieval", "train", "parallel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("add_unk", [False, True])
def test_dictionary_from_items_and_get_items(add_unk):
    items = ["O", "B-PER", "I-PER", "O", "S-LOC", "B-PER"]
    got = Dictionary.from_items(items, add_unk=add_unk)
    want = JDictionary.from_items(items, add_unk=add_unk)
    assert got.get_items() == want.get_items()
    assert got.item2idx == want.item2idx
    assert got.get_items() is not got.idx2item
    assert got.get_idx_for_item("nowhere" if add_unk else "S-LOC") == \
        want.get_idx_for_item("nowhere" if add_unk else "S-LOC")


def test_get_tags_and_num_sentences():
    records = quality_fixture.make_quality_corpus(5, 1, 1, seed=4).train
    jrecords = jquality.make_quality_corpus(5, 1, 1, seed=4).train
    assert [r.get_tags("ner") for r in records] == \
        [r.get_tags("ner") for r in jrecords]
    with pytest.raises(KeyError):
        records[0].get_tags("pos")
    tags = Dictionary.from_items(
        sorted({t for r in records for t in r.tags["ner"]}))
    jtags = JDictionary.from_items(tags.get_items())
    eb = encode_batch(records, HashTokenizer(1000), tags)
    jeb = j_encode(jrecords, JTokenizer(1000), jtags)
    assert eb.num_sentences == jeb.num_sentences == 5
    assert eb.num_sentences == eb.input_ids.shape[0]


@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_elmo_lstmp_cell_matches_flax(lead):
    D, Cd, P, T = 6, 8, 4, 8
    rng = np.random.RandomState(11)
    xs = rng.randn(T, *lead, D).astype(np.float32) * 2.0
    jcell = JCell(cell_dim=Cd, proj_dim=P)
    jcarry = jcell.initialize_carry(jax.random.PRNGKey(0), lead + (D,))
    params = jcell.init(jax.random.PRNGKey(1), jcarry, jnp.asarray(xs[0]))
    flax_params = jax.tree_util.tree_map(np.asarray, params["params"])
    # a bias that opens the i, j and f gates (order i, j, f, o), so the
    # cell state grows past the clip within the 8 steps
    flax_params["B"] = (rng.randn(4 * Cd) * 0.5 + np.repeat(
        [3.0, 3.0, 5.0, 0.0], Cd)).astype(np.float32)

    cell = ELMoLSTMPCell(D, Cd, P)
    assert {k: tuple(v.shape) for k, v in cell.state_dict().items()} == \
        {k: v.shape for k, v in flax_params.items()}
    cell.load_state_dict({k: torch.from_numpy(v.copy())
                          for k, v in flax_params.items()})
    carry = cell.initialize_carry(None, lead + (D,))
    assert [tuple(t.shape) for t in carry] == \
        [tuple(t.shape) for t in jcarry]
    assert all(not t.any() for t in carry)
    clipped = False
    with torch.no_grad():
        for x in xs:
            jcarry, jh = jcell.apply({"params": flax_params}, jcarry,
                                     jnp.asarray(x))
            carry, h = cell(carry, torch.from_numpy(x))
            for got, want in zip(carry + (h,), tuple(jcarry) + (jh,)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-6)
            clipped |= bool((carry[0].abs() == 3.0).any())
    assert clipped, "no cell state reached the clip: the clip is untested"


def test_elmo_lstmp_cell_draws_flax_initializers():
    cell = ELMoLSTMPCell(40, 64, 32)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    assert not cell.B.any()
    for w in (cell.W_0, cell.W_P_0):
        assert float(w.detach().std()) == pytest.approx(w.shape[0] ** -0.5, rel=0.1)


def test_every_exported_name_imports_without_jax_or_a_kernel_build():
    code = (
        "import importlib, sys\n"
        f"for p in {PACKAGES!r}:\n"
        "    mod = importlib.import_module('kbner_tpu_torch.' + p)\n"
        "    assert mod.__all__, p\n"
        "    missing = [n for n in mod.__all__ if not hasattr(mod, n)]\n"
        "    assert not missing, (p, missing)\n"
        "    ns = {}\n"
        "    exec(f'from kbner_tpu_torch.{p} import *', ns)\n"
        "    assert set(mod.__all__) <= set(ns), p\n"
        "from kbner_tpu_torch.ops import _kernels, bm25\n"
        "assert type(bm25).__name__ == 'module', bm25\n"
        "assert not _kernels._loaded, _kernels._loaded\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'kbner_tpu')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_new_entry_points_default_to_the_card(no_cuda, tmp_path):
    for gate in (quality_fixture.run_quality_gate,
                 quality_fixture.run_parser_quality_gate,
                 quality_fixture.run_classifier_quality_gate):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            gate(max_epochs=1)
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import end_to_end_torch
    finally:
        sys.path.remove(str(REPO / "examples"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        end_to_end_torch.main(work_dir=tmp_path)
