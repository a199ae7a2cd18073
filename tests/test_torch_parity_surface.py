"""kbner_tpu's public surface, name by name, in kbner_tpu_torch: every
public top-level function, class and constant of each reference module,
every public method of each of its classes, and every name of each
package ``__init__``'s ``__all__`` has a counterpart in the port's module
of the same path. A counterpart has the same name (defined there,
imported there, or for a method defined on the class or on a base class
of the same module), or is the one ``RENAMES`` names with its reason.

Both trees are parsed with ``ast``; neither package is imported. One case
per reference module, so a name the port drops fails its module's case.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
REF = REPO / "kbner_tpu"
PORT = REPO / "kbner_tpu_torch"

FLAX_SETUP = (None, "Flax's setup; the port builds its submodules in "
                    "__init__")

# "module:name", "module:Class.method" or "module:__all__.name" of the
# reference -> (the port's counterpart in the same module, or None where
# the name is JAX idiom with no counterpart to have; the reason)
RENAMES = {
    "models/__init__.py:__all__.init_tagger": (
        "SequenceTagger", "a torch module is built by its constructor, "
        "SequenceTagger(config, device=, seed=)"),
    "models/__init__.py:__all__.init_stacked_tagger": (
        "StackedSequenceTagger", "a torch module is built by its "
        "constructor"),
    "models/tagger.py:init_tagger": (
        "SequenceTagger", "a torch module is built by its constructor, "
        "SequenceTagger(config, device=, seed=)"),
    "models/tagger.py:init_stacked_tagger": (
        "StackedSequenceTagger", "a torch module is built by its "
        "constructor"),
    "models/tagger.py:SequenceTagger.setup": FLAX_SETUP,
    "models/tagger.py:StackedSequenceTagger.setup": FLAX_SETUP,
    "models/biaffine.py:BiaffineParser.setup": FLAX_SETUP,
    "models/biaffine.py:BiaffineNER.setup": FLAX_SETUP,
    "models/biaffine.py:SemanticDependencyParser.setup": FLAX_SETUP,
    "models/classifier.py:TextClassifier.setup": FLAX_SETUP,
    "models/classifier.py:TextRegressor.setup": FLAX_SETUP,
    "models/embedders.py:CharLMHead.setup": FLAX_SETUP,
    "models/embedders.py:FlairLMEmbedder.setup": FLAX_SETUP,
    "models/embedders.py:ELMoLSTMPCell.num_feature_axes": (
        None, "Flax's RNNCellBase protocol for nn.RNN; the port runs the "
        "cell's recurrence in ELMoLSTMP, not through a generic RNN"),
    "ops/mfvi.py:MFVIHead.setup": FLAX_SETUP,
    "ops/__init__.py:__all__.bm25_score_block_pallas": (
        "bm25_score_block", "K1's wrapper: the CUDA kernel on the card"),
    "ops/__init__.py:__all__.bm25_score_block_xla": (
        "bm25_score_block_ref", "K1's plain PyTorch twin"),
    "ops/bm25.py:bm25_score_block_pallas": (
        "bm25_score_block", "K1's wrapper: the CUDA kernel on the card"),
    "ops/bm25.py:bm25_score_block_xla": (
        "bm25_score_block_ref", "K1's plain PyTorch twin"),
    "ops/bm25.py:bm25_rescore_pallas": (
        "bm25_rescore", "K3's wrapper: the CUDA kernel on the card"),
    "ops/bm25.py:delta16_rescore_pallas": (
        "delta16_rescore", "K2's wrapper: the CUDA kernel on the card"),
    "native/__init__.py:build_library": (
        "build", "native.build(name) compiles either library"),
    "native/__init__.py:build_analyzer_library": (
        "build", "native.build(name) compiles either library"),
    "parallel/sharding_rules.py:tagger_param_shardings": (
        "param_placements", "torch placements per parameter name in place "
        "of a tree of NamedShardings"),
    "retrieval/engine.py:RetrievalEngine.unpack_result": (
        None, "unpacks the reference's packed [Q, 2k] int32 device result; "
        "the port's searches return (scores, ids) tensors"),
    "train/optim.py:sgdw": (
        "SGDW", "a torch.optim.Optimizer in place of an optax chain"),
}


def _surface(path: Path):
    """(top-level public names -> None or {class: public methods, with its
    same-module bases' folded in}, names imported at the top level,
    ``__all__``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defs, classes, imported, exported = {}, {}, set(), []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = None
        elif isinstance(node, ast.ClassDef):
            classes[node.name] = node
            defs[node.name] = None
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported |= {(a.asname or a.name).split(".")[0]
                         for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    exported = [ast.literal_eval(e) for e in node.value.elts]
                else:
                    defs[t.id] = None

    def methods(name, seen=()):
        node = classes[name]
        out = {m.name for m in node.body
               if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
               and not m.name.startswith("_")}
        for base in node.bases:
            if isinstance(base, ast.Name) and base.id in classes \
                    and base.id not in seen:
                out |= methods(base.id, seen + (name,))
        return out

    for name in classes:
        defs[name] = methods(name)
    public = {k: v for k, v in defs.items() if not k.startswith("_")}
    return public, imported, exported


def _reference_modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", _reference_modules())
def test_module_surface_has_a_counterpart(module):
    port_path = PORT / module
    assert port_path.exists(), f"no kbner_tpu_torch/{module}"
    ref, _, ref_all = _surface(REF / module)
    port, port_imported, port_all = _surface(port_path)
    top = set(port) | port_imported

    def has(name, cls=None):
        if cls is None:
            return name in top
        return isinstance(port.get(cls), set) and name in port[cls]

    wanted = [(n, None) for n in ref]
    wanted += [(m, cls) for cls, ms in ref.items() if ms for m in ms]
    missing, used = [], set()
    for name, cls in wanted:
        key = f"{module}:{name}" if cls is None else f"{module}:{cls}.{name}"
        if has(name, cls):
            continue
        if key in RENAMES:
            used.add(key)
            target, reason = RENAMES[key]
            assert reason, key
            if target is not None and not has(target, cls):
                missing.append(f"{key} -> {target}")
            continue
        missing.append(key)
    for name in ref_all:
        key = f"{module}:__all__.{name}"
        if name in port_all:
            continue
        if key in RENAMES:
            used.add(key)
            target, reason = RENAMES[key]
            if target is None or target not in port_all:
                missing.append(f"{key} -> {target}")
            continue
        missing.append(key)
    assert not missing, missing
    stale = {k for k in RENAMES if k.startswith(f"{module}:")} - used
    assert not stale, f"rename entries for names the port has: {stale}"


def test_every_rename_gives_a_reason():
    assert RENAMES
    for key, (target, reason) in RENAMES.items():
        module = key.split(":")[0]
        assert (REF / module).exists(), key
        assert len(reason.split()) >= 3, key
