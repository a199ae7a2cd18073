"""Package rules of the PyTorch port: it imports nothing of JAX or of
kbner_tpu, its entry points run on the card unless the caller asks for the
CPU, and each kernel wrapper hands CUDA tensors to its kernel only (the
plain version is taken for CPU tensors and nowhere else).

There is no card here: the CUDA branch is driven with meta tensors and a
stand-in launcher, patched for one test at a time.
"""

import ctypes
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import kbner_tpu_torch
from kbner_tpu_torch import cli, device
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.data.conll import write_column_file
from kbner_tpu_torch.data.dictionary import make_tag_dictionary
from kbner_tpu_torch.data.quality_fixture import make_quality_corpus
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.ops import _kernels, bm25
from kbner_tpu_torch.retrieval.engine import RetrievalEngine
from kbner_tpu_torch.retrieval.index import BM25Index, BM25Params
from kbner_tpu_torch.train import FinetuneTrainer

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "kbner_tpu_torch"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        kbner_tpu_torch.__path__, prefix="kbner_tpu_torch."))


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    assert "kbner_tpu_torch.ops.bm25" in mods and len(mods) >= 20
    assert {"kbner_tpu_torch.models.embedders",
            "kbner_tpu_torch.train.reinforce",
            "kbner_tpu_torch.train.lm_trainer",
            "kbner_tpu_torch.eval.ensemble",
            "kbner_tpu_torch.train.distill",
            "kbner_tpu_torch.models.ensemble_model",
            "kbner_tpu_torch.data.windows",
            "kbner_tpu_torch.data.doc_context",
            "kbner_tpu_torch.data.corpora",
            "kbner_tpu_torch.ops.tree_crf",
            "kbner_tpu_torch.models.biaffine",
            "kbner_tpu_torch.models.classifier",
            "kbner_tpu_torch.train.parser_trainer",
            "kbner_tpu_torch.models.hdf5",
            "kbner_tpu_torch.ops.mfvi",
            "kbner_tpu_torch.train.param_search",
            "kbner_tpu_torch.utils.artifacts",
            "kbner_tpu_torch.utils.html_viz",
            "kbner_tpu_torch.utils.plotter",
            "kbner_tpu_torch.utils.progress"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', "
            "'msgpack', 'kbner_tpu') or m.startswith(('jax.', 'flax.', "
            "'optax.', 'msgpack.', 'kbner_tpu.'))]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_no_source_line_imports_jax_or_kbner_tpu():
    pattern = re.compile(
        r"^\s*(from|import) (jax|flax|optax|msgpack|kbner_tpu)(\.|\s|$)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits


def test_no_module_imports_the_hf_libraries():
    """The card machine has no ``safetensors``, ``transformers``,
    ``tokenizers``, ``sentencepiece`` or ``regex``: no module of the port
    imports them, at import time or in any source line (the checkpoint
    reader and the ``tokenizer.json`` reader are the port's own)."""
    names = ("safetensors", "transformers", "tokenizers", "sentencepiece",
             "regex")
    pattern = re.compile(rf"^\s*(from|import) ({'|'.join(names)})(\.|\s|$)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {names!r}]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_no_module_imports_h5py():
    """The card machine has no ``h5py``: ELMo's weight files are read by
    the port's own HDF5 reader, and no module imports it, at import time
    or in any source line."""
    pattern = re.compile(r"^\s*(from|import) h5py(\.|\s|$)")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert not hits, hits
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "assert 'h5py' not in sys.modules\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr + out.stdout


def test_no_library_rnn_or_compiled_graph():
    """The LSTMs are written out (no cuDNN RNN through ``nn.LSTM``/
    ``nn.GRU`` or ``torch._VF``), and nothing goes through
    ``torch.compile`` or a fused attention call."""
    pattern = re.compile(r"nn\.(LSTM|GRU|RNN)\(|_VF\.|torch\.compile\(|"
                         r"scaled_dot_product_attention")
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.search(line)]
    assert not hits, hits


# -- entry points run on the card by default -----------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_config():
    return TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(), make_tag_dictionary([["S-PER", "S-LOC"]]))


def test_resolve_device_refuses_cuda_without_a_card(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device.resolve_device()
    assert device.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_the_card(no_cuda, tmp_path, monkeypatch):
    index = BM25Index.build(["a b c", "b c d"], pad_docs_to=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RetrievalEngine(index)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SequenceTagger(_tiny_config())
    assert RetrievalEngine(index, device="cpu").device.type == "cpu"

    target = tmp_path / "run"
    make_tag_dictionary([["S-PER"]]).save(target / "tag_dictionary.json")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(f"name: t\ntokenizer: {{type: hash, vocab_size: 1000}}\n"
                   f"model: {{encoder: tiny}}\ntarget_dir: {target}\n")
    monkeypatch.setattr("sys.stdin", iter(()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--config", str(cfg)])

    # the trainer and the training CLI
    corpus = make_quality_corpus(8, 2, 2)
    tags = corpus.make_tag_dictionary("ner")
    tagger = SequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(), tags), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FinetuneTrainer(tagger, corpus, HashTokenizer(1000), tags)
    assert FinetuneTrainer(tagger, corpus, HashTokenizer(1000), tags,
                           device="cpu").device.type == "cpu"
    data = tmp_path / "data"
    write_column_file(data / "train.txt", corpus.train)
    cfg.write_text(yaml.safe_dump({
        "name": "t", "tokenizer": {"type": "hash", "vocab_size": 1000},
        "model": {"encoder": "tiny"}, "target_dir": str(target),
        "corpora": [{"name": "Q", "data_folder": str(data),
                     "column_format": {0: "text", 1: "ner"},
                     "tag_to_bioes": None}]}))
    for command in ("train", "test"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([command, "--config", str(cfg)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["parse", "--config", str(cfg), "--target_dir", str(data)])

    # the offline KB stage: retrieve and serving from a saved KB need the
    # card; ingest-dump and index run on the host
    kb = tmp_path / "kb.jsonl"
    kb.write_text('{"title": "T", "sentence": "a b c"}\n')
    cli.main(["index", "--kb", str(kb), "--out", str(tmp_path / "kb")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["retrieve", "--index_dir", str(tmp_path / "kb"),
                  "--data_folder", str(data), "--out", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "--config", str(cfg), "--index_dir",
                  str(tmp_path / "kb")])


def test_ace_lm_and_speed_entry_points_default_to_the_card(no_cuda,
                                                         tmp_path):
    """The stacked tagger, the char-LM trainer and the ACE, LM and speed
    commands need the card unless asked for the CPU; ensemble and
    evaluate run on the host."""
    from kbner_tpu_torch.models.embedders import EmbedderSpec, WordEmbedder
    from kbner_tpu_torch.models.tagger import StackedSequenceTagger
    from kbner_tpu_torch.train.lm_trainer import LanguageModelTrainer
    from kbner_tpu_torch.models.embedders import CharLMHead

    spec = [EmbedderSpec("w", WordEmbedder(5, 3), 3)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StackedSequenceTagger(_tiny_config(), spec)
    assert StackedSequenceTagger(_tiny_config(), spec,
                                 device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LanguageModelTrainer(CharLMHead(5, 2, 3), None)

    corpus = make_quality_corpus(8, 2, 2).corpora[0]
    data = tmp_path / "data"
    for split in ("train", "dev", "test"):
        write_column_file(data / f"{split}.txt", getattr(corpus, split))
    base = {"name": "t", "tokenizer": {"type": "hash", "vocab_size": 1000},
            "model": {"encoder": "tiny"}, "target_dir": str(tmp_path / "r"),
            "corpora": [{"name": "Q", "data_folder": str(data),
                         "column_format": {0: "text", 1: "ner"},
                         "tag_to_bioes": None}]}
    for name, extra in (("ace", {"trainer": "ReinforcementTrainer"}),
                        ("lm", {"trainer": "LanguageModelTrainer"}),
                        ("speed", {})):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump({**base, **extra}))
        command = "speed" if name == "speed" else "train"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([command, "--config", str(cfg)])
    pred = tmp_path / "p.conllu"
    pred.write_text("a S-PER S-PER\nb O O\n\n")
    cli.main(["ensemble", str(pred), str(pred), "--out",
              str(tmp_path / "e.conll")])
    cli.main(["evaluate", str(pred)])
    assert (tmp_path / "e.conll").read_text() == "a S-PER\nb O\n\n"


def test_distill_and_swaf_entry_points_default_to_the_card(no_cuda,
                                                           tmp_path):
    """The distillation trainer, the SWAF model and their ``cli train``
    routes need the card unless asked for the CPU."""
    from kbner_tpu_torch.models.ensemble_model import (EnsembleConfig,
                                                       EnsembleModel)
    from kbner_tpu_torch.train.distill import DistillationTrainer

    corpus = make_quality_corpus(8, 2, 2)
    tags = corpus.make_tag_dictionary("ner")
    tagger = SequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(), tags), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DistillationTrainer(tagger, corpus, HashTokenizer(1000), tags,
                            teachers=[tagger])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EnsembleModel(EnsembleConfig(2, 3))
    assert EnsembleModel(EnsembleConfig(2, 3), device="cpu"
                         ).hidden.weight.device.type == "cpu"
    data = tmp_path / "data"
    write_column_file(data / "train.txt", corpus.train)
    pred = tmp_path / "p.tsv"
    pred.write_text("a S-PER S-PER\nb O O\n\n")
    base = {"name": "t", "tokenizer": {"type": "hash", "vocab_size": 1000},
            "model": {"encoder": "tiny"}, "target_dir": str(tmp_path / "r"),
            "corpora": [{"name": "Q", "data_folder": str(data),
                         "column_format": {0: "text", 1: "ner"},
                         "tag_to_bioes": None}]}
    for name, extra in (
            ("kd", {"trainer": "DistillationTrainer",
                    "teachers": [str(tmp_path / "teacher.yaml")]}),
            ("swaf", {"trainer": "SWAFTrainer",
                      "systems": {"dev": [str(pred)], "test": [str(pred)]}})):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump({**base, **extra}))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["train", "--config", str(cfg)])


def test_checkpoint_and_parity_entry_points_default_to_the_card(no_cuda,
                                                               tmp_path):
    """``load_hf_checkpoint`` and ``cli parity`` need the card unless
    asked for the CPU; parity's skips need no device."""
    from kbner_tpu_torch.models.xlmr import load_hf_checkpoint

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_hf_checkpoint(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        load_hf_checkpoint(tmp_path / "ckpt", XLMRConfig.tiny(),
                           device="cpu")
    toy = REPO / "tests" / "fixtures" / "ner_toy"
    argv = ["parity", "--data", str(toy.parent), "--stage1_folder",
            toy.name, "--stage2_folder", toy.name, "--out",
            str(tmp_path / "out")]
    assert cli.main(argv[:2] + [str(tmp_path / "none")] + argv[3:]) is None
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(argv)


def test_elmo_bpemb_and_mfvi_entry_points_default_to_the_card(no_cuda,
                                                            tmp_path):
    """The MFVI head and ``cli train``/``test`` of an ACE stack with ELMo
    and BPEmb members need the card unless asked for the CPU."""
    from kbner_tpu_torch.ops.mfvi import MFVIHead

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MFVIHead(8, 3)
    assert MFVIHead(8, 3, device="cpu").potentials.W1.device.type == "cpu"
    fix = REPO / "tests" / "fixtures"
    raw = yaml.safe_load((fix / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(fix / "ner_toy")
    raw.update(trainer="ReinforcementTrainer", target_dir=str(tmp_path))
    raw["model"]["embeddings"] = [
        {"type": "elmo", "char_encoding": "elmo_bytes", "cell_dim": 4,
         "proj_dim": 3, "filters": [[1, 2]], "n_highway": 1},
        {"type": "bpemb", "dim": 3}]
    cfg = tmp_path / "ace.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    for cmd in ("train", "test"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([cmd, "--config", str(cfg)])
    trainer, _ = cli._build_ace(ExperimentConfig.from_file(cfg), "cpu")
    assert trainer.bpe_vocab is not None and trainer.elmo_bytes


def test_parser_and_classifier_entry_points_default_to_the_card(
        no_cuda, tmp_path):
    """The parsers, the classifier, the regressor, their trainers and the
    ``cli train``/``test``/``parse`` routes of every parsing and
    classification target need the card unless asked for the CPU."""
    from kbner_tpu_torch.models.biaffine import (
        BiaffineConfig, BiaffineNER, BiaffineNERConfig, BiaffineParser,
        SemanticDependencyParser, SemDepConfig)
    from kbner_tpu_torch.models.classifier import (
        TextClassifier, TextClassifierConfig, TextRegressor,
        TextRegressorConfig)
    from kbner_tpu_torch.train.parser_trainer import RegressionTrainer

    enc = XLMRConfig.tiny()
    for cls, cfg in ((BiaffineParser, BiaffineConfig(enc, 3)),
                     (SemanticDependencyParser, SemDepConfig(enc, 3)),
                     (BiaffineNER, BiaffineNERConfig(enc, 3)),
                     (TextClassifier, TextClassifierConfig(enc, 2)),
                     (TextRegressor, TextRegressorConfig(enc))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls(cfg)
        assert cls(cfg, device="cpu").device.type == "cpu"
    model = TextRegressor(TextRegressorConfig(enc), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        RegressionTrainer(model, None, HashTokenizer(1000))
    fix = REPO / "tests" / "fixtures"
    cfg = tmp_path / "dep.yaml"
    cfg.write_text(yaml.safe_dump({
        "name": "t", "targets": "dependency",
        "tokenizer": {"type": "hash", "vocab_size": 1000},
        "model": {"encoder": "tiny"}, "target_dir": str(tmp_path / "r"),
        "corpora": [{"name": "D", "data_folder": str(fix / "dep_toy"),
                     "column_format": {1: "text", 6: "head", 7: "deprel"},
                     "tag_to_bioes": None}]}))
    for argv in (["train"], ["test"],
                 ["parse", "--target_dir", str(fix / "dep_toy")]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv[:1] + ["--config", str(cfg)] + argv[1:])


def test_engine_modes_of_later_slices_raise():
    """Every engine mode is ported: a mesh that is not a DeviceMesh is a
    type error, ``topc_recall`` builds, and an unknown mode or row layout
    is a plain error. (The title field, packed32 rows and the two-operand
    top-k: tests/test_torch_rescore.py; deep windows:
    tests/test_torch_pruned.py; device=False: tests/test_torch_mix.py;
    meshes and topc_recall: tests/test_torch_sharded.py and
    tests/test_torch_mesh.py.)"""
    index = BM25Index.build(["a b c", "b c d", "c d e"], pad_docs_to=8)
    raw = BM25Index.build(["a b c"], params=BM25Params(quantize_norms=False),
                          pad_docs_to=8)
    with pytest.raises(TypeError, match="DeviceMesh"):
        RetrievalEngine(index, mode="pruned", mesh=object(), device="cpu")
    engine = RetrievalEngine(index, mode="pruned", topc_recall=0.9,
                             device="cpu")
    assert engine.topc_recall == 0.9
    with pytest.raises(ValueError, match="quantize_norms"):
        RetrievalEngine(raw, mode="pruned", row_layout="delta16",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown row_layout"):
        RetrievalEngine(index, mode="pruned", row_layout="dense",
                        device="cpu")
    with pytest.raises(ValueError, match="unknown engine mode"):
        RetrievalEngine(index, mode="fast", device="cpu")


# -- the kernel wrappers -----------------------------------------------------------

def _k1_operands(dev, Q=3, Lq=4, Ld=5, N=7):
    return (torch.zeros(Q, Lq, dtype=torch.int32, device=dev),
            torch.zeros(Q, Lq, dtype=torch.float32, device=dev),
            torch.zeros(Ld, N, dtype=torch.int32, device=dev),
            torch.zeros(Ld, N, dtype=torch.float32, device=dev))


def _k2_operands(dev, Q=3, W=4, C=7, NR=5, N=9):
    return (torch.zeros(Q, W, dtype=torch.int32, device=dev),
            torch.zeros(Q, W, dtype=torch.float32, device=dev),
            torch.zeros(Q, C, dtype=torch.int32, device=dev),
            torch.zeros(NR, 128, dtype=torch.int16, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev),
            torch.zeros(N, dtype=torch.int32, device=dev),
            torch.zeros(N, dtype=torch.uint8, device=dev))


def _k3_operands(dev, Q=3, Lq=4, C=7, N=9, Ld=5):
    return (torch.zeros(Q, Lq, dtype=torch.int32, device=dev),
            torch.zeros(Q, Lq, dtype=torch.float32, device=dev),
            torch.zeros(Q, C, dtype=torch.int32, device=dev),
            torch.zeros(N, Ld, dtype=torch.int32, device=dev),
            torch.zeros(N, Ld, dtype=torch.int16, device=dev))


K2_SCALARS = (1.2, 0.75, 20.5, 2)  # k1, b, avgdl, r2
K3_SCALARS = (-2.0, 0.1)  # lo, step; the launch takes them as float32
# per kernel: wrapper, plain version, device check, launcher, library
# symbol, operands, extra arguments, the launch's scalar arguments (after
# the pointers, stream last), output shape, argtypes, source, TPU kernel
KERNELS = {
    "bm25_score": dict(
        wrapper="bm25_score_block", plain="bm25_score_block_ref",
        check="_check_device", launcher="_launcher",
        symbol="bm25_score_block_launch", operands=_k1_operands, extra=(),
        launch_tail=(3, 4, 5, 7, 7, 1234), n_ptrs=5, out_shape=(3, 7),
        argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_longlong, ctypes.c_void_p],
        tpu="kbner_tpu/ops/bm25.py:_bm25_kernel"),
    "delta16_rescore": dict(
        wrapper="delta16_rescore", plain="delta16_rescore_ref",
        check="_check_d16_device", launcher="_d16_launcher",
        symbol="delta16_rescore_launch", operands=_k2_operands,
        extra=K2_SCALARS, launch_tail=(3, 4, 7, 2, 1.2, 0.25, 0.75, 20.5,
                                       1234),
        n_ptrs=8, out_shape=(3, 7),
        argtypes=[ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 4 + [ctypes.c_void_p],
        tpu="kbner_tpu/ops/bm25.py:_d16_rescore_kernel"),
    "bm25_rescore": dict(
        wrapper="bm25_rescore", plain="bm25_rescore_ref",
        check="_check_k3_device", launcher="_k3_launcher",
        symbol="bm25_rescore_launch", operands=_k3_operands,
        extra=K3_SCALARS,
        launch_tail=(3, 4, 7, 5, -2.0, float(np.float32(0.1)), 1234),
        n_ptrs=6, out_shape=(3, 7),
        argtypes=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2 + [ctypes.c_void_p],
        tpu="kbner_tpu/ops/bm25.py:_rescore_kernel"),
}


@pytest.fixture
def plain_forbidden(monkeypatch):
    def plain(*args):
        raise AssertionError("a device tensor reached the plain version")
    for spec in KERNELS.values():
        monkeypatch.setattr(bm25, spec["plain"], plain)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_wrapper_launches_the_kernel_for_device_tensors(plain_forbidden,
                                                        monkeypatch, kernel):
    spec = KERNELS[kernel]
    wrapper = getattr(bm25, spec["wrapper"])
    calls = []

    def launch(*args):
        calls.append(args)
        return 0

    class Stream:
        cuda_stream = 1234

    monkeypatch.setattr(bm25, spec["check"], lambda *ops: None)
    monkeypatch.setattr(bm25, spec["launcher"], lambda: launch)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(wrapper, "launches", 0)
    out = wrapper(*spec["operands"]("meta"), *spec["extra"])
    assert out.device.type == "meta" and tuple(out.shape) == spec["out_shape"]
    assert out.dtype == torch.float32
    assert wrapper.launches == 1
    (args,) = calls
    assert args[spec["n_ptrs"]:] == spec["launch_tail"]

    monkeypatch.setattr(bm25, spec["launcher"], lambda: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        wrapper(*spec["operands"]("meta"), *spec["extra"])
    assert wrapper.launches == 1


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_wrapper_never_hands_other_devices_to_the_plain_version(
        plain_forbidden, kernel):
    spec = KERNELS[kernel]
    wrapper = getattr(bm25, spec["wrapper"])
    ops = spec["operands"]("meta")
    mixed = list(ops)
    mixed[2] = torch.zeros(mixed[2].shape, dtype=mixed[2].dtype)
    for case in (ops, tuple(mixed)):  # not on a CUDA device; mixed
        with pytest.raises(ValueError, match="CUDA device"):
            wrapper(*case, *spec["extra"])


def test_layout_checks():
    qt, qw, dt, di = _k1_operands("meta")
    bm25._check_layout(qt, qw, dt, di)
    bm25._check_layout(qt, qw, dt[:, 2:], di[:, 2:])  # a doc-axis slice
    with pytest.raises(ValueError, match="must be torch.int32"):
        bm25._check_layout(qt.long(), qw, dt, di)
    with pytest.raises(ValueError, match="differ in shape"):
        bm25._check_layout(qt, qw[:, :2], dt, di)
    with pytest.raises(ValueError, match="2-D"):
        bm25._check_layout(qt, qw, dt[None], di[None])
    with pytest.raises(ValueError, match="contiguous"):
        bm25._check_layout(qt.t(), qw.t(), dt, di)
    with pytest.raises(ValueError, match="row-major"):
        bm25._check_layout(qt, qw, dt.t().contiguous().t(),
                           di.t().contiguous().t())


def test_delta16_layout_checks():
    ops = _k2_operands("meta")
    bm25._check_d16_layout(ops, 1)

    def bad(i, x, match, r2=1):
        case = list(ops)
        case[i] = x
        with pytest.raises(ValueError, match=match):
            bm25._check_d16_layout(tuple(case), r2)

    bad(0, ops[0].long(), "must be torch.int32")
    bad(3, ops[3].view(torch.uint16), "must be torch.int16")
    bad(1, ops[1][:, :2].contiguous(), r"\[Q, W\]")
    bad(2, ops[2][:2], r"\[Q, C\]")
    bad(3, torch.zeros(5, 64, dtype=torch.int16, device="meta"), "128")
    bad(4, ops[4][:4], r"\[N\] each")
    bad(2, ops[2].t().contiguous().t(), "contiguous")
    with pytest.raises(ValueError, match="r2"):
        bm25._check_d16_layout(ops, 0)


def test_rescore_layout_checks():
    ops = _k3_operands("meta")
    bm25._check_k3_layout(ops)

    def bad(i, x, match):
        case = list(ops)
        case[i] = x
        with pytest.raises(ValueError, match=match):
            bm25._check_k3_layout(tuple(case))

    bad(0, ops[0].long(), "must be torch.int32")
    bad(4, ops[4].view(torch.uint16), "must be torch.int16")
    bad(1, ops[1][:, :2].contiguous(), r"\[Q, Lq\]")
    bad(2, ops[2][:2], r"\[Q, C\]")
    bad(4, ops[4][:, :3].contiguous(), r"\[N, Ld\] each")
    bad(3, ops[3][None], "2-D")
    bad(2, ops[2].t().contiguous().t(), "contiguous")
    with pytest.raises(ValueError, match="exceed"):
        bm25._check_k3_layout((
            torch.zeros(3, 7000, dtype=torch.int32, device="meta"),
            torch.zeros(3, 7000, device="meta"), *ops[2:]))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launcher_binds_pointers_as_void_p(monkeypatch, kernel):
    """ctypes would pass a plain int as 32 bits and cut a device pointer."""
    spec = KERNELS[kernel]

    class Fn:
        argtypes = None
        restype = None

    lib = type("Lib", (), {spec["symbol"]: Fn()})()
    monkeypatch.setattr(_kernels, "load", lambda name: lib)
    fn = getattr(bm25, spec["launcher"])()
    assert fn.argtypes == spec["argtypes"]
    assert fn.restype is ctypes.c_int


def _cpu_operands(kernel):
    rng = np.random.RandomState(0)
    if kernel == "bm25_score":
        return (torch.from_numpy(rng.randint(0, 5, (2, 3)).astype(np.int32)),
                torch.from_numpy(rng.rand(2, 3).astype(np.float32)),
                torch.from_numpy(rng.randint(-1, 5, (4, 9)).astype(np.int32)),
                torch.from_numpy(rng.rand(4, 9).astype(np.float32))), ()
    if kernel == "bm25_rescore":
        # -1 ids on both sides under random 16-bit codes
        codes = rng.randint(0, 1 << 16, (9, 5)).astype(np.uint16)
        return (torch.from_numpy(rng.randint(-1, 6, (2, 4)).astype(np.int32)),
                torch.from_numpy(rng.rand(2, 4).astype(np.float32)),
                torch.from_numpy(rng.randint(0, 9, (2, 7)).astype(np.int32)),
                torch.from_numpy(rng.randint(-1, 6, (9, 5)).astype(np.int32)),
                torch.from_numpy(codes.view(np.int16))), (-2.0, 1e-4)
    # slots (gap << 3) | tf with small gaps, so ids stay below 400
    flat = ((rng.randint(0, 4, (3, 128)) << 3)
            | rng.randint(0, 8, (3, 128))).astype(np.uint16)
    return (torch.from_numpy(rng.randint(-1, 100, (2, 6)).astype(np.int32)),
            torch.from_numpy(rng.rand(2, 6).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 4, (2, 5)).astype(np.int32)),
            torch.from_numpy(flat.view(np.int16)),
            torch.tensor([0, 40, 128, 250], dtype=torch.int32),
            torch.tensor([40, 88, 100, 6], dtype=torch.int32),
            torch.tensor([3, 17, 40, 255], dtype=torch.uint8)), K2_SCALARS


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_cpu_tensors_take_the_plain_version(kernel):
    spec = KERNELS[kernel]
    wrapper = getattr(bm25, spec["wrapper"])
    ops, extra = _cpu_operands(kernel)
    before = wrapper.launches
    got = wrapper(*ops, *extra)
    assert torch.equal(got, getattr(bm25, spec["plain"])(*ops, *extra))
    assert got.abs().sum() > 0
    assert wrapper.launches == before


# -- building the kernels ----------------------------------------------------------

@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_build_without_nvcc_raises_clearly(tmp_path, monkeypatch, kernel):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _kernels.build(kernel)
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_built_library_is_named_by_source_and_flags(tmp_path, monkeypatch,
                                                    kernel):
    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    path = _kernels.library_path(kernel)
    assert re.fullmatch(rf"lib{kernel}-[0-9a-f]{{16}}\.so", path.name)
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS + ("-G",))
    assert _kernels.library_path(kernel) != path
    monkeypatch.setattr(_kernels, "NVCC_FLAGS", _kernels.NVCC_FLAGS[:-1])
    path.write_bytes(b"")
    assert _kernels.build(kernel) == "(already built)"


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_source_targets_hopper_and_names_its_tpu_kernel(kernel):
    spec = KERNELS[kernel]
    src = (PKG / "csrc" / f"{kernel}.cu").read_text()
    assert spec["tpu"] in src
    assert f'extern "C" int {spec["symbol"]}' in src
    assert "arch=compute_90a,code=sm_90a" in " ".join(_kernels.NVCC_FLAGS)
    assert sorted(p.stem for p in (PKG / "csrc").glob("*.cu")) == sorted(
        KERNELS)
