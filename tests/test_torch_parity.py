"""The port's ``cli parity`` (stage 1 multilingual -> encoder export ->
stage 2 EN -> test predictions -> conlleval), case by case as the JAX
package's own parity tests hold its CLI's: it runs end to end
on the fixture corpus with the JAX CLI's summary keys, skips with a
message without data or weights, and really starts from the checkpoint's
weights (with lr 0 the stage-1 export equals them bit for bit). Each run
is on the CPU (``--device cpu``) at the tiny width.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from kbner_tpu.cli import main as j_main
from kbner_tpu_torch import checkpoint
from kbner_tpu_torch.cli import _sniff_column_format, main

FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def parity_data(tmp_path):
    root = tmp_path / "data"
    shutil.copytree(FIX / "ner_toy", root / "stage1")
    shutil.copytree(FIX / "ner_toy", root / "stage2")
    return root


def _stage_args(data, out, *extra):
    return ["parity", "--data", str(data), "--stage1_folder", "stage1",
            "--stage2_folder", "stage2", "--out", str(out), *extra]


def _keys(tree):
    """The nested key structure of a summary (leaf values dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_parity_runs_end_to_end(parity_data, tmp_path, capsys):
    out = tmp_path / "out"
    summary = main(_stage_args(
        parity_data, out, "--epochs_stage1", "2", "--epochs_stage2", "6",
        "--lr", "2e-3", "--lr_rate", "10", "--batch_size", "8",
        "--device", "cpu"))
    assert json.loads((out / "parity.json").read_text()) == summary
    assert summary["parity"] == "ran"
    # the stage hand-off really happened
    assert (out / "stage1" / "finetuned-encoder.msgpack").exists()
    assert (out / "stage2" / "best-model.msgpack").exists()
    tsv = out / "stage2" / "test.parity-stage2-en.tsv"
    assert tsv.exists() and tsv.stat().st_size > 0
    assert isinstance(summary["conlleval_micro_f1"], float)
    assert summary["conlleval_micro_f1"] >= 0.0
    printed = capsys.readouterr().out
    assert json.loads(printed[printed.index("{"):]) == summary

    # the JAX CLI's summary has the same keys, nested
    j_out = tmp_path / "j_out"
    j_main(_stage_args(parity_data, j_out, "--epochs_stage1", "1",
                       "--epochs_stage2", "1", "--lr", "2e-3",
                       "--lr_rate", "10", "--batch_size", "8"))
    assert _keys(summary) == _keys(
        json.loads((j_out / "parity.json").read_text()))


def test_parity_skips_without_data(tmp_path, capsys):
    assert main(["parity", "--data", str(tmp_path / "nope"),
                 "--out", str(tmp_path / "out")]) is None
    out = capsys.readouterr().out
    assert "SKIP" in out and "stage-1 multilingual" in out
    assert json.loads(out.strip().splitlines()[-1])["parity"] == "skipped"


def test_parity_skips_without_weights(parity_data, tmp_path, capsys):
    main(_stage_args(parity_data, tmp_path / "out", "--weights",
                     str(tmp_path / "no-such-ckpt")))
    out = capsys.readouterr().out
    assert "SKIP" in out and "config.json" in out


def test_parity_refuses_tokenizer_files_without_hash_tokenizer(
        parity_data, tmp_path):
    """A checkpoint directory whose only tokenizer file is
    ``sentencepiece.bpe.model`` raises before any stage runs, naming
    ``tokenizer.json``: the port reads that file only."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text("{}")
    (ckpt / "sentencepiece.bpe.model").write_bytes(b"\0" * 16)
    out = tmp_path / "out"
    with pytest.raises(FileNotFoundError, match="tokenizer.json"):
        main(_stage_args(parity_data, out, "--weights", str(ckpt),
                         "--device", "cpu"))
    assert not (out / "stage1").exists()


def _tiny_checkpoint(path, vocab_size=251):
    """A tiny XLM-R checkpoint written by transformers."""
    transformers = pytest.importorskip("transformers")
    cfg = transformers.XLMRobertaConfig(
        vocab_size=vocab_size, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=64,
        max_position_embeddings=64, type_vocab_size=1, pad_token_id=1,
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)
    hf = transformers.XLMRobertaModel(cfg, add_pooling_layer=False)
    hf.save_pretrained(path)
    return hf


def test_parity_with_the_checkpoint_tokenizer_matches_jax(
        parity_data, tmp_path, monkeypatch):
    """``--weights DIR`` with ``tokenizer.json`` in DIR runs both stages
    with the checkpoint's own tokenizer in both packages: the summaries
    have the same keys, and the port's tokenizer was the HF one, which
    encoded the corpus (the numbers differ: each package draws its head
    from its own random generator)."""
    from kbner_tpu_torch.data import subword
    from kbner_tpu_torch.data.synth_tokenizer import \
        write_xlmr_like_tokenizer

    ckpt = tmp_path / "ckpt"
    _tiny_checkpoint(ckpt)
    write_xlmr_like_tokenizer(ckpt, n_pieces=246, seed=0)   # 251 ids
    words = []
    encode = subword.HFTokenizer.encode_word
    monkeypatch.setattr(subword.HFTokenizer, "encode_word",
                        lambda self, w: words.append(w) or encode(self, w))
    args = ["--weights", str(ckpt), "--epochs_stage1", "1",
            "--epochs_stage2", "1", "--lr", "0.0", "--lr_rate", "0.0",
            "--batch_size", "8"]
    summary = main(_stage_args(parity_data, tmp_path / "out", *args,
                               "--device", "cpu"))
    j_main(_stage_args(parity_data, tmp_path / "j_out", *args))
    j_summary = json.loads((tmp_path / "j_out" / "parity.json").read_text())
    assert summary["parity"] == j_summary["parity"] == "ran"
    assert _keys(summary) == _keys(j_summary)
    assert "Berlin" in words
    exported = checkpoint.load(
        tmp_path / "out" / "stage1" / "finetuned-encoder.msgpack")
    assert np.asarray(exported["word_embeddings"]["embedding"]).shape == (
        251, 32)


def test_parity_weights_actually_loaded(parity_data, tmp_path):
    """``--weights`` initializes the encoder from the checkpoint: with lr 0
    the exported stage-1 encoder equals the checkpoint's weights bit for
    bit. ``--hash_tokenizer`` is the rehearsal mode (no sentencepiece
    files needed)."""
    ckpt = tmp_path / "ckpt"
    hf = _tiny_checkpoint(ckpt)

    out = tmp_path / "out"
    summary = main(_stage_args(
        parity_data, out, "--weights", str(ckpt), "--hash_tokenizer",
        "--hash_vocab", "128", "--epochs_stage1", "1", "--epochs_stage2",
        "1", "--lr", "0.0", "--lr_rate", "0.0", "--batch_size", "8",
        "--device", "cpu"))
    assert summary["parity"] == "ran"
    exported = checkpoint.load(out / "stage1" / "finetuned-encoder.msgpack")
    want = hf.embeddings.word_embeddings.weight.detach().numpy()
    got = np.asarray(exported["word_embeddings"]["embedding"],
                     dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    kernel = np.asarray(exported["layer_1"]["intermediate"]["kernel"])
    np.testing.assert_array_equal(
        kernel, hf.encoder.layer[1].intermediate.dense.weight.detach()
        .numpy().T)


def test_sniff_column_format(tmp_path):
    for line, want in (("EU B-ORG", {0: "text", 1: "ner"}),
                       ("EU NNP PROPN B-ORG",
                        {0: "text", 1: "pos", 2: "upos", 3: "ner"}),
                       ("EU x B-ORG", {0: "text", 1: "c1", 2: "ner"})):
        f = tmp_path / "train.txt"
        f.write_text(f"# id 1\n\n{line}\n")
        assert _sniff_column_format(f) == want
    f.write_text("# id 1\n\n")
    with pytest.raises(ValueError, match="no data lines"):
        _sniff_column_format(f)
