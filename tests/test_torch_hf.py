"""The port's HF XLM-R checkpoint loader against kbner_tpu's and against
transformers.

A tiny randomly initialized ``XLMRobertaModel`` is written with
``save_pretrained`` (the same directory format as a real
xlm-roberta-large export), as ``pytorch_model.bin`` under ``roberta.``
keys, and as F16 and BF16 safetensors files. The port reads safetensors
itself (it imports neither ``safetensors`` nor ``transformers``); this
test uses both libraries to write the files and to compute the reference.
Tolerances: the loaded tensors bit for bit; the encoder against
kbner_tpu's Flax encoder rtol 1e-5, atol 1e-5 (float32, two frameworks);
against transformers' hidden states atol 2e-4, rtol 1e-3, the JAX test's
(``tests/test_hf_parity.py``).
"""

import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from kbner_tpu.models.xlmr import XLMRConfig as JXLMRConfig  # noqa: E402
from kbner_tpu.models.xlmr import XLMREncoder as JXLMREncoder  # noqa: E402
from kbner_tpu.models.xlmr import \
    load_hf_checkpoint as j_load_hf_checkpoint  # noqa: E402
from kbner_tpu_torch import checkpoint, cli, weights  # noqa: E402
from kbner_tpu_torch.config import ExperimentConfig  # noqa: E402
from kbner_tpu_torch.data.subword import HashTokenizer  # noqa: E402
from kbner_tpu_torch.models.embedders import \
    TransformerWordEmbedder  # noqa: E402
from kbner_tpu_torch.models.xlmr import (XLMRConfig, XLMREncoder,  # noqa: E402
                                         _hf_key_map, load_hf_checkpoint)

FIX = Path(__file__).parent / "fixtures"
HF = dict(vocab_size=251, hidden_size=32, num_hidden_layers=2,
          num_attention_heads=4, intermediate_size=64,
          max_position_embeddings=40, type_vocab_size=1, pad_token_id=1,
          layer_norm_eps=1e-5, hidden_act="gelu",
          hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """``(model, {kind: directory})``: safetensors from save_pretrained,
    a ``.bin`` of ``roberta.``-prefixed keys (with a head weight the
    encoder ignores), and F16 and BF16 safetensors files."""
    torch.manual_seed(0)
    model = transformers.XLMRobertaModel(
        transformers.XLMRobertaConfig(**HF), add_pooling_layer=False).eval()
    root = tmp_path_factory.mktemp("hf_xlmr")
    dirs = {"safetensors": root / "st"}
    model.save_pretrained(dirs["safetensors"])
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for kind in ("bin", "f16", "bf16"):
        dirs[kind] = root / kind
        dirs[kind].mkdir()
        shutil.copy(dirs["safetensors"] / "config.json", dirs[kind])
    torch.save({**{f"roberta.{k}": v for k, v in state.items()},
                "lm_head.bias": torch.zeros(HF["vocab_size"])},
               dirs["bin"] / "pytorch_model.bin")
    for kind, dtype in (("f16", torch.float16), ("bf16", torch.bfloat16)):
        safetensors_torch.save_file(
            {f"roberta.{k}": v.to(dtype) for k, v in state.items()},
            dirs[kind] / "model.safetensors", metadata={"format": "pt"})
    return model, dirs


def _config(d, **kw):
    return XLMRConfig.from_hf_config(d / "config.json", dtype=torch.float32,
                                     hidden_dropout=0.0,
                                     attention_dropout=0.0, **kw)


def _encoder(d):
    enc = XLMREncoder(_config(d)).eval()
    enc.load_state_dict(load_hf_checkpoint(d, device="cpu"), strict=True)
    return enc


def _ids():
    rng = np.random.RandomState(0)
    ids = rng.randint(4, 250, size=(2, 12)).astype(np.int64)
    mask = np.ones((2, 12), dtype=np.int64)
    mask[1, 9:] = 0
    ids[1, 9:] = 1  # the pad token
    return ids, mask


@pytest.mark.parametrize("kind", ["safetensors", "bin"])
def test_loaded_state_equals_the_jax_loader_bit_for_bit(hf_dirs, kind):
    """The state dict equals the JAX loader's tree carried over by
    ``weights.member_from_jax_params``, every tensor bit for bit, and
    covers the encoder exactly."""
    _, dirs = hf_dirs
    d = dirs[kind]
    got = load_hf_checkpoint(d, device="cpu")
    jcfg = JXLMRConfig.from_hf_config(d / "config.json")
    tree = j_load_hf_checkpoint(d, jcfg)
    want = weights.member_from_jax_params(
        {"encoder": jax.tree_util.tree_map(np.asarray, tree["params"])},
        TransformerWordEmbedder(_config(d, param_dtype=torch.float32)))
    assert {f"encoder.{k}" for k in got} == set(want)
    assert set(got) == set(XLMREncoder(_config(d)).state_dict())
    for k, t in got.items():
        assert t.dtype == torch.float32 and t.device.type == "cpu", k
        assert torch.equal(t, want[f"encoder.{k}"]), k


@pytest.mark.parametrize("kind", ["safetensors", "bin"])
def test_encoder_matches_flax_and_transformers(hf_dirs, kind):
    model, dirs = hf_dirs
    d = dirs[kind]
    ids, mask = _ids()
    with torch.no_grad():
        got = _encoder(d)(torch.from_numpy(ids), torch.from_numpy(mask))
        want = model(input_ids=torch.from_numpy(ids),
                     attention_mask=torch.from_numpy(mask)
                     ).last_hidden_state.numpy()
    jcfg = JXLMRConfig.from_hf_config(d / "config.json", dtype=jnp.float32,
                                      hidden_dropout=0.0,
                                      attention_dropout=0.0)
    flax_out, _ = JXLMREncoder(jcfg).apply(
        j_load_hf_checkpoint(d, jcfg), jnp.asarray(ids.astype(np.int32)),
        jnp.asarray(mask.astype(np.int32)))
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(flax_out), rtol=1e-5,
                               atol=1e-5)
    # real (unpadded) positions against transformers
    np.testing.assert_allclose(got[0], want[0], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(got[1, :9], want[1, :9], atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("kind,dtype", [("f16", torch.float16),
                                        ("bf16", torch.bfloat16)])
def test_half_precision_safetensors(hf_dirs, kind, dtype):
    """F16 and BF16 files read bit for bit: in their own dtype, and in
    float32 as the exact widening of those values."""
    _, dirs = hf_dirs
    d = dirs[kind]
    src = {k[len("roberta."):]: v for k, v in safetensors_torch.load_file(
        d / "model.safetensors").items()}
    names = _hf_key_map(HF["num_hidden_layers"])
    for out_dtype in (dtype, torch.float32):
        got = load_hf_checkpoint(d, dtype=out_dtype, device="cpu")
        for hf_key, ours in names.items():
            assert got[ours].dtype == out_dtype
            assert torch.equal(got[ours], src[hf_key].to(out_dtype)), ours


def test_missing_weight_and_missing_file_raise(hf_dirs, tmp_path):
    _, dirs = hf_dirs
    broken = tmp_path / "broken"
    shutil.copytree(dirs["safetensors"], broken)
    state = safetensors_torch.load_file(broken / "model.safetensors")
    state.pop("embeddings.word_embeddings.weight")
    safetensors_torch.save_file(state, broken / "model.safetensors")
    with pytest.raises(KeyError, match="embeddings.word_embeddings.weight"):
        load_hf_checkpoint(broken, device="cpu")
    (broken / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        load_hf_checkpoint(broken, device="cpu")


def test_from_hf_config_fields_and_overrides(hf_dirs):
    _, dirs = hf_dirs
    path = dirs["safetensors"] / "config.json"
    got = XLMRConfig.from_hf_config(path)
    want = JXLMRConfig.from_hf_config(path)
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "intermediate_size", "max_position_embeddings",
                  "type_vocab_size", "pad_token_id", "layer_norm_eps",
                  "hidden_dropout", "attention_dropout", "remat"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.bfloat16
    over = XLMRConfig.from_hf_config(path, vocab_size=128, remat=True,
                                     param_dtype=torch.float32)
    assert (over.vocab_size, over.remat, over.param_dtype,
            over.hidden_size) == (128, True, torch.float32, 32)
    # a checkpoint directory as model.encoder keeps its own vocabulary
    cfg = ExperimentConfig.from_dict({
        "name": "x", "tokenizer": {"type": "hash", "vocab_size": 97},
        "model": {"encoder": str(dirs["safetensors"]), "remat": True},
        "corpora": []})
    enc = cfg.make_train_encoder_config(HashTokenizer(97))
    assert (enc.vocab_size, enc.hidden_size, enc.remat, enc.param_dtype) \
        == (251, 32, True, torch.float32)


def _train_config(tmp_path, encoder, weights_dir, **train):
    raw = yaml.safe_load((FIX / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(FIX / "ner_toy")
    raw["tokenizer"]["vocab_size"] = 128
    raw["model"].update(encoder=str(encoder),
                        encoder_weights=str(weights_dir))
    raw["train"].update(max_epochs=1, save_finetuned_encoder=True, **train)
    raw["target_dir"] = str(tmp_path / "run")
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p, Path(raw["target_dir"])


def test_cli_train_loads_encoder_weights(hf_dirs, tmp_path):
    """``cli train`` with ``model.encoder_weights`` starts from the
    checkpoint: at step 0 the exported encoder equals it bit for bit."""
    _, dirs = hf_dirs
    d = dirs["safetensors"]
    p, run = _train_config(tmp_path, d, d, learning_rate=0.0, lr_rate=0.0)
    cli.main(["train", "--config", str(p), "--device", "cpu"])
    exported = checkpoint.load(run / "finetuned-encoder.msgpack")
    want = load_hf_checkpoint(d, device="cpu")
    got = weights.member_from_jax_params(
        {"encoder": exported}, TransformerWordEmbedder(
            _config(d, param_dtype=torch.float32)))
    for k, t in want.items():
        assert torch.equal(got[f"encoder.{k}"], t), k
    assert json.loads((run / "test_results.json").read_text())


def test_encoder_weights_of_another_shape_raise(hf_dirs, tmp_path):
    """A checkpoint narrower than ``model.encoder`` raises, naming the
    first weight that differs."""
    _, dirs = hf_dirs
    p, _ = _train_config(tmp_path, "tiny", dirs["safetensors"])
    with pytest.raises(ValueError, match="word_embeddings.weight"):
        cli._build(ExperimentConfig.from_file(p), "cpu")
