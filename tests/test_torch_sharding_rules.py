"""``kbner_tpu_torch.parallel.sharding_rules.param_placements`` against
``kbner_tpu.parallel.sharding_rules.tagger_param_shardings`` leaf by leaf,
without a world: XLM-R tiny and XLM-R large at vocabulary 250,002 (the
port's built on the meta device, the reference's through
``jax.eval_shape``), and an ACE stack with an XLM-R member, on (data,
model) meshes (8, 1), (4, 2), (2, 2) and (1, 2) of conftest's CPU devices,
with FSDP on and off. A Flax Dense kernel is ``[in, out]`` and an
``nn.Linear`` weight ``[out, in]``: the port's placement of such a leaf is
the reference's spec with its dims swapped, and its shape the reversed
one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import embedders as jemb
from kbner_tpu.models import init_tagger
from kbner_tpu.models.tagger import init_stacked_tagger
from kbner_tpu.parallel import make_mesh as j_make_mesh
from kbner_tpu.parallel.sharding_rules import tagger_param_shardings
from kbner_tpu_torch import weights
from kbner_tpu_torch.models import embedders as emb
from kbner_tpu_torch.models.tagger import (SequenceTagger,
                                           StackedSequenceTagger,
                                           TaggerConfig)
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.parallel import param_placements

MESHES = ((8, 1), (4, 2), (2, 2), (1, 2))
NUM_TAGS = 19


def _example(vocab, B=2, S=8, W=4):
    rng = np.random.RandomState(0)
    return {"input_ids": rng.randint(0, vocab, (B, S)).astype(np.int32),
            "attention_mask": np.ones((B, S), np.int32),
            "word_starts": np.tile(np.arange(W, dtype=np.int32), (B, 1)),
            "word_mask": np.ones((B, W), np.int32),
            "crf_mask": np.ones((B, W), np.int32),
            "tag_ids": np.zeros((B, W), np.int32),
            "lang_ids": np.zeros((B,), np.int32),
            "word_ids": np.zeros((B, W), np.int32)}


def _configs(j_enc, enc):
    kw = dict(num_tags=NUM_TAGS, start_idx=NUM_TAGS - 2,
              stop_idx=NUM_TAGS - 1)
    return JTaggerConfig(encoder=j_enc, **kw), TaggerConfig(encoder=enc,
                                                            **kw)


def _plain(size):
    if size == "tiny":
        j_enc, enc = JXLMRConfig.tiny(vocab_size=1000), XLMRConfig.tiny(
            vocab_size=1000)
    else:
        j_enc = JXLMRConfig.large(vocab_size=250002)
        enc = XLMRConfig.large(vocab_size=250002)
    jcfg, cfg = _configs(j_enc, enc)
    example = {k: jnp.asarray(v) for k, v in _example(
        j_enc.vocab_size).items()}
    shapes = jax.eval_shape(
        lambda r: init_tagger(jcfg, r, example)[1], jax.random.PRNGKey(0))
    return shapes, SequenceTagger(cfg, device="meta")


def _stacked():
    j_enc, enc = JXLMRConfig.tiny(vocab_size=1000), XLMRConfig.tiny(
        vocab_size=1000)
    jcfg, cfg = _configs(j_enc, enc)
    jspecs = [jemb.EmbedderSpec("x", jemb.TransformerWordEmbedder(j_enc), 64),
              jemb.EmbedderSpec("w", jemb.WordEmbedder(50, 6), 6)]
    specs = [emb.EmbedderSpec("x", emb.TransformerWordEmbedder(enc), 64),
             emb.EmbedderSpec("w", emb.WordEmbedder(50, 6), 6)]
    example = {k: jnp.asarray(v) for k, v in _example(1000).items()}
    shapes = jax.eval_shape(
        lambda r: init_stacked_tagger(jcfg, jspecs, r, example)[1],
        jax.random.PRNGKey(0))
    return shapes, StackedSequenceTagger(cfg, specs, device="cpu")


MODELS = {"tiny": lambda: _plain("tiny"), "large": lambda: _plain("large"),
          "stack": _stacked}


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request):
    return request.param, MODELS[request.param]()


def _leaf(tree, keys):
    for k in keys:
        tree = tree[k]
    return tree


def _flax_names(model):
    """``torch name -> (flax path keys, kernel swapped)`` from the port's
    carry-over tables, the transitions as they are."""
    out = {}
    for path, prefix, kind in weights._pairs(model):
        for src, dst in weights._LEAVES[kind]:
            out[f"{prefix}.{dst}"] = (("params",) + path + (src,),
                                      kind == "dense" and src == "kernel")
    for name in weights._crf_leaves(model):
        out[name] = (("params", name), False)
    return out


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("data,model", MESHES)
def test_placements_equal_the_reference_specs(model_pair, data, model,
                                              fsdp):
    name, (shapes, port) = model_pair
    mesh = j_make_mesh(data=data, model=model,
                       devices=jax.devices()[:data * model])
    specs = tagger_param_shardings(shapes, mesh, fsdp=fsdp)
    got = param_placements(port, {"data": data, "model": model}, fsdp=fsdp)
    names = _flax_names(port)
    assert set(got) == {n for n, _ in port.named_parameters()} == set(names)
    n_fallback = n_sharded = 0
    for torch_name, (keys, swap) in names.items():
        leaf = _leaf(shapes, keys)
        spec = tuple(_leaf(specs, keys).spec)
        spec = spec + (None,) * (leaf.ndim - len(spec))
        shape = tuple(dict(port.named_parameters())[torch_name].shape)
        assert shape == (leaf.shape[::-1] if swap else leaf.shape), \
            torch_name
        want = spec[::-1] if swap else spec
        assert got[torch_name] == want, (torch_name, got[torch_name], want)
        n_sharded += any(a is not None for a in want)
        if fsdp and "data" not in want and any(
                a is not None for a in want) and leaf.ndim == 2:
            n_fallback += 1
    assert n_sharded > 0
    if fsdp and data > 1 and name == "large":
        # token_type_embeddings [1, H] never divides; 250,002 vocabulary
        # rows divide over 2 only; 514 positions over 2 only
        fell = {n for n, p in got.items() if p[0] is None and
                n.startswith("encoder.") and n.endswith("embeddings.weight")}
        want = {"encoder.token_type_embeddings.weight"} | (
            {"encoder.word_embeddings.weight",
             "encoder.position_embeddings.weight"} if data > 2 else set())
        assert fell == want
    if fsdp and data > 1:
        assert n_fallback > 0  # the divisibility fallback applied


def test_stack_member_encoder_is_sharded_and_the_rest_replicated():
    """The stack's XLM-R member matches by its ``encoder`` path; the word
    table, ``embedding2nn``, the emission head and the transitions stay
    replicated."""
    _, port = _stacked()
    got = param_placements(port, {"data": 2, "model": 2}, fsdp=True)
    assert got["stack.members.0.encoder.layers.0.attention.query.weight"] \
        == ("model", "data")
    assert got["stack.members.0.encoder.layers.1.output.weight"] == (
        "data", "model")
    for name in ("stack.members.1.table.weight", "embedding2nn.weight",
                 "emission.weight", "transitions"):
        assert set(got[name]) == {None}, name
