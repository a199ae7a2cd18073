"""Seeded weights of the XLM-R + CRF tagger, made on the device in one
draw and handed alike to the program and to the reference.

The layout (names and shapes) is the configuration's: the encoder's
embeddings, its ``num_hidden_layers`` post-LayerNorm layers, a float32
emission head over the tag set and the CRF's ``[K, K]`` transitions. All
values come from one ``torch.randn`` call on a generator seeded with the
run's seed; each leaf takes its slice, scaled: weight matrices by one over
the square root of their input width, embedding tables by one over the
square root of the hidden width, biases and LayerNorm offsets by 0.02,
LayerNorm scales 1 + 0.02 z, transitions z.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def layout(model: dict, n_tags: int) -> List[Tuple[str, Tuple[int, ...]]]:
    H, F = model["hidden_size"], model["intermediate_size"]
    e = "encoder."
    out = [(e + "word_embeddings.weight", (model["vocab_size"], H)),
           (e + "position_embeddings.weight",
            (model["max_position_embeddings"], H)),
           (e + "token_type_embeddings.weight",
            (model["type_vocab_size"], H)),
           (e + "embeddings_ln.weight", (H,)),
           (e + "embeddings_ln.bias", (H,))]
    for i in range(model["num_hidden_layers"]):
        L = f"{e}layers.{i}."
        for name in ("query", "key", "value", "out"):
            out += [(f"{L}attention.{name}.weight", (H, H)),
                    (f"{L}attention.{name}.bias", (H,))]
        out += [(L + "attention_ln.weight", (H,)),
                (L + "attention_ln.bias", (H,)),
                (L + "intermediate.weight", (F, H)),
                (L + "intermediate.bias", (F,)),
                (L + "output.weight", (H, F)), (L + "output.bias", (H,)),
                (L + "output_ln.weight", (H,)), (L + "output_ln.bias", (H,))]
    out += [("emission.weight", (n_tags, H)), ("emission.bias", (n_tags,)),
            ("transitions", (n_tags, n_tags))]
    return out


def make(model: dict, n_tags: int, seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """``{name: float32 tensor}`` on ``device``, views of one draw."""
    shapes = layout(model, n_tags)
    total = sum(torch.Size(s).numel() for _, s in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    H = model["hidden_size"]
    out, pos = {}, 0
    for name, shape in shapes:
        n = torch.Size(shape).numel()
        z = flat[pos:pos + n].view(shape)
        pos += n
        if name == "transitions":
            pass
        elif name.endswith("embeddings.weight"):
            z.mul_(H ** -0.5)
        elif name.endswith("_ln.weight"):
            z.mul_(0.02).add_(1.0)
        elif len(shape) == 2:
            z.mul_(shape[1] ** -0.5)
        else:
            z.mul_(0.02)
        out[name] = z
    return out


def non_embedding_params(model: dict, n_tags: int) -> int:
    """Parameters outside the embedding tables (the FLOP count's N)."""
    return sum(torch.Size(s).numel() for name, s in layout(model, n_tags)
               if "embeddings." not in name)
