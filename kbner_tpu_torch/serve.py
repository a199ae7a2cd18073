"""Retrieval-augmented NER serving: one micro-batch of requests through
search -> context fusion -> XLM-R + CRF decode -> spans.

:func:`predict` is the counterpart of ``FinetuneTrainer.predict``
(``kbner_tpu/train/trainer.py``) and :func:`serve` of the per-batch
``flush`` of ``cmd_serve`` (``kbner_tpu/cli.py``), with the same request
and response schema:

  request:  {"id": ..., "tokens": [...]}  or  {"id": ..., "text": "..."}
  response: {"id": ..., "tokens": [...], "tags": [...],
             "spans": [{"start", "end", "label"}]}
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from .data.conll import X_LABEL, SentenceRecord
from .data.dictionary import Dictionary
from .data.encode import EncodedBatch, make_batches
from .data.subword import SubwordTokenizer
from .data.tag_schemes import get_spans
from .models.tagger import SequenceTagger
from .retrieval.engine import RetrievalEngine
from .retrieval.fusion import fuse_contexts
from .utils.spans import span, timed

_X_TAG = "S-" + X_LABEL


def predict(
    records: Sequence[SentenceRecord],
    tagger: SequenceTagger,
    tokenizer: SubwordTokenizer,
    tag_dict: Dictionary,
    batch_size: int = 32,
    tag_layer: str = "ner",
    sort_by_length: bool = True,
    to_device: Optional[Callable[[EncodedBatch], Dict[str, torch.Tensor]]]
    = None,
) -> List[List[str]]:
    """Predicted BIOES tag strings per sentence, in input order.

    Retrieved-context positions (everything from ``<EOS>`` on, and gold
    ``S-X`` tags) are refilled with ``S-X`` after the masked decode; words
    cut off by the 512-subtoken budget get ``O``. ``to_device`` turns an
    encoded batch into the tagger's inputs (by default its arrays, on the
    tagger's device).
    """
    results: List[Optional[List[str]]] = [None] * len(records)
    rec_index = {id(r): i for i, r in enumerate(records)}
    with span("kbner.tag.encode") as s:
        batches = make_batches(records, tokenizer, None, batch_size,
                               sort_by_length=sort_by_length,
                               tag_layer=tag_layer)
        if s:
            for eb in batches:
                s.add("rows", eb.num_sentences)
                s.add("subtokens", eb.attention_mask.sum())
                s.add("slots", eb.attention_mask.size)
    for eb in batches:
        with span("kbner.tag.upload"):
            batch = (to_device(eb) if to_device is not None else
                     {k: torch.from_numpy(v).to(tagger.device)
                      for k, v in eb.arrays().items()})
        tags, _ = tagger.decode(batch)
        with span("kbner.tag.pull"):
            tags = tags.cpu().numpy()
        with span("kbner.tag.render") as s:
            for b, rec in enumerate(eb.records):
                n_words = int(eb.word_mask[b].sum())
                out = [_X_TAG if eb.crf_mask[b, w] == 0
                       else tag_dict.get_item_for_index(int(tags[b, w]))
                       for w in range(n_words)]
                out.extend(["O"] * (len(rec.tokens) - n_words))
                results[rec_index[id(rec)]] = out
                if s:
                    s.add("words", n_words)
    return results


def request_record(req: Dict[str, Any], tag_layer: str = "ner"
                   ) -> SentenceRecord:
    """A request's sentence: its ``tokens``, or its ``text`` split on
    whitespace."""
    tokens = list(req.get("tokens") or req.get("text", "").split())
    return SentenceRecord(tokens=tokens, tags={tag_layer: ["O"] * len(tokens)})


def serve(
    requests: Sequence[Dict[str, Any]],
    engine: Optional[RetrievalEngine],
    tagger: SequenceTagger,
    tokenizer: SubwordTokenizer,
    tag_dict: Dictionary,
    k: int = 10,
    mode: str = "sentence_link",
    batch_size: int = 32,
    tag_layer: str = "ner",
    timings: Optional[Dict[str, float]] = None,
) -> List[Dict[str, Any]]:
    """Responses for one micro-batch of requests, in order.

    With an engine, each sentence is searched with its own tokens and the
    top-``k`` documents are fused after ``<EOS>`` before tagging; context
    tokens never appear in a response. ``timings``, when given, gets the
    wall seconds of each stage added to its ``retrieve``, ``fuse`` and
    ``tag`` keys (each stage ends with its results on the host).
    """
    with span("kbner.serve.batch", requests=len(requests)):
        stage = {"retrieve": 0.0, "fuse": 0.0, "tag": 0.0}
        orig = [request_record(r, tag_layer) for r in requests]
        records = orig
        if engine is not None:
            with timed("kbner.serve.retrieve") as t:
                results = engine.search([" ".join(r.tokens) for r in orig],
                                        k=k)
            stage["retrieve"] = t.seconds
            with timed("kbner.serve.fuse") as t:
                records = fuse_contexts(orig, results, tokenizer, mode=mode)
                if t:
                    t.add("contexts", sum(len(r) for r in results))
            stage["fuse"] = t.seconds
        with timed("kbner.serve.tag") as t:
            preds = predict(records, tagger, tokenizer, tag_dict,
                            batch_size=batch_size, tag_layer=tag_layer)
        stage["tag"] = t.seconds
        if timings is not None:
            for key, sec in stage.items():
                timings[key] = timings.get(key, 0.0) + sec
        with span("kbner.serve.respond"):
            out = []
            for req, rec, tags in zip(requests, orig, preds):
                tags = tags[:len(rec.tokens)]  # context tokens stay internal
                spans = [{"start": s.start, "end": s.end, "label": s.label}
                         for s in get_spans(tags, ignore_labels=(X_LABEL,))]
                out.append({"id": req.get("id"), "tokens": rec.tokens,
                            "tags": tags, "spans": spans})
        return out
