"""Iterative entity retrieval (the v4 round) and multi-stage fine-tuning
(counterpart of ``kbner_tpu/retrieval/iterative.py``).

The recipe's full loops: train on sentence-retrieval contexts, predict the
entities of the raw sentences, query again with title-boosted entity
clauses, fuse the new contexts and train again; and staged fine-tuning, in
which each stage exports its tuned encoder and the next stage (for
example a monolingual one after the multilingual one) starts from it.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from ..data.conll import SentenceRecord
from ..data.corpus_ops import make_orig_view
from .engine import RetrievalEngine
from .fusion import ContextMode, extract_entities, fuse_contexts
from .pipeline import retrieve_for_records


def strip_context(records: Sequence[SentenceRecord],
                  tag_layer: str = "ner") -> List[SentenceRecord]:
    """Copies of possibly context-fused records without their context."""
    return [make_orig_view(r, tag_layer) for r in records]


def entity_retrieval_round(
    engine: RetrievalEngine,
    trainer,  # a FinetuneTrainer whose model predicts the entities
    records: Sequence[SentenceRecord],
    tokenizer,
    k: int = 10,
    lang: str = "en",
    mode: ContextMode = "sentence_link",
    budget: int = 510,
    use_gold_entities: bool = False,
    tag_layer: str = "ner",
    drop_over_budget_train: bool = False,
) -> List[SentenceRecord]:
    """One v4 round: the entities of each sentence (gold with
    ``use_gold_entities``, as on the train split, else the trainer's
    predictions, as on dev and test) as title-boosted clauses beside the
    sentence query, then the new contexts fused into the sentences."""
    base = strip_context(records, tag_layer)
    if use_gold_entities:
        entities = [extract_entities(r, tag_layer) for r in base]
    else:
        preds = trainer.predict(base)
        entities = [extract_entities(
            SentenceRecord(tokens=r.tokens, tags={tag_layer: p},
                           lang_id=r.lang_id), tag_layer)
            for r, p in zip(base, preds)]
    results = retrieve_for_records(
        engine, base, k=k, lang=lang, with_entity=True, entities=entities,
        tag_layer=tag_layer)
    return fuse_contexts(
        base, results, tokenizer, mode=mode, budget=budget,
        drop_over_budget_train=drop_over_budget_train)


def run_multistage(stages: Sequence, build_trainer) -> List[dict]:
    """Staged fine-tuning: ``build_trainer(stage, encoder_init)`` returns
    ``(trainer, train_config, target_dir)`` for each stage in turn, where
    ``encoder_init`` is the previous stage's exported encoder
    (``target_dir/finetuned-encoder.msgpack``) or None; every stage exports
    its encoder. Returns each stage's ``trainer.train`` result. A stage's
    trainer is dropped before the next one is built, so one model and its
    optimizer state are resident at a time."""
    results = []
    encoder_init: Optional[Path] = None
    for stage in stages:
        trainer, train_config, target_dir = build_trainer(stage,
                                                          encoder_init)
        train_config.save_finetuned_encoder = True
        results.append(trainer.train(target_dir, train_config))
        del trainer
        exported = Path(target_dir) / "finetuned-encoder.msgpack"
        if exported.exists():
            encoder_init = exported
    return results
