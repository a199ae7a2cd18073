"""Deterministic learnable fixture corpus: the trained-quality gate
(counterpart of ``kbner_tpu/data/quality_fixture.py``, the NER part).

Every entity surface form belongs to exactly one type (person, location
and organization vocabularies are disjoint), sentences are filled from
templates, and train/test draw from the same closed vocabulary in
different combinations. Span F1 on the held-out split measures whether
training learned the token->type mapping and the BIOES transitions; a
correct trainer reaches near-perfect F1 in a few CPU minutes.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .conll import Corpus, ListCorpus, SentenceRecord
from .tag_schemes import to_bioes

_PER = [f"Person{i}" for i in range(30)]
_LOC = [f"Cityville{i}" for i in range(30)]
_ORG = [f"Acmecorp{i}" for i in range(30)]

# (template tokens, BIO tags); {P}/{L}/{O} expand to 1-2 token entities
_TEMPLATES: List[Tuple[List[str], List[str]]] = [
    (["{P}", "visited", "{L}", "yesterday", "."],
     ["PER", "O", "LOC", "O", "O"]),
    (["{O}", "hired", "{P}", "in", "{L}", "."],
     ["ORG", "O", "PER", "O", "LOC", "O"]),
    (["the", "office", "of", "{O}", "is", "in", "{L}", "."],
     ["O", "O", "O", "ORG", "O", "O", "LOC", "O"]),
    (["{P}", "and", "{P}", "met", "at", "{O}", "."],
     ["PER", "O", "PER", "O", "O", "ORG", "O"]),
    (["reports", "from", "{L}", "mention", "{P}", "."],
     ["O", "O", "LOC", "O", "PER", "O"]),
    (["{O}", "opened", "a", "plant", "near", "{L}", "."],
     ["ORG", "O", "O", "O", "O", "LOC", "O"]),
]


def _expand(rng: np.random.RandomState, slot: str) -> Tuple[List[str], str]:
    vocab, label = {"{P}": (_PER, "PER"), "{L}": (_LOC, "LOC"),
                    "{O}": (_ORG, "ORG")}[slot]
    # 1- or 2-token entity mentions exercise B-/I- (and BIOES S-/E-) tags
    n = 1 + int(rng.rand() < 0.4)
    return [vocab[rng.randint(len(vocab))] for _ in range(n)], label


def make_quality_corpus(
    n_train: int = 240,
    n_dev: int = 48,
    n_test: int = 96,
    seed: int = 0,
) -> ListCorpus:
    """Pattern corpus with disjoint splits (by sampled content, not by
    entity vocabulary: test entities are seen words in new contexts)."""
    rng = np.random.RandomState(seed)

    def gen(n: int) -> List[SentenceRecord]:
        records = []
        for _ in range(n):
            toks, tags = _TEMPLATES[rng.randint(len(_TEMPLATES))]
            out_toks: List[str] = []
            out_bio: List[str] = []
            for tok, tag in zip(toks, tags):
                if tok in ("{P}", "{L}", "{O}"):
                    ent, label = _expand(rng, tok)
                    out_toks.extend(ent)
                    out_bio.append(f"B-{label}")
                    out_bio.extend(f"I-{label}" for _ in ent[1:])
                else:
                    out_toks.append(tok)
                    out_bio.append("O")
            records.append(SentenceRecord(
                tokens=out_toks, tags={"ner": to_bioes(out_bio)}))
        return records

    return ListCorpus([Corpus(train=gen(n_train), dev=gen(n_dev),
                              test=gen(n_test), name="QUALITY")])


def run_quality_gate(
    max_epochs: int = 30,
    batch_size: int = 16,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device="cuda",
) -> float:
    """Train the tiny float32 tagger on the pattern corpus on ``device``;
    return held-out span F1. A healthy trainer reaches >= 0.95."""
    import tempfile

    from ..models.tagger import SequenceTagger, TaggerConfig
    from ..models.xlmr import XLMRConfig
    from ..train import FinetuneTrainer, TrainConfig
    from .subword import HashTokenizer

    corpus = make_quality_corpus(seed=seed)
    tokenizer = HashTokenizer(vocab_size=4099)
    tag_dict = corpus.make_tag_dictionary("ner")
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=4099), tag_dict,
        locked_dropout=0.0, word_dropout=0.0)
    model = SequenceTagger(cfg, device=device, seed=seed)
    trainer = FinetuneTrainer(model, corpus, tokenizer, tag_dict,
                              device=device)
    with tempfile.TemporaryDirectory() as tmp:
        trainer.train(tmp, TrainConfig(
            learning_rate=learning_rate, lr_rate=1.0,
            batch_size=batch_size, max_epochs=max_epochs, seed=seed))
        metric, _ = trainer.evaluate(corpus.test_list[0])
    return metric.micro_avg_f_score()
