"""Deterministic learnable fixture corpora: the trained-quality gates of
the tagger, the biaffine parser and the text classifier (counterpart of
``kbner_tpu/data/quality_fixture.py``; each corpus equals the reference's
record for record at the same seed).

Every entity surface form belongs to exactly one type (person, location
and organization vocabularies are disjoint), sentences are filled from
templates, and train/test draw from the same closed vocabulary in
different combinations. Span F1 on the held-out split measures whether
training learned the token->type mapping and the BIOES transitions; a
correct trainer reaches near-perfect F1 in a few CPU minutes. The parser
and classifier corpora are built the same way: heads and relations are a
function of the word-class sequence, and each document's topic of the
one topic vocabulary it draws from.
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


# -- parser-family gate ---------------------------------------------------------

_P_NOUNS = [f"noun{i}" for i in range(25)]
_P_VERBS = [f"verb{i}" for i in range(15)]
_P_ADJS = [f"adj{i}" for i in range(15)]
_P_DETS = ["the", "a", "this", "every"]
_P_PREPS = ["in", "near", "under"]

# (role sequence, 1-based head per position, deprel per position): the
# attachment structure is a function of the word-class sequence, so UAS
# on held-out sentences measures whether the parser learned class
# structure, not sentence memorization
_P_TEMPLATES = [
    (["DET", "NOUN", "VERB", "DET", "NOUN"],
     [2, 3, 0, 5, 3],
     ["det", "nsubj", "root", "det", "obj"]),
    (["NOUN", "VERB", "DET", "NOUN"],
     [2, 0, 4, 2],
     ["nsubj", "root", "det", "obj"]),
    (["DET", "ADJ", "NOUN", "VERB"],
     [3, 3, 4, 0],
     ["det", "amod", "nsubj", "root"]),
    (["DET", "NOUN", "VERB", "PREP", "DET", "NOUN"],
     [2, 3, 0, 6, 6, 3],
     ["det", "nsubj", "root", "case", "det", "obl"]),
    (["NOUN", "VERB", "ADJ", "NOUN"],
     [2, 0, 4, 2],
     ["nsubj", "root", "amod", "obj"]),
]

_P_VOCABS = {"NOUN": _P_NOUNS, "VERB": _P_VERBS, "ADJ": _P_ADJS,
             "DET": _P_DETS, "PREP": _P_PREPS}


def make_parser_quality_corpus(
    n_train: int = 240,
    n_dev: int = 48,
    n_test: int = 96,
    seed: int = 0,
) -> ListCorpus:
    """Learnable pattern treebank: heads and deprels are determined by
    the word-class sequence; word classes have disjoint vocabularies."""
    rng = np.random.RandomState(seed)

    def gen(n: int) -> List[SentenceRecord]:
        records = []
        for _ in range(n):
            roles, heads, rels = _P_TEMPLATES[rng.randint(len(_P_TEMPLATES))]
            toks = [_P_VOCABS[r][rng.randint(len(_P_VOCABS[r]))]
                    for r in roles]
            records.append(SentenceRecord(
                tokens=toks,
                tags={"head": [str(h) for h in heads],
                      "deprel": list(rels)}))
        return records

    return ListCorpus([Corpus(train=gen(n_train), dev=gen(n_dev),
                              test=gen(n_test), name="QUALITY-DEP")])


def run_parser_quality_gate(
    max_epochs: int = 30,
    batch_size: int = 16,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device="cuda",
) -> float:
    """Train the tiny float32 biaffine parser on the pattern treebank on
    ``device``; return held-out UAS. A healthy parser trainer reaches >=
    0.9."""
    import tempfile

    from ..models.biaffine import BiaffineConfig, BiaffineParser
    from ..models.xlmr import XLMRConfig
    from ..train import TrainConfig
    from ..train.parser_trainer import ParserTrainer, build_rel_dictionary
    from .subword import HashTokenizer

    corpus = make_parser_quality_corpus(seed=seed)
    tokenizer = HashTokenizer(vocab_size=4099)
    rel_dict = build_rel_dictionary(corpus.train)
    model = BiaffineParser(BiaffineConfig(
        encoder=XLMRConfig.tiny(vocab_size=4099),
        num_rels=max(len(rel_dict), 1), arc_dim=32, rel_dim=16,
        dropout=0.0), device=device, seed=seed)
    trainer = ParserTrainer(model, corpus, tokenizer, rel_dict,
                            device=device)
    with tempfile.TemporaryDirectory() as tmp:
        trainer.train(tmp, TrainConfig(
            learning_rate=learning_rate, lr_rate=1.0,
            batch_size=batch_size, max_epochs=max_epochs, seed=seed))
        scores = trainer.evaluate(corpus.test_list[0])
    return scores["uas"]


# -- classification-family gate -------------------------------------------------

_C_TOPICS = {
    "sports": [f"sportword{i}" for i in range(20)],
    "finance": [f"finword{i}" for i in range(20)],
    "science": [f"sciword{i}" for i in range(20)],
}
_C_FILLER = [f"filler{i}" for i in range(30)]


def make_classifier_quality_corpus(
    n_train: int = 180,
    n_dev: int = 36,
    n_test: int = 72,
    seed: int = 0,
) -> ListCorpus:
    """Learnable text-classification corpus: each document mixes filler
    with words from exactly one topic's disjoint vocabulary."""
    rng = np.random.RandomState(seed)
    topics = sorted(_C_TOPICS)

    def gen(n: int) -> List[SentenceRecord]:
        records = []
        for _ in range(n):
            topic = topics[rng.randint(len(topics))]
            vocab = _C_TOPICS[topic]
            toks = []
            for _ in range(6 + rng.randint(6)):
                src = vocab if rng.rand() < 0.5 else _C_FILLER
                toks.append(src[rng.randint(len(src))])
            if not any(t in vocab for t in toks):
                toks[0] = vocab[rng.randint(len(vocab))]
            records.append(SentenceRecord(tokens=toks, labels=[topic]))
        return records

    return ListCorpus([Corpus(train=gen(n_train), dev=gen(n_dev),
                              test=gen(n_test), name="QUALITY-CLF")])


def run_classifier_quality_gate(
    max_epochs: int = 20,
    batch_size: int = 16,
    learning_rate: float = 1e-3,
    seed: int = 0,
    device="cuda",
) -> float:
    """Train the tiny float32 CLS-pooled classifier on the topic corpus on
    ``device``; return held-out accuracy. A healthy classification
    trainer reaches >= 0.95."""
    import tempfile

    from ..models.classifier import (TextClassifier, TextClassifierConfig,
                                     build_label_dictionary)
    from ..models.xlmr import XLMRConfig
    from ..train import TrainConfig
    from ..train.parser_trainer import ClassificationTrainer
    from .subword import HashTokenizer

    corpus = make_classifier_quality_corpus(seed=seed)
    tokenizer = HashTokenizer(vocab_size=4099)
    label_dict = build_label_dictionary(corpus.train)
    model = TextClassifier(TextClassifierConfig(
        encoder=XLMRConfig.tiny(vocab_size=4099),
        num_labels=max(len(label_dict), 2), dropout=0.0),
        device=device, seed=seed)
    trainer = ClassificationTrainer(model, corpus, tokenizer, label_dict,
                                    device=device)
    with tempfile.TemporaryDirectory() as tmp:
        trainer.train(tmp, TrainConfig(
            learning_rate=learning_rate, lr_rate=1.0,
            batch_size=batch_size, max_epochs=max_epochs, seed=seed))
        scores = trainer.evaluate(corpus.test_list[0])
    return scores["accuracy"]
