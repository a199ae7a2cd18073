"""The experiment YAML (counterpart of ``kbner_tpu/config.py``).

:class:`ServeConfig` is what serving reads: ``name``, ``tag_layer``,
``targets``, ``tokenizer``, ``model`` and ``target_dir``, other keys
ignored. :class:`ExperimentConfig` adds what ``cli train``/``test``/``parse``
read: ``corpora`` (column corpora with a ``column_format``, ``format:
conllu`` or ``fasttext`` folders, or a registry name without a
``column_format``, see :mod:`.data.corpora`), ``train`` (a
:class:`TrainConfig`, a ``DistillConfig`` for the distillation trainer or
an ``LMTrainConfig`` for ``trainer: lm``; unknown keys raise), ``trainer``
(a kind or one of its reference class names), ``data`` (``doc_context``
with ``doc_window_budget``; ``stride_windows`` with ``max_subtokens`` and
``stride_words``), ``teachers`` (the distillation trainer's teacher
configs), ``systems`` (SWAF's prediction files) and ``ace`` (the ACE
episode loop's ``ReinforceConfig``); unknown top-level keys raise, as the
JAX package's do.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from .data.conll import (Corpus, ListCorpus, load_column_corpus,
                         load_conllu_corpus, read_fasttext_file)
from .data.doc_context import make_doc_context_records
from .data.subword import HashTokenizer, HFTokenizer, SubwordTokenizer
from .models.xlmr import XLMRConfig
from .train.trainer import TrainConfig


def _read_yaml(path: str | Path) -> Dict[str, Any]:
    text = Path(path).read_text()
    if text.lstrip().startswith("{"):
        # a config written as JSON reads as JSON, with PyYAML or without
        # (YAML 1.1 would read a number such as 5e-06 as a string)
        return json.loads(text)
    try:
        import yaml  # only the CLI reads YAML; the package imports without it
    except ImportError:  # a config written as JSON reads without PyYAML
        return json.loads(text) if text.strip() else {}
    return yaml.safe_load(text) or {}


@dataclasses.dataclass
class ServeConfig:
    name: str = "experiment"
    tag_layer: str = "ner"
    targets: str = "ner"
    tokenizer: Dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"type": "hash", "vocab_size": 50000})
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    target_dir: Optional[str] = None

    @classmethod
    def from_file(cls, path: str | Path) -> "ServeConfig":
        raw = _read_yaml(path)
        fields = {f.name for f in dataclasses.fields(ServeConfig)}
        return ServeConfig(**{k: v for k, v in raw.items() if k in fields})

    def make_tokenizer(self) -> SubwordTokenizer:
        """``tokenizer: {type: hash, vocab_size: N}`` or ``{type: hf, dir:
        DIR}`` (a saved HF tokenizer directory; a missing ``dir`` is a
        ``KeyError``)."""
        t = dict(self.tokenizer)
        kind = t.pop("type", "hash")
        if kind == "hash":
            return HashTokenizer(**t)
        if kind == "hf":
            return HFTokenizer(t["dir"])
        raise ValueError(f"unknown tokenizer type {kind!r}")

    def make_encoder_config(self, tokenizer: SubwordTokenizer,
                            **overrides) -> XLMRConfig:
        """``model.encoder``: a named size (tiny, base, large), its
        vocabulary cut to a hash tokenizer's (``vocab_size: 250002``
        keeps XLM-R's full table; an HF tokenizer keeps the size's own),
        or an HF checkpoint directory, read from its ``config.json`` with
        its own vocabulary (hash ids are smaller, so they index it
        safely); with ``model.remat``/``model.remat_policy`` and
        ``overrides`` (for example ``param_dtype=torch.float32`` for
        training)."""
        enc = self.model.get("encoder", self.model.get("size", "base"))
        sizes = {"tiny": XLMRConfig.tiny, "base": XLMRConfig.base,
                 "large": XLMRConfig.large}
        kw: Dict[str, Any] = {}
        if "remat" in self.model:
            kw["remat"] = bool(self.model["remat"])
        if self.model.get("remat_policy"):
            kw["remat_policy"] = str(self.model["remat_policy"])
        kw.update(overrides)
        if enc in sizes:
            if self.tokenizer.get("type", "hash") == "hash":
                kw = {"vocab_size": tokenizer.vocab_size, **kw}
            return sizes[enc](**kw)
        return XLMRConfig.from_hf_config(Path(enc) / "config.json", **kw)

    def resolve_target_dir(self) -> Path:
        return Path(self.target_dir or f"resources/taggers/{self.name}")


@dataclasses.dataclass
class CorpusSpec:
    name: str
    data_folder: str
    column_format: Dict[int, str]
    comment_symbol: Optional[str] = None
    train_file: str = "train.txt"
    dev_file: str = "dev.txt"
    test_file: str = "test.txt"
    tag_to_bioes: Optional[str] = "ner"
    # "column" (CoNLL), "conllu" (UD) or "fasttext" (__label__X text)
    format: str = "column"


def _corpus_spec(c: Dict[str, Any]) -> CorpusSpec:
    """One ``corpora:`` block: a conllu or fastText folder (default files
    ``<split>.conllu`` / ``<split>.txt``), a column corpus, or a registry
    name (a block without ``column_format``, resolved under ``data_root``
    with the block's folder, file, comment and tag-layer overrides)."""
    fmt = c.get("format")
    if fmt in ("fasttext", "conllu"):
        suffix = "txt" if fmt == "fasttext" else "conllu"
        return CorpusSpec(
            name=c["name"], data_folder=c["data_folder"], column_format={},
            format=fmt, train_file=c.get("train_file", f"train.{suffix}"),
            dev_file=c.get("dev_file", f"dev.{suffix}"),
            test_file=c.get("test_file", f"test.{suffix}"))
    if "column_format" not in c:
        from .data.corpora import corpus_spec

        return corpus_spec(c["name"], c.get("data_root", "."), **{
            k: v for k, v in c.items()
            if k in ("data_folder", "train_file", "dev_file", "test_file",
                     "comment_symbol", "tag_to_bioes")})
    return CorpusSpec(
        name=c["name"], data_folder=c["data_folder"],
        column_format={int(k): v for k, v in c["column_format"].items()},
        comment_symbol=c.get("comment_symbol"),
        train_file=c.get("train_file", "train.txt"),
        dev_file=c.get("dev_file", "dev.txt"),
        test_file=c.get("test_file", "test.txt"),
        tag_to_bioes=c.get("tag_to_bioes", "ner"))


# trainer: key -> kind; the JAX package's reference class names are
# accepted as aliases
TRAINERS: Dict[str, str] = {
    "FinetuneTrainer": "finetune",
    "ModelFinetuner": "finetune",
    "ModelTrainer": "finetune",
    "DistillationTrainer": "distill",
    "ModelDistiller": "distill",
    "ReinforcementTrainer": "ace",
    "SWAFTrainer": "swaf",
    "LanguageModelTrainer": "lm",
}

_KNOWN_TOP_KEYS = {
    "name", "corpora", "tag_layer", "tokenizer", "model", "train", "data",
    "target_dir", "trainer", "targets", "teachers", "ace", "systems",
}


@dataclasses.dataclass
class ExperimentConfig(ServeConfig):
    corpora: List[CorpusSpec] = dataclasses.field(default_factory=list)
    train: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trainer: str = "FinetuneTrainer"
    # the ACE episode loop's settings (episodes, controller_lr,
    # reward_kind, seed)
    ace: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # the distillation trainer's teachers: one experiment config per
    # corpus language
    teachers: List[str] = dataclasses.field(default_factory=list)
    # SWAF's systems: {dev: [...], test: [...]} 'token gold pred' files
    systems: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str | Path) -> "ExperimentConfig":
        return cls.from_dict(_read_yaml(path))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "ExperimentConfig":
        unknown = set(raw) - _KNOWN_TOP_KEYS
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}; "
                             f"known: {sorted(_KNOWN_TOP_KEYS)}")
        trainer = raw.get("trainer", "FinetuneTrainer")
        if trainer not in TRAINERS:
            raise ValueError(
                f"unknown trainer: {trainer!r}; one of {sorted(TRAINERS)}")
        corpora = [_corpus_spec(c) for c in raw.get("corpora") or []]
        serve = {f.name: raw[f.name] for f in dataclasses.fields(ServeConfig)
                 if f.name in raw}
        return cls(**serve, corpora=corpora, train=raw.get("train") or {},
                   data=raw.get("data") or {}, trainer=trainer,
                   ace=raw.get("ace") or {},
                   teachers=list(raw.get("teachers") or []),
                   systems=raw.get("systems") or {})

    @property
    def trainer_kind(self) -> str:
        return TRAINERS[self.trainer]

    def load_corpus(self) -> ListCorpus:
        corpora = []
        for s in self.corpora:
            folder = Path(s.data_folder)
            if s.format == "fasttext":
                def read(fname, folder=folder):
                    p = folder / fname
                    return read_fasttext_file(p) if p.exists() else []

                corpora.append(Corpus(
                    train=read(s.train_file), dev=read(s.dev_file),
                    test=read(s.test_file), name=s.name))
            elif s.format == "conllu":
                corpora.append(load_conllu_corpus(
                    folder, train_file=s.train_file, dev_file=s.dev_file,
                    test_file=s.test_file, name=s.name))
            else:
                corpora.append(load_column_corpus(
                    folder, s.column_format, train_file=s.train_file,
                    dev_file=s.dev_file, test_file=s.test_file,
                    comment_symbol=s.comment_symbol,
                    tag_to_bioes=s.tag_to_bioes, name=s.name))
        return ListCorpus(corpora)

    def prepare_corpus(self, corpus: ListCorpus, tokenizer) -> ListCorpus:
        """The config's data-encoding policies: with ``doc_context``
        every split of every corpus becomes document windows of
        ``doc_window_budget`` subtokens (510 by default; neighbours as
        ``S-X`` words, :mod:`.data.doc_context`)."""
        if not self.data.get("doc_context", False):
            return corpus
        budget = int(self.data.get("doc_window_budget", 510))

        def windows(recs):
            if not recs:
                return recs
            return make_doc_context_records(recs, tokenizer, budget=budget,
                                            tag_layer=self.tag_layer)[0]

        return ListCorpus([Corpus(train=windows(c.train), dev=windows(c.dev),
                                  test=windows(c.test), name=c.name)
                           for c in corpus.corpora])

    def make_train_config(self):
        """The trainer's config (a ``DistillConfig`` for the distillation
        trainer, an ``LMTrainConfig`` for the char-LM trainer, else a
        :class:`TrainConfig`); unknown ``train:`` keys raise."""
        if self.trainer_kind == "distill":
            from .train.distill import DistillConfig

            cls_ = DistillConfig
        elif self.trainer_kind == "lm":
            from .train.lm_trainer import LMTrainConfig

            cls_ = LMTrainConfig
        else:
            cls_ = TrainConfig
        known = {f.name for f in dataclasses.fields(cls_)}
        unknown = set(self.train) - known
        if unknown:
            raise ValueError(
                f"unknown train keys for {self.trainer}: {sorted(unknown)}; "
                f"known: {sorted(known)}")
        return cls_(**self.train)

    def make_train_encoder_config(self, tokenizer: SubwordTokenizer
                                  ) -> XLMRConfig:
        """The encoder config to train: float32 master parameters."""
        return self.make_encoder_config(tokenizer,
                                        param_dtype=torch.float32)
