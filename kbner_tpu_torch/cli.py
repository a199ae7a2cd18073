"""Command line of the PyTorch port (counterpart of ``kbner_tpu/cli.py``):

    python -m kbner_tpu_torch.cli ingest-dump --dump DUMP.xml.bz2 \
        --out KB.jsonl
    python -m kbner_tpu_torch.cli index --kb KB.jsonl --out KB_DIR
    python -m kbner_tpu_torch.cli retrieve --index_dir KB_DIR \
        --data_folder CONLL --out FUSED
    python -m kbner_tpu_torch.cli train --config CONFIG.yaml
    python -m kbner_tpu_torch.cli test  --config CONFIG.yaml
    python -m kbner_tpu_torch.cli parse --config CONFIG.yaml --target_dir D
    python -m kbner_tpu_torch.cli serve --config CONFIG.yaml --index_dir KB_DIR
    python -m kbner_tpu_torch.cli retrieve --route mix --engine_mode pruned \
        --index_dir en=KB_EN --index_dir de=KB_DE --data_folder CONLL \
        --out FUSED
    python -m kbner_tpu_torch.cli multistage STAGE1.yaml STAGE2.yaml
    python -m kbner_tpu_torch.cli parity --weights XLMR_DIR --data DATA \
        --out OUT
    python -m kbner_tpu_torch.cli ensemble P1.conllu P2.conllu P3.conllu \
        --out ENS.conll
    python -m kbner_tpu_torch.cli evaluate GOLD_PRED.tsv
    python -m kbner_tpu_torch.cli speed --config CONFIG.yaml

``ingest-dump`` turns a MediaWiki XML dump into parsed-wiki JSONL and
``index`` saves a KB built from that JSONL (text and title BM25 indices, a
packed doc store); both run on the host. ``retrieve`` searches every
sentence of a CoNLL folder's ``train/dev/test.txt`` in a KB (``--index_dir``
or ``--kb``), or with ``--route mix`` in every language's KB at once,
and writes each split's retrieval file and its context-fused column file,
what ``train`` reads. ``train`` fine-tunes the NER tagger on the config's
corpora (``FinetuneTrainer``; ``data.stride_windows`` and
``data.doc_context`` apply), or with ``trainer: DistillationTrainer``
(``ModelDistiller``) distills a student from the taggers of the configs
under ``teachers:``, or with ``trainer: ReinforcementTrainer`` runs the
ACE search over a stacked-embedder tagger (``model.embeddings``) and
trains the final model with its best selection, each then testing the
best model; ``trainer: SWAFTrainer`` learns per-token weights for the
systems' prediction files under ``systems:`` and combines their test
predictions; ``trainer: LanguageModelTrainer`` pretrains a character LM;
``targets: dependency``, ``enhancedud``, ``ner_dp``, ``classification``
or ``regression`` trains the biaffine tree parser, the graph parser, span
NER as parsing, the text classifier or the regressor instead, then
prints the best model's test scores (``test`` prints them per test set,
``parse`` writes ``head``/``deprel``, ``deps`` or ``ner`` columns);
``multistage``
trains one config after another, each stage starting from the encoder the
previous one exported; ``parity`` runs the recipe's two stages (a
multilingual fine-tune, then EN from its encoder) from an HF XLM-R
checkpoint directory (``model.encoder_weights`` in a config) and scores
the EN test predictions with conlleval; ``test``
evaluates the best (else final) model on the test sets; ``parse`` tags
every ``*.txt`` column file of a folder (or one file) into
``<stem>.conllu`` with a ``pred`` column. ``serve`` reads JSONL requests on
stdin and writes JSONL responses on stdout, one micro-batch of
``--batch_size`` requests at a time, with the request and response schema
of ``kbner_tpu.cli serve`` (see :mod:`.serve`), from the trained
``best-model.msgpack`` (else ``final-model.msgpack``) that either package
wrote, or from random weights when there is none. ``ensemble``
majority-votes the spans of several prediction files (token and tag
columns) into one; ``evaluate`` prints the span metric of a 'token gold
pred' file and its JSON summary; ``speed`` measures the tagger's decode
rate on the test set. Every command but ``ingest-dump``, ``index``,
``ensemble`` and ``evaluate`` runs on the card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from . import checkpoint, weights
from .config import ExperimentConfig, ServeConfig
from .data.conll import ListCorpus, read_column_file, write_column_file
from .data.dictionary import Dictionary
from .data.subword import HashTokenizer, HFTokenizer
from .models.tagger import SequenceTagger, TaggerConfig
from .models.xlmr import load_hf_checkpoint
from .retrieval.engine import RetrievalEngine
from .retrieval.pipeline import build_kb_from_jsonl, load_kb, save_kb
from .serve import serve
from .train.trainer import FinetuneTrainer

log = logging.getLogger("kbner_tpu_torch")
RETRIEVE_BATCH = 1024  # queries per search, as in retrieve_for_records


def _trained_checkpoint(target_dir: Path) -> Optional[Path]:
    """``best-model.msgpack``, else ``final-model.msgpack``, else None."""
    for name in ("best-model.msgpack", "final-model.msgpack"):
        if (target_dir / name).exists():
            return target_dir / name
    return None


def _build(config: ExperimentConfig, device: str) -> FinetuneTrainer:
    """The NER tagger (float32 master parameters, made from the train
    config's seed) and its trainer over the config's corpora, with the
    config's document windows and stride windows."""
    if config.targets != "ner":
        _refuse_tagger_policies(config)
        raise ValueError(
            f"targets: {config.targets} builds through _build_parser"
            if config.targets in PARSER_TARGETS
            else f"unknown targets: {config.targets}")
    train_config = config.make_train_config()
    corpus = config.load_corpus()
    tokenizer = config.make_tokenizer()
    corpus = config.prepare_corpus(corpus, tokenizer)
    tag_dict_path = config.resolve_target_dir() / "tag_dictionary.json"
    # the tag indexing persists across stages
    tag_dict = (Dictionary.load(tag_dict_path) if tag_dict_path.exists()
                else corpus.make_tag_dictionary(config.tag_layer))
    m = config.model
    tagger_cfg = TaggerConfig.for_tag_dictionary(
        config.make_train_encoder_config(tokenizer), tag_dict,
        use_crf=m.get("use_crf", True),
        locked_dropout=m.get("locked_dropout", 0.5),
        word_dropout=m.get("word_dropout", 0.05),
        num_languages=(len(corpus.corpora) if m.get("enhanced_crf", False)
                       else 0),
        transition_attention=m.get("transition_attention", False))
    model = SequenceTagger(tagger_cfg, device=device, seed=train_config.seed)
    if m.get("encoder_weights"):
        _load_encoder_weights(model, Path(m["encoder_weights"]))
    return FinetuneTrainer(
        model, corpus, tokenizer, tag_dict, tag_layer=config.tag_layer,
        stride_windows=config.data.get("stride_windows", False),
        stride_max_subtokens=config.data.get("max_subtokens", 510),
        stride_words=config.data.get("stride_words", 16), device=device)


PARSER_TARGETS = ("dependency", "enhancedud", "ner_dp", "classification",
                  "regression")
# the column layers cli parse writes for each parsing target
PARSE_LAYERS = {"dependency": ("head", "deprel"), "enhancedud": ("deps",),
                "ner_dp": ("ner",)}


def _refuse_tagger_policies(config: ExperimentConfig) -> None:
    if config.data.get("doc_context") or config.data.get("stride_windows"):
        raise ValueError(
            "doc_context / stride_windows are NER-tagger data policies; "
            f"they are not applied under targets: {config.targets}")


def _build_parser(config: ExperimentConfig, device: str):
    """The parser and classifier families (``targets: dependency``,
    ``enhancedud``, ``ner_dp``, ``classification``, ``regression``): the
    model (float32 master parameters, made from the train config's seed,
    the encoder from ``model.encoder_weights`` when given) and its trainer
    over the config's corpora. Model keys: ``arc_dim`` (256), ``rel_dim``
    (64), ``dropout`` (0.1), ``arc_loss`` (ce), ``partial``,
    ``arc_threshold`` (0.5), ``span_dim`` (128), ``max_span_len`` (30),
    ``multi_label``, ``pooling`` (cls), ``rnn_hidden`` (128); data keys
    ``dep_layer`` (deps) and ``n_buckets`` (0). Returns ``(corpus,
    tokenizer, model, trainer)``; an unknown target raises ValueError."""
    from .device import resolve_device
    from .models import biaffine as bf
    from .models import classifier as clf
    from .train import parser_trainer as pt

    _refuse_tagger_policies(config)
    if config.targets not in PARSER_TARGETS:
        raise ValueError(f"unknown targets: {config.targets}")
    device = resolve_device(device)
    seed = config.make_train_config().seed
    corpus = config.load_corpus()
    tokenizer = config.make_tokenizer()
    enc_cfg = config.make_train_encoder_config(tokenizer)
    mc = config.model
    arc_dim, rel_dim = mc.get("arc_dim", 256), mc.get("rel_dim", 64)
    kw = dict(n_buckets=config.data.get("n_buckets", 0), device=device)
    if config.targets == "dependency":
        rel_dict = pt.build_rel_dictionary(corpus.train)
        model = bf.BiaffineParser(bf.BiaffineConfig(
            encoder=enc_cfg, num_rels=max(len(rel_dict), 1), arc_dim=arc_dim,
            rel_dim=rel_dim, dropout=mc.get("dropout", 0.1),
            arc_loss=mc.get("arc_loss", "ce"),
            partial=mc.get("partial", False)), device=device, seed=seed)
        make = lambda: pt.ParserTrainer(model, corpus, tokenizer, rel_dict,
                                        **kw)
    elif config.targets == "enhancedud":
        dep_layer = config.data.get("dep_layer", "deps")
        rel_dict = pt.build_semdep_rel_dictionary(corpus.train,
                                                  layer=dep_layer)
        model = bf.SemanticDependencyParser(bf.SemDepConfig(
            encoder=enc_cfg, num_rels=max(len(rel_dict), 1), arc_dim=arc_dim,
            rel_dim=rel_dim, arc_threshold=mc.get("arc_threshold", 0.5)),
            device=device, seed=seed)
        make = lambda: pt.SemDepTrainer(model, corpus, tokenizer, rel_dict,
                                        dep_layer=dep_layer, **kw)
    elif config.targets == "ner_dp":
        label_dict = Dictionary()
        label_dict.add_item("O")
        for rec in corpus.train:
            for tag in rec.tags.get(config.tag_layer, []):
                if "-" in tag:
                    label_dict.add_item(tag.split("-", 1)[1])
        model = bf.BiaffineNER(bf.BiaffineNERConfig(
            encoder=enc_cfg, num_labels=max(len(label_dict), 2),
            span_dim=mc.get("span_dim", 128),
            max_span_len=mc.get("max_span_len", 30)), device=device,
            seed=seed)
        make = lambda: pt.BiaffineNERTrainer(
            model, corpus, tokenizer, label_dict, tag_layer=config.tag_layer,
            **kw)
    elif config.targets == "classification":
        label_dict = clf.build_label_dictionary(corpus.train)
        multi = mc.get("multi_label", False)
        model = clf.TextClassifier(clf.TextClassifierConfig(
            encoder=enc_cfg, num_labels=max(len(label_dict), 2),
            multi_label=multi, dropout=mc.get("dropout", 0.1),
            pooling=mc.get("pooling", "cls"),
            rnn_hidden=mc.get("rnn_hidden", 128)), device=device, seed=seed)
        make = lambda: pt.ClassificationTrainer(
            model, corpus, tokenizer, label_dict, multi_label=multi, **kw)
    else:
        model = clf.TextRegressor(clf.TextRegressorConfig(
            encoder=enc_cfg, dropout=mc.get("dropout", 0.1)), device=device,
            seed=seed)
        make = lambda: pt.RegressionTrainer(model, corpus, tokenizer, **kw)
    if mc.get("encoder_weights"):
        _load_encoder_weights(model, Path(mc["encoder_weights"]))
    return corpus, tokenizer, model, make()


def _load_encoder_weights(model, weights_dir: Path) -> None:
    """Load an HF checkpoint directory into the model's float32 master
    encoder (``model.encoder``), on its device; a weight of another dtype
    or shape raises, naming its key."""
    encoder = model.encoder
    own = encoder.state_dict()
    state = load_hf_checkpoint(weights_dir, encoder.config,
                               dtype=torch.float32, device=model.device)
    for key, t in state.items():
        if t.dtype != own[key].dtype or t.shape != own[key].shape:
            raise ValueError(
                f"model.encoder_weights: {key} is {t.dtype} "
                f"{tuple(t.shape)} in {weights_dir}, the encoder's "
                f"{own[key].dtype} {tuple(own[key].shape)}")
    encoder.load_state_dict(state)
    log.info("encoder weights from %s", weights_dir)


def _build_distill(config: ExperimentConfig, device: str):
    """The student (as :func:`_build` makes it) and its
    ``DistillationTrainer`` over the taggers of the ``teachers:`` configs,
    each built from its own config and loaded from its best (else final)
    checkpoint. A teacher whose tag dictionary differs from the
    student's, or that has no checkpoint, raises."""
    from .train.distill import DistillationTrainer

    student = _build(config, device)
    if not config.teachers:
        raise ValueError("trainer: DistillationTrainer needs a 'teachers:' "
                         "list of trained experiment-config paths")
    teachers = []
    for tpath in config.teachers:
        tcfg = ExperimentConfig.from_file(tpath)
        teacher = _build(tcfg, device)
        if teacher.tag_dict.idx2item != student.tag_dict.idx2item:
            raise ValueError(
                f"teacher {tpath} tag dictionary differs from the "
                "student's — KD needs a shared label space")
        ckpt = _trained_checkpoint(tcfg.resolve_target_dir())
        if ckpt is None:
            raise ValueError(f"teacher {tpath} has no trained checkpoint "
                             f"under {tcfg.resolve_target_dir()}")
        teacher.load(ckpt)
        teachers.append(teacher.model)
    return DistillationTrainer(
        student.model, student.corpus, student.tokenizer, student.tag_dict,
        tag_layer=config.tag_layer, teachers=teachers, device=device)


def _build_ace(config: ExperimentConfig, device: str):
    """The stacked-embedder tagger (float32 parameters made from the train
    config's seed; XLM-R's compute dtype as configured) and its trainer,
    with the corpus's word and character vocabularies, for the ACE loop.
    ``model.embeddings`` lists the stack's members:

      - {type: transformer, fine_tune: false}
      - {type: word, dim: D}
      - {type: char_bilstm, char_dim: D, hidden: H}
      - {type: flair, embed_dim: D, hidden: H}
      - {type: elmo, char_dim, filters: [[w, c], ...], n_highway,
         proj_dim, num_layers, mode, cell_dim (bilm-tf's topology),
         conv_activation, char_encoding: elmo_bytes (allennlp's byte ids,
         261 of them), char_vocab_size, weights: FILE (.hdf5/.h5 through
         ELMoEmbedder.load_hdf5, anything else through load_npz)}
      - {type: bpemb, dim: D, vectors: W2V_TEXT_FILE, trainable}

    Returns ``(trainer, specs)``."""
    from .data.encode import (ELMO_CHAR_VOCAB, build_char_vocab,
                              build_word_vocab)
    from .device import resolve_device
    from .models.embedders import (BPEmbEmbedder, BPEVocab,
                                   CharBiLSTMEmbedder, ELMoEmbedder,
                                   EmbedderSpec, FlairLMEmbedder,
                                   TransformerWordEmbedder, WordEmbedder)
    from .models.tagger import StackedSequenceTagger

    if config.targets != "ner":
        raise NotImplementedError(
            f"targets: {config.targets}: the ACE loop tags NER")
    device = resolve_device(device)
    train_config = config.make_train_config()
    corpus = config.load_corpus()
    tokenizer = config.make_tokenizer()
    tag_dict = corpus.make_tag_dictionary(config.tag_layer)
    word_vocab = build_word_vocab(corpus.train)
    char_vocab = build_char_vocab(corpus.train)
    enc_cfg = config.make_train_encoder_config(tokenizer)
    specs = []
    bpe_vocab = None
    elmo_bytes = False
    pending = []  # (member index, weight file) spliced after the build
    for i, e in enumerate(config.model.get("embeddings") or [
            {"type": "word", "dim": 32},
            {"type": "char_bilstm", "char_dim": 16, "hidden": 16}]):
        kind = e.get("type", "word")
        if kind == "word":
            dim = e.get("dim", 32)
            specs.append(EmbedderSpec(f"word{i}", WordEmbedder(
                len(word_vocab), dim, device=device), dim))
        elif kind == "char_bilstm":
            hidden = e.get("hidden", 16)
            specs.append(EmbedderSpec(f"char{i}", CharBiLSTMEmbedder(
                len(char_vocab), e.get("char_dim", 16), hidden,
                device=device), 2 * hidden))
        elif kind == "flair":
            hidden = e.get("hidden", 16)
            specs.append(EmbedderSpec(f"flair{i}", FlairLMEmbedder(
                len(char_vocab), e.get("embed_dim", 16), hidden,
                device=device), 2 * hidden))
        elif kind == "transformer":
            specs.append(EmbedderSpec(f"xlmr{i}", TransformerWordEmbedder(
                enc_cfg, e.get("fine_tune", False), device=device),
                enc_cfg.hidden_size))
        elif kind == "elmo":
            kw = {}
            if e.get("filters"):
                kw["filters"] = tuple((int(w), int(c))
                                      for w, c in e["filters"])
            if e.get("n_highway") is not None:
                kw["n_highway"] = int(e["n_highway"])
            vocab_size = e.get("char_vocab_size", len(char_vocab))
            if e.get("char_encoding") == "elmo_bytes":
                kw["input_key"] = "elmo_char_ids"
                vocab_size = e.get("char_vocab_size", ELMO_CHAR_VOCAB)
                elmo_bytes = True
            mod = ELMoEmbedder(
                vocab_size, e.get("char_dim", 16),
                proj_dim=e.get("proj_dim", 16),
                num_layers=e.get("num_layers", 2), mode=e.get("mode", "all"),
                cell_dim=e.get("cell_dim"),
                conv_activation=e.get(
                    "conv_activation",
                    "relu" if e.get("cell_dim") else "tanh"),
                device=device, **kw)
            if e.get("weights"):
                pending.append((len(specs), str(e["weights"])))
            specs.append(EmbedderSpec(f"elmo{i}", mod, mod.out_dim))
        elif kind == "bpemb":
            if bpe_vocab is None:
                bpe_vocab = (
                    BPEVocab.from_w2v_text(e["vectors"]) if e.get("vectors")
                    else BPEVocab.build(corpus.train, dim=e.get("dim", 25)))
            specs.append(EmbedderSpec(f"bpemb{i}", BPEmbEmbedder(
                len(bpe_vocab.pieces), bpe_vocab.dim,
                e.get("trainable", True), device=device),
                2 * bpe_vocab.dim))
        else:
            raise ValueError(f"unknown ACE embedding type {kind!r}")
    m = config.model
    tagger_cfg = TaggerConfig.for_tag_dictionary(
        enc_cfg, tag_dict, use_crf=m.get("use_crf", True),
        locked_dropout=m.get("locked_dropout", 0.5),
        word_dropout=m.get("word_dropout", 0.05))
    model = StackedSequenceTagger(tagger_cfg, specs, device=device,
                                  seed=train_config.seed)
    for idx, path in pending:
        member = model.stack.members[idx]
        if path.endswith((".hdf5", ".h5")):
            member.load_hdf5(path)
        else:
            member.load_npz(path)
        log.info("loaded ELMo weights for members_%d from %s", idx, path)
    trainer = FinetuneTrainer(model, corpus, tokenizer, tag_dict,
                              tag_layer=config.tag_layer, device=device)
    trainer.word_vocab = word_vocab
    trainer.char_vocab = char_vocab
    trainer.bpe_vocab = bpe_vocab
    trainer.elmo_bytes = elmo_bytes
    return trainer, specs


def _run_lm(config: ExperimentConfig, target_dir: Path, device: str
            ) -> dict:
    """Char-LM pretraining on the corpus's train text: a
    :class:`~.models.embedders.CharLMHead` (``model.embed_dim``,
    ``model.hidden``) made from seed 0, ``char-lm.msgpack`` and
    ``char_vocab.json`` under the target directory."""
    import torch

    from .device import resolve_device
    from .models.embedders import CharLMHead
    from .train.lm_trainer import LanguageModelTrainer

    device = resolve_device(device)
    texts = [" ".join(r.tokens) for r in config.load_corpus().train]
    vocab = Dictionary()
    for ch in " \n" + "".join(texts):
        vocab.add_item(ch)
    model = CharLMHead(len(vocab), config.model.get("embed_dim", 32),
                       config.model.get("hidden", 64), device=device)
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))
    result = LanguageModelTrainer(model, vocab, device=device).train(
        texts, target_dir, config.make_train_config())
    vocab.save(target_dir / "char_vocab.json")
    log.info("char-LM final loss %s", result["final_loss"])
    return result


def _run_swaf(config: ExperimentConfig, target_dir: Path, device: str
              ) -> dict:
    """SWAF over ``systems: {dev: [...], test: [...]}``, files of 'token
    gold pred' lines (gold from each split's first file): an
    :class:`~.models.ensemble_model.EnsembleModel` (``model.hidden``, 128
    by default, made from seed 0) trained ``train.max_epochs`` (200)
    full-batch steps at ``train.learning_rate`` (0.01) on dev, then its
    weighted vote over test into ``test.swaf.tsv``; the final loss and
    the test span micro F1 go to ``swaf_results.json`` and stdout."""
    from .eval.metrics import evaluate_spans
    from .models.ensemble_model import (EnsembleConfig, EnsembleModel,
                                        SWAFTrainer,
                                        encode_system_predictions)

    systems = config.systems
    if not systems.get("dev") or not systems.get("test"):
        raise ValueError("trainer: SWAFTrainer needs systems: {dev: [...], "
                         "test: [...]} prediction files")

    def load_split(files):
        read = [read_column_file(f, {0: "text", 1: "gold", 2: "pred"},
                                 tag_to_bioes=None) for f in files]
        return (read[0], [[r.tags["pred"] for r in recs] for recs in read],
                [r.tags["gold"] for r in read[0]])

    _, dev_sys, dev_gold = load_split(systems["dev"])
    test_recs, test_sys, test_gold = load_split(systems["test"])
    label_dict = Dictionary()
    label_dict.add_item("O")
    for tags in dev_sys + test_sys + [dev_gold, test_gold]:
        for sent in tags:
            for t in sent:
                label_dict.add_item(t)
    dev_arrays = encode_system_predictions(dev_sys, dev_gold, label_dict)
    test_arrays = encode_system_predictions(test_sys, test_gold, label_dict)
    model = EnsembleModel(EnsembleConfig(
        num_systems=len(dev_sys), num_labels=len(label_dict),
        hidden=config.model.get("hidden", 128)), device=device)
    trainer = SWAFTrainer(model)
    losses = trainer.train(
        dev_arrays, steps=int(config.train.get("max_epochs", 200)),
        lr=float(config.train.get("learning_rate", 1e-2)))
    combined = trainer.combine(test_arrays)
    preds = []
    for b, rec in enumerate(test_recs):
        preds.append([label_dict.get_item_for_index(int(combined[b, w]))
                      for w in range(len(rec.tokens))])
        rec.tags["pred"] = preds[-1]
    target_dir.mkdir(parents=True, exist_ok=True)
    write_column_file(target_dir / "test.swaf.tsv", test_recs,
                      layers=("pred",))
    result = {"final_loss": losses[-1] if losses else None,
              "test_micro_f1": evaluate_spans(test_gold,
                                              preds).micro_avg_f_score()}
    (target_dir / "swaf_results.json").write_text(json.dumps(result))
    log.info("SWAF combined test micro-F1 %.4f", result["test_micro_f1"])
    print(json.dumps(result))
    return result


def _setup_logging(target_dir: Optional[Path] = None) -> None:
    handlers: List[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if target_dir is not None:
        target_dir.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(target_dir / "training.log"))
    logging.basicConfig(level=logging.INFO, handlers=handlers, force=True,
                        format="%(asctime)s %(levelname)s %(message)s")


def cmd_train(args) -> dict:
    """Train as the config's trainer says and test the best model;
    returns the training result (the ACE search's, with its history and
    best action, for ``trainer: ReinforcementTrainer``; SWAF's final loss
    and test F1)."""
    config = ExperimentConfig.from_file(args.config)
    target_dir = config.resolve_target_dir()
    _setup_logging(target_dir)
    if config.targets in PARSER_TARGETS:
        return _train_parser(config, target_dir, args.device)
    if config.trainer_kind == "lm":
        return _run_lm(config, target_dir, args.device)
    if config.trainer_kind == "swaf":
        return _run_swaf(config, target_dir, args.device)
    if config.trainer_kind == "distill":
        trainer = _build_distill(config, args.device)
        result = trainer.train(target_dir, config.make_train_config())
        log.info("KD best dev score: %s", result["best_dev_score"])
    elif config.trainer_kind == "ace":
        from .train.reinforce import ReinforceConfig, ace_train

        trainer, specs = _build_ace(config, args.device)
        result = ace_train(trainer, config.make_train_config(), target_dir,
                           num_embeddings=len(specs),
                           config=ReinforceConfig(**config.ace))
        log.info("ACE best action %s (dev F1 %.4f)", result["best_action"],
                 result["best_f1"])
    else:
        trainer = _build(config, args.device)
        result = trainer.train(target_dir, config.make_train_config())
        log.info("best dev score: %s", result["best_dev_score"])
    trainer.final_test(target_dir)
    return result


def _train_parser(config: ExperimentConfig, target_dir: Path, device: str
                  ) -> dict:
    """``cli train`` of a parsing or classification target: train, then
    score the best model on the test splits together and print the scores
    as the last line."""
    corpus, _, _, trainer = _build_parser(config, device)
    result = trainer.train(target_dir, config.make_train_config())
    log.info("best dev: %s", result)
    test = [r for split in corpus.test_list for r in split]
    if test:
        trainer.load(target_dir / "best-model.msgpack")
        scores = trainer.evaluate(test)
        log.info("test %s", scores)
        print(json.dumps(scores))
    return result


def _trained_parser(config: ExperimentConfig, device: str):
    """``_build_parser``'s corpus and trainer, loaded from the best (else
    final) checkpoint."""
    corpus, _, _, trainer = _build_parser(config, device)
    ckpt = _trained_checkpoint(config.resolve_target_dir())
    if ckpt is None:
        raise ValueError(f"no best-model.msgpack or final-model.msgpack "
                         f"under {config.resolve_target_dir()}")
    trainer.load(ckpt)
    return corpus, trainer


def cmd_test(args) -> None:
    config = ExperimentConfig.from_file(args.config)
    target_dir = config.resolve_target_dir()
    _setup_logging(target_dir)
    if config.targets in PARSER_TARGETS:
        corpus, trainer = _trained_parser(config, args.device)
        results = {name: trainer.evaluate(split) for name, split in zip(
            corpus.targets, corpus.test_list) if split}
    elif config.trainer_kind == "ace":
        # the stacked tagger under the search's best action, as the final
        # training ran it
        trainer, _ = _build_ace(config, args.device)
        state = target_dir / "training_state.json"
        if state.exists():
            trainer.selection = np.asarray(
                json.loads(state.read_text())["best_action"], np.float32)
        results = trainer.final_test(target_dir)
    else:
        results = _build(config, args.device).final_test(target_dir)
    print(json.dumps(results, indent=2))


def _parse_files(args):
    """(the column files ``parse`` reads, the directory it writes to)."""
    data_dir = Path(args.target_dir)
    files = sorted(data_dir.glob("*.txt")) if data_dir.is_dir() else [
        data_dir]
    out_dir = Path(args.out_dir) if args.out_dir else (
        data_dir if data_dir.is_dir() else data_dir.parent)
    return files, out_dir


def _parse_with_parser(config: ExperimentConfig, args) -> None:
    """``cli parse`` of a parsing target: each file's predicted layers
    (``head``/``deprel``, ``deps`` or ``ner``) into ``<stem>.conllu``."""
    if config.targets not in PARSE_LAYERS:
        raise ValueError(f"cli parse writes column files for targets "
                         f"{sorted(PARSE_LAYERS)}, not {config.targets}")
    _, trainer = _trained_parser(config, args.device)
    spec = config.corpora[0]
    files, out_dir = _parse_files(args)
    for f in files:
        records = read_column_file(f, spec.column_format,
                                   comment_symbol=spec.comment_symbol,
                                   tag_to_bioes=None)
        for rec, layers in zip(records, trainer.predict_records(records)):
            rec.tags.update(layers)
        out = out_dir / (f.stem + ".conllu")
        write_column_file(out, records, layers=PARSE_LAYERS[config.targets])
        log.info("wrote %s", out)


def cmd_parse(args) -> None:
    config = ExperimentConfig.from_file(args.config)
    target_dir = config.resolve_target_dir()
    _setup_logging(None)
    if config.targets in PARSER_TARGETS:
        return _parse_with_parser(config, args)
    trainer = _build(config, args.device)
    ckpt = _trained_checkpoint(target_dir)
    if ckpt is None:
        raise ValueError(f"no best-model.msgpack or final-model.msgpack "
                         f"under {target_dir}")
    trainer.load(ckpt)
    if args.save_embedding:
        trainer.save_encoder(target_dir / "finetuned-encoder.msgpack")
        log.info("saved the tuned encoder to %s",
                 target_dir / "finetuned-encoder.msgpack")
    spec = config.corpora[0]
    files, out_dir = _parse_files(args)
    for f in files:
        records = read_column_file(f, spec.column_format,
                                   comment_symbol=spec.comment_symbol)
        preds = trainer.predict(records, sort_by_length=not args.keep_order)
        for rec, pred in zip(records, preds):
            rec.tags["pred"] = pred
        out = out_dir / (f.stem + ".conllu")
        write_column_file(out, records, layers=("pred",))
        log.info("wrote %s", out)


def _first(v):
    """The first of an option given once or repeated (or None)."""
    return v[0] if isinstance(v, list) else v


def _open_kb(args):
    """(text index, doc store, title index) from ``--index_dir`` (a saved
    KB, mmap open) or ``--kb`` (parsed-wiki JSONL built in this process,
    its payloads in a packed store at ``--store`` if given)."""
    index_dir = _first(args.index_dir)
    if index_dir:
        text_index, store, title_index, lang = load_kb(index_dir)
        if args.lang and args.lang != lang:
            log.warning("--lang %s differs from the saved index language "
                        "%s; using the index's analyzer", args.lang, lang)
        return text_index, store, title_index
    kb = _first(args.kb)
    if not kb:
        raise SystemExit("provide --kb JSONL or --index_dir")
    return build_kb_from_jsonl(
        kb, lang=args.lang, store_path=args.store,
        fail_path=getattr(args, "kb_fail_file", None))


def cmd_ingest_dump(args) -> None:
    """MediaWiki XML dump -> parsed-wiki JSONL (the reference's
    ``dumps/`` and ``parse_text.py`` stages), on the host."""
    from .retrieval.dump import dump_to_jsonl

    n = dump_to_jsonl(args.dump, args.out, lang=args.lang,
                      paragraph_mode=args.paragraph,
                      max_pages=args.max_pages)
    log.info("wrote %d records to %s", n, args.out)


def cmd_index(args) -> Dict[str, float]:
    """Build a KB from parsed-wiki JSONL and save it (text and title BM25
    indices, the packed doc store, meta.json, a zh KB's IK dictionary), on
    the host. Returns the document count and the seconds of the text
    index's analysis, vocabulary and layout, the title index's build and
    the save."""
    _setup_logging(None)
    out = Path(args.out)
    t0 = time.perf_counter()
    text_index, store, title_index = build_kb_from_jsonl(
        args.kb, lang=args.lang, store_path=out / "kb.docs",
        fail_path=args.kb_fail_file, ik_dict=args.ik_dict,
        ik_smart=args.ik_smart)
    built_s = time.perf_counter() - t0
    save_kb(out, text_index, store, title_index, args.lang,
            ik_dict=args.ik_dict, ik_smart=args.ik_smart)
    store.close()
    text_s = text_index.build_seconds
    title_s = sum(title_index.build_seconds.values())
    stats = {"docs": text_index.n_docs, **text_s, "title": title_s,
             "read": built_s - sum(text_s.values()) - title_s,
             "save": time.perf_counter() - t0 - built_s}
    log.info("saved %d-doc %s index to %s; seconds %s", text_index.n_docs,
             args.lang, out, ", ".join(f"{k} {v:.2f}" for k, v in
                                      stats.items() if k != "docs"))
    return stats


def _predictor(config_path: str, device: str) -> FinetuneTrainer:
    """A trained tagger for ``cli retrieve``'s predicted entity seeds and
    BERTScore embeddings: the config's tokenizer and
    ``target_dir/tag_dictionary.json``, and its best (else final)
    checkpoint, loaded as ``cli serve`` loads it."""
    config = ServeConfig.from_file(config_path)
    target_dir = config.resolve_target_dir()
    if _trained_checkpoint(target_dir) is None:
        raise ValueError(f"no best-model.msgpack or final-model.msgpack "
                         f"under {target_dir}")
    tag_dict = Dictionary.load(target_dir / "tag_dictionary.json")
    tagger = serving_tagger(config, tag_dict, device)
    return FinetuneTrainer(tagger, ListCorpus([]), config.make_tokenizer(),
                           tag_dict, tag_layer=config.tag_layer,
                           device=device)


def _rerank_bertscore(predictor, queries, results, chunk: int = 1024):
    """Each query's contexts ordered by BERTScore F1 against it (stable).
    The queries and their contexts are embedded ``chunk`` queries at a
    time (the reference embeds the whole split in one call), so the
    embeddings on the device stay at one chunk's whatever the split's
    size."""
    from .retrieval.rerank import bertscore_f1

    out = []
    for c in range(0, len(queries), chunk):
        texts: List[str] = []
        spans = []
        for q, docs in zip(queries[c:c + chunk], results[c:c + chunk]):
            spans.append((len(texts), len(docs)))
            texts.append(q)
            texts.extend(d.sentence for d in docs)
        emb, mask = predictor.embed_texts(texts)
        for (start, n), docs in zip(spans, results[c:c + chunk]):
            if not n:
                out.append(list(docs))
                continue
            ctx = slice(start + 1, start + 1 + n)
            f1 = bertscore_f1(emb[start], mask[start], emb[ctx],
                              mask[ctx]).cpu().numpy()
            out.append([docs[i] for i in np.argsort(-f1, kind="stable")])
        del emb, mask
    return out


def _single_search_fn(args):
    """``cli retrieve``'s search over one KB: ``(records, entities) ->``
    one list of results per record."""
    from .retrieval.pipeline import retrieve_for_records

    text_index, store, title_index = _open_kb(args)
    engine = RetrievalEngine(text_index, store=store,
                             title_index=title_index, mode=args.engine_mode,
                             device=args.device)

    def run_search(records, entities):
        return retrieve_for_records(
            engine, records, k=args.k, lang=args.lang,
            with_entity=args.with_entity, entities=entities)
    return run_search


def _mix_search_fn(args):
    """``cli retrieve --route mix``'s search: one engine per language KB
    (repeated ``--kb lang=path`` and ``--index_dir lang=dir``), every query
    fanned out to all of them and merged by score (the reference's
    wildcard ``*wiki_v1`` msearch). Pruned sentence queries go through one
    :class:`MixEngine` over the engines' concatenated arrays (the engines
    keep theirs on the host); entity-boosted or exhaustive searches go
    through :func:`mix_search`, engine by engine, which also reads the
    title indices. Returns ``(records, entities) ->`` one list of results
    per record."""
    from .retrieval.engine import MixEngine, mix_search
    from .retrieval.pipeline import sentence_query

    single_dispatch = args.engine_mode == "pruned" and not args.with_entity
    engine_device = False if single_dispatch else args.device
    engines = {}
    for spec in args.kb or []:
        lang, sep, path = spec.rpartition("=")
        if not sep:
            lang, path = "en", spec
        text_index, store, title_index = build_kb_from_jsonl(path,
                                                             lang=lang)
        engines[lang] = RetrievalEngine(
            text_index, store=store, title_index=title_index,
            mode=args.engine_mode, device=engine_device)
    for spec in args.index_dir or []:
        text_index, store, title_index, lang = load_kb(
            spec.split("=", 1)[-1])
        engines[lang] = RetrievalEngine(
            text_index, store=store, title_index=title_index,
            mode=args.engine_mode, device=engine_device)
    if not engines:
        raise SystemExit("--route mix needs --kb lang=path / --index_dir "
                         "entries")
    mix = None
    if single_dispatch:
        try:
            mix = MixEngine(engines, device=args.device)
        except ValueError as err:  # e.g. an index without doc lengths
            log.warning("MixEngine unavailable (%s); using the per-engine "
                        "fan-out", err)
            engines = {lang: RetrievalEngine(
                e.text_index, store=e.store, title_index=e.title_index,
                mode=args.engine_mode, device=args.device)
                for lang, e in engines.items()}

    def run_search(records, entities):
        queries = [sentence_query(r, "mix") for r in records]
        starts = range(0, len(queries), RETRIEVE_BATCH)
        batches = [queries[i:i + RETRIEVE_BATCH] for i in starts]
        if mix is not None:
            rows = [row for done in mix.search_texts_stream(batches,
                                                            k=args.k)
                    for row in done]
        else:
            rows = [row for i, b in zip(starts, batches)
                    for row in mix_search(
                        engines, b, k=args.k, entity_queries=(
                            entities[i:i + RETRIEVE_BATCH]
                            if args.with_entity else None))]
        return [[doc for _, doc in row] for row in rows]
    return run_search


def cmd_retrieve(args) -> Dict[str, Dict[str, float]]:
    """Search every sentence of ``--data_folder``'s train/dev/test.txt in
    the KB and write, per split, ``<split>.retrieval.tsv`` and the
    context-fused ``<split>.txt`` under ``--out``. Returns per split the
    sentence count and the seconds of its stages (read, seeds, retrieve,
    rerank, write, fuse)."""
    from .data.conll import SentenceRecord
    from .retrieval.fusion import extract_entities, fuse_contexts
    from .retrieval.pipeline import sentence_query, write_retrieval_file
    from .retrieval.rerank import rerank_by_edit_distance

    _setup_logging(None)
    if args.rerank == "bertscore" and not args.model_config:
        raise SystemExit("--rerank bertscore needs --model_config (the "
                         "encoder supplying the token embeddings)")
    run_search = (_mix_search_fn(args) if args.route == "mix"
                  else _single_search_fn(args))
    # the fusion budget is measured with the training tokenizer: the
    # experiment config's, an HF tokenizer directory, else a hash proxy
    if args.tokenizer_config:
        tokenizer = ServeConfig.from_file(
            args.tokenizer_config).make_tokenizer()
    elif args.hf_tokenizer:
        tokenizer = HFTokenizer(args.hf_tokenizer)
    else:
        log.warning("no --tokenizer_config/--hf_tokenizer: the fusion "
                    "budget uses a 250002-entry hash tokenizer")
        tokenizer = HashTokenizer(vocab_size=250002)
    # a trained model predicts the entity seeds of dev and test (train
    # keeps its gold entities) and embeds for BERTScore
    predictor = None
    if args.model_config and (args.with_entity
                              or args.rerank == "bertscore"):
        predictor = _predictor(args.model_config, args.device)

    data_dir, out_dir = Path(args.data_folder), Path(args.out)
    stats: Dict[str, Dict[str, float]] = {}
    for split in ("train", "dev", "test"):
        f = data_dir / f"{split}.txt"
        if not f.exists():
            continue
        t = {}
        clock = time.perf_counter()

        def lap(name):
            nonlocal clock
            now = time.perf_counter()
            t[name] = now - clock
            clock = now

        records = read_column_file(f, {0: "text", 1: "ner"},
                                   comment_symbol=args.comment_symbol)
        lap("read")
        entities = None
        if args.with_entity:
            if predictor is not None and split != "train":
                preds = predictor.predict(records)
                entities = [extract_entities(SentenceRecord(
                    tokens=r.tokens, tags={"ner": p}))
                    for r, p in zip(records, preds)]
                log.info("%s: predicted entity seeds for %d sentences",
                         split, len(records))
            else:
                entities = [extract_entities(r) for r in records]
        lap("seeds")
        results = run_search(records, entities)
        lap("retrieve")
        if args.rerank == "edit":
            results = [rerank_by_edit_distance(sentence_query(r, args.lang),
                                               docs)
                       for r, docs in zip(records, results)]
        elif args.rerank == "bertscore":
            results = _rerank_bertscore(
                predictor, [sentence_query(r, args.lang) for r in records],
                results)
        if args.rerank:
            log.info("%s: reranked contexts by %s", split, args.rerank)
        lap("rerank")
        write_retrieval_file(out_dir / f"{split}.retrieval.tsv", records,
                             results, args.lang, entities=entities)
        if args.distant_out and split == "train":
            from .retrieval.distant import distant_supervision

            silver = distant_supervision(records, results)
            write_column_file(Path(args.distant_out), silver,
                              layers=("ner",))
            log.info("distant supervision: %d silver sentences -> %s",
                     len(silver), args.distant_out)
        lap("write")
        fused = fuse_contexts(records, results, tokenizer, mode=args.mode,
                              drop_over_budget_train=(split == "train"))
        write_column_file(out_dir / f"{split}.txt", fused, layers=("ner",))
        lap("fuse")
        stats[split] = {"sentences": len(records), **t}
        log.info("%s: %d sentences fused; seconds %s", split, len(fused),
                 ", ".join(f"{k} {v:.2f}" for k, v in t.items()))
    return stats


def cmd_multistage(args) -> List[dict]:
    """Staged fine-tuning over the stage configs in order: each stage
    trains as ``cli train`` does and exports its tuned encoder, and the
    next stage's encoder starts from that export. Returns each stage's
    training result."""
    from .retrieval.iterative import run_multistage

    _setup_logging(None)

    def build(path, encoder_init):
        config = ExperimentConfig.from_file(path)
        trainer = _build(config, args.device)
        if encoder_init is not None:
            trainer.load_encoder(encoder_init)
            log.info("stage %s starts from the encoder %s", path,
                     encoder_init)
        return (trainer, config.make_train_config(),
                config.resolve_target_dir())

    results = run_multistage(list(args.configs), build)
    for i, r in enumerate(results):
        log.info("stage %d best dev score: %s", i + 1, r["best_dev_score"])
    return results


def _sniff_column_format(train_file: Path) -> Dict[int, str]:
    """Column layout of a CoNLL file: the first column is the text, the
    last the ner tags (MultiCoNER ships 4 columns text/pos/upos/ner, the
    fixtures 2); middle columns get placeholder names."""
    names = {2: ["text", "ner"], 4: ["text", "pos", "upos", "ner"]}
    with open(train_file, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            n = len(line.split())
            cols = names.get(n, ["text"] + [f"c{i}" for i in range(
                1, n - 1)] + ["ner"])
            return {i: c for i, c in enumerate(cols)}
    raise ValueError(f"no data lines in {train_file}")


def cmd_parity(args) -> Optional[dict]:
    """The one-command F1-parity run of the recipe: stage 1 fine-tunes on
    the multilingual folder and exports its encoder, stage 2 fine-tunes
    on the EN folder from that export, then the EN test predictions go
    through conlleval's span F1. With ``--weights`` the encoder starts
    from that HF checkpoint directory, with its own tokenizer where the
    directory holds tokenizer files (``tokenizer.json``; one with only
    ``sentencepiece.bpe.model`` raises) and ``--hash_tokenizer`` is not
    given, else with the hash tokenizer (a rehearsal whose F1 does not
    compare with the reference's); without it, from a random
    ``--encoder`` of a named size. Skips with a message and a JSON line
    when the weights or a data folder are missing. Writes and prints
    ``parity.json``; returns the summary (None when skipped)."""
    from .eval.conlleval import conll_evaluate

    out = Path(args.out)
    _setup_logging(out)

    def skip(msg):
        print(f"[parity] SKIP: {msg}")
        print(json.dumps({"parity": "skipped", "reason": msg}))

    weights_dir = Path(args.weights) if args.weights else None
    enc_spec, enc_weights = args.encoder, None
    tok_cfg = {"type": "hash", "vocab_size": args.hash_vocab}
    if weights_dir is not None:
        if not (weights_dir / "config.json").exists():
            return skip(
                f"no HF encoder checkpoint at {weights_dir} (need "
                "config.json + model.safetensors/pytorch_model.bin + "
                "sentencepiece tokenizer); place a local xlm-roberta-large "
                "export there")
        enc_spec = enc_weights = str(weights_dir)
        has_tok = any((weights_dir / f).exists() for f in (
            "sentencepiece.bpe.model", "tokenizer.json"))
        if has_tok and not args.hash_tokenizer:
            # the checkpoint's own tokenizer (a directory with only
            # sentencepiece.bpe.model raises when the stages build it)
            tok_cfg = {"type": "hf", "dir": str(weights_dir)}
        else:
            # hash ids index the checkpoint's larger embedding safely; F1
            # numbers are then not reference-comparable
            log.warning("[parity] hash tokenizer with checkpoint weights: "
                        "rehearsal mode, F1 not reference-comparable")

    data = Path(args.data)
    stage1_dir = data / args.stage1_folder
    stage2_dir = data / args.stage2_folder
    for d, what in ((stage1_dir, "stage-1 multilingual"),
                    (stage2_dir, "stage-2 EN monolingual")):
        if not (d / "train.txt").exists():
            return skip(
                f"{what} data folder missing: {d}/train.txt "
                "(expected MultiCoNER *_conll_rank_eos_doc_full_wiki_v3 "
                "layout with train/dev/test.txt)")

    def stage_config(name, folder, epochs, target):
        return ExperimentConfig.from_dict({
            "name": name,
            "corpora": [{
                "name": name,
                "data_folder": str(folder),
                "column_format": _sniff_column_format(folder / "train.txt"),
                "comment_symbol": "# id",
                "tag_to_bioes": "ner",
            }],
            "tokenizer": tok_cfg,
            # a checkpoint encoder trains under remat, as the reference's
            # 550M fine-tune does
            "model": {"encoder": enc_spec, "use_crf": True,
                      "locked_dropout": 0.0, "word_dropout": 0.1,
                      **({"encoder_weights": enc_weights, "remat": True,
                          "remat_policy": "dots_saveable"}
                         if enc_weights else {})},
            # the reference stage recipes: lr 5e-6, head lr x10000
            "train": {"learning_rate": args.lr, "lr_rate": args.lr_rate,
                      "batch_size": args.batch_size,
                      "accumulation_steps": args.accumulation_steps,
                      "max_epochs": epochs,
                      "save_finetuned_encoder": True},
            "trainer": "ModelFinetuner",
            "target_dir": str(target),
        })

    cfg1 = stage_config("parity-stage1-multi", stage1_dir,
                        args.epochs_stage1, out / "stage1")
    trainer1 = _build(cfg1, args.device)
    log.info("[parity] stage 1 (multilingual) on %s ...", stage1_dir)
    r1 = trainer1.train(out / "stage1", cfg1.make_train_config())
    enc_path = out / "stage1" / "finetuned-encoder.msgpack"
    log.info("[parity] stage 1 best dev %.4f; encoder export %s",
             r1["best_dev_score"], enc_path)
    del trainer1

    cfg2 = stage_config("parity-stage2-en", stage2_dir,
                        args.epochs_stage2, out / "stage2")
    trainer2 = _build(cfg2, args.device)
    if enc_path.exists():
        trainer2.load_encoder(enc_path)
        log.info("[parity] stage 2 init from %s", enc_path)
    log.info("[parity] stage 2 (EN) on %s ...", stage2_dir)
    r2 = trainer2.train(out / "stage2", cfg2.make_train_config())

    results = trainer2.final_test(out / "stage2",
                                  batch_size=args.batch_size)
    tsv = out / "stage2" / "test.parity-stage2-en.tsv"
    recs = (read_column_file(tsv, {0: "text", 1: "gold", 2: "pred"})
            if tsv.exists() else [])
    f1 = (conll_evaluate([r.tags["gold"] for r in recs],
                         [r.tags["pred"] for r in recs],
                         remove_x=True).micro_f1() if recs else -1.0)
    summary = {
        "parity": "ran",
        "stage1_best_dev": r1["best_dev_score"],
        "stage2_best_dev": r2["best_dev_score"],
        "test_results": results,
        "conlleval_micro_f1": round(float(f1), 4),
    }
    (out / "parity.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


def cmd_speed(args) -> Dict[str, float]:
    """The tagger's decode rate over the first test set (else the train
    set), from the best checkpoint when there is one."""
    config = ExperimentConfig.from_file(args.config)
    if config.targets != "ner":
        raise ValueError("cli speed measures the NER tagger decode path; "
                         f"targets: {config.targets} is not supported")
    _setup_logging(None)
    trainer = _build(config, args.device)
    best = config.resolve_target_dir() / "best-model.msgpack"
    if best.exists():
        trainer.load(best)
    records = trainer.corpus.test_list[0] or trainer.corpus.train
    out = {"sentences_per_second": trainer.evaluate_speed(
        records, batch_size=args.batch_size), "n_sentences": len(records)}
    print(json.dumps(out))
    return out


def cmd_ensemble(args) -> None:
    """Majority-vote the prediction files (token and tag columns) into
    ``--out``, on the host."""
    from .eval.ensemble import ensemble_predictions

    _setup_logging(None)
    systems, records = [], None
    for f in args.predictions:
        recs = read_column_file(f, {0: "text", 1: "pred"},
                                comment_symbol=args.comment_symbol)
        systems.append([r.tags["pred"] for r in recs])
        if records is None:
            records = recs
    for rec, tags in zip(records, ensemble_predictions(
            systems, threshold=args.threshold)):
        rec.tags["pred"] = tags
    write_column_file(args.out, records, layers=("pred",))
    log.info("wrote the ensemble of %d systems to %s", len(systems),
             args.out)


def cmd_evaluate(args) -> Dict[str, float]:
    """Span metric of a file of 'token gold pred' lines: the per-class
    table, then a JSON line of micro and macro F1, precision and
    recall."""
    from .eval.metrics import evaluate_spans

    recs = read_column_file(args.predictions,
                            {0: "text", 1: "gold", 2: "pred"},
                            comment_symbol=args.comment_symbol)
    metric = evaluate_spans([r.tags["gold"] for r in recs],
                            [r.tags["pred"] for r in recs])
    out = {"micro_f1": metric.micro_avg_f_score(),
           "macro_f1": metric.macro_avg_f_score(),
           "precision": metric.precision(), "recall": metric.recall()}
    print(metric)
    print(json.dumps(out))
    return out


def serving_tagger(config: ServeConfig, tag_dict: Dictionary,
                   device: str) -> SequenceTagger:
    """The tagger ``cli serve`` runs: the encoder stored in its compute
    dtype, with the weights of the trained checkpoint under the config's
    target directory (cast on load) or random ones from seed 0."""
    tokenizer = config.make_tokenizer()
    ckpt = _trained_checkpoint(config.resolve_target_dir())
    tree = checkpoint.load(ckpt) if ckpt is not None else None
    shape = {}  # what the checkpoint's tree says of the tagger's layout
    if tree is not None:
        params = tree.get("params", tree)
        trans = params.get("transitions")
        if trans is not None and len(trans.shape) == 3:
            shape["num_languages"] = int(trans.shape[0])  # enhanced CRF
        shape["relearn_embeddings"] = "embedding2nn" in params
        shape["transition_attention"] = "sent_to_trans_att" in params
    tagger_cfg = TaggerConfig.for_tag_dictionary(
        config.make_encoder_config(tokenizer), tag_dict,
        use_crf=config.model.get("use_crf", True), **shape)
    tagger = SequenceTagger(tagger_cfg, device=device)
    if tree is None:
        log.warning("no trained checkpoint under %s — serving random-init "
                    "weights", config.resolve_target_dir())
    else:
        tagger.load_state_dict(weights.from_jax_params(tree, tagger_cfg))
        log.info("serving %s", ckpt)
    return tagger.eval()


def cmd_serve(args) -> None:
    """Serve retrieval-augmented NER from config + tag_dictionary.json
    (+ a trained checkpoint); the training corpus is not read."""
    config = ServeConfig.from_file(args.config)
    if config.targets != "ner":
        raise ValueError("cli serve serves the NER tagger; "
                         f"targets: {config.targets} is not supported")
    tag_dict_path = config.resolve_target_dir() / "tag_dictionary.json"
    if not tag_dict_path.exists():
        raise ValueError(
            f"{tag_dict_path} not found — serving reconstructs the label "
            "space from the tag dictionary persisted at train time")
    tag_dict = Dictionary.load(tag_dict_path)
    tokenizer = config.make_tokenizer()
    tagger = serving_tagger(config, tag_dict, args.device)

    engine = None
    if args.kb or args.index_dir:
        # the engine holds the title field in either mode, as the
        # reference's does; serving itself searches the text field
        text_index, store, title_index = _open_kb(args)
        engine = RetrievalEngine(text_index, store=store,
                                 title_index=title_index,
                                 mode=args.engine_mode, device=args.device)

    def flush(batch):
        for resp in serve(batch, engine, tagger, tokenizer, tag_dict,
                          k=args.k, mode=args.mode,
                          batch_size=args.batch_size,
                          tag_layer=config.tag_layer):
            print(json.dumps(resp), flush=True)

    batch = []
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        batch.append(json.loads(line))
        if len(batch) >= args.batch_size:
            flush(batch)
            batch = []
    if batch:
        flush(batch)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="kbner_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name, fn):
        sp = sub.add_parser(name)
        sp.add_argument("--config", required=True)
        sp.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
        sp.set_defaults(fn=fn)
        return sp

    add("train", cmd_train)
    add("test", cmd_test)
    sp = add("parse", cmd_parse)
    sp.add_argument("--target_dir", required=True,
                    help="a column file, or a folder of *.txt column files")
    sp.add_argument("--out_dir")
    sp.add_argument("--keep_order", action="store_true")
    sp.add_argument("--save_embedding", action="store_true")
    sp = add("serve", cmd_serve)
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--kb", help="parsed-wiki JSONL, built at start")
    sp.add_argument("--index_dir", help="a saved KB from `index`")
    sp.add_argument("--store", help="with --kb: keep the payloads in a "
                    "packed doc store at this path")
    sp.add_argument("--lang", default="en")
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--mode", default="sentence_link")
    sp.add_argument("--engine_mode", default="exhaustive",
                    help="exhaustive (default) or pruned")

    sp = add("speed", cmd_speed)
    sp.add_argument("--batch_size", type=int, default=32)

    sp = sub.add_parser("ensemble")
    sp.add_argument("predictions", nargs="+",
                    help="prediction files (token pred columns)")
    sp.add_argument("--out", required=True)
    sp.add_argument("--threshold", type=float, default=None)
    sp.add_argument("--comment_symbol", default="# id")
    sp.set_defaults(fn=cmd_ensemble)

    sp = sub.add_parser("evaluate")
    sp.add_argument("predictions", help="file with 'token gold pred' lines")
    sp.add_argument("--comment_symbol", default="# id")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser(
        "parity", help="stage-1 multilingual -> stage-2 EN -> predict -> "
        "conlleval (skips when weights or data are absent)")
    sp.add_argument("--weights", default=None,
                    help="local HF xlm-roberta checkpoint directory "
                         "(config.json + safetensors/bin); omit for a "
                         "random --encoder")
    sp.add_argument("--data", required=True,
                    help="root holding the stage data folders")
    sp.add_argument("--out", required=True)
    sp.add_argument("--stage1_folder",
                    default="MULTI_Multilingual_conll_rank_eos_doc_full_"
                            "wiki_v3")
    sp.add_argument("--stage2_folder",
                    default="EN-English_conll_rank_eos_doc_full_wiki_v3")
    sp.add_argument("--encoder", default="tiny",
                    help="encoder when --weights is absent: tiny/base/large")
    sp.add_argument("--hash_vocab", type=int, default=4096)
    sp.add_argument("--hash_tokenizer", action="store_true",
                    help="force the hash tokenizer even with --weights "
                         "(550M rehearsal mode; F1 not comparable)")
    sp.add_argument("--epochs_stage1", type=int, default=3)
    sp.add_argument("--epochs_stage2", type=int, default=10)
    sp.add_argument("--batch_size", type=int, default=8)
    sp.add_argument("--accumulation_steps", type=int, default=1)
    sp.add_argument("--lr", type=float, default=5e-6)
    sp.add_argument("--lr_rate", type=float, default=10000,
                    help="head-lr multiplier (reference: 10000 at lr 5e-6)")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_parity)

    sp = sub.add_parser("multistage")
    sp.add_argument("configs", nargs="+",
                    help="stage configs in order; each stage's tuned "
                         "encoder starts the next")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_multistage)

    sp = sub.add_parser("index")
    sp.add_argument("--kb", required=True, help="parsed-wiki JSONL")
    sp.add_argument("--out", required=True, help="KB directory to write")
    sp.add_argument("--lang", default="en")
    sp.add_argument("--kb_fail_file", default=None,
                    help="append unparseable KB lines here and go on")
    sp.add_argument("--ik_dict", default=None,
                    help="zh only: an IK dictionary (a word per line) or "
                         "'builtin' for the shipped word list; copied into "
                         "the KB directory")
    sp.add_argument("--ik_smart", action="store_true",
                    help="zh only: ik_smart instead of ik_max_word")
    sp.set_defaults(fn=cmd_index)

    sp = sub.add_parser("ingest-dump")
    sp.add_argument("--dump", required=True,
                    help="MediaWiki pages-articles.xml[.bz2] export")
    sp.add_argument("--out", required=True, help="output JSONL path")
    sp.add_argument("--lang", default="en")
    sp.add_argument("--paragraph", default="all", choices=["all", "first"])
    sp.add_argument("--max_pages", type=int, default=None)
    sp.set_defaults(fn=cmd_ingest_dump)

    sp = sub.add_parser("retrieve")
    sp.add_argument("--kb", action="append", help="parsed-wiki JSONL")
    sp.add_argument("--index_dir", action="append",
                    help="a saved KB from `index`")
    sp.add_argument("--route", default="single", choices=("single", "mix"),
                    help="mix: fan every query out to every language KB "
                         "(--kb lang=path, --index_dir lang=dir, "
                         "repeatable) and merge by score")
    sp.add_argument("--data_folder", required=True,
                    help="folder of train/dev/test.txt column files")
    sp.add_argument("--out", required=True)
    sp.add_argument("--lang", default="en")
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--mode", default="sentence_link",
                    choices=["paragraph", "sentence_link", "sentence"])
    sp.add_argument("--with_entity", action="store_true",
                    help="add the sentence's entities as title-boosted "
                         "clauses (gold on train; predicted on dev/test "
                         "with --model_config)")
    sp.add_argument("--model_config",
                    help="a trained model's config: predicts the entity "
                         "seeds of dev/test and embeds for bertscore")
    sp.add_argument("--engine_mode", default="exhaustive",
                    choices=["exhaustive", "pruned"])
    sp.add_argument("--comment_symbol", default="# id")
    sp.add_argument("--tokenizer_config",
                    help="experiment config whose tokenizer measures the "
                         "fusion budget")
    sp.add_argument("--distant_out", default=None,
                    help="also write silver sentences: the train split's "
                         "gold entity spans projected onto its contexts")
    sp.add_argument("--rerank", default=None, choices=("edit", "bertscore"))
    sp.add_argument("--store", default=None,
                    help="with --kb: keep the payloads in a packed doc "
                         "store at this path")
    sp.add_argument("--kb_fail_file", default=None,
                    help="append unparseable KB lines here and go on")
    sp.add_argument("--hf_tokenizer", default=None,
                    help="local HF tokenizer dir (overrides the hash "
                         "proxy for the 510-subtoken fusion budget)")
    sp.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_retrieve)
    return parser


def main(argv: Optional[List[str]] = None):
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
