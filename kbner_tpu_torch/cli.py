"""Command line of the PyTorch port (counterpart of ``kbner_tpu/cli.py``):

    python -m kbner_tpu_torch.cli train --config CONFIG.yaml
    python -m kbner_tpu_torch.cli test  --config CONFIG.yaml
    python -m kbner_tpu_torch.cli parse --config CONFIG.yaml --target_dir D
    python -m kbner_tpu_torch.cli serve --config CONFIG.yaml --kb KB.jsonl

``train`` fine-tunes the NER tagger on the config's column corpora
(``FinetuneTrainer``; the other trainers and the parser targets wait for
ROADMAP A6) and tests the best model; ``test`` evaluates the best (else
final) model on the test sets; ``parse`` tags every ``*.txt`` column file
of a folder (or one file) into ``<stem>.conllu`` with a ``pred`` column.
``serve`` reads JSONL requests on stdin and writes JSONL responses on
stdout, one micro-batch of ``--batch_size`` requests at a time, with the
request and response schema of ``kbner_tpu.cli serve`` (see :mod:`.serve`),
from the trained ``best-model.msgpack`` (else ``final-model.msgpack``) that
either package wrote, or from random weights when there is none. Every
command runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import List, Optional

from . import checkpoint, weights
from .config import ExperimentConfig, ServeConfig
from .data.conll import read_column_file, write_column_file
from .data.dictionary import Dictionary
from .models.tagger import SequenceTagger, TaggerConfig
from .retrieval.engine import RetrievalEngine
from .retrieval.pipeline import build_kb_from_jsonl
from .serve import serve
from .train.trainer import FinetuneTrainer

log = logging.getLogger("kbner_tpu_torch")


def _trained_checkpoint(target_dir: Path) -> Optional[Path]:
    """``best-model.msgpack``, else ``final-model.msgpack``, else None."""
    for name in ("best-model.msgpack", "final-model.msgpack"):
        if (target_dir / name).exists():
            return target_dir / name
    return None


def _build(config: ExperimentConfig, device: str) -> FinetuneTrainer:
    """The NER tagger (float32 master parameters, made from the train
    config's seed) and its trainer over the config's corpora."""
    if config.targets != "ner":
        raise NotImplementedError(
            f"targets: {config.targets}: the parser and classifier "
            "families wait for ROADMAP A6 in kbner_tpu_torch")
    if config.trainer_kind != "finetune":
        raise NotImplementedError(
            f"trainer: {config.trainer}: only the fine-tuning trainer is "
            "ported; distill, ace, swaf and lm wait for ROADMAP A6")
    if config.model.get("encoder_weights"):
        raise NotImplementedError(
            "model.encoder_weights: loading HF XLM-R weights waits for "
            "ROADMAP A6 (load_hf_checkpoint)")
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
    return FinetuneTrainer(
        model, corpus, tokenizer, tag_dict, tag_layer=config.tag_layer,
        stride_windows=config.data.get("stride_windows", False),
        device=device)


def _setup_logging(target_dir: Optional[Path] = None) -> None:
    handlers: List[logging.Handler] = [logging.StreamHandler(sys.stderr)]
    if target_dir is not None:
        target_dir.mkdir(parents=True, exist_ok=True)
        handlers.append(logging.FileHandler(target_dir / "training.log"))
    logging.basicConfig(level=logging.INFO, handlers=handlers, force=True,
                        format="%(asctime)s %(levelname)s %(message)s")


def cmd_train(args) -> None:
    config = ExperimentConfig.from_file(args.config)
    target_dir = config.resolve_target_dir()
    _setup_logging(target_dir)
    trainer = _build(config, args.device)
    result = trainer.train(target_dir, config.make_train_config())
    log.info("best dev score: %s", result["best_dev_score"])
    trainer.final_test(target_dir)


def cmd_test(args) -> None:
    config = ExperimentConfig.from_file(args.config)
    target_dir = config.resolve_target_dir()
    _setup_logging(target_dir)
    results = _build(config, args.device).final_test(target_dir)
    print(json.dumps(results, indent=2))


def cmd_parse(args) -> None:
    config = ExperimentConfig.from_file(args.config)
    target_dir = config.resolve_target_dir()
    _setup_logging(None)
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
    data_dir = Path(args.target_dir)
    files = sorted(data_dir.glob("*.txt")) if data_dir.is_dir() else [
        data_dir]
    out_dir = Path(args.out_dir) if args.out_dir else (
        data_dir if data_dir.is_dir() else data_dir.parent)
    for f in files:
        records = read_column_file(f, spec.column_format,
                                   comment_symbol=spec.comment_symbol)
        preds = trainer.predict(records, sort_by_length=not args.keep_order)
        for rec, pred in zip(records, preds):
            rec.tags["pred"] = pred
        out = out_dir / (f.stem + ".conllu")
        write_column_file(out, records, layers=("pred",))
        log.info("wrote %s", out)


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
    if args.index_dir or args.store:
        raise NotImplementedError(
            "--index_dir and --store wait for a later slice of "
            "kbner_tpu_torch; build the KB in memory with --kb")
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
    if args.kb:
        # the engine holds the title field in either mode, as the
        # reference's does; serving itself searches the text field
        text_index, store, title_index = build_kb_from_jsonl(
            args.kb, lang=args.lang)
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
    sp.add_argument("--kb")
    sp.add_argument("--index_dir")
    sp.add_argument("--store")
    sp.add_argument("--lang", default="en")
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--mode", default="sentence_link")
    sp.add_argument("--engine_mode", default="exhaustive",
                    help="exhaustive (default) or pruned")
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
