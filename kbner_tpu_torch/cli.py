"""Command line of the PyTorch port (counterpart of ``kbner_tpu/cli.py``;
this slice carries ``serve``).

    python -m kbner_tpu_torch.cli serve --config CONFIG.yaml --kb KB.jsonl

reads JSONL requests on stdin and writes JSONL responses on stdout, one
micro-batch of ``--batch_size`` requests at a time, with the request and
response schema of ``kbner_tpu.cli serve`` (see :mod:`.serve`). It runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from .config import ServeConfig
from .data.dictionary import Dictionary
from .models.tagger import SequenceTagger, TaggerConfig
from .retrieval.engine import RetrievalEngine
from .retrieval.pipeline import build_kb_from_jsonl
from .serve import serve

log = logging.getLogger("kbner_tpu_torch")


def cmd_serve(args) -> None:
    """Serve retrieval-augmented NER from config + tag_dictionary.json;
    the training corpus is not read."""
    if args.index_dir or args.store:
        raise NotImplementedError(
            "--index_dir and --store wait for a later slice of "
            "kbner_tpu_torch; build the KB in memory with --kb")
    config = ServeConfig.from_file(args.config)
    if config.targets != "ner":
        raise ValueError("cli serve serves the NER tagger; "
                         f"targets: {config.targets} is not supported")
    target_dir = config.resolve_target_dir()
    tag_dict_path = target_dir / "tag_dictionary.json"
    if not tag_dict_path.exists():
        raise ValueError(
            f"{tag_dict_path} not found — serving reconstructs the label "
            "space from the tag dictionary persisted at train time")
    for ckpt in ("best-model.msgpack", "final-model.msgpack"):
        if (target_dir / ckpt).exists():
            raise NotImplementedError(
                f"{target_dir / ckpt}: loading a trained Flax checkpoint "
                "waits for a later slice of kbner_tpu_torch; serve it with "
                "kbner_tpu.cli")
    log.warning("no trained checkpoint under %s — serving random-init "
                "weights", target_dir)
    tag_dict = Dictionary.load(tag_dict_path)
    tokenizer = config.make_tokenizer()
    tagger = SequenceTagger(
        TaggerConfig.for_tag_dictionary(
            config.make_encoder_config(tokenizer), tag_dict,
            use_crf=config.model.get("use_crf", True)),
        device=args.device)
    tagger.eval()

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
    sp = sub.add_parser("serve")
    sp.add_argument("--config", required=True)
    sp.add_argument("--batch_size", type=int, default=32)
    sp.add_argument("--kb")
    sp.add_argument("--index_dir")
    sp.add_argument("--store")
    sp.add_argument("--lang", default="en")
    sp.add_argument("--k", type=int, default=10)
    sp.add_argument("--mode", default="sentence_link")
    sp.add_argument("--engine_mode", default="exhaustive",
                    help="exhaustive (default) or pruned")
    sp.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_serve)
    return parser


def main(argv: Optional[List[str]] = None) -> None:
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
