"""End-to-end KB-NER walkthrough on toy data through kbner_tpu_torch, the
PyTorch/CUDA port (no downloads; the same six steps, paragraphs and toy
corpus as ``examples/end_to_end.py``):
  1. wiki paragraphs -> anchored, sentence-split KB JSONL (parse_text stage)
  2. KB JSONL -> BM25 text+title indices + doc store (build_kb stage)
  3. per-sentence retrieval + context fusion under a subtoken budget
     (generate_data + context_process stages)
  4. fine-tune an XLM-R+CRF tagger on the context-augmented data
  5. iterative (v4) entity-boosted retrieval with the trained model
  6. evaluate span F1 and render an HTML visualization

Run:  PYTHONPATH=. python examples/end_to_end_torch.py [--device cpu]
      [--work_dir DIR]
On an NVIDIA GPU (the default device, ``cuda``) the exhaustive engine
scores every query with the CUDA kernel ``csrc/bm25_score.cu``; on the
CPU with its plain PyTorch twin. For real experiments swap the
HashTokenizer for a saved XLM-R tokenizer directory (``HFTokenizer``) and
load HF weights with ``kbner_tpu_torch.models.load_hf_checkpoint``.
"""

import argparse
import tempfile
from pathlib import Path

from kbner_tpu_torch.data import HashTokenizer, load_column_corpus
from kbner_tpu_torch.models import SequenceTagger, TaggerConfig, XLMRConfig
from kbner_tpu_torch.retrieval import RetrievalEngine
from kbner_tpu_torch.retrieval.fusion import fuse_contexts
from kbner_tpu_torch.retrieval.iterative import entity_retrieval_round
from kbner_tpu_torch.retrieval.pipeline import (
    build_kb_from_jsonl,
    retrieve_for_records,
)
from kbner_tpu_torch.retrieval.wikitext import paragraphs_to_jsonl
from kbner_tpu_torch.train import FinetuneTrainer, TrainConfig
from kbner_tpu_torch.utils.html_viz import render_ner_html

REPO = Path(__file__).resolve().parent.parent

WIKI = [
    {"title": "Berlin", "url": "wiki/Berlin",
     "paragraph": "Berlin is the capital of Germany. It is a big city."},
    {"title": "Paris", "url": "wiki/Paris",
     "paragraph": "Paris is the capital of France."},
    {"title": "Alice Smith", "url": "wiki/Alice_Smith",
     "paragraph": "Alice Smith is a fictional person."},
    {"title": "Acme Corp", "url": "wiki/Acme",
     "paragraph": "Acme Corp is a fictional company in cartoons."},
    {"title": "European Union", "url": "wiki/EU",
     "paragraph": "The European Union is a political union of states."},
]


def kb_and_fused(work: Path, device="cuda") -> dict:
    """Steps 1-3: the KB from ``WIKI`` under ``work``, its exhaustive
    engine on ``device``, and the toy corpus with its train split
    retrieved (k=3) and fused in ``sentence_link`` mode. Returns
    ``n_sentences``, ``engine``, ``corpus``, ``tokenizer`` and the
    train split's ``results``."""
    kb_jsonl = work / "kb.jsonl"
    n = paragraphs_to_jsonl(WIKI, kb_jsonl, lang="en")
    text_index, store, title_index = build_kb_from_jsonl(kb_jsonl)
    engine = RetrievalEngine(text_index, store=store,
                             title_index=title_index, device=device)
    print(f"KB: {n} sentences indexed")

    corpus = load_column_corpus(
        REPO / "tests/fixtures/ner_toy", {0: "text", 1: "ner"},
        comment_symbol="# id")
    tokenizer = HashTokenizer(vocab_size=997)
    results = retrieve_for_records(engine, corpus.train, k=3)
    corpus.train[:] = fuse_contexts(
        corpus.train, results, tokenizer, mode="sentence_link")
    print("fused example:", " ".join(corpus.train[0].tokens))
    return dict(n_sentences=n, engine=engine, corpus=corpus,
                tokenizer=tokenizer, results=results)


def main(device="cuda", work_dir=None) -> dict:
    """All six steps on ``device``, the files under ``work_dir`` (a new
    temporary directory when None). Returns steps 1-3's ``n_sentences``
    and ``results``, the fused train records (``fused``), the v4 dev
    records (``v4``), the train span ``f1`` and the ``work`` directory."""
    work = Path(work_dir or tempfile.mkdtemp(prefix="kbner_demo_"))
    work.mkdir(parents=True, exist_ok=True)

    # 1-3: KB construction, retrieval and fusion
    kb = kb_and_fused(work, device)
    engine, corpus, tokenizer = kb["engine"], kb["corpus"], kb["tokenizer"]

    # 4: fine-tune
    tag_dict = corpus.make_tag_dictionary("ner")
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=1000), tag_dict,
        locked_dropout=0.0, word_dropout=0.0)
    model = SequenceTagger(cfg, device=device, seed=0)
    trainer = FinetuneTrainer(model, corpus, tokenizer, tag_dict,
                              device=device)
    trainer.train(work / "run", TrainConfig(
        learning_rate=1e-3, lr_rate=1.0, batch_size=4, max_epochs=30))

    # 5: iterative (v4) round with predicted entities
    fused_v4 = entity_retrieval_round(
        engine, trainer, corpus.dev, tokenizer, k=3)
    print("v4 fused dev example:", " ".join(fused_v4[0].tokens))

    # 6: evaluate + visualize
    metric, _ = trainer.evaluate(corpus.train)
    f1 = metric.micro_avg_f_score()
    print(f"train span F1: {f1:.3f}")
    (work / "ner.html").write_text(render_ner_html(corpus.train[:3]))
    print(f"artifacts in {work}")
    return dict(n_sentences=kb["n_sentences"], results=kb["results"],
                fused=list(corpus.train), v4=fused_v4, f1=f1, work=work)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--work_dir", default=None)
    args = ap.parse_args()
    main(device=args.device, work_dir=args.work_dir)
