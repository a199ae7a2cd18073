"""The knowledge base of a configuration, made once per checkout.

``ensure_docs`` draws the documents (``kbgen.synth_wiki_docs`` with the
configuration's ``kb`` parameters) into ``<cache>/kb-<n_docs>-<n_topics>-
<seed>/`` (``portbench/.cache`` in a run) as ``docs.npy`` and
``ent_vocab.npy``: the raw data that the program's index and the
reference both read. ``ensure_saved_kb`` builds the program's KB from them
(a text and a title index and a packed document store, saved with
``save_kb``) under ``kb/`` in the same directory, as ``cli index`` would,
so that a run serves it through ``load_kb`` as ``cli serve --index_dir``
does. Each is written under a fixed ``.partial`` name and renamed when
whole; a half-written one left by a killed run is removed.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Tuple

import numpy as np

from . import kbgen
from .cell import log

def kb_dir(kb: dict, cache: Path) -> Path:
    return cache / f"kb-{kb['n_docs']}-{kb['n_topics']}-{kb['seed']}"


def _generate(kb: dict):
    return kbgen.synth_wiki_docs(
        kb["n_docs"], vocab=kb["vocab"], zipf_s=kb["zipf_s"],
        mean_len=kb["mean_len"], sigma=kb["len_sigma"],
        min_len=kb["min_len"], max_len=kb["max_len"], seed=kb["seed"],
        n_topics=kb["n_topics"], entity_frac=kb["entity_frac"],
        entities_per_topic=kb["entities_per_topic"])


def ensure_docs(kb: dict, cache: Path) -> Path:
    d = kb_dir(kb, cache)
    if (d / "ent_vocab.npy").exists():
        return d
    t0 = time.perf_counter()
    d.mkdir(parents=True, exist_ok=True)
    docs, _, topics = _generate(kb)
    for name, arr in (("docs", docs), ("ent_vocab", topics.ent_vocab)):
        part = d / f"{name}.partial.npy"
        np.save(part, arr)
        part.rename(d / f"{name}.npy")
    log(f"kb: drew {kb['n_docs']} documents in "
        f"{time.perf_counter() - t0:.1f} s (first run of this checkout)")
    return d


def topic_model(kb: dict, d: Path) -> kbgen.TopicModel:
    return kbgen.TopicModel(kb["vocab"], kb["zipf_s"], kb["entity_frac"],
                            np.load(d / "ent_vocab.npy"))


def docs(d: Path) -> np.ndarray:
    return np.load(d / "docs.npy", mmap_mode="r")


def ensure_saved_kb(kb: dict, cache: Path) -> Tuple[Path, bool]:
    """``(the saved KB's directory, whether this call built it)``."""
    d = ensure_docs(kb, cache)
    out = d / "kb"
    if (out / "meta.json").exists():
        return out, False
    from kbner_tpu_torch.retrieval.docstore import PackedDocStore
    from kbner_tpu_torch.retrieval.index import BM25Index
    from kbner_tpu_torch.retrieval.pipeline import save_kb

    t0 = time.perf_counter()
    part = d / "kb.partial"
    shutil.rmtree(part, ignore_errors=True)
    part.mkdir()
    tok = np.load(d / "docs.npy")
    vocab = {f"w{i}": i for i in range(int(tok.max()) + 1)}
    text = BM25Index.build_encoded(tok, vocab)
    title = BM25Index.build_encoded(np.ascontiguousarray(tok[:, :2]), vocab)
    rows = ((s, s, kbgen.title_of(r), f"https://en.wikipedia.org/wiki/Doc_{i}")
            for i, r in enumerate(tok) for s in (kbgen.render(r),))
    store = PackedDocStore.build(part / "kb.docs", rows)
    save_kb(part, text, store, title)
    store.close()
    part.rename(out)
    log(f"kb: indexed and saved {kb['n_docs']} documents in "
        f"{time.perf_counter() - t0:.1f} s (first run of this checkout)")
    return out, True
