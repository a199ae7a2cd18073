"""The KB's offline stage (counterpart of ``kbner_tpu/retrieval/pipeline.py``):
building a KB from parsed-wiki JSONL, saving and opening it, per-sentence
retrieval over a corpus split, and the retrieval file.

The retrieval file is the reference's: per sentence, the query line, then
one line per retrieved context ``sentence \\t paragraph \\t title \\t score
\\t url \\t hits``, then a blank line. A KB directory holds ``text.idx`` and
``title.idx`` (``BM25Index.save`` pickles), ``kb.docs`` (a
:class:`~.docstore.PackedDocStore`), ``meta.json`` and, for a zh KB indexed
with an IK dictionary, its copy ``ik.dic``; either package opens what the
other saved.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from ..data.conll import SentenceRecord
from .analyzer import builtin_zh_lexicon, get_analyzer, highlight_hits
from .docstore import PackedDocStore, PackedDocStoreWriter
from .engine import DocStore, RetrievalEngine, RetrievedDoc
from .fusion import extract_entities
from .index import BM25Index, BM25Params

log = logging.getLogger("kbner_tpu_torch")

_CJK_SPACE_RE = re.compile(
    r"(?<=[⺀-鿿가-힯豈-﫿]) "
    r"(?=[⺀-鿿가-힯豈-﫿])")


def clean_cjk_spaces(text: str) -> str:
    """Remove the spaces between CJK characters (the zh/mix query
    cleanup)."""
    prev = None
    while prev != text:
        prev = text
        text = _CJK_SPACE_RE.sub("", text)
    return text


def sentence_query(record: SentenceRecord, lang: str = "en") -> str:
    """The query of a sentence: its original tokens joined by spaces."""
    text = " ".join(record.original_tokens())
    if lang in ("zh", "mix"):
        text = clean_cjk_spaces(text)
    return text


def retrieve_for_records(
    engine: RetrievalEngine,
    records: Sequence[SentenceRecord],
    k: int = 10,
    lang: str = "en",
    with_entity: bool = False,
    entities: Optional[Sequence[Sequence[str]]] = None,
    tag_layer: str = "ner",
    batch_size: int = 1024,
) -> List[List[RetrievedDoc]]:
    """Per-sentence BM25 retrieval over a corpus split, ``batch_size``
    queries at a time.

    ``with_entity`` adds title-boosted entity clauses, from ``entities``
    or else from the records' own tags. Sentence-only queries to a pruned
    engine go through its pipelined stream (:meth:`search_texts_stream`);
    every other search is one :meth:`search` per batch.
    """
    queries = [sentence_query(r, lang) for r in records]
    ents: Optional[List[List[str]]] = None
    if with_entity:
        ents = (list(map(list, entities)) if entities is not None
                else [extract_entities(r, tag_layer) for r in records])
    if ents is None and engine.mode == "pruned":
        return engine.search_texts_stream(queries, k=k,
                                          batch_size=batch_size)
    out: List[List[RetrievedDoc]] = []
    for i in range(0, len(queries), batch_size):
        es = ents[i:i + batch_size] if ents is not None else None
        out.extend(engine.search(queries[i:i + batch_size], k=k,
                                 entity_queries=es))
    return out


# -- the retrieval file -------------------------------------------------------

def write_retrieval_file(
    path: str | Path,
    records: Sequence[SentenceRecord],
    results: Sequence[Sequence[RetrievedDoc]],
    lang: str = "en",
    entities: Optional[Sequence[Sequence[str]]] = None,
) -> None:
    """The reference's retrieval file, with its highlight column
    ``text_fragment ---#--- title_fragment``: the sentence query's terms
    wrapped in ``<hit>`` tags in each context, and the entity clause's
    terms in its title (empty without entities, as ES omits a field with
    no match)."""
    analyze = get_analyzer(lang)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for i, (rec, docs) in enumerate(zip(records, results)):
            query = sentence_query(rec, lang)
            f.write(query + "\n")
            q_terms = set(analyze(query))
            ent_terms = (set(analyze(" ".join(entities[i])))
                         if entities is not None and i < len(entities)
                         else set())
            for d in docs:
                hits = (highlight_hits(d.sentence, q_terms) + " ---#--- "
                        + highlight_hits(d.title, ent_terms))
                f.write(f"{d.sentence}\t{d.paragraph}\t{d.title}\t"
                        f"{d.score:.6f}\t{d.url}\t{hits}\n")
            f.write("\n")


def read_retrieval_file(path: str | Path) -> Dict[str, List[RetrievedDoc]]:
    """A retrieval file as query -> ranked contexts (doc ids -1)."""
    out: Dict[str, List[RetrievedDoc]] = {}
    query: Optional[str] = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                query = None
                continue
            if query is None:
                query = line
                out[query] = []
                continue
            parts = line.split("\t") + [""] * 5
            out[query].append(RetrievedDoc(
                doc_id=-1, score=float(parts[3]) if parts[3] else 0.0,
                sentence=parts[0], paragraph=parts[1], title=parts[2],
                url=parts[4]))
    return out


# -- saved KBs ----------------------------------------------------------------

def save_kb(
    dir_path: str | Path,
    text_index: BM25Index,
    store,
    title_index: Optional[BM25Index] = None,
    lang: str = "en",
    ik_dict: Optional[str | Path] = None,
    ik_smart: bool = False,
) -> None:
    """Write a KB directory: ``text.idx`` (and ``title.idx``), ``kb.docs``
    and ``meta.json``. A :class:`PackedDocStore` is copied unless it is
    already the directory's ``kb.docs``; any other store is packed. The
    IK dictionary of a zh KB (``ik_dict``, ``"builtin"`` for the shipped
    one) is copied in as ``ik.dic``, since queries must be segmented as
    the documents were. Open it again with :func:`load_kb`."""
    d = Path(dir_path)
    d.mkdir(parents=True, exist_ok=True)
    text_index.save(d / "text.idx")
    if title_index is not None:
        title_index.save(d / "title.idx")
    if isinstance(store, PackedDocStore):
        if store.path.resolve() != (d / "kb.docs").resolve():
            shutil.copyfile(store.path, d / "kb.docs")
    else:
        PackedDocStore.from_store(d / "kb.docs", store).close()
    meta = {"lang": lang}
    if ik_dict is not None:
        src = builtin_zh_lexicon() if ik_dict == "builtin" else ik_dict
        shutil.copyfile(src, d / "ik.dic")
        meta["ik_dict"] = "ik.dic"
        meta["ik_smart"] = bool(ik_smart)
    (d / "meta.json").write_text(json.dumps(meta))


def load_kb(dir_path: str | Path
            ) -> Tuple[BM25Index, PackedDocStore, Optional[BM25Index], str]:
    """Open a :func:`save_kb` directory: (text index, mmapped doc store,
    title index or None, language), the indices with the language's
    analyzer (the saved IK dictionary's for a zh KB that has one)."""
    d = Path(dir_path)
    meta = json.loads((d / "meta.json").read_text())
    lang = meta.get("lang", "en")
    analyzer = get_analyzer(
        lang, dict_path=(d / meta["ik_dict"] if meta.get("ik_dict")
                         else None),
        smart=meta.get("ik_smart", False))
    text_index = BM25Index.load(d / "text.idx", analyzer=analyzer)
    title_index = (BM25Index.load(d / "title.idx", analyzer=analyzer)
                   if (d / "title.idx").exists() else None)
    return text_index, PackedDocStore(d / "kb.docs"), title_index, lang


# -- building a KB ------------------------------------------------------------

def build_kb_from_jsonl(
    path: str | Path,
    lang: str = "en",
    max_docs: Optional[int] = None,
    params: Optional[BM25Params] = None,
    with_title_index: bool = True,
    store_path: Optional[str | Path] = None,
    fail_path: Optional[str | Path] = None,
    ik_dict: Optional[str | Path] = None,
    ik_smart: bool = False,
) -> Tuple[BM25Index, "DocStore | PackedDocStore", Optional[BM25Index]]:
    """Text (and title) indices and a doc store from parsed-wiki JSONL:
    one object per line with ``title``, ``sentence``, ``paragraph`` and
    ``url`` (the reference's ``parse_text.py`` output). ``sentence`` is the
    searched text field and ``title`` the boosted one; ``paragraph`` and
    ``url`` are stored, not searched.

    ``store_path`` streams the payloads into a :class:`PackedDocStore`
    there instead of holding them in memory. ``fail_path`` appends each
    line that is not a JSON object to that file and goes on; without it
    such a line raises. A zh KB is analyzed by the IK analyzer over
    ``ik_dict`` (``"builtin"`` for the shipped word list; ``ik_smart``
    for ik_smart), else by char bigrams.
    """
    analyzer = get_analyzer(lang, dict_path=ik_dict, smart=ik_smart)
    sentences: List[str] = []
    titles: List[str] = []
    paragraphs: List[str] = []
    urls: List[str] = []
    writer = (PackedDocStoreWriter(store_path)
              if store_path is not None else None)
    n_failed = 0
    fail_f = open(fail_path, "a", encoding="utf-8") if fail_path else None
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                try:
                    obj = json.loads(line)
                    if not isinstance(obj, dict):
                        raise ValueError(f"{path}: record is not an "
                                         f"object: {line!r}")
                except ValueError:
                    if fail_f is None:
                        raise
                    fail_f.write(line if line.endswith("\n")
                                 else line + "\n")
                    n_failed += 1
                    continue
                sentence = obj.get("sentence", "")
                title = obj.get("title", "")
                sentences.append(sentence)
                titles.append(title)
                if writer is not None:
                    writer.add(sentence, obj.get("paragraph", ""), title,
                               obj.get("url", ""))
                else:
                    paragraphs.append(obj.get("paragraph", ""))
                    urls.append(obj.get("url", ""))
                if max_docs is not None and len(sentences) >= max_docs:
                    break
    finally:
        if fail_f is not None:
            fail_f.close()
        if writer is not None:
            writer.close()
    if n_failed:
        log.warning("build_kb_from_jsonl: %d unparseable lines appended to "
                    "%s", n_failed, fail_path)
    text_index = BM25Index.build(sentences, analyzer=analyzer,
                                 params=params)
    title_index = (BM25Index.build(titles, analyzer=analyzer, params=params)
                   if with_title_index else None)
    if writer is not None:
        store: DocStore | PackedDocStore = PackedDocStore(store_path)
    else:
        store = DocStore(sentences=sentences, paragraphs=paragraphs,
                         titles=titles, urls=urls)
    return text_index, store, title_index
