"""BM25 index, retrieval engines, context fusion, KB build (the package
surface of ``kbner_tpu.retrieval``)."""
from .analyzer import cjk_analyze, get_analyzer, standard_analyze
from .index import BM25Index, BM25Params, quantize_doc_length
from .engine import (DocStore, MixEngine, RetrievalEngine, RetrievedDoc,
                     mix_search)
from .distant import (distant_supervision, match_entity_count,
                      rank_contexts_jaccard)
from .docstore import PackedDocStore, PackedDocStoreWriter
from .dump import dump_to_jsonl, iter_dump_pages, wikitext_to_paragraphs

__all__ = [
    "dump_to_jsonl",
    "iter_dump_pages",
    "wikitext_to_paragraphs",
    "standard_analyze",
    "cjk_analyze",
    "get_analyzer",
    "BM25Index",
    "BM25Params",
    "quantize_doc_length",
    "DocStore",
    "distant_supervision",
    "match_entity_count",
    "rank_contexts_jaccard",
    "PackedDocStore",
    "PackedDocStoreWriter",
    "MixEngine",
    "RetrievalEngine",
    "RetrievedDoc",
    "mix_search",
]
