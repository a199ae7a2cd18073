"""Host-side data: sentence records, tag dictionaries, subword encoding
(the package surface of ``kbner_tpu.data``)."""
from .dictionary import Dictionary, make_tag_dictionary
from .conll import (
    Corpus,
    ListCorpus,
    SentenceRecord,
    EOS_MARKER,
    X_LABEL,
    load_column_corpus,
    read_column_file,
    read_fasttext_file,
    write_column_file,
)
from .subword import (HashTokenizer, HFTokenizer, SubwordTokenizer,
                      subtoken_length)
from .encode import (
    EncodedBatch,
    add_classic_features,
    build_char_vocab,
    build_word_vocab,
    encode_batch,
    kmeans,
    make_batches,
)
from .corpora import CORPUS_REGISTRY, corpus_spec
from .doc_context import make_doc_context_records, strip_doc_context
from .tag_schemes import (
    TagSpan,
    bioes_to_bio,
    get_spans,
    iob2,
    iob_iobes,
    to_bioes,
)

__all__ = [
    "Dictionary",
    "make_tag_dictionary",
    "Corpus",
    "ListCorpus",
    "SentenceRecord",
    "EOS_MARKER",
    "X_LABEL",
    "load_column_corpus",
    "read_column_file",
    "write_column_file",
    "TagSpan",
    "bioes_to_bio",
    "get_spans",
    "iob2",
    "iob_iobes",
    "to_bioes",
    "HashTokenizer",
    "HFTokenizer",
    "SubwordTokenizer",
    "subtoken_length",
]
