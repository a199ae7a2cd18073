"""CoNLL column files, CoNLL-U and fastText files, and sentence records
(counterpart of ``kbner_tpu/data/conll.py``).

A sentence is a record of token strings and per-layer tag strings. The
``<EOS>`` marker separates the original sentence from retrieved context
tokens; everything from it onward is context. IOB tags convert to BIOES
at read time for the layer named by ``tag_to_bioes``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

from .dictionary import Dictionary, make_tag_dictionary
from .tag_schemes import to_bioes

EOS_MARKER = "<EOS>"
DOCSTART = "-DOCSTART-"
X_LABEL = "X"


@dataclass
class SentenceRecord:
    """One sentence: parallel lists of tokens and tag layers. ``doc_id``
    groups sentences into documents, ``lang_id`` names the source
    corpus, ``labels`` are a classification corpus's sentence labels."""

    tokens: List[str]
    tags: Dict[str, List[str]] = field(default_factory=dict)
    doc_id: int = -1
    lang_id: int = 0
    comment: Optional[str] = None
    labels: List[str] = field(default_factory=list)

    @property
    def eos_index(self) -> int:
        """Token index of the ``<EOS>`` context separator, or -1."""
        try:
            return self.tokens.index(EOS_MARKER)
        except ValueError:
            return -1

    def original_tokens(self) -> List[str]:
        """Tokens of the original sentence (context stripped at <EOS>)."""
        eos = self.eos_index
        return self.tokens[:eos] if eos >= 0 else self.tokens

    def get_tags(self, layer: str) -> List[str]:
        return self.tags[layer]


def read_column_file(
    path: Union[str, Path],
    column_format: Dict[int, str],
    comment_symbol: Optional[str] = None,
    tag_to_bioes: Optional[str] = None,
    document_separator: str = DOCSTART,
    encoding: str = "utf-8",
    max_sentences: Optional[int] = None,
) -> List[SentenceRecord]:
    """Parse a whitespace-column CoNLL file. ``column_format`` maps a
    column index to a layer name and must name one ``'text'`` column;
    ``tag_to_bioes`` names the layer converted from IOB to BIOES. A
    missing tag column reads as ``O``; a line starting with
    ``comment_symbol`` becomes the next sentence's comment."""
    text_col = None
    for idx, name in column_format.items():
        if name == "text":
            text_col = idx
    if text_col is None:
        raise ValueError("column_format must map one column to 'text'")

    tag_layers = [name for name in column_format.values() if name != "text"]
    sentences: List[SentenceRecord] = []
    doc_id = 0
    cur_tokens: List[str] = []
    cur_tags: Dict[str, List[str]] = {layer: [] for layer in tag_layers}
    cur_comment: Optional[str] = None

    def flush():
        nonlocal cur_tokens, cur_tags, cur_comment
        if cur_tokens:
            rec = SentenceRecord(tokens=cur_tokens, tags=dict(cur_tags),
                                 doc_id=doc_id, comment=cur_comment)
            if tag_to_bioes and tag_to_bioes in rec.tags:
                rec.tags[tag_to_bioes] = to_bioes(rec.tags[tag_to_bioes])
            sentences.append(rec)
        cur_tokens = []
        cur_tags = {layer: [] for layer in tag_layers}
        cur_comment = None

    with open(path, encoding=encoding) as f:
        for line in f:
            line = line.rstrip("\n")
            if comment_symbol is not None and line.startswith(comment_symbol):
                cur_comment = line
                continue
            if not line.strip():
                flush()
                if max_sentences is not None and len(sentences) >= max_sentences:
                    return sentences[:max_sentences]
                continue
            fields = line.split()
            token = fields[text_col] if text_col < len(fields) else ""
            if token == document_separator:
                flush()
                doc_id += 1
                continue
            if not token:
                continue
            cur_tokens.append(token)
            for idx, name in column_format.items():
                if name != "text":
                    cur_tags[name].append(
                        fields[idx] if idx < len(fields) else "O")
    flush()
    if max_sentences is not None:
        sentences = sentences[:max_sentences]
    return sentences


def write_column_file(
    path: Union[str, Path],
    sentences: Sequence[SentenceRecord],
    layers: Sequence[str] = ("ner",),
    encoding: str = "utf-8",
) -> None:
    """Write sentences in CoNLL column format: each sentence's comment,
    then one line per token (the token and its tag in each layer the
    record has), then a blank line."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding=encoding) as f:
        for rec in sentences:
            if rec.comment:
                f.write(rec.comment + "\n")
            n = len(rec.tokens)
            cols = [rec.tokens] + [rec.tags[l][:n] for l in layers
                                   if l in rec.tags]
            f.write("".join(" ".join(line) + "\n"
                            for line in zip(*cols, strict=True)))
            f.write("\n")


def _tag_dictionary(splits, tag_type: str) -> Dictionary:
    def iter_tags() -> Iterator[List[str]]:
        for split in splits:
            for rec in split:
                if tag_type in rec.tags:
                    yield rec.tags[tag_type]

    return make_tag_dictionary(iter_tags())


@dataclass
class Corpus:
    """train/dev/test splits of sentence records."""

    train: List[SentenceRecord]
    dev: List[SentenceRecord]
    test: List[SentenceRecord]
    name: str = "corpus"

    def make_tag_dictionary(self, tag_type: str) -> Dictionary:
        return _tag_dictionary((self.train, self.dev, self.test), tag_type)

    def downsample(self, fraction: float) -> "Corpus":
        def take(split: List[SentenceRecord]) -> List[SentenceRecord]:
            return split[:max(1, int(len(split) * fraction))]

        return Corpus(take(self.train), take(self.dev), take(self.test),
                      self.name)


def load_column_corpus(
    data_folder: Union[str, Path],
    column_format: Dict[int, str],
    train_file: str = "train.txt",
    dev_file: str = "dev.txt",
    test_file: str = "test.txt",
    comment_symbol: Optional[str] = None,
    tag_to_bioes: Optional[str] = "ner",
    name: Optional[str] = None,
) -> Corpus:
    """A folder of column files; a missing split is empty."""
    folder = Path(data_folder)

    def read(fname: str) -> List[SentenceRecord]:
        p = folder / fname
        if not p.exists():
            return []
        return read_column_file(p, column_format,
                                comment_symbol=comment_symbol,
                                tag_to_bioes=tag_to_bioes)

    return Corpus(train=read(train_file), dev=read(dev_file),
                  test=read(test_file), name=name or folder.name)


#: CoNLL-U layer names produced by :func:`read_conllu_file` (UD columns
#: LEMMA/UPOS/XPOS/HEAD/DEPREL/DEPS; FORM is the token text).
CONLLU_LAYERS = ("lemma", "upos", "pos", "head", "deprel", "deps")


def read_conllu_file(
    path: Union[str, Path],
    encoding: str = "utf-8",
    max_sentences: Optional[int] = None,
) -> List[SentenceRecord]:
    """Parse a CoNLL-U (Universal Dependencies) file: the layers
    ``lemma``, ``upos``, ``pos`` (XPOS), ``head``, ``deprel`` and
    ``deps``; a ``#`` line becomes the sentence's comment; multiword-token
    ranges (``1-2``) and empty nodes (``1.1``) are skipped, so heads refer
    to the basic token ids; a missing column reads as ``_``."""
    sentences: List[SentenceRecord] = []
    cur_tokens: List[str] = []
    cur_tags: Dict[str, List[str]] = {l: [] for l in CONLLU_LAYERS}
    cur_comment: Optional[str] = None

    def flush():
        nonlocal cur_tokens, cur_tags, cur_comment
        if cur_tokens:
            sentences.append(SentenceRecord(
                tokens=cur_tokens, tags=dict(cur_tags), comment=cur_comment))
        cur_tokens = []
        cur_tags = {l: [] for l in CONLLU_LAYERS}
        cur_comment = None

    with open(path, encoding=encoding) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line.strip():
                flush()
                if max_sentences is not None and \
                        len(sentences) >= max_sentences:
                    return sentences
                continue
            if line.startswith("#"):
                cur_comment = line
                continue
            fields = line.split("\t")
            if len(fields) < 2:
                fields = line.split()
            if "-" in fields[0] or "." in fields[0]:
                continue
            cur_tokens.append(fields[1])
            for layer, col in zip(CONLLU_LAYERS, (2, 3, 4, 6, 7, 8)):
                cur_tags[layer].append(fields[col] if col < len(fields)
                                       else "_")
    flush()
    if max_sentences is not None:
        sentences = sentences[:max_sentences]
    return sentences


def load_conllu_corpus(
    data_folder: Union[str, Path],
    train_file: str = "train.conllu",
    dev_file: str = "dev.conllu",
    test_file: str = "test.conllu",
    name: Optional[str] = None,
) -> Corpus:
    """A UD treebank folder of CoNLL-U files; a missing split is empty."""
    folder = Path(data_folder)

    def read(fname: str) -> List[SentenceRecord]:
        p = folder / fname
        return read_conllu_file(p) if p.exists() else []

    return Corpus(train=read(train_file), dev=read(dev_file),
                  test=read(test_file), name=name or folder.name)


def read_fasttext_file(
    path: Union[str, Path],
    label_prefix: str = "__label__",
    encoding: str = "utf-8",
    max_sentences: Optional[int] = None,
) -> List[SentenceRecord]:
    """A fastText classification file, ``__label__X token ...`` per line:
    the labels (prefix dropped) and the other words as tokens; a line
    without tokens is skipped."""
    out: List[SentenceRecord] = []
    with open(path, encoding=encoding) as f:
        for line in f:
            parts = line.strip().split()
            labels = [p[len(label_prefix):] for p in parts
                      if p.startswith(label_prefix)]
            tokens = [p for p in parts if not p.startswith(label_prefix)]
            if not tokens:
                continue
            out.append(SentenceRecord(tokens=tokens, labels=labels))
            if max_sentences is not None and len(out) >= max_sentences:
                break
    return out


@dataclass
class ListCorpus:
    """Several corpora: the concatenated train split for training, and
    per-corpus dev/test lists for evaluation. Each record's ``lang_id`` is
    its corpus's position."""

    corpora: List[Corpus]

    def __post_init__(self):
        for lang_id, corpus in enumerate(self.corpora):
            for split in (corpus.train, corpus.dev, corpus.test):
                for rec in split:
                    rec.lang_id = lang_id

    @property
    def targets(self) -> List[str]:
        return [c.name for c in self.corpora]

    @property
    def train(self) -> List[SentenceRecord]:
        return [rec for c in self.corpora for rec in c.train]

    @property
    def dev_list(self) -> List[List[SentenceRecord]]:
        return [c.dev for c in self.corpora]

    @property
    def test_list(self) -> List[List[SentenceRecord]]:
        return [c.test for c in self.corpora]

    def make_tag_dictionary(self, tag_type: str) -> Dictionary:
        return _tag_dictionary(
            [s for c in self.corpora for s in (c.train, c.dev, c.test)],
            tag_type)
