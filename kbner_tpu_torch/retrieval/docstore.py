"""Packed, mmap-backed document store: the KB's payload file (counterpart
of ``kbner_tpu/retrieval/docstore.py``, same file format).

One file holds every field of every document as one UTF-8 blob plus a
uint64 offset table, opened with ``mmap``, so a lookup is a page-cache read
and opening costs nothing per document. Layout::

    magic  b"KBDS1\\n"
    blob   UTF-8 bytes of all field values, doc-major, field-minor
           (doc0.sentence, doc0.paragraph, doc0.title, doc0.url, doc1...)
    offs   uint64[n_docs * n_fields + 1] little-endian absolute file
           positions of the field boundaries
    footer 24 bytes: uint64 n_docs, uint64 n_fields, uint64 offs_pos

The writer streams the payloads to disk and keeps only the offset table
(32 bytes per document) in memory. Doc ids are assignment order, the ids of
the ``BM25Index`` built from the same record stream.
"""

from __future__ import annotations

import mmap
from pathlib import Path
from typing import Iterable, Iterator, List, Tuple, Union

import numpy as np

from .engine import DocStore, RetrievedDoc

_MAGIC = b"KBDS1\n"
FIELDS = ("sentence", "paragraph", "title", "url")
_FOOTER = np.dtype("<u8").itemsize * 3


class PackedDocStoreWriter:
    """Streaming builder: :meth:`add` documents, then :meth:`close`."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "wb")
        self._f.write(_MAGIC)
        self._pos = len(_MAGIC)
        self._offsets: List[int] = [self._pos]
        self._closed = False

    def add(self, sentence: str, paragraph: str = "", title: str = "",
            url: str = "") -> int:
        """Append one document; returns its doc id."""
        doc_id = len(self)
        for val in (sentence, paragraph, title, url):
            b = val.encode("utf-8")
            self._f.write(b)
            self._pos += len(b)
            self._offsets.append(self._pos)
        return doc_id

    def __len__(self) -> int:
        return (len(self._offsets) - 1) // len(FIELDS)

    def close(self) -> None:
        if self._closed:
            return
        self._f.write(np.asarray(self._offsets, dtype="<u8").tobytes())
        self._f.write(np.asarray([len(self), len(FIELDS), self._pos],
                                 dtype="<u8").tobytes())
        self._f.close()
        self._closed = True

    def __enter__(self) -> "PackedDocStoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class PackedDocStore:
    """Read side: mmap the file and decode fields on demand; it answers
    :meth:`materialize` as :class:`~.engine.DocStore` does."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self._file = open(self.path, "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0,
                                 access=mmap.ACCESS_READ)
        except ValueError:  # an empty file cannot be mapped
            self._file.close()
            raise ValueError(f"{path} is not a packed doc store")
        if self._mm[:len(_MAGIC)] != _MAGIC:
            self.close()
            raise ValueError(f"{path} is not a packed doc store")
        n_docs, n_fields, offs_pos = np.frombuffer(
            self._mm[-_FOOTER:], dtype="<u8")
        if int(n_fields) != len(FIELDS):
            self.close()
            raise ValueError(
                f"field count {n_fields} != {len(FIELDS)}; file from a "
                "different schema version")
        self.n_docs = int(n_docs)
        self._offs = np.frombuffer(
            self._mm, dtype="<u8", count=self.n_docs * len(FIELDS) + 1,
            offset=int(offs_pos))

    @classmethod
    def build(cls, path: Union[str, Path],
              records: Iterable[Union[Tuple[str, str, str, str], dict]]
              ) -> "PackedDocStore":
        """Build from (sentence, paragraph, title, url) tuples or dicts
        with those keys (the parsed-wiki JSONL schema)."""
        with PackedDocStoreWriter(path) as w:
            for r in records:
                if isinstance(r, dict):
                    w.add(r.get("sentence", ""), r.get("paragraph", ""),
                          r.get("title", ""), r.get("url", ""))
                else:
                    w.add(*r)
        return cls(path)

    @classmethod
    def from_store(cls, path: Union[str, Path],
                   store: DocStore) -> "PackedDocStore":
        def get(lst, i):
            return lst[i] if lst is not None and i < len(lst) else ""

        return cls.build(path, (
            (store.sentences[i], get(store.paragraphs, i),
             get(store.titles, i), get(store.urls, i))
            for i in range(len(store.sentences))))

    def __len__(self) -> int:
        return self.n_docs

    def get(self, doc_id: int, field: str) -> str:
        if not 0 <= doc_id < self.n_docs:
            raise IndexError(f"doc id {doc_id} out of range [0, "
                             f"{self.n_docs})")
        j = doc_id * len(FIELDS) + FIELDS.index(field)
        lo, hi = int(self._offs[j]), int(self._offs[j + 1])
        return self._mm[lo:hi].decode("utf-8")

    def field(self, field: str) -> Iterator[str]:
        """One field over all docs, in doc order."""
        for i in range(self.n_docs):
            yield self.get(i, field)

    def materialize(self, doc_id: int, score: float) -> RetrievedDoc:
        if not 0 <= doc_id < self.n_docs:
            return RetrievedDoc(doc_id=doc_id, score=score)
        return RetrievedDoc(doc_id, score, *(self.get(doc_id, f)
                                             for f in FIELDS))

    def close(self) -> None:
        self._offs = None  # release the buffer export before mmap.close
        self._mm.close()
        self._file.close()

    def __enter__(self) -> "PackedDocStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
