"""Sliding windows for over-budget sentences (counterpart of
``kbner_tpu/data/windows.py``).

A sentence longer than the subtoken budget is split into overlapping word
chunks, each within the budget; each chunk is tagged on its own and the
predictions are stitched back, each side of a seam taking its half of the
overlap.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .conll import SentenceRecord
from .subword import SubwordTokenizer


def split_long_record(
    rec: SentenceRecord,
    tokenizer: SubwordTokenizer,
    max_subtokens: int = 510,
    stride_words: int = 16,
) -> List[Tuple[SentenceRecord, int]]:
    """``(chunk, word_offset)`` pieces covering ``rec``: each chunk fits
    ``max_subtokens`` with CLS and SEP (a single word over the budget is a
    chunk of its own), and the next one starts ``stride_words`` words
    before its end (at least one word later). A sentence within the budget
    is ``[(rec, 0)]``."""
    lens = [tokenizer.word_length(w) for w in rec.tokens]
    if sum(lens) + 2 <= max_subtokens:
        return [(rec, 0)]
    chunks: List[Tuple[SentenceRecord, int]] = []
    start, n = 0, len(rec.tokens)
    while start < n:
        used, end = 2, start  # CLS/SEP
        while end < n and used + lens[end] <= max_subtokens:
            used += lens[end]
            end += 1
        end = max(end, start + 1)
        chunks.append((SentenceRecord(
            tokens=rec.tokens[start:end],
            tags={k: v[start:end] for k, v in rec.tags.items()},
            doc_id=rec.doc_id, lang_id=rec.lang_id, comment=rec.comment),
            start))
        if end >= n:
            break
        start = max(end - stride_words, start + 1)
    return chunks


def stitch_window_predictions(
    pieces: Sequence[Tuple[Sequence[str], int, int]],
    total_len: int,
) -> List[str]:
    """One sentence's tags from ``(tags, word_offset, chunk_len)`` pieces
    in order: where two chunks overlap, the left one gives the first
    ``overlap // 2`` words and the right one the rest; words no chunk
    covers are ``O``."""
    out: List[str] = ["O"] * total_len
    prev_end = 0
    for idx, (tags, off, clen) in enumerate(pieces):
        begin = off
        if idx > 0 and off < prev_end:
            begin = off + (prev_end - off) // 2
        for w in range(begin, off + clen):
            out[w] = tags[w - off]
        prev_end = off + clen
    return out


def predict_long(
    trainer,
    records: Sequence[SentenceRecord],
    max_subtokens: int = 510,
    stride_words: int = 16,
    batch_size: int = 32,
) -> List[List[str]]:
    """``trainer.predict`` over every record's window chunks (all records'
    chunks in one call), stitched back into one tag list per record."""
    chunks: List[SentenceRecord] = []
    layout: List[List[Tuple[int, int, int]]] = []
    for rec in records:
        entry = []
        for chunk, off in split_long_record(rec, trainer.tokenizer,
                                            max_subtokens, stride_words):
            entry.append((len(chunks), off, len(chunk.tokens)))
            chunks.append(chunk)
        layout.append(entry)
    preds = trainer.predict(chunks, batch_size)
    return [stitch_window_predictions(
        [(preds[ci], off, clen) for ci, off, clen in entry], len(rec.tokens))
        for rec, entry in zip(records, layout)]
