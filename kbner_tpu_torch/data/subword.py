"""Subword tokenization (counterpart of ``kbner_tpu/data/subword.py``).

Tokenizers meet the :class:`SubwordTokenizer` protocol: per-word subtoken
ids, which ``encode.py`` flattens into padded arrays with first-subtoken
alignment. Only the deterministic ``HashTokenizer`` is carried: the
repository holds no HF tokenizer files, so ``HFTokenizer`` waits until
one does.
"""

from __future__ import annotations

import hashlib
from typing import List, Protocol, Sequence


class SubwordTokenizer(Protocol):
    cls_id: int
    sep_id: int
    pad_id: int
    vocab_size: int

    def encode_word(self, word: str) -> List[int]:
        """Subtoken ids for one word (no specials)."""
        ...


class HashTokenizer:
    """Hashes words into a fixed vocabulary. Long words split into 4-char
    pieces (at most ``max_pieces``). Ids 0-3 are reserved: cls=0, pad=1,
    sep=2, unk=3 — the same ids ``kbner_tpu`` assigns, so both packages
    encode a sentence to the same array."""

    def __init__(self, vocab_size: int = 1000, max_pieces: int = 3):
        self.vocab_size = vocab_size
        self.max_pieces = max_pieces
        self.cls_id = 0
        self.pad_id = 1
        self.sep_id = 2
        self.unk_id = 3
        self._reserved = 4

    def _hash(self, piece: str) -> int:
        h = int.from_bytes(
            hashlib.md5(piece.encode("utf-8")).digest()[:4], "little")
        return self._reserved + h % (self.vocab_size - self._reserved)

    def encode_word(self, word: str) -> List[int]:
        pieces = [word[i:i + 4] for i in range(0, len(word), 4)]
        pieces = pieces[: self.max_pieces] or [word]
        return [self._hash(p) for p in pieces]

    def word_length(self, word: str) -> int:
        """``len(encode_word(word))``, without hashing the pieces."""
        return max(1, min(-(-len(word) // 4), self.max_pieces))


def subtoken_length(tokenizer: HashTokenizer, words: Sequence[str]) -> int:
    """Total subtokens for a word sequence."""
    return sum(map(tokenizer.word_length, words))
