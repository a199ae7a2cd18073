"""Subword tokenization (counterpart of ``kbner_tpu/data/subword.py``).

Tokenizers meet the :class:`SubwordTokenizer` protocol: per-word subtoken
ids, which ``encode.py`` flattens into padded arrays with first-subtoken
alignment. ``HFTokenizer`` reads a saved HF tokenizer directory's
``tokenizer.json`` with the port's own reader (:mod:`.hf_tokenizer`);
``HashTokenizer`` is the deterministic tokenizer that needs no file.
"""

from __future__ import annotations

import hashlib
import random
from typing import Dict, List, Optional, Protocol, Sequence

from .hf_tokenizer import DROPOUT_SEED, load_pretrained


class SubwordTokenizer(Protocol):
    cls_id: int
    sep_id: int
    pad_id: int
    vocab_size: int

    def encode_word(self, word: str) -> List[int]:
        """Subtoken ids for one word (no specials)."""
        ...

    def word_length(self, word: str) -> int:
        """``len(encode_word(word))``."""
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


class HFTokenizer:
    """A locally saved HF tokenizer directory (``tokenizer.json`` and the
    files beside it), read as ``transformers``' ``AutoTokenizer`` reads it:
    ``cls_id``/``sep_id``/``pad_id`` from the named special tokens (the
    class's defaults where nothing names them; None where the class has
    none, as GPT-2's), ``vocab_size`` the model's vocabulary united with
    the added tokens. BPE dropout draws from this tokenizer's own
    ``random.Random(seed)`` (``seed`` 0 by default); as each word's ids
    are cached, a word keeps its first draw. A directory without
    ``tokenizer.json`` raises."""

    def __init__(self, tokenizer_dir: str, seed: int = DROPOUT_SEED):
        self._rng = random.Random(seed)
        self._tok, specials = load_pretrained(tokenizer_dir, self._rng)
        ids = {k: self._id(v) for k, v in specials.items()}
        self.unk_id = ids["unk_token"]
        self.cls_id = ids["cls_token"]
        self.sep_id = ids["sep_token"]
        self.pad_id = ids["pad_token"]
        self.vocab_size = len(self._tok)
        self._cache: Dict[str, List[int]] = {}

    def _id(self, token: Optional[str]) -> Optional[int]:
        if token is None:
            return None
        return self._tok.token_to_id(token)

    def encode_word(self, word: str) -> List[int]:
        """The ids of ``" " + word`` (a leading space marks the word
        boundary), or ``[unk_id]`` when there are none (``[None]`` where
        the class has no unk token, as the reference gives); cached per
        word."""
        ids = self._cache.get(word)
        if ids is None:
            ids = self._tok.encode(" " + word) or [self.unk_id]
            self._cache[word] = ids
        return ids

    def word_length(self, word: str) -> int:
        return len(self.encode_word(word))


def subtoken_length(tokenizer: SubwordTokenizer, words: Sequence[str]
                    ) -> int:
    """Total subtokens for a word sequence."""
    return sum(map(tokenizer.word_length, words))
