"""Seeded tokenizer directories, written with plain ``json``.

The repository holds no published tokenizer files, so tests and the card
smoke write them:

- :func:`write_xlmr_like_tokenizer`: a ``tokenizer.json`` shaped as
  XLM-R's (a Unigram model with ``<s> <pad> </s> <unk>`` at ids 0-3,
  seeded ``▁``-prefixed and bare pieces with scores and ``<mask>`` last as
  an ``lstrip`` added token; a ``Precompiled`` normalizer; the legacy
  ``WhitespaceSplit`` + ``Metaspace(add_prefix_space)`` pre-tokenizer) and
  a ``tokenizer_config.json`` naming ``XLMRobertaTokenizer``. With
  ``n_pieces=249_997`` it has XLM-R's 250,002 ids.
- :func:`write_roberta_like_tokenizer`: RoBERTa's layout, a ByteLevel BPE
  (GPT-2's byte alphabet, seeded merges, ``<s> <pad> </s> <unk>`` first and
  ``<mask>`` last) naming ``RobertaTokenizer``; with ``n_merges=50_004``
  it has ``roberta-base``'s 50,265 ids.
- :func:`write_mbert_like_tokenizer`: multilingual BERT's layout, a
  WordPiece (``[PAD]``, 99 unused, ``[UNK] [CLS] [SEP] [MASK]``, then
  seeded cased pieces, bare and ``##``-prefixed) behind ``BertNormalizer``
  and ``BertPreTokenizer``, naming ``BertTokenizer`` with
  ``do_lower_case`` false; with ``n_pieces=119_443`` it has
  ``bert-base-multilingual-cased``'s 119,547 ids.

The charsmap is built here (``build_double_array``, a minimal Darts-clone
construction) from seeded NFKC mappings, many of them with
multi-code-point keys (decomposed accents, Hangul jamo, fullwidth letters
with a combining mark), in the layout sentencepiece writes.
"""

from __future__ import annotations

import base64
import json
import struct
import unicodedata
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

from .hf_tokenizer import BYTE_CHARS

SPECIAL_PIECES = ("<s>", "<pad>", "</s>", "<unk>")
MASK = "<mask>"
META = "▁"


def build_double_array(keys: Sequence[bytes], values: Sequence[int]
                       ) -> List[int]:
    """Darts-clone units for ``keys`` (no NUL, none empty) mapping to
    ``values`` (< 2**31): a unit holds its label in bits 0-7, a has-leaf
    flag in bit 8 and the offset to its children in bits 10-30; a leaf
    (the label-0 child) holds bit 31 and its value. Bases are unique and
    the array is whole 256-unit blocks, so every walk stays inside it."""
    children: List[Dict[int, int]] = [{}]
    leaf: Dict[int, int] = {}
    for key, value in zip(keys, values):
        node = 0
        for b in key:
            nxt = children[node].get(b)
            if nxt is None:
                nxt = children[node][b] = len(children)
                children.append({})
            node = nxt
        leaf[node] = value
    units = [0] * 256
    used = bytearray(256)
    used[0] = 1

    def taken(i: int) -> bool:
        return i < len(used) and used[i] == 1

    bases = set()
    queue = [(0, 0)]
    free = 1
    while queue:
        node, pos = queue.pop()
        labels = ([0] if node in leaf else []) + sorted(children[node])
        while taken(free):
            free += 1
        f = free
        while True:
            base = f ^ labels[0]
            if not taken(f) and base not in bases and not any(
                    taken(base ^ c) for c in labels):
                break
            f += 1
        while (base | 255) >= len(units):
            units.extend([0] * 256)
            used.extend(bytes(256))
        bases.add(base)
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("double array too large for plain offsets")
        units[pos] |= (offset << 10) | ((node in leaf) << 8)
        for c in labels:
            used[base ^ c] = 1
            if c == 0:
                units[base] = (1 << 31) | leaf[node]
            else:
                units[base ^ c] = c
                queue.append((children[node][c], base ^ c))
    return units


def charsmap_blob(mapping: Dict[str, str]) -> bytes:
    """A ``precompiled_charsmap``: u32 trie size, units, then the
    NUL-terminated replacements."""
    strings = bytearray()
    offsets: Dict[str, int] = {}
    keys, values = [], []
    for k in sorted(mapping):
        v = mapping[k]
        if v not in offsets:
            offsets[v] = len(strings)
            strings += v.encode("utf-8") + b"\0"
        keys.append(k.encode("utf-8"))
        values.append(offsets[v])
    units = build_double_array(keys, values)
    return (struct.pack("<I", 4 * len(units))
            + struct.pack(f"<{len(units)}I", *units) + bytes(strings))


def _mapping_pool() -> Dict[str, List[str]]:
    """Keys whose NFKC differs from them, by kind."""
    latin = [c for c in map(chr, range(0xC0, 0x250))
             if len(unicodedata.normalize("NFD", c)) > 1]
    latin += [c for c in map(chr, range(0x1E00, 0x1F00))
              if len(unicodedata.normalize("NFD", c)) > 1]
    jamo = [unicodedata.normalize("NFD", chr(0xAC00 + 28 * i + t))
            for i in range(0, 399, 7) for t in (0, 1, 4)]
    return {
        "decomposed": [unicodedata.normalize("NFD", c) for c in latin],
        "jamo": jamo,
        "fullwidth": [chr(c) for c in range(0xFF01, 0xFF5F)],
        "fullwidth+mark": [chr(c) + m for c in range(0xFF41, 0xFF5B)
                           for m in ("́", "̈")],
        "compat": [c for c in map(chr, list(range(0xA0, 0xC0))
                                  + list(range(0x2070, 0x2190))
                                  + list(range(0x2460, 0x24F0))
                                  + list(range(0x3000, 0x3001))
                                  + list(range(0x3380, 0x33E0))
                                  + list(range(0xFB00, 0xFB07)))
                   if unicodedata.normalize("NFKC", c) != c],
    }


def nfkc_mappings(n: int = 300, seed: int = 0) -> Dict[str, str]:
    """``n`` seeded ``key -> NFKC(key)`` pairs, spread over the pool's
    kinds."""
    rng = np.random.RandomState(seed)
    pool = _mapping_pool()
    out: Dict[str, str] = {}
    kinds = sorted(pool)
    for i in range(n):
        kind = pool[kinds[i % len(kinds)]]
        key = kind[rng.randint(len(kind))]
        out[key] = unicodedata.normalize("NFKC", key)
    return out


def _alphabet() -> List[str]:
    ranges = [(0x21, 0x7F), (0xC0, 0x180), (0x391, 0x3CA), (0x410, 0x450),
              (0x5D0, 0x5EB), (0x627, 0x64B), (0x905, 0x940), (0xE01, 0xE31),
              (0x3041, 0x3097), (0x30A1, 0x30FB), (0x4E00, 0x4F00),
              (0xAC00, 0xAD00)]
    return [chr(c) for a, b in ranges for c in range(a, b)
            if unicodedata.category(chr(c))[0] in "LNPS"]


def unigram_vocab(n_pieces: int, seed: int = 0) -> List[list]:
    """``[piece, score]`` rows: the specials, ``n_pieces`` seeded pieces
    (every alphabet char bare and ``▁``-prefixed, then random 2-8 char
    strings skewed toward lowercase ASCII, half of them ``▁``-prefixed;
    scores rounded to 0.1 so that paths tie), then ``<mask>``."""
    rng = np.random.RandomState(seed)
    alpha = _alphabet()
    ascii_lower = [chr(c) for c in range(0x61, 0x7B)]
    pieces: List[str] = []
    seen = set(SPECIAL_PIECES) | {MASK}
    for c in alpha + [META]:
        for p in (c, META + c):
            if p not in seen and len(pieces) < n_pieces:
                seen.add(p)
                pieces.append(p)
    chars = np.array(alpha + ascii_lower * 40)
    while len(pieces) < n_pieces:
        m = 4 * (n_pieces - len(pieces)) + 64
        lens = rng.randint(2, 9, m)
        picks = chars[rng.randint(len(chars), size=(m, 8))]
        prefix = rng.rand(m) < 0.5
        for k in range(m):
            p = (META if prefix[k] else "") + "".join(picks[k, :lens[k]])
            if p not in seen:
                seen.add(p)
                pieces.append(p)
                if len(pieces) == n_pieces:
                    break
    ranks = np.arange(1, len(pieces) + 1)
    scores = np.round(-np.log(ranks) - 2.0 * rng.rand(len(pieces)) - 1.0, 1)
    return ([[t, 0.0] for t in SPECIAL_PIECES]
            + [[p, float(s)] for p, s in zip(pieces, scores)]
            + [[MASK, 0.0]])


def tokenizer_spec(n_pieces: int, seed: int = 0, charsmap: int = 300,
                   normalizer=None, pre_tokenizer=None) -> dict:
    """The ``tokenizer.json`` object; ``normalizer``/``pre_tokenizer``
    replace XLM-R's (``charsmap`` mappings in a Precompiled normalizer; 0
    leaves none)."""
    vocab = unigram_vocab(n_pieces, seed)
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for i, t in enumerate(SPECIAL_PIECES)]
    added.append({"id": len(vocab) - 1, "content": MASK,
                  "single_word": False, "lstrip": True, "rstrip": False,
                  "normalized": False, "special": True})
    if normalizer is None and charsmap:
        blob = charsmap_blob(nfkc_mappings(charsmap, seed))
        normalizer = {"type": "Precompiled", "precompiled_charsmap":
                      base64.b64encode(blob).decode("ascii")}
    if pre_tokenizer is None:
        pre_tokenizer = {"type": "Sequence", "pretokenizers": [
            {"type": "WhitespaceSplit"},
            {"type": "Metaspace", "replacement": META,
             "add_prefix_space": True}]}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": normalizer,
        "pre_tokenizer": pre_tokenizer,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}],
            "special_tokens": {
                t: {"id": t, "ids": [i], "tokens": [t]}
                for t, i in (("<s>", 0), ("</s>", 2))}},
        "decoder": {"type": "Metaspace", "replacement": META,
                    "add_prefix_space": True},
        "model": {"type": "Unigram", "unk_id": 3, "vocab": vocab,
                  "byte_fallback": False},
    }


def write_xlmr_like_tokenizer(out_dir, n_pieces: int = 249_997,
                              seed: int = 0, charsmap: int = 300,
                              **spec_kw) -> Path:
    """Write ``tokenizer.json`` and ``tokenizer_config.json`` under
    ``out_dir``; returns it."""
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    spec = tokenizer_spec(n_pieces, seed, charsmap, **spec_kw)
    (d / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(
        {"tokenizer_class": "XLMRobertaTokenizer", "model_max_length": 512}))
    return d


def sample_words(n: int, seed: int = 0) -> List[str]:
    """Seeded words for holding a tokenizer to another: ASCII words,
    punctuation and digits, accented and decomposed letters, fullwidth
    forms, combining marks, Hangul syllables and jamo, CJK, emoji with ZWJ
    and skin tones, regional indicators, odd spaces, the empty string and
    the special tokens in and beside words."""
    rng = np.random.RandomState(seed)
    pool = _mapping_pool()
    alpha = _alphabet()
    fixed = ["", " ", "<mask>", "x<mask>", "<mask>y", "a <mask>", "<s>",
             "</s>", "<s>x", "<unk>", "<pad>", "ab\u3000cd", "a\xa0b",
             "\xa8x", "e\u0301\u0301", "\u1100\u1161\u11a8",
             "\U0001f468\u200d\U0001f469\u200d\U0001f467",
             "\U0001f44d\U0001f3fd",
             "\U0001f1eb\U0001f1f7\U0001f1e9\U0001f1ea",
             "\xa9\u200d\xa9", "a\r\nb", "\u039f\u0394\u039f\u03a3",
             "\u0130stanbul", "\ufb01nal", "\u216b", "x\xb2",
             "\uff11\uff12\uff13", "\uff45\u0301"]
    lower = [chr(c) for c in range(0x61, 0x7B)]
    words = list(fixed)
    kinds = ["ascii", "punct", "digits", "alpha", "pool", "mix"]
    while len(words) < n:
        kind = kinds[rng.randint(len(kinds))]
        k = rng.randint(1, 12)
        if kind == "ascii":
            w = "".join(lower[i] for i in rng.randint(26, size=k))
            if rng.rand() < 0.3:
                w = w.capitalize()
        elif kind == "punct":
            w = "".join("!\"#$%&'()*+,-./:;<=>?@[]_{}~"[i]
                        for i in rng.randint(28, size=min(k, 4)))
        elif kind == "digits":
            w = "".join(str(i) for i in rng.randint(10, size=k))
        elif kind == "alpha":
            w = "".join(alpha[i] for i in rng.randint(len(alpha), size=k))
        elif kind == "pool":
            keys = sorted(pool)
            sub = pool[keys[rng.randint(len(keys))]]
            w = "".join(sub[i] for i in rng.randint(len(sub),
                                                     size=min(k, 3)))
        else:
            parts = [lower[i] for i in rng.randint(26, size=k)]
            extra = ["\u0301", "\u0308", "\u200d", "\xa0", "\U0001f3fd",
                     "\U0001f1eb", "\u3000", "<mask>", "\uff41", "\u1161",
                     "-", "'"]
            j = rng.randint(len(parts) + 1)
            parts.insert(j, extra[rng.randint(len(extra))])
            w = "".join(parts)
        words.append(w)
    return words[:n]


def _merge_words(n: int, rng: np.random.RandomState) -> List[str]:
    """Seeded words for merges to build: ASCII syllables, capitalized or
    not, digit runs and multilingual letters, most after a space."""
    lower = [chr(c) for c in range(0x61, 0x7B)]
    vowels = list("aeiouy")
    alpha = _alphabet()
    words: List[str] = []
    for _ in range(n):
        kind = rng.randint(10)
        if kind < 7:
            w = "".join(lower[rng.randint(26)] + vowels[rng.randint(6)]
                        for _ in range(rng.randint(1, 5)))
            if rng.rand() < 0.25:
                w = w.capitalize()
        elif kind < 8:
            w = "".join(str(d) for d in rng.randint(10, size=rng.randint(
                1, 5)))
        else:
            w = "".join(alpha[i] for i in rng.randint(len(alpha),
                                                      size=rng.randint(1, 4)))
        words.append((" " if rng.rand() < 0.8 else "") + w)
    return words


def roberta_like_spec(n_merges: int = 50_004, seed: int = 0) -> dict:
    """The ``tokenizer.json`` object of :func:`write_roberta_like_tokenizer`:
    each seeded word's UTF-8 bytes in GPT-2's alphabet merged left to
    right, one merge per prefix not built yet, until ``n_merges``."""
    rng = np.random.RandomState(seed)
    vocab: Dict[str, int] = {t: i for i, t in enumerate(SPECIAL_PIECES)}
    for c in BYTE_CHARS:
        vocab[c] = len(vocab)
    merges: List[List[str]] = []
    while len(merges) < n_merges:
        for w in _merge_words(4096, rng):
            b = "".join(BYTE_CHARS[x] for x in w.encode("utf-8"))
            for i in range(1, len(b)):
                if b[:i + 1] not in vocab and len(merges) < n_merges:
                    merges.append([b[:i], b[i]])
                    vocab[b[:i + 1]] = len(vocab)
    vocab[MASK] = len(vocab)
    added = [{"id": i, "content": t, "single_word": False,
              "lstrip": t == MASK, "rstrip": False, "normalized": False,
              "special": True}
             for t, i in list(vocab.items())[:4] + [(MASK, vocab[MASK])]]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added, "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False,
                          "trim_offsets": True, "use_regex": True},
        "post_processor": {"type": "RobertaProcessing", "sep": ["</s>", 2],
                           "cls": ["<s>", 0], "trim_offsets": True,
                           "add_prefix_space": False},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "ignore_merges": False, "vocab": vocab, "merges": merges},
    }


def write_roberta_like_tokenizer(out_dir, n_merges: int = 50_004,
                                 seed: int = 0) -> Path:
    """Write a RoBERTa-shaped ``tokenizer.json`` (:func:`roberta_like_spec`)
    and a ``tokenizer_config.json`` naming ``RobertaTokenizer`` under
    ``out_dir``; returns it."""
    return _write(out_dir, roberta_like_spec(n_merges, seed),
                  {"tokenizer_class": "RobertaTokenizer",
                   "model_max_length": 512})


MBERT_SPECIALS = ("[PAD]",) + tuple(f"[unused{i}]" for i in range(1, 100)) + (
    "[UNK]", "[CLS]", "[SEP]", "[MASK]")


def mbert_like_spec(n_pieces: int = 119_443, seed: int = 0) -> dict:
    """The ``tokenizer.json`` object of :func:`write_mbert_like_tokenizer`:
    the specials, every alphabet char bare and ``##``-prefixed, then
    seeded 2-8 char cased pieces (half ``##``-prefixed), ``n_pieces`` after
    the specials in all."""
    rng = np.random.RandomState(seed)
    vocab: Dict[str, int] = {t: i for i, t in enumerate(MBERT_SPECIALS)}
    alpha = _alphabet()
    target = len(vocab) + n_pieces
    for c in alpha:
        for p in (c, "##" + c):
            if p not in vocab and len(vocab) < target:
                vocab[p] = len(vocab)
    lower = [chr(c) for c in range(0x61, 0x7B)]
    chars = np.array(alpha + lower * 40 + [c.upper() for c in lower] * 4)
    while len(vocab) < target:
        m = 4 * (target - len(vocab)) + 64
        lens = rng.randint(2, 9, m)
        picks = chars[rng.randint(len(chars), size=(m, 8))]
        prefix = rng.rand(m) < 0.5
        for k in range(m):
            p = ("##" if prefix[k] else "") + "".join(picks[k, :lens[k]])
            if p not in vocab:
                vocab[p] = len(vocab)
                if len(vocab) == target:
                    break
    added = [{"id": vocab[t], "content": t, "single_word": False,
              "lstrip": False, "rstrip": False, "normalized": False,
              "special": True}
             for t in ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")]
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": False},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {
                t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
    }


def write_mbert_like_tokenizer(out_dir, n_pieces: int = 119_443,
                               seed: int = 0) -> Path:
    """Write an mBERT-shaped ``tokenizer.json`` (:func:`mbert_like_spec`)
    and a ``tokenizer_config.json`` naming ``BertTokenizer`` (cased:
    ``do_lower_case`` false) under ``out_dir``; returns it."""
    return _write(out_dir, mbert_like_spec(n_pieces, seed),
                  {"tokenizer_class": "BertTokenizer",
                   "do_lower_case": False, "model_max_length": 512})


def _write(out_dir, spec: dict, config: dict) -> Path:
    d = Path(out_dir)
    d.mkdir(parents=True, exist_ok=True)
    (d / "tokenizer.json").write_text(
        json.dumps(spec, ensure_ascii=False), encoding="utf-8")
    (d / "tokenizer_config.json").write_text(json.dumps(config))
    return d
