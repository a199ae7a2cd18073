"""The ``tokenizer.json`` pipeline of HF ``tokenizers``, read with ``json``.

:class:`TokenizerJson` gives the ids of ``Tokenizer.encode(text,
add_special_tokens=False)`` for the types the library serializes:

- added tokens (``special``, ``lstrip``, ``rstrip``, ``single_word``,
  ``normalized``), split out of the text longest match first, the
  un-normalized ones before normalization and the others after it;
- normalizers ``Sequence``, ``NFC``/``NFD``/``NFKC``/``NFKD``, ``Replace``
  (a string, or an Onig regex through :func:`onig_regex`), ``Lowercase``,
  ``Strip``, ``Precompiled`` (a sentencepiece charsmap: a Darts-clone
  double array walked per grapheme cluster), ``BertNormalizer``,
  ``StripAccents``, ``Prepend``, ``Nmt`` and ``ByteLevel``;
- pre-tokenizers ``Sequence``, ``WhitespaceSplit``, ``Whitespace``,
  ``Metaspace`` (``prepend_scheme``/``split``, or the legacy
  ``add_prefix_space``), ``ByteLevel`` (GPT-2's split pattern and byte
  alphabet), ``Split`` (a string or an Onig regex; every behavior,
  ``invert``), ``Punctuation``, ``Digits``, ``CharDelimiterSplit``,
  ``UnicodeScripts`` (the library's script table, :mod:`.unicode_scripts`)
  and ``BertPreTokenizer``;
- the ``Unigram`` and ``BPE`` models (both with ``byte_fallback``; BPE
  with ``dropout``, drawn from a seeded ``random.Random``), ``WordPiece``
  and ``WordLevel``.

Any other type raises ``NotImplementedError`` naming it, as does an Onig
construct that the translator does not read. The post-processor and the
decoder are read and ignored: they add nothing without special tokens.
:func:`load_pretrained`
adds what ``transformers``' fast tokenizers read beside the file: the
special tokens of ``tokenizer_config.json`` and ``special_tokens_map.json``,
each class's defaults (XLM-R, RoBERTa, GPT-2, BERT), the base class's
``add_prefix_space`` and BERT's normalizer options.

Normalization keeps, per character, the input offset it came from, as the
library's ``NormalizedString`` alignments do; Metaspace's ``first`` scheme
reads it. The library's Unicode tables differ from Python's (Unicode
15.0): its normalization tables are older (the code points in ``_HELD``
keep their form under its decompositions, and they keep it here), BERT's
character classes come from an older table (``_CRATE_*``), and its Onig
classes are newer (characters that Unicode 15.1-16.0 assigned read as
unassigned here).
"""

from __future__ import annotations

import base64
import dataclasses
import functools
import heapq
import json
import random
import re
import struct
import unicodedata
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

from .unicode_scripts import NO_SCRIPT, script_class

# -- character classes --------------------------------------------------------

# Unicode White_Space (Rust's char::is_whitespace)
_WHITE_SPACE = frozenset((0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x20, 0x85, 0xA0,
                          0x1680, *range(0x2000, 0x200B), 0x2028, 0x2029,
                          0x202F, 0x205F, 0x3000))
# word characters outside L, M, Nd, Nl and Pc: Join_Control and the
# Other_Alphabetic symbols (circled and squared letters)
_WORD_EXTRA = ((0x200C, 0x200D), (0x24B6, 0x24E9), (0x1F130, 0x1F149),
               (0x1F150, 0x1F169), (0x1F170, 0x1F189))


def _in(cp: int, ranges) -> bool:
    return any(a <= cp <= b for a, b in ranges)


def is_space(c: str) -> bool:
    return ord(c) in _WHITE_SPACE


def is_word(c: str) -> bool:
    """Rust regex's Unicode ``\\w`` (Python's lacks marks)."""
    cat = unicodedata.category(c)
    return (cat[0] in "LM" or cat in ("Nd", "Nl", "Pc")
            or _in(ord(c), _WORD_EXTRA))


def _code_points(ranges) -> frozenset:
    return frozenset(cp for a, b in ranges for cp in range(a, b + 1))


# The character tables of the library's dependencies, older than Python's,
# given as Python's categories and the code points Unicode assigned or moved
# since: the unicode_categories crate's (Unicode 8: BertNormalizer's
# ``clean_text`` and ``strip_accents``, BertPreTokenizer, Punctuation) and
# unicode-normalization's combining marks (Mn, Mc, Me; StripAccents).
_CRATE_NOT_OTHER = _code_points(((0x890, 0x891), (0x8E2, 0x8E2),
                                 (0x110CD, 0x110CD), (0x13430, 0x1343F)))
_CRATE_NONSPACING_EXTRA = _code_points(((0x1734, 0x1734),))
_CRATE_NOT_NONSPACING = _code_points((
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8E1), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81), (0xEBA, 0xEBA),
    (0xECE, 0xECE), (0x180F, 0x180F), (0x1885, 0x1886), (0x1ABF, 0x1ACE),
    (0x1DF6, 0x1DFB), (0xA82C, 0xA82C), (0xA8C5, 0xA8C5), (0xA8FF, 0xA8FF),
    (0xA9BD, 0xA9BD), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x111C9, 0x111C9), (0x111CF, 0x111CF), (0x1123E, 0x1123E),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x11438, 0x1143F),
    (0x11442, 0x11444), (0x11446, 0x11446), (0x1145E, 0x1145E),
    (0x1182F, 0x11837), (0x11839, 0x1183A), (0x1193B, 0x1193C),
    (0x1193E, 0x1193E), (0x11943, 0x11943), (0x119D4, 0x119D7),
    (0x119DA, 0x119DB), (0x119E0, 0x119E0), (0x11A01, 0x11A0A),
    (0x11A33, 0x11A38), (0x11A3B, 0x11A3E), (0x11A47, 0x11A47),
    (0x11A51, 0x11A56), (0x11A59, 0x11A5B), (0x11A8A, 0x11A96),
    (0x11A98, 0x11A99), (0x11C30, 0x11C36), (0x11C38, 0x11C3D),
    (0x11C3F, 0x11C3F), (0x11C92, 0x11CA7), (0x11CAA, 0x11CB0),
    (0x11CB2, 0x11CB3), (0x11CB5, 0x11CB6), (0x11D31, 0x11D36),
    (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D), (0x11D3F, 0x11D45),
    (0x11D47, 0x11D47), (0x11D90, 0x11D91), (0x11D95, 0x11D95),
    (0x11D97, 0x11D97), (0x11EF3, 0x11EF4), (0x11F00, 0x11F01),
    (0x11F36, 0x11F3A), (0x11F40, 0x11F40), (0x11F42, 0x11F42),
    (0x13440, 0x13440), (0x13447, 0x13455), (0x16F4F, 0x16F4F),
    (0x16FE4, 0x16FE4), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46),
    (0x1E000, 0x1E006), (0x1E008, 0x1E018), (0x1E01B, 0x1E021),
    (0x1E023, 0x1E024), (0x1E026, 0x1E02A), (0x1E08F, 0x1E08F),
    (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE), (0x1E2EC, 0x1E2EF),
    (0x1E4EC, 0x1E4EF), (0x1E944, 0x1E94A)))
_COMBINING_EXTRA = _code_points(((0x1CF2, 0x1CF3),))
_NOT_COMBINING = _code_points((
    (0x7FD, 0x7FD), (0x898, 0x89F), (0x8CA, 0x8D3), (0x9FE, 0x9FE),
    (0xAFA, 0xAFF), (0xB55, 0xB55), (0xC04, 0xC04), (0xC3C, 0xC3C),
    (0xCF3, 0xCF3), (0xD00, 0xD00), (0xD3B, 0xD3C), (0xD81, 0xD81),
    (0xEBA, 0xEBA), (0xECE, 0xECE), (0x1715, 0x1715), (0x180F, 0x180F),
    (0x1ABF, 0x1ACE), (0x1CF7, 0x1CF7), (0x1DF6, 0x1DFA), (0xA82C, 0xA82C),
    (0xA8FF, 0xA8FF), (0x10D24, 0x10D27), (0x10EAB, 0x10EAC),
    (0x10EFD, 0x10EFF), (0x10F46, 0x10F50), (0x10F82, 0x10F85),
    (0x11070, 0x11070), (0x11073, 0x11074), (0x110C2, 0x110C2),
    (0x11145, 0x11146), (0x111C9, 0x111C9), (0x111CE, 0x111CF),
    (0x11241, 0x11241), (0x1133B, 0x1133B), (0x1145E, 0x1145E),
    (0x1182C, 0x1183A), (0x11930, 0x11935), (0x11937, 0x11938),
    (0x1193B, 0x1193E), (0x11940, 0x11940), (0x11942, 0x11943),
    (0x119D1, 0x119D7), (0x119DA, 0x119E0), (0x119E4, 0x119E4),
    (0x11A01, 0x11A0A), (0x11A33, 0x11A39), (0x11A3B, 0x11A3E),
    (0x11A47, 0x11A47), (0x11A51, 0x11A5B), (0x11A8A, 0x11A99),
    (0x11D31, 0x11D36), (0x11D3A, 0x11D3A), (0x11D3C, 0x11D3D),
    (0x11D3F, 0x11D45), (0x11D47, 0x11D47), (0x11D8A, 0x11D8E),
    (0x11D90, 0x11D91), (0x11D93, 0x11D97), (0x11EF3, 0x11EF6),
    (0x11F00, 0x11F01), (0x11F03, 0x11F03), (0x11F34, 0x11F3A),
    (0x11F3E, 0x11F42), (0x13440, 0x13440), (0x13447, 0x13455),
    (0x16F4F, 0x16F4F), (0x16F7F, 0x16F87), (0x16FE4, 0x16FE4),
    (0x16FF0, 0x16FF1), (0x1CF00, 0x1CF2D), (0x1CF30, 0x1CF46),
    (0x1E08F, 0x1E08F), (0x1E130, 0x1E136), (0x1E2AE, 0x1E2AE),
    (0x1E2EC, 0x1E2EF), (0x1E4EC, 0x1E4EF)))
_CRATE_PUNCT_EXTRA = _code_points(((0x166D, 0x166D), (0x111C9, 0x111C9)))
_CRATE_NOT_PUNCT = _code_points((
    (0x61D, 0x61D), (0x9FD, 0x9FD), (0xA76, 0xA76), (0xC77, 0xC77),
    (0xC84, 0xC84), (0x1B7D, 0x1B7E), (0x2E43, 0x2E4F), (0x2E52, 0x2E5D),
    (0x10EAD, 0x10EAD), (0x10F55, 0x10F59), (0x10F86, 0x10F89),
    (0x1144B, 0x1144F), (0x1145A, 0x1145B), (0x1145D, 0x1145D),
    (0x11660, 0x1166C), (0x116B9, 0x116B9), (0x1183B, 0x1183B),
    (0x11944, 0x11946), (0x119E2, 0x119E2), (0x11A3F, 0x11A46),
    (0x11A9A, 0x11A9C), (0x11A9E, 0x11AA2), (0x11B00, 0x11B09),
    (0x11C41, 0x11C45), (0x11C70, 0x11C71), (0x11EF7, 0x11EF8),
    (0x11F43, 0x11F4F), (0x11FFF, 0x11FFF), (0x12FF1, 0x12FF2),
    (0x16E97, 0x16E9A), (0x16FE2, 0x16FE2), (0x1E95E, 0x1E95F)))
# BertNormalizer's "Chinese characters": the CJK ideograph blocks it names
_CJK = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
        (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
        (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def is_bert_punc(c: str) -> bool:
    """ASCII punctuation or the crate's punctuation (BertPreTokenizer,
    Punctuation)."""
    cp = ord(c)
    if cp < 0x80:
        return 0x21 <= cp <= 0x2F or 0x3A <= cp <= 0x40 or (
            0x5B <= cp <= 0x60) or 0x7B <= cp <= 0x7E
    return (unicodedata.category(c)[0] == "P" and cp not in _CRATE_NOT_PUNCT
            ) or cp in _CRATE_PUNCT_EXTRA


def _crate_nonspacing(c: str) -> bool:
    """A nonspacing mark to the crate (BertNormalizer's accents)."""
    cp = ord(c)
    return (unicodedata.category(c) == "Mn" and cp not in
            _CRATE_NOT_NONSPACING) or cp in _CRATE_NONSPACING_EXTRA


def _combining_mark(c: str) -> bool:
    """A combining mark to unicode-normalization (StripAccents)."""
    cp = ord(c)
    return (unicodedata.category(c)[0] == "M" and cp not in _NOT_COMBINING
            ) or cp in _COMBINING_EXTRA


def _bert_control(c: str) -> bool:
    """What BertNormalizer's ``clean_text`` drops: NUL, U+FFFD and the
    crate's Cc, Cf and Co but tab, newline and carriage return."""
    cp = ord(c)
    return cp in (0, 0xFFFD) or (
        c not in "\t\n\r" and unicodedata.category(c) in ("Cc", "Cf", "Co")
        and cp not in _CRATE_NOT_OTHER)


def _is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric``: Nd, Nl and No (Python's
    ``str.isnumeric`` also counts ideographs with numeric values)."""
    return unicodedata.category(c) in ("Nd", "Nl", "No")


# code points that Python 3.12's normalization (Unicode 15) changes and the
# library's (Unicode 12) leaves alone, kept as they are: compatibility forms
# from Unicode 13-14, U+11938's canonical decomposition, and U+11930, which
# composes with U+11935 into it
_HELD_COMPAT = ((0x32FF, 0x32FF), (0xA7F2, 0xA7F4), (0xAB69, 0xAB69),
                (0x10781, 0x10785), (0x10787, 0x107B0), (0x107B2, 0x107BA),
                (0x1E030, 0x1E06D), (0x1F16C, 0x1F16C), (0x1FBF0, 0x1FBF9))
_HELD = {"NFC": ((0x11930, 0x11930),), "NFD": ((0x11938, 0x11938),),
         "NFKC": _HELD_COMPAT + ((0x11930, 0x11930),),
         "NFKD": _HELD_COMPAT + ((0x11938, 0x11938),)}

# -- grapheme clusters (UAX #29, extended) ------------------------------------

(_OTHER, _CR, _LF, _CONTROL, _EXTEND, _ZWJ, _RI, _PREPEND, _SPACING, _L,
 _V, _T, _LV, _LVT) = range(14)

_PREPEND_RANGES = ((0x0600, 0x0605), (0x06DD, 0x06DD), (0x070F, 0x070F),
                   (0x0890, 0x0891), (0x08E2, 0x08E2), (0x0D4E, 0x0D4E),
                   (0x110BD, 0x110BD), (0x110CD, 0x110CD),
                   (0x111C2, 0x111C3), (0x1193F, 0x1193F),
                   (0x11941, 0x11941), (0x11A84, 0x11A89),
                   (0x11D46, 0x11D46), (0x11F02, 0x11F02))
# Extend beyond Mn and Me: Other_Grapheme_Extend (with Unicode 16's spacing
# viramas), the emoji modifiers and the tags
_EXTEND_RANGES = ((0x09BE, 0x09BE), (0x09D7, 0x09D7), (0x0B3E, 0x0B3E),
                  (0x0B57, 0x0B57), (0x0BBE, 0x0BBE), (0x0BD7, 0x0BD7),
                  (0x0CC0, 0x0CC0), (0x0CC2, 0x0CC2), (0x0CC7, 0x0CC8),
                  (0x0CCA, 0x0CCB), (0x0CD5, 0x0CD6), (0x0D3E, 0x0D3E),
                  (0x0D57, 0x0D57), (0x0DCF, 0x0DCF), (0x0DDF, 0x0DDF),
                  (0x1715, 0x1715), (0x1734, 0x1734), (0x1B35, 0x1B35),
                  (0x1B3B, 0x1B3B), (0x1B3D, 0x1B3D), (0x1B43, 0x1B44),
                  (0x1BAA, 0x1BAA), (0x1BF2, 0x1BF3), (0x200C, 0x200C),
                  (0x302E, 0x302F), (0xA953, 0xA953), (0xA9C0, 0xA9C0),
                  (0xFF9E, 0xFF9F), (0x111C0, 0x111C0), (0x11235, 0x11235),
                  (0x1133E, 0x1133E), (0x1134D, 0x1134D),
                  (0x11357, 0x11357), (0x114B0, 0x114B0),
                  (0x114BD, 0x114BD), (0x115AF, 0x115AF),
                  (0x116B6, 0x116B6), (0x11930, 0x11930),
                  (0x1193D, 0x1193D), (0x11F41, 0x11F41),
                  (0x16FF0, 0x16FF1), (0x1D165, 0x1D166),
                  (0x1D16D, 0x1D172), (0x1F3FB, 0x1F3FF),
                  (0xE0020, 0xE007F))
# Mc that is not SpacingMark; and the Lo and Mn that are
_NOT_SPACING = ((0x102B, 0x102C), (0x1038, 0x1038), (0x1062, 0x1064),
                (0x1067, 0x106D), (0x1083, 0x1083), (0x1087, 0x108C),
                (0x108F, 0x108F), (0x109A, 0x109C), (0x1A61, 0x1A61),
                (0x1A63, 0x1A64), (0xAA7B, 0xAA7B), (0xAA7D, 0xAA7D),
                (0x11720, 0x11721))
_SPACING_EXTRA = (0x0E33, 0x0EB3, 0x1171E)
# Extended_Pictographic (emoji-data.txt)
_PICT = ((0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C),
         (0x2049, 0x2049), (0x2122, 0x2122), (0x2139, 0x2139),
         (0x2194, 0x2199), (0x21A9, 0x21AA), (0x231A, 0x231B),
         (0x2328, 0x2328), (0x2388, 0x2388), (0x23CF, 0x23CF),
         (0x23E9, 0x23F3), (0x23F8, 0x23FA), (0x24C2, 0x24C2),
         (0x25AA, 0x25AB), (0x25B6, 0x25B6), (0x25C0, 0x25C0),
         (0x25FB, 0x25FE), (0x2600, 0x2605), (0x2607, 0x2612),
         (0x2614, 0x2685), (0x2690, 0x2705), (0x2708, 0x2712),
         (0x2714, 0x2714), (0x2716, 0x2716), (0x271D, 0x271D),
         (0x2721, 0x2721), (0x2728, 0x2728), (0x2733, 0x2734),
         (0x2744, 0x2744), (0x2747, 0x2747), (0x274C, 0x274C),
         (0x274E, 0x274E), (0x2753, 0x2755), (0x2757, 0x2757),
         (0x2763, 0x2767), (0x2795, 0x2797), (0x27A1, 0x27A1),
         (0x27B0, 0x27B0), (0x27BF, 0x27BF), (0x2934, 0x2935),
         (0x2B05, 0x2B07), (0x2B1B, 0x2B1C), (0x2B50, 0x2B50),
         (0x2B55, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D),
         (0x3297, 0x3297), (0x3299, 0x3299), (0x1F000, 0x1F0FF),
         (0x1F10D, 0x1F10F), (0x1F12F, 0x1F12F), (0x1F16C, 0x1F171),
         (0x1F17E, 0x1F17F), (0x1F18E, 0x1F18E), (0x1F191, 0x1F19A),
         (0x1F1AD, 0x1F1E5), (0x1F201, 0x1F20F), (0x1F21A, 0x1F21A),
         (0x1F22F, 0x1F22F), (0x1F232, 0x1F23A), (0x1F23C, 0x1F23F),
         (0x1F249, 0x1F3FA), (0x1F400, 0x1F53D), (0x1F546, 0x1F64F),
         (0x1F680, 0x1F6FF), (0x1F774, 0x1F77F), (0x1F7D5, 0x1F7FF),
         (0x1F80C, 0x1F80F), (0x1F848, 0x1F84F), (0x1F85A, 0x1F85F),
         (0x1F888, 0x1F88F), (0x1F8AE, 0x1F8FF), (0x1F90C, 0x1F93A),
         (0x1F93C, 0x1F945), (0x1F947, 0x1FAFF), (0x1FC00, 0x1FFFD))


def _gcb(c: str) -> int:
    """The Grapheme_Cluster_Break class of ``c``."""
    cp = ord(c)
    if cp < 0x7F:
        return _CR if cp == 0x0D else _LF if cp == 0x0A else (
            _CONTROL if cp < 0x20 else _OTHER)
    if cp == 0x200D:
        return _ZWJ
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return _RI
    if 0xAC00 <= cp <= 0xD7A3:
        return _LV if (cp - 0xAC00) % 28 == 0 else _LVT
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return _L
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return _V
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return _T
    if _in(cp, _PREPEND_RANGES):
        return _PREPEND
    if cp in _SPACING_EXTRA:
        return _SPACING
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me") or _in(cp, _EXTEND_RANGES):
        return _EXTEND
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return _CONTROL
    if cat == "Mc" and not _in(cp, _NOT_SPACING):
        return _SPACING
    return _OTHER


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters. GB9c (Indic conjuncts) is left out: it
    joins three-byte characters only, and the charsmap reads clusters of
    fewer than six bytes whole."""
    out: List[str] = []
    if not text:
        return out
    start, prev = 0, _gcb(text[0])
    pict = _in(ord(text[0]), _PICT)   # the text so far ends ExtPict Extend*
    pict_zwj = False                  # ... ends ExtPict Extend* ZWJ
    ri = int(prev == _RI)             # regional indicators ending it
    for i in range(1, len(text)):
        c = text[i]
        cur, is_pict = _gcb(c), _in(ord(c), _PICT)
        if prev == _CR and cur == _LF:
            join = True
        elif prev in (_CONTROL, _CR, _LF) or cur in (_CONTROL, _CR, _LF):
            join = False
        else:
            join = ((prev == _L and cur in (_L, _V, _LV, _LVT))
                    or (prev in (_LV, _V) and cur in (_V, _T))
                    or (prev in (_LVT, _T) and cur == _T)
                    or cur in (_EXTEND, _ZWJ, _SPACING) or prev == _PREPEND
                    or (pict_zwj and is_pict)
                    or (prev == _RI and cur == _RI and ri % 2 == 1))
        if not join:
            out.append(text[start:i])
            start = i
        if is_pict:
            pict, pict_zwj = True, False
        elif cur == _ZWJ:
            pict, pict_zwj = False, pict
        elif cur != _EXTEND:
            pict = pict_zwj = False
        ri = ri + 1 if cur == _RI else 0
        prev = cur
    out.append(text[start:])
    return out


# -- aligned transformations --------------------------------------------------
# A text carries ``orig``, per character the input offset it came from. A
# transformation is a list of ``(char, change)`` as in the library's
# ``NormalizedString::transform``: change 0 replaces the next input char,
# 1 inserts (aligned with the char before), -n replaces one and drops n;
# ``(None, n)`` drops n input chars.

Transform = List[Tuple[Optional[str], int]]


def _apply(orig: List[int], tr: Transform, base: int
           ) -> Tuple[str, List[int]]:
    chars: List[str] = []
    new: List[int] = []
    i = 0
    for c, change in tr:
        if c is None:
            i += change
            continue
        if change > 0:
            new.append(orig[i - 1] if i > 0 else base)
        else:
            new.append(orig[i])
            i += 1 - change
        chars.append(c)
    return "".join(chars), new


def _replace(tr: Transform, old: str, new: str) -> None:
    """``old`` becomes ``new``: the first chars replace, the rest insert
    (or the last one drops what is left of ``old``)."""
    diff = len(new) - len(old)
    tr.extend((c, 0) for c in new)
    if diff > 0:
        for k in range(len(tr) - diff, len(tr)):
            tr[k] = (tr[k][0], 1)
    elif diff < 0 and tr:
        tr[-1] = (tr[-1][0], tr[-1][1] + diff)


# -- Onig regexes -------------------------------------------------------------
# The library compiles ``Split`` and ``Replace`` regexes with Oniguruma (Ruby
# syntax). :func:`onig_regex` translates the constructs that published files
# use into a ``re`` pattern whose classes are explicit code point ranges,
# built once from ``unicodedata``: Python's ``\s``, ``\d`` and ``\w`` are not
# Onig's (Python's ``\s`` holds U+001C-U+001F, Onig's does not).

_MAX_CP = 0x10FFFF
_GENERAL = frozenset(("Lu", "Ll", "Lt", "Lm", "Lo", "Mn", "Mc", "Me", "Nd",
                      "Nl", "No", "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po",
                      "Sm", "Sc", "Sk", "So", "Zs", "Zl", "Zp", "Cc", "Cf",
                      "Cs", "Co", "Cn"))
# Onig's \w beyond L, M, Nd, Nl and Pc: the Other_Alphabetic symbols
# (circled and squared letters), and outside a class also the Latin-1
# superscripts and fractions
_ONIG_WORD_EXTRA = _WORD_EXTRA[1:]
_ONIG_LATIN1_WORD = ((0xB2, 0xB3), (0xB9, 0xB9), (0xBC, 0xBE))
_ESCAPED = {"t": "\t", "n": "\n", "r": "\r", "f": "\f", "v": "\v", "a": "\a",
            "e": "\x1b"}
_HEX = frozenset("0123456789abcdefABCDEF")

Ranges = List[Tuple[int, int]]


@functools.lru_cache(maxsize=None)
def _category_ranges() -> Dict[str, Ranges]:
    """Every general category's code point ranges (one pass over them)."""
    out: Dict[str, Ranges] = {}
    start, cur = 0, unicodedata.category("\0")
    for cp in range(1, _MAX_CP + 2):
        cat = unicodedata.category(chr(cp)) if cp <= _MAX_CP else None
        if cat != cur:
            out.setdefault(cur, []).append((start, cp - 1))
            start, cur = cp, cat
    return out


def _union(*parts: Sequence[Tuple[int, int]]) -> Ranges:
    out: Ranges = []
    for a, b in sorted(r for p in parts for r in p):
        if out and a <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(b, out[-1][1]))
        else:
            out.append((a, b))
    return out


def _complement(ranges: Ranges) -> Ranges:
    out: Ranges = []
    nxt = 0
    for a, b in ranges:
        if a > nxt:
            out.append((nxt, a - 1))
        nxt = b + 1
    if nxt <= _MAX_CP:
        out.append((nxt, _MAX_CP))
    return out


@functools.lru_cache(maxsize=None)
def _property(name: str) -> Ranges:
    """``\\p{name}`` for a general category or its one-letter group."""
    cats = _category_ranges()
    if len(name) == 1 and name in "LMNPSZC":
        return _union(*(r for c, r in cats.items() if c[0] == name))
    if name in _GENERAL:
        return list(cats.get(name, []))
    raise NotImplementedError(f"Onig property \\p{{{name}}}")


@functools.lru_cache(maxsize=None)
def _onig_class(letter: str, in_class: bool = False) -> Ranges:
    """Onig's Unicode ``\\s``, ``\\d`` and ``\\w`` (outside a class or
    inside one)."""
    if letter == "s":
        return _union(((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85)),
                      _property("Z"))
    if letter == "d":
        return _property("Nd")
    return _union(*(_property(c) for c in ("L", "M", "Nd", "Nl", "Pc")),
                  _ONIG_WORD_EXTRA, () if in_class else _ONIG_LATIN1_WORD)


def _class_re(ranges: Ranges) -> str:
    if not ranges:
        return "(?!)"
    return "[" + "".join(f"\\U{a:08x}" if a == b else
                         f"\\U{a:08x}-\\U{b:08x}" for a, b in ranges) + "]"


class _OnigReader:
    """One pass over an Onig pattern, writing its ``re`` translation."""

    def __init__(self, pattern: str):
        self.p, self.i = pattern, 0

    def refuse(self, what: str):
        raise NotImplementedError(
            f"Onig construct {what} in the regex {self.p!r}")

    def translate(self) -> str:
        out: List[str] = []
        p = self.p
        while self.i < len(p):
            c = p[self.i]
            if c == "\\":
                kind, val = self.escape()
                out.append(_class_re(val) if kind == "set" else
                           re.escape(chr(val)) if kind == "char" else
                           self.anchor(val))
            elif c == "[":
                out.append(_class_re(self.bracket()))
            elif c == "(":
                out.append(self.group())
            elif c == "{":
                out.append(self.interval())
            elif c in "^$":
                out.append(f"(?m:{c})")   # Ruby's anchors are per line
                self.i += 1
            elif c in ")|*+?.":
                out.append(c)
                self.i += 1
            else:
                out.append(re.escape(c))
                self.i += 1
        return "".join(out)

    def hex_digits(self, n: int, braced: bool) -> int:
        """Up to ``n`` hex digits, or all of them inside braces."""
        p = self.p
        if braced:
            end = p.find("}", self.i)
            digits = p[self.i + 1:end] if end > 0 else ""
            self.i = end + 1 if end > 0 else len(p)
        else:
            digits = ""
            while len(digits) < n and p[self.i:self.i + 1] in _HEX:
                digits += p[self.i]
                self.i += 1
        if not digits or any(c not in _HEX for c in digits):
            self.refuse("a malformed hex escape")
        return int(digits, 16)

    def escape(self, in_class: bool = False) -> Tuple[str, object]:
        """``("set", ranges)``, ``("char", code point)`` or
        ``("anchor", letter)``."""
        p = self.p
        if self.i + 1 >= len(p):
            self.refuse("a trailing backslash")
        c = p[self.i + 1]
        self.i += 2
        if c in "pP":
            if not p.startswith("{", self.i) or "}" not in p[self.i:]:
                self.refuse(f"\\{c} without braces")
            end = p.index("}", self.i)
            name, self.i = p[self.i + 1:end], end + 1
            neg = (c == "P") != name.startswith("^")
            ranges = _property(name.lstrip("^"))
            return "set", _complement(ranges) if neg else ranges
        if c in "sdwSDW":
            ranges = _onig_class(c.lower(), in_class)
            return "set", _complement(ranges) if c.isupper() else ranges
        if c in _ESCAPED:
            return "char", ord(_ESCAPED[c])
        if c == "x":
            braced = p.startswith("{", self.i)
            cp = self.hex_digits(2, braced)
            if not braced and cp > 0x7F:
                self.refuse(f"the raw byte \\x{cp:02X}")
            return "char", cp
        if c == "u":
            return "char", self.hex_digits(4, False)
        if c in "AzZbB":
            return "anchor", c
        if c.isalnum():
            self.refuse(f"\\{c}")
        return "char", ord(c)

    def anchor(self, letter: str) -> str:
        if letter == "A":
            return r"\A"
        if letter == "z":
            return r"\Z"
        if letter == "Z":
            return r"(?=\n?\Z)"
        w = _class_re(_onig_class("w"))
        if letter == "b":
            return f"(?:(?<={w})(?!{w})|(?<!{w})(?={w}))"
        return f"(?:(?<={w})(?={w})|(?<!{w})(?!{w}))"

    def bracket(self) -> Ranges:
        p = self.p
        self.i += 1
        neg = p.startswith("^", self.i)
        self.i += neg
        parts: List[Ranges] = []
        first = True
        while True:
            if self.i >= len(p):
                self.refuse("an unclosed [")
            c = p[self.i]
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if p.startswith("[:", self.i):
                self.refuse("a POSIX bracket [:...:]")
            if c == "[":
                parts.append(self.bracket())
                continue
            if p.startswith("&&", self.i):
                self.refuse("a class intersection &&")
            kind, lo = self.class_atom()
            if kind == "set":
                parts.append(lo)
                continue
            if p.startswith("-", self.i) and p[self.i + 1:self.i + 2] not in (
                    "]", ""):
                self.i += 1
                kind, hi = self.class_atom()
                if kind != "char" or hi < lo:
                    self.refuse("a range that is not from char to char")
                parts.append([(lo, hi)])
            else:
                parts.append([(lo, lo)])
        ranges = _union(*parts)
        return _complement(ranges) if neg else ranges

    def class_atom(self) -> Tuple[str, object]:
        c = self.p[self.i]
        if c != "\\":
            self.i += 1
            return "char", ord(c)
        kind, val = self.escape(in_class=True)
        if kind == "anchor":
            if val == "b":
                return "char", 0x08   # backspace inside a class
            self.refuse(f"\\{val} in a class")
        return kind, val

    def group(self) -> str:
        p = self.p
        if not p.startswith("(?", self.i):
            self.i += 1
            return "("
        self.i += 2
        for head, out in ((":", "(?:"), ("=", "(?="), ("!", "(?!"),
                          ("<=", "(?<="), ("<!", "(?<!"), (">", "(?>")):
            if p.startswith(head, self.i):
                self.i += len(head)
                return out
        m = re.compile(r"<([A-Za-z_]\w*)>").match(p, self.i)
        if m:
            self.i = m.end()
            return f"(?P<{m.group(1)}>"
        m = re.compile(r"([im]*)(?:-([im]*))?([:)])").match(p, self.i)
        if m and (m.group(1) or m.group(2)):
            on, off, end = m.group(1), m.group(2) or "", m.group(3)
            self.i = m.end()
            # Ruby's m is Python's s (a dot that takes newlines)
            flags = on.replace("m", "s") + (
                "-" + off.replace("m", "s") if off else "")
            if end == ":":
                return f"(?{flags}:"
            if self.i == len(m.group(0)) + 2 and not off:
                return f"(?{flags})"   # at the start: the whole pattern
            self.refuse(f"the inline option (?{m.group(0)}")
        self.refuse(f"the group (?{p[self.i:self.i + 3]}")

    def interval(self) -> str:
        m = re.compile(r"\{(\d*)(,?)(\d*)\}").match(self.p, self.i)
        if not m or not (m.group(1) or m.group(3)):
            self.i += 1
            return r"\{"   # not an interval: a literal brace
        self.i = m.end()
        if self.p.startswith("+", self.i):
            self.refuse("a repeated interval {n,m}+")
        return m.group(0)


@functools.lru_cache(maxsize=64)
def onig_regex(pattern: str) -> "re.Pattern":
    """``pattern`` as Oniguruma reads it, compiled for ``re``. Constructs
    read: literals and escapes (``\\t \\n \\r \\f \\v \\a \\e \\xHH
    \\x{H...} \\uHHHH``), ``.``, classes ``[...]`` (negated, nested, ranges),
    ``\\p{..}``/``\\P{..}``/``\\p{^..}`` over general categories and their
    one-letter groups, ``\\s \\S \\d \\D \\w \\W`` as Onig reads them,
    groups (capturing, ``(?:``, named, atomic, lookahead and lookbehind),
    ``(?i:...)``/``(?m:...)`` and options at the start, quantifiers (lazy
    and possessive), intervals, alternation, ``^ $ \\A \\z \\Z \\b \\B``.
    Anything else raises ``NotImplementedError`` naming it."""
    out = _OnigReader(pattern).translate()
    try:
        return re.compile(out)
    except re.error as e:
        raise NotImplementedError(f"Onig regex {pattern!r}: {e}") from e


def onig_find_iter(rx: "re.Pattern", text: str
                   ) -> Iterator[Tuple[int, int]]:
    """The spans of ``rx`` in ``text`` as the ``onig`` crate's
    ``find_iter`` gives them: each search starts where the last match
    ended, and an empty match right there is skipped by one char."""
    pos, last = 0, None
    while pos <= len(text):
        m = rx.search(text, pos)
        if m is None:
            return
        s, e = m.span()
        if s == e and last == e:
            pos += 1
            continue
        yield s, e
        pos = last = e


# -- normalizers --------------------------------------------------------------
# each is (text, orig, base) -> (text, orig); base is the offset of the
# piece's own first input char

Normalizer = Callable[[str, List[int], int], Tuple[str, List[int]]]


def _unicode_form(form: str) -> Normalizer:
    held = _HELD[form]

    def norm(s: str) -> str:
        if not held or not any(_in(ord(c), held) for c in s):
            return unicodedata.normalize(form, s)
        return _norm_held(form, held, s)

    def run(text, orig, base):
        if unicodedata.is_normalized(form, text) and not (
                held and any(_in(ord(c), held) for c in text)):
            return text, orig
        # segments start at combining class 0; one that changes its
        # neighbour (a composition, a reordering) joins it
        segs: List[str] = []
        for c in text:
            if segs and (unicodedata.combining(c) or norm(segs[-1] + c)
                         != norm(segs[-1]) + norm(c)):
                segs[-1] += c
            else:
                segs.append(c)
        tr: Transform = []
        for s in segs:
            _replace(tr, s, norm(s))
        return _apply(orig, tr, base)
    return run


def _norm_held(form: str, held, s: str) -> str:
    out, run = [], []
    for c in s:
        if _in(ord(c), held):
            out.append(unicodedata.normalize(form, "".join(run)))
            out.append(c)
            run = []
        else:
            run.append(c)
    out.append(unicodedata.normalize(form, "".join(run)))
    return "".join(out)


def _lowercase(text, orig, base):
    if text == text.lower():
        return text, orig
    tr: Transform = []
    for c in text:
        low = c.lower()   # per char: no final-sigma rule, as in Rust
        tr.append((low[0], 0))
        tr.extend((x, 1) for x in low[1:])
    return _apply(orig, tr, base)


def _strip(left: bool, right: bool) -> Normalizer:
    def run(text, orig, base):
        a, b = 0, len(text)
        while left and a < b and is_space(text[a]):
            a += 1
        while right and b > a and is_space(text[b - 1]):
            b -= 1
        if (a, b) == (0, len(text)):
            return text, orig
        return _apply(orig, [(None, a)] + [(c, 0) for c in text[a:b]], base)
    return run


def _pattern(pattern: dict, owner: str) -> "re.Pattern":
    """A ``{"String": ...}`` or ``{"Regex": ...}`` pattern (the library
    compiles both with Oniguruma, the string escaped)."""
    if "String" in pattern:
        return re.compile(re.escape(pattern["String"]))
    if "Regex" in pattern:
        return onig_regex(pattern["Regex"])
    raise NotImplementedError(f"{owner} pattern {pattern!r}")


def _replace_normalizer(spec: dict) -> Normalizer:
    rx, content = _pattern(spec["pattern"], "Replace"), spec["content"]

    def run(text, orig, base):
        tr: Transform = []
        last = 0
        for s, e in onig_find_iter(rx, text):
            tr.extend((c, 0) for c in text[last:s])
            tr.append((None, e - s))
            tr.extend((c, 1) for c in content)
            last = e
        if not tr:
            return text, orig
        tr.extend((c, 0) for c in text[last:])
        return _apply(orig, tr, base)
    return run


def _filter_map(keep: Optional[Callable[[str], bool]] = None,
                to: Optional[Callable[[str], str]] = None) -> Normalizer:
    """The library's ``NormalizedString::filter`` then ``map``: the chars
    ``keep`` refuses dropped, each other one replaced by ``to(char)``."""
    def run(text, orig, base):
        tr: Transform = [(None, 1) if keep is not None and not keep(c)
                         else (to(c) if to is not None else c, 0)
                         for c in text]
        return _apply(orig, tr, base)
    return run


def _prepend(prefix: str) -> Normalizer:
    def run(text, orig, base):
        if not text or not prefix:
            return text, orig
        return prefix + text, orig[:1] * len(prefix) + orig
    return run


def _gpt2_byte_chars() -> List[str]:
    """GPT-2's byte alphabet: the printable Latin-1 bytes as themselves,
    every other byte as the next char from U+0100 on."""
    shown = {*range(0x21, 0x7F), *range(0xA1, 0xAD), *range(0xAE, 0x100)}
    extra = iter(range(0x100, 0x200))
    return [chr(b) if b in shown else chr(next(extra)) for b in range(256)]


BYTE_CHARS = _gpt2_byte_chars()   # byte -> its char


def _byte_level(text, orig, base):
    """Each char as the chars of its UTF-8 bytes (the ByteLevel normalizer,
    and the pre-tokenizer's last step)."""
    tr: Transform = []
    for c in text:
        bs = c.encode("utf-8")
        tr.append((BYTE_CHARS[bs[0]], 0))
        tr.extend((BYTE_CHARS[b], 1) for b in bs[1:])
    return _apply(orig, tr, base)


_NMT_DROP = frozenset([*range(0x01, 0x09), 0x0B, *range(0x0E, 0x20), 0x7F,
                       0x8F, 0x9F])
_NMT_SPACE = frozenset([0x09, 0x0A, 0x0C, 0x0D, 0x1680, *range(0x200B, 0x2010),
                        0x2028, 0x2029, 0x2581, 0xFEFF, 0xFFFD])


def _bert_normalizer(spec: dict) -> Normalizer:
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    if strip is None:
        strip = lower
    steps: List[Normalizer] = []
    if spec.get("clean_text", True):
        steps.append(_filter_map(
            lambda c: not _bert_control(c),
            lambda c: " " if c in "\t\n\r" or is_space(c) else c))
    if spec.get("handle_chinese_chars", True):
        def chinese(text, orig, base):
            tr: Transform = []
            for c in text:
                if _in(ord(c), _CJK):
                    tr.extend(((" ", 0), (c, 1), (" ", 1)))
                else:
                    tr.append((c, 0))
            return _apply(orig, tr, base)
        steps.append(chinese)
    if strip:
        steps += [_unicode_form("NFD"),
                  _filter_map(lambda c: not _crate_nonspacing(c))]
    if lower:
        steps.append(_lowercase)
    return _sequence(steps)


def _sequence(steps: Sequence[Normalizer]) -> Normalizer:
    def run(text, orig, base):
        for step in steps:
            text, orig = step(text, orig, base)
        return text, orig
    return run


class Precompiled:
    """A sentencepiece ``precompiled_charsmap``: a little-endian u32 trie
    size in bytes, a Darts-clone double array of u32 units, then the
    NUL-terminated replacement strings. Each grapheme cluster of fewer than
    six UTF-8 bytes is looked up whole; failing that (or for a longer one)
    each of its chars is looked up alone. A lookup takes the first (the
    shortest) key of a common-prefix search and replaces the whole chunk,
    as the ``spm_precompiled`` crate does."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob)
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.strings = blob[4 + size:]
        self.strings.decode("utf-8")   # the crate holds it as a String
        self._memo: Dict[str, Optional[str]] = {}

    def transform(self, chunk: str) -> Optional[str]:
        hit = self._memo.get(chunk, self)
        if hit is not self:
            return hit
        units, hit = self.units, None
        unit = units[0]
        pos = (unit >> 10) << ((unit & 512) >> 6)
        for c in chunk.encode("utf-8"):
            if c == 0:
                break
            pos ^= c
            unit = units[pos]
            if unit & 0x800000FF != c:
                break
            pos ^= (unit >> 10) << ((unit & 512) >> 6)
            if unit >> 8 & 1:
                start = units[pos] & 0x7FFFFFFF
                end = self.strings.find(b"\0", start)
                hit = self.strings[start:end if end >= 0 else None].decode()
                break
        self._memo[chunk] = hit
        return hit

    def normalize_str(self, text: str) -> str:
        return self(text, list(range(len(text))), 0)[0]

    def __call__(self, text, orig, base):
        tr: Transform = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    _replace(tr, g, norm)
                    continue
            for c in g:
                norm = self.transform(c)
                if norm is None:
                    tr.append((c, 0))
                else:
                    _replace(tr, c, norm)
        return _apply(orig, tr, base)


def make_normalizer(spec: Optional[dict]) -> Optional[Normalizer]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        return _sequence([make_normalizer(s) for s in spec["normalizers"]])
    if kind in _HELD:
        return _unicode_form(kind)
    if kind == "Replace":
        return _replace_normalizer(spec)
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        return _strip(spec.get("strip_left", True),
                      spec.get("strip_right", True))
    if kind == "Precompiled":
        return Precompiled(base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind == "StripAccents":
        return _filter_map(lambda c: not _combining_mark(c))
    if kind == "Prepend":
        return _prepend(spec["prepend"])
    if kind == "Nmt":
        return _filter_map(
            lambda c: ord(c) not in _NMT_DROP,
            lambda c: " " if ord(c) in _NMT_SPACE else c)
    if kind == "ByteLevel":
        return _byte_level
    raise NotImplementedError(f"normalizer type {kind!r}")


# -- pre-tokenizers -----------------------------------------------------------
# a piece is (text, orig, shift): shift is the input offset where the
# library's NormalizedString for it starts (``offsets_original().0``)

Piece = Tuple[str, List[int], int]
PreTokenizer = Callable[[Piece], List[Piece]]


def _slices(piece: Piece, spans) -> List[Piece]:
    text, orig, _ = piece
    return [(text[a:b], orig[a:b], orig[a]) for a, b in spans if b > a]


def _runs(text: str, key) -> List[Tuple[int, int, object]]:
    """Maximal runs of equal ``key(char)``: (start, end, key)."""
    out: List[Tuple[int, int, object]] = []
    for i, c in enumerate(text):
        k = key(c)
        if out and out[-1][2] == k:
            out[-1] = (out[-1][0], i + 1, k)
        else:
            out.append((i, i + 1, k))
    return out


def _whitespace_split(piece: Piece) -> List[Piece]:
    return _slices(piece, [(a, b) for a, b, space in _runs(piece[0], is_space)
                           if not space])


def _whitespace(piece: Piece) -> List[Piece]:
    """``\\w+|[^\\w\\s]+``, the matches kept."""
    def cls(c):
        return 1 if is_word(c) else 2 if is_space(c) else 3
    return _slices(piece, [(a, b) for a, b, k in _runs(piece[0], cls)
                           if k != 2])


def _metaspace(spec: dict) -> PreTokenizer:
    rep = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme", "always")
    # the legacy key: true is what the scheme says, false must say never
    if spec.get("add_prefix_space") is False and scheme != "never":
        raise ValueError("Metaspace: add_prefix_space false needs "
                         "prepend_scheme never")
    if scheme not in ("always", "first", "never"):
        raise NotImplementedError(f"Metaspace prepend_scheme {scheme!r}")
    split = spec.get("split", True)

    def run(piece: Piece) -> List[Piece]:
        text, orig, shift = piece
        text = text.replace(" ", rep)
        if (scheme == "always" or (scheme == "first" and shift == 0)) and (
                not text.startswith(rep)):
            text, orig = rep + text, orig[:1] + orig
        if not split:
            return [(text, orig, shift)]
        # MergedWithNext: each replacement char starts a piece, and a run
        # of them gives all but its last one a piece of its own
        starts = [0] + [i for i, c in enumerate(text) if c == rep and i]
        bounds = sorted(set(starts)) + [len(text)]
        return _slices((text, orig, shift), zip(bounds, bounds[1:]))
    return run


# the library's split behaviors, by their serialized names
_BEHAVIORS = {"removed": "Removed", "isolated": "Isolated",
              "mergedwithprevious": "MergedWithPrevious",
              "mergedwithnext": "MergedWithNext", "contiguous": "Contiguous"}
# GPT-2's split, which the ByteLevel pre-tokenizer uses
GPT2_SPLIT = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
              r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")


def _behavior(name: str) -> str:
    key = name.replace("_", "").lower()
    if key not in _BEHAVIORS:
        raise NotImplementedError(f"split behavior {name!r}")
    return _BEHAVIORS[key]


def _matches(text: str, spans) -> List[Tuple[int, int, bool]]:
    """``Pattern::find_matches``: the matched ``spans`` (in order) and the
    text between them, ``(start, end, is_match)``, covering ``text``."""
    out: List[Tuple[int, int, bool]] = []
    prev = 0
    for a, b in spans:
        if prev != a:
            out.append((prev, a, False))
        out.append((a, b, True))
        prev = b
    if prev != len(text):
        out.append((prev, len(text), False))
    return out


def _char_spans(text: str, pred) -> List[Tuple[int, int]]:
    """A char pattern's matches: each char ``pred`` holds for, alone."""
    return [(i, i + 1) for i, c in enumerate(text) if pred(c)]


def _split(piece: Piece, spans, behavior: str,
           invert: bool = False) -> List[Piece]:
    """``NormalizedString::split`` with a behavior, empty pieces dropped as
    ``PreTokenizedString::split`` drops them."""
    matches = _matches(piece[0], spans)
    if invert:
        matches = [(a, b, not m) for a, b, m in matches]
    if behavior == "Removed":
        return _slices(piece, [(a, b) for a, b, m in matches if not m])
    if behavior == "Isolated":
        return _slices(piece, [(a, b) for a, b, _ in matches])
    # MergedWithNext is MergedWithPrevious over the matches reversed
    if behavior == "MergedWithNext":
        matches = [(-b, -a, m) for a, b, m in reversed(matches)]
    out: List[List[int]] = []
    prev = False
    for a, b, m in matches:
        join = m == prev if behavior == "Contiguous" else m and not prev
        if join and out:
            out[-1][1] = b
        else:
            out.append([a, b])
        prev = m
    if behavior == "MergedWithNext":
        out = [[-b, -a] for a, b in reversed(out)]
    return _slices(piece, out)


def _split_pre_tokenizer(spec: dict) -> PreTokenizer:
    rx = _pattern(spec["pattern"], "Split")
    behavior = _behavior(spec["behavior"])
    invert = bool(spec.get("invert", False))
    return lambda piece: _split(piece, onig_find_iter(rx, piece[0]),
                                behavior, invert)


def _byte_level_pre_tokenizer(spec: dict) -> PreTokenizer:
    prefix = spec.get("add_prefix_space", True)
    rx = onig_regex(GPT2_SPLIT) if spec.get("use_regex", True) else None

    def run(piece: Piece) -> List[Piece]:
        text, orig, shift = piece
        if prefix and text and not text.startswith(" "):
            text, orig = " " + text, orig[:1] + orig
        pieces = [(text, orig, shift)]
        if rx is not None:
            pieces = _split(pieces[0], onig_find_iter(rx, text), "Isolated")
        return [(*_byte_level(t, o, sh), sh) for t, o, sh in pieces]
    return run


def _unicode_scripts(piece: Piece) -> List[Piece]:
    """A cut before each char whose script differs from the last char's
    that had one (the first such char too); chars of no script never cut,
    and those before the first cut are dropped, as in the library."""
    cuts: List[int] = []
    last = None
    for i, c in enumerate(piece[0]):
        k = script_class(c)
        if k != NO_SCRIPT:
            if k != last:
                cuts.append(i)
            last = k
    cuts.append(len(piece[0]))
    return _slices(piece, zip(cuts, cuts[1:]))


def _bert_pre_tokenizer(piece: Piece) -> List[Piece]:
    """Whitespace removed, then each punctuation char isolated."""
    return [q for w in _split(piece, _char_spans(piece[0], is_space),
                              "Removed")
            for q in _split(w, _char_spans(w[0], is_bert_punc), "Isolated")]


def make_pre_tokenizer(spec: Optional[dict]) -> Optional[PreTokenizer]:
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [make_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def run(piece: Piece) -> List[Piece]:
            pieces = [piece]
            for p in parts:
                pieces = [q for x in pieces for q in p(x)]
            return pieces
        return run
    if kind == "WhitespaceSplit":
        return _whitespace_split
    if kind == "Whitespace":
        return _whitespace
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "ByteLevel":
        return _byte_level_pre_tokenizer(spec)
    if kind == "Split":
        return _split_pre_tokenizer(spec)
    if kind == "BertPreTokenizer":
        return _bert_pre_tokenizer
    if kind == "Punctuation":
        behavior = _behavior(spec.get("behavior", "Isolated"))
        return lambda piece: _split(
            piece, _char_spans(piece[0], is_bert_punc), behavior)
    if kind == "Digits":
        behavior = ("Isolated" if spec.get("individual_digits", False)
                    else "Contiguous")
        return lambda piece: _split(
            piece, _char_spans(piece[0], _is_numeric), behavior)
    if kind == "UnicodeScripts":
        return _unicode_scripts
    if kind == "CharDelimiterSplit":
        delim = spec["delimiter"]
        return lambda piece: _split(
            piece, _char_spans(piece[0], delim.__eq__), "Removed")
    raise NotImplementedError(f"pre_tokenizer type {kind!r}")


# -- models -------------------------------------------------------------------

K_UNK_PENALTY = 10.0
DROPOUT_SEED = 0   # the default seed of BPE dropout's draws


def _byte_pieces(vocab: Dict[str, int], s: str) -> Optional[List[int]]:
    """Byte fallback: the ids of ``s``'s UTF-8 bytes as ``<0xNN>`` pieces,
    or None unless the vocabulary has every one."""
    ids = [vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
    return None if None in ids else ids


class Unigram:
    """Viterbi over the pieces, as ``tokenizers``' optimized Unigram
    encoder: candidates in increasing length, a strictly better score
    replaces, an unknown char scores ``min_score - 10`` and runs of unknown
    chars fuse into one ``unk_id``; with ``byte_fallback`` a piece that is
    not in the vocabulary (a fused unknown run) becomes its UTF-8 bytes'
    ``<0xNN>`` pieces where the vocabulary has them all."""

    def __init__(self, spec: dict):
        self.byte_fallback = bool(spec.get("byte_fallback"))
        vocab = spec["vocab"]
        self.unk_id = spec.get("unk_id")
        self.scores = [float(s) for _, s in vocab]
        self.vocab = {tok: i for i, (tok, _) in enumerate(vocab)}
        self.size = len(vocab)
        self.min_score = min(self.scores, default=float("inf"))
        self.max_len = max((len(t) for t, _ in vocab), default=1)

    def tokenize(self, text: str) -> List[int]:
        n = len(text)
        if not n:
            return []
        vocab, scores, unk = self.vocab, self.scores, self.unk_id
        unk_score = self.min_score - K_UNK_PENALTY
        best = [0.0] * (n + 1)
        start = [-1] * (n + 1)
        ids = [0] * (n + 1)
        for i in range(n):
            here, single = best[i], False
            for j in range(i + 1, min(n, i + self.max_len) + 1):
                tid = vocab.get(text[i:j])
                if tid is None:
                    continue
                s = scores[tid] + here
                if start[j] < 0 or s > best[j]:
                    best[j], start[j], ids[j] = s, i, tid
                single = single or j == i + 1
            if not single:
                if unk is None:
                    raise ValueError("Unigram: an unknown char and no unk_id")
                s = unk_score + here
                if start[i + 1] < 0 or s > best[i + 1]:
                    best[i + 1], start[i + 1], ids[i + 1] = s, i, unk
        out: List[str] = []
        end, fused = n, None
        while end > 0:
            i = start[end]
            if unk is not None and ids[end] == unk:
                fused = (i, fused[1] if fused else end)
            else:
                if fused:
                    out.append(text[fused[0]:fused[1]])
                    fused = None
                out.append(text[i:end])
            end = i
        if fused:
            out.append(text[fused[0]:fused[1]])
        result: List[int] = []
        for t in reversed(out):
            tid = vocab.get(t)
            fallback = (_byte_pieces(vocab, t) if tid is None
                        and self.byte_fallback else None)
            result.extend(fallback or [unk if tid is None else tid])
        return result


class BPE:
    """Byte-pair merges by rank over a word's chars, as ``tokenizers``'
    ``Word::merge_all`` (lowest rank first, then leftmost). With
    ``byte_fallback`` an unknown char becomes its UTF-8 bytes' ``<0xNN>``
    pieces where the vocabulary has them all (an unknown run before it is
    still pending, as in the library). With ``dropout`` p each merge popped
    is skipped with probability p, drawing from ``rng``; the skipped ones
    return to the queue after the next merge that is not skipped."""

    def __init__(self, spec: dict, rng: Optional[random.Random] = None):
        self.dropout = float(spec.get("dropout") or 0.0)
        if not 0.0 <= self.dropout <= 1.0:
            raise ValueError(f"BPE dropout {self.dropout} is not in [0, 1]")
        self.rng = rng if rng is not None else random.Random(DROPOUT_SEED)
        self.byte_fallback = bool(spec.get("byte_fallback"))
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.size = len(self.vocab)
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = bool(spec.get("fuse_unk"))
        self.ignore_merges = bool(spec.get("ignore_merges"))
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(spec.get("merges", [])):
            if isinstance(m, str):
                m = m.split(" ")
                if len(m) != 2:
                    raise ValueError(f"BPE merge {rank + 1} is not 'a b'")
            a, b = m
            new = self.vocab[a + b[len(self.prefix):]]
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, new)

    def tokenize(self, word: str) -> List[int]:
        if not word:
            return []
        vocab = self.vocab
        if self.ignore_merges and not self.dropout and word in vocab:
            return [vocab[word]]
        syms: List[int] = []
        unk: Optional[int] = None
        for k, ch in enumerate(word):
            s = (self.prefix if k else "") + ch + (
                self.suffix if k == len(word) - 1 else "")
            tid = vocab.get(s)
            fallback = (_byte_pieces(vocab, s) if tid is None
                        and self.byte_fallback else None)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
            elif fallback is not None:
                syms.extend(fallback)
            elif self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                if unk is None or not self.fuse_unk:
                    unk = vocab[self.unk]
        if unk is not None:
            syms.append(unk)
        return self._merge_all(syms)

    def _merge_all(self, c: List[int]) -> List[int]:
        n, merges = len(c), self.merges
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n)) + [-1]
        alive = [True] * n
        heap = [(merges[p][0], i, merges[p][1]) for i, p in
                enumerate(zip(c, c[1:])) if p in merges]
        heapq.heapify(heap)
        skipped: List[Tuple[int, int, int]] = []
        while heap:
            top = heapq.heappop(heap)
            if self.dropout and self.rng.random() < self.dropout:
                skipped.append(top)
                continue
            for m in skipped:
                heapq.heappush(heap, m)
            skipped.clear()
            _, pos, new = top
            q = nxt[pos]
            if not alive[pos] or q < 0:
                continue
            m = merges.get((c[pos], c[q]))
            if m is None or m[1] != new:
                continue
            c[pos], alive[q], nxt[pos] = new, False, nxt[q]
            if nxt[q] >= 0:
                prev[nxt[q]] = pos
            if prev[pos] >= 0:
                m = merges.get((c[prev[pos]], new))
                if m:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] >= 0:
                m = merges.get((new, c[nxt[pos]]))
                if m:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [x for x, a in zip(c, alive) if a]


class WordPiece:
    """Greedy longest match first from each position, the pieces after the
    first carrying ``continuing_subword_prefix``; a word longer than
    ``max_input_chars_per_word`` chars, or with a position no piece
    matches, is the unk token alone."""

    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.size = len(self.vocab)
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)
        self.max_len = max(map(len, self.vocab), default=0)

    def _unk(self) -> List[int]:
        if self.unk not in self.vocab:
            raise ValueError(f"WordPiece: the unk token {self.unk!r} is not "
                             "in the vocabulary")
        return [self.vocab[self.unk]]

    def tokenize(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return self._unk()
        ids: List[int] = []
        start = 0
        while start < len(word):
            # no piece is longer than the longest key
            end = min(len(word), start + self.max_len)
            while end > start:
                piece = word[start:end] if not start else (
                    self.prefix + word[start:end])
                if piece in self.vocab:
                    ids.append(self.vocab[piece])
                    break
                end -= 1
            if end == start:
                return self._unk()
            start = end
        return ids


class WordLevel:
    """A word's own id, else the unk token's."""

    def __init__(self, spec: dict):
        self.vocab: Dict[str, int] = dict(spec["vocab"])
        self.size = len(self.vocab)
        self.unk = spec.get("unk_token", "<unk>")

    def tokenize(self, word: str) -> List[int]:
        tid = self.vocab.get(word, self.vocab.get(self.unk))
        if tid is None:
            raise ValueError(f"WordLevel: {word!r} is unknown and the unk "
                             f"token {self.unk!r} is not in the vocabulary")
        return [tid]


def make_model(spec: dict, rng: Optional[random.Random] = None):
    kind = spec.get("type")
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "BPE":
        return BPE(spec, rng)
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "WordLevel":
        return WordLevel(spec)
    raise NotImplementedError(f"model type {kind!r}")


# -- the tokenizer ------------------------------------------------------------

@dataclasses.dataclass
class AddedToken:
    content: str
    special: bool = False
    lstrip: bool = False
    rstrip: bool = False
    single_word: bool = False
    normalized: bool = True

    @classmethod
    def from_json(cls, d: dict) -> "AddedToken":
        return cls(content=d["content"], special=d.get("special", False),
                   lstrip=d.get("lstrip", False),
                   rstrip=d.get("rstrip", False),
                   single_word=d.get("single_word", False),
                   normalized=d.get("normalized",
                                    not d.get("special", False)))


class TokenizerJson:
    """A ``tokenizer.json`` file's encoding pipeline (see the module)."""

    def __init__(self, spec: dict, rng: Optional[random.Random] = None):
        self.model = make_model(spec["model"], rng)
        self.normalizer = make_normalizer(spec.get("normalizer"))
        self.pre_tokenizer = make_pre_tokenizer(spec.get("pre_tokenizer"))
        self.added: Dict[str, int] = {}        # content -> id
        self._tokens: Dict[str, AddedToken] = {}
        self.add_tokens([AddedToken.from_json(t)
                         for t in spec.get("added_tokens") or []])

    @classmethod
    def from_file(cls, path, rng: Optional[random.Random] = None
                  ) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f), rng)

    # -- vocabulary --
    def token_to_id(self, token: str) -> Optional[int]:
        tid = self.added.get(token)
        return tid if tid is not None else self.model.vocab.get(token)

    def __len__(self) -> int:
        vocab = self.model.vocab
        return len(vocab) + sum(t not in vocab for t in self.added)

    def add_tokens(self, tokens: Sequence[AddedToken]) -> None:
        """As the library's ``AddedVocabulary::add_tokens``: a token keeps
        the model's id for its content, else takes the next free id; one
        whose content is already added keeps its id and takes the new
        flags."""
        for t in tokens:
            if not t.content:
                continue
            if t.content in self._tokens:
                self._tokens[t.content] = t
                continue
            tid = self.token_to_id(t.content)
            if tid is None:
                size = self.model.size
                top = max(self.added.values(), default=None)
                tid = size if top is None or (top < size and size) else (
                    top + 1)
            self.added[t.content] = tid
            self._tokens[t.content] = t
        self._matchers = []
        for normalized in (False, True):
            pats: Dict[str, AddedToken] = {}
            for t in self._tokens.values():
                if t.normalized != normalized:
                    continue
                pat = t.content
                if normalized and self.normalizer is not None:
                    pat = self.normalizer(pat, list(range(len(pat))), 0)[0]
                pats.setdefault(pat, t)
            rx = None
            if any(pats):
                rx = re.compile("|".join(re.escape(p) for p in sorted(
                    (p for p in pats if p), key=len, reverse=True)))
            self._matchers.append((rx, pats))

    def _split_added(self, piece: Piece, matcher) -> List[object]:
        """``AddedVocabulary::find_matches``: a piece's text split around
        the added tokens, leftmost longest, with their strip and
        single-word rules; tokens as ints, the rest as pieces."""
        rx, pats = matcher
        text = piece[0]
        if rx is None:   # still a slice: it starts at its first char
            return _slices(piece, [(0, len(text))])
        spans: List[Tuple[int, int, Optional[int]]] = []
        last = 0
        for m in rx.finditer(text):
            a, b = m.span()
            tok = pats[m.group()]
            if tok.single_word and (
                    (a and is_word(text[a - 1]))
                    or (b < len(text) and is_word(text[b]))):
                continue
            if tok.lstrip:
                k = a
                while k > 0 and is_space(text[k - 1]):
                    k -= 1
                a = max(k, last)
            if tok.rstrip:
                while b < len(text) and is_space(text[b]):
                    b += 1
            if last < a:
                spans.append((last, a, None))
            spans.append((a, b, self.added[tok.content]))
            last = b
        if last != len(text):
            spans.append((last, len(text), None))
        out: List[object] = []
        for (a, b, tid), sl in zip(spans, _slices(
                piece, [(a, b) for a, b, _ in spans])):
            out.append(sl if tid is None else tid)
        return out

    def encode(self, text: str) -> List[int]:
        """``encode(text, add_special_tokens=False).ids``."""
        if not text:
            return []
        items = self._split_added(
            (text, list(range(len(text))), 0), self._matchers[0])
        stage: List[object] = []
        for it in items:
            if isinstance(it, int):
                stage.append(it)
                continue
            t, orig, shift = it
            if self.normalizer is not None:
                t, orig = self.normalizer(t, orig, shift)
            if t:
                stage.extend(self._split_added((t, orig, shift),
                                               self._matchers[1]))
        ids: List[int] = []
        for it in stage:
            if isinstance(it, int):
                ids.append(it)
                continue
            pieces = [it] if self.pre_tokenizer is None else (
                self.pre_tokenizer(it))
            for p in pieces:
                ids.extend(self.model.tokenize(p[0]))
        return ids


# -- the files beside it ------------------------------------------------------

SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                "pad_token", "cls_token", "mask_token")
# XLMRobertaTokenizerFast's and RobertaTokenizerFast's defaults; their
# mask token (named or not) strips the space before it
XLMR_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>",
                 "unk_token": "<unk>", "sep_token": "</s>",
                 "pad_token": "<pad>", "cls_token": "<s>",
                 "mask_token": "<mask>"}
_LSTRIP_MASK = ("XLMRobertaTokenizer", "RobertaTokenizer")
# each fast class's defaults for what the files do not name; GPT-2 names
# no cls, sep or pad
CLASS_SPECIALS = {
    "XLMRobertaTokenizer": XLMR_SPECIALS,
    "RobertaTokenizer": XLMR_SPECIALS,
    "GPT2Tokenizer": {k: "<|endoftext|>"
                      for k in ("bos_token", "eos_token", "unk_token")},
    "BertTokenizer": {"unk_token": "[UNK]", "sep_token": "[SEP]",
                      "pad_token": "[PAD]", "cls_token": "[CLS]",
                      "mask_token": "[MASK]"},
}
# AutoTokenizer's class for a config.json without tokenizer_class
_MODEL_TYPES = {"xlm-roberta": "XLMRobertaTokenizer",
                "roberta": "RobertaTokenizer", "gpt2": "GPT2Tokenizer",
                "bert": "BertTokenizer"}
# BertNormalizer's options as the library fills them in
_BERT_NORMALIZER = {"clean_text": True, "handle_chinese_chars": True,
                    "strip_accents": None, "lowercase": True}


def _read_json(path: Path) -> dict:
    if not path.exists():
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _as_built(spec: dict, cls_name: Optional[str], init: dict) -> dict:
    """``tokenizer.json`` as ``transformers`` rebuilds its parts: the base
    class sets the top ByteLevel pre-tokenizer's ``add_prefix_space`` to
    the config's (default false); ``BertTokenizerFast`` sets a
    BertNormalizer's ``lowercase``, ``strip_accents`` and
    ``handle_chinese_chars`` to ``do_lower_case`` (default true),
    ``strip_accents`` and ``tokenize_chinese_chars`` (default true)."""
    pre = spec.get("pre_tokenizer")
    if isinstance(pre, dict) and pre.get("type") == "ByteLevel":
        spec["pre_tokenizer"] = dict(
            pre, add_prefix_space=bool(init.get("add_prefix_space", False)))
    if cls_name == "BertTokenizer":
        norm = spec.get("normalizer")
        if norm is None:
            raise ValueError("BertTokenizerFast reads the normalizer's "
                             "options, and this tokenizer.json has none")
        if norm.get("type") == "BertNormalizer":
            want = {"lowercase": init.get("do_lower_case", True),
                    "strip_accents": init.get("strip_accents"),
                    "handle_chinese_chars": init.get(
                        "tokenize_chinese_chars", True)}
            spec["normalizer"] = {**_BERT_NORMALIZER, **norm, **want}
    return spec


def load_pretrained(tokenizer_dir, rng: Optional[random.Random] = None
                    ) -> Tuple[TokenizerJson, Dict[str, Optional[str]]]:
    """A saved fast tokenizer directory, as ``transformers``'
    ``AutoTokenizer.from_pretrained`` reads it: ``tokenizer.json`` with
    the parts its class rebuilds (:func:`_as_built`), then the special
    tokens of ``tokenizer_config.json`` (overridden by
    ``special_tokens_map.json`` where the config has no
    ``added_tokens_decoder``), the class's defaults
    (:data:`CLASS_SPECIALS`) for what neither names, and each named token
    that the file does not add yet added as a special token. ``rng`` draws
    BPE dropout. Returns the tokenizer and each special key's content
    (None where unnamed)."""
    d = Path(tokenizer_dir)
    path = d / "tokenizer.json"
    if not path.exists():
        present = sorted(p.name for p in d.iterdir()) if d.is_dir() else []
        raise FileNotFoundError(
            f"{d} has no tokenizer.json (found {present}); the port reads "
            "the tokenizers library's tokenizer.json only, not "
            "sentencepiece.bpe.model")
    init = _read_json(d / "tokenizer_config.json")
    cls_name = init.get("tokenizer_class") or _MODEL_TYPES.get(
        _read_json(d / "config.json").get("model_type"))
    if cls_name and cls_name.endswith("Fast"):
        cls_name = cls_name[:-len("Fast")]
    tok = TokenizerJson(_as_built(_read_json(path), cls_name, init), rng)
    given: Dict[str, object] = {k: init[k] for k in SPECIAL_KEYS
                                if k in init}
    extra = list(init.get("additional_special_tokens") or [])
    if "added_tokens_decoder" not in init:
        smap = _read_json(d / "special_tokens_map.json")
        for k, v in smap.items():
            if k == "additional_special_tokens":
                extra += [t for t in v if t not in extra]
            elif k in SPECIAL_KEYS:
                given[k] = dict(v, special=True) if isinstance(v, dict) else v
    given = {**CLASS_SPECIALS.get(cls_name, {}), **given}
    if cls_name in _LSTRIP_MASK and isinstance(given.get("mask_token"), str):
        given["mask_token"] = {"content": given["mask_token"],
                               "lstrip": True, "normalized": False}

    def content(v) -> Optional[str]:
        return v["content"] if isinstance(v, dict) else v

    specials = {k: content(given.get(k)) for k in SPECIAL_KEYS}
    names = {c for c in specials.values() if c is not None} | {
        content(t) for t in extra}
    to_add: List[AddedToken] = []
    for _, t in sorted((int(i), t) for i, t in (
            init.get("added_tokens_decoder") or {}).items()):
        to_add.append(_added(t, names))
    for v in [given[k] for k in SPECIAL_KEYS if given.get(k) is not None
              ] + extra:
        # a token named by its content alone is not added again
        if not (isinstance(v, str) and (v in tok.added or any(
                t.content == v for t in to_add))):
            to_add.append(_added(v, names))
    tok.add_tokens(to_add)
    return tok, specials


def _added(v, names) -> AddedToken:
    """A token transformers adds as named: special when it is or when one
    of the special keys names it; a special one is not normalized unless
    it says so."""
    if isinstance(v, str):
        return AddedToken(v, special=True, normalized=False)
    special = bool(v.get("special")) or v["content"] in names
    return AddedToken(v["content"], special=special,
                      lstrip=v.get("lstrip", False),
                      rstrip=v.get("rstrip", False),
                      single_word=v.get("single_word", False),
                      normalized=v.get("normalized", not special))
