"""The ``tokenizer.json`` pipeline of HF ``tokenizers``, read with ``json``.

:class:`TokenizerJson` gives the ids of ``Tokenizer.encode(text,
add_special_tokens=False)`` for what XLM-R's published file and the repo's
fixtures use:

- added tokens (``special``, ``lstrip``, ``rstrip``, ``single_word``,
  ``normalized``), split out of the text longest match first, the
  un-normalized ones before normalization and the others after it;
- normalizers ``Sequence``, ``NFC``/``NFD``/``NFKC``/``NFKD``, ``Replace``,
  ``Lowercase``, ``Strip`` and ``Precompiled`` (a sentencepiece charsmap:
  a Darts-clone double array walked per grapheme cluster);
- pre-tokenizers ``Sequence``, ``WhitespaceSplit``, ``Whitespace`` and
  ``Metaspace`` (``prepend_scheme``/``split``, or the legacy
  ``add_prefix_space``);
- the ``Unigram`` and ``BPE`` models.

Any other type raises ``NotImplementedError`` naming it. The post-processor
and the decoder are read and ignored: they add nothing without special
tokens. :func:`load_pretrained` adds what ``transformers``' fast tokenizers
read beside the file: the special tokens of ``tokenizer_config.json`` and
``special_tokens_map.json``.

Normalization keeps, per character, the input offset it came from, as the
library's ``NormalizedString`` alignments do; Metaspace's ``first`` scheme
reads it. The library's Unicode tables are older than Python's: the code
points in ``_HELD`` keep their form under its decompositions, and they keep
it here.
"""

from __future__ import annotations

import base64
import dataclasses
import heapq
import json
import re
import struct
import unicodedata
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def _replace_normalizer(spec: dict) -> Normalizer:
    pattern, content = spec["pattern"], spec["content"]
    if "String" in pattern:
        rx = re.compile(re.escape(pattern["String"]))
    elif "Regex" in pattern:
        try:
            rx = re.compile(pattern["Regex"])
        except re.error as e:
            raise NotImplementedError(
                f"Replace pattern {pattern['Regex']!r}: {e}") from e
    else:
        raise NotImplementedError(f"Replace pattern {pattern!r}")

    def run(text, orig, base):
        tr: Transform = []
        last = 0
        for m in rx.finditer(text):
            s, e = m.span()
            tr.extend((c, 0) for c in text[last:s])
            tr.append((None, e - s))
            tr.extend((c, 1) for c in content)
            last = e
        if not last and not tr:
            return text, orig
        tr.extend((c, 0) for c in text[last:])
        return _apply(orig, tr, base)
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
        parts = [make_normalizer(s) for s in spec["normalizers"]]

        def run(text, orig, base):
            for p in parts:
                text, orig = p(text, orig, base)
            return text, orig
        return run
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
    raise NotImplementedError(f"pre_tokenizer type {kind!r}")


# -- models -------------------------------------------------------------------

K_UNK_PENALTY = 10.0


class Unigram:
    """Viterbi over the pieces, as ``tokenizers``' optimized Unigram
    encoder: candidates in increasing length, a strictly better score
    replaces, an unknown char scores ``min_score - 10`` and runs of unknown
    chars fuse into one ``unk_id``."""

    def __init__(self, spec: dict):
        if spec.get("byte_fallback"):
            raise NotImplementedError("Unigram byte_fallback")
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
        return [vocab.get(t, unk) for t in reversed(out)]


class BPE:
    """Byte-pair merges by rank over a word's chars, as ``tokenizers``'
    ``Word::merge_all`` (lowest rank first, then leftmost)."""

    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise NotImplementedError("BPE dropout")
        if spec.get("byte_fallback"):
            raise NotImplementedError("BPE byte_fallback")
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
        if self.ignore_merges and word in vocab:
            return [vocab[word]]
        syms: List[int] = []
        unk: Optional[int] = None
        for k, ch in enumerate(word):
            s = (self.prefix if k else "") + ch + (
                self.suffix if k == len(word) - 1 else "")
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
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
        while heap:
            _, pos, new = heapq.heappop(heap)
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


def make_model(spec: dict):
    kind = spec.get("type")
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "BPE":
        return BPE(spec)
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

    def __init__(self, spec: dict):
        self.model = make_model(spec["model"])
        self.normalizer = make_normalizer(spec.get("normalizer"))
        self.pre_tokenizer = make_pre_tokenizer(spec.get("pre_tokenizer"))
        self.added: Dict[str, int] = {}        # content -> id
        self._tokens: Dict[str, AddedToken] = {}
        self.add_tokens([AddedToken.from_json(t)
                         for t in spec.get("added_tokens") or []])

    @classmethod
    def from_file(cls, path) -> "TokenizerJson":
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f))

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
        whose content is already added is ignored."""
        for t in tokens:
            if not t.content or t.content in self._tokens:
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
# XLMRobertaTokenizerFast's defaults; its mask token strips the space
# before it
XLMR_SPECIALS = {"bos_token": "<s>", "eos_token": "</s>",
                 "unk_token": "<unk>", "sep_token": "</s>",
                 "pad_token": "<pad>", "cls_token": "<s>",
                 "mask_token": {"content": "<mask>", "lstrip": True}}
_XLMR_CLASSES = ("XLMRobertaTokenizer", "XLMRobertaTokenizerFast")


def _read_json(path: Path) -> dict:
    if not path.exists():
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_pretrained(tokenizer_dir) -> Tuple[TokenizerJson,
                                            Dict[str, Optional[str]]]:
    """A saved fast tokenizer directory, as ``transformers``'
    ``AutoTokenizer.from_pretrained`` reads it: ``tokenizer.json``, then
    the special tokens of ``tokenizer_config.json`` (overridden by
    ``special_tokens_map.json`` where the config has no
    ``added_tokens_decoder``), XLM-R's defaults for what neither names
    when the class is XLM-R's, and each named token that the file does not
    add yet added as a special token. Returns the tokenizer and each
    special key's content (None where unnamed)."""
    d = Path(tokenizer_dir)
    path = d / "tokenizer.json"
    if not path.exists():
        present = sorted(p.name for p in d.iterdir()) if d.is_dir() else []
        raise FileNotFoundError(
            f"{d} has no tokenizer.json (found {present}); the port reads "
            "the tokenizers library's tokenizer.json only, not "
            "sentencepiece.bpe.model")
    tok = TokenizerJson.from_file(path)
    init = _read_json(d / "tokenizer_config.json")
    cls_name = init.get("tokenizer_class") or {
        "xlm-roberta": "XLMRobertaTokenizer"}.get(
        _read_json(d / "config.json").get("model_type"))
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
    if cls_name in _XLMR_CLASSES:
        given = {**XLMR_SPECIALS, **given}

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
