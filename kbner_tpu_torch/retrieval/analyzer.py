"""Text analysis: Lucene standard-analyzer tokenization and the zh
analyzers (counterpart of ``kbner_tpu/retrieval/analyzer.py``).

Elasticsearch's ``standard`` analyzer is the UAX#29 word-break grammar plus
lowercasing, with no stopwords: MidLetter/MidNumLet/Single_Quote joins
(``don't``, ``U.S.A``, ``3.14``), ExtendNumLet joins (``foo_bar``), single
Han/Hiragana characters, joined Katakana runs, and Extend/Format chars
attached to the current token. zh is indexed with IK in the reference
recipe (``ik_max_word``/``ik_smart``): :class:`IkAnalyzer` segments Han runs
with a word list, and without one :func:`cjk_analyze` adds Han bigrams.
``kbner_tpu_torch/native`` analyzes whole batches of documents with the
standard and bigram rules in one native call, with tables generated from
:func:`_wb_class` below.
"""

from __future__ import annotations

import re
import unicodedata
from pathlib import Path
from typing import List, Tuple

# -- UAX#29 Word_Break classes (the subset relevant to the KB's languages) --

_HAN_RANGES = (
    (0x3400, 0x4DBF), (0x4E00, 0x9FFF), (0xF900, 0xFAFF),
    (0x20000, 0x2EBEF),
)
_HIRAGANA_RANGES = ((0x3041, 0x3096), (0x309D, 0x309F))
_KATAKANA_RANGES = ((0x30A1, 0x30FA), (0x30FC, 0x30FF), (0x31F0, 0x31FF),
                    (0xFF66, 0xFF9D))

_MIDLETTER = frozenset({0x00B7, 0x0387, 0x05F4, 0x2027, 0xFE13, 0xFE55,
                        0xFF1A})
_MIDNUMLET = frozenset({0x002E, 0x2019, 0x2024, 0xFE52, 0xFF07, 0xFF0E})
_SINGLE_QUOTE = frozenset({0x0027})
_MIDNUM = frozenset({0x002C, 0x003B, 0x037E, 0x066C, 0xFE10, 0xFE14,
                     0xFE50, 0xFE54, 0xFF0C, 0xFF1B})
_EXTENDNUMLET = frozenset({0x005F, 0x203F, 0x2040, 0x2054, 0xFE33, 0xFE34,
                           0xFE4D, 0xFE4E, 0xFE4F, 0xFF3F})

# class tags
(_OTHER, _ALETTER, _NUMERIC, _KATAKANA, _HAN, _HIRAGANA, _ENL, _MID_LET,
 _MID_NUMLET, _MID_NUM, _SQ, _EXTEND) = range(12)

_WORD_CLASSES = (_ALETTER, _NUMERIC, _KATAKANA, _ENL)
# no-break pairs among word classes (WB5, WB8-10, WB13, WB13a/b)
_JOINS = {
    (_ALETTER, _ALETTER), (_ALETTER, _NUMERIC),
    (_NUMERIC, _ALETTER), (_NUMERIC, _NUMERIC),
    (_KATAKANA, _KATAKANA),
    (_ALETTER, _ENL), (_NUMERIC, _ENL), (_KATAKANA, _ENL), (_ENL, _ENL),
    (_ENL, _ALETTER), (_ENL, _NUMERIC), (_ENL, _KATAKANA),
}


def _in_ranges(cp: int, ranges) -> bool:
    return any(lo <= cp <= hi for lo, hi in ranges)


def _wb_class(ch: str) -> int:
    cp = ord(ch)
    if _in_ranges(cp, _HAN_RANGES):
        return _HAN
    if _in_ranges(cp, _HIRAGANA_RANGES):
        return _HIRAGANA
    if _in_ranges(cp, _KATAKANA_RANGES):
        return _KATAKANA
    if cp in _EXTENDNUMLET:
        return _ENL
    if cp in _MIDNUMLET:
        return _MID_NUMLET
    if cp in _SINGLE_QUOTE:
        return _SQ
    if cp in _MIDLETTER:
        return _MID_LET
    if cp in _MIDNUM:
        return _MID_NUM
    cat = unicodedata.category(ch)
    if cat == "Nd":
        return _NUMERIC
    if cat[0] == "L" or cat == "Nl":
        return _ALETTER
    if cat in ("Mn", "Mc", "Me", "Cf"):
        return _EXTEND
    return _OTHER


# The same rules on ASCII text, as one regex: a run of letters, digits and
# '_' (all of which join), continued across '.' or "'" between two letters
# and across '.', ',', ';' or "'" between two digits. Every other ASCII
# character breaks; a token of '_' alone is dropped.
_ASCII_TOKEN_RE = re.compile(
    r"[A-Za-z0-9_]+(?:(?:(?<=[A-Za-z])[.'](?=[A-Za-z])"
    r"|(?<=[0-9])[.,;'](?=[0-9]))[A-Za-z0-9_]+)*")
_CORE_RE = re.compile(r"[A-Za-z0-9]")


def analyze_with_offsets(text: str) -> List[Tuple[str, int, int]]:
    """Lucene standard-analyzer tokenization + lowercasing, with
    ``(token, start, end)`` character offsets into the original text
    (the offsets ES highlighting wraps its ``<hit>`` tags around). See
    module docstring for the UAX#29 rules implemented. ASCII text takes
    one regex with the same result, about 40 times faster."""
    if text.isascii():
        return [(m.group().lower(), m.start(), m.end())
                for m in _ASCII_TOKEN_RE.finditer(text)
                if "_" not in m.group() or _CORE_RE.search(m.group())]
    tokens: List[Tuple[str, int, int]] = []
    cur: List[str] = []
    cur_start = 0          # offset of the current token's first char
    cur_end = 0            # offset AFTER its last appended char
    prev_cls = _OTHER      # class of the last base char of the current token
    has_core = False       # current token contains a non-ENL word char

    def flush() -> None:
        nonlocal cur, prev_cls, has_core
        if cur and has_core:
            tokens.append(("".join(cur).lower(), cur_start, cur_end))
        cur = []
        prev_cls = _OTHER
        has_core = False

    def push(ch: str, i: int) -> None:
        nonlocal cur_start, cur_end
        if not cur:
            cur_start = i
        cur.append(ch)
        cur_end = i + 1

    n = len(text)
    i = 0
    while i < n:
        ch = text[i]
        c = _wb_class(ch)
        if c == _EXTEND:
            # WB4: combining/format chars attach, don't change the class
            if cur:
                push(ch, i)
            i += 1
            continue
        if c in (_HAN, _HIRAGANA):
            # Lucene's grammar: ideographic / hiragana single-char tokens
            flush()
            tokens.append((ch, i, i + 1))
            i += 1
            continue
        if c in _WORD_CLASSES:
            if cur and (prev_cls, c) not in _JOINS:
                flush()
            push(ch, i)
            prev_cls = c
            has_core = has_core or c != _ENL
            i += 1
            continue
        if c in (_MID_LET, _MID_NUMLET, _MID_NUM, _SQ) and cur:
            # WB6/7, WB11/12: join iff a matching word char follows
            # (skipping Extend/Format chars)
            j = i + 1
            while j < n and _wb_class(text[j]) == _EXTEND:
                j += 1
            nxt = _wb_class(text[j]) if j < n else _OTHER
            letter_join = (prev_cls == _ALETTER and nxt == _ALETTER
                           and c in (_MID_LET, _MID_NUMLET, _SQ))
            numeric_join = (prev_cls == _NUMERIC and nxt == _NUMERIC
                            and c in (_MID_NUM, _MID_NUMLET, _SQ))
            if letter_join or numeric_join:
                push(ch, i)  # prev_cls stays the base class
                i += 1
                continue
            flush()
            i += 1
            continue
        flush()
        i += 1
    flush()
    return tokens


def standard_analyze(text: str) -> List[str]:
    """Lucene standard-analyzer tokenization + lowercasing (see module
    docstring for the UAX#29 rules implemented)."""
    return [t for t, _, _ in analyze_with_offsets(text)]


def highlight_hits(text: str, query_terms, pre: str = "<hit>",
                   post: str = "</hit>") -> str:
    """ES-style highlight fragment: every analyzer token of ``text`` whose
    form is in ``query_terms`` is wrapped in ``pre``/``post``. Returns ""
    when nothing matches, as the reference writes the empty fragment
    then."""
    terms = {t.lower() for t in query_terms}
    if not terms:
        return ""
    spans = [(s, e) for tok, s, e in analyze_with_offsets(text)
             if tok in terms]
    if not spans:
        return ""
    out: List[str] = []
    last = 0
    for s, e in spans:
        out.extend((text[last:s], pre, text[s:e], post))
        last = e
    out.append(text[last:])
    return "".join(out)


def _is_cjk_single(tok: str) -> bool:
    return len(tok) == 1 and _in_ranges(ord(tok), _HAN_RANGES)


def cjk_analyze(text: str) -> List[str]:
    """The zh analyzer without a dictionary: the standard tokens, each
    single Han character followed by its bigram with the Han character
    before it."""
    base = standard_analyze(text)
    out: List[str] = []
    prev_cjk = None
    for tok in base:
        out.append(tok)
        if _is_cjk_single(tok):
            if prev_cjk is not None:
                out.append(prev_cjk + tok)
            prev_cjk = tok
        else:
            prev_cjk = None
    return out


class IkAnalyzer:
    """IK-style dictionary analyzer for zh (``ik_max_word`` /
    ``ik_smart``). Over each run of adjacent single Han tokens of the
    standard tokenization:

    * ``smart=False`` (ik_max_word): every dictionary word at every
      position, overlapping ("北京大学" with {北京, 大学, 北京大学} gives all
      three), then each character no word covers as a unigram;
    * ``smart=True`` (ik_smart): greedy forward maximum matching, one
      segmentation, longest word first.

    Other tokens pass through as the standard analyzer makes them. The
    dictionary is a word-per-line file (``#`` comments), as IK's
    ``main.dic``; words shorter than two characters are ignored.
    """

    def __init__(self, words, smart: bool = False):
        self.words = {w for w in words if len(w) >= 2}
        self.smart = smart
        self.max_len = max((len(w) for w in self.words), default=1)
        # the prefixes end a position's scan without a trie
        self.prefixes = {w[:i] for w in self.words
                         for i in range(1, len(w))}

    @classmethod
    def from_file(cls, dict_path, smart: bool = False) -> "IkAnalyzer":
        words = []
        with open(dict_path, encoding="utf-8") as f:
            for line in f:
                w = line.strip()
                if w and not w.startswith("#"):
                    words.append(w)
        return cls(words, smart=smart)

    def _han_run(self, run: str) -> List[str]:
        n = len(run)
        out: List[str] = []
        if self.smart:
            i = 0
            while i < n:
                for L in range(min(self.max_len, n - i), 1, -1):
                    if run[i:i + L] in self.words:
                        out.append(run[i:i + L])
                        i += L
                        break
                else:
                    out.append(run[i])
                    i += 1
            return out
        covered = [False] * n
        for i in range(n):
            for L in range(2, min(self.max_len, n - i) + 1):
                piece = run[i:i + L]
                if piece in self.words:
                    out.append(piece)
                    for j in range(i, i + L):
                        covered[j] = True
                if L < n - i + 1 and piece not in self.prefixes \
                        and piece not in self.words:
                    break
        for i in range(n):
            if not covered[i]:
                out.append(run[i])
        return out

    def __call__(self, text: str) -> List[str]:
        toks = analyze_with_offsets(text)
        out: List[str] = []
        run: List[str] = []
        last_end = None
        for tok, s, e in toks:
            if _is_cjk_single(tok) and (last_end is None or s == last_end
                                        or not run):
                if run and s != last_end:
                    out.extend(self._han_run("".join(run)))
                    run = []
                run.append(tok)
                last_end = e
                continue
            if run:
                out.extend(self._han_run("".join(run)))
                run = []
                last_end = None
            out.append(tok)
        if run:
            out.extend(self._han_run("".join(run)))
        return out


def builtin_zh_lexicon() -> Path:
    """The checked-in zh word list (about 3.5k common words), the
    dictionary ``--ik_dict builtin`` names."""
    return Path(__file__).parent / "zh_lexicon.txt"


def get_analyzer(lang: str = "en", dict_path=None, smart: bool = False):
    """The index analyzer of a language: for zh an :class:`IkAnalyzer`
    over ``dict_path`` (``"builtin"``: :func:`builtin_zh_lexicon`;
    ``smart`` for ik_smart), else the char-bigram :func:`cjk_analyze`;
    the standard analyzer for every other language."""
    if lang == "zh":
        if dict_path is not None:
            if dict_path == "builtin":
                dict_path = builtin_zh_lexicon()
            return IkAnalyzer.from_file(dict_path, smart=smart)
        return cjk_analyze
    return standard_analyze
