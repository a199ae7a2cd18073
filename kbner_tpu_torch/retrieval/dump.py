"""MediaWiki XML dump ingestion (counterpart of
``kbner_tpu/retrieval/dump.py``, the reference's ``kb/dumps`` stage with
``parse_text.py``'s walk over its DumpDB):

  - :func:`iter_dump_pages` streams pages from a ``pages-articles.xml`` or
    ``.xml.bz2`` export in constant memory;
  - :func:`wikitext_to_paragraphs` turns wiki markup into plain paragraphs
    with the character spans of their links;
  - :func:`build_redirects` and :func:`dump_to_jsonl` write the
    ``parse_text.py`` JSONL schema (``{title, p_id, s_id, sentence,
    paragraph, url}``), links resolved through redirects and re-inserted
    as ``<e:Title>mention</e>``, paragraphs deduplicated per page,
    sentences split per language.

The dump itself is an input: nothing here downloads it.
"""

from __future__ import annotations

import bz2
import dataclasses
import json
import re
import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from .wikitext import insert_anchors, split_sentences

# namespaces whose links are dropped from text entirely (media/meta)
_DROP_LINK_NS = {
    "file", "image", "media", "category", "wikipedia", "template", "help",
    "portal", "book", "draft", "timedtext", "module", "special", "wikt",
    "wiktionary", "commons",
}

_COMMENT_RE = re.compile(r"<!--.*?-->", re.S)
_REF_RE = re.compile(
    r"<ref[^>/]*/\s*>|<ref[^>]*>.*?</ref\s*>", re.S | re.I)
_DROPTAG_RE = re.compile(
    r"<(math|gallery|timeline|score|syntaxhighlight|source|pre|code)"
    r"[^>]*>.*?</\1\s*>", re.S | re.I)
_HTMLTAG_RE = re.compile(r"</?[a-zA-Z][^>]*?>")
_EXTLINK_RE = re.compile(r"\[(?:https?|ftp)://[^\s\]]+\s+([^\]]*)\]")
_BARE_EXTLINK_RE = re.compile(r"\[(?:https?|ftp)://[^\s\]]*\]")
_URL_RE = re.compile(r"(?:https?|ftp)://\S+")
_QUOTES_RE = re.compile(r"'{2,}")
_HEADING_RE = re.compile(r"^\s*=+.*=+\s*$")
_LIST_PREFIX_RE = re.compile(r"^[\s*#:;]+")
_MAGIC_RE = re.compile(r"__[A-Z]+__")


@dataclasses.dataclass
class DumpPage:
    title: str
    ns: int
    redirect: Optional[str]  # redirect target title, if any
    text: str


def _open_dump(path: str | Path):
    path = Path(path)
    if path.suffix == ".bz2":
        return bz2.open(path, "rb")
    return open(path, "rb")


def iter_dump_pages(path: str | Path) -> Iterator[DumpPage]:
    """Stream ``<page>`` elements from a MediaWiki export XML.

    Memory stays constant: elements are cleared as soon as each page is
    yielded. Tag namespaces (``{http://www.mediawiki.org/...}``) are
    stripped so every export schema version parses identically.
    """
    with _open_dump(path) as f:
        context = ET.iterparse(f, events=("end",))
        for _, elem in context:
            tag = elem.tag.rsplit("}", 1)[-1]
            if tag != "page":
                continue
            title = ns = redirect = None
            text = ""
            for child in elem.iter():
                ctag = child.tag.rsplit("}", 1)[-1]
                if ctag == "title" and title is None:
                    title = child.text or ""
                elif ctag == "ns" and ns is None:
                    ns = int(child.text or 0)
                elif ctag == "redirect" and redirect is None:
                    redirect = child.get("title", "")
                elif ctag == "text":
                    text = child.text or ""
            yield DumpPage(title or "", ns or 0, redirect, text)
            elem.clear()


def normalize_title(title: str) -> str:
    """Canonical article-title form: underscores to spaces, fragment
    stripped, first letter uppercased (MediaWiki title semantics)."""
    t = title.split("#", 1)[0].replace("_", " ").strip()
    return t[:1].upper() + t[1:] if t else t


def _strip_nested(text: str, open_s: str, close_s: str) -> str:
    """Remove nested ``open_s ... close_s`` regions (templates, tables)."""
    out: List[str] = []
    depth = 0
    i = 0
    n = len(text)
    lo, lc = len(open_s), len(close_s)
    while i < n:
        if text.startswith(open_s, i):
            depth += 1
            i += lo
        elif depth and text.startswith(close_s, i):
            depth -= 1
            i += lc
        elif depth == 0:
            out.append(text[i])
            i += 1
        else:
            i += 1
    return "".join(out)


def _link_target_label(inner: str) -> Tuple[Optional[str], str]:
    """Parse ``Title|label`` link innards -> (target or None-to-drop,
    label). Media/category/interlanguage links are dropped."""
    target, sep, label = inner.partition("|")
    t = target.strip()
    if ":" in t:
        prefix = t.split(":", 1)[0].strip().lower()
        if prefix in _DROP_LINK_NS or (len(prefix) in (2, 3)
                                       and prefix.isalpha()):
            return None, ""
    if not sep:
        label = t
    elif not label.strip():  # pipe trick: [[Title (x)|]] -> Title
        label = re.sub(r"\s*\(.*?\)\s*$", "", t)
    return t, label


def _replace_links(text: str) -> Tuple[str, List[Tuple[str, int, int]]]:
    """Replace ``[[...]]`` links with their labels, returning the plain
    text and anchor spans ``(title, start, end)`` into it."""
    out: List[str] = []
    anchors: List[Tuple[str, int, int]] = []
    out_len = 0
    pos = 0
    n = len(text)
    while True:
        s = text.find("[[", pos)
        if s < 0:
            out.append(text[pos:])
            break
        out.append(text[pos:s])
        out_len += s - pos
        depth = 1
        j = s + 2
        while j < n and depth:
            if text.startswith("[[", j):
                depth += 1
                j += 2
            elif text.startswith("]]", j):
                depth -= 1
                j += 2
            else:
                j += 1
        inner = text[s + 2:j - 2] if depth == 0 else text[s + 2:]
        pos = j
        target, label = _link_target_label(inner)
        if target is None:
            continue
        if "[[" in label:  # nested markup inside a caption/label
            label, _ = _replace_links(label)
        label = _QUOTES_RE.sub("", label)
        if not label:
            continue
        title = normalize_title(target)
        if title:
            anchors.append((title, out_len, out_len + len(label)))
        out.append(label)
        out_len += len(label)
    return "".join(out), anchors


def wikitext_to_paragraphs(
    wikitext: str,
    min_chars: int = 8,
) -> List[Tuple[str, List[Tuple[str, int, int]]]]:
    """Wiki markup -> ``[(paragraph_text, [(title, start, end), ...])]``.

    The cleanup order matters: comments, then ``<ref>``/verbatim tag
    regions, then nested templates and tables, then per-line link
    replacement with offset tracking, then externals/quotes/leftover
    HTML. Headings and magic words are dropped; list markers stripped
    (wikipedia2vec's DumpDB keeps list items as their own paragraphs).
    """
    t = _COMMENT_RE.sub("", wikitext)
    t = _DROPTAG_RE.sub("", t)
    t = _REF_RE.sub("", t)
    t = _strip_nested(t, "{{", "}}")
    t = _strip_nested(t, "{|", "|}")
    t = _MAGIC_RE.sub("", t)

    paragraphs: List[Tuple[str, List[Tuple[str, int, int]]]] = []
    for raw_line in t.split("\n"):
        line = raw_line.strip()
        if not line or _HEADING_RE.match(line):
            continue
        line = _LIST_PREFIX_RE.sub("", line)
        plain, anchors = _replace_links(line)
        # post-link cleanups shift offsets; apply them piecewise so the
        # anchor spans stay valid: run on the label-free regions only
        plain, anchors = _clean_preserving_anchors(plain, anchors)
        plain = plain.strip()
        if len(plain) < min_chars:
            continue
        paragraphs.append((plain, anchors))
    return paragraphs


def _clean_preserving_anchors(
    text: str, anchors: List[Tuple[str, int, int]],
) -> Tuple[str, List[Tuple[str, int, int]]]:
    """Apply the remaining regex cleanups while remapping anchor spans.

    Builds a deletion map: every regex match becomes (span, replacement);
    offsets after each edit shift by the length delta. Anchors whose span
    overlaps a deleted region are clipped."""
    edits: List[Tuple[int, int, str]] = []
    for m in _EXTLINK_RE.finditer(text):
        edits.append((m.start(), m.end(), m.group(1)))
    for m in _BARE_EXTLINK_RE.finditer(text):
        edits.append((m.start(), m.end(), ""))
    for m in _URL_RE.finditer(text):
        edits.append((m.start(), m.end(), ""))
    for m in _QUOTES_RE.finditer(text):
        edits.append((m.start(), m.end(), ""))
    for m in _HTMLTAG_RE.finditer(text):
        edits.append((m.start(), m.end(), ""))
    if not edits:
        return text, anchors
    # drop overlapping edits (first wins) and sort
    edits.sort()
    kept: List[Tuple[int, int, str]] = []
    last_end = -1
    for s, e, rep in edits:
        if s >= last_end:
            kept.append((s, e, rep))
            last_end = e
    out: List[str] = []
    # old-position -> new-position mapping at edit boundaries
    shifts: List[Tuple[int, int]] = []  # (old_pos, delta_at_and_after)
    cursor = 0
    delta = 0
    for s, e, rep in kept:
        out.append(text[cursor:s])
        out.append(rep)
        delta += len(rep) - (e - s)
        shifts.append((e, delta))
        cursor = e
    out.append(text[cursor:])
    new_text = "".join(out)

    def remap(p: int) -> int:
        d = 0
        for old, dd in shifts:
            if p >= old:
                d = dd
            else:
                break
        return p + d

    new_anchors: List[Tuple[str, int, int]] = []
    for title, s, e in anchors:
        ns_, ne_ = remap(s), remap(e)
        ns_ = max(0, min(ns_, len(new_text)))
        ne_ = max(ns_, min(ne_, len(new_text)))
        if ne_ > ns_:
            new_anchors.append((title, ns_, ne_))
    return new_text, new_anchors


def build_redirects(path: str | Path,
                    max_pages: Optional[int] = None) -> Dict[str, str]:
    """Pass 1: title -> redirect-target map (``db.resolve_redirect``,
    parse_text.py:60-63). Chains are followed at lookup time."""
    redirects: Dict[str, str] = {}
    for i, page in enumerate(iter_dump_pages(path)):
        if max_pages is not None and i >= max_pages:
            break
        if page.redirect:
            redirects[normalize_title(page.title)] = normalize_title(
                page.redirect)
    return redirects


def resolve_redirect(title: str, redirects: Dict[str, str],
                     max_hops: int = 8) -> str:
    seen = set()
    for _ in range(max_hops):
        nxt = redirects.get(title)
        if nxt is None or nxt in seen:
            return title
        seen.add(title)
        title = nxt
    return title


def dump_to_jsonl(
    dump_path: str | Path,
    out_path: str | Path,
    lang: str = "en",
    paragraph_mode: str = "all",  # or "first" (--paragraph first)
    max_pages: Optional[int] = None,
    min_chars: int = 8,
) -> int:
    """Full dump -> JSONL pipeline; returns the number of records.

    Mirrors the reference loop (parse_text.py:38-88): per page, dedup
    paragraphs, resolve anchor redirects, re-insert ``<e:Title>`` markup
    reverse-sorted by start, sentence-split, emit one record per
    sentence with the anchored paragraph attached.
    """
    redirects = build_redirects(dump_path, max_pages=max_pages)
    n_out = 0
    with open(out_path, "w", encoding="utf-8") as wf:
        for i, page in enumerate(iter_dump_pages(dump_path)):
            if max_pages is not None and i >= max_pages:
                break
            if page.ns != 0 or page.redirect or not page.text:
                continue
            paragraphs = wikitext_to_paragraphs(page.text,
                                                min_chars=min_chars)
            if paragraph_mode == "first":
                paragraphs = paragraphs[:1]
            unique = set()
            for p_id, (text, anchors) in enumerate(paragraphs):
                if text in unique:
                    continue
                unique.add(text)
                resolved = [(resolve_redirect(t, redirects), s, e)
                            for t, s, e in anchors]
                anchored = insert_anchors(text, resolved)
                for s_id, sentence in enumerate(
                        split_sentences(text, lang)):
                    rec = {
                        "title": page.title, "p_id": p_id, "s_id": s_id,
                        "sentence": sentence, "paragraph": anchored,
                        "url": (f"https://{lang}.wikipedia.org/wiki/"
                                f"{page.title}"),
                    }
                    wf.write(json.dumps(rec, ensure_ascii=False) + "\n")
                    n_out += 1
    return n_out
