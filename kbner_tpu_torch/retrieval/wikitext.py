"""Wikipedia text extraction, the reference's ``parse_text.py`` stage
(counterpart of ``kbner_tpu/retrieval/wikitext.py``):

  - wiki links re-inserted as ``<e:Title>mention</e>``, applied from the
    last offset back so earlier offsets stay valid;
  - sentence splitting per language: ``.*?[。！？]`` for zh, and for the
    European languages a regex over sentence-final punctuation followed by
    a capital or an opening character (punkt is not available offline);
  - JSONL records ``{title, p_id, s_id, sentence, paragraph, url}``, what
    ``pipeline.build_kb_from_jsonl`` reads.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Iterable, List, Sequence, Tuple

_ZH_SENT_RE = re.compile(r".*?[。！？]|[^。！？]+$", re.S)
# sentence-final punctuation followed by space + capital/opening char
_EU_SENT_RE = re.compile(
    r"(?<=[.!?])\s+(?=[\"'(\[]?[A-ZÀ-ÞА-ЯЁ0-9])")


def insert_anchors(
    paragraph: str,
    anchors: Sequence[Tuple[str, int, int]],  # (title, start, end)
) -> str:
    """Re-insert wiki-link markup ``<e:Title>mention</e>``.

    Anchors are applied sorted by start offset descending so that earlier
    offsets remain valid while the string grows (parse_text.py:53-71).
    """
    out = paragraph
    for title, start, end in sorted(anchors, key=lambda a: -a[1]):
        if not (0 <= start <= end <= len(out)):
            continue
        mention = out[start:end]
        out = out[:start] + f"<e:{title}>{mention}</e>" + out[end:]
    return out


def split_sentences(text: str, lang: str = "en") -> List[str]:
    """Per-language sentence splitting (parse_text.py:17-32)."""
    text = text.strip()
    if not text:
        return []
    if lang == "zh":
        return [m for m in _ZH_SENT_RE.findall(text) if m.strip()]
    parts = _EU_SENT_RE.split(text)
    return [p.strip() for p in parts if p.strip()]


def paragraphs_to_jsonl(
    records: Iterable[dict],
    out_path: str | Path,
    lang: str = "en",
    dedup: bool = True,
) -> int:
    """Emit KB JSONL from paragraph records.

    Each input record: {title, paragraph, url, anchors?: [(title, s, e)]}.
    Paragraphs are deduplicated (the reference dedups paragraph text),
    anchors re-inserted, sentences split; one JSONL line per sentence.
    Returns the number of sentences written.
    """
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    seen = set()
    n = 0
    with open(out_path, "w", encoding="utf-8") as f:
        for p_id, rec in enumerate(records):
            para = rec["paragraph"]
            if dedup:
                key = hash(para)
                if key in seen:
                    continue
                seen.add(key)
            marked = insert_anchors(para, rec.get("anchors", []))
            for s_id, sent in enumerate(split_sentences(marked, lang)):
                f.write(json.dumps({
                    "title": rec.get("title", ""),
                    "p_id": p_id,
                    "s_id": s_id,
                    "sentence": sent,
                    "paragraph": marked,
                    "url": rec.get("url", ""),
                }, ensure_ascii=False) + "\n")
                n += 1
    return n


def strip_anchors(text: str) -> str:
    """Remove ``<e:Title>mention</e>`` markup, keeping mentions."""
    return re.sub(r"<e:[^>]*>(.*?)</e>", r"\1", text)
