"""Entity spans as HTML (counterpart of ``kbner_tpu/utils/html_viz.py``;
the reference's ``flair/visual/ner_html.py``): the same bytes for the same
records."""

from __future__ import annotations

import html
from typing import List, Sequence

from ..data.conll import SentenceRecord
from ..data.tag_schemes import get_spans

_COLORS = [
    "#ffadad", "#ffd6a5", "#fdffb6", "#caffbf", "#9bf6ff", "#a0c4ff",
    "#bdb2ff", "#ffc6ff",
]

_PAGE = """<!DOCTYPE html><html><head><meta charset="utf-8">
<style>
body {{ font-family: sans-serif; line-height: 2.0; margin: 2em; }}
.ent {{ padding: 2px 4px; border-radius: 4px; }}
.lbl {{ font-size: 0.7em; font-weight: bold; margin-left: 3px; }}
</style></head><body>
{body}
</body></html>"""


def render_ner_html(
    records: Sequence[SentenceRecord],
    tag_layer: str = "ner",
    ignore_labels: Sequence[str] = ("X",),
) -> str:
    """Render tagged sentences with colored entity spans."""
    label_colors = {}
    parts: List[str] = []
    for rec in records:
        tags = rec.tags.get(tag_layer, ["O"] * len(rec.tokens))
        spans = {s.start: s for s in get_spans(tags,
                                               ignore_labels=ignore_labels)}
        out: List[str] = ["<p>"]
        i = 0
        while i < len(rec.tokens):
            span = spans.get(i)
            if span is not None:
                if span.label not in label_colors:
                    label_colors[span.label] = _COLORS[
                        len(label_colors) % len(_COLORS)]
                color = label_colors[span.label]
                text = html.escape(" ".join(rec.tokens[span.start:span.end]))
                out.append(
                    f'<span class="ent" style="background:{color}">{text}'
                    f'<span class="lbl">{html.escape(span.label)}</span>'
                    f"</span> ")
                i = span.end
            else:
                out.append(html.escape(rec.tokens[i]) + " ")
                i += 1
        out.append("</p>")
        parts.append("".join(out))
    return _PAGE.format(body="\n".join(parts))
