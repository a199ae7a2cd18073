"""String <-> integer id mapping with JSON persistence (counterpart of
``kbner_tpu/data/dictionary.py``; the same file format, so a
``tag_dictionary.json`` written by either package opens in the other)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Union


class Dictionary:
    """Bidirectional item<->index map; items keep insertion order. With
    ``add_unk`` the item ``<unk>`` takes index 0 and stands in for every
    unknown item (text vocabularies; tag dictionaries have none)."""

    UNK = "<unk>"

    def __init__(self, add_unk: bool = False):
        self.item2idx: Dict[str, int] = {}
        self.idx2item: List[str] = []
        if add_unk:
            self.add_item(self.UNK)

    def add_item(self, item: str) -> int:
        if item not in self.item2idx:
            self.item2idx[item] = len(self.idx2item)
            self.idx2item.append(item)
        return self.item2idx[item]

    def get_idx_for_item(self, item: str) -> int:
        idx = self.item2idx.get(item)
        if idx is None:
            if self.UNK in self.item2idx:
                return self.item2idx[self.UNK]
            raise KeyError(f"Item {item!r} not in dictionary.")
        return idx

    def get_item_for_index(self, idx: int) -> str:
        return self.idx2item[idx]

    def get_items(self) -> List[str]:
        return list(self.idx2item)

    def __len__(self) -> int:
        return len(self.idx2item)

    def __contains__(self, item: str) -> bool:
        return item in self.item2idx

    def save(self, path: Union[str, Path]) -> None:
        path = Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"items": self.idx2item}))

    @classmethod
    def load(cls, path: Union[str, Path]) -> "Dictionary":
        data = json.loads(Path(path).read_text())
        return cls.from_items(data["items"])

    @classmethod
    def from_items(cls, items: Iterable[str],
                   add_unk: bool = False) -> "Dictionary":
        d = cls(add_unk=add_unk)
        for item in items:
            d.add_item(item)
        return d


def make_tag_dictionary(sentences_tags, extra_tags=None) -> Dictionary:
    """Tag dictionary in the reference's order: 'O' first, then tags in
    corpus order, then '<START>' and '<STOP>' (the CRF's two extra states
    are always the last two indices)."""
    d = Dictionary()
    d.add_item("O")
    for tags in sentences_tags:
        for tag in tags:
            d.add_item(tag)
    for tag in extra_tags or ():
        d.add_item(tag)
    d.add_item("<START>")
    d.add_item("<STOP>")
    return d
