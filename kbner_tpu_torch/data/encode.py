"""Sentence records -> padded integer arrays (counterpart of
``kbner_tpu/data/encode.py``).

  input_ids [B, S]       subtoken ids incl CLS/SEP
  attention_mask [B, S]  1 for real subtokens
  word_starts [B, W]     subtoken index of each word's first subtoken
  word_mask [B, W]       1 for real words
  tag_ids [B, W]         gold tag indices (0 without a tag dictionary)
  crf_mask [B, W]        word_mask minus retrieved-context (X) positions
  lang_ids [B]           source-corpus id

:func:`add_classic_features` adds the inputs of the classic embedders
(word ids, per-word characters, the sentence's character stream, ELMo's
byte ids, BPEmb's piece ids) to a batch's ``extra`` arrays.
The ``<EOS>`` context separator word is encoded as the tokenizer's SEP
token. The arrays stay numpy here; the tagger moves them to its device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from .conll import EOS_MARKER, SentenceRecord
from .dictionary import Dictionary
from .subword import SubwordTokenizer, subtoken_length


@dataclasses.dataclass
class EncodedBatch:
    input_ids: np.ndarray
    attention_mask: np.ndarray
    word_starts: np.ndarray
    word_mask: np.ndarray
    tag_ids: np.ndarray
    crf_mask: np.ndarray
    lang_ids: np.ndarray
    records: Optional[List[SentenceRecord]] = None
    # the classic embedders' inputs (add_classic_features)
    extra: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)

    @property
    def num_sentences(self) -> int:
        return self.input_ids.shape[0]

    def arrays(self) -> Dict[str, np.ndarray]:
        return {
            "input_ids": self.input_ids,
            "attention_mask": self.attention_mask,
            "word_starts": self.word_starts,
            "word_mask": self.word_mask,
            "tag_ids": self.tag_ids,
            "crf_mask": self.crf_mask,
            "lang_ids": self.lang_ids,
            **self.extra,
        }


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def encode_batch(
    records: Sequence[SentenceRecord],
    tokenizer: SubwordTokenizer,
    tag_dict: Optional[Dictionary] = None,
    tag_layer: str = "ner",
    max_subtokens: int = 512,
    subtoken_bucket: int = 16,
    word_bucket: int = 8,
    x_tag: str = "S-X",
    keep_records: bool = True,
) -> EncodedBatch:
    """Encode a list of sentences into one padded batch. Sequences longer
    than ``max_subtokens`` are truncated at a word boundary. With a tag
    dictionary, ``tag_ids`` holds each word's gold tag; a context position
    whose tag is missing from the dictionary gets 0 (it never reaches the
    loss), any other missing tag raises."""
    B = len(records)
    per_sentence = []
    for rec in records:
        sub_ids: List[int] = [tokenizer.cls_id]
        starts: List[int] = []
        n_words = 0
        for word in rec.tokens:
            ids = ([tokenizer.sep_id] if word == EOS_MARKER
                   else tokenizer.encode_word(word))
            if len(sub_ids) + len(ids) + 1 > max_subtokens:
                break
            starts.append(len(sub_ids))
            sub_ids.extend(ids)
            n_words += 1
        sub_ids.append(tokenizer.sep_id)
        per_sentence.append((sub_ids, starts, n_words))

    S = round_up(max(len(s[0]) for s in per_sentence), subtoken_bucket)
    W = round_up(max(s[2] for s in per_sentence), word_bucket)
    S = min(S, max_subtokens)

    input_ids = np.full((B, S), tokenizer.pad_id, dtype=np.int32)
    attention_mask = np.zeros((B, S), dtype=np.int32)
    word_starts = np.zeros((B, W), dtype=np.int32)
    word_mask = np.zeros((B, W), dtype=np.int32)
    tag_ids = np.zeros((B, W), dtype=np.int32)
    crf_mask = np.zeros((B, W), dtype=np.int32)
    lang_ids = np.zeros((B,), dtype=np.int32)

    for b, (rec, (sub_ids, starts, n_words)) in enumerate(
            zip(records, per_sentence)):
        L = len(sub_ids)
        input_ids[b, :L] = sub_ids
        attention_mask[b, :L] = 1
        word_starts[b, :n_words] = starts
        word_mask[b, :n_words] = 1
        lang_ids[b] = rec.lang_id
        tags = rec.tags.get(tag_layer)
        # everything from <EOS> onward is retrieved context: masked from
        # the CRF whether or not gold tags are present
        eos = rec.eos_index
        for w in range(n_words):
            is_x = (tags is not None and w < len(tags) and tags[w] == x_tag) \
                or (eos >= 0 and w >= eos)
            crf_mask[b, w] = 0 if is_x else 1
            if tag_dict is not None and tags is not None and w < len(tags):
                tag_ids[b, w] = (tag_dict.item2idx.get(tags[w], 0) if is_x
                                 else tag_dict.get_idx_for_item(tags[w]))

    return EncodedBatch(
        input_ids=input_ids,
        attention_mask=attention_mask,
        word_starts=word_starts,
        word_mask=word_mask,
        tag_ids=tag_ids,
        crf_mask=crf_mask,
        lang_ids=lang_ids,
        records=list(records) if keep_records else None,
    )


def kmeans(x: Sequence[int], k: int, seed: int = 0):
    """Frequency-weighted 1-D k-means over sentence lengths: Lloyd
    iterations on the distinct values weighted by their counts, an empty
    cluster reseeded with the farthest point of the biggest one. Returns
    ``(centroids, clusters)``, ``clusters[i]`` the indices assigned to
    centroid i; empty clusters are dropped."""
    x = np.asarray(x, dtype=np.float64)
    d, indices, f = np.unique(x, return_inverse=True, return_counts=True)
    if len(d) < k:
        raise ValueError(
            f"unable to assign {len(d)} datapoints to {k} clusters")
    total = d * f
    rng = np.random.RandomState(seed)
    c = d[rng.permutation(len(d))[:k]]
    old = None
    dists = np.abs(d[:, None] - c[None, :])
    y = dists.argmin(axis=1)
    dmin = dists.min(axis=1)
    while old is None or not np.array_equal(c, old):
        for i in range(k):
            if not np.any(y == i):
                mask = y[None, :] == np.arange(k)[:, None]
                biggest = np.nonzero(mask[mask.sum(axis=1).argmax()])[0]
                farthest = dmin[biggest].argmax()
                y[biggest[farthest]] = i
        mask = y[None, :] == np.arange(k)[:, None]  # [k, |d|]
        old = c
        c = (total[None, :] * mask).sum(axis=1) / (f[None, :] * mask).sum(
            axis=1)
        dists = np.abs(d[:, None] - c[None, :])
        y = dists.argmin(axis=1)
        dmin = dists.min(axis=1)
    y = y[indices]
    assigned = np.unique(y)
    centroids = c[assigned].tolist()
    clusters = [np.nonzero(y == i)[0].tolist() for i in assigned]
    return centroids, clusters


def _budget_chunks(order, lengths, batch_size: int, token_budget: int):
    """Consecutive runs of ``order``: a run closes at ``batch_size``
    sentences, or (with a ``token_budget``) before the summed subtokens,
    each sentence's plus CLS and SEP, would pass the budget."""
    chunks, cur, cur_tokens = [], [], 0
    for i in order:
        n = lengths[i] + 2
        if cur and (len(cur) >= batch_size or (
                token_budget and cur_tokens + n > token_budget)):
            chunks.append(cur)
            cur, cur_tokens = [], 0
        cur.append(i)
        cur_tokens += n
    if cur:
        chunks.append(cur)
    return chunks


def make_batches(
    records: Sequence[SentenceRecord],
    tokenizer: SubwordTokenizer,
    tag_dict: Optional[Dictionary],
    batch_size: int,
    shuffle: bool = False,
    seed: int = 0,
    sort_by_length: bool = True,
    token_budget: int = 0,
    n_buckets: int = 0,
    **encode_kwargs,
) -> List[EncodedBatch]:
    """Batches of sentences sorted by subtoken length, so that pad waste
    stays low within a batch. ``token_budget`` closes a batch before its
    summed subtokens pass the budget (instead of at ``batch_size``);
    ``n_buckets`` draws batches within k-means length buckets (each capped
    at ``batch_size`` and the budget). ``shuffle`` permutes whole batches
    with ``RandomState(seed)``."""
    order = list(range(len(records)))
    lengths = None
    if sort_by_length or token_budget or n_buckets:
        lengths = [subtoken_length(tokenizer, r.tokens) for r in records]
    if n_buckets:
        _, clusters = kmeans(lengths, min(n_buckets, len(set(lengths))),
                             seed=seed)
        chunks = [c for cluster in clusters for c in _budget_chunks(
            cluster, lengths, batch_size, token_budget)]
    else:
        if sort_by_length:
            order.sort(key=lambda i: lengths[i])
        if token_budget:
            chunks = _budget_chunks(order, lengths, len(order) or 1,
                                    token_budget)
        else:
            chunks = [order[i:i + batch_size]
                      for i in range(0, len(order), batch_size)]
    if shuffle:
        np.random.RandomState(seed).shuffle(chunks)
    return [
        encode_batch([records[i] for i in chunk], tokenizer, tag_dict,
                     **encode_kwargs)
        for chunk in chunks
    ]


def build_word_vocab(records: Sequence[SentenceRecord]) -> Dictionary:
    """Token vocabulary of a corpus (index 0 is ``<unk>``)."""
    vocab = Dictionary(add_unk=True)
    for rec in records:
        for tok in rec.tokens:
            vocab.add_item(tok)
    return vocab


def build_char_vocab(records: Sequence[SentenceRecord]) -> Dictionary:
    """Character vocabulary of a corpus (index 0 is ``<unk>``, then the
    ``' '`` word separator)."""
    vocab = Dictionary(add_unk=True)
    vocab.add_item(" ")
    for rec in records:
        for tok in rec.tokens:
            for ch in tok:
                vocab.add_item(ch)
    return vocab


# allennlp's ELMoCharacterMapper ids (no +1 shift): utf-8 bytes 0-255,
# begin and end of word 258 and 259, padding 260 -- the encoding that the
# character tables of published ELMo weight files were trained on
ELMO_BOW, ELMO_EOW, ELMO_PAD = 258, 259, 260
ELMO_CHAR_VOCAB = 261
ELMO_MAX_CHARS = 50


def add_classic_features(
    eb: EncodedBatch,
    word_vocab: Optional[Dictionary] = None,
    char_vocab: Optional[Dictionary] = None,
    max_chars_per_word: int = 16,
    max_stream_chars: int = 1024,
    bpe_vocab=None,
    elmo_bytes: bool = False,
) -> EncodedBatch:
    """Add the classic embedders' int32 inputs to ``eb.extra``, on the
    batch's ``[B, W]`` word axis:

      elmo_char_ids, elmo_char_mask   with ``elmo_bytes``: each word as
        [B, W, 50]                    begin-of-word, its first 48 utf-8
                                      bytes, end-of-word, padded with 260
      word_ids [B, W]                 each word's id in ``word_vocab``
      char_ids, char_mask [B, W, C]   each word's first C characters
      char_stream, char_stream_mask   the words joined by ``' '``, cut at
        [B, T]                        ``max_stream_chars``; T rounded up
                                      to 32 and capped at that cut
      word_char_starts, ..._ends      each word's first and last character
        [B, W]                        in the stream, clipped to T - 1
      bpe_first_ids, bpe_last_ids     with a ``bpe_vocab``
        [B, W]                        (:class:`~..models.embedders.
                                      BPEVocab`): each word's first and
                                      last piece
    """
    if eb.records is None:
        raise ValueError("add_classic_features needs eb.records")
    B, W = eb.word_mask.shape

    if elmo_bytes:
        EC = ELMO_MAX_CHARS
        ids = np.full((B, W, EC), ELMO_PAD, dtype=np.int32)
        mask = np.zeros((B, W, EC), dtype=np.int32)
        for b, rec in enumerate(eb.records):
            for w, tok in enumerate(rec.tokens[:W]):
                row = [ELMO_BOW, *tok.encode("utf-8")[:EC - 2], ELMO_EOW]
                ids[b, w, :len(row)] = row
                mask[b, w, :len(row)] = 1
        eb.extra.update(elmo_char_ids=ids, elmo_char_mask=mask)

    if word_vocab is not None:
        word_ids = np.zeros((B, W), dtype=np.int32)
        for b, rec in enumerate(eb.records):
            for w, tok in enumerate(rec.tokens[:W]):
                word_ids[b, w] = word_vocab.item2idx.get(tok, 0)
        eb.extra["word_ids"] = word_ids

    if char_vocab is not None:
        C = max_chars_per_word
        idx = char_vocab.item2idx
        space = idx.get(" ", 0)
        streams, bounds = [], []
        for rec in eb.records:
            chars: List[int] = []
            starts, ends = [], []
            for w, tok in enumerate(rec.tokens[:W]):
                if w > 0:
                    chars.append(space)
                starts.append(len(chars))
                chars.extend(idx.get(ch, 0) for ch in tok)
                ends.append(max(len(chars) - 1, 0))
            streams.append(chars[:max_stream_chars])
            bounds.append((starts, ends))
        T = min(round_up(max(max(map(len, streams)), 1), 32),
                max_stream_chars)
        char_ids = np.zeros((B, W, C), dtype=np.int32)
        char_mask = np.zeros((B, W, C), dtype=np.int32)
        char_stream = np.zeros((B, T), dtype=np.int32)
        char_stream_mask = np.zeros((B, T), dtype=np.int32)
        word_char_starts = np.zeros((B, W), dtype=np.int32)
        word_char_ends = np.zeros((B, W), dtype=np.int32)
        for b, (rec, chars, (starts, ends)) in enumerate(
                zip(eb.records, streams, bounds)):
            char_stream[b, :len(chars)] = chars
            char_stream_mask[b, :len(chars)] = 1
            for w, tok in enumerate(rec.tokens[:W]):
                word_char_starts[b, w] = min(starts[w], T - 1)
                word_char_ends[b, w] = min(ends[w], T - 1)
                for c, ch in enumerate(tok[:C]):
                    char_ids[b, w, c] = idx.get(ch, 0)
                    char_mask[b, w, c] = 1
        eb.extra.update(char_ids=char_ids, char_mask=char_mask,
                        char_stream=char_stream,
                        char_stream_mask=char_stream_mask,
                        word_char_starts=word_char_starts,
                        word_char_ends=word_char_ends)

    if bpe_vocab is not None:
        first, last = bpe_vocab.encode_first_last(eb)
        eb.extra.update(bpe_first_ids=first, bpe_last_ids=last)
    return eb
