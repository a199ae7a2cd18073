"""Context reranking (counterpart of ``kbner_tpu/retrieval/rerank.py``,
the reference's ``tools/bert_scoring.py``): by normalized edit distance to
the query, by any scorer, or by BERTScore F1 over token embeddings.

:func:`bertscore_f1` is plain PyTorch on the embeddings' device, as the
JAX package leaves it to XLA: one matmul and two masked max/mean
reductions.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from .engine import RetrievedDoc


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, O(len(a) * len(b)) with two rows."""
    if len(a) < len(b):
        a, b = b, a
    prev = list(range(len(b) + 1))
    for i, ca in enumerate(a, 1):
        cur = [i]
        for j, cb in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (ca != cb)))
        prev = cur
    return prev[-1]


def normalized_edit_similarity(a: str, b: str) -> float:
    """1 - distance / longer length, in [0, 1]; 1.0 for equal strings."""
    if not a and not b:
        return 1.0
    return 1.0 - edit_distance(a, b) / max(len(a), len(b))


def rerank_by_edit_distance(query: str, docs: Sequence[RetrievedDoc]
                            ) -> List[RetrievedDoc]:
    """Contexts by edit similarity of their sentence to the query (stable
    among equals)."""
    return sorted(docs,
                  key=lambda d: -normalized_edit_similarity(query,
                                                            d.sentence))


def rerank_with_scorer(query: str, docs: Sequence[RetrievedDoc],
                       scorer: Callable[[str, str], float]
                       ) -> List[RetrievedDoc]:
    """Contexts by ``scorer(query, sentence)``, highest first."""
    return sorted(docs, key=lambda d: -scorer(query, d.sentence))


def bertscore_f1(q_emb, q_mask, d_emb, d_mask) -> torch.Tensor:
    """BERTScore F1 of one query against K candidates: ``q_emb`` [Lq, D],
    ``q_mask`` [Lq], ``d_emb`` [K, Ld, D], ``d_mask`` [K, Ld] (tensors or
    arrays; arrays are taken to the CPU). Greedy matching: recall is the
    mean over query tokens of the best cosine similarity in the candidate,
    precision the same the other way, F1 their harmonic mean; a pair with
    no token on one side scores 0. Returns [K] float32."""
    q_emb, q_mask, d_emb, d_mask = (torch.as_tensor(x) for x in (
        q_emb, q_mask, d_emb, d_mask))
    q_emb = q_emb.float()
    d_emb = d_emb.float()
    qn = q_emb / torch.clamp(torch.linalg.vector_norm(
        q_emb, dim=-1, keepdim=True), min=1e-9)
    dn = d_emb / torch.clamp(torch.linalg.vector_norm(
        d_emb, dim=-1, keepdim=True), min=1e-9)
    sim = torch.matmul(dn, qn.T).transpose(1, 2)  # [K, Lq, Ld]
    q_on = q_mask > 0
    d_on = d_mask > 0
    pair = q_on[None, :, None] & d_on[:, None, :]
    sim = torch.where(pair, sim, float("-inf"))
    n_q = q_on.sum()
    n_d = d_on.sum(dim=1)
    best_q = sim.amax(dim=2)  # [K, Lq]
    best_d = sim.amax(dim=1)  # [K, Ld]
    recall = torch.where(q_on[None], best_q, 0.0).sum(dim=1) / torch.clamp(
        n_q, min=1)
    precision = torch.where(d_on, best_d, 0.0).sum(dim=1) / torch.clamp(
        n_d, min=1)
    f1 = 2 * precision * recall / torch.clamp(precision + recall, min=1e-9)
    return torch.where((n_d > 0) & (n_q > 0), f1, 0.0)


def rerank_by_bertscore(
    encode_fn: Callable[[Sequence[str]], Tuple[np.ndarray, np.ndarray]],
    query: str,
    docs: Sequence[RetrievedDoc],
) -> List[RetrievedDoc]:
    """Contexts by BERTScore F1 against the query. ``encode_fn(texts) ->
    (emb [B, S, D], mask [B, S])`` embeds the query and the contexts in
    one batch (for example ``FinetuneTrainer.embed_texts``)."""
    if not docs:
        return []
    emb, mask = encode_fn([query] + [d.sentence for d in docs])
    f1 = bertscore_f1(emb[0], mask[0], emb[1:], mask[1:]).cpu().numpy()
    return [docs[i] for i in np.argsort(-f1, kind="stable")]


def split_corpus(records: Sequence, n_parts: int) -> List[List]:
    """Records dealt round-robin into ``n_parts`` parts (the reference's
    ``tools/split.py``)."""
    parts: List[List] = [[] for _ in range(n_parts)]
    for i, rec in enumerate(records):
        parts[i % n_parts].append(rec)
    return parts
