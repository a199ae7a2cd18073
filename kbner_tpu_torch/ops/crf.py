"""Linear-chain CRF ops: log partition, gold-path score, negative
log-likelihood, posterior marginals, Viterbi and n-best decode
(counterpart of ``kbner_tpu/ops/crf.py``).

Masking: retrieved-context tokens and padding are removed from the chain
by transition-skip masking. At a masked step the forward variables carry
through unchanged (and a Viterbi back-pointer is the identity), so the
previous unmasked position connects directly to the next one — the same
result as compacting the sequence, with static shapes.

Conventions:
  - ``transitions[i, j]`` = score of moving FROM tag i TO tag j, either
    ``[K, K]`` or one matrix per sentence ``[B, K, K]``;
  - ``<START>``/``<STOP>`` indices are passed explicitly;
  - the chain starts at word 0 whatever its mask says, as the JAX
    package's scan does: a sentence whose first word is masked (a stride
    window that starts in retrieved context) scores word 0 from
    ``<START>`` in the partition function but not in the gold path;
  - all CRF math runs in float32.

The loops over the word axis are plain PyTorch with autograd: the JAX
package runs them as ``lax.scan`` and has no kernel for them. The
recursions and the Viterbi decode skip the word columns after the first
that are masked in every sentence of the batch (in a fused batch, the
context words after the longest sentence): a masked step is an exact
carry, so dropping such a column changes no value, gradient or tag, and
the loop runs over the sentence words only.
Finding those columns (:func:`live_columns`) costs one host sync, which
waits for whatever the mask waits for; a caller that knows the mask
before the emissions finds them first and hands them to
:func:`crf_decode`, so the loop is queued behind the emissions without
waiting for them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.spans import current

NEG_INF = -1e30


def _masked_step(alpha: torch.Tensor, step_val: torch.Tensor,
                 mask_t: torch.Tensor) -> torch.Tensor:
    """The step's value where the sentence is unmasked, else the carry."""
    return torch.where(mask_t[:, None], step_val, alpha)


def _trans3(transitions: torch.Tensor, B: int) -> torch.Tensor:
    """Transitions as ``[B, K, K]`` float32."""
    transitions = transitions.float()
    if transitions.dim() == 2:
        return transitions.unsqueeze(0).expand(B, *transitions.shape)
    return transitions


def live_columns(mask: torch.Tensor) -> torch.Tensor:
    """Indices of the word columns that some sentence leaves unmasked, and
    of column 0, which always stays: the recursions start there whatever
    its mask. One host sync, on the mask alone."""
    live = mask.bool().any(0)
    live[0] = True
    return live.nonzero().squeeze(1)


def _active_columns(emissions: torch.Tensor, mask: torch.Tensor,
                    cols: Optional[torch.Tensor] = None):
    """``(emissions, mask, cols)`` over the ``cols`` columns
    (:func:`live_columns` when not given); ``cols`` is None when every
    column is kept."""
    if cols is None:
        cols = live_columns(mask)
    if cols.numel() == mask.shape[1]:
        return emissions, mask, None
    return emissions[:, cols], mask[:, cols], cols


def crf_forward(
    emissions: torch.Tensor,  # [B, T, K]
    mask: torch.Tensor,  # [B, T]
    transitions: torch.Tensor,  # [K, K] or [B, K, K]
    start_idx: int,
    stop_idx: int,
) -> torch.Tensor:
    """Log partition function log Z per sentence. Returns ``[B]``."""
    emissions = emissions.float()
    mask = mask.bool()
    B = emissions.shape[0]
    trans = _trans3(transitions, B)
    emissions, mask, _ = _active_columns(emissions, mask)
    current().add("columns", emissions.shape[1])
    alpha = trans[:, start_idx, :] + emissions[:, 0, :]
    for t in range(1, emissions.shape[1]):
        # scores[b, i, j] = alpha[b, i] + trans[b, i, j] + emit[b, j]
        scores = alpha.unsqueeze(2) + trans + emissions[:, t, None, :]
        alpha = _masked_step(alpha, torch.logsumexp(scores, dim=1),
                             mask[:, t])
    return torch.logsumexp(alpha + trans[:, :, stop_idx], dim=1)


def crf_gold_score(
    emissions: torch.Tensor,  # [B, T, K]
    tags: torch.Tensor,  # [B, T] int
    mask: torch.Tensor,  # [B, T]
    transitions: torch.Tensor,  # [K, K] or [B, K, K]
    start_idx: int,
    stop_idx: int,
) -> torch.Tensor:
    """Score of the gold path, skipping masked positions. Returns ``[B]``.

    Each unmasked position's previous tag is the tag at the last unmasked
    position before it (``<START>`` for the first), found with a running
    maximum over the unmasked positions' indices."""
    emissions = emissions.float()
    mask = mask.bool()
    B, T, _ = emissions.shape
    trans = _trans3(transitions, B)
    tags = tags.long()
    emit = torch.gather(emissions, 2, tags.unsqueeze(2)).squeeze(2)
    emit_total = torch.where(mask, emit, 0.0).sum(1)

    pos = torch.arange(T, device=emissions.device).expand(B, T)
    last = torch.cummax(torch.where(mask, pos, -1), dim=1).values  # <= t
    prev_pos = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    start = torch.full_like(tags, start_idx)
    prev_tags = torch.where(prev_pos >= 0,
                            torch.gather(tags, 1, prev_pos.clamp(min=0)),
                            start)
    batch_ix = torch.arange(B, device=emissions.device)
    trans_scores = trans[batch_ix[:, None], prev_tags, tags]  # [B, T]
    trans_total = torch.where(mask, trans_scores, 0.0).sum(1)
    last_tag = torch.where(last[:, -1] >= 0,
                           tags[batch_ix, last[:, -1].clamp(min=0)],
                           start[:, 0])
    return emit_total + trans_total + trans[batch_ix, last_tag, stop_idx]


def crf_neg_log_likelihood(
    emissions: torch.Tensor,
    tags: torch.Tensor,
    mask: torch.Tensor,
    transitions: torch.Tensor,
    start_idx: int,
    stop_idx: int,
) -> torch.Tensor:
    """Per-sentence CRF negative log-likelihood ``[B]``; callers choose
    the reduction."""
    log_z = crf_forward(emissions, mask, transitions, start_idx, stop_idx)
    gold = crf_gold_score(emissions, tags, mask, transitions, start_idx,
                          stop_idx)
    return log_z - gold


def crf_decode(
    emissions: torch.Tensor,  # [B, T, K]
    mask: torch.Tensor,  # [B, T]
    transitions: torch.Tensor,  # [K, K] or [B, K, K]
    start_idx: int,
    stop_idx: int,
    pad_tag: int = 0,
    cols: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Viterbi decode with transition-skip masking.

    Returns ``(best_tags [B, T] int32, best_score [B] float32)``. Masked
    positions are filled with ``pad_tag``. The recursion runs over the
    ``cols`` word columns, :func:`live_columns` of ``mask`` (found here
    when not given; a caller passes them to spare the wait for
    ``emissions`` that finding them here would take).
    """
    emissions = emissions.float()
    mask = mask.bool()
    B, T, K = emissions.shape
    trans = _trans3(transitions, B)
    em, m, cols = _active_columns(emissions, mask, cols)
    identity_bp = torch.arange(K, device=emissions.device).expand(B, K)

    alpha = trans[:, start_idx, :] + em[:, 0, :]
    bps = []  # bps[i] maps the tag at column i+1 to the best tag at i
    for t in range(1, em.shape[1]):
        scores = alpha.unsqueeze(2) + trans  # [B, K(from), K(to)]
        best_score, best_prev = scores.max(dim=1)
        m_t = m[:, t, None]
        alpha = torch.where(m_t, best_score + em[:, t, :], alpha)
        bps.append(torch.where(m_t, best_prev, identity_bp))

    final = alpha + trans[:, :, stop_idx]
    best_score, tag = final.max(dim=1)
    tags = [tag]
    for bp in reversed(bps):
        tag = torch.gather(bp, 1, tag.unsqueeze(1)).squeeze(1)
        tags.append(tag)
    tags = torch.stack(tags[::-1], dim=1)  # [B, em.shape[1]]
    tags = torch.where(m, tags, torch.full_like(tags, pad_tag))
    tags = tags.to(torch.int32)
    if cols is not None:
        tags = torch.full((B, T), pad_tag, dtype=torch.int32,
                          device=tags.device).index_copy(1, cols, tags)
    return tags, best_score


def crf_marginals(
    emissions: torch.Tensor,  # [B, T, K]
    mask: torch.Tensor,  # [B, T]
    transitions: torch.Tensor,  # [K, K] or [B, K, K]
    start_idx: int,
    stop_idx: int,
) -> torch.Tensor:
    """Posterior tag marginals p(y_t = k | x) by forward-backward.

    Returns ``[B, T, K]``; rows at masked positions are uniform (they
    carry no probability mass in the chain)."""
    emissions = emissions.float()
    mask = mask.bool()
    B, T, K = emissions.shape
    trans = _trans3(transitions, B)
    em, m, cols = _active_columns(emissions, mask)
    Tc = em.shape[1]

    alphas = [trans[:, start_idx, :] + em[:, 0, :]]
    for t in range(1, Tc):
        scores = alphas[-1].unsqueeze(2) + trans + em[:, t, None, :]
        alphas.append(_masked_step(alphas[-1], torch.logsumexp(scores, 1),
                                   m[:, t]))
    # beta_t[k]: log sum over the paths from t (in state k) to STOP
    betas = [trans[:, :, stop_idx]]
    for t in range(Tc - 2, -1, -1):
        scores = trans + (em[:, t + 1] + betas[-1])[:, None, :]
        betas.append(_masked_step(betas[-1], torch.logsumexp(scores, 2),
                                  m[:, t + 1]))
    alpha = torch.stack(alphas, 1)  # [B, Tc, K]
    beta = torch.stack(betas[::-1], 1)
    log_z = torch.logsumexp(alphas[-1] + trans[:, :, stop_idx], dim=1)
    marg = torch.exp(alpha + beta - log_z[:, None, None])
    marg = torch.where(m[:, :, None], marg, 1.0 / K)
    if cols is None:
        return marg
    out = torch.full((B, T, K), 1.0 / K, dtype=marg.dtype,
                     device=marg.device)
    return out.index_copy(1, cols, marg)


def crf_decode_nbest(
    emissions: torch.Tensor,  # [B, T, K]
    mask: torch.Tensor,  # [B, T]
    transitions: torch.Tensor,  # [K, K] or [B, K, K]
    start_idx: int,
    stop_idx: int,
    n_best: int = 5,
    pad_tag: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N-best Viterbi. Returns ``(tags [B, N, T] int32, scores [B, N]
    float32)``, best first. The state is ``[B, K, N]``, the N best path
    scores ending in each tag; each step takes the top N over (previous
    tag, previous rank), ties broken toward the lower flat index as
    ``lax.top_k`` breaks them."""
    emissions = emissions.float()
    mask = mask.bool()
    B, T, K = emissions.shape
    N = n_best
    trans = _trans3(transitions, B)
    dev = emissions.device

    alpha = torch.full((B, K, N), NEG_INF, device=dev)
    alpha[:, :, 0] = trans[:, start_idx, :] + emissions[:, 0, :]
    id_tag = torch.arange(K, device=dev)[None, :, None].expand(B, K, N)
    id_rank = torch.arange(N, device=dev)[None, None, :].expand(B, K, N)

    def top_n(flat):
        vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
        return vals[..., :N], idx[..., :N]

    bp_tags, bp_ranks = [], []
    for t in range(1, T):
        # cand[b, k', k, n] = alpha[b, k, n] + trans[b, k, k']
        cand = alpha[:, None, :, :] + trans.transpose(1, 2)[:, :, :, None]
        vals, idx = top_n(cand.reshape(B, K, K * N))  # [B, K', N]
        m = mask[:, t, None, None]
        alpha = torch.where(m, vals + emissions[:, t, :, None], alpha)
        bp_tags.append(torch.where(m, idx // N, id_tag))
        bp_ranks.append(torch.where(m, idx % N, id_rank))

    final = alpha + trans[:, :, stop_idx, None]  # [B, K, N]
    best_scores, best_idx = top_n(final.reshape(B, K * N))
    tag, rank = best_idx // N, best_idx % N  # [B, N]
    tags = [tag]
    for bt, br in zip(reversed(bp_tags), reversed(bp_ranks)):
        flat = tag * N + rank
        tag = torch.gather(bt.reshape(B, K * N), 1, flat)
        rank = torch.gather(br.reshape(B, K * N), 1, flat)
        tags.append(tag)
    tags = torch.stack(tags[::-1], dim=2)  # [B, N, T]
    tags = torch.where(mask[:, None, :], tags, torch.full_like(tags, pad_tag))
    return tags.to(torch.int32), best_scores
