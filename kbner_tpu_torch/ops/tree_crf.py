"""First-order projective dependency tree CRF (counterpart of
``kbner_tpu/ops/tree_crf.py``): the log partition over single-root
projective trees (the inside algorithm), the arc marginals and the
(partial-annotation) tree CRF loss of the biaffine parser.

Chart layout per batch row: one flat ``[n * n]`` table per chart,
``s_c[x * n + y]`` the log-sum of complete spans headed at x reaching y
(x < y rightward, x > y leftward), ``s_i`` likewise for incomplete spans.
Position 0 is ROOT and takes exactly one child. Masking uses the finite
``NEG`` instead of -inf, so the marginals stay free of NaN.

The recursion over span widths ``1..n-1`` is a Python loop of plain
PyTorch (the JAX package runs it under ``lax.scan``, with no kernel): on
the card it is paced by its launches, so every index map and every
width's masks are made once before the loop, and each width writes both
triangles of a chart in one ``index_copy``. The tables carry a trash
column at ``n * n``: a span that runs past the grid writes there (the
JAX code's ``mode="drop"`` slot), and the column is never read. Every
update is out of place, so autograd reaches the scores; the marginals
are the gradient of the summed log partition.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG = -1e9


def _lse(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``log(sum(exp(x)))`` over ``dim``, stable for finite inputs (its
    gradient is the softmax, as the JAX ``_lse``'s is)."""
    return torch.logsumexp(x, dim=dim)


def _index_maps(n: int, device):
    """The per-width index maps and masks of the recursion, stacked over
    the widths ``w = 1..n-1`` (leading axis ``w - 1``): flat cell indices
    into ``[n * n]`` (clipped into the grid for the gathers; ``n * n``
    for the writes of spans past the grid), the split mask ``m < w`` and
    the span ends ``j = a + w``."""
    a = torch.arange(n, device=device)
    w = torch.arange(1, n, device=device)[:, None, None]  # [n-1, 1, 1]
    aa = a[None, :, None]  # span starts [1, n, 1]
    m = a[None, None, :]  # split offsets [1, 1, n]

    def clip(x):
        return x.clamp(0, n - 1)

    j = w[:, :, 0] + a[None, :]  # [n-1, n] span ends
    oob = n * n
    maps = {
        "c1": aa * n + clip(aa + m),
        "c2": clip(aa + w) * n + clip(aa + m + 1),
        "c3": clip(aa + m) * n + aa,
        "c4": clip(aa + w) * n + clip(aa + m),
        "c5": aa * n + clip(aa + m + 1),
        "c6": clip(aa + m + 1) * n + clip(aa + w),
    }
    shape = (n - 1, n, n)
    maps = {k: v.expand(shape).reshape(n - 1, n * n) for k, v in maps.items()}
    maps["left"] = clip(j) * n + a  # A[j, a]: head j -> dependent a
    maps["right"] = a * n + clip(j)  # A[a, j]
    # the writes: cell (j, a), then cell (a, j); past the grid, the trash
    maps["write"] = torch.cat([torch.where(j < n, j * n + a, oob),
                               torch.where(j < n, a * n + j, oob)], dim=1)
    maps["m_ok"] = (m < w).expand(shape)  # [n-1, 1 -> n, n]
    maps["end"] = clip(j)
    maps["end_in"] = j < n
    return maps


def tree_crf_inside(
    scores: torch.Tensor,  # [B, n, n] scores[b, d, h] (grid incl. ROOT=0)
    word_mask: torch.Tensor,  # [B, n-1] 1 for real words (grid pos 1..n-1)
    arc_mask: Optional[torch.Tensor] = None,  # [B, n, n] allowed arcs (d, h)
) -> torch.Tensor:
    """Log partition over single-root projective trees, ``[B]``, in
    float32 (float64 for float64 scores).

    ``scores[b, d, h]`` is the score of the arc from head h to dependent
    d, as ``BiaffineParser.scores`` orients it; ``arc_mask`` restricts the
    sum to the trees whose arcs are all allowed (partial annotation)."""
    B, n, _ = scores.shape
    dev = scores.device
    dtype = torch.promote_types(scores.dtype, torch.float32)
    A = scores.transpose(1, 2).to(dtype)  # A[b, h, d]
    if arc_mask is not None:
        A = torch.where(arc_mask.transpose(1, 2).bool(), A, NEG)
    ext = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev),
                     word_mask.bool()], dim=1)  # [B, n]
    lens = word_mask.long().sum(1)  # the last word's grid index

    s_i = torch.full((B, n * n + 1), NEG, dtype=dtype, device=dev)
    s_c = torch.full((B, n * n + 1), NEG, dtype=dtype, device=dev)
    diag_pos = torch.arange(n, device=dev) * (n + 1)
    s_c = s_c.index_fill(1, diag_pos, 0.0)
    if n == 1:
        return s_c.gather(1, lens[:, None])[:, 0]

    mp = _index_maps(n, dev)
    A_flat = A.reshape(B, n * n)
    # every width's span validity: both ends inside the root-extended
    # sentence; the root's complete span only where it covers the sentence
    end_mask = ext[:, mp["end"]] & mp["end_in"][None]  # [B, n-1, n]
    diag = (ext[:, None, :] & end_mask).transpose(0, 1)  # [n-1, B, n]
    widths = torch.arange(1, n, device=dev)
    root_ok = ((torch.arange(n, device=dev)[None, None, :] > 0)
               | (lens[None, :, None] == widths[:, None, None]))
    diag_root = diag & root_ok  # [n-1, B, n]
    il_arc = A_flat[:, mp["left"]].transpose(0, 1)  # [n-1, B, n]
    ir_arc = A_flat[:, mp["right"]].transpose(0, 1)

    def take(flat, idx):  # [B, n*n + 1] gathered by a flat [n*n] map
        return flat.index_select(1, idx).view(B, n, n)

    for k in range(n - 1):
        m_ok = mp["m_ok"][k]
        # ilr[b, a] = lse_m C(a -> a+m) + C(a+w -> a+m+1)
        ilr = _lse(torch.where(m_ok, take(s_c, mp["c1"][k])
                               + take(s_c, mp["c2"][k]), NEG))
        # I(j -> a) and I(a -> j)
        il = torch.where(diag[k], ilr + il_arc[k], NEG)
        ir = torch.where(diag[k], ilr + ir_arc[k], NEG)
        s_i = s_i.index_copy(1, mp["write"][k], torch.cat([il, ir], 1))
        # C(j -> a) = lse_m C(a+m -> a) + I(j -> a+m)
        cl = _lse(torch.where(m_ok, take(s_c, mp["c3"][k])
                              + take(s_i, mp["c4"][k]), NEG))
        # C(a -> j) = lse_m I(a -> a+m+1) + C(a+m+1 -> j)
        cr = _lse(torch.where(m_ok, take(s_i, mp["c5"][k])
                              + take(s_c, mp["c6"][k]), NEG))
        s_c = s_c.index_copy(1, mp["write"][k], torch.cat([
            torch.where(diag[k], cl, NEG),
            torch.where(diag_root[k], cr, NEG)], 1))
    # logZ = C(0 -> last word)
    return s_c.gather(1, lens[:, None])[:, 0]


def tree_crf_marginals(
    scores: torch.Tensor,
    word_mask: torch.Tensor,
    arc_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """P(arc h -> d | sentence) ``[B, n, n]`` in ``scores``' orientation:
    the gradient of the summed log partition. Differentiable itself when
    ``scores`` requires a gradient and grad mode is on."""
    graph = scores.requires_grad and torch.is_grad_enabled()
    with torch.enable_grad():
        s = scores if graph else scores.detach().requires_grad_(True)
        log_z = tree_crf_inside(s, word_mask, arc_mask).sum()
        (grad,) = torch.autograd.grad(log_z, s, create_graph=graph)
    return grad


def tree_crf_loss(
    scores: torch.Tensor,  # [B, n, n] (d, h)
    word_mask: torch.Tensor,  # [B, n-1]
    heads: torch.Tensor,  # [B, n-1] gold head per word; < 0 = unannotated
    partial: bool = False,
) -> torch.Tensor:
    """Per-sentence tree CRF negative log-likelihood, ``[B]``:
    ``logZ - score(gold tree)``; with ``partial``, the unannotated words
    (head < 0) are marginalized, so the gold term is the log-sum over the
    trees consistent with the annotated arcs (a second, constrained
    inside pass)."""
    B, n, _ = scores.shape
    log_z = tree_crf_inside(scores, word_mask)
    heads = heads.long()
    if partial:
        h_grid = torch.arange(n, device=scores.device)[None, None, :]
        annotated = (heads >= 0) & word_mask.bool()  # [B, n-1]
        allow_words = torch.where(annotated[:, :, None],
                                  h_grid == heads.clamp(min=0)[:, :, None],
                                  True)  # [B, n-1, n]
        arc_mask = torch.cat([torch.ones((B, 1, n), dtype=torch.bool,
                                         device=scores.device),
                              allow_words], dim=1)
        return log_z - tree_crf_inside(scores, word_mask, arc_mask)
    gold = scores[:, 1:, :].gather(2, heads.clamp(min=0)[:, :, None])[..., 0]
    gold = (gold * word_mask.to(gold.dtype)).sum(1)
    return log_z - gold
