"""The plain reference that decides ``correct``: plain PyTorch and numpy,
written from the published descriptions, importing nothing of the program.

- Subwords: the hash tokenizer's rule (a word's 4-character pieces, at most
  3, each md5-hashed into ids 4..V-1; CLS 0, PAD 1, SEP 2; ``<EOS>`` is SEP).
- BM25: Lucene 8 / ES 7 scoring over the documents' term ids, worked out
  again from the documents: idf ``ln(1 + (N - df + 0.5) / (df + 0.5))``,
  ``tf / (tf + k1 (1 - b + b dl / avgdl))`` with Lucene's one-byte length
  norm, k1 1.2, b 0.75, impacts in float32; a document longer than the
  index's row width keeps its highest-impact distinct terms (the width is
  the 99.5th percentile of distinct terms per document, at least 32).
  Scores are summed in float64; the top k is ``lax.top_k``'s: equal scores
  lower id first.
- Fusion (``sentence_link``): each retrieved document in rank order as
  ``[ title ] sentence`` while the running subtoken count, the sentence's
  plus one for ``<EOS>``, stays within the budget.
- XLM-R (Conneau et al. 2019; RoBERTa's layout): RoBERTa position ids,
  post-LayerNorm layers, exact GELU, softmax attention, first-subtoken word
  features, a float32 linear emission head and a linear-chain CRF with no
  move into ``<START>`` and none out of ``<STOP>`` (score -10000).
  Computed in float32 with TF32 off; the CRF in float64.
- Dropout masks are drawn as the configuration states them: one seed per
  site group (the embeddings, each layer, the word features) from the
  step's host generator, each group's masks from a device generator
  seeded with it, in the order of the forward pass.
- AdamW (b1 0.9, b2 0.999, eps 1e-8) in two groups (encoder at lr, the
  rest at lr x lr_rate) on a linear warm-up and decay read at the update
  count before the update, after clipping by the global norm.

``quant="fp8"`` runs the same arithmetic with every matmul operand and
every weight matrix rounded to float8 e4m3 (per-tensor scale, the
gradient passed straight through): the control, one precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

CLS, PAD, SEP = 0, 1, 2
EOS = "<EOS>"
NO_TRANS = -10000.0
FP8_MAX = 448.0


# -- subwords and encoding ----------------------------------------------------

def word_length(word: str, max_pieces: int = 3) -> int:
    return max(1, min(-(-len(word) // 4), max_pieces))


def word_ids(word: str, vocab: int, max_pieces: int = 3) -> List[int]:
    pieces = [word[i:i + 4] for i in range(0, len(word), 4)][:max_pieces]
    pieces = pieces or [word]
    return [4 + int.from_bytes(hashlib.md5(p.encode("utf-8")).digest()[:4],
                               "little") % (vocab - 4) for p in pieces]


def subtokens(words: Sequence[str]) -> int:
    return sum(word_length(w) for w in words)


def encoded_length(words: Sequence[str], max_subtokens: int = 512) -> int:
    """Real subtokens of one fused sentence as :func:`encode` lays it out
    (CLS and SEP included)."""
    n = 1
    for w in words:
        m = 1 if w == EOS else word_length(w)
        if n + m + 1 > max_subtokens:
            break
        n += m
    return n + 1


def encode(sentences: Sequence[Sequence[str]], vocab: int,
           tags: Optional[Sequence[Sequence[int]]] = None,
           max_subtokens: int = 512) -> Dict[str, np.ndarray]:
    """Padded inputs of fused sentences: ids ``[B, S]`` (CLS, each word's
    pieces, SEP; S a multiple of 16, at most ``max_subtokens``; a sentence
    is cut before the word that would pass it), the word starts and masks
    ``[B, W]`` (W a multiple of 8), ``n_words`` (the words before
    ``<EOS>``: the tagged ones) and, with ``tags``, their ids."""
    rows = []
    for words in sentences:
        ids, starts = [CLS], []
        for w in words:
            piece = [SEP] if w == EOS else word_ids(w, vocab)
            if len(ids) + len(piece) + 1 > max_subtokens:
                break
            starts.append(len(ids))
            ids.extend(piece)
        ids.append(SEP)
        n_tagged = words.index(EOS) if EOS in words else len(words)
        rows.append((ids, starts, min(n_tagged, len(starts))))
    B = len(rows)
    S = min(-(-max(len(r[0]) for r in rows) // 16) * 16, max_subtokens)
    W = -(-max(len(r[1]) for r in rows) // 8) * 8
    out = dict(input_ids=np.full((B, S), PAD, np.int64),
               attention_mask=np.zeros((B, S), np.int64),
               word_starts=np.zeros((B, W), np.int64),
               word_mask=np.zeros((B, W), np.float32),
               n_words=np.zeros(B, np.int64),
               tag_ids=np.zeros((B, W), np.int64))
    for b, (ids, starts, n) in enumerate(rows):
        out["input_ids"][b, :len(ids)] = ids
        out["attention_mask"][b, :len(ids)] = 1
        out["word_starts"][b, :len(starts)] = starts
        out["word_mask"][b, :len(starts)] = 1
        out["n_words"][b] = n
        if tags is not None:
            out["tag_ids"][b, :n] = tags[b][:n]
    return out


# -- BM25 ---------------------------------------------------------------------

class BM25:
    """Exact BM25 over ``docs`` (``[N, L]`` term ids, pad < 0) on
    ``device``."""

    def __init__(self, docs: np.ndarray, device, k1: float = 1.2,
                 b: float = 0.75):
        tok = torch.from_numpy(np.array(docs)).to(device).long()
        N = tok.shape[0]
        valid = tok >= 0
        V = int(tok.max()) + 1
        self.n_docs, self.vocab = N, V
        dl = valid.sum(1)
        key = torch.where(valid, tok, V).sort(dim=1).values
        key = key + torch.arange(N, device=device)[:, None] * (V + 1)
        key = key[key % (V + 1) != V]  # row-major: docs in order, terms sorted
        runs, tf = torch.unique_consecutive(key, return_counts=True)
        doc, term = runs // (V + 1), runs % (V + 1)
        del key, runs
        df = torch.bincount(term, minlength=V)
        nt = torch.bincount(doc, minlength=N)
        avgdl = float(dl.double().mean())
        idf = torch.log(1.0 + (N - df.double() + 0.5) / (df.double() + 0.5)
                        ).float()
        # Lucene's one-byte norm keeps the top four bits of the length
        shift = (torch.floor(torch.log2(dl.double().clamp(min=1))) - 3
                 ).clamp(min=0).long()
        dlq = (dl >> shift) << shift
        norm = (k1 * (1.0 - b + b * dlq.double() / avgdl)).float()
        tf32 = tf.float()
        impact = idf[term] * tf32 / (tf32 + norm[doc])
        nt_np = nt.cpu().numpy()
        width = min(int(nt_np.max()), max(32, int(np.percentile(nt_np,
                                                                 99.5))))
        if int(nt_np.max()) > width:
            # a long document keeps its ``width`` highest-impact terms
            # (equal impacts: the lower term id)
            order = torch.sort(-impact, stable=True).indices
            order = order[torch.sort(doc[order], stable=True).indices]
            doc, term, impact = doc[order], term[order], impact[order]
            first = torch.cumsum(nt, 0) - nt
            pos = torch.arange(len(doc), device=device) - first[doc]
            keep = pos < width
            doc, term, impact = doc[keep], term[keep], impact[keep]
        # postings by term
        order = torch.sort(term, stable=True).indices
        self.p_doc = doc[order]
        self.p_imp = impact[order].double()
        counts = torch.bincount(term, minlength=V)
        self.p_off = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        self.p_off_host = self.p_off.cpu().numpy()

    def query_terms(self, text: str) -> Dict[int, int]:
        """A query's terms (``w<id>`` words of the vocabulary) and their
        counts."""
        out: Dict[int, int] = {}
        for w in text.lower().split():
            if w.startswith("w") and w[1:].isdigit() and int(w[1:]) < \
                    self.vocab:
                t = int(w[1:])
                out[t] = out.get(t, 0) + 1
        return out

    def scores(self, text: str, low: bool = False) -> torch.Tensor:
        """``[N]`` scores of one query: float64 sums of the float32
        impacts, or with ``low`` (the control) float32 sums of impacts
        rounded to bfloat16."""
        imp = self.p_imp
        if low:
            imp = imp.to(torch.bfloat16).float()
        s = torch.zeros(self.n_docs, dtype=imp.dtype,
                        device=self.p_doc.device)
        for t, n in self.query_terms(text).items():
            lo, hi = int(self.p_off_host[t]), int(self.p_off_host[t + 1])
            if hi > lo:
                s.index_add_(0, self.p_doc[lo:hi], imp[lo:hi] * n)
        return s

    def topk(self, scores: torch.Tensor, k: int):
        """(ids, scores) of the top ``k`` positive scores, ties lower id
        first."""
        order = torch.sort(-scores, stable=True).indices[:k]
        top = scores[order]
        keep = top > 0
        return order[keep].cpu().numpy(), top[keep].cpu().numpy()


def fuse(tokens: Sequence[str], ranked_docs: Sequence[np.ndarray],
         budget: int = 510) -> List[str]:
    """``sentence_link`` fusion of ``tokens`` with the documents' term rows,
    in rank order."""
    used = subtokens(tokens)
    if used > budget:
        return list(tokens)
    out, used = list(tokens), used + 1
    for row in ranked_docs:
        words = [f"w{t}" for t in row[row >= 0].tolist()]
        ctx = ["[", *[f"w{t}" for t in row[:2].tolist()], "]", *words]
        n = subtokens(ctx)
        if used + n > budget:
            break
        if len(out) == len(tokens):
            out.append(EOS)
        out.extend(ctx)
        used += n
    return out


# -- the tagger ---------------------------------------------------------------

def _q8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes straight through."""
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = amax / FP8_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (y - x).detach()


class Tagger:
    """XLM-R + CRF over a ``{name: float32 tensor}`` parameter dict named as
    the configuration's layout (``encoder.layers.<i>.attention.query.weight``
    ...)."""

    def __init__(self, params: Dict[str, torch.Tensor], model: dict,
                 start: int, stop: int, quant: Optional[str] = None):
        self.p = params
        self.m = model
        self.start, self.stop = start, stop
        self.quant = quant

    def _w(self, name: str) -> torch.Tensor:
        w = self.p[name]
        return _q8(w) if self.quant == "fp8" and w.dim() == 2 else w

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.quant == "fp8":
            a, b = _q8(a), _q8(b)
        return torch.matmul(a, b)

    def _linear(self, x, name):
        return self._mm(x, self._w(name + ".weight").t()) + self.p[
            name + ".bias"]

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.p[name + ".weight"],
                            self.p[name + ".bias"],
                            self.m["layer_norm_eps"])

    def features(self, ids, mask, starts, word_mask, drops=None):
        """Word features ``[B, W, H]``. ``drops`` (a :class:`Drops`) applies
        the training masks."""
        m = self.m
        H, nH = m["hidden_size"], m["num_attention_heads"]
        hd = H // nH
        e = "encoder."
        pos = torch.cumsum(mask, 1) * mask + m["pad_token_id"]
        x = (self._w(e + "word_embeddings.weight")[ids]
             + self._w(e + "position_embeddings.weight")[pos]
             + self.p[e + "token_type_embeddings.weight"][0])
        x = self._ln(x, e + "embeddings_ln")
        if drops is not None:
            x = drops.apply(x, drops.emb)
        bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
        B, S, _ = x.shape
        for i in range(m["num_hidden_layers"]):
            L = f"{e}layers.{i}."
            gen = None if drops is None else drops.layer(i)

            def heads(t):
                return t.view(B, S, nH, hd).transpose(1, 2)

            q = heads(self._linear(x, L + "attention.query"))
            k = heads(self._linear(x, L + "attention.key"))
            v = heads(self._linear(x, L + "attention.value"))
            probs = torch.softmax(self._mm(q, k.transpose(-1, -2))
                                  / math.sqrt(hd) + bias, dim=-1)
            if gen is not None:
                probs = drops.apply(probs, gen, drops.attn_rate)
            ctx = self._mm(probs, v).transpose(1, 2).reshape(B, S, H)
            a = self._linear(ctx, L + "attention.out")
            if gen is not None:
                a = drops.apply(a, gen)
            x = self._ln(x + a, L + "attention_ln")
            h = self._linear(F.gelu(self._linear(x, L + "intermediate")),
                             L + "output")
            if gen is not None:
                h = drops.apply(h, gen)
            x = self._ln(x + h, L + "output_ln")
        st = starts.clamp(0, S - 1)
        feats = torch.gather(x, 1, st[..., None].expand(-1, -1, H))
        feats = feats * word_mask[..., None]
        if drops is not None:
            feats = drops.word(feats)
        return feats

    def emissions(self, feats: torch.Tensor) -> torch.Tensor:
        w = self._w("emission.weight")
        return self._mm(feats, w.t()) + self.p["emission.bias"]

    def transitions(self) -> torch.Tensor:
        t = self.p["transitions"].double().clone()
        t[:, self.start] = NO_TRANS
        t[self.stop, :] = NO_TRANS
        return t

    def nll(self, em: torch.Tensor, tags: torch.Tensor, n: torch.Tensor
            ) -> torch.Tensor:
        """Per-sentence CRF negative log-likelihood over each row's first
        ``n`` words."""
        trans = self.transitions()
        em = em.double()
        B = em.shape[0]
        alpha = trans[self.start][None] + em[:, 0]
        gold = trans[self.start, tags[:, 0]] + em[torch.arange(B), 0,
                                                    tags[:, 0]]
        last = tags[:, 0]
        for t in range(1, int(n.max())):
            on = (t < n)
            step = (torch.logsumexp(alpha[:, :, None] + trans[None], 1)
                    + em[:, t])
            alpha = torch.where(on[:, None], step, alpha)
            g = trans[last, tags[:, t]] + em[torch.arange(B), t, tags[:, t]]
            gold = gold + torch.where(on, g, 0.0)
            last = torch.where(on, tags[:, t], last)
        log_z = torch.logsumexp(alpha + trans[:, self.stop][None], 1)
        gold = gold + trans[last, self.stop]
        return log_z - gold

    def viterbi(self, em: torch.Tensor, n: int):
        """(best path, its score) over the first ``n`` words of ``em``
        ``[W, K]``."""
        trans = self.transitions()
        em = em.double()
        alpha = trans[self.start] + em[0]
        back = []
        for t in range(1, n):
            s = alpha[:, None] + trans
            alpha, arg = s.max(0)
            alpha = alpha + em[t]
            back.append(arg)
        end = alpha + trans[:, self.stop]
        best = int(end.argmax())
        score = float(end[best])
        path = [best]
        for arg in reversed(back):
            path.append(int(arg[path[-1]]))
        return path[::-1], score

    def path_score(self, em: torch.Tensor, path: Sequence[int]) -> float:
        trans = self.transitions()
        em = em.double()
        s = trans[self.start, path[0]] + em[0, path[0]]
        for t in range(1, len(path)):
            s = s + trans[path[t - 1], path[t]] + em[t, path[t]]
        return float(s + trans[path[-1], self.stop])


class Drops:
    """One training step's dropout masks, drawn as the configuration states
    them: seeds from the step's host generator ``rng`` (one for the
    embeddings, one per layer, one for the word features, in that order),
    each group's masks from a device generator seeded with its seed, drawn
    over the whole batch and cut to ``rows``."""

    def __init__(self, rng: torch.Generator, n_layers: int, device,
                 hidden: float, attn: float, word: float):
        def draw():
            return int(torch.randint(0, 2**62, (1,), generator=rng))

        self.emb_seed = draw()
        self.layer_seeds = [draw() for _ in range(n_layers)]
        self.word_seed = draw()
        self.device = device
        self.rate, self.attn_rate, self.word_rate = hidden, attn, word
        self.rows = slice(None)
        self.batch = None

    def _gen(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def start(self, batch: int, rows: slice) -> None:
        """A block of ``rows`` of a batch of ``batch`` rows."""
        self.batch, self.rows = batch, rows
        self.emb = self._gen(self.emb_seed)

    def layer(self, i: int) -> torch.Generator:
        return self._gen(self.layer_seeds[i])

    def _uniform(self, shape, gen):
        full = (self.batch,) + tuple(shape[1:])
        return torch.rand(full, generator=gen, device=self.device)[self.rows]

    def apply(self, x, gen, rate=None):
        rate = self.rate if rate is None else rate
        if rate <= 0:
            return x
        keep = 1.0 - rate
        return torch.where(self._uniform(x.shape, gen) < keep, x / keep, 0.0)

    def word(self, feats):
        gen = self._gen(self.word_seed)
        if self.word_rate <= 0:
            return feats
        B, W, _ = feats.shape
        drop = self._uniform((B, W, 1), gen) < self.word_rate
        return torch.where(drop, 0.0, feats)


def adamw(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          state: dict, lrs: Dict[str, float], clip: float,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One AdamW update in place (no weight decay); ``lrs`` by group."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = 1.0 if float(norm) < clip else clip / float(norm)
    state["n"] = n = state.get("n", 0) + 1
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
    for name, p in params.items():
        g = grads[name] * scale
        mu = state.setdefault("mu", {}).setdefault(name, torch.zeros_like(p))
        nu = state.setdefault("nu", {}).setdefault(name, torch.zeros_like(p))
        mu.mul_(b1).add_(g, alpha=1 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1 - b2)
        group = "encoder" if "encoder" in name.split(".") else "head"
        lr = lrs[group]
        if lr:
            p.sub_(lr * (mu / bc1) / ((nu / bc2).sqrt() + eps))


def linear_schedule(peak: float, warmup: int, total: int, count: int
                    ) -> float:
    warmup = max(warmup, 1)
    if count < warmup:
        return peak * count / warmup
    decay = max(total - warmup, 1)
    return peak * (1.0 - min(count - warmup, decay) / decay)
