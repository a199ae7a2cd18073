"""Sequence tagger: XLM-R encoder + first-subtoken pooling + emission + CRF
(counterpart of ``kbner_tpu/models/tagger.py``).

  - encoder hidden states -> gather each word's first subtoken (indices
    clipped into the sequence, as ``take_along_axis(mode="clip")`` does);
  - word-mask multiply, word dropout, the ``embedding2nn`` re-projection,
    locked dropout;
  - float32 linear emission scores over the tagset;
  - a CRF over constrained transitions (nothing moves into ``<START>``,
    nothing out of ``<STOP>``: score -10000), one matrix or one per
    language (``num_languages``, selected by the batch's ``lang_ids``); or
    a softmax head (``use_crf=False``).

Losses: the mean per-sentence CRF negative log-likelihood with
transition-skip masking (or masked token cross-entropy), and the
multi-view agreement loss. Dropout is on when a host ``torch.Generator``
is passed as ``rng`` (see :mod:`.xlmr`), and off without one.

:class:`StackedSequenceTagger` takes its word features from a stack of
embedders (:mod:`.embedders`) instead, under the batch's ACE
``selection`` mask.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.crf import crf_decode, crf_marginals, crf_neg_log_likelihood
from ..ops.losses import feature_l2_loss
from ..ops.losses import multi_view_loss as mv_loss
from .embedders import EmbedderSpec, StackedEmbedder, reset_dense_
from .xlmr import Linear, XLMRConfig, XLMREncoder, device_generator

NO_TRANS = -10000.0
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TaggerConfig:
    encoder: XLMRConfig
    num_tags: int  # includes <START>/<STOP> as the last two indices
    start_idx: int
    stop_idx: int
    use_crf: bool = True
    relearn_embeddings: bool = True  # embedding2nn
    locked_dropout: float = 0.5
    word_dropout: float = 0.05
    num_languages: int = 0  # 0 = shared transitions
    transition_attention: bool = False

    @classmethod
    def for_tag_dictionary(cls, encoder: XLMRConfig, tag_dict, **kw):
        return cls(
            encoder=encoder,
            num_tags=len(tag_dict),
            start_idx=tag_dict.get_idx_for_item("<START>"),
            stop_idx=tag_dict.get_idx_for_item("<STOP>"),
            **kw,
        )


def _tagger_device(config: TaggerConfig, device) -> torch.device:
    if config.transition_attention:
        raise NotImplementedError(
            "transition_attention waits for the distillation trainer's "
            "slice of kbner_tpu_torch (ROADMAP A6)")
    return resolve_device(device)


class SequenceTagger(nn.Module):
    """XLM-R + CRF (or softmax) tagger. Parameters are made on ``device``
    (the card by default) in the encoder's storage dtype (the emission
    head and transitions in float32) and drawn from a ``torch.Generator``
    seeded with ``seed``: normal(0, 0.02) for matrices and embedding
    tables, zero biases, unit LayerNorm scales, normal(0, 1)
    transitions."""

    def __init__(self, config: TaggerConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = _tagger_device(config, device)
        self.encoder = XLMREncoder(config.encoder, device=device)
        self._heads(config, device, config.encoder.hidden_size,
                    config.encoder.storage_dtype)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    def _heads(self, config: TaggerConfig, device: torch.device, width: int,
               dtype: torch.dtype) -> None:
        """``embedding2nn`` (``width`` wide, stored in ``dtype``), the
        float32 emission head and the transitions."""
        self.config = config
        self.embedding2nn = (
            Linear(width, width, device=device, dtype=dtype)
            if config.relearn_embeddings else None)
        self.emission = Linear(width, config.num_tags, device=device,
                               dtype=torch.float32)
        self.transitions = None
        if config.use_crf:
            shape = (config.num_tags, config.num_tags)
            if config.num_languages > 0:
                shape = (config.num_languages,) + shape
            self.transitions = nn.Parameter(torch.empty(shape, device=device))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, 0.02, generator=gen)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
            if isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        if self.transitions is not None:
            self.transitions.normal_(0.0, 1.0, generator=gen)

    @property
    def device(self) -> torch.device:
        return self.emission.weight.device

    # -- transitions ----------------------------------------------------------

    def transition_matrix(self, lang_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Constrained transitions: ``[K, K]``, or ``[B, K, K]`` when the
        tagger keeps one matrix per language and ``lang_ids`` are given
        (clipped into the languages; without them, language 0's)."""
        cfg = self.config
        t = self.transitions.clone()
        t[..., :, cfg.start_idx] = NO_TRANS
        t[..., cfg.stop_idx, :] = NO_TRANS
        if cfg.num_languages > 0:
            if lang_ids is None:
                return t[0]
            return t[lang_ids.long().clamp(0, cfg.num_languages - 1)]
        return t

    def _batch_transitions(self, batch: Batch) -> torch.Tensor:
        return self.transition_matrix(batch.get("lang_ids"))

    # -- features -------------------------------------------------------------

    def _extract_features(self, batch: Batch,
                          rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        """Raw word features ``[B, W, H]``: the encoder's hidden state at
        each word's first subtoken (positions clipped into the sequence)."""
        hidden = self.encoder(batch["input_ids"], batch["attention_mask"],
                              rng=rng)
        starts = batch["word_starts"].long().clamp(0, hidden.shape[1] - 1)
        return torch.gather(
            hidden, 1, starts.unsqueeze(-1).expand(-1, -1, hidden.shape[2]))

    def _word_features(self, batch: Batch,
                       rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Word features ``[B, W, H]`` in the compute dtype: first-subtoken
        gather, word mask, word dropout (whole word vectors zeroed, not
        rescaled), ``embedding2nn``, locked dropout (one mask per sentence
        and channel over all words, rescaled by 1 / keep)."""
        cfg = self.config
        feats = self._extract_features(batch, rng)
        feats = feats * batch["word_mask"].unsqueeze(-1).to(feats.dtype)
        gen = device_generator(rng, feats.device)
        B, W, H = feats.shape
        if gen is not None and cfg.word_dropout > 0:
            drop = torch.rand((B, W, 1), generator=gen,
                              device=feats.device) < cfg.word_dropout
            feats = torch.where(drop, 0.0, feats)
        if self.embedding2nn is not None:
            feats = self.embedding2nn(feats)
        if gen is not None and cfg.locked_dropout > 0:
            keep = 1.0 - cfg.locked_dropout
            mask = torch.rand((B, 1, H), generator=gen,
                              device=feats.device) < keep
            feats = feats * mask / keep
        return feats

    def emissions(self, batch: Batch,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Float32 emission scores ``[B, W, K]``."""
        return self.emission(self._word_features(batch, rng).float())

    # -- losses ---------------------------------------------------------------

    def _gold_loss(self, emissions: torch.Tensor, batch: Batch
                   ) -> torch.Tensor:
        cfg = self.config
        if cfg.use_crf:
            nll = crf_neg_log_likelihood(
                emissions, batch["tag_ids"], batch["crf_mask"],
                self._batch_transitions(batch), cfg.start_idx, cfg.stop_idx)
            return nll.mean()
        logp = F.log_softmax(emissions, dim=-1)
        gold = torch.gather(logp, 2, batch["tag_ids"].long().unsqueeze(2))
        mask = batch["crf_mask"].float()
        return -(gold.squeeze(2) * mask).sum() / mask.sum().clamp(min=1.0)

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None,
             return_emissions: bool = False):
        """Mean per-sentence CRF NLL, or masked token cross-entropy for
        the softmax head."""
        emissions = self.emissions(batch, rng)
        loss = self._gold_loss(emissions, batch)
        if return_emissions:
            return loss, emissions
        return loss

    def multi_view_loss(
        self,
        batch: Batch,
        orig_batch: Batch,
        rng: Optional[torch.Generator] = None,
        agreement_weight: float = 1.0,
        l2_weight: float = 0.0,
        kind: str = "kl",
    ) -> torch.Tensor:
        """The context view (``batch``) trains on its gold loss; its
        posterior marginals (detached) teach the context-free view
        (``orig_batch``, the same sentences cut at ``<EOS>``) on the shared
        original positions; an optional L2 term matches their features."""
        cfg = self.config
        feats_ctx = self._word_features(batch, rng)
        feats_orig = self._word_features(orig_batch, rng)
        em_ctx = self.emission(feats_ctx.float())
        em_orig = self.emission(feats_orig.float())
        loss = self._gold_loss(em_ctx, batch)
        if cfg.use_crf:
            trans = self._batch_transitions(batch)
            marg_ctx = crf_marginals(em_ctx, batch["crf_mask"], trans,
                                     cfg.start_idx, cfg.stop_idx)
            marg_orig = crf_marginals(em_orig, orig_batch["crf_mask"], trans,
                                      cfg.start_idx, cfg.stop_idx)
        else:
            marg_ctx = F.softmax(em_ctx, -1)
            marg_orig = F.softmax(em_orig, -1)
        # the orig view's word axis is a prefix of the context view's
        W = orig_batch["word_mask"].shape[1]
        shared = orig_batch["word_mask"]
        loss = loss + agreement_weight * mv_loss(
            marg_ctx[:, :W], marg_orig[:, :W], shared, kind=kind)
        if l2_weight > 0:
            loss = loss + l2_weight * feature_l2_loss(
                feats_ctx[:, :W].float(), feats_orig[:, :W].float(), shared)
        return loss

    def distill_loss(self, *args, **kwargs):
        raise NotImplementedError(
            "distill_loss waits for the distillation trainer's slice of "
            "kbner_tpu_torch (ROADMAP A6)")

    def kbest_distill_loss(self, *args, **kwargs):
        raise NotImplementedError(
            "kbest_distill_loss waits for the distillation trainer's slice "
            "of kbner_tpu_torch (ROADMAP A6)")

    # -- decoding -------------------------------------------------------------

    @torch.no_grad()
    def decode(self, batch: Batch, pad_tag: int = 0,
               posterior: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tags ``[B, W]`` int32 + scores ``[B]``: Viterbi, the argmax of
        the forward-backward marginals (``posterior=True``), or the
        softmax head's argmax. Masked positions get ``pad_tag``."""
        cfg = self.config
        emissions = self.emissions(batch)
        mask = batch["crf_mask"].bool()
        if cfg.use_crf and posterior:
            marg = crf_marginals(emissions, mask,
                                 self._batch_transitions(batch),
                                 cfg.start_idx, cfg.stop_idx)
            best, tags = marg.max(dim=-1)
            score = (torch.log(best + 1e-9) * mask).sum(-1)
        elif cfg.use_crf:
            return crf_decode(emissions, mask, self._batch_transitions(batch),
                              cfg.start_idx, cfg.stop_idx, pad_tag=pad_tag)
        else:
            tags = emissions.argmax(dim=-1)
            score = F.log_softmax(emissions, -1).max(dim=-1).values.sum(-1)
        tags = torch.where(mask, tags, torch.full_like(tags, pad_tag))
        return tags.to(torch.int32), score

    @torch.no_grad()
    def marginals(self, batch: Batch) -> torch.Tensor:
        """Posterior tag marginals ``[B, W, K]`` (softmax for the softmax
        head)."""
        cfg = self.config
        emissions = self.emissions(batch)
        if cfg.use_crf:
            return crf_marginals(emissions, batch["crf_mask"],
                                 self._batch_transitions(batch),
                                 cfg.start_idx, cfg.stop_idx)
        return F.softmax(emissions, dim=-1)


class StackedSequenceTagger(SequenceTagger):
    """The tagger over a stack of embedders (the ACE substrate): the word
    features are the :class:`StackedEmbedder` of ``specs`` under the
    batch's ``selection`` mask (a float ``[N]`` vector, all members when
    absent); ``embedding2nn`` and the emission head run over the stack's
    total width in float32. Parameters are drawn as Flax draws them (see
    :mod:`.embedders`; transitions normal(0, 1)) from a generator seeded
    with ``seed`` on ``device``."""

    def __init__(self, config: TaggerConfig, specs: Sequence[EmbedderSpec],
                 device="cuda", seed: int = 0):
        nn.Module.__init__(self)
        device = _tagger_device(config, device)
        self.specs = tuple(specs)
        self.stack = StackedEmbedder([s.module for s in specs]).to(device)
        self._heads(config, device, sum(s.dim for s in specs),
                    torch.float32)
        self._init_weights(torch.Generator(device=device).manual_seed(seed))

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for member in self.stack.members:
            member.reset_parameters(gen)
        for lin in (self.embedding2nn, self.emission):
            if lin is not None:
                reset_dense_(lin, gen)
        if self.transitions is not None:
            self.transitions.normal_(0.0, 1.0, generator=gen)

    def _extract_features(self, batch: Batch,
                          rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        return self.stack(batch, batch.get("selection"))
