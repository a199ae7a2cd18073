"""Sequence tagger: XLM-R encoder + first-subtoken pooling + emission + CRF
(counterpart of ``kbner_tpu/models/tagger.py``).

  - encoder hidden states -> gather each word's first subtoken (indices
    clipped into the sequence, as ``take_along_axis(mode="clip")`` does);
  - word-mask multiply, word dropout, the ``embedding2nn`` re-projection,
    locked dropout;
  - float32 linear emission scores over the tagset;
  - a CRF over constrained transitions (nothing moves into ``<START>``,
    nothing out of ``<STOP>``: score -10000), one matrix or one per
    language (``num_languages``, selected by the batch's ``lang_ids``),
    or with ``transition_attention`` a per-sentence softmax mixture of
    the languages' matrices predicted from the mean word feature; or a
    softmax head (``use_crf=False``).

Losses: the mean per-sentence CRF negative log-likelihood with
transition-skip masking (or masked token cross-entropy), the multi-view
agreement loss, and the distillation losses (logit or posterior-marginal,
and k-best sequence distillation). Dropout is on when a host
``torch.Generator`` is passed as ``rng`` (see :mod:`.xlmr`), and off
without one.

The attention mixture serves the gold loss and decoding; the multi-view
loss, the marginals and the distillation terms use the per-language
matrices (``lang_ids``), as the JAX package's tagger does.

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
from ..ops.crf import (crf_decode, crf_forward, crf_gold_score,
                       crf_marginals, crf_neg_log_likelihood, live_columns)
from ..ops.losses import (distillation_loss, feature_l2_loss,
                          posterior_distillation_loss)
from ..ops.losses import multi_view_loss as mv_loss
from ..utils.spans import span
from .embedders import (EmbedderSpec, StackedEmbedder, reset_dense_,
                        reset_flax_)
from .xlmr import (Linear, XLMRConfig, XLMREncoder, device_generator,
                   draw_uniform)

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


class SequenceTagger(nn.Module):
    """XLM-R + CRF (or softmax) tagger. Parameters are made on ``device``
    (the card by default) in the encoder's storage dtype (the emission
    head, transitions and transition attention in float32) and drawn from
    a ``torch.Generator`` seeded with ``seed`` from Flax's distributions:
    Dense matrices lecun-normal, embedding tables normal(0, 1/sqrt(D)),
    zero biases, unit LayerNorm scales, normal(0, 1) transitions and the
    attention's ``[H, L]`` normal(0, 0.02)."""

    def __init__(self, config: TaggerConfig, device="cuda", seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        self.encoder = XLMREncoder(config.encoder, device=device)
        self._heads(config, device, config.encoder.hidden_size,
                    config.encoder.storage_dtype)
        self._draw(device, seed)

    def _heads(self, config: TaggerConfig, device: torch.device, width: int,
               dtype: torch.dtype) -> None:
        """``embedding2nn`` (``width`` wide, stored in ``dtype``), the
        float32 emission head, the transitions and the transition
        attention's ``[width, L]`` matrix and ``[L]`` bias."""
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
        self.sent_to_trans_att = self.sent_to_trans_att_b = None
        if (config.use_crf and config.num_languages > 0
                and config.transition_attention):
            L = config.num_languages
            self.sent_to_trans_att = nn.Parameter(
                torch.empty((width, L), device=device))
            self.sent_to_trans_att_b = nn.Parameter(
                torch.empty((L,), device=device))

    def _draw(self, device: torch.device, seed: int) -> None:
        """Draw the parameters from a generator seeded with ``seed``; on
        the meta device (shapes without storage) there is nothing to
        draw."""
        if device.type != "meta":
            self._init_weights(torch.Generator(device=device).manual_seed(
                seed))

    @torch.no_grad()
    def _init_heads(self, gen: torch.Generator) -> None:
        """Transitions normal(0, 1); the attention normal(0, 0.02) with a
        zero bias."""
        if self.transitions is not None:
            self.transitions.normal_(0.0, 1.0, generator=gen)
        if self.sent_to_trans_att is not None:
            self.sent_to_trans_att.normal_(0.0, 0.02, generator=gen)
            self.sent_to_trans_att_b.zero_()

    def _init_weights(self, gen: torch.Generator) -> None:
        """Flax's defaults, as ``init_tagger`` draws them: every Dense
        lecun-normal with a zero bias, every Embed normal(0, 1/sqrt(D)),
        LayerNorms ones and zeros (:func:`.embedders.reset_flax_`); then
        the heads (:meth:`_init_heads`)."""
        reset_flax_(self, gen)
        self._init_heads(gen)

    @property
    def device(self) -> torch.device:
        return self.emission.weight.device

    # -- transitions ----------------------------------------------------------

    def _constrained(self) -> torch.Tensor:
        """The transitions (every language's) with nothing into
        ``<START>`` and nothing out of ``<STOP>``."""
        cfg = self.config
        t = self.transitions.clone()
        t[..., :, cfg.start_idx] = NO_TRANS
        t[..., cfg.stop_idx, :] = NO_TRANS
        return t

    def transition_matrix(self, lang_ids: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """Constrained transitions: ``[K, K]``, or ``[B, K, K]`` when the
        tagger keeps one matrix per language and ``lang_ids`` are given
        (clipped into the languages; without them, language 0's)."""
        cfg = self.config
        t = self._constrained()
        if cfg.num_languages > 0:
            if lang_ids is None:
                return t[0]
            return t[lang_ids.long().clamp(0, cfg.num_languages - 1)]
        return t

    def _batch_transitions(self, batch: Batch,
                           feats: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
        """The batch's transitions. With transition attention and word
        ``feats``: ``[B, K, K]``, each sentence's softmax mixture of the
        constrained per-language matrices, weighted from its features'
        mean over its words; else :meth:`transition_matrix` of the batch's
        ``lang_ids``."""
        if self.sent_to_trans_att is None or feats is None:
            return self.transition_matrix(batch.get("lang_ids"))
        m = batch["word_mask"].float().unsqueeze(-1)
        sent = (feats.float() * m).sum(1) / m.sum(1).clamp(min=1.0)
        att = F.softmax(sent @ self.sent_to_trans_att
                        + self.sent_to_trans_att_b, dim=-1)
        return torch.einsum("bl,lij->bij", att, self._constrained())

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
            drop = draw_uniform((B, W, 1), gen,
                                feats.device) < cfg.word_dropout
            feats = torch.where(drop, 0.0, feats)
        if self.embedding2nn is not None:
            feats = self.embedding2nn(feats)
        if gen is not None and cfg.locked_dropout > 0:
            keep = 1.0 - cfg.locked_dropout
            mask = draw_uniform((B, 1, H), gen, feats.device) < keep
            feats = feats * mask / keep
        return feats

    def _features_and_emissions(self, batch: Batch,
                                rng: Optional[torch.Generator] = None):
        """``(word features, float32 emission scores [B, W, K])``."""
        feats = self._word_features(batch, rng)
        return feats, self.emission(feats.float())

    def emissions(self, batch: Batch,
                  rng: Optional[torch.Generator] = None) -> torch.Tensor:
        """Float32 emission scores ``[B, W, K]``."""
        return self._features_and_emissions(batch, rng)[1]

    # -- losses ---------------------------------------------------------------

    def _gold_loss(self, emissions: torch.Tensor, batch: Batch,
                   feats: Optional[torch.Tensor] = None,
                   token_norm: Optional[float] = None) -> torch.Tensor:
        cfg = self.config
        if cfg.use_crf:
            with span("kbner.train.crf"):
                nll = crf_neg_log_likelihood(
                    emissions, batch["tag_ids"], batch["crf_mask"],
                    self._batch_transitions(batch, feats), cfg.start_idx,
                    cfg.stop_idx)
                return nll.mean()
        logp = F.log_softmax(emissions, dim=-1)
        gold = torch.gather(logp, 2, batch["tag_ids"].long().unsqueeze(2))
        mask = batch["crf_mask"].float()
        if token_norm is None:
            token_norm = mask.sum().clamp(min=1.0)
        return -(gold.squeeze(2) * mask).sum() / token_norm

    def loss(self, batch: Batch, rng: Optional[torch.Generator] = None,
             return_emissions: bool = False,
             token_norm: Optional[float] = None):
        """Mean per-sentence CRF NLL, or masked token cross-entropy for
        the softmax head, the latter over ``token_norm`` when given (a
        data-parallel rank's share of the global token count) instead of
        the batch's token count."""
        with span("kbner.train.forward"):
            feats, emissions = self._features_and_emissions(batch, rng)
        loss = self._gold_loss(emissions, batch, feats, token_norm)
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
        token_norm: Optional[float] = None,
        shared_norm: Optional[float] = None,
    ) -> torch.Tensor:
        """The context view (``batch``) trains on its gold loss; its
        posterior marginals (detached) teach the context-free view
        (``orig_batch``, the same sentences cut at ``<EOS>``) on the shared
        original positions; an optional L2 term matches their features.
        A data-parallel rank gives its shares of the global batch's counts:
        ``token_norm`` of ``crf_mask`` (the softmax head's gold term),
        ``shared_norm`` of the orig view's ``word_mask`` (the agreement and
        L2 terms)."""
        cfg = self.config
        feats_ctx = self._word_features(batch, rng)
        feats_orig = self._word_features(orig_batch, rng)
        em_ctx = self.emission(feats_ctx.float())
        em_orig = self.emission(feats_orig.float())
        loss = self._gold_loss(em_ctx, batch, token_norm=token_norm)
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
            marg_ctx[:, :W], marg_orig[:, :W], shared, kind=kind,
            norm=shared_norm)
        if l2_weight > 0:
            loss = loss + l2_weight * feature_l2_loss(
                feats_ctx[:, :W].float(), feats_orig[:, :W].float(), shared,
                norm=shared_norm)
        return loss

    def distill_loss(
        self,
        batch: Batch,
        teacher_logits: torch.Tensor,  # [B, W, K] float32
        rng: Optional[torch.Generator] = None,
        interpolation: float = 0.5,
        temperature: float = 1.0,
        posterior: bool = False,
        token_norm: Optional[float] = None,
    ) -> torch.Tensor:
        """``interpolation * kd + (1 - interpolation) * gold loss``: kd is
        the temperature cross-entropy against the teacher's logits, or
        with ``posterior`` (CRF only) the cross-entropy of the student's
        CRF marginals against the teacher's, both under the per-language
        transitions. Token means (kd, the softmax head's gold term) are
        over ``token_norm`` when given, as in :meth:`loss`."""
        cfg = self.config
        loss, emissions = self.loss(batch, rng, return_emissions=True,
                                    token_norm=token_norm)
        mask = batch["crf_mask"]
        if posterior and cfg.use_crf:
            trans = self._batch_transitions(batch)
            marg_s = crf_marginals(emissions, mask, trans, cfg.start_idx,
                                   cfg.stop_idx)
            with torch.no_grad():  # the teacher's side is detached
                marg_t = crf_marginals(teacher_logits, mask, trans,
                                       cfg.start_idx, cfg.stop_idx)
            kd = posterior_distillation_loss(marg_s, marg_t, mask,
                                             norm=token_norm)
        else:
            kd = distillation_loss(emissions, teacher_logits, mask,
                                   temperature=temperature, norm=token_norm)
        return interpolation * kd + (1.0 - interpolation) * loss

    def kbest_distill_loss(
        self,
        batch: Batch,
        teacher_paths: torch.Tensor,  # [B, N, W] teacher k-best tags
        teacher_weights: torch.Tensor,  # [B, N] path weights
        rng: Optional[torch.Generator] = None,
        interpolation: float = 0.5,
        token_norm: Optional[float] = None,
    ) -> torch.Tensor:
        """Sequence-level distillation: kd is minus the mean over
        sentences of the weighted log-likelihood of the teacher's N paths
        under the student's CRF (gold score minus log Z, the per-language
        transitions), mixed with the gold loss (``token_norm`` as in
        :meth:`loss`). The N paths go through one batched gold-score call
        over ``B * N`` rows."""
        cfg = self.config
        loss, emissions = self.loss(batch, rng, return_emissions=True,
                                    token_norm=token_norm)
        mask = batch["crf_mask"]
        trans = self._batch_transitions(batch)
        log_z = crf_forward(emissions, mask, trans, cfg.start_idx,
                            cfg.stop_idx)  # [B]
        B, N, W = teacher_paths.shape

        def rep(x):  # each sentence's row once per path
            return x.repeat_interleave(N, dim=0)

        gold = crf_gold_score(
            rep(emissions), teacher_paths.reshape(B * N, W), rep(mask),
            trans if trans.dim() == 2 else rep(trans), cfg.start_idx,
            cfg.stop_idx)
        lls = gold.view(B, N) - log_z[:, None]
        kd = -(teacher_weights * lls).sum(1).mean()
        return interpolation * kd + (1.0 - interpolation) * loss

    # -- decoding -------------------------------------------------------------

    @torch.no_grad()
    def decode(self, batch: Batch, pad_tag: int = 0,
               posterior: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tags ``[B, W]`` int32 + scores ``[B]``: Viterbi, the argmax of
        the forward-backward marginals (``posterior=True``), or the
        softmax head's argmax. Masked positions get ``pad_tag``."""
        cfg = self.config
        mask = batch["crf_mask"].bool()
        with span("kbner.tag.forward"):
            # before the forward is queued, so that finding them waits
            # for the mask alone and the loop queues behind the encoder
            cols = (live_columns(mask) if cfg.use_crf and not posterior
                    else None)
            feats, emissions = self._features_and_emissions(batch)
        if cfg.use_crf and posterior:
            marg = crf_marginals(emissions, mask,
                                 self._batch_transitions(batch, feats),
                                 cfg.start_idx, cfg.stop_idx)
            best, tags = marg.max(dim=-1)
            score = (torch.log(best + 1e-9) * mask).sum(-1)
        elif cfg.use_crf:
            with span("kbner.tag.crf", columns=emissions.shape[1]) as s:
                if s:
                    s.add("live_columns", cols.numel())
                return crf_decode(emissions, mask,
                                  self._batch_transitions(batch, feats),
                                  cfg.start_idx, cfg.stop_idx,
                                  pad_tag=pad_tag, cols=cols)
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
    total width in float32, as does the transition attention. Parameters
    are drawn as Flax draws them (see :mod:`.embedders`; transitions
    normal(0, 1), the attention normal(0, 0.02)) from a generator seeded
    with ``seed`` on ``device``."""

    def __init__(self, config: TaggerConfig, specs: Sequence[EmbedderSpec],
                 device="cuda", seed: int = 0):
        nn.Module.__init__(self)
        device = resolve_device(device)
        self.specs = tuple(specs)
        self.stack = StackedEmbedder([s.module for s in specs]).to(device)
        self._heads(config, device, sum(s.dim for s in specs),
                    torch.float32)
        self._draw(device, seed)

    @torch.no_grad()
    def _init_weights(self, gen: torch.Generator) -> None:
        for member in self.stack.members:
            member.reset_parameters(gen)
        for lin in (self.embedding2nn, self.emission):
            if lin is not None:
                reset_dense_(lin, gen)
        self._init_heads(gen)

    def _extract_features(self, batch: Batch,
                          rng: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
        return self.stack(batch, batch.get("selection"))
