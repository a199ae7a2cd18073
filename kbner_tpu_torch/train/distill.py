"""Knowledge distillation (counterpart of ``kbner_tpu/train/distill.py``).

A student tagger trains on the interpolation of its gold loss with a
distillation term against its teachers: the teachers' emission scores
(logit or CRF-posterior distillation) or the first teacher's k-best CRF
paths (sequence distillation).

  - The train batches are fixed (``make_batches(..., shuffle=False)`` over
    the corpus's train split, no epoch resampling or windows), so the
    teachers' outputs stay aligned with them; each epoch visits them in
    the order ``RandomState(seed).permutation`` gives.
  - Teachers are routed per sentence: ``clip(lang_id, 0, n_teachers - 1)``
    picks the teacher whose emissions that sentence learns from.
  - ``teacher_cache`` ``"f16"`` keeps each batch's teacher emissions on
    the host in float16 (numpy's rounding of the float32 scores),
    ``"f32"`` in float32; either way the teachers run one at a time over
    every batch on the trainer's device and go back to the CPU after
    their pass. ``"lazy"`` keeps every teacher on the device and runs
    them again for each batch.
  - ``kbest > 0``: ``teachers[0]``'s ``kbest`` best CRF paths
    (``crf_decode_nbest`` under its language-0 transitions) with a
    softmax over their scores as weights, cached on the host.
  - ``best-model.msgpack`` is written whenever the epoch's dev score (the
    negated train loss without dev sets) is at least the best so far,
    ``final-model.msgpack`` at the end.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.encode import EncodedBatch, make_batches
from ..models.tagger import SequenceTagger
from ..ops.crf import crf_decode_nbest
from .optim import make_finetune_optimizer
from .trainer import FinetuneTrainer, TrainConfig

log = logging.getLogger("kbner_tpu_torch")
TEACHER_CACHES = ("f16", "f32", "lazy")


@dataclasses.dataclass
class DistillConfig(TrainConfig):
    interpolation: float = 0.5  # weight of the distillation term
    temperature: float = 1.0
    posterior: bool = False  # distill CRF posterior marginals, not logits
    kbest: int = 0  # > 0: distill the first teacher's k-best CRF paths
    teacher_cache: str = "f16"  # f16 | f32 | lazy


class DistillationTrainer(FinetuneTrainer):
    """Fine-tunes a student against its ``teachers`` (taggers over the
    student's tag dictionary); the other arguments are
    :class:`FinetuneTrainer`'s."""

    def __init__(self, *args, teachers: Sequence[SequenceTagger] = (),
                 **kwargs):
        super().__init__(*args, **kwargs)
        if self.mesh is not None:
            raise NotImplementedError(
                "distillation on a mesh: the teacher caches are per-batch "
                "host arrays that need the batch's mesh padding (ROADMAP A)")
        self.teachers = list(teachers)

    # -- the teachers' outputs --------------------------------------------------

    def _owners(self, eb: EncodedBatch) -> np.ndarray:
        """Each sentence's teacher index."""
        return np.clip(eb.lang_ids, 0, len(self.teachers) - 1)

    @torch.no_grad()
    def _batch_emissions(self, eb: EncodedBatch,
                         arrays: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
        """One batch's teacher emissions on the device, each sentence's
        from its own teacher (every teacher already on the device);
        ``arrays`` are the batch's on the device, if made already."""
        arrays = self._to_device(eb) if arrays is None else arrays
        owner = torch.from_numpy(self._owners(eb)).to(self.device)
        out = None
        for t_idx, teacher in enumerate(self.teachers):
            rows = (owner == t_idx)[:, None, None]
            if bool(rows.any()):
                out = torch.where(rows, teacher.emissions(arrays),
                                  0.0 if out is None else out)
        return out

    @torch.no_grad()
    def _teacher_emissions(self, batches: List[EncodedBatch],
                           dtype=np.float16) -> List[np.ndarray]:
        """Each batch's teacher emissions on the host at ``dtype``, every
        sentence's from its own teacher. The teachers run one at a time
        over all batches on the trainer's device, each back on the CPU
        after its pass. The cache holds ``sentences * W * K * itemsize``
        bytes."""
        out: List[Optional[np.ndarray]] = [None] * len(batches)
        for t_idx, teacher in enumerate(self.teachers):
            teacher.to(self.device)
            for b_idx, eb in enumerate(batches):
                rows = self._owners(eb) == t_idx
                if not rows.any():
                    continue
                logits = teacher.emissions(self._to_device(eb)).cpu(
                ).numpy().astype(dtype)
                if out[b_idx] is None:
                    out[b_idx] = np.zeros_like(logits)
                out[b_idx][rows] = logits[rows]
            teacher.to("cpu")
        log.info("cached teacher emissions for %d batches (%s)",
                 len(batches), np.dtype(dtype).name)
        return out

    @torch.no_grad()
    def _teacher_kbest(self, batches: List[EncodedBatch], n_best: int
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """Each batch's ``teachers[0]`` k-best paths ``[B, N, W]`` and
        their softmax-normalised scores ``[B, N]``, on the host."""
        teacher = self.teachers[0].to(self.device)
        cfg = teacher.config
        trans = teacher.transition_matrix()
        out = []
        for eb in batches:
            arrays = self._to_device(eb)
            paths, scores = crf_decode_nbest(
                teacher.emissions(arrays), arrays["crf_mask"], trans,
                cfg.start_idx, cfg.stop_idx, n_best=n_best)
            out.append((paths.cpu().numpy(),
                        torch.softmax(scores, -1).cpu().numpy()))
        teacher.to("cpu")
        log.info("cached teacher %d-best sequences for %d batches", n_best,
                 len(batches))
        return out

    # -- training -------------------------------------------------------------

    def _targets(self, config: DistillConfig, eb: EncodedBatch, arrays,
                 cached):
        """A batch's distillation targets on the device, from its entry
        of ``cached`` (None: the teachers emit now)."""
        if config.kbest and config.kbest > 0:
            paths, weights = cached
            return (torch.from_numpy(paths).to(self.device),
                    torch.from_numpy(weights).to(self.device))
        if cached is None:
            return self._batch_emissions(eb, arrays)
        return torch.from_numpy(cached).to(self.device).float()

    def _kd_loss(self, arrays, targets, config: DistillConfig,
                 rng: Optional[torch.Generator]) -> torch.Tensor:
        if config.kbest and config.kbest > 0:
            paths, weights = targets
            return self.model.kbest_distill_loss(
                arrays, paths, weights, rng=rng,
                interpolation=config.interpolation)
        return self.model.distill_loss(
            arrays, targets, rng=rng, interpolation=config.interpolation,
            temperature=config.temperature, posterior=config.posterior)

    def kd_step(self, eb: EncodedBatch, cached, opt, config: DistillConfig,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        """Loss, gradients and one optimizer call on batch ``eb`` against
        its entry of the teachers' cache (None: the teachers emit now).
        Returns the loss, still on the device."""
        arrays = self._to_device(eb)
        loss = self._kd_loss(arrays, self._targets(config, eb, arrays,
                                                   cached), config, rng)
        loss.backward()
        opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss.detach()

    def train(self, base_path: str | Path, config: DistillConfig
              ) -> Dict[str, Any]:
        base_path = Path(base_path)
        base_path.mkdir(parents=True, exist_ok=True)
        self.tag_dict.save(base_path / "tag_dictionary.json")
        self._apply_corpus_surgery(config)
        batches = make_batches(
            self.corpus.train, self.tokenizer, self.tag_dict,
            config.batch_size, shuffle=False, tag_layer=self.tag_layer,
            max_subtokens=config.max_subtokens)
        if config.teacher_cache not in TEACHER_CACHES:
            raise ValueError(f"teacher_cache must be f16|f32|lazy, "
                             f"got {config.teacher_cache!r}")
        use_kbest = bool(config.kbest and config.kbest > 0)
        if use_kbest:
            cached = self._teacher_kbest(batches, config.kbest)
        elif config.teacher_cache == "lazy":
            cached = None
            for teacher in self.teachers:
                teacher.to(self.device)
        else:
            cached = self._teacher_emissions(
                batches, dtype=np.float32 if config.teacher_cache == "f32"
                else np.float16)

        total_steps = max(1, len(batches)) * config.max_epochs
        opt = make_finetune_optimizer(
            self.model.named_parameters(), lr=config.learning_rate,
            lr_rate=config.lr_rate,
            warmup_steps=int(total_steps * config.warmup_fraction),
            total_steps=total_steps, weight_decay=config.weight_decay,
            grad_clip=config.grad_clip,
            accumulation_steps=config.accumulation_steps,
            use_inverse_sqrt=config.use_inverse_sqrt)
        rng = torch.Generator().manual_seed(config.seed)
        rng_order = np.random.RandomState(config.seed)
        best_score = -np.inf
        history: Dict[str, List[float]] = {"train_loss": [], "dev_score": []}
        for epoch in range(config.max_epochs):
            t0 = time.time()
            losses = []
            for b_idx in rng_order.permutation(len(batches)):
                losses.append(self.kd_step(
                    batches[b_idx], None if cached is None else cached[b_idx],
                    opt, config, rng))
            # one host pull per epoch
            train_loss = (float(np.mean(torch.stack(losses).cpu().numpy(
            ).astype(np.float64))) if losses else 0.0)
            history["train_loss"].append(train_loss)
            dev_scores = [
                self.evaluate(dev, config.eval_batch_size)[0]
                .micro_avg_f_score()
                for dev in self.corpus.dev_list if dev]
            dev_score = (float(np.mean(dev_scores)) if dev_scores
                         else -train_loss)
            history["dev_score"].append(dev_score)
            log.info("KD epoch %d  loss %.4f  dev %.4f  (%.1fs)", epoch + 1,
                     train_loss, dev_score, time.time() - t0)
            if dev_score >= best_score:
                best_score = dev_score
                self.save(base_path / "best-model.msgpack")
        self.save(base_path / "final-model.msgpack")
        return {"best_dev_score": best_score, "history": history}
