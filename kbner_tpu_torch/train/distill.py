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
  - On a mesh (:class:`FinetuneTrainer`'s; the student sharded on it by
    ``parallel.shard_params``) each step runs as ``train_step`` does:
    the batch padded to a multiple of ``data`` and cut to this rank's
    rows, dropout masks drawn over the global batch, token means over the
    global count, the gradients averaged over ``data``, the clipping norm
    the whole model's. Each rank's teachers emit for its own rows only,
    which is what it caches; a padding row gets zero logits, a zero
    k-best path and zero path weights, so it adds nothing to any term.
    A teacher is a whole copy on every rank, or sharded by
    ``shard_params`` on the same mesh: its forward is then a collective,
    so whether it runs on a batch is decided on the global batch's
    sentences. Rank 0 writes the files.
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
    student's tag dictionary; on a mesh, whole or sharded on that mesh);
    the other arguments are :class:`FinetuneTrainer`'s."""

    def __init__(self, *args, teachers: Sequence[SequenceTagger] = (),
                 **kwargs):
        super().__init__(*args, **kwargs)
        for teacher in teachers:
            sh = getattr(teacher, "sharding", None)
            if sh is not None and sh.mesh is not self.mesh:
                raise ValueError("a sharded teacher must be sharded by "
                                 "parallel.shard_params on the trainer's "
                                 "mesh")
        self.teachers = list(teachers)

    # -- the teachers' outputs --------------------------------------------------

    def _owners(self, eb: EncodedBatch, local: bool = True) -> np.ndarray:
        """Each sentence's teacher index; with ``local``, of this rank's
        rows, -1 on a padding row."""
        owner = np.clip(eb.lang_ids, 0, len(self.teachers) - 1)
        if not local:
            return owner
        return self._host_rows({"owner": owner + 1})["owner"] - 1

    def _emits(self, t_idx: int, eb: EncodedBatch, owners: np.ndarray
               ) -> bool:
        """Whether teacher ``t_idx`` runs on batch ``eb``: it owns one of
        this rank's rows (``owners``), or for a sharded teacher, whose
        forward is a collective, one sentence of the global batch."""
        if getattr(self.teachers[t_idx], "sharding", None) is not None:
            owners = self._owners(eb, local=False)
        return bool((owners == t_idx).any())

    @torch.no_grad()
    def _batch_emissions(self, eb: EncodedBatch,
                         arrays: Optional[Dict[str, torch.Tensor]] = None
                         ) -> torch.Tensor:
        """This rank's rows of one batch's teacher emissions on the device,
        each sentence's from its own teacher (every teacher already on the
        device); ``arrays`` are those rows on the device, if made
        already."""
        if arrays is None:
            arrays = self._to_device(eb, shard_rows=True)
        owners = self._owners(eb)
        owner = torch.from_numpy(owners).to(self.device)[:, None, None]
        out = torch.zeros(arrays["word_mask"].shape
                          + (self.model.config.num_tags,), device=self.device)
        for t_idx, teacher in enumerate(self.teachers):
            if self._emits(t_idx, eb, owners):
                out = torch.where(owner == t_idx, teacher.emissions(arrays),
                                  out)
        return out

    @torch.no_grad()
    def _teacher_emissions(self, batches: List[EncodedBatch],
                           dtype=np.float16) -> List[np.ndarray]:
        """This rank's rows of each batch's teacher emissions on the host
        at ``dtype``, every sentence's from its own teacher. The teachers
        run one at a time over all batches on the trainer's device, each
        back on the CPU after its pass. The cache holds ``rows * W * K *
        itemsize`` bytes."""
        owners = [self._owners(eb) for eb in batches]
        out = [np.zeros((len(o), eb.word_mask.shape[1],
                         self.model.config.num_tags), dtype)
               for o, eb in zip(owners, batches)]
        for t_idx, teacher in enumerate(self.teachers):
            teacher.to(self.device)
            for eb, own, cache in zip(batches, owners, out):
                if not self._emits(t_idx, eb, own):
                    continue
                rows = own == t_idx
                logits = teacher.emissions(self._to_device(
                    eb, shard_rows=True)).cpu().numpy().astype(dtype)
                cache[rows] = logits[rows]
            teacher.to("cpu")
        log.info("cached teacher emissions for %d batches (%s)",
                 len(batches), np.dtype(dtype).name)
        return out

    @torch.no_grad()
    def _teacher_kbest(self, batches: List[EncodedBatch], n_best: int
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
        """This rank's rows of each batch's ``teachers[0]`` k-best paths
        ``[B, N, W]`` and their softmax-normalised scores ``[B, N]``, on
        the host; zero on a padding row."""
        teacher = self.teachers[0].to(self.device)
        cfg = teacher.config
        trans = teacher.transition_matrix()
        out = []
        for eb in batches:
            arrays = self._to_device(eb, shard_rows=True)
            paths, scores = crf_decode_nbest(
                teacher.emissions(arrays), arrays["crf_mask"], trans,
                cfg.start_idx, cfg.stop_idx, n_best=n_best)
            real = torch.from_numpy(self._owners(eb) >= 0).to(
                self.device)[:, None]
            out.append((torch.where(real[..., None], paths, 0).cpu().numpy(),
                        torch.where(real, torch.softmax(scores, -1),
                                    0.0).cpu().numpy()))
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
                 rng: Optional[torch.Generator],
                 token_norm: Optional[float] = None) -> torch.Tensor:
        if config.kbest and config.kbest > 0:
            paths, weights = targets
            return self.model.kbest_distill_loss(
                arrays, paths, weights, rng=rng,
                interpolation=config.interpolation, token_norm=token_norm)
        return self.model.distill_loss(
            arrays, targets, rng=rng, interpolation=config.interpolation,
            temperature=config.temperature, posterior=config.posterior,
            token_norm=token_norm)

    def kd_step(self, eb: EncodedBatch, cached, opt, config: DistillConfig,
                rng: Optional[torch.Generator]) -> torch.Tensor:
        """Loss, gradients and one optimizer call on batch ``eb`` against
        its entry of the teachers' cache (None: the teachers emit now),
        on a mesh as :meth:`train_step`. Returns the (global) batch's
        loss, still on the device."""
        def loss_fn():
            arrays = self._to_device(eb, shard_rows=True)
            return self._kd_loss(
                arrays, self._targets(config, eb, arrays, cached), config,
                rng, self._token_norm(eb))

        return self._step(loss_fn, opt)

    def train(self, base_path: str | Path, config: DistillConfig
              ) -> Dict[str, Any]:
        base_path = Path(base_path)
        if self.writer:
            base_path.mkdir(parents=True, exist_ok=True)
            self.tag_dict.save(base_path / "tag_dictionary.json")
        self._barrier()
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
            use_inverse_sqrt=config.use_inverse_sqrt, **self._norm_options())
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
