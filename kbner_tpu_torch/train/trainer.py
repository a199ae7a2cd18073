"""Fine-tuning trainer (counterpart of ``kbner_tpu/train/trainer.py``).

  - two parameter groups (encoder at ``lr``, head at ``lr * lr_rate``),
    AdamW with warmup, global-norm clipping and gradient accumulation
    (:mod:`.optim`, optax's bookkeeping);
  - the schedule's horizon from the realised epoch size (micro-batches
    per epoch times epochs);
  - first-epoch encoder freezing by multiplying the encoder's gradients
    by 0, so the optimizer's update count and moments run on as optax's;
  - per-epoch dev evaluation, a dataset-level macro average over the
    corpora's dev sets (the negated train loss without dev sets);
  - with ``stride_windows``, sentences over ``stride_max_subtokens``
    train as overlapping word windows (split after resampling, each
    epoch) and are evaluated window by window, stitched back
    (:mod:`..data.windows`);
  - ``best-model.msgpack``/``final-model.msgpack`` (and
    ``finetuned-encoder.msgpack``) in the Flax tree layout the JAX
    package's trainer writes, so either package reads the other's;
  - ``loss.tsv``, ``history.json``, a final save on ``KeyboardInterrupt``;
  - ``checkpoint``/``resume`` through ``checkpoint.msgpack``, the blob the
    JAX package's trainer writes (``{"params", "opt_state", "meta"}``:
    the Flax tree, optax's state tree, and a JSON string of epoch, best
    score and history), so either package resumes the other's run;
  - on a ``(data, model)`` mesh (``parallel.make_mesh``, the model
    sharded on it first with ``parallel.shard_params``): each batch
    padded to a multiple of ``data`` and cut to this rank's rows, the
    gradients averaged over ``data`` (an FSDP leaf's backward already
    did), dropout masks drawn over the global batch (in multi-view mode
    both views' rows, the context view's masks first), the clipping norm
    taken over the whole model; every rank evaluates and predicts (TP and
    FSDP forwards are collectives), and rank 0 alone writes the files, of
    the gathered state, in the single-rank layout.

Randomness comes from ``torch.Generator``s seeded with ``TrainConfig.seed``:
the model's init (the caller's), every dropout mask (one host generator
per ``train`` call) and batch shuffling (numpy ``RandomState(seed +
epoch)``, as the reference shuffles).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import weights
from ..data import corpus_ops
from ..data.conll import X_LABEL, Corpus, ListCorpus, SentenceRecord
from ..data.dictionary import Dictionary
from ..data.encode import (EncodedBatch, add_classic_features, encode_batch,
                           make_batches)
from ..data.subword import SubwordTokenizer
from ..data.windows import predict_long, split_long_record
from ..device import resolve_device
from ..eval.metrics import Metric, evaluate_spans
from ..models.tagger import SequenceTagger
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, batch_rows, local_rows,
                             pad_batch_for_mesh)
from ..parallel.sharding_rules import gather_state_dict, shard_state_dict
from ..serve import predict as predict_tags
from ..utils import spans
from .optim import (FinetuneOptimizer, from_optax_state, is_encoder_param,
                    make_finetune_optimizer, optax_state)

log = logging.getLogger("kbner_tpu_torch")


@dataclasses.dataclass
class TrainConfig:
    learning_rate: float = 5e-6
    lr_rate: float = 10000.0  # head lr multiplier
    batch_size: int = 16
    max_epochs: int = 10
    warmup_fraction: float = 0.1
    accumulation_steps: int = 1
    weight_decay: float = 0.0
    grad_clip: float = 5.0
    use_inverse_sqrt: bool = False
    adam_mu_bf16: bool = False  # Adam's first moment stored in bfloat16
    # the JAX package's dropout PRNG implementation; no torch generator
    # reproduces any of JAX's bit streams, so every value means the
    # trainer's torch.Generator seeded with ``seed``
    rng_impl: Optional[str] = "unsafe_rbg"
    seed: int = 0
    max_subtokens: int = 512
    eval_batch_size: int = 32
    save_finetuned_encoder: bool = False
    monitor_test: bool = False
    # corpus surgery
    resample_smooth: Optional[float] = None
    direct_upsample_rate: Optional[int] = None
    direct_upsample_max_size: Optional[int] = None
    down_sample_amount: Optional[int] = None
    clip_long_sentences: bool = False
    # multi-view cooperative training
    multi_view: bool = False
    mv_agreement_weight: float = 1.0
    mv_l2_weight: float = 0.0
    mv_kind: str = "kl"
    freeze_first_epoch: bool = False
    checkpoint: bool = False
    resume: bool = False
    # a torch.profiler trace of the first epoch's steps [profile_start,
    # profile_start + profile_steps), with the program's spans
    # (utils/spans.py) on, into <target_dir>/profile/trace.json
    profile_steps: int = 0
    profile_start: int = 2


class FinetuneTrainer:
    """Trains ``model`` (a :class:`SequenceTagger` with float32 master
    parameters) on ``corpus`` on ``device`` (the card by default; the
    model is moved there). With ``mesh`` (a ``DeviceMesh`` from
    ``parallel.make_mesh``) every rank of the mesh runs the same trainer
    on the same corpus: training, evaluation and saving are collectives."""

    def __init__(
        self,
        model: SequenceTagger,
        corpus: ListCorpus | Corpus,
        tokenizer: SubwordTokenizer,
        tag_dict: Dictionary,
        mesh=None,
        tag_layer: str = "ner",
        stride_windows: bool = False,
        stride_max_subtokens: int = 510,
        stride_words: int = 16,
        device="cuda",
    ):
        self._init_mesh(mesh, model)
        self.stride_windows = stride_windows
        self.stride_max_subtokens = stride_max_subtokens
        self.stride_words = stride_words
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        if isinstance(corpus, Corpus):
            corpus = ListCorpus([corpus])
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.tag_dict = tag_dict
        self.tag_layer = tag_layer
        # ACE: the embedder-selection mask every batch carries (set per
        # episode by train/reinforce.py), and the classic embedders'
        # vocabularies and ELMo's byte ids (add_classic_features)
        self.selection: Optional[np.ndarray] = None
        self.word_vocab: Optional[Dictionary] = None
        self.char_vocab: Optional[Dictionary] = None
        self.bpe_vocab = None
        self.elmo_bytes = False

    # -- the mesh ---------------------------------------------------------------

    def _init_mesh(self, mesh, model: nn.Module) -> None:
        """The trainer's place on ``mesh`` (None: one process): the
        model's :class:`~..parallel.sharding_rules.Sharding`, which
        ``shard_params`` must have set on this mesh, and whether this
        rank writes the files."""
        self.mesh = mesh
        self.sharding = None
        self.writer = True
        if mesh is None:
            return
        from torch.distributed.device_mesh import DeviceMesh

        if not (isinstance(mesh, DeviceMesh) and set(
                mesh.mesh_dim_names or ()) == {DATA_AXIS, MODEL_AXIS}):
            raise TypeError(f"mesh must be a DeviceMesh with dimensions "
                            f"{(DATA_AXIS, MODEL_AXIS)} (parallel."
                            f"make_mesh), got {type(mesh).__name__}")
        sh = getattr(model, "sharding", None)
        if sh is None or sh.mesh is not mesh:
            raise ValueError("a meshed trainer takes the model that "
                             "parallel.shard_params(model, mesh) sharded "
                             "on this mesh")
        self.sharding = sh
        self.writer = dist.get_rank() == 0

    def _barrier(self) -> None:
        """Every rank waits for rank 0's files."""
        if self.mesh is not None:
            dist.barrier()

    # -- one step ---------------------------------------------------------------

    def _to_device(self, eb: EncodedBatch, shard_rows: bool = False
                   ) -> Dict[str, torch.Tensor]:
        """The batch's arrays on the device, with the classic embedders'
        inputs when the trainer has their vocabularies and the ``[N]``
        selection mask when it has one. With ``shard_rows`` on a mesh the
        batch is padded to a multiple of its data axis and cut to this
        rank's rows (the selection mask stays whole), as the reference's
        ``_to_device`` shards a training batch."""
        if (self.word_vocab is not None or self.char_vocab is not None
                or self.bpe_vocab is not None) and not {
                    "word_ids", "char_ids", "bpe_first_ids"} & set(eb.extra):
            add_classic_features(eb, self.word_vocab, self.char_vocab,
                                 bpe_vocab=self.bpe_vocab,
                                 elmo_bytes=self.elmo_bytes)
        arrays = eb.arrays()
        if shard_rows:
            arrays = self._host_rows(arrays)
        with spans.span("kbner.train.upload") as s:
            out = {k: torch.from_numpy(v).to(self.device)
                   for k, v in arrays.items()}
            if self.selection is not None:
                out["selection"] = torch.as_tensor(
                    np.asarray(self.selection, np.float32),
                    device=self.device)
            if s:
                mask = arrays["attention_mask"]
                s.add("rows", mask.shape[0])
                s.add("subtokens", mask.sum())
                s.add("slots", mask.size)
        return out

    def _host_rows(self, arrays: Dict[str, np.ndarray]
                   ) -> Dict[str, np.ndarray]:
        """On a mesh, host arrays of a batch padded to a multiple of its
        data axis and cut to this rank's rows; else ``arrays``."""
        if self.mesh is None:
            return arrays
        return local_rows(pad_batch_for_mesh(arrays, self.mesh), self.mesh)

    def _loss(self, item, config: TrainConfig,
              rng: Optional[torch.Generator]) -> torch.Tensor:
        if config.multi_view:
            # both views hold the same sentences, so the same rows fall
            # to this rank; the context view's masks are drawn first
            eb, orig = item
            return self.model.multi_view_loss(
                self._to_device(eb, shard_rows=True),
                self._to_device(orig, shard_rows=True), rng=rng,
                agreement_weight=config.mv_agreement_weight,
                l2_weight=config.mv_l2_weight, kind=config.mv_kind,
                token_norm=self._token_norm(eb),
                shared_norm=self._token_norm(orig, "word_mask"))
        return self.model.loss(self._to_device(item, shard_rows=True),
                               rng=rng, token_norm=self._token_norm(item))

    def _data_split(self) -> int:
        """The ranks of the mesh's data axis (1 off a mesh)."""
        return 1 if self.sharding is None else self.sharding.sizes[DATA_AXIS]

    def _token_norm(self, eb: EncodedBatch, mask: str = "crf_mask"
                    ) -> Optional[float]:
        """On a split data axis of ``n`` ranks, a token mean's divisor: the
        global batch's count of ``mask`` over ``n``, so that the ranks'
        mean loss is the global token mean (the padding rows count no
        token); else None, the batch's own count."""
        n = self._data_split()
        if n == 1:
            return None
        return max(float(getattr(eb, mask).sum()), 1.0) / n

    def _data_shard(self):
        """:func:`~..parallel.mesh.batch_rows` of this rank's rows on a
        mesh whose data axis is split, else a no-op context."""
        if self._data_split() == 1:
            return contextlib.nullcontext()
        return batch_rows(self.sharding.coords[DATA_AXIS], self._data_split())

    def train_step(self, item, opt: FinetuneOptimizer, config: TrainConfig,
                   rng: Optional[torch.Generator], freeze: bool = False
                   ) -> torch.Tensor:
        """Loss, gradients and one optimizer call on one batch (an
        ``EncodedBatch``, or a (context, orig) pair in multi-view mode).
        Returns the loss of the (global) batch, still on the device."""
        return self._step(lambda: self._loss(item, config, rng), opt, freeze)

    def _step(self, loss_fn, opt: FinetuneOptimizer, freeze: bool = False
              ) -> torch.Tensor:
        """``loss_fn()`` on this rank's rows and its backward pass, the
        gradients averaged over ``data``, one optimizer call; returns the
        global batch's loss, still on the device."""
        with spans.span("kbner.train.step"):
            with self._data_shard():
                loss = loss_fn()
                with spans.span("kbner.train.backward"):
                    loss.backward()
            if self._data_split() > 1:
                self.sharding.sync_gradients(self.model)
                loss = loss.detach().clone()
                dist.all_reduce(loss, group=self.sharding.groups[DATA_AXIS])
                loss /= self._data_split()
            if freeze:
                grads = [p.grad for n, p in self.model.named_parameters()
                         if is_encoder_param(n) and p.grad is not None]
                torch._foreach_mul_(grads, 0.0)
            with spans.span("kbner.train.optimizer"):
                opt.step()
            self.model.zero_grad(set_to_none=True)
            return loss.detach()

    # -- training ---------------------------------------------------------------

    def _apply_corpus_surgery(self, config: TrainConfig) -> None:
        if config.clip_long_sentences:
            removed = corpus_ops.clip_sentences(
                self.corpus, self.tokenizer, config.max_subtokens - 2)
            if removed:
                log.info("clipped %d over-budget train sentences", removed)
        if config.down_sample_amount:
            corpus_ops.down_sample(self.corpus, config.down_sample_amount,
                                   seed=config.seed)
        if config.direct_upsample_rate:
            corpus_ops.direct_upsample(self.corpus,
                                       config.direct_upsample_rate,
                                       config.direct_upsample_max_size)

    def _epoch_records(self, config: TrainConfig, epoch: int):
        if config.resample_smooth:
            records = corpus_ops.resample_corpora(
                self.corpus, smooth=config.resample_smooth,
                seed=config.seed + epoch)
        else:
            records = self.corpus.train
        if self.stride_windows:
            records = [chunk for rec in records
                       for chunk, _ in split_long_record(
                           rec, self.tokenizer, self.stride_max_subtokens,
                           self.stride_words)]
        return records

    def _make_train_batches(self, records, config: TrainConfig, epoch: int):
        """Encoded batches, shuffled with ``RandomState(seed + epoch)``;
        multi-view mode pairs each with the ``<EOS>``-truncated view of
        the same sentences."""
        batches = make_batches(
            records, self.tokenizer, self.tag_dict, config.batch_size,
            shuffle=True, seed=config.seed + epoch, tag_layer=self.tag_layer,
            max_subtokens=config.max_subtokens)
        if not config.multi_view:
            return batches
        return [(eb, encode_batch(
            [corpus_ops.make_orig_view(r, self.tag_layer) for r in eb.records],
            self.tokenizer, self.tag_dict, tag_layer=self.tag_layer,
            max_subtokens=config.max_subtokens)) for eb in batches]

    def make_optimizer(self, config: TrainConfig) -> FinetuneOptimizer:
        """The optimizer of :meth:`train`, its horizon from the epoch size
        of ``config``'s epoch 0; on a mesh its clipping norm is the whole
        model's."""
        steps_per_epoch = max(1, math.ceil(
            len(self._epoch_records(config, 0)) / config.batch_size))
        total_steps = steps_per_epoch * config.max_epochs
        return make_finetune_optimizer(
            self.model.named_parameters(), lr=config.learning_rate,
            lr_rate=config.lr_rate,
            warmup_steps=int(total_steps * config.warmup_fraction),
            total_steps=total_steps, weight_decay=config.weight_decay,
            grad_clip=config.grad_clip,
            accumulation_steps=config.accumulation_steps,
            use_inverse_sqrt=config.use_inverse_sqrt,
            mu_dtype=torch.bfloat16 if config.adam_mu_bf16 else None,
            **self._norm_options())

    def _norm_options(self) -> Dict[str, Any]:
        """On a mesh, the optimizer's options that take its clipping norm
        over the whole model (each slice weighted by one over its
        replicas, summed over the world); else none."""
        if self.sharding is None:
            return {}
        return dict(norm_weights={n: 1.0 / self.sharding.replicas(n)
                                  for n, _ in self.model.named_parameters()},
                    norm_group=dist.group.WORLD)

    def train(self, base_path: str | Path, config: TrainConfig
              ) -> Dict[str, Any]:
        base_path = Path(base_path)
        if self.writer:
            base_path.mkdir(parents=True, exist_ok=True)
            self.tag_dict.save(base_path / "tag_dictionary.json")
        self._barrier()
        self._apply_corpus_surgery(config)
        opt = self.make_optimizer(config)
        rng = torch.Generator().manual_seed(config.seed)
        best_score = -np.inf
        history: Dict[str, List[float]] = {"train_loss": [], "dev_score": []}

        start_epoch = 0
        ckpt_path = base_path / "checkpoint.msgpack"
        if config.resume and ckpt_path.exists():
            meta = self._load_checkpoint(ckpt_path, opt)
            start_epoch = meta["epoch"] + 1
            best_score, history = meta["best_score"], meta["history"]
            log.info("resumed from checkpoint at epoch %d", start_epoch)

        loss_tsv = base_path / "loss.tsv"
        if start_epoch == 0 and self.writer:
            loss_tsv.write_text("EPOCH\tTIMESTAMP\tTRAIN_LOSS\tDEV_SCORE\n")

        try:
            for epoch in range(start_epoch, config.max_epochs):
                t0 = time.time()
                batches = self._make_train_batches(
                    self._epoch_records(config, epoch), config, epoch)
                freeze = config.freeze_first_epoch and epoch == 0
                losses = []
                prof = None
                for i, item in enumerate(batches):
                    if (config.profile_steps and epoch == start_epoch
                            and i == config.profile_start and self.writer):
                        prof = self._start_profile()
                    losses.append(self.train_step(item, opt, config, rng,
                                                  freeze))
                    if prof is not None and i + 1 == (
                            config.profile_start + config.profile_steps):
                        self._stop_profile(prof, base_path)
                        prof = None
                if prof is not None:  # epoch shorter than the window
                    self._stop_profile(prof, base_path)
                # one host pull per epoch
                train_loss = (float(np.mean(torch.stack(losses).cpu().numpy(
                ).astype(np.float64))) if losses else 0.0)
                history["train_loss"].append(train_loss)

                dev_scores = [
                    self.evaluate(dev, config.eval_batch_size)[0]
                    .micro_avg_f_score()
                    for dev in self.corpus.dev_list if dev]
                # without dev sets, select on the negated train loss
                dev_score = (float(np.mean(dev_scores)) if dev_scores
                             else -train_loss)
                history["dev_score"].append(dev_score)
                log.info("epoch %d  loss %.4f  dev %.4f  (%.1fs)",
                         epoch + 1, train_loss, dev_score, time.time() - t0)
                if self.writer:
                    with open(loss_tsv, "a") as f:
                        f.write(f"{epoch + 1}\t{time.strftime('%H:%M:%S')}"
                                f"\t{train_loss:.6f}\t{dev_score:.6f}\n")
                if dev_score >= best_score:
                    best_score = dev_score
                    self.save(base_path / "best-model.msgpack")
                    if config.save_finetuned_encoder:
                        self.save_encoder(
                            base_path / "finetuned-encoder.msgpack")
                if config.checkpoint:
                    self._save_checkpoint(ckpt_path, opt, epoch, best_score,
                                          history)
        except KeyboardInterrupt:
            log.info("interrupted — saving final-model")
            self.save(base_path / "final-model.msgpack")
            raise

        self.save(base_path / "final-model.msgpack")
        if self.writer:
            (base_path / "history.json").write_text(json.dumps(history))
        self._barrier()
        return {"best_dev_score": best_score, "history": history}

    def _start_profile(self) -> torch.profiler.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        # the program's spans lie on the trace beside the kernels
        self._own_spans = spans.enable()
        prof.start()
        return prof

    def _stop_profile(self, prof, base_path: Path) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        if self._own_spans:
            spans.disable()
            spans.collect()
        out = base_path / "profile"
        out.mkdir(exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        log.info("wrote profiler trace to %s", out)

    # -- checkpoint/resume --------------------------------------------------------

    def _save_checkpoint(self, path, opt: FinetuneOptimizer, epoch: int,
                         best_score: float, history) -> None:
        """``checkpoint.msgpack`` as the JAX package's trainer writes it:
        the Flax tree, optax's state tree (:func:`.optim.optax_state`)
        and the meta JSON string, of the gathered state on a mesh."""
        params = gather_state_dict(self.model)
        moments = opt.named_moments()
        if self.sharding is not None:
            moments = {key: {n: self.sharding.gather(n, t)
                             for n, t in named.items()}
                       for key, named in moments.items()}
        if self.writer:
            weights.checkpoint.dump({
                "params": weights.to_jax_params(params, self.model),
                "opt_state": optax_state(opt, moments, self.model),
                "meta": json.dumps({"epoch": epoch, "best_score": best_score,
                                    "history": history})}, path)
        self._barrier()

    def _load_checkpoint(self, path, opt: FinetuneOptimizer
                         ) -> Dict[str, Any]:
        """Resume the model and ``opt`` from either package's
        ``checkpoint.msgpack`` (each rank its slices); returns the meta."""
        blob = weights.checkpoint.load(path)
        self.model.load_state_dict(shard_state_dict(
            self.model, weights.from_jax_params(blob["params"], self.model)))
        opt.count, opt.mini_step, moments = from_optax_state(
            blob["opt_state"], opt, self.model)
        if self.sharding is not None:
            moments = {key: {n: self.sharding.local(n, t)
                             for n, t in named.items()}
                       for key, named in moments.items()}
        opt.load_named_moments(moments)
        return json.loads(blob["meta"])

    # -- evaluation -----------------------------------------------------------------

    def predict(self, records: Sequence[SentenceRecord], batch_size: int = 32,
                sort_by_length: bool = True) -> List[List[str]]:
        """Predicted BIOES tag strings per sentence, in input order;
        context positions get ``S-X`` and words past the subtoken budget
        ``O``."""
        return predict_tags(records, self.model, self.tokenizer,
                            self.tag_dict, batch_size=batch_size,
                            tag_layer=self.tag_layer,
                            sort_by_length=sort_by_length,
                            to_device=self._to_device)

    @torch.no_grad()
    def embed_texts(self, texts: Sequence[str], batch_size: int = 64
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Word-level encoder features of whitespace-tokenized texts, in
        input order, on the trainer's device: ``(emb [B, W, H] float32,
        mask [B, W] int32)``, zero past each text's words. The embeddings
        of BERTScore reranking (``retrieval/rerank.py``)."""
        if not texts:
            return (torch.zeros((0, 0, 0), device=self.device),
                    torch.zeros((0, 0), dtype=torch.int32,
                                device=self.device))
        recs = [SentenceRecord(tokens=t.split() or ["."]) for t in texts]
        for r in recs:
            r.tags[self.tag_layer] = ["O"] * len(r.tokens)
        rec_index = {id(r): i for i, r in enumerate(recs)}
        batches = make_batches(recs, self.tokenizer, None, batch_size,
                               sort_by_length=True, tag_layer=self.tag_layer)
        # each batch's rows go straight into the output, so only one
        # batch's features are alive beside it
        W = max(int(eb.word_mask.sum(1).max()) for eb in batches)
        H = self.model.config.encoder.hidden_size
        emb = torch.zeros((len(recs), W, H), device=self.device)
        mask = torch.zeros((len(recs), W), dtype=torch.int32,
                           device=self.device)
        for eb in batches:
            arrays = self._to_device(eb)
            feats = self.model._extract_features(arrays).float()
            for b, rec in enumerate(eb.records):
                i, n = rec_index[id(rec)], int(eb.word_mask[b].sum())
                emb[i, :n] = feats[b, :n]
                mask[i, :n] = arrays["word_mask"][b, :n]
            del arrays, feats
        return emb, mask

    def evaluate_speed(self, records: Sequence[SentenceRecord],
                       batch_size: int = 32) -> float:
        """Decode throughput in sentences/s, after one warm-up batch."""
        self.predict(records[:min(len(records), batch_size)], batch_size)
        t0 = time.time()
        self.predict(records, batch_size)
        return len(records) / max(time.time() - t0, 1e-9)

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32, out_path: Optional[Path] = None
                 ) -> Tuple[Metric, List[List[str]]]:
        """Span metric of the predictions (stitched from windows with
        ``stride_windows``) against the gold tags (X, _ and NE spans
        ignored); with ``out_path``, 'token gold pred' lines."""
        if self.stride_windows:
            preds = predict_long(
                self, records, max_subtokens=self.stride_max_subtokens,
                stride_words=self.stride_words, batch_size=batch_size)
        else:
            preds = self.predict(records, batch_size)
        gold = [r.tags[self.tag_layer] for r in records]
        metric = evaluate_spans(gold, preds,
                                ignore_labels=(X_LABEL, "_", "NE"))
        if out_path is not None:
            with open(out_path, "w", encoding="utf-8") as f:
                for rec, pred in zip(records, preds):
                    for tok, g, p in zip(rec.tokens,
                                         rec.tags[self.tag_layer], pred):
                        f.write(f"{tok} {g} {p}\n")
                    f.write("\n")
        return metric, preds

    def final_test(self, base_path: str | Path, batch_size: int = 32):
        """Reload the best model and evaluate each test set; writes
        ``test.<name>.tsv`` and ``test_results.json``."""
        base_path = Path(base_path)
        best = base_path / "best-model.msgpack"
        if best.exists():
            self.load(best)
        results = {}
        for name, test_set in zip(self.corpus.targets, self.corpus.test_list):
            if not test_set:
                continue
            metric, _ = self.evaluate(
                test_set, batch_size, out_path=base_path / f"test.{name}.tsv"
                if self.writer else None)
            results[name] = {"micro_f1": metric.micro_avg_f_score(),
                             "macro_f1": metric.macro_avg_f_score()}
            log.info("TEST %s: %s", name, results[name])
        if self.writer:
            (base_path / "test_results.json").write_text(json.dumps(results))
        self._barrier()
        return results

    # -- persistence ----------------------------------------------------------------

    def save(self, path: str | Path) -> None:
        """The Flax tree of the (gathered) parameters; on a mesh rank 0
        writes it and every rank waits."""
        state = gather_state_dict(self.model)
        if self.writer:
            weights.save_params(state, self.model, path)
        self._barrier()

    def load(self, path: str | Path) -> None:
        self.model.load_state_dict(shard_state_dict(
            self.model, weights.load_params(path, self.model)))

    def save_encoder(self, path: str | Path) -> None:
        """Only the tuned encoder's tree (``params.encoder``; a stacked
        tagger has none there, as in the reference)."""
        tree = weights.to_jax_params(gather_state_dict(self.model), self.model)
        if self.writer:
            weights.checkpoint.dump(tree["params"]["encoder"], path)
        self._barrier()

    def load_encoder(self, path: str | Path) -> None:
        tree = weights.to_jax_params(gather_state_dict(self.model), self.model)
        if "encoder" not in tree["params"]:
            raise KeyError("params.encoder: the tagger's tree has none (a "
                           "stacked tagger keeps XLM-R under "
                           "stack/members_<i>/encoder)")
        tree["params"]["encoder"] = weights.checkpoint.load(path)
        self.model.load_state_dict(shard_state_dict(
            self.model, weights.from_jax_params(tree, self.model)))
