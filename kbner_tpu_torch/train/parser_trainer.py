"""The parser and classifier families' trainers (counterpart of
``kbner_tpu/train/parser_trainer.py``): ``targets: dependency``
(:class:`ParserTrainer`, UAS/LAS), ``enhancedud`` (:class:`SemDepTrainer`,
unlabeled and labeled arc F1), ``ner_dp`` (:class:`BiaffineNERTrainer`,
span micro-F1), ``classification`` (:class:`ClassificationTrainer`,
accuracy or micro-F1) and ``regression`` (:class:`RegressionTrainer`,
negated MSE), over one loop:

  - the train split is encoded once (``n_buckets`` k-means length
    buckets, records kept), and each epoch permutes those batches with
    one ``np.random.RandomState(seed)``;
  - the optimizer is :func:`.optim.make_finetune_optimizer`'s two groups
    (encoder at ``lr``, the rest at ``lr * lr_rate``), its horizon
    ``max_epochs * (len(train) // batch_size)`` steps and a warmup of
    ``warmup_fraction`` of it (at least one step);
  - after each epoch the dev splits are scored, a run without dev selects
    on the negated train loss, and a later epoch wins a tie; the best and
    final models go to ``best-model.msgpack``/``final-model.msgpack`` in
    the Flax tree layout the JAX package's trainer writes, the epochs to
    ``history.json``.

The model keeps float32 master parameters and computes in its encoder's
dtype (bfloat16 on the card for XLM-R base and large); dropout masks come
from one host ``torch.Generator`` seeded with ``TrainConfig.seed``.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np
import torch

from .. import weights
from ..data.conll import SentenceRecord
from ..data.dictionary import Dictionary
from ..data.encode import EncodedBatch, make_batches
from ..device import resolve_device
from ..models.biaffine import (encode_dependency_arrays, encode_semdep_arrays,
                               encode_span_labels, mst_decode,
                               single_root_eisner)
from ..models.classifier import encode_labels
from .optim import make_finetune_optimizer
from .trainer import TrainConfig

log = logging.getLogger("kbner_tpu_torch")


def build_rel_dictionary(records: Sequence[SentenceRecord],
                         rel_layer: str = "deprel") -> Dictionary:
    d = Dictionary()
    for r in records:
        for rel in r.tags.get(rel_layer, []):
            d.add_item(rel)
    return d


def build_semdep_rel_dictionary(records: Sequence[SentenceRecord],
                                layer: str = "deps") -> Dictionary:
    """Relation labels of enhanced-UD ``head:rel|head:rel`` cells, with
    ``<unk>`` at index 0 (the relation of a cell without an arc)."""
    d = Dictionary()
    d.add_item("<unk>")
    for r in records:
        for cell in r.tags.get(layer, []):
            for item in cell.split("|"):
                if ":" in item:
                    d.add_item(item.split(":", 1)[1])
    return d


def _f1(tp: int, n_pred: int, n_gold: int):
    p = tp / max(n_pred, 1)
    r = tp / max(n_gold, 1)
    return 2 * p * r / max(p + r, 1e-12), p, r


class _TaskTrainer:
    """The shared encode, train and checkpoint loop; a subclass attaches
    its gold arrays (``_attach_arrays``) and scores (``evaluate``, higher
    is better under ``score_key``)."""

    score_key = "score"

    def __init__(self, model, corpus, tokenizer, n_buckets: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.corpus = corpus
        self.tokenizer = tokenizer
        self.n_buckets = n_buckets

    # -- task hooks -----------------------------------------------------------

    def _attach_arrays(self, eb: EncodedBatch) -> None:
        raise NotImplementedError

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32) -> Dict[str, float]:
        raise NotImplementedError

    # -- batches --------------------------------------------------------------

    def _encode(self, records, batch_size: int, seed: int = 0
                ) -> List[EncodedBatch]:
        batches = make_batches(records, self.tokenizer, None, batch_size,
                               seed=seed, n_buckets=self.n_buckets,
                               keep_records=True)
        for eb in batches:
            self._attach_arrays(eb)
        return batches

    def _to_device(self, eb: EncodedBatch) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in eb.arrays().items()}

    # -- training -------------------------------------------------------------

    def make_optimizer(self, config: TrainConfig, n_records: int):
        n_batches = max(1, n_records // max(config.batch_size, 1))
        total_steps = max(config.max_epochs * n_batches, 1)
        return make_finetune_optimizer(
            self.model.named_parameters(), lr=config.learning_rate,
            lr_rate=config.lr_rate,
            warmup_steps=max(int(config.warmup_fraction * total_steps), 1),
            total_steps=total_steps, weight_decay=config.weight_decay,
            grad_clip=config.grad_clip,
            accumulation_steps=config.accumulation_steps)

    def train_step(self, eb: EncodedBatch, opt, rng) -> torch.Tensor:
        """Loss, gradients and one optimizer call on one batch; returns
        the loss, still on the device."""
        loss = self.model.loss(self._to_device(eb), rng=rng)
        loss.backward()
        opt.step()
        self.model.zero_grad(set_to_none=True)
        return loss.detach()

    def train(self, base_path: str | Path, config: TrainConfig
              ) -> Dict[str, float]:
        base_path = Path(base_path)
        base_path.mkdir(parents=True, exist_ok=True)
        train_records = list(self.corpus.train)
        opt = self.make_optimizer(config, len(train_records))
        rng = torch.Generator().manual_seed(config.seed)
        key = self.score_key
        best = {key: -float("inf"), "epoch": 0}
        history = []
        dev = [r for split in self.corpus.dev_list for r in split]
        all_batches = self._encode(train_records, config.batch_size,
                                   seed=config.seed)
        order_rng = np.random.RandomState(config.seed)
        for epoch in range(1, config.max_epochs + 1):
            t0 = time.time()
            losses = [self.train_step(all_batches[i], opt, rng)
                      for i in order_rng.permutation(len(all_batches))]
            # one host pull per epoch
            mean_loss = (float(np.mean(torch.stack(losses).float().cpu()
                                       .numpy().astype(np.float64)))
                         if losses else 0.0)
            scores = (self.evaluate(dev, config.eval_batch_size)
                      if dev else {key: -mean_loss})
            history.append({"epoch": epoch, "loss": mean_loss, **scores})
            log.info("epoch %d: loss %.4f dev %s %.4f (%.1fs)", epoch,
                     mean_loss, key, scores[key], time.time() - t0)
            if scores[key] >= best[key]:
                best = {**scores, "epoch": epoch}
                self.save(base_path / "best-model.msgpack")
        self.save(base_path / "final-model.msgpack")
        (base_path / "history.json").write_text(json.dumps(history))
        out = {f"best_dev_{k}": v for k, v in best.items() if k != "epoch"}
        out["best_epoch"] = best["epoch"]
        return out

    # -- persistence ----------------------------------------------------------

    def save(self, path: str | Path) -> None:
        weights.save_params(self.model.state_dict(), self.model, path)

    def load(self, path: str | Path) -> None:
        self.model.load_state_dict(weights.load_params(path, self.model))


class ParserTrainer(_TaskTrainer):
    """Tree parsing (``targets: dependency``): CoNLL-U columns 6 and 7,
    selection on UAS; heads from the model's decode, repaired on the host
    with :func:`mst_decode` where they are not a single-root tree
    (``mst_repairs`` counts those sentences), and where that repair is
    not one either, replaced by :func:`single_root_eisner`'s tree
    (``tree_repairs``; the reference leaves such a sentence as its MST
    returns it, ROADMAP C)."""

    score_key = "uas"

    def __init__(self, model, corpus, tokenizer, rel_dict: Dictionary,
                 n_buckets: int = 0, mst_repair: bool = True, device="cuda"):
        super().__init__(model, corpus, tokenizer, n_buckets, device)
        self.rel_dict = rel_dict
        self.mst_repair = mst_repair
        self.mst_repairs = self.tree_repairs = 0

    def _attach_arrays(self, eb) -> None:
        encode_dependency_arrays(eb, rel_dict=self.rel_dict)

    def predict(self, eb) -> tuple:
        """``(heads, rels)`` numpy ``[B, W]``."""
        heads, rels, s_arc = self.model.decode(self._to_device(eb),
                                               return_scores=True)
        heads, rels = heads.cpu().numpy(), rels.cpu().numpy()
        if self.mst_repair:
            wm = np.asarray(eb.word_mask)
            s_arc_np = None
            for b in range(heads.shape[0]):
                n = int(wm[b].sum())
                if not _has_cycle_or_multiroot(heads[b, :n]):
                    continue
                if s_arc_np is None:
                    s_arc_np = s_arc.float().cpu().numpy()
                heads[b, :n] = mst_decode(s_arc_np[b:b + 1],
                                          wm[b:b + 1])[0, :n]
                self.mst_repairs += 1
                if _has_cycle_or_multiroot(heads[b, :n]):
                    heads[b, :n] = single_root_eisner(
                        s_arc_np[b, :n + 1, :n + 1])[1:]
                    self.tree_repairs += 1
        return heads, rels

    def predict_records(self, records: Sequence[SentenceRecord],
                        batch_size: int = 32) -> List[Dict[str, List[str]]]:
        """Per record ``{"head": [...], "deprel": [...]}`` in the input
        order (CoNLL-U columns 6 and 7); the words past the subtoken
        budget get ROOT and ``dep``."""
        out: Dict[int, Dict[str, List[str]]] = {}
        names = self.rel_dict.idx2item
        for eb in self._encode(records, batch_size):
            heads, rels = self.predict(eb)
            W = heads.shape[1]
            for b, rec in enumerate(eb.records):
                n = min(len(rec.tokens), W)
                pad = len(rec.tokens) - n
                out[id(rec)] = {
                    "head": [str(int(h)) for h in heads[b, :n]] + ["0"] * pad,
                    "deprel": [names[int(r)] if int(r) < len(names)
                               else "dep" for r in rels[b, :n]]
                    + ["dep"] * pad}
        return [out[id(r)] for r in records]

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32) -> Dict[str, float]:
        total = correct_h = correct_hl = 0
        for eb in self._encode(records, batch_size):
            heads, rels = self.predict(eb)
            gold_h = eb.extra["heads"]
            # unannotated heads (-1) are not scored
            wm = (np.asarray(eb.word_mask) > 0) & (gold_h >= 0)
            total += int(wm.sum())
            hit = (heads == gold_h) & wm
            correct_h += int(hit.sum())
            correct_hl += int((hit & (rels == eb.extra["rel_ids"])).sum())
        if total == 0:
            return {"uas": 0.0, "las": 0.0}
        return {"uas": correct_h / total, "las": correct_hl / total}


class SemDepTrainer(_TaskTrainer):
    """Graph parsing (``targets: enhancedud``): enhanced-UD ``head:rel|...``
    cells, selection on labeled arc F1."""

    score_key = "lf1"

    def __init__(self, model, corpus, tokenizer, rel_dict: Dictionary,
                 n_buckets: int = 0, dep_layer: str = "deps", device="cuda"):
        super().__init__(model, corpus, tokenizer, n_buckets, device)
        self.rel_dict = rel_dict
        self.dep_layer = dep_layer

    def _attach_arrays(self, eb) -> None:
        encode_semdep_arrays(eb, layer=self.dep_layer, rel_dict=self.rel_dict)

    def predict(self, eb) -> tuple:
        """``(arcs [B, W, W+1] 0/1, rels [B, W, W+1])`` numpy."""
        arcs, rels = self.model.decode(self._to_device(eb))
        return arcs.cpu().numpy(), rels.cpu().numpy()

    def predict_records(self, records: Sequence[SentenceRecord],
                        batch_size: int = 32) -> List[Dict[str, List[str]]]:
        """Per record ``{"deps": ["h:rel|h:rel", ...]}`` in the input
        order; ``_`` past the subtoken budget."""
        out: Dict[int, Dict[str, List[str]]] = {}
        names = self.rel_dict.idx2item

        def name(r: int) -> str:
            return names[r] if r < len(names) else "dep"

        for eb in self._encode(records, batch_size):
            arcs, rels = self.predict(eb)
            W = arcs.shape[1]
            for b, rec in enumerate(eb.records):
                cells = []
                for w in range(len(rec.tokens)):
                    if w >= W:
                        cells.append("_")
                        continue
                    cells.append("|".join(
                        f"{int(h)}:{name(int(rels[b, w, h]))}"
                        for h in np.nonzero(arcs[b, w])[0]) or "_")
                out[id(rec)] = {"deps": cells}
        return [out[id(r)] for r in records]

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32) -> Dict[str, float]:
        tp_u = tp_l = n_pred = n_gold = 0
        for eb in self._encode(records, batch_size):
            arcs, rels = self.predict(eb)
            gold_a = eb.extra["arc_matrix"] > 0
            pred = arcs > 0
            n_pred += int(pred.sum())
            n_gold += int(gold_a.sum())
            hit = pred & gold_a
            tp_u += int(hit.sum())
            tp_l += int((hit & (rels == eb.extra["rel_matrix"])).sum())
        return {"uf1": _f1(tp_u, n_pred, n_gold)[0],
                "lf1": _f1(tp_l, n_pred, n_gold)[0]}


class BiaffineNERTrainer(_TaskTrainer):
    """Span NER as parsing (``targets: ner_dp``): BIOES gold spans against
    the greedily chosen non-overlapping spans, selection on micro-F1."""

    score_key = "micro_f1"

    def __init__(self, model, corpus, tokenizer, label_dict: Dictionary,
                 n_buckets: int = 0, tag_layer: str = "ner", device="cuda"):
        super().__init__(model, corpus, tokenizer, n_buckets, device)
        self.label_dict = label_dict
        self.tag_layer = tag_layer

    def _attach_arrays(self, eb) -> None:
        encode_span_labels(eb, tag_layer=self.tag_layer,
                           label_dict=self.label_dict)

    def predict(self, eb) -> List[List[tuple]]:
        """Per sentence ``[(start, end_inclusive, label_id, score)]``."""
        return self.model.decode(self._to_device(eb))

    def predict_records(self, records: Sequence[SentenceRecord],
                        batch_size: int = 32) -> List[Dict[str, List[str]]]:
        """Per record ``{"ner": [BIOES tags]}`` from the chosen spans."""
        out: Dict[int, Dict[str, List[str]]] = {}
        names = self.label_dict.idx2item
        for eb in self._encode(records, batch_size):
            for rec, chosen in zip(eb.records, self.predict(eb)):
                tags = ["O"] * len(rec.tokens)
                for (i, j, lab, _s) in chosen:
                    if j >= len(tags):
                        continue
                    name = names[lab] if lab < len(names) else "MISC"
                    if i == j:
                        tags[i] = f"S-{name}"
                    else:
                        tags[i] = f"B-{name}"
                        for p in range(i + 1, j):
                            tags[p] = f"I-{name}"
                        tags[j] = f"E-{name}"
                out[id(rec)] = {"ner": tags}
        return [out[id(r)] for r in records]

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32) -> Dict[str, float]:
        tp = n_pred = n_gold = 0
        for eb in self._encode(records, batch_size):
            gold = eb.extra["span_labels"]
            for b, chosen in enumerate(self.predict(eb)):
                pred = {(i, j, lab) for (i, j, lab, _s) in chosen}
                gi, gj = np.nonzero(gold[b])
                gspans = {(int(i), int(j), int(gold[b, i, j]))
                          for i, j in zip(gi, gj)}
                tp += len(pred & gspans)
                n_pred += len(pred)
                n_gold += len(gspans)
        f1, p, r = _f1(tp, n_pred, n_gold)
        return {"micro_f1": f1, "precision": p, "recall": r}


def _has_cycle_or_multiroot(heads: np.ndarray) -> bool:
    """True if the 1-indexed head assignment is not a single-root tree."""
    n = len(heads)
    if n == 0:
        return False
    if int((heads == 0).sum()) != 1:
        return True
    for d in range(1, n + 1):
        seen = set()
        x = d
        while x != 0:
            if x in seen or x > n:
                return True
            seen.add(x)
            x = int(heads[x - 1])
    return False


class ClassificationTrainer(_TaskTrainer):
    """Document classification (``targets: classification``): selection
    on accuracy (single-label) or micro-F1 (multi-label)."""

    def __init__(self, model, corpus, tokenizer, label_dict: Dictionary,
                 multi_label: bool = False, n_buckets: int = 0,
                 device="cuda"):
        super().__init__(model, corpus, tokenizer, n_buckets, device)
        self.label_dict = label_dict
        self.multi_label = multi_label
        self.score_key = "micro_f1" if multi_label else "accuracy"

    def _attach_arrays(self, eb) -> None:
        encode_labels(eb.records, self.label_dict, eb)

    def predict(self, eb) -> np.ndarray:
        return self.model.predict(self._to_device(eb)).cpu().numpy()

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32) -> Dict[str, float]:
        correct = total = tp = n_pred = n_gold = 0
        for eb in self._encode(records, batch_size):
            pred = self.predict(eb)
            if self.multi_label:
                gold = eb.extra["label_multi"]
                tp += int(((pred > 0) & (gold > 0)).sum())
                n_pred += int((pred > 0).sum())
                n_gold += int((gold > 0).sum())
            else:
                gold = eb.extra["label_ids"]
                correct += int((pred == gold).sum())
                total += len(gold)
        if self.multi_label:
            f1, p, r = _f1(tp, n_pred, n_gold)
            return {"micro_f1": f1, "precision": p, "recall": r}
        return {"accuracy": correct / max(total, 1)}

    def predict_records(self, records: Sequence[SentenceRecord],
                        batch_size: int = 32) -> List[List[str]]:
        """Per record its predicted label names, in the input order."""
        names = self.label_dict.idx2item
        out: Dict[int, List[str]] = {}
        for eb in self._encode(records, batch_size):
            pred = self.predict(eb)
            for b, rec in enumerate(eb.records):
                out[id(rec)] = ([names[i] for i in np.nonzero(pred[b])[0]]
                                if self.multi_label
                                else [names[int(pred[b])]])
        return [out[id(r)] for r in records]


class RegressionTrainer(_TaskTrainer):
    """Document regression (``targets: regression``): numeric labels,
    selection on the negated MSE."""

    score_key = "neg_mse"

    def _attach_arrays(self, eb) -> None:
        """``targets`` float32 [B] from each record's first label (0 for
        none or a non-number)."""
        vals = np.zeros((len(eb.records),), dtype=np.float32)
        for b, rec in enumerate(eb.records):
            try:
                vals[b] = float(rec.labels[0]) if rec.labels else 0.0
            except ValueError:
                vals[b] = 0.0
        eb.extra["targets"] = vals

    def predict(self, eb) -> np.ndarray:
        return self.model.predict(self._to_device(eb)).float().cpu().numpy()

    def evaluate(self, records: Sequence[SentenceRecord],
                 batch_size: int = 32) -> Dict[str, float]:
        se = n = 0.0
        for eb in self._encode(records, batch_size):
            pred = self.predict(eb)
            se += float(((pred - eb.extra["targets"]) ** 2).sum())
            n += len(pred)
        mse = se / max(n, 1.0)
        return {"neg_mse": -mse, "mse": mse}
