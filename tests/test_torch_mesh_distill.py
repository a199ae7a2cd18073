"""The PyTorch port's distillation and multi-view training on a mesh
against kbner_tpu's: spawned gloo worlds on the CPU, one per layout (data
parallelism over 2 ranks, tensor parallelism over 2, and (data=2,
model=2) with FSDP over 4), each run by ``tests/torch_world.py``'s
``mesh_distill_rank`` while the JAX reference computes here.

The batches are ner_toy's train sentences, each fused with ``<EOS>`` and
a context (``torch_world.with_contexts``), so the two views of
multi-view training differ. Tolerances are
tests/test_torch_mesh_train.py's:

  - one sharded step (logit, posterior and k-best distillation; multi-view
    with the CRF and the softmax head) on 7 sentences, padded to the data
    axis with zero targets, against ``jax.grad`` of the reference's own
    loss on that padded batch: loss rel 1e-4, gradients rtol 2e-3, atol
    1e-5;
  - one-epoch runs with dropout off against the JAX trainers on meshes of
    the same data axis (the JAX meshed distillation trainer at batch 4,
    the batch it can run), and padded runs at batch 3 with every dropout
    on against the port's single-process trainer on the same padded
    batches: rtol 1e-4, atol 1e-6, the attention's key bias held within
    its steps' reach of its start (its exact gradient is 0).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kbner_tpu.data import HashTokenizer as JTokenizer
from kbner_tpu.data import encode_batch as j_encode
from kbner_tpu.data import load_column_corpus as j_load
from kbner_tpu.data.conll import Corpus as JCorpus
from kbner_tpu.data.conll import ListCorpus as JListCorpus
from kbner_tpu.data.conll import SentenceRecord as JRecord
from kbner_tpu.data.corpus_ops import make_orig_view as j_orig_view
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.parallel import make_mesh as j_make_mesh
from kbner_tpu.train import FinetuneTrainer as JTrainer
from kbner_tpu.train import TrainConfig as JTrainConfig
from kbner_tpu.train.distill import DistillationTrainer as JDistillTrainer
from kbner_tpu.train.distill import DistillConfig as JDistillConfig
from kbner_tpu_torch import weights
from kbner_tpu_torch.data.encode import encode_batch
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.train import FinetuneTrainer
from kbner_tpu_torch.train.distill import DistillationTrainer

import torch_world
from torch_world import (JAX_RUNS, JOIN_S, KD_STEPS, MV_CONFIG, PADDED_RUNS,
                         ROUTED, RUN_BASE, TOY_FOLDER, TOY_ROWS, TOY_VOCAB,
                         World, fused_toy_corpus, kd_run, padded_trainer,
                         run_config, run_trainer, toy_tagger, with_contexts)

LAYOUTS = {"dp2": (2, 1, False), "tp2": (1, 2, False),
           "dp2xtp2_fsdp": (2, 2, True)}
STEP_KINDS = ("logit", "posterior", "kbest", "mv_crf", "mv_softmax")
LOSS_REL, G_RTOL, G_ATOL = 1e-4, 2e-3, 1e-5
RUN_RTOL, RUN_ATOL = 1e-4, 1e-6
KEY_BIAS = "attention.key.bias"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(v, data):
    return np.pad(v, [(0, (-v.shape[0]) % data)] + [(0, 0)] * (v.ndim - 1))


def _j_corpus():
    toy = j_load(TOY_FOLDER, {0: "text", 1: "ner"}, comment_symbol="# id")
    train = with_contexts(toy.train, lambda t, g: JRecord(
        tokens=t, tags={"ner": g}))
    return JListCorpus([JCorpus(train=train, dev=[], test=[],
                                name="TOY")])


def _j_model(tags, example, seed, use_crf=True):
    cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=1000), tags, use_crf=use_crf,
        locked_dropout=0.0, word_dropout=0.0)
    return init_tagger(cfg, jax.random.PRNGKey(seed), example)


def _j_run(name, kw, data, models, corpus, tags, base):
    """The JAX trainer's run of ``kw`` on a mesh of ``data`` CPU devices:
    epoch losses, dev scores and final parameters (Flax tree)."""
    (model, params), teacher = models["crf"], models["teacher1"]
    args = (model, jax.tree_util.tree_map(jnp.asarray, params), corpus,
            JTokenizer(TOY_VOCAB), tags)
    mesh = j_make_mesh(data=data, devices=jax.devices()[:data])
    if kw.get("multi_view"):
        trainer = JTrainer(*args, mesh=mesh)
        cfg = JTrainConfig(**RUN_BASE, **kw)
    else:
        trainer = JDistillTrainer(*args, mesh=mesh, teachers=[teacher])
        cfg = JDistillConfig(**RUN_BASE, **kw)
    res = trainer.train(base / f"{name}-{data}", cfg)
    return {"loss": np.asarray(res["history"]["train_loss"]),
            "dev": np.asarray(res["history"]["dev_score"]),
            "tree": jax.tree_util.tree_map(np.asarray, trainer.params),
            "files": sorted(p.name for p in (base / f"{name}-{data}")
                            .iterdir())}


def _reference():
    """The reference's taggers (students with both heads, two teachers),
    as Flax models and numpy trees, the step batch's arrays and, per
    data-axis size, its targets padded to it."""
    corpus = _j_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = JTokenizer(TOY_VOCAB)
    recs = corpus.train[:TOY_ROWS]
    arrays = j_encode(recs, tok, tags).arrays()
    orig = j_encode([j_orig_view(r) for r in recs], tok, tags).arrays()
    example = {k: jnp.asarray(v) for k, v in arrays.items()}
    models = {"crf": _j_model(tags, example, 0),
              "softmax": _j_model(tags, example, 0, use_crf=False),
              "teacher1": _j_model(tags, example, 1),
              "teacher2": _j_model(tags, example, 2)}
    B, W = arrays["word_mask"].shape
    K = len(tags)
    rng = np.random.RandomState(4)
    logit = (2 * rng.standard_normal((B, W, K))).astype(np.float32)
    paths = rng.randint(0, K - 2, size=(B, 2, W)).astype(np.int32)
    pw = rng.dirichlet(np.ones(2), size=B).astype(np.float32)
    targets = {data: {"logit": (_pad(logit, data),),
                      "posterior": (_pad(logit, data),),
                      "kbest": (_pad(paths, data), _pad(pw, data)),
                      "mv_crf": (), "mv_softmax": ()} for data in (1, 2)}
    return {"models": models, "corpus": corpus, "tags": tags,
            "arrays": arrays, "orig": orig, "targets": targets,
            "trees": {k: jax.tree_util.tree_map(np.asarray, p)
                      for k, (_, p) in models.items()}}


def _jax_grads(ref, data):
    """``jax.grad`` of each step kind's loss on the batch padded to
    ``data`` rows' multiple, against its padded targets."""
    jb = {k: jnp.asarray(_pad(v, data)) for k, v in ref["arrays"].items()}
    jo = {k: jnp.asarray(_pad(v, data)) for k, v in ref["orig"].items()}
    out = {}
    for kind in STEP_KINDS:
        model, params = ref["models"]["softmax" if kind == "mv_softmax"
                                      else "crf"]
        t = [jnp.asarray(x) for x in ref["targets"][data][kind]]
        if kind.startswith("mv_"):
            def fn(p, model=model):
                return model.apply(p, jb, jo, deterministic=True,
                                   method=model.multi_view_loss,
                                   kind=MV_CONFIG["mv_kind"],
                                   l2_weight=MV_CONFIG["mv_l2_weight"])
        elif kind == "kbest":
            def fn(p, model=model, t=t):
                return model.apply(
                    p, jb, *t, deterministic=True,
                    interpolation=KD_STEPS[kind]["interpolation"],
                    method=model.kbest_distill_loss)
        else:
            def fn(p, model=model, t=t, kw=KD_STEPS[kind]):
                return model.apply(p, jb, t[0], deterministic=True,
                                   method=model.distill_loss, **kw)
        loss, g = jax.jit(jax.value_and_grad(fn))(params)
        out[kind] = (float(loss), jax.tree_util.tree_map(np.asarray, g))
    return out


def _single_runs(trees, base):
    """The port's single-process runs of :data:`PADDED_RUNS` (every
    dropout on) on batches padded to multiples of 1 and 2 rows."""
    corpus = fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(TOY_VOCAB)
    out = {}
    for data in (1, 2):
        for name, kw in PADDED_RUNS.items():
            cls = padded_trainer(FinetuneTrainer if kw.get("multi_view")
                                 else DistillationTrainer, data)
            trainer = run_trainer(
                kw, toy_tagger(trees["crf"], tags, dropout=True), corpus,
                tok, tags, [toy_tagger(trees["teacher1"], tags)], cls=cls)
            out[name, data] = kd_run(trainer, run_config(kw),
                                     base / f"{name}-{data}")
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each layout's per-rank arrays, and the references: the worlds run
    while the JAX side and the port's single-process runs compute."""
    ref = _reference()
    started = {}
    for name, (data, model, fsdp) in LAYOUTS.items():
        d = tmp_path_factory.mktemp(name)
        started[name] = (World(torch_world.mesh_distill_rank, data * model,
                               d, data, model, fsdp, ref["trees"],
                               ref["targets"][data], str(d)), d)
    ref["grads"] = {data: _jax_grads(ref, data) for data in (1, 2)}
    base = tmp_path_factory.mktemp("jax")
    ref["runs"] = {(name, data): _j_run(name, kw, data, ref["models"],
                                        ref["corpus"], ref["tags"], base)
                   for name, kw in JAX_RUNS.items()
                   for data in ((1, 2) if name == "mv3" else (2,))}
    ref["single"] = _single_runs(ref["trees"],
                                 tmp_path_factory.mktemp("single"))
    tags = fused_toy_corpus().make_tag_dictionary("ner")
    ref["init"] = {n: v.numpy() for n, v in toy_tagger(
        ref["trees"]["crf"], tags).state_dict().items()}
    ref["port_tags"] = tags
    return {name: (w.join(JOIN_S), d) for name, (w, d) in
            started.items()}, ref


def _hold_run(got, want, init, steps, what, small=None):
    """A run's parameters (``param/<name>``) at rtol 1e-4, atol 1e-6; the
    key biases within the run's Adam steps of their start, and so the
    elements where a step of the reference run had a gradient that was
    not 0 but under 1e-5 (``small``): Adam's eps is then over 0.1% of
    its denominator and that step is set by the gradient's last bits,
    which the ranks' sums round apart (one element of 4,096 of
    ``embedding2nn`` at 2.9e-8 in the padded tensor-parallel posterior
    run)."""
    lr = RUN_BASE["learning_rate"]
    for k, w in want.items():
        x = got[f"param/{k}"]
        tiny = np.zeros(w.shape, bool)
        if k.endswith(KEY_BIAS):
            tiny[...] = True
        elif small is not None:
            tiny = small[f"small/{k}"]
        reach = steps * lr * (1.0 if k.endswith(KEY_BIAS)
                              else RUN_BASE["lr_rate"]) * 1.01
        for y in (x, w):
            assert np.abs(y - init[k])[tiny].max(initial=0.0) <= reach, k
        np.testing.assert_allclose(x[~tiny], w[~tiny], rtol=RUN_RTOL,
                                   atol=RUN_ATOL, err_msg=f"{what} {k}")


def test_fused_batches_are_the_reference_batches(worlds):
    """The port's encoding of the fused sentences is the reference's, and
    their orig views are shorter: the comparisons below are on the same
    inputs, and the two views differ."""
    corpus = fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    port = encode_batch(corpus.train[:TOY_ROWS], HashTokenizer(TOY_VOCAB),
                        tags).arrays()
    want = worlds[1]["arrays"]
    assert sorted(port) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(port[k], want[k], err_msg=k)
    assert tags.idx2item == worlds[1]["tags"].idx2item
    assert all("<EOS>" in r.tokens for r in corpus.train)


@pytest.mark.parametrize("kind", STEP_KINDS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_step_loss_and_gradients_match_jax_grad(worlds, layout, kind):
    """Every rank's loss and every gathered gradient of one sharded
    ``kd_step`` (or multi-view ``train_step``) equal ``jax.grad`` of the
    reference's loss on the batch padded to the data axis, its targets
    padded with zero logits, zero paths and zero path weights."""
    ranks = worlds[0][layout][0]
    data = LAYOUTS[layout][0]
    j_loss, j_grads = worlds[1]["grads"][data][kind]
    model = toy_tagger(None, worlds[1]["port_tags"], kind != "mv_softmax")
    want = weights.from_jax_params(j_grads, model)
    for r, got in enumerate(ranks):
        assert float(got[f"step/{kind}/loss"]) == pytest.approx(
            j_loss, rel=LOSS_REL)
        for name, w in want.items():
            np.testing.assert_allclose(got[f"step/{kind}/grad/{name}"],
                                       w.numpy(), rtol=G_RTOL, atol=G_ATOL,
                                       err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("run", JAX_RUNS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_run_matches_jax_meshed_trainer(worlds, layout, run):
    """One epoch, dropout off: the epoch loss and parameters equal the
    JAX trainer's on a mesh of the same data axis (batch 3 pads over
    data = 2; batch 4 does not), and rank 0 wrote the files the JAX
    trainer writes."""
    ranks, d = worlds[0][layout]
    data = LAYOUTS[layout][0]
    ref = worlds[1]["runs"][run, data if run == "mv3" else 2]
    model = toy_tagger(None, worlds[1]["port_tags"])
    want = {k: v.numpy() for k, v in
            weights.from_jax_params(ref["tree"], model).items()}
    kw = JAX_RUNS[run]
    steps = -(-8 // kw["batch_size"])
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"jax/{run}/loss"], ref["loss"],
                                   rtol=RUN_RTOL)
        # no dev set: the dev score is the negated loss
        np.testing.assert_allclose(got[f"jax/{run}/dev"], -ref["loss"],
                                   rtol=RUN_RTOL)
        assert int(got[f"jax/{run}/count"]) == steps
        _hold_run({k[len(f"jax/{run}/"):]: v for k, v in got.items()
                   if k.startswith(f"jax/{run}/")}, want, worlds[1]["init"],
                  steps, f"{layout} rank {r}")
    files = sorted(p.name for p in (d / "jax" / run).iterdir())
    assert files == ref["files"]


@pytest.mark.parametrize("run", PADDED_RUNS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_padded_run_with_dropout_matches_single_process(worlds, layout,
                                                        run):
    """One epoch at batch 3 with every dropout on (the reference's meshed
    distillation trainer fails on these padded batches): the losses and
    parameters equal the port's single-process trainer on the same
    padded batches (masks drawn over the global batch)."""
    ranks = worlds[0][layout][0]
    data = LAYOUTS[layout][0]
    ref = worlds[1]["single"][run, data]
    want = {k[len("param/"):]: v for k, v in ref.items()
            if k.startswith("param/")}
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"pad/{run}/loss"], ref["loss"],
                                   rtol=RUN_RTOL)
        # no dev set: the dev score is the negated loss
        np.testing.assert_allclose(got[f"pad/{run}/dev"], -ref["loss"],
                                   rtol=RUN_RTOL)
        assert int(got[f"pad/{run}/count"]) == int(ref["count"]) == 3
        _hold_run({k[len(f"pad/{run}/"):]: v for k, v in got.items()
                   if k.startswith(f"pad/{run}/")}, want, worlds[1]["init"],
                  3, f"{layout} rank {r}", small=ref)


def _teacher_emissions(worlds, rows):
    """Each teacher's float32 emissions on the routed batch's ``rows``, in
    one process."""
    corpus = fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    routed = [type(r)(tokens=r.tokens, tags=r.tags, lang_id=lang)
              for r, lang in zip(corpus.train, ROUTED)]
    batch = {k: torch.from_numpy(v) for k, v in encode_batch(
        routed, HashTokenizer(TOY_VOCAB), tags).arrays().items()}
    with torch.no_grad():
        return [toy_tagger(worlds[1]["trees"][f"teacher{t}"], tags
                           ).emissions(batch).numpy()[rows]
                for t in (1, 2)]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_teachers_route_per_language_across_ranks(worlds, layout):
    """Two teachers over a batch whose first two sentences are language 0
    and last two language 1: over data = 2 each rank holds one language,
    caches and emits only its own teacher's rows and runs only that
    teacher; sharded on the mesh, every teacher runs on every rank (its
    forward is a collective) and the rows are the same."""
    data = LAYOUTS[layout][0]
    for got in worlds[0][layout][0]:
        lo = int(got["coord"][0]) * (4 // data)
        rows = slice(lo, lo + 4 // data)
        langs = np.asarray(ROUTED)[rows]
        np.testing.assert_array_equal(got["route/owners"], langs)
        em = _teacher_emissions(worlds, rows)
        want = np.where(langs[:, None, None] == 0, em[0], em[1])
        for how in ("whole", "sharded"):
            for key in ("cached", "lazy"):
                np.testing.assert_allclose(got[f"route/{how}/{key}"], want,
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{how} {key}")
        own = [2 * int((langs == t).any()) for t in (0, 1)]
        assert list(got["route/whole/forwards"]) == own
        assert list(got["route/sharded/forwards"]) == [2, 2]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_padding_rows_get_zero_kbest_targets(worlds, layout):
    """The k-best targets of 3 sentences: over data = 2 the padding row
    has a zero path and zero path weights (a softmax over its scores
    would weigh it 1); the real rows are the single-process targets."""
    corpus = fused_toy_corpus()
    tags = corpus.make_tag_dictionary("ner")
    tok = HashTokenizer(TOY_VOCAB)
    trainer = DistillationTrainer(
        toy_tagger(None, tags), corpus, tok, tags, device="cpu",
        teachers=[toy_tagger(worlds[1]["trees"]["teacher1"], tags)])
    paths, pw = trainer._teacher_kbest(
        [encode_batch(corpus.train[:3], tok, tags)], 2)[0]
    data = LAYOUTS[layout][0]
    paths, pw = _pad(paths, data), _pad(pw, data)
    for got in worlds[0][layout][0]:
        n = len(paths) // data
        lo = int(got["coord"][0]) * n
        np.testing.assert_array_equal(got["route/kbest/paths"],
                                      paths[lo:lo + n])
        np.testing.assert_allclose(got["route/kbest/weights"],
                                   pw[lo:lo + n], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pw[:3].sum(-1), 1.0, rtol=1e-6)


def test_teachers_sharded_elsewhere_are_refused(worlds):
    """A teacher that ``shard_params`` sharded on another mesh, or a
    sharded teacher given to a trainer without a mesh, is a
    ``ValueError``."""
    for name, (ranks, _) in worlds[0].items():
        for got in ranks:
            for key in ("refused/other_mesh", "refused/no_mesh"):
                assert "shard_params on the trainer's mesh" in str(
                    got[key]), (name, key)
