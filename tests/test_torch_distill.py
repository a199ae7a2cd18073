"""The PyTorch port's knowledge distillation against kbner_tpu's: the
tagger's distillation losses (logit, posterior, k-best) with transition
attention on and off, the teachers' caches and routing, a
``DistillationTrainer`` run from carried-in weights, and ``cli train``
with ``trainer: DistillationTrainer`` (teacher checkpoints crossing both
ways).

Tolerances, float32 on the CPU: losses rtol 1e-5 and gradients rtol 1e-4,
atol 1e-6, as tests/test_torch_tagger.py; a trainer run's parameters rtol
1e-5, atol 1e-7 and its losses per epoch rtol 1e-5, as
tests/test_torch_train.py; the float32 teacher caches rtol 1e-5, atol
1e-5, as the JAX package's routing test; the port's float16 cache bit for
bit its own float32 scores cast by numpy, and within one float16 step of
the JAX package's; k-best paths and cache dtypes exactly.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from kbner_tpu.config import ExperimentConfig as JExperimentConfig
from kbner_tpu.data import quality_fixture as jquality
from kbner_tpu.data.conll import Corpus as JCorpus
from kbner_tpu.data.conll import ListCorpus as JListCorpus
from kbner_tpu.data.encode import encode_batch as j_encode
from kbner_tpu.data.encode import make_batches as j_make_batches
from kbner_tpu.data.subword import HashTokenizer as JTokenizer
from kbner_tpu.models import TaggerConfig as JTaggerConfig
from kbner_tpu.models import XLMRConfig as JXLMRConfig
from kbner_tpu.models import init_tagger
from kbner_tpu.train.distill import DistillConfig as JDistillConfig
from kbner_tpu.train.distill import DistillationTrainer as JDistillTrainer
from kbner_tpu_torch import checkpoint, cli, weights
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.data import quality_fixture
from kbner_tpu_torch.data.conll import Corpus, ListCorpus
from kbner_tpu_torch.data.encode import encode_batch, make_batches
from kbner_tpu_torch.data.subword import HashTokenizer
from kbner_tpu_torch.models.tagger import SequenceTagger, TaggerConfig
from kbner_tpu_torch.models.xlmr import XLMRConfig
from kbner_tpu_torch.train import distill as distill_module
from kbner_tpu_torch.train.distill import DistillationTrainer, DistillConfig

FIX = Path(__file__).parent / "fixtures"
VOCAB = 997
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def _two_languages(module, n_train=24, seed=2):
    """The quality corpus's train split as two languages (the halves),
    with dev and test on the first."""
    base = module.make_quality_corpus(n_train, 6, 6, seed=seed)
    c = base.corpora[0]
    half = len(c.train) // 2
    Corpus_, ListCorpus_ = ((JCorpus, JListCorpus)
                            if module is jquality else (Corpus, ListCorpus))
    return ListCorpus_([Corpus_(train=c.train[:half], dev=c.dev, test=c.test,
                                name="EN"),
                        Corpus_(train=c.train[half:], dev=[], test=[],
                                name="DE")])


def _pair(tags_j, tags_p, example_j, seed, noise=0.05, **kw):
    """A Flax tagger (perturbed parameters, from ``seed``) and the port's
    tagger with the same weights; dropout off."""
    j_cfg = JTaggerConfig.for_tag_dictionary(
        JXLMRConfig.tiny(vocab_size=VOCAB), tags_j, locked_dropout=0.0,
        word_dropout=0.0, **kw)
    model, params = init_tagger(j_cfg, jax.random.PRNGKey(seed), example_j)
    rng = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32), params)
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags_p, locked_dropout=0.0,
        word_dropout=0.0, **kw)
    tagger = SequenceTagger(cfg, device="cpu", seed=seed + 1)
    tagger.load_state_dict(weights.from_jax_params(params, cfg), strict=True)
    return model, params, tagger


@pytest.fixture(scope="module")
def corpora():
    jc, pc = _two_languages(jquality), _two_languages(quality_fixture)
    jtags, tags = jc.make_tag_dictionary("ner"), pc.make_tag_dictionary("ner")
    assert jtags.idx2item == tags.idx2item
    example = {k: jnp.asarray(v) for k, v in j_encode(
        jc.train[:2], JTokenizer(VOCAB), jtags).arrays().items()}
    return jc, pc, jtags, tags, example


# -- the tagger's losses and their gradients ----------------------------------------

LOSSES = [
    dict(kind="logit", temperature=1.0),
    dict(kind="logit", temperature=2.0, transition_attention=True),
    dict(kind="logit", temperature=2.0, use_crf=False),
    dict(kind="posterior"),
    # the posterior term's marginals take the per-language matrices while
    # the gold loss takes the attention mixture, as the reference's do
    dict(kind="posterior", transition_attention=True),
    dict(kind="kbest"),
    dict(kind="kbest", transition_attention=True),
]


@pytest.mark.parametrize("case", LOSSES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_distill_losses_and_every_gradient_match_flax(corpora, case):
    case = dict(case)
    kind, temperature = case.pop("kind"), case.pop("temperature", 1.0)
    jc, pc, jtags, tags, example = corpora
    kw = dict(case, num_languages=2) if case.get("transition_attention") \
        else case
    model, params, tagger = _pair(jtags, tags, example, seed=3, **kw)
    arrays = encode_batch(pc.train[:4] + pc.train[-4:], HashTokenizer(VOCAB),
                          tags).arrays()
    assert set(arrays["lang_ids"].tolist()) == {0, 1}
    rng = np.random.RandomState(4)
    B, W = arrays["word_mask"].shape
    K = len(tags)
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    if kind == "kbest":
        paths = rng.randint(0, K - 2, size=(B, 3, W)).astype(np.int32)
        pw = rng.dirichlet(np.ones(3), size=B).astype(np.float32)
        targets = (paths, pw)
        j_fn = lambda p: model.apply(  # noqa: E731
            p, jb, jnp.asarray(paths), jnp.asarray(pw), deterministic=True,
            interpolation=0.3, method=model.kbest_distill_loss)
        p_fn = lambda: tagger.kbest_distill_loss(  # noqa: E731
            _torch(arrays), *map(torch.from_numpy, targets),
            interpolation=0.3)
    else:
        teacher = (2 * rng.standard_normal((B, W, K))).astype(np.float32)
        post = kind == "posterior"
        j_fn = lambda p: model.apply(  # noqa: E731
            p, jb, jnp.asarray(teacher), deterministic=True,
            interpolation=0.3, temperature=temperature, posterior=post,
            method=model.distill_loss)
        p_fn = lambda: tagger.distill_loss(  # noqa: E731
            _torch(arrays), torch.from_numpy(teacher), interpolation=0.3,
            temperature=temperature, posterior=post)
    want, j_grads = jax.value_and_grad(j_fn)(jp)
    got = p_fn()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    want_grads = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, j_grads), tagger.config)
    for name, p in tagger.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=name)


def test_transition_attention_draws_and_carries(corpora):
    """The attention is drawn as Flax draws it (normal(0, 0.02), zero
    bias), lives beside the per-language transitions, and carries both
    ways under the Flax tree's names."""
    jc, pc, jtags, tags, example = corpora
    cfg = TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB, hidden_size=256,
                        intermediate_size=64), tags, num_languages=40,
        transition_attention=True)
    tagger = SequenceTagger(cfg, device="cpu", seed=0)
    att = tagger.sent_to_trans_att.detach()
    assert tuple(att.shape) == (256, 40)
    assert abs(float(att.std()) - 0.02) < 0.001
    assert not bool(tagger.sent_to_trans_att_b.any())
    model, params, tagger = _pair(jtags, tags, example, seed=5,
                                  num_languages=2, transition_attention=True)
    tree = weights.to_jax_params(tagger.state_dict(), tagger.config)
    assert jax.tree_util.tree_structure(tree) == \
        jax.tree_util.tree_structure(params)
    for name in ("transitions", "sent_to_trans_att", "sent_to_trans_att_b"):
        np.testing.assert_array_equal(tree["params"][name],
                                      params["params"][name])
    # a tagger without languages has no attention, whatever the flag says
    plain = SequenceTagger(TaggerConfig.for_tag_dictionary(
        XLMRConfig.tiny(vocab_size=VOCAB), tags, transition_attention=True),
        device="cpu")
    assert plain.sent_to_trans_att is None


@pytest.mark.parametrize("posterior", [False, True])
def test_attention_decode_matches_flax(corpora, posterior):
    jc, pc, jtags, tags, example = corpora
    model, params, tagger = _pair(jtags, tags, example, seed=6,
                                  num_languages=2, transition_attention=True)
    arrays = encode_batch(pc.train[:3] + pc.train[-3:], HashTokenizer(VOCAB),
                          tags).arrays()
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    want_tags, want_scores = model.apply(
        jax.tree_util.tree_map(jnp.asarray, params), jb,
        method=lambda m, b: m.decode(b, posterior=posterior))
    got_tags, got_scores = tagger.decode(_torch(arrays), posterior=posterior)
    np.testing.assert_array_equal(got_tags.numpy(), np.asarray(want_tags))
    np.testing.assert_allclose(got_scores.numpy(), np.asarray(want_scores),
                               rtol=1e-5)


# -- the teachers ---------------------------------------------------------------------

def _trainers(corpora, n_teachers, teacher_kw=None, **student_kw):
    """The JAX and port distillation trainers over the two-language
    corpus: the same student and the same ``n_teachers`` teachers in both
    (the JAX trainer's parameters as numpy, for the trainer to copy), over
    corpora of their own."""
    _, _, jtags, tags, example = corpora
    jc, pc = _two_languages(jquality), _two_languages(quality_fixture)
    smodel, sparams, student = _pair(jtags, tags, example, seed=0,
                                     **student_kw)
    teachers = [_pair(jtags, tags, example, seed=100 + i,
                      **(teacher_kw or {})) for i in range(n_teachers)]
    jt = JDistillTrainer(
        smodel, jax.tree_util.tree_map(jnp.asarray, sparams), jc,
        JTokenizer(VOCAB), jtags,
        teachers=[(m, jax.tree_util.tree_map(jnp.asarray, p))
                  for m, p, _ in teachers])
    pt = DistillationTrainer(student, pc, HashTokenizer(VOCAB), tags,
                             teachers=[t for _, _, t in teachers],
                             device="cpu")
    return jt, pt, sparams


def _batches(jt, pt, batch_size=8):
    jb = j_make_batches(jt.corpus.train, jt.tokenizer, jt.tag_dict,
                        batch_size, shuffle=False, tag_layer="ner")
    pb = make_batches(pt.corpus.train, pt.tokenizer, pt.tag_dict, batch_size,
                      shuffle=False, tag_layer="ner")
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(a.input_ids, b.input_ids)
    return jb, pb


def test_per_language_teacher_routing(corpora):
    """Two teachers, two languages: each sentence's cached emissions come
    from its own language's teacher, as in the JAX package."""
    jt, pt, _ = _trainers(corpora, 2)
    jb, pb = _batches(jt, pt)
    want = jt._teacher_emissions(jb, dtype=np.float32)
    got = pt._teacher_emissions(pb, dtype=np.float32)
    for eb, g, w in zip(pb, got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
        arrays = _torch(eb.arrays())
        for t_idx, teacher in enumerate(pt.teachers):
            rows = np.clip(eb.lang_ids, 0, 1) == t_idx
            with torch.no_grad():
                own = teacher.emissions(arrays).numpy()
            np.testing.assert_array_equal(g[rows], own[rows])
    assert any(len(set(eb.lang_ids.tolist())) == 2 for eb in pb)


def _within_a_float16_step(got, want):
    """Two float16 caches of float32 scores that agree within atol 1e-5
    (the float32 caches' tolerance): at most that plus one float16 step
    apart."""
    step = np.spacing(np.abs(want)).astype(np.float32)
    assert (np.abs(got.astype(np.float32) - want.astype(np.float32))
            <= step + 1e-5).all()


def test_teacher_cache_policies(corpora, tmp_path):
    """f16 holds half the bytes, numpy's rounding of the float32 scores
    bit for bit and within one float16 step of the JAX package's cache;
    lazy emits what the float32 cache holds; an unknown policy raises the
    JAX package's message."""
    jt, pt, _ = _trainers(corpora, 1)
    jb, pb = _batches(jt, pt, batch_size=16)
    c16, c32 = pt._teacher_emissions(pb), pt._teacher_emissions(
        pb, dtype=np.float32)
    j16 = jt._teacher_emissions(jb)
    assert c16[0].dtype == np.float16 and j16[0].dtype == np.float16
    assert sum(a.nbytes for a in c16) * 2 == sum(a.nbytes for a in c32)
    for a16, a32, w16 in zip(c16, c32, j16):
        np.testing.assert_array_equal(a16.view(np.uint16),
                                      a32.astype(np.float16).view(np.uint16))
        _within_a_float16_step(a16, w16)
    for eb, a32 in zip(pb, c32):
        np.testing.assert_array_equal(pt._batch_emissions(eb).numpy(), a32)
    errors = []
    for trainer, cfg in ((jt, JDistillConfig), (pt, DistillConfig)):
        with pytest.raises(ValueError, match="teacher_cache") as err:
            trainer.train(tmp_path / type(trainer).__module__,
                          cfg(teacher_cache="zstd"))
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_teacher_kbest_paths_and_weights(corpora):
    """The first teacher's k-best paths and softmax weights, the whole
    ``[B, N]`` array: a one-word sentence has fewer distinct paths than N,
    whose scores sit at the CRF's -1e30 and weigh 0."""
    tags = corpora[3]
    jt, pt, _ = _trainers(corpora, 1)
    for trainer in (jt, pt):
        one = trainer.corpus.train[0]
        trainer.corpus.corpora[0].train.insert(0, type(one)(
            tokens=one.tokens[:1], tags={"ner": one.tags["ner"][:1]}))
    jb, pb = _batches(jt, pt, batch_size=32)
    n_best = len(tags) + 3
    want = jt._teacher_kbest(jb, n_best)
    got = pt._teacher_kbest(pb, n_best)
    for (gp, gw), (wp, ww) in zip(got, want):
        assert gp.shape == wp.shape and gw.shape == ww.shape
        np.testing.assert_array_equal(gp, np.asarray(wp))
        np.testing.assert_allclose(gw, np.asarray(ww), rtol=1e-5, atol=1e-7,
                                   equal_nan=True)
        assert (gw == 0).any() and not np.isnan(gw).any()
        np.testing.assert_allclose(gw.sum(-1), 1.0, rtol=1e-6)


# -- a trainer run from carried-in weights --------------------------------------------

RUNS = [
    dict(teacher_cache="f32", temperature=2.0),
    dict(teacher_cache="f16"),
    dict(teacher_cache="lazy", interpolation=0.7),
    dict(teacher_cache="f32", posterior=True),
    dict(kbest=3),
]


@pytest.mark.parametrize("kw", RUNS, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()))
def test_trainer_run_matches_jax(corpora, tmp_path, monkeypatch, kw):
    """One epoch of 4 batches in the seeded permutation's order, as
    tests/test_torch_train.py's run (routed per language over two
    teachers, the first alone for k-best), dropout off: the student's
    parameters, the loss, the dev score and the files equal the JAX
    trainer's. (A second epoch can bring a token back with a gradient
    that nearly cancels its Adam moment, which turns the frameworks'
    last-bit gradient differences into a visible share of a step: one
    embedding element at 2.9e-5 relative after two epochs of the
    posterior run.)

    The float16 run trains both students on the JAX trainer's float16
    cache: the two frameworks' float32 scores differ in the last bits, so
    a few of them (4 of 3,072 here) round to other float16 values, a
    difference test_teacher_cache_policies bounds."""
    jt, pt, init = _trainers(corpora, 2)
    cfg = dict(learning_rate=1e-3, lr_rate=3.0, batch_size=6, max_epochs=1,
               warmup_fraction=0.0, seed=4, **kw)
    if kw.get("teacher_cache") == "f16":
        jb, pb = _batches(jt, pt, batch_size=6)
        shared = jt._teacher_emissions(jb)
        for own, theirs in zip(pt._teacher_emissions(pb), shared):
            _within_a_float16_step(own, theirs)
        monkeypatch.setattr(pt, "_teacher_emissions",
                            lambda batches, dtype: shared)
    # each element's largest gradient over the run, read as the
    # optimizer takes it
    seen = {}
    make = distill_module.make_finetune_optimizer

    def recording(named, **kw):
        named = list(named)
        opt = make(named, **kw)
        step = opt.step

        def recorded():
            for n, prm in named:
                g = prm.grad.abs() if prm.grad is not None else 0.0 * prm
                seen[n] = torch.maximum(seen.get(n, g), g).detach()
            return step()
        opt.step = recorded
        return opt

    monkeypatch.setattr(distill_module, "make_finetune_optimizer", recording)
    j_result = jt.train(tmp_path / "jax", JDistillConfig(**cfg))
    p_result = pt.train(tmp_path / "pt", DistillConfig(**cfg))
    want = weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jt.params), pt.model.config)
    start = weights.from_jax_params(init, pt.model.config)
    reach = 4 * cfg["learning_rate"] * cfg["lr_rate"] * 1.01
    moved = 0
    for name, p in pt.model.state_dict().items():
        # where every gradient of the run stays under 1e-5, Adam's eps
        # (1e-8) is over 0.1% of its denominator and the step is set by
        # the gradient's last bits, which the frameworks round apart (one
        # position-embedding element at 2e-5 relative in the float16
        # run); such elements, and attention.key.bias (a zero gradient in
        # exact arithmetic, tests/test_torch_train.py), are held within
        # the run's reach of the start
        tiny = (seen[name] < 1e-5).numpy()
        if name.endswith("attention.key.bias"):
            tiny[...] = True
        for x in (p, want[name]):
            assert float((x - start[name]).abs().numpy()[tiny].max(
                initial=0.0)) <= reach, name
        np.testing.assert_allclose(p.numpy()[~tiny], want[name].numpy()[~tiny],
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        moved += int(not torch.equal(p, start[name]))
    assert moved > 0
    np.testing.assert_allclose(p_result["history"]["train_loss"],
                               j_result["history"]["train_loss"], rtol=1e-5)
    assert p_result["history"]["dev_score"] == \
        j_result["history"]["dev_score"]
    assert p_result["best_dev_score"] == j_result["best_dev_score"]
    for name in ("best-model.msgpack", "final-model.msgpack",
                 "tag_dictionary.json"):
        assert (tmp_path / "pt" / name).exists(), name
    assert sorted(p.name for p in (tmp_path / "pt").iterdir()) == \
        sorted(p.name for p in (tmp_path / "jax").iterdir())


# -- the config and the CLI ------------------------------------------------------------

def _config(tmp_path, name="toy", **overrides):
    raw = yaml.safe_load((FIX / "toy_config.yaml").read_text())
    raw["corpora"][0]["data_folder"] = str(FIX / "ner_toy")
    raw["corpora"][0]["test_file"] = "train.txt"
    raw["train"]["max_epochs"] = 25
    raw["target_dir"] = str(tmp_path / f"{name}_run")
    raw["name"] = name
    raw.update(overrides)
    p = tmp_path / f"{name}.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p, raw


def test_config_keeps_teachers_and_systems(tmp_path):
    """``teachers:`` and ``systems:`` are kept as the JAX config keeps
    them (they used to be dropped)."""
    systems = {"dev": ["d.a.tsv", "d.b.tsv"], "test": ["t.a.tsv"]}
    p, _ = _config(tmp_path, trainer="DistillationTrainer",
                   teachers=["a.yaml", "b.yaml"], systems=systems)
    got, want = ExperimentConfig.from_file(p), JExperimentConfig.from_file(p)
    assert got.teachers == want.teachers == ["a.yaml", "b.yaml"]
    assert got.systems == want.systems == systems
    p, _ = _config(tmp_path, name="plain")
    got, want = ExperimentConfig.from_file(p), JExperimentConfig.from_file(p)
    assert (got.teachers, got.systems) == (want.teachers, want.systems) == \
        ([], {})


def test_distill_train_keys_validated(tmp_path):
    """``DistillConfig``'s keys are legal under the distillation trainer
    and give the JAX package's config; the fine-tuner rejects them."""
    p, raw = _config(tmp_path, trainer="DistillationTrainer")
    raw["train"].update(interpolation=0.7, kbest=2, teacher_cache="lazy")
    p.write_text(yaml.safe_dump(raw))
    got = ExperimentConfig.from_file(p).make_train_config()
    want = JExperimentConfig.from_file(p).make_train_config()
    assert isinstance(got, DistillConfig) and got.interpolation == 0.7
    assert {f: getattr(got, f) for f in ("interpolation", "temperature",
                                         "posterior", "kbest",
                                         "teacher_cache")} == \
        {f: getattr(want, f) for f in ("interpolation", "temperature",
                                       "posterior", "kbest",
                                       "teacher_cache")}
    raw["trainer"] = "FinetuneTrainer"
    p.write_text(yaml.safe_dump(raw))
    with pytest.raises(ValueError, match="interpolation"):
        ExperimentConfig.from_file(p).make_train_config()


def test_cli_kd_end_to_end(tmp_path):
    """A teacher trained by ``cli train``, then a student distilled from
    it through ``trainer: DistillationTrainer`` + ``teachers:`` learns the
    toy corpus at the JAX test's step, 1e-3, as the JAX CLI's does."""
    teacher_p, teacher_raw = _config(tmp_path, name="teacher")
    cli.main(["train", "--config", str(teacher_p), "--device", "cpu"])
    assert (Path(teacher_raw["target_dir"]) / "best-model.msgpack").exists()
    student_p, student_raw = _config(
        tmp_path, name="student", trainer="DistillationTrainer",
        teachers=[str(teacher_p)])
    student_raw["train"].update(interpolation=0.5, max_epochs=20)
    student_p.write_text(yaml.safe_dump(student_raw))
    result = cli.main(["train", "--config", str(student_p), "--device",
                       "cpu"])
    run = Path(student_raw["target_dir"])
    for name in ("best-model.msgpack", "final-model.msgpack",
                 "test_results.json", "test.TOY.tsv", "training.log"):
        assert (run / name).exists(), name
    assert len(result["history"]["train_loss"]) == 20
    results = json.loads((run / "test_results.json").read_text())
    assert results["TOY"]["micro_f1"] > 0.8


@pytest.mark.parametrize("kw", [
    dict(teacher_cache="f16"), dict(teacher_cache="f32"),
    dict(teacher_cache="lazy"), dict(posterior=True), dict(kbest=3)],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_cli_kd_modes(tmp_path, kw):
    """Every distillation mode runs through ``cli train`` over an
    enhanced-CRF teacher with transition attention and its checkpoint."""
    teacher_p, teacher_raw = _config(tmp_path, name="teacher")
    teacher_raw["model"].update(enhanced_crf=True, transition_attention=True)
    teacher_raw["train"]["max_epochs"] = 2
    teacher_p.write_text(yaml.safe_dump(teacher_raw))
    cli.main(["train", "--config", str(teacher_p), "--device", "cpu"])
    tree = checkpoint.load(Path(teacher_raw["target_dir"])
                           / "best-model.msgpack")
    assert tree["params"]["sent_to_trans_att"].shape == (64, 1)
    student_p, student_raw = _config(
        tmp_path, name="student", trainer="ModelDistiller",
        teachers=[str(teacher_p)])
    student_raw["train"].update(max_epochs=2, **kw)
    student_p.write_text(yaml.safe_dump(student_raw))
    result = cli.main(["train", "--config", str(student_p), "--device",
                       "cpu"])
    assert np.isfinite(result["history"]["train_loss"]).all()
    assert (Path(student_raw["target_dir"]) / "test_results.json").exists()


def test_cli_kd_requires_teachers(tmp_path):
    p, _ = _config(tmp_path, name="kd_no_teachers",
                   trainer="DistillationTrainer")
    with pytest.raises(ValueError, match="teachers"):
        cli.main(["train", "--config", str(p), "--device", "cpu"])


def test_cli_kd_refuses_untrained_or_mismatched_teachers(tmp_path):
    teacher_p, _ = _config(tmp_path, name="untrained")
    student_p, _ = _config(tmp_path, name="student",
                           trainer="DistillationTrainer",
                           teachers=[str(teacher_p)])
    with pytest.raises(ValueError, match="no trained checkpoint"):
        cli.main(["train", "--config", str(student_p), "--device", "cpu"])
    other_p, other_raw = _config(tmp_path, name="other")
    other_raw["corpora"][0]["data_folder"] = str(FIX / "ner_toy_de")
    other_p.write_text(yaml.safe_dump(other_raw))
    student_p, _ = _config(tmp_path, name="student2",
                           trainer="DistillationTrainer",
                           teachers=[str(other_p)])
    with pytest.raises(ValueError, match="tag dictionary differs"):
        cli.main(["train", "--config", str(student_p), "--device", "cpu"])


def test_teacher_checkpoints_cross_both_ways(tmp_path):
    """A teacher trained by the JAX CLI teaches the port's student, and a
    teacher trained by the port's CLI teaches the JAX package's student:
    each side's teacher, loaded from the other's checkpoint, emits what
    the writer's emits (rtol 1e-5, atol 1e-5)."""
    from kbner_tpu import cli as jcli

    for name, writer in (("jax_teacher", jcli), ("pt_teacher", cli)):
        p, raw = _config(tmp_path, name=name)
        raw["train"]["max_epochs"] = 3
        p.write_text(yaml.safe_dump(raw))
        writer.main(["train", "--config", str(p)] + (
            ["--device", "cpu"] if writer is cli else []))
    # the port's student over the JAX teacher
    sp, sraw = _config(tmp_path, name="pt_student",
                       trainer="DistillationTrainer",
                       teachers=[str(tmp_path / "jax_teacher.yaml")])
    sraw["train"]["max_epochs"] = 2
    sp.write_text(yaml.safe_dump(sraw))
    pt = cli._build_distill(ExperimentConfig.from_file(sp), "cpu")
    # the JAX package's student over the port's teacher
    jp, jraw = _config(tmp_path, name="jax_student",
                       trainer="DistillationTrainer",
                       teachers=[str(tmp_path / "pt_teacher.yaml")])
    jraw["train"]["max_epochs"] = 2
    jp.write_text(yaml.safe_dump(jraw))
    _, jt = jcli._build_distill(JExperimentConfig.from_file(jp))
    pt_reader = cli._build_distill(ExperimentConfig.from_file(jp), "cpu")
    _, jt_reader = jcli._build_distill(JExperimentConfig.from_file(sp))
    for port, jax_ in ((pt, jt_reader), (pt_reader, jt)):
        pb = make_batches(port.corpus.train, port.tokenizer, port.tag_dict,
                          4, shuffle=False)
        jb = j_make_batches(jax_.corpus.train, jax_.tokenizer,
                            jax_.tag_dict, 4, shuffle=False)
        for g, w in zip(port._teacher_emissions(pb, dtype=np.float32),
                        jax_._teacher_emissions(jb, dtype=np.float32)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    cli.main(["train", "--config", str(sp), "--device", "cpu"])
    jcli.main(["train", "--config", str(jp)])
    for run in ("pt_student_run", "jax_student_run"):
        results = json.loads((tmp_path / run / "test_results.json")
                             .read_text())
        assert 0.0 <= results["TOY"]["micro_f1"] <= 1.0
