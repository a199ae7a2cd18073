"""The port's parser and classifier trainers and their CLI routes
(``kbner_tpu_torch/train/parser_trainer.py``, ``cli.py``
``_build_parser``) against ``kbner_tpu``'s on the fixture corpora of
``tests/test_cli_config.py`` and ``tests/test_conllu.py``:

  - each of the five trainers runs 3 epochs from the JAX trainer's
    initial weights (carried with ``weights.from_jax_params``), dropout
    off, and its ``history.json`` (losses at rtol 1e-4, scores equal or,
    for the MSE, at rtol 1e-4) matches the JAX trainer's;
  - ``best-model.msgpack`` of either package loads into the other's
    trainer (the same tree, the same scores);
  - ``cli test`` and ``cli parse`` of both packages on either package's
    trained directory print the same scores and write the same files, and
    ``cli train`` of both packages trains, tests and prints its scores;
  - ``_build_parser`` reads the model and data keys, refuses the tagger's
    data policies and unknown targets.
"""

import copy
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from kbner_tpu import cli as jcli
from kbner_tpu.config import ExperimentConfig as JExperimentConfig
from kbner_tpu_torch import cli, weights
from kbner_tpu_torch.config import ExperimentConfig
from kbner_tpu_torch.train.parser_trainer import (BiaffineNERTrainer,
                                                  ClassificationTrainer,
                                                  ParserTrainer,
                                                  RegressionTrainer,
                                                  SemDepTrainer)

FIX = Path(__file__).parent / "fixtures"
TRAIN = {"max_epochs": 3, "batch_size": 8, "learning_rate": 5e-3,
         "lr_rate": 1.0}


def _corpus(name, folder, **kw):
    return {"name": name, "data_folder": str(FIX / folder), **kw}


CONFIGS = {
    "dependency": dict(
        corpora=[_corpus("DEP_TOY", "dep_toy", column_format={
            1: "text", 6: "head", 7: "deprel"}, tag_to_bioes=None)],
        model={"encoder": "tiny", "arc_dim": 32, "rel_dim": 16,
               "arc_loss": "crf"}, data={"n_buckets": 2}),
    "enhancedud": dict(
        corpora=[_corpus("SDP_TOY", "semdep_toy", column_format={
            1: "text", 8: "deps"}, tag_to_bioes=None,
            test_file="train.txt")],
        model={"encoder": "tiny", "arc_dim": 32, "rel_dim": 16}),
    "ner_dp": dict(
        corpora=[_corpus("TOY", "ner_toy", column_format={
            0: "text", 1: "ner"}, comment_symbol="# id",
            tag_to_bioes="ner")],
        model={"encoder": "tiny", "span_dim": 32, "max_span_len": 8}),
    "classification": dict(
        corpora=[_corpus("CLF_TOY", "clf_toy", format="fasttext",
                         test_file="train.txt")],
        model={"encoder": "tiny", "dropout": 0.0, "pooling": "rnn",
               "rnn_hidden": 16}),
    "regression": dict(
        corpora=[_corpus("REG_TOY", "reg_toy", format="fasttext",
                         test_file="train.txt")],
        model={"encoder": "tiny", "dropout": 0.0}),
}
TRAINERS = {"dependency": ParserTrainer, "enhancedud": SemDepTrainer,
            "ner_dp": BiaffineNERTrainer,
            "classification": ClassificationTrainer,
            "regression": RegressionTrainer}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _raw(target, target_dir, **train):
    return {"name": f"toy-{target}", "targets": target,
            "tokenizer": {"type": "hash", "vocab_size": 997},
            "train": {**TRAIN, **train}, "target_dir": str(target_dir),
            **copy.deepcopy(CONFIGS[target])}


def _write(path, raw):
    path.write_text(json.dumps(raw))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per target, both trainers' 3-epoch runs from the JAX trainer's
    initial weights: (raw config, JAX trainer, port trainer, JAX dir,
    port dir)."""
    out = {}
    for target in CONFIGS:
        tmp = tmp_path_factory.mktemp(target)
        jdir, pdir = tmp / "jax", tmp / "pt"
        raw = _raw(target, jdir)
        _, _, _, jt = jcli._build_parser(JExperimentConfig.from_dict(raw))
        init = jax.tree_util.tree_map(np.array, jt.params)
        pcfg = ExperimentConfig.from_dict({**raw, "target_dir": str(pdir)})
        _, _, model, pt = cli._build_parser(pcfg, "cpu")
        assert type(pt) is TRAINERS[target]
        model.load_state_dict(weights.from_jax_params(init, model))
        jt.train(jdir, JExperimentConfig.from_dict(raw).make_train_config())
        pt.train(pdir, pcfg.make_train_config())
        out[target] = (raw, jt, pt, jdir, pdir)
    return out


@pytest.mark.parametrize("target", list(CONFIGS))
def test_trainer_history_matches_jax(runs, target):
    _, _, _, jdir, pdir = runs[target]
    want = json.loads((jdir / "history.json").read_text())
    got = json.loads((pdir / "history.json").read_text())
    assert [sorted(h) for h in got] == [sorted(h) for h in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-4)
        for k in w:
            if k in ("loss", "epoch"):
                continue
            if k in ("mse", "neg_mse"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4)
            else:
                assert g[k] == w[k], (k, g, w)
    for name in ("best-model.msgpack", "final-model.msgpack"):
        assert (pdir / name).exists() and (jdir / name).exists()


@pytest.mark.parametrize("target", list(CONFIGS))
def test_checkpoints_cross_both_ways(runs, target):
    """Each package's best-model.msgpack: the same tree layout; the other
    package loads it and scores the test split the same."""
    raw, jt, pt, jdir, pdir = runs[target]
    j_tree = serialization.msgpack_restore(
        (jdir / "best-model.msgpack").read_bytes())
    p_tree = serialization.msgpack_restore(
        (pdir / "best-model.msgpack").read_bytes())
    assert jax.tree_util.tree_structure(j_tree) == \
        jax.tree_util.tree_structure(p_tree)
    test_j = [r for s in jt.corpus.test_list for r in s]
    test_p = [r for s in pt.corpus.test_list for r in s]
    pt.load(jdir / "best-model.msgpack")
    want = weights.from_jax_params(j_tree, pt.model)
    for name, p in pt.model.state_dict().items():
        assert torch.equal(p, want[name]), name
    jt.load(pdir / "best-model.msgpack")
    for a, b in zip(jax.tree_util.tree_leaves(jt.params),
                    jax.tree_util.tree_leaves(p_tree)):
        np.testing.assert_array_equal(np.asarray(a), b)
    port_on_jax, jax_on_port = pt.evaluate(test_p), jt.evaluate(test_j)
    pt.load(pdir / "best-model.msgpack")
    jt.load(jdir / "best-model.msgpack")
    for got, want in ((port_on_jax, jt.evaluate(test_j)),
                      (jax_on_port, pt.evaluate(test_p))):
        assert got.keys() == want.keys()
        np.testing.assert_allclose([got[k] for k in sorted(want)],
                                   [want[k] for k in sorted(want)],
                                   rtol=1e-4)


def _json_out(capsys):
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


@pytest.mark.parametrize("target", list(CONFIGS))
def test_cli_test_and_parse_match_in_both_packages(runs, target, tmp_path,
                                                   capsys):
    """``cli test`` (and ``cli parse`` for the parsing targets) of both
    packages on either package's trained directory: the same scores, the
    same files."""
    raw = runs[target][0]
    for run_dir in runs[target][3:]:
        cfg = _write(tmp_path / "cfg.json", {**raw,
                                             "target_dir": str(run_dir)})
        capsys.readouterr()
        jcli.main(["test", "--config", str(cfg)])
        want = _json_out(capsys)
        cli.main(["test", "--config", str(cfg), "--device", "cpu"])
        got = _json_out(capsys)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_allclose(
                [got[name][k] for k in sorted(want[name])],
                [want[name][k] for k in sorted(want[name])], rtol=1e-4)
        if target not in cli.PARSE_LAYERS:
            continue
        folder = Path(raw["corpora"][0]["data_folder"])
        for pkg, argv in (("jax", []), ("pt", ["--device", "cpu"])):
            main = jcli.main if pkg == "jax" else cli.main
            main(["parse", "--config", str(cfg), "--target_dir",
                  str(folder / "train.txt"), "--out_dir",
                  str(tmp_path / pkg), *argv])
        assert (tmp_path / "pt" / "train.conllu").read_text() == \
            (tmp_path / "jax" / "train.conllu").read_text()


# the tree parser trains from CoNLL-U here (tests/test_conllu.py's
# config); its column-file config trains in the ``runs`` fixture
CLI_CONFIGS = ["conllu"] + list(CONFIGS)[1:]


@pytest.mark.parametrize("target", CLI_CONFIGS)
def test_cli_train_in_both_packages(target, tmp_path, capsys):
    """``cli train`` of both packages, one epoch: each trains, tests its
    best model and prints the same score keys as the last line."""
    if target == "conllu":
        raw = _raw("dependency", tmp_path, max_epochs=1)
        raw["corpora"] = [{"name": "UD_TOY", "format": "conllu",
                           "data_folder": str(FIX / "ud_toy"),
                           "train_file": "en_toy-ud-train.conllu",
                           "dev_file": "en_toy-ud-dev.conllu",
                           "test_file": "en_toy-ud-train.conllu"}]
        raw["data"] = {}
    else:
        raw = _raw(target, tmp_path, max_epochs=1)
    keys = []
    for pkg in ("jax", "pt"):
        cfg = _write(tmp_path / f"{pkg}.json",
                     {**raw, "target_dir": str(tmp_path / pkg)})
        capsys.readouterr()
        if pkg == "jax":
            jcli.main(["train", "--config", str(cfg)])
        else:
            cli.main(["train", "--config", str(cfg), "--device", "cpu"])
        scores = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert all(np.isfinite(v) for v in scores.values()), scores
        keys.append(sorted(scores))
        assert (tmp_path / pkg / "best-model.msgpack").exists()
        assert len(json.loads((tmp_path / pkg / "history.json")
                              .read_text())) == 1
    assert keys[0] == keys[1]


def test_build_parser_reads_keys_and_refuses(tmp_path):
    """The model and data keys reach the models; the tagger's data
    policies and an unknown target raise; ``cli parse`` of a classifier
    raises naming the parsing targets."""
    raw = _raw("dependency", tmp_path)
    raw["model"].update(arc_dim=24, rel_dim=12, partial=True)
    _, _, model, trainer = cli._build_parser(ExperimentConfig.from_dict(raw),
                                             "cpu")
    assert (model.config.arc_dim, model.config.rel_dim, model.config.partial,
            model.config.arc_loss) == (24, 12, True, "crf")
    assert trainer.n_buckets == 2
    raw = _raw("classification", tmp_path)
    raw["model"].update(pooling="min_max_mean", multi_label=True)
    _, _, model, trainer = cli._build_parser(ExperimentConfig.from_dict(raw),
                                             "cpu")
    assert model.head.in_features == 3 * model.config.encoder.hidden_size
    assert trainer.score_key == "micro_f1"
    raw = _raw("enhancedud", tmp_path)
    raw["data"] = {"dep_layer": "deps"}
    raw["model"]["arc_threshold"] = 0.7
    _, _, model, trainer = cli._build_parser(ExperimentConfig.from_dict(raw),
                                             "cpu")
    assert model.config.arc_threshold == 0.7 and \
        trainer.rel_dict.idx2item[0] == "<unk>"
    for data in ({"doc_context": True}, {"stride_windows": True}):
        with pytest.raises(ValueError, match="NER-tagger data policies"):
            cli._build_parser(ExperimentConfig.from_dict(
                {**raw, "data": data}), "cpu")
    with pytest.raises(ValueError, match="unknown targets"):
        cli._build_parser(ExperimentConfig.from_dict(
            {**raw, "targets": "constituency"}), "cpu")
    cfg = _write(tmp_path / "clf.json", _raw("classification", tmp_path))
    with pytest.raises(ValueError, match="cli parse writes column files"):
        cli.main(["parse", "--config", str(cfg), "--target_dir",
                  str(FIX / "clf_toy"), "--device", "cpu"])
