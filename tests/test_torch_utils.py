"""The PyTorch port's parameter search and utilities against kbner_tpu's:
random and TPE search trials equal for the same seed (every proposal,
score and the saved ``param_search.json``), ``render_ner_html`` byte for
byte, ``cached_path``/``extract_archive`` (local paths, seeded cache
entries, the download opt-in refused without touching the network,
archives), the progress log's sessions and per-round seconds, and the
plotter's None without matplotlib."""

import json
import sys
import tarfile
import zipfile
from pathlib import Path

import numpy as np
import pytest

from kbner_tpu.train import param_search as jps
from kbner_tpu.utils import artifacts as jart
from kbner_tpu.utils import html_viz as jhtml
from kbner_tpu.utils import progress as jprog
from kbner_tpu_torch.data.conll import SentenceRecord
from kbner_tpu_torch.train import param_search as ps
from kbner_tpu_torch.utils import artifacts, html_viz, plotter, progress

FIX = Path(__file__).parent / "fixtures"


# -- parameter search -----------------------------------------------------------------

def _space(mod):
    return mod.SearchSpace(
        choices={"hidden": [64, 128, 256], "opt": ["sgd", {"adam": 1}]},
        uniform={"dropout": (0.0, 0.5)},
        log_uniform={"lr": (1e-5, 1e-1)})


def _score(params):
    """A deterministic dev score with an interior optimum."""
    return (-(np.log10(params["lr"]) + 3) ** 2 - (params["dropout"] - 0.2)
            ** 2 + 0.01 * (params["hidden"] == 128)
            + 0.05 * (params["opt"] == "sgd"))


@pytest.mark.parametrize("search,kw", [
    ("random_search", dict(n_trials=12, seed=0)),
    ("random_search", dict(n_trials=5, seed=7)),
    ("tpe_search", dict(n_trials=20, seed=0)),
    ("tpe_search", dict(n_trials=14, n_startup=3, gamma=0.4, seed=5))])
def test_search_trials_equal_the_reference(tmp_path, search, kw):
    got = getattr(ps, search)(_space(ps), _score, base_path=tmp_path / "pt",
                              **kw)
    want = getattr(jps, search)(_space(jps), _score,
                                base_path=tmp_path / "jax", **kw)
    assert got == want
    assert len(got["trials"]) == kw["n_trials"]
    assert (tmp_path / "pt" / "param_search.json").read_bytes() == \
        (tmp_path / "jax" / "param_search.json").read_bytes()


def test_parzen_pick_equals_the_reference():
    for seed in range(5):
        rng = np.random.RandomState(seed)
        good, bad = rng.rand(3), rng.rand(seed + 1)
        a = ps._parzen_pick(np.random.RandomState(seed), good, bad, 0.0, 1.0)
        b = jps._parzen_pick(np.random.RandomState(seed), good, bad, 0.0,
                             1.0)
        assert a == b and 0.0 <= a <= 1.0
    assert ps._parzen_pick(np.random.RandomState(0), np.array([0.5]),
                           np.array([]), 0.0, 1.0) == jps._parzen_pick(
        np.random.RandomState(0), np.array([0.5]), np.array([]), 0.0, 1.0)


# -- HTML -----------------------------------------------------------------------------

def test_render_ner_html_is_byte_equal():
    from kbner_tpu.data.conll import SentenceRecord as JRecord

    rows = [(["Alice", "met", "<Bob>", "&", "Carol", "in", "Paris"],
             ["B-PER", "O", "S-PER", "O", "B-PER", "E-PER", "S-LOC"]),
            (["Acme", "Corp", "X"], ["B-ORG", "I-ORG", "X"]),
            (["no", "tags"], None)]
    got = html_viz.render_ner_html([SentenceRecord(
        tokens=t, tags={} if g is None else {"ner": g}) for t, g in rows])
    want = jhtml.render_ner_html([JRecord(
        tokens=t, tags={} if g is None else {"ner": g}) for t, g in rows])
    assert got.encode() == want.encode()
    assert "&lt;Bob&gt;" in got and got.count('class="ent"') == 5


# -- artifacts ------------------------------------------------------------------------

def test_cached_path_local_and_seeded(tmp_path, monkeypatch):
    f = tmp_path / "a.txt"
    f.write_text("x")
    assert artifacts.cached_path(f) == f
    with pytest.raises(FileNotFoundError):
        artifacts.cached_path(tmp_path / "missing.txt")
    url = "https://example.com/emb/vectors.vec"
    assert artifacts.url_to_filename(url) == jart.url_to_filename(url)
    (tmp_path / artifacts.url_to_filename(url)).write_text("2 2\na 1 2\n")
    assert artifacts.cached_path(url, cache_dir=tmp_path).read_text() == \
        "2 2\na 1 2\n"
    # a miss without the opt-in raises before any download is tried
    monkeypatch.delenv("KBNER_ALLOW_DOWNLOAD", raising=False)

    def no_network(*a, **k):
        raise AssertionError("the network was touched")

    import urllib.request
    monkeypatch.setattr(urllib.request, "urlopen", no_network)
    with pytest.raises(FileNotFoundError, match="Pre-seed"):
        artifacts.cached_path("https://example.com/nope.bin",
                              cache_dir=tmp_path)


def test_extract_archive(tmp_path):
    z = tmp_path / artifacts.url_to_filename("https://x/y/model.zip")
    with zipfile.ZipFile(z, "w") as f:
        f.writestr("inner/weights.txt", "w")
    out = artifacts.cached_path("https://x/y/model.zip", cache_dir=tmp_path,
                                extract=True)
    assert (out / "inner" / "weights.txt").read_text() == "w"
    assert artifacts.extract_archive(z) == out  # once only
    t = tmp_path / "m.tar.gz"
    src = tmp_path / "payload.txt"
    src.write_text("p")
    with tarfile.open(t, "w:gz") as f:
        f.add(src, arcname="payload.txt")
    assert (artifacts.extract_archive(t) / "payload.txt").read_text() == "p"
    with pytest.raises(ValueError, match="archive"):
        artifacts.extract_archive(src)


# -- progress and plots ---------------------------------------------------------------

def _progress(tmp_path):
    rows = [{"ts": 1000.0, "wall_s": 100.0, "round": 1},
            {"ts": 1600.0, "wall_s": 700.0, "round": 1},
            {"ts": 2000.0, "wall_s": 50.0, "round": 1},  # a new session
            {"ts": 2400.0, "wall_s": 450.0, "round": 1},
            {"ts": 3000.0, "wall_s": 1050.0, "round": 2},
            {"ts": 3500.0, "wall_s": 10.0, "round": 2}]
    p = tmp_path / "PROGRESS.jsonl"
    p.write_text("".join(json.dumps(r) + "\n" for r in rows) + "\n")
    return p


def test_progress_equals_the_reference(tmp_path, capsys):
    p = _progress(tmp_path)
    assert progress.read_progress(p) == jprog.read_progress(p)
    assert [r["session"] for r in progress.read_progress(p)] == \
        [0, 0, 1, 1, 1, 2]
    assert progress.round_wall_seconds(p) == jprog.round_wall_seconds(p) \
        == {1: 1000.0, 2: 0.0}
    progress.main([str(p)])
    got = capsys.readouterr().out
    jprog.main([str(p)])
    assert got == capsys.readouterr().out == \
        "round 1: 0.28 h\nround 2: 0.00 h\n"


def test_plotter_returns_none_without_matplotlib(tmp_path, monkeypatch):
    assert plotter.plot_training_curves(tmp_path) is None  # no history
    (tmp_path / "history.json").write_text(json.dumps(
        {"train_loss": [1.0, 0.5], "dev_score": [0.2, 0.4]}))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    assert plotter.plot_training_curves(tmp_path) is None
    assert plotter.plot_embedding_tsne(np.zeros((4, 3)), list("abab"),
                                       tmp_path / "t.png") is None
    assert not list(tmp_path.glob("*.png"))
