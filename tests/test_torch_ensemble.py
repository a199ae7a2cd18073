"""The PyTorch port's majority-vote ensemble and its ``ensemble`` and
``evaluate`` commands against kbner_tpu's: the reference's cases,
random systems held equal to ``kbner_tpu.eval.ensemble``, and the CLI's
files and printed output byte for byte."""

import contextlib
import io

import numpy as np
import pytest

from kbner_tpu import cli as jcli
from kbner_tpu.eval import ensemble as jens
from kbner_tpu_torch import cli
from kbner_tpu_torch.eval.ensemble import (collect_votes,
                                           ensemble_predictions,
                                           select_spans, spans_to_bioes)

LABELS = ("PER", "LOC", "ORG", "X")


@pytest.mark.parametrize("systems,kw,want", [
    # unanimous agreement passes through
    ([[["B-PER", "E-PER", "O", "S-LOC"]]] * 3, {},
     [["B-PER", "E-PER", "O", "S-LOC"]]),
    # PER has 2 of 3 votes, LOC 1 < 1.5
    ([[["S-PER", "O", "O"]], [["S-PER", "O", "O"]], [["O", "O", "S-LOC"]]],
     {}, [["S-PER", "O", "O"]]),
    # votes tie at 2: the longer span wins, the overlapping one is dropped
    ([[["B-ORG", "I-ORG", "E-ORG"]]] * 2 + [[["O", "O", "S-ORG"]]] * 2, {},
     [["B-ORG", "I-ORG", "E-ORG"]]),
    ([[["S-PER"]], [["O"]], [["O"]]], {}, [["O"]]),
    ([[["S-PER"]], [["O"]], [["O"]]], {"threshold": 1}, [["S-PER"]]),
    # X (context) spans are ignored
    ([[["S-PER", "S-X"]], [["S-PER", "S-X"]]], {}, [["S-PER", "O"]]),
    ([], {}, []),
])
def test_reference_cases(systems, kw, want):
    assert ensemble_predictions(systems, **kw) == want
    assert jens.ensemble_predictions(systems, **kw) == want


def test_spans_and_greedy_selection():
    assert spans_to_bioes([(0, 2, "PER"), (3, 4, "LOC")], 5) == \
        ["B-PER", "E-PER", "O", "S-LOC", "O"]
    votes = {(0, 3, "ORG"): 3, (1, 2, "PER"): 3, (4, 5, "LOC"): 2}
    assert select_spans(votes, threshold=2) == [(0, 3, "ORG"), (4, 5, "LOC")]


def _random_tags(rng, n):
    """BIOES-ish tags with broken spans (lone I-, E- after O, label
    changes inside a span) as systems emit them."""
    kinds = np.array(["O", "B", "I", "E", "S"])
    return [("O" if k == "O" else f"{k}-{rng.choice(LABELS)}")
            for k in kinds[rng.randint(0, 5, size=n)]]


@pytest.mark.parametrize("seed", range(6))
def test_random_systems_equal_the_reference(seed):
    rng = np.random.RandomState(seed)
    n_sys = 1 + seed % 5
    lengths = rng.randint(1, 14, size=25)
    systems = [[_random_tags(rng, n) for n in lengths]
               for _ in range(n_sys)]
    for kw in ({}, {"threshold": 1}, {"threshold": n_sys},
               {"ignore_labels": ()}):
        assert ensemble_predictions(systems, **kw) == \
            jens.ensemble_predictions(systems, **kw)
    for i in range(len(lengths)):
        per = [s[i] for s in systems]
        assert dict(collect_votes(per)) == dict(jens.collect_votes(per))


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _write(path, rows, comment=True):
    with open(path, "w") as f:
        for i, sent in enumerate(rows):
            if comment:
                f.write(f"# id s-{i}\n")
            f.write("".join(" ".join(cols) + "\n" for cols in sent) + "\n")


def test_cli_ensemble_and_evaluate_equal_the_jax_cli(tmp_path):
    rng = np.random.RandomState(11)
    lengths = rng.randint(1, 12, size=30)
    tokens = [[f"w{j}" for j in range(n)] for n in lengths]
    gold = [_random_tags(rng, n) for n in lengths]
    files = []
    for s in range(3):
        # each system keeps most of the gold tags
        pred = [[g if rng.rand() < 0.7 else t for g, t in
                 zip(gs, _random_tags(rng, len(gs)))] for gs in gold]
        files.append(tmp_path / f"p{s}.conllu")
        _write(files[-1], [list(zip(t, p)) for t, p in zip(tokens, pred)])
    for extra in ([], ["--threshold", "1"]):
        out, jout = tmp_path / "ens.conll", tmp_path / "jens.conll"
        cli.main(["ensemble", *map(str, files), "--out", str(out), *extra])
        jcli.main(["ensemble", *map(str, files), "--out", str(jout), *extra])
        assert out.read_bytes() == jout.read_bytes()
    # evaluate the ensemble joined with gold, as 'token gold pred' lines
    ens = [line.split() for line in out.read_text().splitlines()
           if line and not line.startswith("#")]
    flat_gold = [g for gs in gold for g in gs]
    for comment in (False, True):
        joined = tmp_path / f"gold_pred{int(comment)}.tsv"
        it = iter(zip(ens, flat_gold))
        _write(joined, [[(tok, g, p) for (tok, p), g in
                         (next(it) for _ in range(n))] for n in lengths],
               comment=comment)
        got = _run(cli.main, ["evaluate", str(joined)])
        assert got == _run(jcli.main, ["evaluate", str(joined)])
        assert '"micro_f1"' in got.splitlines()[-1]
