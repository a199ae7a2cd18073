"""The roofline and FLOP counts against hand-worked numbers."""

import json
from pathlib import Path

import pytest

from portbench.harness import peaks, weights
from portbench.harness.kinds import finetune_fused, serve_backlog
from portbench.rooflines import bm25_score

LARGE = json.loads((Path(__file__).resolve().parents[1] / "configs"
                    / "xlmr-large-kb1m.json").read_text())["model"]


def test_k1_bound_at_the_serve_shape():
    # K1 at the serve shape: Q=32, Lq=64, [Ld=52, N=1,000,448] int32 +
    # float32, 21,156,250 non-pad slots: 544.3 MB and 0.677 G lookups
    n = bm25_score.need(32, 64, 52, 1_000_448, 21_156_250)
    assert n["bytes"] == 32 * 64 * 8 + 52 * 1_000_448 * 8 + 32 * 1_000_448 * 4
    assert n["bytes"] / 1e6 == pytest.approx(544.3, abs=0.05)
    assert n["lookups"] / 1e9 == pytest.approx(0.677, abs=0.0005)
    t = bm25_score.least_seconds(32, 64, 52, 1_000_448, 21_156_250)
    assert t == pytest.approx(n["bytes"] / peaks.HBM_BYTES_PER_S)
    assert t * 1e3 == pytest.approx(0.1625, abs=0.0001)


def test_non_embedding_parameters_of_xlmr_large():
    per_layer = 4 * (1024 * 1024 + 1024) + 2 * 1024 * 4096 + 4096 + 1024 \
        + 4 * 1024
    n = weights.non_embedding_params(LARGE, 27)
    assert n == 24 * per_layer + 2 * 1024 + 27 * 1024 + 27 + 27 * 27


def test_training_flops_of_the_smoke_padded_step():
    # 6 N B S + 12 L B S^2 H at B = 16, S = 496 (the smoke's step): 1.556e13
    f = finetune_fused.train_flops(LARGE, 19, [496] * 16)
    assert f == pytest.approx(1.556e13, rel=5e-4)


def test_serve_flops_count_each_row_as_it_is():
    lens = [512, 100]
    n = weights.non_embedding_params(LARGE, 27)
    f = serve_backlog.forward_flops(LARGE, 27, lens)
    assert f == 2 * n * 612 + 4 * 24 * 1024 * (512 ** 2 + 100 ** 2)
