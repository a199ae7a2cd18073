"""On the card: the control (the reference one precision below bfloat16)
fails the cell's own limits at the cell's own size, on three seeds. Run
with ``python -m pytest portbench/tests -m cuda`` on a machine with a
card."""

import time

import pytest

from portbench.harness import cell as cells
from portbench.harness import control

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["large.serve.exh", "base.serve.exh"])
def test_the_serve_control_fails(card, workload):
    bench = cells.manifest()
    for seed in SEEDS:
        c = cells.make_cell(bench, workload, seed, 0.0, False,
                            time.perf_counter())
        got = control.serve_control(c)
        assert any(v > c.limits[k] for k, v in got.items()), (seed, got)


@pytest.mark.cuda
def test_the_training_control_and_fault_fail(card):
    bench = cells.manifest()
    for seed in SEEDS:
        c = cells.make_cell(bench, "large.finetune.b16", seed, 0.0, False,
                            time.perf_counter())
        got = control.train_control(c)
        for label, numbers in got.items():
            assert any(v > c.limits[k] for k, v in numbers.items()), (
                seed, label, numbers)
