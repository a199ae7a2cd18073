"""``portbench/spans_probe.py`` end to end at ``bench_tiny``'s size on the
CPU: the program's span tree of each kind, its counts, and what the
profiled slice names."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("workload,spans,root,names", [
    ("large.serve.exh", 15, "kbner.serve.batch",
     {"kbner.tag.encode", "kbner.tag.crf", "kbner.retrieve.score"}),
    ("large.finetune.b16", 8, "kbner.train.step",
     {"kbner.train.forward", "kbner.train.backward", "kbner.optim.update"}),
])
def test_probe_reads_the_program_spans(tmp_path, workload, spans, root,
                                       names):
    res = subprocess.run(
        [sys.executable, str(REPO / "portbench" / "spans_probe.py"),
         "--workload", workload, "--seed", str(2**31 + 9), "--blocks", "2",
         "--block", "2", "--tiny", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads((tmp_path / f"{workload}-{2**31 + 9}.json")
                     .read_text())
    assert out["units_off"] == out["units_on"] == 4
    assert out["spans_per_unit"] == spans
    assert names <= set(out["span_ms_per_unit"])
    assert 0.9 < out["coverage"][root]["share"] <= 1.0
    assert 0 < out["pad_pct"] < 100
    # the CPU has no device timeline: every idle second is named by a span
    prof = out["profiled"]
    assert prof["busy_s"] == 0
    assert set(prof["idle_by_span"]) <= set(out["span_ms_per_unit"])
