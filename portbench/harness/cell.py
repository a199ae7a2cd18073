"""One run of one cell: the manifest's entries found by name, the cell's
kind run, its metrics read, its outputs judged.

A traffic file's ``kind`` names the module under ``harness/kinds/`` that
drives it; a metric's name names its reader under ``metrics/``; a cell's
name names its limits under ``limits/``. A later cell, mix or metric is
files and entries, with no file here to edit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[1]  # the benchmark's folder
REPO = ROOT.parent


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_file_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    return load_file_module(ROOT / "metrics" / f"{name}.py")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t_start: float = dataclasses.field(default_factory=time.perf_counter)
    cache: Path = ROOT / ".cache"  # the KB's files, once a checkout

    def sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()


def manifest(path: Path = REPO / "BENCHMARK.json") -> dict:
    return json.loads(path.read_text())


def make_cell(bench: dict, workload: str, seed: int, seconds: float,
              trace: bool, t_start: float, device: str = "cuda") -> Cell:
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         "BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = json.loads((REPO / cfg_entry["file"]).read_text())
    traffic = json.loads((ROOT / "traffic" / f"{wl['traffic']}.json")
                         .read_text())
    limits = json.loads((ROOT / "limits" / f"{workload}.json").read_text())
    return Cell(workload, config, traffic, limits, seed, seconds, trace,
                device=device, t_start=t_start)


def cell_metrics(bench: dict, workload: str, trace: bool):
    """The metrics this cell reports: its end-to-end metrics in an untraced
    run, its per-layer metrics in a traced one."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def run(cell: Cell, bench: dict) -> dict:
    """Drive the cell; returns the result object (without printing)."""
    kind = importlib.import_module(
        f"portbench.harness.kinds.{cell.traffic['kind']}")
    ctx = kind.run(cell)
    metrics = {}
    for m in cell_metrics(bench, cell.name, cell.trace):
        value = metric_module(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in ctx["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct and ctx["failed"] == 0),
           "attempted": ctx["attempted"], "failed": ctx["failed"],
           "metrics": metrics, "device": ctx["device"]}
    if cell.trace and "trace" in ctx:
        tr = ctx["trace"]
        out["device"]["busy_s"] = tr.busy_s
        out["device"]["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    out["_ctx"] = ctx
    return out
