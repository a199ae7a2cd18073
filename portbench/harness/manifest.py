"""Checks of ``BENCHMARK.json`` against the benchmark's format, and of the
files that its names point to: a metric's reader ``metrics/<name>.py``
(whose declared unit, source, layer and moved metric agree with its
entry), a cell's traffic ``traffic/<traffic>.json`` with a module for its
``kind`` under ``harness/kinds/``, its limits ``limits/<cell>.json``, a
configuration's file."""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import List

from .cell import REPO, ROOT, load_file_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"host_clock", "device_trace"}


def _line(s) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def validate(bench: dict, repo: Path = REPO, root: Path = ROOT) -> List[str]:
    """Every fault found; empty when the manifest holds."""
    err: List[str] = []
    keys = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
    if set(bench) != keys:
        err.append(f"top-level keys {sorted(bench)}")
        return err
    if not 1 <= bench["run_seconds"] <= 51 or \
            int(bench["run_seconds"]) != bench["run_seconds"]:
        err.append(f"run_seconds {bench['run_seconds']}")
    names = set()

    def named(kind, entry, allowed):
        extra = set(entry) - allowed
        if extra:
            err.append(f"{kind} {entry.get('name')}: keys {sorted(extra)}")
        n = entry.get("name", "")
        if not NAME.match(n):
            err.append(f"{kind} name {n!r}")
        if (kind, n) in names:
            err.append(f"{kind} {n} twice")
        names.add((kind, n))

    for c in bench["configs"]:
        named("config", c, {"name", "source", "file", "reduced", "why"})
        if not _line(c.get("source")) or not _line(c.get("why")):
            err.append(f"config {c['name']}: source or why")
        if not (repo / c["file"]).is_file():
            err.append(f"config {c['name']}: no file {c['file']}")
        for k in c.get("reduced", []):
            if not NAME.match(k):
                err.append(f"config {c['name']}: reduced key {k!r}")
    cfgs = {c["name"] for c in bench["configs"]}
    pairs = set()
    for w in bench["workloads"]:
        named("workload", w, {"name", "config", "traffic", "chips", "why"})
        if w["config"] not in cfgs:
            err.append(f"workload {w['name']}: config {w['config']}")
        if w["chips"] not in (1, 4):
            err.append(f"workload {w['name']}: chips {w['chips']}")
        if not _line(w.get("why")) or not NAME.match(w["traffic"]):
            err.append(f"workload {w['name']}: why or traffic")
        if (w["config"], w["traffic"]) in pairs:
            err.append(f"workload {w['name']}: pair twice")
        pairs.add((w["config"], w["traffic"]))
        tf = root / "traffic" / f"{w['traffic']}.json"
        if not tf.is_file():
            err.append(f"workload {w['name']}: no {tf.name}")
        else:
            kind = json.loads(tf.read_text()).get("kind", "")
            if not (root / "harness" / "kinds" / f"{kind}.py").is_file():
                err.append(f"traffic {w['traffic']}: no module for kind "
                           f"{kind!r}")
        if not (root / "limits" / f"{w['name']}.json").is_file():
            err.append(f"workload {w['name']}: no limits")
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    if "setup_s" not in e2e:
        err.append("no setup_s")
    for group, allowed in (("end_to_end", {"name", "unit", "better", "bound",
                                           "source", "workloads"}),
                           ("per_layer", {"name", "unit", "better", "source",
                                          "layer", "moves", "workloads"})):
        for m in bench[group]:
            named("metric", m, allowed)
            if not UNIT.match(m.get("unit", "")):
                err.append(f"metric {m['name']}: unit {m.get('unit')!r}")
            if m.get("better") not in ("lower", "higher"):
                err.append(f"metric {m['name']}: better")
            ok = E2E_SOURCES if group == "end_to_end" else SOURCES
            if m.get("source") not in ok:
                err.append(f"metric {m['name']}: source {m.get('source')}")
            if group == "end_to_end" and not 0.01 <= m["bound"] <= 0.25:
                err.append(f"metric {m['name']}: bound {m['bound']}")
            for c in m.get("workloads", []):
                if c not in cells:
                    err.append(f"metric {m['name']}: no cell {c}")
            if group == "per_layer":
                if m.get("moves") not in e2e or not _line(m.get("layer")):
                    err.append(f"metric {m['name']}: moves or layer")
                elif "workloads" in e2e[m["moves"]]:
                    for c in m.get("workloads", cells):
                        if c not in e2e[m["moves"]]["workloads"]:
                            err.append(f"metric {m['name']}: {c} does not "
                                       f"report {m['moves']}")
            path = root / "metrics" / f"{m['name']}.py"
            if not path.is_file():
                err.append(f"metric {m['name']}: no reader")
                continue
            mod = load_file_module(path)
            want = {"UNIT": m.get("unit"), "SOURCE": m.get("source"),
                    "BETTER": m.get("better")}
            if group == "per_layer":
                want.update(LAYER=m.get("layer"), MOVES=m.get("moves"))
            for attr, v in want.items():
                if getattr(mod, attr, None) != v:
                    err.append(f"metric {m['name']}: {attr} "
                               f"{getattr(mod, attr, None)!r} != {v!r}")
    return err
