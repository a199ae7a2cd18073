"""Per-round wall-clock from a ``PROGRESS.jsonl`` log (counterpart of
``kbner_tpu/utils/progress.py``).

Each record carries ``ts`` (absolute seconds), ``wall_s`` (the writing
session's own clock, which restarts at zero with every new session) and
``round``. Summing or differencing ``wall_s`` across sessions would count
twice or go negative, so sessions are told apart where ``wall_s``
decreases, and a round's wall-clock is the sum over its sessions of each
one's ``ts`` span. ``python -m kbner_tpu_torch.utils.progress
[PROGRESS.jsonl]`` prints hours per round.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List


def read_progress(path: str | Path) -> List[dict]:
    """Parse PROGRESS.jsonl and annotate each record with a ``session``
    id (increments whenever ``wall_s`` decreases — a new session) and
    ``session_wall_s`` (wall_s rebased to the session's first record, so
    in-session deltas are directly comparable)."""
    records: List[dict] = []
    session = 0
    prev_wall = None
    base = 0.0
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            r = json.loads(line)
            if prev_wall is not None and r["wall_s"] < prev_wall:
                session += 1
                base = r["wall_s"]
            elif prev_wall is None:
                base = r["wall_s"]
            prev_wall = r["wall_s"]
            r = dict(r)
            r["session"] = session
            r["session_wall_s"] = r["wall_s"] - base
            records.append(r)
    return records


def round_wall_seconds(path: str | Path) -> Dict[int, float]:
    """Per-round wall-clock seconds, computable without double counting:
    within each (round, session) group the absolute ``ts`` span is
    summed — session restarts neither reset nor double-count, and the
    downtime between sessions is excluded."""
    spans: Dict[tuple, List[float]] = {}
    for r in read_progress(path):
        key = (int(r["round"]), r["session"])
        ts = float(r["ts"])
        if key not in spans:
            spans[key] = [ts, ts]
        else:
            spans[key][0] = min(spans[key][0], ts)
            spans[key][1] = max(spans[key][1], ts)
    out: Dict[int, float] = {}
    for (rnd, _sess), (lo, hi) in spans.items():
        out[rnd] = out.get(rnd, 0.0) + (hi - lo)
    return out


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Summarize PROGRESS.jsonl per round (session-safe)")
    ap.add_argument("path", nargs="?", default="PROGRESS.jsonl")
    args = ap.parse_args(argv)
    per_round = round_wall_seconds(args.path)
    for rnd in sorted(per_round):
        print(f"round {rnd}: {per_round[rnd] / 3600.0:.2f} h")


if __name__ == "__main__":
    main()
