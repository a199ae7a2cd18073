"""Spans and the profiled slices of a traced run.

Spans are the benchmark's own: ``torch.profiler.record_function`` ranges
named ``portbench.<layer>`` that :func:`wrapped` opens around the program's
calls into a layer, installed for the traced slices only. :func:`profile`
runs two slices under ``torch.profiler`` and reduces them to what the
per-layer metrics read: the device's busy seconds over the first (device
activity alone), each kernel's time and launches, the device time of the
kernels launched under each span in the second (host and device
activity), and the breakdown (the device operations that took most time,
and the longest idle gaps named by the benchmark span open on the host at
the time).
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, record_function

PREFIX = "portbench."
SLICE = PREFIX + "slice"


@contextlib.contextmanager
def wrapped(targets: List[Tuple[object, str, str]]):
    """Within the block, each ``(owner, attribute, span)`` call goes through
    a ``record_function(portbench.<span>)`` range; restored on exit."""
    saved = []
    for owner, attr, span in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, owner.__dict__.get(attr, _MISSING)))

        def call(*a, _fn=fn, _name=PREFIX + span, **kw):
            with record_function(_name):
                return _fn(*a, **kw)

        setattr(owner, attr, call)
    try:
        yield
    finally:
        for owner, attr, old in reversed(saved):
            if old is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)


_MISSING = object()


def _device(events):
    """The device's own operations (the device timeline also carries the
    spans' annotation ranges, which are not work)."""
    return [e for e in events if e.device_type != DeviceType.CPU
            and not e.name.startswith(PREFIX)]


def _merged(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(i for i in intervals if i[1] > i[0]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The reduced trace of a traced run: ``units`` batches or steps
    profiled for the device alone (busy seconds, the window's host-clock
    length, each kernel's time), then as many again with host operations
    and the benchmark's spans (the device time under each span, and the
    idle gaps named by what the host was in). The host's operators cost
    the profiler time of their own, so the idle share is read from the
    first slice only."""

    def __init__(self, dev_events, window_s: float, span_events,
                 units: int):
        self.units = units
        self.window_s = window_s
        self.kernels: Dict[str, List[float]] = defaultdict(list)
        for e in _device(dev_events):
            self.kernels[e.name].append(e.time_range.elapsed_us() / 1e6)
        self.busy_s = sum(b - a for a, b in _merged(
            (e.time_range.start, e.time_range.end)
            for e in _device(dev_events))) / 1e6
        cpu = [e for e in span_events if e.device_type == DeviceType.CPU]
        self.under: Dict[str, float] = defaultdict(float)
        for e in cpu:
            if e.name.startswith(PREFIX):
                self.under[e.name[len(PREFIX):]] += e.device_time_total / 1e6
        outer = [e for e in cpu if e.name == SLICE]
        lo, hi = ((outer[0].time_range.start, outer[0].time_range.end)
                  if outer else (0.0, 0.0))
        merged = _merged((max(e.time_range.start, lo), min(e.time_range.end,
                                                           hi))
                         for e in _device(span_events))
        # idle gaps, named by the innermost benchmark span (and host
        # operator) open at their midpoint
        gaps, last = [], lo
        for a, b in merged + [[hi, hi]]:
            if a > last:
                gaps.append((last, a))
            last = max(last, b)
        named = _Intervals(e for e in cpu if e.name.startswith(PREFIX)
                           and e.name != SLICE)
        ops = _Intervals(e for e in cpu if not e.name.startswith(PREFIX))
        self.gaps: Dict[str, float] = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:50]:
            mid = (a + b) / 2
            span, op = named.at(mid), ops.at(mid)
            name = span[len(PREFIX):] if span else "outside spans"
            if op is not None:
                name += " / " + op
            self.gaps[name] += (b - a) / 1e6

    def kernel(self, pattern: str) -> Tuple[float, int]:
        """(seconds, launches) of the kernels whose name holds
        ``pattern``."""
        hit = [t for name, ts in self.kernels.items() if pattern in name
               for t in ts]
        return sum(hit), len(hit)

    def breakdown(self) -> dict:
        ops = sorted(((name, sum(ts)) for name, ts in self.kernels.items()),
                     key=lambda x: -x[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


class _Intervals:
    """Host ranges sorted by start; :meth:`at` names the latest-starting
    one that covers a time (the innermost, where ranges nest)."""

    def __init__(self, events):
        rows = sorted((e.time_range.start, e.time_range.end, e.name)
                      for e in events)
        self.starts = [r[0] for r in rows]
        self.rows = rows

    def at(self, t: float, look: int = 4000):
        i = bisect.bisect_right(self.starts, t)
        for j in range(i - 1, max(i - 1 - look, -1), -1):
            if self.rows[j][1] >= t:
                return self.rows[j][2]
        return None


def profile(body: Callable[[], int], sync: Callable[[], None]) -> Trace:
    """Profile two calls of ``body`` (each runs the next slice of the
    cell's work and returns its units): the first for the device alone,
    timed on the host clock between syncs; the second with host operations
    too, inside the ``portbench.slice`` span."""
    cuda = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    sync()
    with torch.profiler.profile(activities=cuda or
                                [ProfilerActivity.CPU]) as first:
        t0 = time.perf_counter()
        units = body()
        sync()
        window_s = time.perf_counter() - t0
    dev = first.events() if cuda else []
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU] + cuda) as second:
        with record_function(SLICE):
            body()
            sync()
    return Trace(dev, window_s, second.events(), units)
