"""Spans of the program's own stages: named host intervals with counts.

    from kbner_tpu_torch.utils import spans

    spans.enable()
    serve(...)                      # or train_step(...)
    spans.disable()
    for s in spans.collect():       # in the order they opened
        s.name, s.start, s.end, s.parent, s.unit, s.counts

:func:`span` opens one: ``with span("kbner.tag.encode") as s:``, counts
given at entry (``span(name, rows=4)``), added inside (``s.add(key, n)``)
or from deeper code (``current().add(key, n)``). Off, the default, it is
one flag test that returns a shared no-op, which is falsy, so ``if s:
s.add(...)`` computes a count only when it is kept. On, a span keeps its
name, its start and end on ``time.perf_counter_ns()``, the index of the
span it opened inside (None for a root) and its unit: the number of its
root among the roots since the last :func:`collect` (a serve micro-batch,
a training step). While a ``torch.profiler`` is active, a kept span also
opens a ``record_function`` range of its name, so it lies on the
profiler's timeline beside the kernels it launched and names the host's
stage there.

A span never waits for the device: counts come from host values, and the
only waits are the program's own pulls, which have spans of their own.
:func:`timed` is a span that reads the clock even when off, for a caller
that reports a stage's seconds itself (``serve(timings=)``), so that the
stage reads the clock in one place.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

_on = False
_kept: List["Span"] = []
_roots = 0
_local = threading.local()  # each thread's open spans
_lock = threading.Lock()
_profiler = None  # torch.autograd.profiler, imported by enable()


class Span:
    """One stage's interval on the host clock, with its counts."""

    __slots__ = ("name", "start", "end", "parent", "unit", "counts", "_keep",
                 "_index", "_range")

    def __init__(self, name: str, counts: Dict[str, int], keep: bool):
        self.name = name
        self.counts = counts
        self.start = self.end = 0
        self.parent: Optional[int] = None
        self.unit: Optional[int] = None
        self._keep = keep
        self._range = None

    def __bool__(self) -> bool:
        return self._keep

    def add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + int(n)

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9

    def __enter__(self) -> "Span":
        if self._keep:
            global _roots
            stack = _stack()
            with _lock:  # threads share the list and the root numbers
                if stack:
                    self.parent = stack[-1]._index
                    self.unit = stack[-1].unit
                else:
                    self.unit = _roots
                    _roots += 1
                self._index = len(_kept)
                _kept.append(self)
            stack.append(self)
            if _profiler._is_profiler_enabled:
                self._range = _profiler.record_function(self.name)
                self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end = time.perf_counter_ns()
        if self._keep:
            if self._range is not None:
                self._range.__exit__(*exc)
                self._range = None
            _stack().pop()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.seconds * 1e3:.3f} ms, "
                f"parent={self.parent}, unit={self.unit}, {self.counts})")


class _Off:
    """The span of a run that keeps none."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def add(self, key: str, n: int) -> None:
        pass


_OFF = _Off()


def _stack() -> List[Span]:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def span(name: str, **counts: int):
    """A stage's span (kept only while spans are enabled)."""
    if not _on:
        return _OFF
    return Span(name, counts, True)


def current():
    """The innermost kept span open on this thread (the shared no-op when
    none is), for a count known only deep inside its stage."""
    if not _on:
        return _OFF
    stack = _stack()
    return stack[-1] if stack else _OFF


def timed(name: str, **counts: int) -> Span:
    """A span that reads the clock whether kept or not (its ``seconds``
    after the block)."""
    return Span(name, counts, _on)


def enable() -> bool:
    """Keep spans from now on; True if this turned them on."""
    global _on, _profiler
    from torch.autograd import profiler

    _profiler = profiler
    was, _on = _on, True
    return not was


def disable() -> None:
    global _on
    _on = False


def collect() -> List[Span]:
    """The kept spans, in the order they opened, and forget them; call it
    between units (a span's ``parent`` indexes the list it is in)."""
    global _kept, _roots
    with _lock:
        out, _kept, _roots = _kept, [], 0
    return out
