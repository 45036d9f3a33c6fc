"""Spans of the port's own layers, kept in memory while a profiler records.

``span(name, **attrs)`` opens a span: a ``Record`` with its id, the id of
the span open around it (``parent``, None at the top), its name, its start
and end on ``time.perf_counter_ns()`` and its attributes. ``take()`` returns
the finished records and empties the store.

The tracer is live only while a ``torch.profiler`` records
(``torch.autograd.profiler._is_profiler_enabled``): to trace the port,
profile it. There is no other switch. Off, ``span`` reads that one flag and
returns one shared null context: no allocation, no torch call. Spans emit
no ``record_function`` range, so the profiler's own trace is unchanged;
a reader places them on the trace's clock by its own ranges.

One thread: the stack of open spans is the process's.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import NamedTuple

from torch.autograd import profiler as _profiler

__all__ = ["Record", "live", "span", "take"]


class Record(NamedTuple):
    id: int
    parent: int | None
    name: str
    start: int  # ns, time.perf_counter_ns
    end: int
    attrs: dict


_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_open: list = []  # ids of the spans open now, innermost last
_records: list = []


def live() -> bool:
    """True while a profiler records, so spans and counters are kept."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "start")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        _records.append(Record(self.id, self.parent, self.name, self.start, end, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` around its body while the
    tracer is live; otherwise the shared null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name, attrs)


def take() -> list:
    """The finished records, oldest first; the store is emptied."""
    out = _records[:]
    del _records[: len(out)]
    return out
