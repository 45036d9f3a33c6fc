"""Host spans and the device trace of a traced slice, reduced to what the
per-layer metrics read.

``Spans`` keeps the benchmark's own spans around calls into the program in
memory, on the host's clock. Inside a traced slice each span is also a
profiler range named ``pb:<name>``, so the device's operations and the
host's spans share one clock there. ``record`` runs a slice under
``torch.profiler`` (host and device activity), keeps the trace in memory
and reduces it to ``Trace``: the device operations and the ranges, nothing
written to disk.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import time

PREFIX = "pb:"
SLICE = "loop"


class Spans:
    """(name, start, end) on ``time.perf_counter``, in memory."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self.annotate = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        if self.annotate:
            import torch

            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.records.append((name, t, time.perf_counter()))

    def durations(self, name: str, since: float = float("-inf"), until: float = float("inf")):
        return [e - s for n, s, e in self.records if n == name and s >= since and e <= until]


@dataclasses.dataclass
class Trace:
    """A traced slice: device operations and ``pb:`` ranges as
    (name, start_ns, end_ns), and the slice's own range."""

    ops: list
    ranges: list
    start_ns: int
    end_ns: int

    @property
    def window_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def kernels(self):
        """Device operations but copies and fills."""
        return [o for o in self.ops if not o[0].startswith(("Memcpy", "Memset"))]

    def matching(self, patterns) -> list:
        rxs = [re.compile(p) for p in patterns]
        return [o for o in self.kernels() if any(rx.search(o[0]) for rx in rxs)]

    def ranges_named(self, name: str) -> list:
        return [(s, e) for n, s, e in self.ranges if n == name]

    def busy_s(self, ops=None, within=None) -> float:
        """Seconds in which at least one of ``ops`` (default: every device
        operation) ran, inside ``within`` (a list of (start_ns, end_ns);
        default the slice)."""
        merged = _Merged(self.ops if ops is None else ops)
        spans = within if within is not None else [(self.start_ns, self.end_ns)]
        return sum(merged.covered(s, e) for s, e in spans) / 1e9

    def ops_within(self, spans, ops=None) -> list:
        """Operations that start inside one of ``spans``."""
        spans = sorted(spans)
        starts = [s for s, _ in spans]
        out = []
        for o in self.kernels() if ops is None else ops:
            i = bisect.bisect_right(starts, o[1]) - 1
            if i >= 0 and o[1] < spans[i][1]:
                out.append(o)
        return out

    def top_ops(self, k: int = 10) -> list:
        total: dict[str, float] = {}
        for n, s, e in self.ops:
            total[n] = total.get(n, 0.0) + (e - s) / 1e9
        return [[n, t] for n, t in sorted(total.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """Device idle seconds in the slice, summed by the innermost span
        the host had open at the time (``loop``: the harness's own loop
        between spans)."""
        merged = _Merged(self.ops)
        bounds = []
        for n, s, e in self.ranges:
            bounds.append((max(s, self.start_ns), 1, n))
            bounds.append((min(e, self.end_ns), 0, n))
        bounds.sort(key=lambda b: (b[0], b[1]))
        stack, idle, t = [], {}, self.start_ns
        for at, opening, n in bounds:
            if at > t and stack:
                gap = (at - t) - merged.covered(t, at)
                idle[stack[-1]] = idle.get(stack[-1], 0.0) + gap / 1e9
            t = max(t, at)
            if opening:
                stack.append(n)
            elif n in stack:
                del stack[len(stack) - 1 - stack[::-1].index(n)]
        return [[n, s] for n, s in sorted(idle.items(), key=lambda x: -x[1])[:k] if s > 0]


class _Merged:
    """The union of operations' intervals, as disjoint sorted intervals."""

    def __init__(self, ops):
        self.spans = []
        for s, e in sorted((s, e) for _, s, e in ops):
            if self.spans and s <= self.spans[-1][1]:
                self.spans[-1][1] = max(self.spans[-1][1], e)
            else:
                self.spans.append([s, e])
        self.starts = [s for s, _ in self.spans]

    def covered(self, lo, hi) -> int:
        """Nanoseconds of [lo, hi) that the union covers."""
        if hi <= lo:
            return 0
        total = 0
        for s, e in self.spans[max(bisect.bisect_right(self.starts, lo) - 1, 0):]:
            if s >= hi:
                break
            total += max(0, min(e, hi) - max(s, lo))
        return total


def _events(prof):
    """(name, on_device, start_ns, end_ns) of every event of the trace."""
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None or not hasattr(res, "events"):
        raise RuntimeError("the profiler keeps no kineto_results: its trace cannot be read")
    for e in res.events():
        s = e.start_ns()
        yield e.name(), "CUDA" in str(e.device_type()), s, s + e.duration_ns()


def record(fn, spans: Spans, device):
    """Run ``fn()`` inside a ``pb:loop`` range under the profiler, the
    card's activity with the host's where ``device`` is a card; returns
    (fn's result, ``Trace``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    if cuda:
        torch.cuda.synchronize(device)
    spans.annotate = True
    try:
        with profile(activities=activities) as prof:
            with spans(SLICE):
                out = fn()
                if cuda:
                    torch.cuda.synchronize(device)
    finally:
        spans.annotate = False
    ops, ranges = [], []
    for name, on_device, s, e in _events(prof):
        if name.startswith(PREFIX):
            if not on_device:  # the device's copy of a range is no operation
                ranges.append((name[len(PREFIX):], s, e))
        elif on_device:
            ops.append((name, s, e))
    loop = [r for r in ranges if r[0] == SLICE]
    if not loop:
        raise RuntimeError("the trace holds no pb:loop range: the profiler recorded no host ranges")
    _, start, end = loop[0]
    ops = [o for o in ops if o[2] > start and o[1] < end]
    return out, Trace(ops=ops, ranges=ranges, start_ns=start, end_ns=end)
