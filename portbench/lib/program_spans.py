"""The program's own spans and counters (``repro_torch.tracing``) of a
traced slice, and their place on the device trace's clock.

The program keeps its records only while a profiler records, so a run
holds them for its traced slice alone. ``records`` takes them from the
program once a run, keeps those inside the slice (``run.traced``'s
``start``–``stop``, on the same ``perf_counter`` clock) and caches them on
``run.state``. A program without the tracer gives none, and every reader
of them then returns None.

``on_trace`` places records on the trace's clock: each lies inside one of
the benchmark's ``step`` spans (``run.spans``), and that span's ``pb:step``
range in the trace, paired in order, gives the offset between the clocks,
taken at the midpoints of the two.
"""
from __future__ import annotations

import bisect

KEY = "program_spans"


def records(run) -> list:
    """The program's records inside the traced slice, oldest first."""
    if KEY not in run.state:
        recs = []
        if run.traced is not None:
            try:
                from repro_torch import tracing
            except ImportError:  # a program that keeps no spans of its own
                tracing = None
            if tracing is not None:
                lo, hi = run.traced["start"] * 1e9, run.traced["stop"] * 1e9
                recs = [r for r in tracing.take() if r.start >= lo and r.end <= hi]
        run.state[KEY] = recs
    return run.state[KEY]


def named(run, name: str) -> list:
    return [r for r in records(run) if r.name == name]


def seconds(recs) -> float:
    return sum(r.end - r.start for r in recs) / 1e9


def on_trace(run, recs) -> list:
    """(start_ns, end_ns) of each of ``recs`` on the trace's clock; records
    outside every benchmark ``step`` span are left out."""
    lo, hi = run.traced["start"], run.traced["stop"]
    steps = [(s, e) for n, s, e in run.spans.records if n == "step" and s >= lo and e <= hi]
    ranges = run.trace.ranges_named("step")
    if len(steps) != len(ranges):
        raise RuntimeError(f"{len(steps)} step spans in the slice against {len(ranges)} "
                           "pb:step ranges in its trace: the clocks cannot be paired")
    starts = [s for s, _ in steps]
    out = []
    for r in recs:
        i = bisect.bisect_right(starts, r.start / 1e9) - 1
        if i < 0 or r.end / 1e9 > steps[i][1]:
            continue
        (s, e), (rs, re) = steps[i], ranges[i]
        offset = (rs + re) / 2 - (s + e) / 2 * 1e9
        out.append((r.start + offset, r.end + offset))
    return out
