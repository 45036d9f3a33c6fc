"""What several per-layer metrics read alike. Each reader returns None
where its run holds nothing for it to read (no trace, no matching kernel,
no span), and the harness then leaves the metric out of the line."""
from __future__ import annotations

from portbench.lib import peaks


def share_of_peak(run, flops: float, seconds: float, dtype: str | None = None):
    """Percent of the card's peak for ``dtype`` (default the model's)."""
    if not seconds or not flops:
        return None
    return 100.0 * flops / seconds / peaks.FLOPS[dtype or run.model["dtype"]]


def mfu(run):
    """Model FLOPs the measured window completed over the window at peak."""
    w = run.window
    return share_of_peak(run, w.get("flops", 0.0), w["seconds"])


def idle_pct(run):
    """Percent of the traced slice in which no operation ran on the device."""
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)


def kernel_busy_s(run, patterns, within=None):
    """Device seconds of the kernels whose names match ``patterns``; None
    where none ran in the traced slice."""
    if run.trace is None:
        return None
    ops = run.trace.matching(patterns)
    if within is not None:
        ops = run.trace.ops_within(within, ops)
    if not ops:
        return None
    return run.trace.busy_s(ops)


def window_spans(run, name: str) -> list:
    """Durations in seconds of the spans ``name`` inside the window."""
    w = run.window
    return run.spans.durations(name, w["start"], w["stop"])
