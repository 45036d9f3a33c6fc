"""The program's own spans (``repro_torch.tracing``) as the benchmark reads
them: kept to the traced slice, placed on the device trace's clock through
the benchmark's ``step`` spans and their ``pb:step`` ranges, and reduced
by the five readers that use them; then a traced tiny serving run on the
CPU, whose trace holds no device operation."""
import sys
import time
import types

import pytest
import repro_torch
import torch
from conftest import tiny_cell

from portbench.lib import harness
from portbench.lib import manifest as mf
from portbench.lib import program_spans as ps
from portbench.lib.trace import Spans, Trace
from repro_torch import tracing

HOST0 = 100.0  # s, the host clock at the synthetic slice's origin
SHIFT = 1_000_000_000_000  # ns, the trace's clock less the host's


def host_ns(us):
    return round(HOST0 * 1e9) + us * 1000


def host_s(us):
    return HOST0 + us * 1e-6


def trace_ns(us):
    return host_ns(us) + SHIFT


# (id, parent, name, start us, end us, attrs) on the host clock; the first
# lies before the slice and is left out
RECORDS = [
    (1, None, "engine.decode", -50, -40, {"pages_live": 100, "pages_walked": 100}),
    (2, None, "engine.step", 12, 48, {"step": 0}),
    (3, 2, "engine.prefill", 13, 20, {"rid": 7}),
    (4, 2, "engine.decode", 21, 47, {"pages_live": 6, "pages_walked": 16}),
    (5, 4, "decode.pages", 22, 30, {}),
    (6, 4, "decode.pages", 31, 39, {}),
    (7, 4, "decode.fetch", 40, 47, {}),
    (8, None, "engine.step", 62, 98, {"step": 1}),
    (9, 8, "engine.decode", 63, 97, {"pages_live": 10, "pages_walked": 16}),
    (10, 9, "decode.pages", 64, 72, {}),
    (11, 9, "decode.pages", 73, 81, {}),
    (12, 9, "decode.fetch", 82, 96, {}),
]
# the benchmark's step spans on the host clock (one before the slice), and
# their pb:step ranges in the trace, each a microsecond inside at both ends
STEPS = [(-80, -20), (10, 50), (60, 100)]
RANGES = [("loop", 5, 105), ("step", 11, 49), ("step", 61, 99)]
# device operations: 4 + 2 us inside the first step's pages, all 16 us of
# the second's
OPS = [("k1", 20, 26), ("k2", 33, 35), ("k3", 60, 90)]


def synthetic_run(monkeypatch):
    recs = [tracing.Record(i, p, n, host_ns(s), host_ns(e), a) for i, p, n, s, e, a in RECORDS]
    monkeypatch.setattr(tracing, "take", lambda: list(recs))
    spans = Spans()
    spans.records = [("step", host_s(s), host_s(e)) for s, e in STEPS]
    trace = Trace(ops=[(n, trace_ns(s), trace_ns(e)) for n, s, e in OPS],
                  ranges=[(n, trace_ns(s), trace_ns(e)) for n, s, e in RANGES],
                  start_ns=trace_ns(5), end_ns=trace_ns(105))
    return types.SimpleNamespace(state={}, traced={"start": host_s(5), "stop": host_s(105)},
                                 spans=spans, trace=trace)


def read(name, run):
    return mf.metric_reader(name).read(run)


def test_records_are_kept_to_the_slice_and_taken_once(monkeypatch):
    run = synthetic_run(monkeypatch)
    assert [r.id for r in ps.records(run)] == list(range(2, 13))
    monkeypatch.setattr(tracing, "take", lambda: [])
    assert len(ps.records(run)) == 11  # cached on the run


def test_the_join_maps_spans_exactly(monkeypatch):
    run = synthetic_run(monkeypatch)
    mapped = ps.on_trace(run, ps.named(run, "engine.decode"))
    want = [(trace_ns(21), trace_ns(47)), (trace_ns(63), trace_ns(97))]
    assert mapped == [(pytest.approx(s, abs=0.5), pytest.approx(e, abs=0.5)) for s, e in want]


def test_the_join_refuses_unpaired_steps(monkeypatch):
    run = synthetic_run(monkeypatch)
    run.trace.ranges = run.trace.ranges[:-1]
    with pytest.raises(RuntimeError, match="cannot be paired"):
        ps.on_trace(run, ps.named(run, "decode.pages"))


@pytest.mark.parametrize("name,value", [
    ("pages_host_ms.serve", 0.016),  # 4 x 8 us over 2 decodes
    ("live_page_share.serve", 50.0),  # (6 + 10) / (16 + 16)
    ("decode_issue_ms.serve", 0.0195),  # (26 + 34 - 7 - 14) us / 2
    ("first_token_hold_ms.serve", 0.028),  # 48 - 20 us
    ("idle_pages.serve", 10.0),  # (32 - 22) us of a 100 us slice
])
def test_readers_give_their_hand_computed_values(monkeypatch, name, value):
    assert read(name, synthetic_run(monkeypatch)) == pytest.approx(value, rel=1e-9)


READERS = ["pages_host_ms.serve", "live_page_share.serve", "decode_issue_ms.serve",
           "first_token_hold_ms.serve", "idle_pages.serve"]


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_in_a_program_without_the_tracer(monkeypatch, name):
    run = synthetic_run(monkeypatch)
    monkeypatch.delattr(repro_torch, "tracing")  # the import fails, as in an older port
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert read(name, run) is None


def test_idle_pages_needs_device_operations(monkeypatch):
    run = synthetic_run(monkeypatch)
    run.trace.ops = []
    assert read("idle_pages.serve", run) is None


def test_traced_tiny_serve_reads_the_programs_metrics():
    cell = tiny_cell("serve")
    r = harness.run_cell(cell, seed=2**31 + 11, seconds=0.5, trace=True,
                         device=torch.device("cpu"), t0=time.perf_counter())
    assert r["correct"], r["checks"]
    m = {n: v["value"] for n, v in r["metrics"].items()}
    for name in ("pages_host_ms.serve", "live_page_share.serve", "decode_issue_ms.serve"):
        assert name in m
    assert "idle_pages.serve" not in m  # no device operation on the CPU
    assert 0 < m["pages_host_ms.serve"] <= m["decode_issue_ms.serve"]
    assert 0 < m["live_page_share.serve"] <= 100
    assert r["metrics"]["live_page_share.serve"]["unit"] == "%"
    if "first_token_hold_ms.serve" in m:
        assert m["first_token_hold_ms.serve"] > 0
