"""The reduction of a traced slice: busy time as the union of device
intervals, idle time named by the innermost host span, and a traced run's
per-layer line (on the CPU the trace holds no device operation, so only
the host's metrics are read)."""
import time

import pytest
import torch
from conftest import tiny_cell

from portbench.lib import harness
from portbench.lib.trace import Trace

# ns: loop [0, 100); step [10, 90) holds decode [20, 60)
RANGES = [("loop", 0, 100), ("step", 10, 90), ("decode", 20, 60)]
OPS = [("k1", 25, 35), ("k2", 30, 45), ("Memcpy DtoH", 50, 55), ("gemm_x", 70, 80)]


def test_busy_is_the_union():
    t = Trace(ops=OPS, ranges=RANGES, start_ns=0, end_ns=100)
    assert t.busy_s() == pytest.approx(35e-9)  # 25-45, 50-55, 70-80
    assert t.busy_s(within=t.ranges_named("decode")) == pytest.approx(25e-9)
    assert [o[0] for o in t.ops_within(t.ranges_named("decode"))] == ["k1", "k2"]
    assert [o[0] for o in t.matching([r"(?i)GEMM"])] == ["gemm_x"]
    assert t.top_ops(1) == [["k2", pytest.approx(15e-9)]]


def test_idle_is_named_by_the_innermost_span():
    t = Trace(ops=OPS, ranges=RANGES, start_ns=0, end_ns=100)
    idle = dict(t.idle_gaps())
    # loop: 0-10 and 90-100; step: 10-20 and 60-90 less 70-80; decode: 20-60 less 25-45, 50-55
    assert idle == {"loop": pytest.approx(20e-9), "step": pytest.approx(30e-9),
                    "decode": pytest.approx(15e-9)}
    assert sum(idle.values()) + t.busy_s() == pytest.approx(t.window_s)


@pytest.mark.parametrize("drive", ["prefill", "graph", "serve"])
def test_traced_run_reads_the_host_metrics(drive):
    cell = tiny_cell(drive)
    r = harness.run_cell(cell, seed=5, seconds=0.5, trace=True, device=torch.device("cpu"),
                         t0=time.perf_counter())
    names = {m["name"] for m in cell.per_layer}
    assert r["correct"] and set(r["metrics"]) <= names
    assert any(n.startswith("mfu.") for n in r["metrics"])
    assert not any(n.startswith("idle.") or "roofline" in n for n in r["metrics"])
    assert r["device"]["window_s"] > 0 and r["device"]["busy_s"] == 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(r)[-1] == "checks"
