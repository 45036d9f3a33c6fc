"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the plain reference, and the result line.

A drive (``portbench/drive/<name>.py``, named by the traffic mix) owns the
loop that offers the mix to the port and the comparison of what that loop
produced. It provides

    setup(run)                  weights, inputs, the program's objects,
                                every shape this cell uses warmed up
    loop(run, seconds, keep)    the mix for ``seconds``; returns its counts
                                (``seconds``: the host clock over the whole
                                loop, ended by a synchronisation); ``keep``
                                lets it keep outputs for the comparison
    end_to_end(run, counts)     {end-to-end metric: value}
    release(run)                frees the program's state
    check(run, control=None)    ([Check], attempted, failed); ``control``
                                puts the reference's lower precision in the
                                program's place

and the harness does the rest. Per-layer metrics are read after the run by
``portbench/metrics/<name>.py`` from ``run``: the window's counts, the
host spans and, in a traced run, the trace of a slice that follows the
window.
"""
from __future__ import annotations

import dataclasses
import gc
import math
import random
import sys
import time

from portbench.lib import manifest as mf
from portbench.lib import trace as tr

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Check:
    """One number compared with its limit: ``value <= limit`` passes."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from ``seed``
    (Algorithm R): the loop keeps no more than ``k`` outputs alive."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Run:
    cell: mf.Cell
    seed: int
    device: object
    ref: object  # the configuration's reference module
    drive: object
    spans: tr.Spans = dataclasses.field(default_factory=tr.Spans)
    state: dict = dataclasses.field(default_factory=dict)
    window: dict | None = None  # the measured window's counts
    traced: dict | None = None  # the traced slice's counts
    trace: tr.Trace | None = None
    kept: Reservoir | None = None

    @property
    def model(self) -> dict:
        return self.cell.config["model"]

    @property
    def limits(self) -> dict:
        return self.cell.config["limits"]


def forbidden_modules() -> list:
    """Modules of JAX or the JAX package loaded in this process, compared by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def device_kind(device) -> tuple:
    import torch

    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return device.type, device.type


def run_cell(cell: mf.Cell, *, seed: int, seconds: float, trace: bool, device,
             t0: float, control: str | None = None) -> dict:
    """Everything of one run after the checks for a card: returns the
    result (the JSON line's object, ``checks`` last). ``control`` (the
    configuration's ``control``) judges the reference in that lower
    precision in the program's place: ``control.py`` reads its limit's
    upper end so; a benchmark run never does."""
    import torch

    run = Run(cell=cell, seed=seed, device=device,
              ref=mf.reference(cell.config_name), drive=mf.drive(cell.traffic["drive"]))
    run.kept = Reservoir(int(cell.traffic.get("keep", 2)), seed)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)  # the context exists before its stats are reset
        torch.cuda.reset_peak_memory_stats(device)
    with torch.no_grad():
        run.drive.setup(run)
        if cuda:
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t0
        run.window = run.drive.loop(run, seconds, True)
        if trace:
            slice_s = min(float(cell.traffic["trace_seconds"]), seconds)
            run.traced, run.trace = tr.record(
                lambda: run.drive.loop(run, slice_s, False), run.spans, device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run.drive.release(run)
    gc.collect()  # the program's objects may hold each other
    if cuda:
        torch.cuda.empty_cache()
    checks, attempted, failed = run.drive.check(run, control)

    metrics, units = {}, {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if not trace:
        values = dict(run.drive.end_to_end(run, run.window), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = values[m["name"]]
    else:
        for m in cell.per_layer:
            value = mf.metric_reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = value
    platform, kind = device_kind(device)
    dev = {"platform": platform, "kind": kind, "count": cell.chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(c.ok for c in checks), "attempted": int(attempted),
              "failed": int(failed),
              "metrics": {n: {"value": float(v), "unit": units[n]} for n, v in metrics.items()},
              "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_ops(), "idle_gaps": run.trace.idle_gaps()}
    # a value that is not finite fails its check and prints as null
    result["checks"] = {c.name: {"value": float(c.value) if math.isfinite(c.value) else None,
                                 "limit": float(c.limit)} for c in checks}
    return result
