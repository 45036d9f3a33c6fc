"""Benchmark rows (port of ``benchmarks/common.py``): timing, CSV lines and
machine-readable JSON rows for the port's benchmark twins.

``timeit`` takes the median wall time of a call, ended by
``torch.cuda.synchronize`` on a card. A ``Rows`` records each ``row(...)``
as a CSV line on stdout and a JSON row (name, us_per_call, derived, and
any metadata the caller passes), and ``emit_json`` writes them as
``{"backend": "cuda" | "cpu", "rows": [...]}``, the reference's layout.
"""
from __future__ import annotations

import json
import time

import torch


def timeit(fn, *args, device, reps: int = 5, warmup: int = 1) -> float:
    """Median wall time per call of ``fn(*args)`` in seconds, after
    ``warmup`` calls; on a CUDA ``device`` each call ends in a synchronize."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


class Rows:
    """The rows of one benchmark run on ``device``."""

    def __init__(self, device):
        self.backend = torch.device(device).type
        self.rows: list[tuple[str, float, str]] = []
        self.json_rows: list[dict] = []

    def row(self, name: str, seconds: float, derived: str, **meta):
        """One row: a CSV line to stdout, a structured copy for JSON;
        ``meta`` rides into the JSON row as it is."""
        self.rows.append((name, seconds * 1e6, derived))
        self.json_rows.append({"name": name, "us_per_call": seconds * 1e6,
                               "derived": derived, **meta})
        print(f"{name},{seconds * 1e6:.1f},{derived}", flush=True)

    def emit_json(self, path: str) -> None:
        """Every row so far to ``path`` as deterministic (sorted keys,
        indented) JSON."""
        payload = {"backend": self.backend, "rows": self.json_rows}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
