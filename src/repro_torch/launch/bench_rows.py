"""Benchmark rows (port of ``benchmarks/common.py``): timing, CSV lines and
machine-readable JSON rows for the port's benchmark twins, and the rows of
``benchmarks/bench_gemm.py`` (``gemm_rows``) and ``bench_gcn.py``
(``gcn_rows``).

``timeit`` takes the median wall time of a call, ended by
``torch.cuda.synchronize`` on a card. A ``Rows`` records each ``row(...)``
as a CSV line on stdout and a JSON row (name, us_per_call, derived, and
any metadata the caller passes), and ``emit_json`` writes them as
``{"backend": "cuda" | "cpu", "rows": [...]}``, the reference's layout.
"""
from __future__ import annotations

import json
import time

import numpy as np
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


GEMM_N = 512  # bench_gemm's m = k = n
TILED = (2048, 512)  # bench_gemm's tiled GEMM: A rows, tile_m
POLICIES = ("fp32", "bf16", "fp8")


def gemm_rows(rows: Rows, *, device, seed: int = 0) -> dict:
    """``benchmarks/bench_gemm.py``'s rows on ``device`` (Fig. 9a, Fig. 10):
    ``ops.gemm`` at 512^3, each policy's expanding GEMM's error against the
    fp32 product with the card's peak for that policy, and
    ``core.pipeline.tiled_gemm`` on a 2048 x 512 A. Operands are the
    bench's numpy draws. Returns ``{policy: rel_err}``."""
    from repro_torch.core import precision
    from repro_torch.core.pipeline import tiled_gemm
    from repro_torch.hopper import ops
    from repro_torch.launch.precision_ladder import _full_fp32_matmul

    rng = np.random.default_rng(seed)
    m = k = n = GEMM_N
    a32 = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(device)
    b32 = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(device)
    flops = 2 * m * k * n
    errs = {}
    with torch.no_grad(), _full_fp32_matmul():
        t = timeit(lambda a, b: ops.gemm(a, b), a32, b32, device=device)
        rows.row("fig9a_gemm_512", t, f"{flops / t / 1e9:.2f} GFLOP/s")
        exact = a32 @ b32
        for pol in POLICIES:
            out = precision.expanding_gemm(a32, b32, pol, impl="ref")
            rel = float(torch.linalg.norm(out.float() - exact) / torch.linalg.norm(exact))
            peak = precision.peak_flops(pol)
            errs[pol] = rel
            rows.row(f"fig10_gemm_{pol}", t, f"rel_err={rel:.1e};card_peak={peak / 1e12:.0f}TFLOP/s",
                     rel_err=rel, peak_flops=peak)
        big_a = torch.from_numpy(
            rng.standard_normal((TILED[0], k)).astype(np.float32)).to(device)
        t = timeit(lambda a, b: tiled_gemm(a, b, tile_m=TILED[1]), big_a, b32, device=device)
        rows.row(f"fig9a_tiled_gemm_{TILED[0]}x{TILED[1]}", t,
                 f"{2 * TILED[0] * k * n / t / 1e9:.2f} GFLOP/s")
    return errs


def gcn_rows(rows: Rows, *, device, seed: int = 0, params=None) -> dict:
    """``benchmarks/bench_gcn.py``'s rows on ``device`` (Fig. 11): one
    144 x 144 GCN layer (``gcn.forward``) per citation-style graph, the
    bench's numpy draws; ``params`` default to ``gcn.init_params([144,
    144], seed=seed)``. Returns ``{graph: output}``."""
    from repro_torch.launch.gcn_inference import FEATURES, GRAPHS, adjacency
    from repro_torch.models import gcn

    rng = np.random.default_rng(seed)
    if params is None:
        params = gcn.init_params([FEATURES, FEATURES], seed=seed, device=device)
    outs = {}
    with torch.no_grad():
        for name, n, deg in GRAPHS:
            adj = adjacency(rng, n, deg).to(device)
            feats = torch.from_numpy(
                rng.standard_normal((n, FEATURES)).astype(np.float32)).to(device)
            t = timeit(lambda a, x: gcn.forward(params, a, x), adj, feats, device=device)
            flops = 2 * n * FEATURES * FEATURES + 2 * adj.values.numel() * FEATURES
            rows.row(f"fig11_gcn_{name}", t, f"{flops / t / 1e9:.2f} GFLOP/s;nodes={n}")
            outs[name] = gcn.forward(params, adj, feats)
    return outs
