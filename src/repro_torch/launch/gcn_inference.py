"""GCN layer inference (port of ``examples/gcn_inference.py``; paper
Sec. V-C, Fig. 11): mixed dense + sparse-dense compute on citation-style
graphs.

The paper evaluates webkb / cora / citeseer (avg degree 1.4-2.0). Graphs
are synthetic with matched size and degree, built with the reference's
numpy calls, so the same seed gives the reference's adjacency and
features; the stack is the paper's 144-feature layer, two layers deep.

    PYTHONPATH=src python -m repro_torch.launch.gcn_inference   # on the card
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import sparse
from repro_torch.device import resolve_device
from repro_torch.models import gcn

# (name, nodes, avg_degree) — matching the paper's three citation graphs
GRAPHS = (("webkb", 877, 1.8), ("cora", 2708, 2.0), ("citeseer", 3327, 1.4))
FEATURES = 144  # the paper's hidden layer width
LAYERS = 2


def adjacency(rng, n, deg):
    """Symmetric-normalized adjacency with self loops, ELL format (host
    tensors; ``.to(device)`` moves it)."""
    L = max(int(round(deg)) + 1, 2)
    cols = rng.integers(0, n, (n, L)).astype(np.int32)
    cols[:, 0] = np.arange(n)  # self loop
    vals = np.full((n, L), 1.0 / L, np.float32)
    return sparse.EllMatrix(torch.from_numpy(vals), torch.from_numpy(cols), (n, n))


@dataclasses.dataclass
class GraphRun:
    name: str
    adj: sparse.EllMatrix
    feats: torch.Tensor
    out: torch.Tensor
    forward_ms: float  # host clock around one forward, ended by a device sync


def run(*, device=None, seed=0, graphs=GRAPHS, params=None):
    """One forward of the ``LAYERS``-deep ``FEATURES``-wide stack per graph,
    on ``device`` (default ``cuda``; raises without CUDA unless a device is
    given). Graphs and features come from one numpy stream seeded with
    ``seed``, in the reference example's order; ``params`` default to
    ``gcn.init_params`` with the same seed. Returns one ``GraphRun`` per
    graph."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    if params is None:
        params = gcn.init_params([FEATURES] * (LAYERS + 1), seed=seed, device=device)
    runs = []
    for name, n, deg in graphs:
        adj = adjacency(rng, n, deg).to(device)
        feats = torch.from_numpy(
            rng.standard_normal((n, FEATURES)).astype(np.float32)).to(device)
        t = time.perf_counter()
        with torch.no_grad():
            out = gcn.forward(params, adj, feats)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        runs.append(GraphRun(name, adj, feats, out, (time.perf_counter() - t) * 1e3))
    return runs


def main():
    for r in run():
        n = r.adj.shape[0]
        flops = 2 * n * FEATURES * FEATURES * LAYERS + 2 * r.adj.nnz * FEATURES * LAYERS
        print(f"{r.name:10s} n={n:6d} L={r.adj.values.shape[1]}: {r.forward_ms:8.3f} ms "
              f"per forward ({flops / r.forward_ms / 1e6:8.2f} GFLOP/s), out "
              f"{tuple(r.out.shape)}, finite={bool(torch.isfinite(r.out).all())}")


if __name__ == "__main__":
    main()
