"""Plain PyTorch reference of the paper's GCN (Sec. V-C, Fig. 11), and the
maker of the graph, features and weights both sides are handed.

H' = act(A (H W)) for each layer, ReLU between layers and none after the
last, A the row-normalized adjacency with self loops held as ELL rows
(``values``, ``cols`` of shape (nodes, slots)): row i sums
values[i, l] * X[cols[i, l]]. Computed in fp32 with TF32 off. This file
imports nothing of the port.

``tf32=True`` is the control: the products in TF32, the step below the
exact fp32 the configuration states.
"""
from __future__ import annotations

import contextlib
import math

import torch


def make_graph(graph: dict, seed: int, device):
    """(values fp32, cols int32), each (nodes, slots): slot 0 the self loop,
    the other ``slots - 1`` columns uniform over the nodes, every value
    1 / slots (the generator of the port's ``launch/gcn_inference.py``
    ``adjacency``, drawn on the device)."""
    n, L = graph["nodes"], graph["ell_slots"]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    cols = torch.randint(0, n, (n, L), generator=gen, device=device, dtype=torch.int32)
    cols[:, 0] = torch.arange(n, device=device, dtype=torch.int32)
    vals = torch.full((n, L), 1.0 / L, dtype=torch.float32, device=device)
    return vals, cols


def make_weights(graph: dict, seed: int, device) -> list:
    """One (f_in, f_out) fp32 matrix a layer, normal with std 1/sqrt(f_in)."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    dims = graph["feature_dims"]
    return [torch.randn((a, b), generator=gen, device=device).mul_(1.0 / math.sqrt(a))
            for a, b in zip(dims[:-1], dims[1:])]


def make_features(graph: dict, seed: int, device, count: int):
    """``count`` unit-normal (nodes, f_in) fp32 feature matrices in one draw."""
    gen = torch.Generator(device=device).manual_seed(int(seed) + 2)
    x = torch.randn((count, graph["nodes"], graph["feature_dims"][0]), generator=gen,
                    device=device)
    return list(x.unbind(0))


@contextlib.contextmanager
def _tf32(on: bool):
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = m, c


@torch.no_grad()
def forward(weights, vals, cols, feats, *, tf32: bool = False, rows: int = 16384):
    """The whole graph's output (nodes, f_out) in fp32; the aggregation in
    blocks of ``rows`` rows, each an explicit gather and sum."""
    h = feats.float()
    with _tf32(tf32):
        for i, w in enumerate(weights):
            x = torch.matmul(h, w.float())
            out = torch.empty_like(x)
            for r in range(0, x.shape[0], rows):
                g = x[cols[r:r + rows].long()]  # (rows, slots, f)
                out[r:r + rows] = (vals[r:r + rows, :, None] * g).sum(1)
            h = torch.relu(out) if i < len(weights) - 1 else out
    return h
