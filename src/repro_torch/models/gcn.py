"""GCN layer (port of ``repro.models.gcn``; paper Sec. V-C, Fig. 11):
sparse-dense aggregation + dense feature recombination.

H' = act( Â (H W) ) with Â an ``EllMatrix``: the recombination runs
through ``ops.gemm`` and the aggregation through ``ops.spmm``, so on the
card each layer is one launch of each Hopper kernel. Parameters are a list
of (f_in, f_out) weight tensors, as in the reference.

Passing ``mesh=`` (or calling under ``sharding.use_mesh``) runs the whole
forward sharded: each op follows its own PartitionRule (the GEMM
K-sharded with its psum, the adjacency's rows split for the aggregation),
one launch of each kernel per rank and layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sparse import EllMatrix
from repro_torch.device import resolve_device
from repro_torch.hopper import ops
from repro_torch.models import layers as L


def init_params(feature_dims: list[int], *, seed: int = 0,
                dtype=torch.float32, device=None):
    """Random weights with the reference's shapes and ``dense_init`` scale
    (1/sqrt(fan_in)), drawn on ``device`` (default ``cuda``; raises without
    CUDA unless a device is given) from a ``torch.Generator`` seeded with
    ``seed``. The draws differ from ``jax.random``'s; tests carry JAX
    weights over with ``params_from_jax``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return [
        L.dense_init(gen, (fi, fo), dtype=dtype, device=device)
        for fi, fo in zip(feature_dims[:-1], feature_dims[1:])
    ]


def params_from_jax(np_params, *, device=None):
    """Carry the reference's weight list (``repro.models.gcn.init_params``,
    as numpy arrays or anything ``np.asarray`` takes) over to tensors on
    ``device`` (default ``cuda``)."""
    device = resolve_device(device)
    return [torch.from_numpy(np.array(w)).to(device) for w in np_params]


def gcn_layer(w, adj: EllMatrix, feats, *, activate=True, mesh=None):
    """One layer: recombine (dense GEMM) then aggregate (SpMM)."""
    h = ops.gemm(feats, w, mesh=mesh)  # dense recombination
    h = ops.spmm(adj, h, mesh=mesh)  # sparse aggregation (row-sharded)
    return torch.relu(h) if activate else h


def forward(params, adj: EllMatrix, feats, *, mesh=None):
    h = feats
    for i, w in enumerate(params):
        h = gcn_layer(w, adj, h, activate=i < len(params) - 1, mesh=mesh)
    return h
