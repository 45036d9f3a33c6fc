"""Mixture-of-Experts layer with sorted, capacity-bounded dispatch (port of
``repro.models.moe``).

Routing (``_route``): router logits and softmax in fp32, the top-k experts
of each token (ties go to the lower expert index, as ``jax.lax.top_k``
breaks them), their weights renormalised to sum to one, and the
Switch-style load-balance aux loss. ``moe_mlp`` dispatches each batch row
on its own: the row's (token, choice) pairs are sorted by expert
(**stable**, so a token keeps its place within an expert), the pair of rank
``r`` in expert ``e`` takes slot ``e * C + r`` and is dropped at
``r >= C`` (``C = capacity(cfg, S)``). Only int vectors are scattered
(the slot -> pair map, over a buffer one longer whose last entry takes
every dropped pair, as JAX's ``mode="drop"`` discards them); values move by
gathers, and the combine gathers back through the inverse of the sort.

The dispatch and combine stay local to each data shard when a mesh is
current (``parallel.sharding.current_mesh()``, set by
``activation_sharding``) and the batch divides over its data axes: the
reference's ``shard_map`` branch. Each data rank (at index 0 on ``model``)
runs ``_dispatch`` and ``_combine`` on its own rows, in its own allocation
and on its own stream (``DeviceMesh.on``), and the parts are collected
into the global buffers the expert products take; ``MESH_ROW_CALLS``
counts those per-rank calls. Every op is row-wise, so the branch is
bitwise the mesh-free one. The expert products stay global, as the
reference leaves them outside the ``shard_map`` for GSPMD.

Numerics follow the dense port's treatment of ``preferred_element_type``:
the expert products are ``torch.matmul``/``einsum`` in the activation
dtype (fp32 accumulation inside the GEMM, one rounding), and where the
reference keeps an fp32 result before the activation, the port takes the
rounded product to fp32 there. ``tp_reduce_bf16`` keeps the gated hidden
buffer in the activation dtype (the reference's ``h_dt``) instead of fp32;
the expert output is rounded to the activation dtype either way. As in the
reference, a non-gated activation is not applied inside the experts (both
MoE configs, swiglu and geglu, are gated). ``moe_mlp_decode`` computes
every expert for every token and weights them by the one-hot top-k.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import constrain

# "dispatch" / "combine" -> the per-data-rank calls of the mesh branch
MESH_ROW_CALLS: collections.Counter = collections.Counter()


def init_moe_params(dense, cfg, num_layers: int, dtype) -> dict:
    """The MoE leaves, drawn in the reference's order through ``dense(shape,
    scale=None, dtype=None)`` (``layers.dense_init`` on the caller's
    generator): ``router`` (nl, d, E) fp32, ``moe_wi`` (nl, E, d, f),
    ``moe_wo`` (nl, E, f, d) and, for a gated activation, ``moe_wg``."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense((num_layers, d, E), dtype=torch.float32),
        "moe_wi": dense((num_layers, E, d, f), dtype=dtype),
        "moe_wo": dense((num_layers, E, f, d), scale=1.0 / math.sqrt(f), dtype=dtype),
    }
    if L.is_gated(cfg.activation):
        p["moe_wg"] = dense((num_layers, E, d, f), dtype=dtype)
    return p


def capacity(cfg, seq_len: int) -> int:
    E, k = cfg.num_experts, cfg.experts_per_token
    return max(int(math.ceil(k * seq_len / E * cfg.capacity_factor)), 1)


def _route(p, x, cfg):
    """x (..., d) -> (topv (..., k) fp32, topi (..., k) int64, aux scalar)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(torch.matmul(x.float(), p["router"].float()), dim=-1)
    # a stable descending sort keeps equal probabilities in index order:
    # lax.top_k's tie rule (E is small, so the sort costs nothing)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[..., :k], topi[..., :k]
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    hits = F.one_hot(topi, E).float().sum(-2)  # (..., E)
    f_e = hits.reshape(-1, E).mean(0) / k
    p_e = probs.reshape(-1, E).mean(0)
    return topv, topi, E * torch.sum(f_e * p_e)


def _dispatch(x, topi, E, C):
    """(B, S, d), (B, S, k) -> (disp (B, E, C, d), slot (B, S k), order
    (B, S k)): each row's pairs sorted by expert, pair of rank r in expert
    e at slot e C + r, slot E C where r >= C (dropped)."""
    B, S, d = x.shape
    n = topi.shape[1] * topi.shape[2]
    rows = torch.arange(B, device=x.device)[:, None]
    e_flat = topi.reshape(B, n)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    experts = torch.arange(E, device=x.device).expand(B, E).contiguous()
    first = torch.searchsorted(se.contiguous(), experts, side="left")
    rank = torch.arange(n, device=x.device) - torch.gather(first, 1, se)
    slot = torch.where(rank < C, se * C + rank, E * C)
    # int-only scatter into one extra entry that takes every dropped pair
    inv = torch.full((B, E * C + 1), n, dtype=torch.long, device=x.device)
    inv.scatter_(1, slot, torch.arange(n, device=x.device).expand(B, n))
    inv = inv[:, : E * C]
    tok_sorted = order // topi.shape[2]
    src = torch.where(inv < n, torch.gather(tok_sorted, 1, inv.clamp_max(n - 1)), S)
    disp = torch.where((src < S)[..., None], x[rows, src.clamp_max(S - 1)], 0)
    return disp.reshape(B, E, C, d), slot, order


def _combine(y, slot, order, topv, k):
    """(B, E, C, d) expert outputs -> (B, S, d): each pair's row (zero where
    dropped) gathered back to (token, choice) order and weighted."""
    B, E, C, d = y.shape
    n = slot.shape[1]
    rows = torch.arange(B, device=y.device)[:, None]
    yf = y.reshape(B, E * C, d)
    vals = torch.where((slot < E * C)[..., None], yf[rows, slot.clamp_max(E * C - 1)], 0)
    inv_order = torch.empty_like(order)
    inv_order.scatter_(1, order, torch.arange(n, device=y.device).expand(B, n))
    out = vals[rows, inv_order] * topv.reshape(B, n, 1)
    return out.reshape(B, n // k, k, d).sum(2)


def _data_ranks(mesh, B):
    """(the data-axis spec, one rank per data index at ``model`` index 0)
    when ``B`` splits over the mesh's data axes, else None."""
    dp = sh.dp_axes(mesh)
    if B % sh.axis_size(mesh, dp):
        return None
    return dp, [r for r in range(mesh.n)
                if all(i == 0 for a, i in mesh.coords(r).items() if a not in dp)]


def _per_data_rank(mesh, ranks, spec, fn, kind, *args):
    """``fn`` on each data rank's rows of ``args`` (split on dim 0 by
    ``spec``), in the rank's allocation and on its stream; the per-rank
    outputs (a tuple) collected and joined on dim 0."""
    outs = []
    for r in ranks:
        parts = [mesh.own(mesh.local(a, (spec,), r), r) for a in args]
        with mesh.on(r):
            out = fn(*parts)
        MESH_ROW_CALLS[kind] += 1
        outs.append([mesh.collect(o, r, args[0].device) for o in out])
    return tuple(torch.cat(col, 0) for col in zip(*outs))


def moe_mlp(p, x, cfg):
    """x (B, S, d) -> (out (B, S, d), aux_loss * router_aux_weight)."""
    E, k = cfg.num_experts, cfg.experts_per_token
    C = capacity(cfg, x.shape[1])
    act = L.activation_fn(cfg.activation)
    x = constrain(x, "moe_tokens")
    topv, topi, aux = _route(p, x, cfg)
    mesh = sh.current_mesh()
    local = None if mesh is None else _data_ranks(mesh, x.shape[0])
    if local is not None:
        disp, slot, order = _per_data_rank(
            mesh, local[1], local[0], lambda xr, ir: _dispatch(xr, ir, E, C), "dispatch", x, topi)
    else:
        disp, slot, order = _dispatch(x, topi, E, C)
    disp = constrain(disp, "moe_dispatch")
    h_dt = x.dtype if cfg.tp_reduce_bf16 else torch.float32
    h = constrain(torch.einsum("becd,edf->becf", disp, p["moe_wi"]), "moe_hidden")
    if L.is_gated(cfg.activation):
        g = constrain(torch.einsum("becd,edf->becf", disp, p["moe_wg"]), "moe_hidden")
        h = act(g.float()).to(h_dt) * h.to(h_dt)
    y = torch.einsum("becf,efd->becd", h.to(x.dtype), p["moe_wo"])
    y = constrain(y, "moe_dispatch")
    if local is not None:
        (out,) = _per_data_rank(mesh, local[1], local[0],
                                lambda *a: (_combine(*a, k),), "combine",
                                y, slot, order, topv.to(x.dtype))
    else:
        out = _combine(y, slot, order, topv.to(x.dtype), k)
    return out, aux * cfg.router_aux_weight


def moe_mlp_decode(p, x, cfg):
    """x (B, d) -> (B, d): every expert on every token, weighted by the
    one-hot top-k (decode streams every expert's weights anyway)."""
    E = cfg.num_experts
    act = L.activation_fn(cfg.activation)
    topv, topi, _ = _route(p, x, cfg)
    w = (F.one_hot(topi, E).float() * topv[..., None]).sum(-2)  # (B, E)
    # (1, B, d) @ (E, d, f): a batched GEMM over the experts' weights as
    # they lie (an einsum would flatten (E, f) and copy every weight)
    h = torch.matmul(x[None], p["moe_wi"]).float()  # (E, B, f)
    if L.is_gated(cfg.activation):
        h = act(torch.matmul(x[None], p["moe_wg"]).float()) * h
    y = torch.matmul(h.to(x.dtype), p["moe_wo"])  # (E, B, d)
    return (y.float() * w.t()[..., None]).sum(0).to(x.dtype)


def moe_mlp_dropless(p, x, cfg):
    """x (..., d) -> (..., d): every (token, choice) pair reaches its
    expert, none dropped (no capacity). The pairs are sorted by expert
    (stable) and each expert runs once on the rows routed to it, so the
    buffers grow with k S, not with E S; its weighted output is added back
    at its tokens in fp32. Gated activations only (``_route``'s top-k
    softmax renormalised, as the published top-k-then-softmax gives).
    One device-to-host read of the experts' row counts a call."""
    E, k = cfg.num_experts, cfg.experts_per_token
    act = L.activation_fn(cfg.activation)
    flat = x.reshape(-1, x.shape[-1])
    topv, topi, _ = _route(p, flat, cfg)
    order = torch.argsort(topi.reshape(-1), stable=True)
    tok = order // k
    weight = topv.reshape(-1)[order]
    counts = torch.bincount(topi.reshape(-1), minlength=E).tolist()
    out = torch.zeros(flat.shape, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = tok[start:start + n]
            xe = flat[rows]
            h = act(torch.matmul(xe, p["moe_wg"][e]).float()) * torch.matmul(xe, p["moe_wi"][e]).float()
            y = torch.matmul(h.to(x.dtype), p["moe_wo"][e])
            out.index_add_(0, rows, y.float() * weight[start:start + n, None])
        start += n
    return out.to(x.dtype).reshape(x.shape)


def shared_expert(p, x, activation):
    """The shared expert every token takes, unweighted: ``sh_wi`` (up),
    ``sh_wg`` (gate), ``sh_wo`` (down)."""
    return L.mlp({"wi": p["sh_wi"], "wg": p["sh_wg"], "wo": p["sh_wo"]}, x, activation)
