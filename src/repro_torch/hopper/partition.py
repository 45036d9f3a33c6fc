"""Mesh-aware partitioning of every op: the port of the reference's
``kernels/partition.py``, the third axis of dispatch (paper Fig. 13).

Every op of ``hopper/ops.py`` takes ``mesh=`` (a ``parallel.mesh.
DeviceMesh`` or ``RingMesh``, or the ``parallel.sharding.use_mesh``
context) and routes through ``sharded_call``. Each op registers a
*PartitionRule*: how its operands split over the mesh's *partition
levels* — the chiplet axis (``model``) and, on a multi-pod mesh, the pod
axis (``pod``, the D2D link) jointly above it; the attention family adds
the ``data`` level for its batch or sequence — which collective stitches
the partials back together at each level, and when the op must degrade
to fewer levels or to replication.

Layering:

  ops.py            the one seam (``ops._dispatch``): an explicit ``mesh=``,
                    else ``sharding.kernel_mesh()``, else the plain call
  plan_for()        PartitionRule -> PartitionPlan (specs, the per-rank
                    local function, per-level collective costs), from
                    shapes alone: a device-free ``MeshSpec`` plans too
  sharded_call()    runs a plan on a ``DeviceMesh``: the plan's ``pre``
                    rewrite, one part of every operand per rank (its own
                    allocation, ``DeviceMesh.shard_spec``), the plan's
                    ``local_fn`` over every rank (each rank's work on its
                    own stream, through whichever registered impl was
                    selected: ``cuda``, ``torch`` or ``ref``), the parts
                    gathered back by the out specs, and ``post``

A spec (``PartitionSpec``, alias ``P``) is a tuple of per-dimension
entries: ``None``, an axis name, or a tuple of names split jointly, outer
axis major. ``local_fn(mesh, *per-rank operand lists)`` returns the
per-rank outputs; an operand that is ``None`` stays ``None`` on every
rank.

Rule table (the op's logical-axis split over the partition levels):

  gemm              K-sharded over pod×model jointly with a hierarchical
                    psum (intra-pod first); under a sub-fp32 ``precision``
                    each shard runs the scaled kernel and the psum payload
                    narrows to bf16. Else M-row sharding
  flash_attention   GQA heads (q and kv together) over the non-``data``
                    levels, composed with ``data``: the batch when it
                    divides, else the sequence-parallel KV ring on each
                    ``data`` group (``collectives.ring_scan``, the
                    contiguous or zigzag schedule; ``remote_copy`` sends
                    each hop through the ring-hop kernel)
  decode_attention  heads × batch; declines paged pools (``block_table``)
  linear_attention  heads × batch, ``u`` per head, ``s0`` with the streams
  spmm              ELL rows over pod×model, dense replicated
  bsr_spmm          nnz tiles over pod×model, hierarchical psum of rows
  spmspm            A rows over pod×model, B replicated
  stencil           x-slabs with the halo over the inner axis
                    (``collectives.ppermute``), one pod-boundary hop per
                    direction; with ``overlap`` the interior on the
                    unpadded slab plus two 3h-row strips, bitwise the sync
                    path

**The replication fallback ladder.** ``plan_for`` offers the rule the full
level stack, outermost first; each time the rule declines, the outermost
level is dropped. Returns None (replication: the call runs once,
unsharded, on the operands' device) when no non-trivial level exists or
every rung declines; an exhausted ladder warns once per op and mesh
shape (``ReproDegradeWarning``).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import precision as prec
from repro_torch.diagnostics import warn_degrade
from repro_torch.hopper import dispatch
from repro_torch.hopper.flash_attention import zigzag_indices, zigzag_inverse
from repro_torch.parallel.collectives import (
    NEG_LSE,
    hierarchical_psum,
    online_softmax_merge,
    ppermute,
    ppermute_start,
    ring_scan,
)
from repro_torch.parallel.mesh import DeviceMesh

# the mesh-axis vocabulary the partition layer shards over or names in a
# collective: the D2D pod link, the group interconnect, the chiplet crossbar
AXIS_VOCAB = ("pod", "data", "model")


# ---------------------------------------------------------------------------
# Plan objects
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """One entry per dimension: ``None``, an axis name, or a tuple of axis
    names split jointly (``P(None, ("pod", "model"))``). A tuple, so it
    compares equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class CollectiveCost:
    """One collective a plan fires at one partition level.

    Fields: ``kind`` — "all_reduce" | "all_gather" | "reduce_scatter" |
    "permute"; ``axis`` — the mesh axis it crosses; ``nbytes`` — the
    per-rank payload; ``n`` — the participant count at that level.
    """

    kind: str
    axis: str
    nbytes: int
    n: int = 0


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A resolved partitioning of one op call over one or more mesh levels.

    Fields: ``op`` — the op name; ``levels`` — outer-to-inner ``(axis,
    size)`` pairs the plan shards over; ``in_specs`` — one
    ``PartitionSpec`` per positional operand (entries for ``None``
    operands are ignored); ``out_specs`` — the output's spec, or a tuple of
    specs for a tuple output; ``local_fn`` — ``local_fn(mesh, *per-rank
    operand lists) -> per-rank outputs``, collectives included;
    ``collectives`` — per-level ``CollectiveCost`` in firing order
    (innermost first); ``note`` — a one-line description; ``overlappable``
    — the local function issues its transfers ahead of the compute that
    does not need them; ``hops`` — the pipeline depth (the ring's fold
    count, 2 for the halo's two directions); ``pre`` / ``post`` — global
    rewrites before sharding and after gathering (the zigzag permutation).
    """

    op: str
    levels: tuple
    in_specs: tuple
    out_specs: Any
    local_fn: Callable
    collectives: tuple[CollectiveCost, ...] = ()
    note: str = ""
    overlappable: bool = False
    hops: int = 0
    pre: Callable | None = None
    post: Callable | None = None

    @property
    def axis(self):
        """Spec-entry form of the levels: ``"model"`` for one level,
        ``("pod", "model")`` for a joint split."""
        return _joint(self.levels)

    @property
    def n(self) -> int:
        """Total shard count: the product of every level's size."""
        return _ntot(self.levels)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Device-free mesh descriptor: ``shape`` is ``{axis: size}`` in axis
    order. Plans resolve against it; ``sharded_call`` needs a
    ``DeviceMesh``."""

    shape: dict

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)


def partition_axis(mesh) -> str:
    """The innermost axis ops shard over: ``model`` when present, else the
    mesh's last axis."""
    names = tuple(mesh.axis_names)
    return "model" if "model" in names else names[-1]


def _stack(mesh, with_data: bool) -> tuple:
    names = tuple(mesh.axis_names)
    inner = partition_axis(mesh)
    outer = ("pod", "data") if with_data else ("pod",)
    levels = [(a, int(mesh.shape[a])) for a in outer
              if a in names and a != inner and int(mesh.shape[a]) > 1]
    if int(mesh.shape[inner]) > 1:
        levels.append((inner, int(mesh.shape[inner])))
    return tuple(levels)


def partition_levels(mesh) -> tuple:
    """The partition-level stack of ``mesh``, outermost first: ``("pod",
    P)`` when the mesh has a non-trivial pod axis, then the
    ``partition_axis``. Size-1 axes are dropped."""
    return _stack(mesh, False)


def attention_levels(mesh) -> tuple:
    """``partition_levels`` of ``mesh`` with the ``data`` axis slotted
    between ``pod`` and the chiplet axis (the attention family's batch or
    sequence level). Size-1 axes are dropped."""
    return _stack(mesh, True)


def _joint(levels):
    axes = tuple(a for a, _ in levels)
    return axes[0] if len(axes) == 1 else axes


def _ntot(levels) -> int:
    return math.prod(n for _, n in levels)


def _levels_note(levels) -> str:
    return "+".join(f"{a}={n}" for a, n in levels)


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _per_level_psum_costs(levels, shape, dtype) -> tuple:
    """One all_reduce per level, innermost first: ``hierarchical_psum``'s
    firing order."""
    return tuple(CollectiveCost("all_reduce", axis, _nbytes(shape, dtype), n)
                 for axis, n in reversed(tuple(levels)))


def _each(mesh, fn, *parts) -> list:
    """``fn`` over every rank's operands (``None`` stays ``None``), each
    rank under its own device and stream."""
    outs = []
    for r in range(mesh.n):
        with mesh.on(r):
            outs.append(fn(*(None if p is None else p[r] for p in parts)))
    return outs


# ---------------------------------------------------------------------------
# Rule registry and resolution
# ---------------------------------------------------------------------------

_RULES: dict[str, Callable] = {}
_LEVEL_FNS: dict[str, Callable] = {}


def register_partition_rule(op: str, *, levels: Callable | None = None) -> Callable:
    """Decorator registering ``op``'s PartitionRule: ``rule(levels,
    *operands, impl=..., **op_kwargs) -> PartitionPlan | None`` (None:
    declined at this level stack). ``levels`` maps a mesh to the stack
    ``plan_for`` offers (default ``partition_levels``)."""

    def deco(fn: Callable) -> Callable:
        _RULES[op] = fn
        if levels is not None:
            _LEVEL_FNS[op] = levels
        return fn

    return deco


def partitioned_ops() -> list[str]:
    """Sorted names of every op with a PartitionRule."""
    return sorted(_RULES)


# plan-only keywords: schedule knobs the partition layer consumes, never the
# kernels. plan_for forwards each only to rules whose signature declares it;
# the dispatch seam strips them before any direct kernel call
PLAN_KWARGS = ("overlap", "zigzag", "remote_copy")


@functools.lru_cache(maxsize=None)
def _rule_plan_params(rule: Callable) -> frozenset:
    params = inspect.signature(rule).parameters
    return frozenset(k for k in PLAN_KWARGS if k in params)


def strip_plan_kwargs(kwargs: dict) -> dict:
    """``kwargs`` without the plan-only schedule keywords."""
    return {k: v for k, v in kwargs.items() if k not in PLAN_KWARGS}


def plan_for(op: str, mesh, *args, impl: str | None = None, **kwargs):
    """Resolve ``op``'s PartitionRule against ``mesh`` (a ``DeviceMesh`` or
    a ``MeshSpec``) for the operands ``args`` (tensors, or anything with
    ``.shape`` and ``.dtype``: ``device="meta"`` tensors plan without
    memory) and the op's keywords ``kwargs`` (plan-only schedule keywords
    reach only the rules that declare them); ``impl`` is the dispatch impl
    each rank's part will run. Walks the replication ladder; returns the
    plan, or None (replication), warning once when a non-trivial stack was
    exhausted."""
    rule = _RULES.get(op)
    if rule is None:
        return None
    accepted = _rule_plan_params(rule)
    kwargs = {k: v for k, v in kwargs.items() if k not in PLAN_KWARGS or k in accepted}
    offered = levels = _LEVEL_FNS.get(op, partition_levels)(mesh)
    while levels:
        plan = rule(levels, *args, impl=impl, **kwargs)
        if plan is not None:
            return plan
        levels = levels[1:]
    if offered:
        shape = "x".join(f"{a}={s}" for a, s in offered)
        warn_degrade(
            f"partition ladder exhausted for {op!r}: every rung of "
            f"({shape}) declined; replicating the call on all devices",
            key=("ladder_exhausted", op, shape),
        )
    return None


def flash_plan(mesh, q, k, v, *, impl: str | None = None, **kwargs):
    """``plan_for("flash_attention", mesh, q, k, v, impl=impl, **kwargs)``:
    the flash rule against ``mesh`` for q (B, H, Sq, D) and k, v
    (B, K, Sk, D), with ``impl`` and the op's keywords ``kwargs`` as
    ``plan_for`` takes them."""
    return plan_for("flash_attention", mesh, q, k, v, impl=impl, **kwargs)


def plan_collective_bytes(plan: PartitionPlan | None) -> int:
    """Total per-rank collective payload of ``plan`` (0 for replication)."""
    return 0 if plan is None else sum(c.nbytes for c in plan.collectives)


def local_operand_structs(plan: PartitionPlan | None, mesh, args) -> tuple:
    """``(shape, dtype)`` of each live operand of ``args`` as one rank of
    ``mesh`` holds it under ``plan`` (``None`` operands skipped;
    replication passes shapes whole)."""
    out = []
    for i, a in enumerate(args):
        if a is None:
            continue
        shape = list(a.shape)
        for d, entry in enumerate(() if plan is None else plan.in_specs[i]):
            names = () if entry is None else (entry,) if isinstance(entry, str) else entry
            for name in names:
                shape[d] //= int(mesh.shape[name])
        out.append((tuple(shape), a.dtype))
    return tuple(out)


def sharded_call(op: str, mesh, *args, impl: str | None = None, **kwargs):
    """Run ``op`` on the operands ``args`` and keywords ``kwargs`` over
    ``mesh`` by its plan through the selected ``impl``, or once,
    unsharded, when the plan is None. Returns exactly what the unsharded
    op returns, on the operands' device. A ``MeshSpec`` plans but cannot
    run a plan (``TypeError``)."""
    if not isinstance(mesh, (DeviceMesh, MeshSpec)):
        raise TypeError(f"mesh= takes a DeviceMesh (or RingMesh); got {type(mesh).__name__}")
    impl = dispatch.resolve_impl(op, impl)
    plan = plan_for(op, mesh, *args, impl=impl, **kwargs)
    if plan is None:
        return dispatch.kernel_call(op, *args, impl=impl, **strip_plan_kwargs(kwargs))
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"executing a partition plan for {op!r} needs a device mesh; "
            f"got {type(mesh).__name__} (MeshSpec is for plan_for/costing only)"
        )
    device = next(a.device for a in args if a is not None)
    if plan.pre is not None:
        args = plan.pre(*args)
    parts = [None if a is None else mesh.shard_spec(a, spec)
             for a, spec in zip(args, plan.in_specs)]
    outs = plan.local_fn(mesh, *parts)
    if isinstance(plan.out_specs, PartitionSpec):
        out = mesh.gather_spec(outs, plan.out_specs, device)
    else:
        out = tuple(mesh.gather_spec([o[i] for o in outs], spec, device)
                    for i, spec in enumerate(plan.out_specs))
    return plan.post(out) if plan.post is not None else out


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@register_partition_rule("gemm")
def _gemm_rule(levels, a, b, *, impl=None, out_dtype=None, accum_dtype=torch.float32,
               precision=None, **blocks):
    """K-sharded GEMM with a hierarchical psum (intra-pod first, so the D2D
    link moves one buffer per pod); M rows when K resists. Each shard
    quantizes its own K-slab under ``precision``; a sub-fp32 policy
    narrows the psum payload to bf16."""
    precision = prec.resolve(precision)
    M, K = a.shape
    N = b.shape[1]
    out_dtype = out_dtype or (torch.float32 if precision is not None else a.dtype)
    n = _ntot(levels)
    ax = _joint(levels)
    pk = {} if precision is None else {"precision": precision}
    reduce_dtype = accum_dtype
    if precision is not None and precision.compute_dtype.itemsize < 4:
        reduce_dtype = torch.bfloat16

    def gemm(dtype):
        return lambda a_l, b_l: dispatch.kernel_call(
            "gemm", a_l, b_l, out_dtype=dtype, accum_dtype=accum_dtype, impl=impl, **pk,
            **blocks)

    if K % n == 0:
        def local(mesh, a_p, b_p):
            sums = hierarchical_psum(_each(mesh, gemm(reduce_dtype), a_p, b_p), mesh, levels)
            return _each(mesh, lambda s: s.to(out_dtype), sums)

        return PartitionPlan(
            op="gemm", levels=tuple(levels),
            in_specs=(P(None, ax), P(ax, None)), out_specs=P(None, None),
            local_fn=local,
            collectives=_per_level_psum_costs(levels, (M, N), reduce_dtype),
            note=f"k-sharded ({K}/{n} per device over {_levels_note(levels)}), psum epilogue"
                 + (f", {_dtype_name(reduce_dtype)} reduce" if reduce_dtype != accum_dtype
                    else ""),
        )
    if M % n == 0:
        return PartitionPlan(
            op="gemm", levels=tuple(levels),
            in_specs=(P(ax, None), P(None, None)), out_specs=P(ax, None),
            local_fn=lambda mesh, a_p, b_p: _each(mesh, gemm(out_dtype), a_p, b_p),
            note=f"m-row-sharded ({M}/{n} per device over {_levels_note(levels)})",
        )
    return None


def _attn_levels_split(levels, batch: int):
    """``(head_levels, data_level, batch_ok)``: the non-``data`` levels,
    the ``("data", n)`` level if offered, and whether ``batch`` divides
    it."""
    heads = tuple(lv for lv in levels if lv[0] != "data")
    data = next((lv for lv in levels if lv[0] == "data"), None)
    return heads, data, data is not None and batch % data[1] == 0


def _attn_used(levels, head_ok: bool, data_used: bool):
    """The levels a composed attention plan shards over, in mesh order."""
    return tuple(lv for lv in levels
                 if (lv[0] == "data" and data_used) or (lv[0] != "data" and head_ok))


def _attn_head_ok(heads, count: int):
    """Whether ``count`` heads divide the head stack; None declines the rung
    (a shorter stack may still divide) when more than one head level is
    offered."""
    ok = bool(heads) and count % _ntot(heads) == 0
    if not ok and len(heads) > 1:
        return None
    return ok


def _head_note(kind, count, heads):
    return f"head-sharded ({count}/{_ntot(heads)} {kind} over {_levels_note(heads)})"


@register_partition_rule("flash_attention", levels=attention_levels)
def _flash_rule(levels, q, k, v, *, impl=None, causal=True, window=0, q_offset=0,
                scale=None, precision=None, return_lse=False, overlap=True, zigzag=True,
                remote_copy=False, **blocks):
    """GQA head sharding × a ``data`` level carrying the batch or the
    sequence.

    - **batch**: ``B % data == 0`` shards B, one kernel call per rank;
    - **sequence-parallel KV ring** (B does not divide, ``Sq == Sk``,
      ``Sq % data == 0``): on each ``data`` group every rank keeps its Q
      chunk and the K/V chunks rotate through ``hops - 1`` hops of
      ``ring_scan``, each folded through ``online_softmax_merge``:
      - the **zigzag** ring for unbounded causal attention (``zigzag``,
        ``Sq % 2d == 0``): rank i owns half-chunks i and 2d-1-i
        (``pre``/``post`` gather globally); hop 0 is one causal call,
        every later hop two unmasked calls;
      - else the **contiguous** ring: each hop at its static ``q_offset``,
        wrapped hops of a bounded mask merged as no-ops, a lookback window
        pruning the tail hops; it declines a bounded mask at a nonzero
        ``q_offset``.
    """
    B, _, Sq, _ = q.shape
    K, Sk = k.shape[1], k.shape[2]
    # precision quantizes per shard and per hop inside the impls
    pk = {} if precision is None else {"precision": precision}
    heads, data, batch_ok = _attn_levels_split(levels, B)
    head_ok = _attn_head_ok(heads, K)
    if head_ok is None:
        return None
    bounded = bool(causal or window)
    ring_ok = (data is not None and not batch_ok and Sq == Sk and Sq % data[1] == 0
               and not (bounded and q_offset != 0))
    if not head_ok and not batch_ok and not ring_ok:
        return None
    ax = _joint(heads) if head_ok else None
    used = _attn_used(levels, head_ok, batch_ok or ring_ok)
    notes = [_head_note("kv heads", K, heads)] if head_ok else []

    def fa(q_, k_, v_, **mask):
        return dispatch.kernel_call("flash_attention", q_, k_, v_, scale=scale, impl=impl,
                                    **pk, **blocks, **mask)

    if batch_ok or not ring_ok:
        dt = "data" if batch_ok else None
        h4 = P(dt, ax, None, None)
        if batch_ok:
            notes.append(f"batch-sharded (B={B}/{data[1]} over data)")
        return PartitionPlan(
            op="flash_attention", levels=used, in_specs=(h4, h4, h4),
            out_specs=(h4, P(dt, ax, None)) if return_lse else h4,
            local_fn=lambda mesh, qs, ks, vs: _each(
                mesh, lambda q_, k_, v_: fa(q_, k_, v_, causal=causal, window=window,
                                            q_offset=q_offset, return_lse=return_lse),
                qs, ks, vs),
            note=" + ".join(notes),
        )

    d = data[1]
    c = Sq // d  # per-rank chunk length (static)
    hops = d
    if window:
        # hop t's nearest k sits c*t - (c-1) behind the earliest q; hops
        # entirely beyond every row's lookback are pruned statically
        hops = min(d, max(1, -(-(window + c - 1) // c)))
    zig = bool(zigzag and causal and not window and q_offset == 0 and Sq % (2 * d) == 0)

    def local_ring(step):
        def local(mesh, qs, ks, vs):
            carries = _each(mesh, lambda q_l: (
                torch.zeros(q_l.shape, dtype=torch.float32, device=q_l.device),
                torch.full(q_l.shape[:-1], NEG_LSE, dtype=torch.float32, device=q_l.device),
            ), qs)
            carries = ring_scan(
                lambda me, carry, kv, t: step(qs[me], mesh.coords(me)["data"], carry, kv, t),
                carries, list(zip(ks, vs)), mesh, hops=hops, overlap=overlap,
                remote_copy=remote_copy, axis="data")
            outs = _each(mesh, lambda q_l, carry: (carry[0].to(q_l.dtype), carry[1]),
                         qs, carries)
            return outs if return_lse else [o for o, _ in outs]

        return local

    if zig:
        c2 = Sq // (2 * d)  # half-chunk length: rank i owns half-chunks i, 2d-1-i

        def step(q_l, me, carry, kv, t):
            o, lse = carry
            k_b, v_b = kv
            if t == 0:
                # resident hop: the local block is order-isomorphic to its
                # global rows, so a plain causal call is the global mask
                o_t, lse_t = fa(q_l, k_b, v_b, causal=True, window=0, q_offset=0,
                                return_lse=True)
                return online_softmax_merge(o, lse, o_t, lse_t)
            # hop t > 0: the resident KV left rank s = me - t (mod d). Of
            # the four (q-half x kv-half) pairs q_tail x k_head is always
            # fully valid; up-ranks (me >= t) also get q_head x k_head,
            # down-ranks (wrapped) q_tail x k_tail; every omitted pair is
            # fully masked, so both calls run unmasked
            up = me >= t
            q_head, q_tail = q_l[:, :, :c2], q_l[:, :, c2:]
            k_head, v_head = k_b[:, :, :c2], v_b[:, :, :c2]
            k_tail, v_tail = k_b[:, :, c2:], v_b[:, :, c2:]
            unmasked = dict(causal=False, window=0, q_offset=0, return_lse=True)
            o_full, lse_full = fa(q_tail, k_head, v_head, **unmasked)
            if up:
                o_sel, lse_sel = fa(q_head, k_head, v_head, **unmasked)
            else:
                o_sel, lse_sel = fa(q_tail, k_tail, v_tail, **unmasked)
            o_sel = o_sel.float()
            none_o, none_lse = torch.zeros_like(o_sel), torch.full_like(lse_sel, NEG_LSE)
            # head rows: up-ranks take the sel partial, down-ranks none;
            # tail rows: the full partial plus (down-ranks) the sel one
            if up:
                o_h, lse_h = o_sel, lse_sel
                o_m, lse_m = online_softmax_merge(o_full.float(), lse_full, none_o, none_lse)
            else:
                o_h, lse_h = none_o, none_lse
                o_m, lse_m = online_softmax_merge(o_full.float(), lse_full, o_sel, lse_sel)
            o_t = torch.cat([o_h, o_m], dim=2)
            lse_t = torch.cat([lse_h, lse_m], dim=2)
            return online_softmax_merge(o, lse, o_t, lse_t)

        idx, inv = (torch.from_numpy(a) for a in (zigzag_indices(Sq, d), zigzag_inverse(Sq, d)))

        def pre(q_g, k_g, v_g):
            return tuple(x.index_select(2, idx.to(x.device)) for x in (q_g, k_g, v_g))

        def post(out):
            if return_lse:
                return tuple(x.index_select(2, inv.to(x.device)) for x in out)
            return out.index_select(2, inv.to(out.device))

    else:
        pre = post = None

        def step(q_l, me, carry, kv, t):
            o, lse = carry
            k_b, v_b = kv
            o_t, lse_t = fa(q_l, k_b, v_b, causal=causal, window=window,
                            q_offset=q_offset + t * c, return_lse=True)
            if bounded and t:
                # ranks me < t hold a wrapped (future) KV chunk this hop:
                # the mask hides it entirely, so it merges as a no-op
                if me >= t:
                    o_t = o_t.float()
                else:
                    o_t = torch.zeros(o_t.shape, dtype=torch.float32, device=o_t.device)
                    lse_t = torch.full_like(lse_t, NEG_LSE)
            return online_softmax_merge(o, lse, o_t, lse_t)

    h4 = P(None, ax, "data", None)
    kv_local = _nbytes((B, K // _ntot(heads) if head_ok else K, Sk // d, k.shape[-1]), k.dtype)
    notes.append(f"ring seq-parallel{' zigzag' if zig else ''} "
                 f"(Sq={Sq}/{d} per device over data={d}, {hops - 1} kv hops)")
    return PartitionPlan(
        op="flash_attention", levels=used, in_specs=(h4, h4, h4),
        out_specs=(h4, P(None, ax, "data")) if return_lse else h4,
        local_fn=local_ring(step),
        collectives=tuple(CollectiveCost("permute", "data", kv_local, d)
                          for _ in range(2 * (hops - 1))),  # k and v, per hop
        note=" + ".join(notes),
        overlappable=bool(overlap and hops > 1), hops=hops, pre=pre, post=post,
    )


@register_partition_rule("decode_attention", levels=attention_levels)
def _decode_rule(levels, q, k, v, position, *, impl=None, **kwargs):
    """Heads over the non-``data`` levels × B (queries, cache rows and
    positions) over ``data``; no ring. Declines paged pools, which shard
    by pages (``serving/ring_decode.py``)."""
    if kwargs.get("block_table") is not None:
        return None
    B, K = q.shape[0], k.shape[1]
    heads, data, batch_ok = _attn_levels_split(levels, B)
    head_ok = _attn_head_ok(heads, K)
    if head_ok is None:
        return None
    if not head_ok and not batch_ok:
        return None
    ax = _joint(heads) if head_ok else None
    dt = "data" if batch_ok else None
    notes = [_head_note("kv heads", K, heads)] if head_ok else []
    if batch_ok:
        notes.append(f"batch-sharded (B={B}/{data[1]} over data)")
    o_spec = P(dt, ax, None)
    return PartitionPlan(
        op="decode_attention", levels=_attn_used(levels, head_ok, batch_ok),
        in_specs=(P(dt, ax, None), P(dt, ax, None, None), P(dt, ax, None, None), P(dt)),
        out_specs=(o_spec, P(dt, ax)) if kwargs.get("return_lse") else o_spec,
        local_fn=lambda mesh, qs, ks, vs, ps: _each(
            mesh, lambda q_, k_, v_, p_: dispatch.kernel_call(
                "decode_attention", q_, k_, v_, p_, impl=impl, **kwargs),
            qs, ks, vs, ps),
        note=" + ".join(notes),
    )


@register_partition_rule("linear_attention", levels=attention_levels)
def _linear_attention_rule(levels, r, k, v, w_log, u=None, s0=None, *, impl=None, **kwargs):
    """Every stream (r, k, v, decay, the carried state) splits on H over
    the non-``data`` levels and on B over ``data``; ``u`` is per head. No
    collective."""
    B, H = r.shape[0], r.shape[1]
    heads, data, batch_ok = _attn_levels_split(levels, B)
    head_ok = _attn_head_ok(heads, H)
    if head_ok is None:
        return None
    if not head_ok and not batch_ok:
        return None
    ax = _joint(heads) if head_ok else None
    dt = "data" if batch_ok else None
    h4 = P(dt, ax, None, None)
    notes = [_head_note("heads", H, heads)] if head_ok else []
    if batch_ok:
        notes.append(f"batch-sharded (B={B}/{data[1]} over data)")
    return PartitionPlan(
        op="linear_attention", levels=_attn_used(levels, head_ok, batch_ok),
        in_specs=(h4, h4, h4, h4, P(ax, None), h4), out_specs=(h4, h4),
        local_fn=lambda mesh, *parts: _each(
            mesh, lambda *ops_: dispatch.kernel_call("linear_attention", *ops_, impl=impl,
                                                     **kwargs),
            *parts),
        note=" + ".join(notes),
    )


@register_partition_rule("spmm")
def _spmm_rule(levels, values, cols, dense, *, impl=None, **kwargs):
    """ELL rows over pod×model; each rank streams its own value/index rows
    against a replicated dense operand."""
    R = values.shape[0]
    n = _ntot(levels)
    if R % n:
        return None
    ax = _joint(levels)
    return PartitionPlan(
        op="spmm", levels=tuple(levels),
        in_specs=(P(ax, None), P(ax, None), P(None, None)), out_specs=P(ax, None),
        local_fn=lambda mesh, *parts: _each(
            mesh, lambda *ops_: dispatch.kernel_call("spmm", *ops_, impl=impl, **kwargs),
            *parts),
        note=f"row-sharded ({R}/{n} ELL rows per device over {_levels_note(levels)})",
    )


@register_partition_rule("bsr_spmm")
def _bsr_rule(levels, tile_values, tile_rows, tile_cols, dense, *, num_rows, impl=None,
              **kwargs):
    """Disjoint nnz-tile subsets per rank, each a full-height partial, and a
    hierarchical psum of the rows (intra-pod first). Every impl of the port
    writes a block row with none of the rank's tiles as 0 (ROADMAP,
    differences by design), so the partials need no row mask before the
    sum, unlike the reference's Pallas kernel's."""
    T = tile_values.shape[0]
    n = _ntot(levels)
    if T % n or T == 0:
        return None
    F = dense.shape[1]
    ax = _joint(levels)

    def local(mesh, *parts):
        partials = _each(mesh, lambda *ops_: dispatch.kernel_call(
            "bsr_spmm", *ops_, num_rows=num_rows, impl=impl, **kwargs), *parts)
        return hierarchical_psum(partials, mesh, levels)

    return PartitionPlan(
        op="bsr_spmm", levels=tuple(levels),
        in_specs=(P(ax, None, None), P(ax), P(ax), P(None, None)), out_specs=P(None, None),
        local_fn=local,
        collectives=_per_level_psum_costs(levels, (num_rows, F), torch.float32),
        note=f"tile-sharded ({T}/{n} nnz tiles per device over {_levels_note(levels)}), "
             f"psum epilogue",
    )


@register_partition_rule("spmspm")
def _spmspm_rule(levels, a_values, a_cols, b_values, b_rows, *, contraction_dim, impl=None,
                 **kwargs):
    """A's rows over pod×model, B replicated; each rank intersects its own
    rows."""
    R = a_values.shape[0]
    n = _ntot(levels)
    if R % n:
        return None
    ax = _joint(levels)
    return PartitionPlan(
        op="spmspm", levels=tuple(levels),
        in_specs=(P(ax, None), P(ax, None), P(None, None), P(None, None)),
        out_specs=P(ax, None),
        local_fn=lambda mesh, *parts: _each(mesh, lambda *ops_: dispatch.kernel_call(
            "spmspm", *ops_, contraction_dim=contraction_dim, impl=impl, **kwargs), *parts),
        note=f"a-row-sharded ({R}/{n} rows per device over {_levels_note(levels)})",
    )


def _halo_block(width: int, cap: int, halo: int) -> int:
    """Largest block <= cap that divides ``width`` and covers the halo
    reach (the kernel requires max|dx| <= bx)."""
    for d in range(min(cap, width), 0, -1):
        if width % d == 0 and d >= halo:
            return d
    return width


@register_partition_rule("stencil")
def _stencil_rule(levels, grid, *, offsets, weights, impl=None, bx=None, overlap=True,
                  **kwargs):
    """X-slabs with the halo exchanged by ``ppermute`` (the SARIS boundary
    planes).

    Each rank pads its slab with ``h`` neighbour planes a side (the ring's
    wrap is the periodic boundary) and runs the impl on the padded slab, so
    the impl's own wrap never reaches a kept row. Slabs are pod-major: the
    exchange is a ring over the inner axis plus, at the pod edges, one hop
    over the pod axis per direction, whose payload replaces the intra-pod
    wrap.

    With ``overlap`` (when ``lx >= 2h``) the inner transfers are issued
    first, every rank's interior rows (which never reach the halo) run on
    the unpadded slab while they fly, and only two ``h``-row strips, each
    padded to ``3h`` input rows, wait for them: row for row the same sums
    in the same order as the synchronous path, so bitwise equal.
    """
    X, Y, Z = grid.shape
    h = int(np.abs(np.asarray(offsets)[:, 0]).max(initial=0))
    n = _ntot(levels)
    if X % n:
        return None
    lx = X // n
    if h > lx:
        return None  # halo wider than a slab: drop a level rather than multi-hop
    bx_cap = dispatch.resolve_blocks("stencil", bx=bx)["bx"]
    bx_local = _halo_block(lx + 2 * h, bx_cap, max(h, 1))
    ax = _joint(levels)
    inner, tp = levels[-1]
    outer = levels[:-1]  # () or the single ("pod", P) level above
    fwd = [(i, (i + 1) % tp) for i in range(tp)]
    bwd = [(i, (i - 1) % tp) for i in range(tp)]
    overlapped = bool(overlap and h and lx >= 2 * h)

    def stencil(g, block):
        return dispatch.kernel_call("stencil", g, offsets=offsets, weights=weights,
                                    impl=impl, bx=block, **kwargs)

    def exchange(mesh, gs, interior=None):
        """Each rank's (lo, hi) halo planes; ``interior`` runs on every rank
        between issuing the inner transfers and waiting for them."""
        lo = ppermute_start([g[-h:] for g in gs], mesh, inner, fwd)  # left tails
        hi = ppermute_start([g[:h] for g in gs], mesh, inner, bwd)  # right heads
        done = None if interior is None else _each(mesh, interior, gs)
        lo = [res.ready(mesh, r)[0] for r, res in enumerate(lo)]
        hi = [res.ready(mesh, r)[0] for r, res in enumerate(hi)]
        if outer:
            # pod-edge ranks got the intra-pod wrap; what they need is the
            # neighbouring pod's boundary planes, one D2D hop away
            (pod, pods), = outer
            lo_pod = ppermute(lo, mesh, pod, [(i, (i + 1) % pods) for i in range(pods)])
            hi_pod = ppermute(hi, mesh, pod, [(i, (i - 1) % pods) for i in range(pods)])
            at = [mesh.coords(r)[inner] for r in range(mesh.n)]
            lo = [lo_pod[r] if at[r] == 0 else lo[r] for r in range(mesh.n)]
            hi = [hi_pod[r] if at[r] == tp - 1 else hi[r] for r in range(mesh.n)]
        return lo, hi, done

    if overlapped:
        bx_int = _halo_block(lx, bx_cap, max(h, 1))
        bx_strip = _halo_block(3 * h, bx_cap, max(h, 1))

        def local(mesh, gs):
            # rows [h, lx-h) reach at most the slab's edges, so the unpadded
            # call's wrap never touches them (its wrapped edge rows are
            # dropped and recomputed from the strips)
            lo, hi, interior = exchange(mesh, gs, lambda g: stencil(g, bx_int)[h:lx - h])
            return _each(mesh, lambda g, lo_, hi_, mid: torch.cat([
                stencil(torch.cat([lo_, g[:2 * h]]), bx_strip)[h:2 * h], mid,
                stencil(torch.cat([g[-2 * h:], hi_]), bx_strip)[h:2 * h]]),
                gs, lo, hi, interior)

    else:
        def local(mesh, gs):
            if not h:
                return _each(mesh, lambda g: stencil(g, bx_local), gs)
            lo, hi, _ = exchange(mesh, gs)
            return _each(mesh, lambda g, lo_, hi_: stencil(torch.cat([lo_, g, hi_]),
                                                           bx_local)[h:h + lx], gs, lo, hi)

    halo_bytes = _nbytes((h, Y, Z), grid.dtype)
    colls = []
    if h:
        colls += [CollectiveCost("permute", inner, halo_bytes, tp)] * 2
        if outer:
            colls += [CollectiveCost("permute", outer[0][0], halo_bytes, outer[0][1])] * 2
    return PartitionPlan(
        op="stencil", levels=tuple(levels),
        in_specs=(P(ax, None, None),), out_specs=P(ax, None, None),
        local_fn=local, collectives=tuple(colls),
        note=f"x-sharded ({lx} planes per device over {_levels_note(levels)})"
             f", halo h={h} via ppermute"
             + (" + pod boundary hop" if h and outer else "")
             + (" (overlapped)" if overlapped else ""),
        overlappable=overlapped, hops=2 if overlapped else 0,
    )
