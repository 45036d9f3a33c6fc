"""Ring-mesh partitioning of flash attention: the ``data`` level of the
reference's ``kernels/partition.py``.

``ops.flash_attention(..., mesh=RingMesh(n))`` routes here.
``flash_plan`` resolves the reference's flash rule against the ring into
a ``PartitionPlan``; ``sharded_flash_attention`` runs the plan: the
plan's ``pre`` rewrite of the global operands, one part per rank
(``RingMesh.shard`` along the plan's ``dim``), the plan's ``local_fn``
over every rank, the parts gathered back and the plan's ``post`` rewrite.
A rule that declines leaves nothing to shard: the call replicates, as in
the reference, and runs once, unsharded, on the operands' device, with
one ``ReproDegradeWarning`` naming the op and the ring.

The flash rule at the ``data`` level, in preference order (the
reference's ``_flash_rule``):

- **batch**: ``B % n == 0`` shards B, one kernel call per rank, no hop;
- **sequence-parallel KV ring** (``Sq == Sk``, ``Sq % n == 0``): each rank
  keeps its Q chunk and the K/V chunks rotate through ``n - 1`` hops of
  ``collectives.ring_scan``; every hop calls the kernel and folds the
  partial through ``online_softmax_merge``:
  - the **zigzag** ring for unbounded causal attention (``zigzag``,
    ``Sq % 2n == 0``): rank r owns half-chunks r and 2n-1-r (``pre`` /
    ``post`` gather globally); hop 0 is one causal call, every later hop
    two unmasked calls;
  - else the **contiguous** ring: each hop at its static ``q_offset``,
    wrapped hops of a bounded mask merged as no-ops, and a lookback
    window pruning the tail hops.
- the ring declines a bounded mask (causal or window) at a nonzero
  ``q_offset``.

Head sharding over a ``model`` level and the other ops' rules are not
ported (the ring is the port's only mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.diagnostics import warn_degrade
from repro_torch.hopper import dispatch
from repro_torch.hopper.flash_attention import zigzag_indices, zigzag_inverse
from repro_torch.parallel.collectives import NEG_LSE, online_softmax_merge, ring_scan

# plan-only keywords: schedule knobs the partition layer consumes, never the
# kernels; stripped before any direct kernel call
PLAN_KWARGS = ("overlap", "zigzag", "remote_copy")


def strip_plan_kwargs(kwargs: dict) -> dict:
    """``kwargs`` without the plan-only schedule keywords."""
    return {k: v for k, v in kwargs.items() if k not in PLAN_KWARGS}


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A resolved partitioning of one flash-attention call over a ring.

    Fields: ``dim`` — the dimension of every operand and output split over
    the ring (0: batch, 2: sequence); ``local_fn`` — ``local_fn(mesh,
    *per-rank operand lists) -> per-rank outputs``; ``note`` — the
    reference's one-line description; ``overlappable`` — the ring issues
    its hops double-buffered; ``hops`` — the ring's fold count (0 without
    a ring); ``pre`` / ``post`` — global rewrites before sharding and after
    gathering (the zigzag permutation).
    """

    dim: int
    local_fn: Callable
    note: str = ""
    overlappable: bool = False
    hops: int = 0
    pre: Callable | None = None
    post: Callable | None = None


def flash_plan(mesh, q, k, v, *, impl: str | None = None, **kwargs):
    """The flash rule resolved against ``mesh``'s ``n`` ranks; ``None``
    means replication (one rank, or the rule declined, which also warns
    once)."""
    if mesh.n < 2:
        return None
    plan = _flash_rule(mesh.n, q, k, v, impl=impl, **kwargs)
    if plan is None:
        shape = f"data={mesh.n}"
        warn_degrade(
            f"partition ladder exhausted for 'flash_attention': every rung of "
            f"({shape}) declined; replicating the call on all devices",
            key=("ladder_exhausted", "flash_attention", shape),
        )
    return plan


def sharded_flash_attention(mesh, q, k, v, *, impl: str | None = None, **kwargs):
    """Flash attention over ``mesh`` by its plan, or unsharded when the
    plan is ``None``. Returns exactly what the unsharded op returns, on the
    operands' device."""
    impl = dispatch.resolve_impl("flash_attention", impl)
    plan = flash_plan(mesh, q, k, v, impl=impl, **kwargs)
    if plan is None:
        return dispatch.kernel_call("flash_attention", q, k, v, impl=impl,
                                    **strip_plan_kwargs(kwargs))
    device = q.device
    args = (q, k, v) if plan.pre is None else plan.pre(q, k, v)
    outs = plan.local_fn(mesh, *(mesh.shard(a, plan.dim) for a in args))
    if isinstance(outs[0], tuple):
        out = tuple(mesh.gather([o[i] for o in outs], plan.dim, device)
                    for i in range(len(outs[0])))
    else:
        out = mesh.gather(outs, plan.dim, device)
    return plan.post(out) if plan.post is not None else out


def _flash_rule(d, q, k, v, *, impl=None, causal=True, window=0,
                q_offset=0, scale=None, precision=None, return_lse=False,
                overlap=True, zigzag=True, remote_copy=False, **blocks):
    B, _, Sq, _ = q.shape
    Sk = k.shape[2]
    batch_ok = B % d == 0
    bounded = bool(causal or window)
    ring_ok = (not batch_ok and Sq == Sk and Sq % d == 0
               and not (bounded and q_offset != 0))
    if not batch_ok and not ring_ok:
        return None
    # precision quantizes per shard and per hop inside the impls
    kw = dict(scale=scale, impl=impl, **({} if precision is None else {"precision": precision}),
              **blocks)

    def fa(q_, k_, v_, **mask):
        return dispatch.kernel_call("flash_attention", q_, k_, v_, **mask, **kw)

    if batch_ok:
        def local_batch(mesh, qs, ks, vs):
            outs = []
            for me in range(mesh.n):
                with mesh.on(me):
                    outs.append(fa(qs[me], ks[me], vs[me], causal=causal, window=window,
                                   q_offset=q_offset, return_lse=return_lse))
            return outs

        return PartitionPlan(dim=0, local_fn=local_batch,
                             note=f"batch-sharded (B={B}/{d} over data)")

    c = Sq // d  # per-rank chunk length (static)
    hops = d
    if window:
        # hop t's nearest k sits c*t - (c-1) behind the earliest q; hops
        # entirely beyond every row's lookback are pruned statically
        hops = min(d, max(1, -(-(window + c - 1) // c)))
    zig = bool(zigzag and causal and not window and q_offset == 0 and Sq % (2 * d) == 0)

    def local_ring(step):
        def local(mesh, qs, ks, vs):
            carries = []
            for me in range(mesh.n):
                with mesh.on(me):
                    q_l = qs[me]
                    carries.append((
                        torch.zeros(q_l.shape, dtype=torch.float32, device=q_l.device),
                        torch.full(q_l.shape[:-1], NEG_LSE, dtype=torch.float32,
                                   device=q_l.device),
                    ))
            carries = ring_scan(lambda me, carry, kv, t: step(qs[me], me, carry, kv, t),
                                carries, list(zip(ks, vs)), mesh, hops=hops,
                                overlap=overlap, remote_copy=remote_copy)
            outs = []
            for me, (o, lse) in enumerate(carries):
                with mesh.on(me):
                    o = o.to(qs[me].dtype)
                outs.append((o, lse) if return_lse else o)
            return outs

        return local

    if zig:
        c2 = Sq // (2 * d)  # half-chunk length: rank r owns half-chunks r, 2d-1-r

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

    return PartitionPlan(
        dim=2, local_fn=local_ring(step),
        note=(f"ring seq-parallel{' zigzag' if zig else ''} "
              f"(Sq={Sq}/{d} per device over data={d}, {hops - 1} kv hops)"),
        overlappable=bool(overlap and hops > 1), hops=hops, pre=pre, post=post,
    )
