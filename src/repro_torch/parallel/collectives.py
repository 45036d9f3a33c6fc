"""The collectives of the partition layer, single-controller.

A port of the reference's ``repro/parallel/collectives.py``: the ring
family, ``ring_schedule`` (the hop schedule as data), ``ring_scan``
(rotate a block through a ring of ranks, folding it into a carry at every
hop) and ``online_softmax_merge`` (fold one attention partial into a
running accumulator); ``hierarchical_psum`` (the per-level all-reduce of
the partition plans); and ``ppermute``, the counterpart of
``jax.lax.ppermute`` over one mesh axis (the stencil's halo exchange).
The reference runs them inside a ``shard_map``, one traced program for
every rank; here one process drives every rank of a
``parallel.mesh.DeviceMesh`` in turn, each on its own stream, so the rank
index ``me`` is a Python int and the reference's traced ``axis_index``
branches become static. Each takes and returns per-rank lists.

A hop pushes each rank's resident block into a landing buffer owned by its
right neighbour ``(me + 1) % n``. Two CUDA events stand in for the DMA
semaphores of the reference's ``remote_ring_hop``: "landing buffer free",
recorded on the receiver's stream where the buffer is allocated and waited
on by the sender's stream before it writes; "landed", recorded on the
sender's stream after the push and waited on by the receiver's stream
before it first reads the block. The controller records each event before
any stream waits on it, so no wait can see an older generation of it.

``ring_scan_carry`` threads a linear recurrence's carry along a ring:
rank r re-scans its chunk with the true carry rank r - 1 produced.
``all_to_all`` is ``jax.lax.all_to_all`` (untiled) over one mesh axis, and
``ep_expert_ffn`` the expert-parallel FFN built on it: experts split over
an axis, token rows exchanged to their experts' ranks and back.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.diagnostics import warn_degrade
from repro_torch.hopper import ring_hop

# the flash kernels' masked-score floor: fully-masked softmax rows carry
# lse ~= NEG, which the online merge weights to exp(NEG - NEG) ~ 1 against a
# zero accumulator instead of producing -inf - -inf NaNs
NEG_LSE = -1e30


def _rings(mesh, axis):
    """The rings of ``axis`` (its groups, in axis order), or the one ring of
    every rank in rank order when ``axis`` is None."""
    return [list(range(mesh.n))] if axis is None else mesh.groups(axis)


def _hop_send(mesh, remote_copy: bool):
    """The transport of one leaf of a hop, ``send(src, dst)``: the Hopper
    ring-hop kernel (``hopper/ring_hop.py``, the counterpart of
    ``remote_ring_hop``) when ``remote_copy`` is set on a CUDA mesh, and it
    launches or raises; otherwise the plain transport ``dst.copy_(src)``,
    the counterpart of ``ppermute``. ``remote_copy=True`` on a CPU mesh
    takes the plain transport with one ``ReproDegradeWarning``, as the
    reference does off-TPU."""
    if remote_copy:
        if mesh.is_cuda:
            return ring_hop.ring_hop_cuda
        warn_degrade(
            "remote_copy=True requested on CPU tensors: the ring-hop kernel "
            "runs on the card only, falling back to the plain transport "
            "(identical bytes)",
            key=("remote_copy_fallback", "cpu"),
        )
    return ring_hop.ring_hop_plain


@dataclasses.dataclass(frozen=True)
class HopEvent:
    """One event of a ring hop schedule, in issue order.

    Fields: ``kind`` — ``"send"``, ``"dma_start"`` / ``"dma_wait"`` (the
    remote-copy form of a send) or ``"fold"``; ``hop`` — the hop index the
    event serves; ``src`` — the buffer id the event reads; ``dst`` — the
    buffer id a transfer lands in (None for folds).
    """

    kind: str
    hop: int
    src: int | None = None
    dst: int | None = None


def ring_schedule(hops: int, *, overlap: bool = True,
                  remote_copy: bool = False) -> tuple:
    """The ring hop schedule as data, event for event the reference's:
    ``overlap`` issues hop t+1's transfer before hop t's fold (else after
    it); ``remote_copy`` expands each send into its ``dma_start`` /
    ``dma_wait`` pair. Blocks alternate between buffers ``t % 2``.
    Returns a tuple of ``HopEvent``."""
    events = []

    def send(t):
        src, dst = (t - 1) % 2, t % 2
        if remote_copy:
            events.append(HopEvent("dma_start", t, src, dst))
            events.append(HopEvent("dma_wait", t, None, dst))
        else:
            events.append(HopEvent("send", t, src, dst))

    for t in range(hops):
        if overlap and t + 1 < hops:
            send(t + 1)
        events.append(HopEvent("fold", t, t % 2))
        if not overlap and t + 1 < hops:
            send(t + 1)
    return tuple(events)


class _Resident:
    """A block resident at one rank, and the "landed" event its rank's
    stream has to wait on before the first read (None once waited)."""

    __slots__ = ("block", "landed")

    def __init__(self, block, landed=None):
        self.block, self.landed = block, landed

    def ready(self, mesh, me):
        if self.landed is not None:
            mesh.streams[me].wait_event(self.landed)
            self.landed = None
        return self.block


def _push(mesh, send, block, me: int, to: int) -> _Resident:
    """Push rank ``me``'s ``block`` (every leaf) into new landing buffers of
    rank ``to``: allocated under ``to``'s stream, written on ``me``'s."""
    if not mesh.is_cuda:
        landing = tuple(torch.empty_like(x) for x in block)
        for x, y in zip(block, landing):
            send(x, y)
        return _Resident(landing)
    with mesh.on(to):
        landing = tuple(torch.empty_like(x, device=mesh.devices[to]) for x in block)
        free = torch.cuda.Event()
        free.record(mesh.streams[to])
    sender = mesh.streams[me]
    sender.wait_event(free)
    with mesh.on(me):
        for x, y in zip(block, landing):
            send(x, y)
            if y.device == mesh.devices[me]:
                y.record_stream(sender)
        landed = torch.cuda.Event()
        landed.record(sender)
    return _Resident(landing, landed)


def ring_scan(step_fn, carries, blocks, mesh, *, hops: int | None = None,
              overlap: bool = True, remote_copy: bool = False, axis: str | None = None) -> list:
    """Rotate every rank's block through its ring, folding it into that
    rank's carry at every hop.

    Args: ``step_fn(me, carry, block, t) -> carry`` — called once per rank
    and hop, under rank ``me``'s device and stream; at hop ``t`` the
    resident block is the one the rank ``t`` places behind ``me`` on its
    ring started with; ``carries`` / ``blocks`` — per-rank lists (a block
    is a tuple of tensors; every leaf hops); ``mesh`` — the ``DeviceMesh``;
    ``hops`` — fold count (default the ring's length); ``overlap`` — issue
    hop t+1's transfers before hop t's folds (else after); ``remote_copy``
    — the transport of each send (``_hop_send``); ``axis`` — the rings are
    the groups of this mesh axis (default: one ring of every rank, in rank
    order).

    Replays ``ring_schedule(hops, overlap=overlap)`` event by event, as the
    reference does; each event is applied to every rank in turn. Fires
    ``hops - 1`` sends per rank, one transport call per leaf. Returns the
    per-rank list of folded carries.
    """
    n = mesh.n
    if len(carries) != n or len(blocks) != n:
        raise ValueError(f"ring_scan: {len(carries)} carries, {len(blocks)} blocks "
                         f"for {n} ranks")
    rings = _rings(mesh, axis)
    hops = len(rings[0]) if hops is None else hops
    pairs = [(g[i], g[(i + 1) % len(g)]) for g in rings for i in range(len(g))]
    send = _hop_send(mesh, remote_copy)
    carries = list(carries)
    buffers = [{0: _Resident(b)} for b in blocks]
    for ev in ring_schedule(hops, overlap=overlap):
        if ev.kind == "send":
            landed = [None] * n
            for me, to in pairs:
                block = buffers[me][ev.src].ready(mesh, me)
                landed[to] = _push(mesh, send, block, me, to)
            for me in range(n):
                buffers[me][ev.dst] = landed[me]
        else:  # fold
            for me in range(n):
                block = buffers[me][ev.src].ready(mesh, me)
                with mesh.on(me):
                    carries[me] = step_fn(me, carries[me], block, ev.hop)
    return carries


def ppermute_start(parts, mesh, axis: str, perm) -> list:
    """Issue ``ppermute``'s transfers and return each rank's ``_Resident``
    landing without making any rank wait for it: a caller that has other
    work for a rank's stream queues it first, then takes the part with
    ``.ready(mesh, r)[0]``."""
    out = [None] * mesh.n
    for g in mesh.groups(axis):
        for src, dst in perm:
            out[g[dst]] = _push(mesh, ring_hop.ring_hop_plain, (parts[g[src]],),
                                g[src], g[dst])
    for r in range(mesh.n):
        if out[r] is None:  # perm sends rank r nothing: zeros, as in the reference
            with mesh.on(r):
                out[r] = _Resident((torch.zeros_like(parts[r], device=mesh.devices[r]),))
    return out


def ppermute(parts, mesh, axis: str, perm) -> list:
    """``jax.lax.ppermute`` over ``axis``: in every group of ``axis``, the
    rank at axis index ``src`` sends its part to the rank at ``dst``, for
    each ``(src, dst)`` of ``perm``. Returns the per-rank received parts,
    each in a new allocation of its receiver (zeros where ``perm`` sends
    it nothing). The transport is ``ring_hop.ring_hop_plain`` on the
    sender's stream, fenced by the ring's free / landed events
    (``_push``)."""
    return [res.ready(mesh, r)[0] for r, res in enumerate(ppermute_start(parts, mesh, axis, perm))]


def ring_scan_carry(chunk_fn, xs, s0, mesh, axis: str, *, overlap: bool = True):
    """Sequence-parallel linear-recurrence carry over a ``ppermute`` ring
    on ``axis``: rank ``r`` scans its chunk with the true carry rank
    ``r - 1`` produced (the reference's ``ring_scan_carry``).

    Args: ``chunk_fn(me, state, xs_local) -> (state_out, ys_local)`` — the
    per-chunk scan, called under rank ``me``'s device and stream;
    ``xs`` — the per-rank chunks; ``s0`` — the global initial state (only
    the first rank of each ring consumes it); ``overlap`` — issue hop
    ``t``'s transfer the moment ``chunk_fn`` produced its state, before
    the ranks' outputs are taken; ``overlap=False`` takes them first (the
    reference's synchronous order). The carry is a tensor.

    The reference runs the ring SPMD: every rank evaluates ``chunk_fn`` at
    every hop and keeps hop ``me``'s result. A single controller knows
    ``me``, so only the kept evaluations run: at hop ``t`` the rank at axis
    index ``t`` of each group scans with the carry that arrived from index
    ``t - 1``, and sends its end state on (one ``ppermute`` a hop, plain
    transport). Returns per-rank lists ``(ys, s_out)``; the last rank's
    ``s_out`` of each group is that group's final state.
    """
    groups = mesh.groups(axis)
    n = len(groups[0])
    if len(xs) != mesh.n:
        raise ValueError(f"ring_scan_carry: {len(xs)} chunks for {mesh.n} ranks")
    ys, s_out = [None] * mesh.n, [None] * mesh.n
    carry = {}  # rank -> the carry it scans with
    for g in groups:
        carry[g[0]] = mesh.own(s0, g[0])
    for t in range(n):
        for g in groups:
            me = g[t]
            with mesh.on(me):
                s_out[me], y = chunk_fn(me, carry.pop(me), xs[me])
            if not overlap:
                ys[me] = y
            if t + 1 < n:  # the hop: this rank's end state to the next rank
                carry[g[t + 1]] = _to_rank(mesh, s_out[me], me, g[t + 1])
            if overlap:
                ys[me] = y
    return ys, s_out


def _to_rank(mesh, x, src: int, dst: int):
    """Rank ``src``'s ``x`` copied into a new allocation of rank ``dst``,
    fenced by the ring's events (``_push``), card to card or on one card."""
    return _push(mesh, ring_hop.ring_hop_plain, (x,), src, dst).ready(mesh, dst)[0]


def hierarchical_psum(parts, mesh, levels) -> list:
    """Reduce the per-rank ``parts`` across a hierarchy of mesh axes,
    innermost level first (the reference's ``hierarchical_psum``).

    ``levels`` is an outer-to-inner tuple of ``(axis, size)`` pairs (a
    ``PartitionPlan.levels``); size-1 levels are skipped. At each level,
    every group of the axis sums its parts in increasing axis index, in
    fp32, rounded once to the parts' dtype, on the stream of the group's
    first rank (a part on another card is first copied there); every other
    rank of the group then gets a copy of that sum in its own allocation,
    so the group's results are bitwise equal. Returns the per-rank reduced
    parts. Plain tensor code, as the reference's ``psum`` is XLA's
    collective with no kernel of its own."""
    parts = list(parts)
    for axis, size in reversed(tuple(levels)):
        if size <= 1:
            continue
        for g in mesh.groups(axis):
            root = g[0]
            terms = [parts[root]]
            for r in g[1:]:
                if parts[r].device == parts[root].device:
                    mesh._handoff(parts[r], r, root)
                    terms.append(parts[r])
                else:
                    terms.append(_to_rank(mesh, parts[r], r, root))
            with mesh.on(root):
                acc = terms[0].float() + terms[1].float()
                for t in terms[2:]:
                    acc += t.float()
                parts[root] = acc.to(terms[0].dtype)
            for r in g[1:]:
                parts[r] = _to_rank(mesh, parts[root], root, r)
    return parts


def all_to_all(parts, mesh, axis: str, split_dim: int, concat_dim: int) -> list:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=False)``:
    in every group of ``axis`` (``n`` ranks), the rank at axis index ``i``
    splits its part along ``split_dim`` (whose size must be ``n``) and
    sends slab ``j`` to the rank at index ``j``, which stacks the ``n``
    slabs it receives along a new ``concat_dim`` in the order of their
    senders' indices. A part's shape becomes
    ``insert(delete(shape, split_dim), concat_dim, n)``. Each slab is cut
    on its sender's stream and goes through ``_to_rank`` (the ring's fenced
    copy; a rank's own slab too); each result is a new allocation of its
    rank."""
    parts = list(parts)
    out = [None] * mesh.n
    for g in mesh.groups(axis):
        n = len(g)
        for r in g:
            if parts[r].shape[split_dim] != n:
                raise ValueError(f"all_to_all: dim {split_dim} of {tuple(parts[r].shape)} is "
                                 f"not the {n} ranks of {axis!r}")
        for j, dst in enumerate(g):
            slabs = []
            for src in g:
                with mesh.on(src):  # the slab is cut on the stream that made the part
                    slab = parts[src].select(split_dim, j).contiguous()
                slabs.append(_to_rank(mesh, slab, src, dst))
            with mesh.on(dst):
                out[dst] = torch.stack(slabs, concat_dim)
    return out


def ep_expert_ffn(disp, wi, wg, wo, act, mesh, dp, *, ep_axis: str = "model"):
    """Expert-parallel FFN on capacity-dispatched tokens (the reference's
    ``ep_expert_ffn``).

    ``disp`` (B, E, C, d) is split over the ``dp`` axes (a name or a tuple)
    and whole on every rank of ``ep_axis``; the expert weights ``wi``,
    ``wg`` (E, d, f; ``wg`` None for an ungated activation) and ``wo``
    (E, f, d) are split over ``ep_axis`` on E: global tensors, or
    ``sharding.Placed`` parts on ``mesh`` with that spec (placed once,
    reused across calls). Each rank regroups its (b, E, C, d) rows as
    (ep, b, E / ep, C, d) and exchanges them over ``ep_axis``
    (``all_to_all``, split 0, concat 1), so that it holds every row of its
    own experts; runs the FFN on them as the TP path does
    (``act(x wg) * (x wi)`` in fp32 from products in ``disp``'s dtype,
    rounded to it for ``wo``) and exchanges the results back the same
    way. Returns the global (B, E, C, d) output, on ``disp``'s device.
    With ``disp`` whole on ``ep_axis`` (the reference's in_specs), every
    rank of a data group receives its group's rows from each of the ep
    ranks: it runs its experts on ep copies of them.

    The reference's return exchange (split 0, concat 0, then a reshape)
    puts rows back in place only where a data rank holds one batch row
    (B / |dp| = 1) or ``ep_axis`` has one rank; here every row returns to
    where it came from at any batch. Raises ``ValueError`` where E does
    not split over ``ep_axis``."""
    from repro_torch.parallel import sharding as sh

    ep = mesh.shape[ep_axis]
    E = disp.shape[1]
    if E % ep:
        raise ValueError(f"ep_expert_ffn: {E} experts do not split over {ep_axis}={ep}")
    e_loc = E // ep

    def parts_of(w):
        if w is None:
            return [None] * mesh.n
        if isinstance(w, sh.Placed):
            if tuple(w.sharding.spec)[:1] != (ep_axis,) or w.sharding.mesh is not mesh:
                raise ValueError(f"ep_expert_ffn: expert weights placed as "
                                 f"{tuple(w.sharding.spec)}, not ({ep_axis!r}, ...) on this mesh")
            return w.parts
        return mesh.shard_spec(w, (ep_axis,))

    wi_p, wg_p, wo_p = parts_of(wi), parts_of(wg), parts_of(wo)
    spec = (dp,)
    rows = []
    for r, x in enumerate(mesh.shard_spec(disp, spec)):
        b, _, C, d = x.shape
        with mesh.on(r):
            rows.append(x.reshape(b, ep, e_loc, C, d).transpose(0, 1))
    xs = all_to_all(rows, mesh, ep_axis, 0, 1)  # (b, ep, e_loc, C, d): sender on dim 1
    ys = []
    for r, x in enumerate(xs):
        b, _, _, C, d = x.shape
        with mesh.on(r):
            x = x.reshape(b * ep, e_loc, C, d)
            h = torch.einsum("becd,edf->becf", x, wi_p[r]).float()
            if wg_p[r] is not None:
                h = act(torch.einsum("becd,edf->becf", x, wg_p[r]).float()) * h
            y = torch.einsum("becf,efd->becd", h.to(x.dtype), wo_p[r])
            ys.append(y.reshape(b, ep, e_loc, C, d).transpose(0, 1))
    back = all_to_all(ys, mesh, ep_axis, 0, 1)  # (b, ep, e_loc, C, d): owner on dim 1
    outs = []
    for r, y in enumerate(back):
        b, _, _, C, d = y.shape
        with mesh.on(r):
            outs.append(y.reshape(b, E, C, d))
    return mesh.gather_spec(outs, spec, disp.device)


def online_softmax_merge(o_acc, lse_acc, o, lse):
    """Merge one attention partial into a running online-softmax
    accumulator: ``o_acc`` / ``lse_acc`` the running output and
    log-sum-exp (init 0 and ``NEG_LSE``), ``o`` / ``lse`` a new partial
    (softmax-normalised output and its lse over the same rows). Returns the
    merged ``(o, lse)`` in fp32, each side reweighted by
    ``exp(lse_side - lse_merged)``."""
    lse_new = torch.logaddexp(lse_acc, lse)
    w_acc = torch.exp(lse_acc - lse_new)[..., None]
    w = torch.exp(lse - lse_new)[..., None]
    return o_acc.float() * w_acc + o.float() * w, lse_new
