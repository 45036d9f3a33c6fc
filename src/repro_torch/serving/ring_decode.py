"""Cache-sharded ring decode over a ``RingMesh`` (the reference's
``serving/ring_decode.py``).

The serving case: a paged KV cache bigger than one device. The page pools
shard over the ring: rank r owns the pages behind every sequence's logical
cache blocks ``[r*NB_l, (r+1)*NB_l)``, and its table columns index its own
local pool. Each decode step folds per-shard partials into the exact
softmax:

  1. every rank runs the paged ``decode_attention`` over its table slab
     with ``pos_offset = r * NB_l * bs`` and ``return_lse=True``;
  2. the partials rotate through ``collectives.ring_scan`` (plain
     transport: the reference's ring decode has no ``remote_copy``, so no
     ring-hop kernel runs here);
  3. each rank stashes every arriving partial at its global shard index
     and folds the set in rank order 0..n-1 through
     ``online_softmax_merge``.

Folding in global order makes every rank's merge chain the same, so the
result equals ``ring_decode_reference`` (the same chain on one device)
bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.hopper import ops
from repro_torch.parallel import collectives

__all__ = ["ring_decode", "ring_decode_reference"]


def _shard_partial(q, k_pool, v_pool, block_table, position, *, base,
                   window, scale, k_scale, v_scale, impl):
    """One shard's paged decode partial: (o, lse), lse fp32 (B, H)."""
    return ops.kernel_call(
        "decode_attention", q, k_pool, v_pool, position, impl=impl,
        window=window, scale=scale, block_table=block_table,
        k_scale=k_scale, v_scale=v_scale, pos_offset=base, return_lse=True,
    )


def _fold(q, parts):
    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full(q.shape[:2], collectives.NEG_LSE, dtype=torch.float32,
                         device=q.device)
    for o_r, lse_r in parts:
        o_acc, lse_acc = collectives.online_softmax_merge(o_acc, lse_acc, o_r, lse_r)
    return o_acc.to(q.dtype)


def ring_decode(q, k_pool, v_pool, block_table, position, mesh, *,
                window: int = 0, scale=None, k_scale=None, v_scale=None,
                impl=None, overlap: bool = True):
    """Decode against a cache sharded over ``mesh`` (a ``RingMesh``).

    Args: ``q`` (B, H, D) and ``position`` (B,), replicated to every rank;
    ``k_pool`` / ``v_pool`` (P, K, bs, D), sharded on P (rank r holds
    pages ``[r*P/n, (r+1)*P/n)``); ``block_table`` (B, NB), sharded on
    columns, each entry indexing the owning rank's local pool;
    ``k_scale`` / ``v_scale`` — optional (P, K, bs, 1) pool scales,
    sharded like the pools; ``window``, ``scale``, ``impl`` as in
    ``ops.decode_attention``; ``overlap=False`` is the synchronous ring.

    Returns (B, H, D) in ``q.dtype`` on ``q``'s device: rank 0's copy of
    the replicated result, bitwise ``ring_decode_reference``'s.
    """
    n = mesh.n
    NB = block_table.shape[1]
    bs = k_pool.shape[2]
    if NB % n or k_pool.shape[0] % n:
        raise ValueError(
            f"ring_decode: table columns ({NB}) and pool pages "
            f"({k_pool.shape[0]}) must split over the ring's {n} ranks"
        )
    nb_l = NB // n
    qs, pos = mesh.replicate(q), mesh.replicate(position)
    kps, vps = mesh.shard(k_pool, 0), mesh.shard(v_pool, 0)
    tbls = mesh.shard(block_table, 1)
    kss = vss = [None] * n
    if k_scale is not None:
        kss, vss = mesh.shard(k_scale, 0), mesh.shard(v_scale, 0)
    blocks, stashes = [], []
    for me in range(n):
        with mesh.on(me):
            o_l, lse_l = _shard_partial(
                qs[me], kps[me], vps[me], tbls[me], pos[me], base=me * nb_l * bs,
                window=window, scale=scale, k_scale=kss[me], v_scale=vss[me], impl=impl,
            )
            blocks.append((o_l.float(), lse_l))
            stashes.append((None,) * n)

    def stash(me, slots, blk, t):
        # each arriving partial goes to its global shard index
        slots = list(slots)
        slots[(me - t) % n] = blk
        return tuple(slots)

    stashes = collectives.ring_scan(stash, stashes, blocks, mesh, overlap=overlap)
    outs = []
    for me in range(n):
        with mesh.on(me):
            outs.append(_fold(qs[me], stashes[me]))
    return mesh.collect(outs[0], 0, q.device)


def ring_decode_reference(q, k_pool, v_pool, block_table, position, n, *,
                          window: int = 0, scale=None, k_scale=None,
                          v_scale=None, impl=None):
    """Single-device simulation of the n-shard merge chain: the same
    per-shard paged partials, folded in the same global order; the bitwise
    oracle for ``ring_decode``."""
    NB = block_table.shape[1]
    bs = k_pool.shape[2]
    nb_l = NB // n
    p_l = k_pool.shape[0] // n
    parts = []
    for r in range(n):
        sl = slice(r * p_l, (r + 1) * p_l)
        o_r, lse_r = _shard_partial(
            q, k_pool[sl], v_pool[sl], block_table[:, r * nb_l:(r + 1) * nb_l], position,
            base=r * nb_l * bs, window=window, scale=scale,
            k_scale=None if k_scale is None else k_scale[sl],
            v_scale=None if v_scale is None else v_scale[sl], impl=impl,
        )
        parts.append((o_r.float(), lse_r))
    return _fold(q, parts)
