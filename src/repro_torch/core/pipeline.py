"""Tiling above the kernel level (port of ``repro.core.pipeline``).

``tiled_map`` applies a function tile by tile along one axis, so only one
tile's intermediates are live at a time; ``tiled_gemm`` streams A's rows
through ``ops.gemm`` (the Hopper GEMM kernel on the card, forward only:
it has no backward); ``microbatched`` accumulates a loss-and-gradients
function over batch tiles. The reference runs its tiles under
``lax.map`` / ``lax.scan``, which XLA may overlap; here they run one
after another on the current stream.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.tree import leaves, tree_map, unflatten


def tiled_map(fn: Callable, x, tile: int, axis: int = 0):
    """``fn`` over tiles of ``tile`` rows along ``axis`` (which ``tile``
    must divide), the results joined along the same axis."""
    n = x.shape[axis]
    if n % tile:
        raise ValueError(f"tiled_map: tile {tile} does not divide {n} along axis {axis}")
    xt = torch.movedim(x, axis, 0)
    ys = [fn(xt[i: i + tile]) for i in range(0, n, tile)]
    return torch.movedim(torch.cat(ys, 0), 0, axis)


def tiled_gemm(a, b, tile_m: int = 1024, gemm_fn: Callable | None = None):
    """C = A @ B with A streamed in row tiles of ``tile_m`` through
    ``gemm_fn`` (default ``ops.gemm``)."""
    from repro_torch.hopper import ops

    gemm_fn = gemm_fn or ops.gemm
    return tiled_map(lambda at: gemm_fn(at, b), a, tile_m, axis=0)


def microbatched(step_fn: Callable, n_micro: int):
    """Gradient accumulation: ``step_fn(params, batch) -> (loss, grads)``
    run on ``n_micro`` row tiles of the batch (each tile ``B / n_micro``
    consecutive rows), the losses and fp32 gradients summed and scaled by
    ``1 / n_micro``. Returns a function of the same signature."""

    def wrapped(params, batch):
        sizes = {x.shape[0] for x in leaves(batch)}
        if len(sizes) != 1 or next(iter(sizes)) % n_micro:
            raise ValueError(f"microbatched: batch rows {sorted(sizes)} do not split "
                             f"into {n_micro} tiles")
        rows = next(iter(sizes)) // n_micro
        loss_acc = None
        acc = None
        for i in range(n_micro):
            mb = tree_map(lambda x: x[i * rows: (i + 1) * rows], batch)
            loss, grads = step_fn(params, mb)
            loss_acc = loss.float() if loss_acc is None else loss_acc + loss.float()
            if acc is None:
                acc = [torch.zeros_like(g, dtype=torch.float32)
                       for g in leaves(grads)]
            for a, g in zip(acc, leaves(grads)):
                a.add_(g.float())
            del grads
        scale = 1.0 / n_micro
        return loss_acc * scale, unflatten(params, [a.mul_(scale) for a in acc])

    return wrapped
