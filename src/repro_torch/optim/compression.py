"""Gradient compression with error feedback (port of
``repro.optim.compression``).

Each gradient leaf, plus the fp32 residual the last step's round trip
lost, goes through a ``core.precision`` policy and back to fp32; the new
residual is what this round trip lost. The default ``"bf16"`` is a plain
cast (``scale_block == 0``); block-scaled policies (``"fp8"``) quantize
per ``scale_block`` elements of the trailing axis through
``precision.quantize_blockwise`` / ``dequantize_blockwise``, the same
machinery as the scaled kernels. Scalar leaves always take the plain cast.
"""
from __future__ import annotations

import torch

from repro_torch.core import precision as prec
from repro_torch.core.tree import leaves, tree_map, unflatten


def init_error_state(params):
    """fp32 zeros shaped like ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                    params)


def compress_decompress(grads, err, policy="bf16"):
    """Returns (the gradients after the round trip, fp32; the new fp32
    residual). ``grads`` a gradient tree, ``err`` the residual tree from
    the last step (``init_error_state``'s shape), ``policy`` a policy name
    or ``Precision``."""
    p = prec.resolve(policy)

    def one(g, e):
        gf = g.float() + e
        if p.scale_block and gf.dim():
            blk = p.scale_block
            gc = prec.dequantize_blockwise(
                *prec.quantize_blockwise(gf, p, axis=-1, block=blk), axis=-1, block=blk)
        else:
            gc = gf.to(p.compute_dtype).float()
        return gc, gf - gc

    pairs = [one(g, e) for g, e in zip(leaves(grads), leaves(err))]
    return unflatten(grads, [c for c, _ in pairs]), unflatten(grads, [r for _, r in pairs])
