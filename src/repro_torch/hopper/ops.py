"""The port's op entry points, dispatched through ``hopper.dispatch``.

Public signatures and argument checks follow ``repro.kernels.ops``'s
``gemm``, ``flash_attention``, ``decode_attention`` and ``spmm``. The
implementations:

  - ``cuda``:  the Hopper kernels' wrappers, ``hopper/gemm.py``,
               ``hopper/flash_attention.py`` and ``hopper/spmm.py``
               (decode attention has no kernel, as in the reference)
  - ``torch``: ``hopper/blocked.py``, the plain forms
  - ``ref``:   ``hopper/ref.py``, the naive oracles

``precision=`` (narrow operands) and ``mesh=`` (sharded execution) raise
``NotImplementedError`` until the port's precision and multi-GPU slices
land.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse import EllMatrix
from repro_torch.hopper import blocked as _blocked
from repro_torch.hopper import dispatch
from repro_torch.hopper import flash_attention as _fa
from repro_torch.hopper import gemm as _gemm
from repro_torch.hopper import ref as _ref
from repro_torch.hopper import spmm as _spmm
from repro_torch.hopper.dispatch import kernel_call, resolve_blocks


def _not_yet(precision, mesh):
    if precision is not None:
        raise NotImplementedError("precision= is not ported yet")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet")


# ---------------------------------------------------------------------------
# Dense GEMM
# ---------------------------------------------------------------------------


def gemm(a, b, *, out_dtype=None, accum_dtype=torch.float32, precision=None,
         impl=None, mesh=None, bm=None, bk=None, bn=None):
    """C = A @ B with widening accumulation: a (M, K), b (K, N); the
    output is ``out_dtype`` (default ``a.dtype``). ``bm``/``bk``/``bn``
    shape the plain form only."""
    _not_yet(precision, mesh)
    blocks = resolve_blocks("gemm", bm=bm, bk=bk, bn=bn)
    return kernel_call("gemm", a, b, out_dtype=out_dtype,
                       accum_dtype=accum_dtype, impl=impl, **blocks)


dispatch.register_kernel("gemm", impl="cuda")(_gemm.gemm_cuda)
dispatch.register_kernel("gemm", impl="torch")(_blocked.gemm_blocked)


@dispatch.register_kernel("gemm", impl="ref")
def _gemm_ref(a, b, *, out_dtype=None, accum_dtype=torch.float32,
              bm=None, bk=None, bn=None):
    return _ref.gemm_ref(a, b, out_dtype=out_dtype, accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    scale=None, precision=None, impl=None, mesh=None,
                    bq=None, bk=None, block_k=None, return_lse=False):
    """q: (B,H,Sq,D); k,v: (B,K,Sk,D). Returns (B,H,Sq,D).

    ``window > 0`` is a lookback window: each query attends to keys in
    ``(q_pos - window, q_pos]``, so a window bounds future positions even
    with ``causal=False``. ``return_lse=True`` also returns the per-row
    log-sum-exp, (B,H,Sq) fp32. ``block_k`` is the historical spelling of
    ``bk``; ``bq``/``bk`` shape the plain form only.
    """
    if block_k is not None:
        if bk is not None and bk != block_k:
            raise TypeError(
                f"flash_attention: bk={bk} and its alias block_k={block_k} disagree"
            )
        bk = block_k
    _not_yet(precision, mesh)
    blocks = resolve_blocks("flash_attention", bq=bq, bk=bk)
    return kernel_call(
        "flash_attention", q, k, v, causal=causal, window=window,
        q_offset=q_offset, scale=scale, return_lse=return_lse, impl=impl,
        **blocks,
    )


dispatch.register_kernel("flash_attention", impl="cuda")(_fa.flash_attention_cuda)
dispatch.register_kernel("flash_attention", impl="torch")(
    _blocked.flash_attention_blocked
)


@dispatch.register_kernel("flash_attention", impl="ref")
def _fa_ref(q, k, v, *, causal, window, q_offset, scale, bq=None, bk=None,
            return_lse=False):
    return _ref.mha_ref(q, k, v, causal=causal, window=window,
                        q_offset=q_offset, scale=scale, return_lse=return_lse)


def decode_attention(q, k, v, position, *, window=0, scale=None,
                     precision=None, impl=None, mesh=None, bs=None,
                     paged=False, block_table=None, k_scale=None,
                     v_scale=None, pos_offset=0, return_lse=False):
    """Single-token attention against a cache: q (B, H, D), ``position``
    (B,). Contiguous: k/v (B, K, S, D). ``paged=True``: k/v are page pools
    (P, K, bs, D) and ``block_table`` (B, NB) maps each sequence's logical
    cache blocks to pool pages; the two layouts are bitwise equal at a
    matching block partition. ``pos_offset`` is the absolute position of
    logical block 0; ``return_lse=True`` adds the (B, H) fp32 log-sum-exp.
    ``k_scale``/``v_scale`` (quantized pools) belong to the precision
    slice and raise for now."""
    _not_yet(precision, mesh)
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError("k_scale/v_scale (quantized pools) are not ported yet")
    if paged and block_table is None:
        raise TypeError("decode_attention: paged=True requires block_table")
    if block_table is not None and not paged:
        raise TypeError("decode_attention: block_table requires paged=True")
    if paged:
        if k.dim() != 4 or k.shape[:3] != v.shape[:3]:
            raise ValueError(
                f"decode_attention(paged): pools must be (P, K, bs, D), got "
                f"k={tuple(k.shape)} v={tuple(v.shape)}"
            )
        blocks = {}  # the pool's page extent pins bs
    else:
        blocks = resolve_blocks("decode_attention", bs=bs)
    return kernel_call(
        "decode_attention", q, k, v, position, window=window, scale=scale,
        block_table=block_table, pos_offset=pos_offset,
        return_lse=return_lse, impl=impl, **blocks,
    )


dispatch.register_kernel("decode_attention", impl="torch")(
    _blocked.decode_attention_blocked
)


@dispatch.register_kernel("decode_attention", impl="ref")
def _decode_ref(q, k, v, position, *, window, scale, block_table=None,
                pos_offset=0, return_lse=False, bs=None):
    if block_table is not None:
        return _ref.decode_attention_paged_ref(
            q, k, v, block_table, position, window=window, scale=scale,
            pos_offset=pos_offset, return_lse=return_lse,
        )
    return _ref.decode_attention_ref(q, k, v, position, window=window,
                                     scale=scale, pos_offset=pos_offset,
                                     return_lse=return_lse)


# ---------------------------------------------------------------------------
# SpMM (sparse-dense, ELL value/index rows)
# ---------------------------------------------------------------------------


def spmm(values, cols=None, dense=None, *, impl=None, mesh=None, bm=None):
    """ELL sparse-dense matmul. Either ``spmm(A, dense)`` with A an
    EllMatrix, or the unpacked ``spmm(values, cols, dense)``. ``bm``
    shapes the plain form only."""
    if isinstance(values, EllMatrix):
        if cols is not None and dense is not None:
            raise TypeError(
                "spmm(A, dense): extra operand alongside the EllMatrix form"
            )
        if dense is None:  # positional form: spmm(A, dense)
            dense = cols
        values, cols = values.values, values.cols
    if cols is None or dense is None:
        raise TypeError("spmm: cols and dense operands are required")
    _not_yet(None, mesh)
    blocks = resolve_blocks("spmm", bm=bm)
    return kernel_call("spmm", values, cols, dense, impl=impl, **blocks)


dispatch.register_kernel("spmm", impl="cuda")(_spmm.spmm_cuda)
dispatch.register_kernel("spmm", impl="torch")(_blocked.spmm_blocked)


@dispatch.register_kernel("spmm", impl="ref")
def _spmm_ref(values, cols, dense, *, bm=None):
    return _ref.spmm_ref(values, cols, dense)
