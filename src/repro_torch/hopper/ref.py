"""Naive oracles: the obviously-correct forms the tests hold the plain
forms and the kernels to (counterparts of ``repro.kernels.ref``'s
attention oracles, plain and scaled, ``gemm_ref``, ``gemm_scaled_ref``,
``spmm_ref``, ``spmspm_ref``, ``spmspm_comparisons``, ``stencil_ref`` and
``linear_attention_scan_ref``; ``bsr_spmm_ref`` densifies the tiles, where
the reference reuses its blocked form)."""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import precision as prec
from repro_torch.hopper.dispatch import resolve_blocks


def mha_ref(q, k, v, *, causal=True, window=0, q_offset=0, scale=None,
            return_lse=False):
    """q (B, H, Sq, D); k/v (B, K, Sk, D) with H = K * G. ``window > 0`` is
    a lookback window: keys in ``(q_pos - window, q_pos]``, so it bounds
    ``k_pos <= q_pos`` even with ``causal=False``. ``return_lse`` adds the
    (B, H, Sq) fp32 log-sum-exp, floored at -1e30."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, K, G, Sq, D).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal or window:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # fully-masked rows
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    o = o.reshape(B, H, Sq, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).clamp_min(-1e30).reshape(B, H, Sq)
    return o, lse


def _dequantized_rows(x, policy):
    """``x`` quantized per row over its last axis and reconstructed in fp32."""
    vals, scales = prec.quantize_blockwise(x, policy, axis=-1, block=x.shape[-1])
    return prec.dequantize_blockwise(vals, scales, axis=-1)


def mha_scaled_ref(q, k, v, precision, **kwargs):
    """Scaled-attention oracle: q/k/v quantized and dequantized per row over
    the head dim, then the exact oracle ``mha_ref`` (fp32 out)."""
    p = prec.resolve(precision)
    return mha_ref(*(_dequantized_rows(x, p) for x in (q, k, v)), **kwargs)


def decode_attention_ref(q, k, v, position, *, window=0, scale=None,
                         pos_offset=0, return_lse=False):
    """One new token per sequence against a contiguous cache: q (B, H, D),
    k/v (B, K, S, D), ``position`` (B,) absolute index of the new token.
    ``pos_offset`` is the absolute position of cache row 0."""
    B, H, D = q.shape
    K, S = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = q.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bksd->bkgs", qf, k.float()) * scale
    idx = torch.arange(S, device=q.device)[None, :] + pos_offset
    mask = idx <= position[:, None]
    if window:
        mask &= idx > position[:, None] - window
    s = s.masked_fill(~mask[:, None, None, :], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    o = torch.einsum("bkgs,bksd->bkgd", p, v.float())
    o = o.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = torch.logsumexp(s, dim=-1).clamp_min(-1e30).reshape(B, H)
    return o, lse


def decode_attention_scaled_ref(q, k, v, position, *, precision, **kwargs):
    """Quantized-cache decode oracle: the cache quantized per row as the
    serving path holds it, dequantized, then the exact oracle."""
    kq, ks, vq, vs = prec.quantize_kv_cache(k, v, precision)
    return decode_attention_ref(q, prec.dequantize_blockwise(kq, ks, axis=-1),
                                prec.dequantize_blockwise(vq, vs, axis=-1),
                                position, **kwargs)


def decode_attention_paged_ref(q, k, v, block_table, position, *, window=0,
                               scale=None, precision=None, k_scale=None,
                               v_scale=None, pos_offset=0, return_lse=False):
    """Paged-cache oracle: gather each sequence's pages (k/v pools
    (P, K, bs, D), ``block_table`` (B, NB)) back into the contiguous
    (B, K, NB*bs, D) layout and run ``decode_attention_ref``. ``precision``
    quantizes the pools per row first; ``k_scale``/``v_scale`` (P, K, bs,
    1) are the scales of pools already held narrow."""
    if precision is not None and k_scale is None:
        k, k_scale, v, v_scale = prec.quantize_kv_cache(k, v, precision)
    if k_scale is not None:
        k = prec.dequantize_blockwise(k, k_scale, axis=-1)
        v = prec.dequantize_blockwise(v, v_scale, axis=-1)
    B, nb = block_table.shape
    K, bs, D = k.shape[1], k.shape[2], k.shape[3]

    def gather(pool):
        return pool[block_table.long()].transpose(1, 2).reshape(B, K, nb * bs, D)

    return decode_attention_ref(
        q, gather(k), gather(v), position, window=window, scale=scale,
        pos_offset=pos_offset, return_lse=return_lse,
    )


def gemm_ref(a, b, out_dtype=None, accum_dtype=torch.float32):
    """C = A @ B with widening accumulation: one matmul of both operands in
    ``accum_dtype``, or in fp32 where ``accum_dtype`` is narrower (bf16
    products are exact in fp32), whose sum is rounded once to
    ``accum_dtype`` and then to ``out_dtype`` (default ``a.dtype``). This is
    what the reference's ``jnp.matmul(..., preferred_element_type=)`` does on
    the CPU, except for bf16 operands with an fp16 accumulator, where XLA
    rounds the fp32 sum to bf16 first."""
    out_dtype = out_dtype or a.dtype
    wide = accum_dtype if accum_dtype.itemsize >= 4 else torch.float32
    return torch.matmul(a.to(wide), b.to(wide)).to(accum_dtype).to(out_dtype)


def gemm_scaled_ref(a, b, precision, *, out_dtype=None,
                    accum_dtype=torch.float32, bk=None):
    """Scaled-GEMM oracle: both operands quantized per K-block of ``bk``
    (``resolve_blocks("gemm")``, at most K) as the kernels take them,
    dequantized to fp32, one matmul; the output defaults to fp32."""
    p = prec.resolve(precision)
    bk = min(resolve_blocks("gemm", bk=bk)["bk"], a.shape[1])
    af = prec.dequantize_blockwise(*prec.quantize_blockwise(a, p, axis=1, block=bk),
                                   axis=1, block=bk)
    bf = prec.dequantize_blockwise(*prec.quantize_blockwise(b, p, axis=0, block=bk),
                                   axis=0, block=bk)
    return gemm_ref(af, bf, out_dtype or torch.float32, accum_dtype)


def spmm_ref(values, cols, dense):
    """values/cols: (R, L) ELL rows (padding: value 0, col 0); dense: (C, F).
    Gathers every slot's row, then sums in fp32; the output is
    ``dense.dtype``."""
    gathered = dense[cols.long()]  # (R, L, F)
    return torch.einsum(
        "rl,rlf->rf", values.float(), gathered.float()
    ).to(dense.dtype)


def bsr_spmm_ref(tile_values, tile_rows, tile_cols, dense, num_rows):
    """BSR tiles (T, bm, bk) at block coordinates (tile_rows, tile_cols)
    times dense (K, F): densify the tiles into a (num_rows, K) fp32 matrix,
    then one fp32 matmul. Returns fp32 (num_rows, F)."""
    T, bm, bk = tile_values.shape
    K = dense.shape[0]
    blocked = torch.zeros((num_rows // bm, K // bk, bm, bk), dtype=torch.float32,
                          device=dense.device)
    blocked.index_put_((tile_rows.long(), tile_cols.long()), tile_values.float(),
                       accumulate=True)
    a = blocked.transpose(1, 2).reshape(num_rows, (K // bk) * bk)
    return a @ dense[: a.shape[1]].float()


# ---------------------------------------------------------------------------
# Sparse-sparse matmul (paper Fig. 9d): index intersection
# ---------------------------------------------------------------------------


def _ell_densify(values, idx, width):
    """(N, L) ELL rows -> (N, width) fp32, duplicate slots summed."""
    n = values.shape[0]
    out = torch.zeros((n, width), dtype=torch.float32, device=values.device)
    rows = torch.arange(n, device=values.device)[:, None].expand_as(idx)
    return out.index_put_((rows, idx.long()), values.float(), accumulate=True)


def spmspm_ref(a_values, a_cols, b_values, b_rows, contraction_dim):
    """out[r, c] = sum over the index intersection of A.row(r) (ELL rows
    (R, La)) and B.col(c) (ELL columns (C, Lb)). Oracle: densify both
    operands and matmul, in fp32. Padding entries carry value 0."""
    a_dense = _ell_densify(a_values, a_cols, contraction_dim)
    b_dense = _ell_densify(b_values, b_rows, contraction_dim)
    return a_dense @ b_dense.T


def spmspm_comparisons(a_cols, b_rows) -> int:
    """Paper figure of merit: index comparisons an all-pairs intersection
    performs (GCOMP), R * C * La * Lb."""
    R, La = a_cols.shape
    C, Lb = b_rows.shape
    return int(R) * int(C) * int(La) * int(Lb)


# ---------------------------------------------------------------------------
# Stencil (paper Fig. 9b): offset streams over a 3D grid, periodic boundary
# ---------------------------------------------------------------------------


def stencil_ref(grid, offsets, weights):
    """out[x, y, z] = sum_p w_p * grid[x+dx_p, y+dy_p, z+dz_p], periodic in
    every axis, summed in fp32 in point order; the output has the grid's
    dtype. offsets (P, 3) ints, weights (P,)."""
    w = torch.as_tensor(weights, dtype=torch.float32)
    out = torch.zeros(grid.shape, dtype=torch.float32, device=grid.device)
    for p, (dx, dy, dz) in enumerate(np.asarray(offsets).tolist()):
        out = out + float(w[p]) * torch.roll(
            grid, (-dx, -dy, -dz), dims=(0, 1, 2)).float()
    return out.to(grid.dtype)


# ---------------------------------------------------------------------------
# Chunked linear attention with data-dependent decay (RWKV6 / SSD)
# ---------------------------------------------------------------------------


def linear_attention_scan_ref(r, k, v, w_log, u, s0=None):
    """Exact per-token recurrence (the oracle). r, k, w_log (B, H, T, N);
    v (B, H, T, M); u (H, N) or None; s0 (B, H, N, M) or None.

    rwkv (u given):  o_t = r_t . S_{t-1} + (r_t * u * k_t) v_t
    ssd  (u None):   o_t = r_t . S_t
    both:            S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T

    Computes in fp32, or in fp64 where v is fp64. Returns (o (B, H, T, M)
    in v's dtype, S_final (B, H, N, M) fp32, or fp64 where v is)."""
    B, H, T, N = r.shape
    M = v.shape[-1]
    acc = torch.float64 if v.dtype == torch.float64 else torch.float32
    S = (torch.zeros((B, H, N, M), dtype=acc, device=v.device)
         if s0 is None else s0.to(acc))
    rf, kf, vf, wf = (x.to(acc) for x in (r, k, v, w_log))
    outs = []
    for t in range(T):
        rt, kt, vt, wt = rf[:, :, t], kf[:, :, t], vf[:, :, t], wf[:, :, t]
        S_new = torch.exp(wt)[..., None] * S + kt[..., :, None] * vt[..., None, :]
        if u is None:
            o = torch.einsum("bhn,bhnm->bhm", rt, S_new)
        else:
            o = (torch.einsum("bhn,bhnm->bhm", rt, S)
                 + (rt * u[None].to(acc) * kt).sum(-1, keepdim=True) * vt)
        S = S_new
        outs.append(o)
    o = (torch.stack(outs, 2) if outs
         else torch.zeros((B, H, 0, M), dtype=acc, device=v.device))
    return o.to(v.dtype), S
