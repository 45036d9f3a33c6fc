"""Plain forms of the ops (the reference's ``xla`` impls).

Each runs the algorithm of the kernel it stands beside in plain tensor
code, so it runs on any device: the CPU tests use it, and on the card it
is the kernel's plain version.

- Attention: the same online-softmax loop as the kernel. Numerics follow
  the reference: fp32 scores with ``q`` scaled before the dot,
  ``NEG = -1e30`` for masked scores, masked probabilities set to exactly
  0 (so a fully-masked row yields 0), and ``l`` clamped at 1e-30.
- Scaled attention (``precision=``): q/k/v quantized per row over D,
  dequantized, then the same loop, fp32 out; decode dequantizes each
  streamed cache block inside the fp32 online softmax (``k_scale``/
  ``v_scale`` are the scales of a cache already held narrow).
- ``gemm_blocked``: the reference's ``xla`` gemm is ``gemm_ref`` itself,
  an fp32-accumulated matmul cast to ``out_dtype``.
- ``gemm_scaled_blocked``: a loop over K blocks of ``bk`` narrow values,
  each block's fp32 product rescaled by the outer product of its scales
  into the fp32 accumulator.
- ``spmm_blocked``: row blocks of ``bm``, slot by slot in fp32, in the
  Pallas body's order (the kernel sums in the same order, so in fp32 the
  two agree bitwise).
- ``bsr_spmm_blocked`` (the reference's ``xla.bsr_spmm_xla``): gather each
  tile's dense slab, batched tile products, scatter-add into the output,
  in chunks of tiles so the gathered slabs stay within ``CHUNK_BYTES``.
- ``spmspm_blocked`` (``xla.spmspm_xla``): densify A's rows, gather them
  at B's indices and contract, in row chunks of the same budget.
- ``stencil_blocked``: the Pallas body's order, point by point, ``acc =
  acc + float32(w_p) * roll(grid)`` in fp32 (product and sum rounded
  separately), then one cast to the grid's dtype.
- ``linear_attention_blocked`` (``xla.linear_attention_xla``): T padded to
  the chunk, a loop over chunks carrying the fp32 state, batched products
  inside a chunk.

The attention and scan forms compute in fp64 for fp64 inputs (and return
fp64), so that ``torch.autograd.gradcheck`` can hold the gradients of
``hopper/grads.py`` to them; every other input type computes in fp32.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import precision as prec
from repro_torch.hopper.dispatch import resolve_blocks
from repro_torch.hopper.ref import gemm_ref

NEG = -1e30
CHUNK_BYTES = 256 << 20  # largest gathered intermediate of the sparse plain forms
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)


def as_bytes(x):
    """fp8 tensors as a uint8 view, others as they are: gathers, pads and
    copies of fp8 values go through their bytes, which every device
    supports."""
    return x.view(torch.uint8) if x.dtype in FP8_DTYPES else x


def compute_dtype(x):
    """fp32, the plain forms' arithmetic, or fp64 for fp64 inputs (the
    gradient checks differentiate the plain forms in fp64)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _online_softmax_step(m, denom, acc, s, mask, vblk, pv_eq):
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # fully-masked rows: exp(NEG - NEG) == 1, so zero them by the mask
    p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
    corr = torch.exp(m - m_new)
    denom = denom * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(pv_eq, p, vblk)
    return m_new, denom, acc


def flash_attention_blocked(q, k, v, *, causal=True, window=0, q_offset=0,
                            scale=None, bq=None, bk=None, return_lse=False):
    """FA-2 forward as a loop over KV blocks of ``bk`` keys.

    q (B, H, Sq, D); k/v (B, K, Sk, D), GQA with H = K * G. A lookback
    ``window`` bounds keys to ``(q_pos - window, q_pos]`` regardless of
    ``causal``; ``q_offset`` is the absolute position of q row 0.
    ``bq``/``bk`` resolve through ``dispatch.resolve_blocks`` (only ``bk``
    shapes this form). ``return_lse`` also returns the (B, H, Sq) fp32
    log-sum-exp ``m + log(max(l, 1e-30))``.
    """
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    block_k = min(resolve_blocks("flash_attention", bq=bq, bk=bk)["bk"], Sk)
    pad = (-Sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nb = (Sk + pad) // block_k
    dev = q.device
    ct = compute_dtype(q)

    qf = (q.to(ct) * scale).reshape(B, K, G, Sq, D)
    q_pos = torch.arange(Sq, device=dev) + q_offset
    m = torch.full((B, K, G, Sq), NEG, dtype=ct, device=dev)
    denom = torch.zeros((B, K, G, Sq), dtype=ct, device=dev)
    acc = torch.zeros((B, K, G, Sq, D), dtype=ct, device=dev)
    for i in range(nb):
        sl = slice(i * block_k, (i + 1) * block_k)
        kblk = k[:, :, sl].to(ct)
        vblk = v[:, :, sl].to(ct)
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, kblk)
        k_pos = i * block_k + torch.arange(block_k, device=dev)
        mask = (k_pos[None, :] < Sk).expand(Sq, block_k)
        if causal or window:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        m, denom, acc = _online_softmax_step(
            m, denom, acc, s, mask, vblk, "bkgqs,bksd->bkgqd"
        )
    o = acc / denom.clamp_min(1e-30)[..., None]
    o = o.reshape(B, H, Sq, D).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(denom.clamp_min(1e-30))).reshape(B, H, Sq)
    return o, lse


def flash_attention_scaled_values_blocked(qq, kq, vq, q_scale, k_scale, v_scale,
                                          **kwargs):
    """Scaled FA-2 on quantized operands: values (B, H|K, S, D) in a compute
    dtype and fp32 per-row scales (B, H|K, S, 1), dequantized to fp32, then
    ``flash_attention_blocked`` (fp32 out). The kernel's plain version."""
    deq = (prec.dequantize_blockwise(x, s, axis=-1)
           for x, s in ((qq, q_scale), (kq, k_scale), (vq, v_scale)))
    return flash_attention_blocked(*deq, **kwargs)


def flash_attention_scaled_blocked(q, k, v, precision, **kwargs):
    """The reference's ``xla.flash_attention_scaled_xla``: q/k/v quantized
    per row over D to ``precision``'s compute dtype, dequantized, then the
    unchanged blocked loop; the output is fp32."""
    p = prec.resolve(precision)
    quantized = [prec.quantize_blockwise(x, p, axis=-1, block=x.shape[-1])
                 for x in (q, k, v)]
    (qq, qs), (kq, ks), (vq, vs) = quantized
    return flash_attention_scaled_values_blocked(qq, kq, vq, qs, ks, vs, **kwargs)


def decode_attention_blocked(q, k, v, position, *, window=0, scale=None,
                             bs=None, precision=None, block_table=None,
                             k_scale=None, v_scale=None, pos_offset=0,
                             return_lse=False):
    """Single-token attention as a loop over cache blocks.

    Contiguous: k/v (B, K, S, D), streamed in blocks of ``bs`` rows
    (``dispatch.resolve_blocks``). Paged (``block_table`` (B, NB) int):
    k/v are page pools (P, K, bs, D) and the page size is the block. Both
    layouts are rearranged into one contiguous (nb, B, K, bs, D) stream and
    run the same loop body, so paged decode is bitwise equal to contiguous
    decode when the contiguous length is ``NB * bs``. ``position`` (B,) is
    each token's absolute position; ``pos_offset`` the absolute position of
    logical block 0; ``return_lse`` adds the (B, H) fp32 log-sum-exp.

    ``precision`` holds the cache quantized per row (values plus one fp32
    scale per cached row, ``precision.quantize_kv_cache``) and dequantizes
    each streamed block at use; ``k_scale``/``v_scale`` ((P|B, K, bs|S, 1)
    fp32) are the scales of a cache already held narrow.
    """
    B, H, D = q.shape
    K = k.shape[1]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device
    if precision is not None and k_scale is None:
        k, k_scale, v, v_scale = prec.quantize_kv_cache(k, v, precision)
    if block_table is not None:
        bs = k.shape[2]
        nb = block_table.shape[1]
        S = nb * bs
        table = block_table.long()

        def blk(x):  # (P, K, bs, d)[table] -> (nb, B, K, bs, d)
            return as_bytes(x)[table].transpose(0, 1).contiguous().view(x.dtype)
    else:
        S = k.shape[2]
        bs = min(resolve_blocks("decode_attention", bs=bs)["bs"], S)
        pad = (-S) % bs
        nb = (S + pad) // bs

        def blk(x):  # (B, K, S, d) -> (nb, B, K, bs, d), zero rows past S
            xb = F.pad(as_bytes(x), (0, 0, 0, pad)) if pad else as_bytes(x)
            d = x.shape[-1]
            xb = xb.reshape(B, K, nb, bs, d).permute(2, 0, 1, 3, 4).contiguous()
            return xb.view(x.dtype)

    kb, vb = blk(k), blk(v)
    ksb, vsb = (blk(k_scale), blk(v_scale)) if k_scale is not None else (None, None)
    qf = (q.float() * scale).reshape(B, K, G, D)
    position = position.to(dev)
    m = torch.full((B, K, G), NEG, device=dev)
    denom = torch.zeros((B, K, G), device=dev)
    acc = torch.zeros((B, K, G, D), device=dev)
    for i in range(nb):
        kf, vf = kb[i].float(), vb[i].float()
        if ksb is not None:  # dequantize the cache block at use
            kf, vf = kf * ksb[i], vf * vsb[i]
        s = torch.einsum("bkgd,bksd->bkgs", qf, kf)
        idx = pos_offset + i * bs + torch.arange(bs, device=dev)[None, :]
        mask = (idx < pos_offset + S) & (idx <= position[:, None])
        if window:
            mask = mask & (idx > position[:, None] - window)
        m, denom, acc = _online_softmax_step(
            m, denom, acc, s, mask[:, None, None, :], vf, "bkgs,bksd->bkgd",
        )
    o = acc / denom.clamp_min(1e-30)[..., None]
    o = o.reshape(B, H, D).to(q.dtype)
    if not return_lse:
        return o
    lse = (m + torch.log(denom.clamp_min(1e-30))).reshape(B, H)
    return o, lse


def gemm_blocked(a, b, *, out_dtype=None, accum_dtype=torch.float32,
                 bm=None, bk=None, bn=None):
    """C = A @ B, operands in ``accum_dtype`` (fp32 by default), cast to
    ``out_dtype`` (default ``a.dtype``). As the reference's ``xla`` gemm
    is its ``gemm_ref``, this form is ``ref.gemm_ref``: one matmul;
    ``bm``/``bk``/``bn`` are accepted for the common signature."""
    return gemm_ref(a, b, out_dtype=out_dtype, accum_dtype=accum_dtype)


def gemm_accum_blocked(a, b, *, bk, accum_dtype, out_dtype=None):
    """C = A @ B with the accumulator held in ``accum_dtype``, as the
    reference's Pallas body keeps ``acc_ref``: for each K block of ``bk``
    (the last one ragged), its fp32 product rounded to ``accum_dtype`` is
    added into the running sum, which is rounded after each add; the sum
    is cast to ``out_dtype`` (default ``a.dtype``). The plain version of
    the GEMM kernel with a narrow accumulator."""
    M, K = a.shape
    acc = torch.zeros((M, b.shape[1]), dtype=accum_dtype, device=a.device)
    for k0 in range(0, K, bk):
        part = a[:, k0:k0 + bk].float() @ b[k0:k0 + bk].float()
        acc = acc + part.to(accum_dtype)
    return acc.to(out_dtype or a.dtype)


def gemm_scaled_values_blocked(aq, bq, a_scale, b_scale, *, bk,
                               out_dtype=torch.float32):
    """Scaled GEMM on quantized operands: aq (M, K), bq (K, N) in a compute
    dtype, a_scale (M, nk), b_scale (nk, N) fp32 with nk = ceil(K / bk).
    For each K block: its fp32 product, times the outer product of its
    scales, added to the fp32 accumulator. The kernel's plain version."""
    M, K = aq.shape
    N = bq.shape[1]
    acc = torch.zeros((M, N), dtype=torch.float32, device=aq.device)
    for kb in range(a_scale.shape[1]):
        sl = slice(kb * bk, (kb + 1) * bk)
        part = aq[:, sl].float() @ bq[sl].float()
        acc = acc + part * (a_scale[:, kb, None] * b_scale[None, kb, :])
    return acc.to(out_dtype)


def gemm_scaled_blocked(a, b, precision, *, out_dtype=None,
                        accum_dtype=torch.float32, bm=None, bk=None, bn=None):
    """The reference's ``xla.gemm_scaled_xla``: a (M, K) quantized per
    K-block of ``bk`` (``resolve_blocks("gemm")``, at most K) along its
    rows, b (K, N) along its columns, then ``gemm_scaled_values_blocked``;
    the output defaults to fp32. Quantizing the unpadded operands gives the
    reference's values and scales bitwise: its K padding is zeros, which
    change no block's amax."""
    if accum_dtype != torch.float32:
        raise NotImplementedError(
            f"gemm: accum_dtype={accum_dtype} with precision=: the scaled forms sum in "
            f"float32, and the reference's kernel paths refuse a narrow accumulator too (its "
            f"xla scan and its Pallas body raise); only impl='ref' computes it"
        )
    p = prec.resolve(precision)
    bk = min(resolve_blocks("gemm", bm=bm, bk=bk, bn=bn)["bk"], a.shape[1])
    aq, a_scale = prec.quantize_blockwise(a, p, axis=1, block=bk)
    bq, b_scale = prec.quantize_blockwise(b, p, axis=0, block=bk)
    return gemm_scaled_values_blocked(aq, bq, a_scale, b_scale, bk=bk,
                                      out_dtype=out_dtype or torch.float32)


def spmm_blocked(values, cols, dense, *, bm=None):
    """ELL sparse-dense product over row blocks of ``bm`` rows
    (``dispatch.resolve_blocks``): for each block, ``acc += vals[:, j] *
    dense[cols[:, j]]`` for j = 0..L-1 in fp32, then one cast to
    ``dense.dtype``. values/cols (R, L), dense (C, F); returns (R, F)."""
    R, L = values.shape
    F_ = dense.shape[1]
    out = torch.empty((R, F_), dtype=dense.dtype, device=dense.device)
    bm = max(min(resolve_blocks("spmm", bm=bm)["bm"], R), 1)
    for r0 in range(0, R, bm):
        vals = values[r0:r0 + bm].float()
        idx = cols[r0:r0 + bm].long()
        acc = torch.zeros((vals.shape[0], F_), dtype=torch.float32, device=dense.device)
        for j in range(L):
            acc += vals[:, j:j + 1] * dense[idx[:, j]].float()
        out[r0:r0 + bm] = acc.to(dense.dtype)
    return out


def bsr_spmm_blocked(tile_values, tile_rows, tile_cols, dense, num_rows, *, bf=None):
    """BSR tiles (T, bm, bk) times dense (K, F) -> fp32 (num_rows, F).

    For each chunk of tiles: gather ``dense[cols[t]*bk : +bk]``, batched
    fp32 products ``tile @ slab``, then scatter-add them at ``rows[t]``.
    Row-blocks without tiles stay 0. The chunk holds at most
    ``CHUNK_BYTES`` of gathered fp32 slabs (about 2048 tiles at bk=128,
    F=256). ``bf`` (the kernel grid's F block) is accepted for the common
    signature; it does not change the sums."""
    T, bm, bk = tile_values.shape
    F_ = dense.shape[1]
    dev = dense.device
    out = torch.zeros((num_rows // bm, bm, F_), dtype=torch.float32, device=dev)
    step = max(1, CHUNK_BYTES // max(1, bk * F_ * 4))
    k_off = torch.arange(bk, device=dev)
    for t0 in range(0, T, step):
        rows = tile_rows[t0:t0 + step].long()
        cols = tile_cols[t0:t0 + step].long()
        slabs = dense[cols[:, None] * bk + k_off].float()  # (t, bk, F)
        prods = torch.bmm(tile_values[t0:t0 + step].float(), slabs)
        out.index_add_(0, rows, prods)
    return out.reshape(num_rows, F_)


def spmspm_blocked(a_values, a_cols, b_values, b_rows, contraction_dim, *,
                   bm=None, bn=None):
    """Sparse x sparse by one-side densified intersection: A's rows (ELL
    (R, La)) densified to (rows, K) fp32, gathered at B's indices (ELL
    columns (C, Lb)), contracted with B's values: ``out[r, c] = sum_j
    b[c, j] * a_dense[r, b_rows[c, j]]`` -> fp32 (R, C). An index outside
    ``[0, K)`` contributes nothing (the kernel's contract): such an entry is
    made padding, value 0 at index 0, before the densify and the gather.

    Rows go in chunks of a multiple of ``bm`` whose gathered (rows, C, Lb)
    block stays within ``CHUNK_BYTES``; ``bn`` is accepted for the common
    signature (all columns go in each chunk)."""
    R = a_values.shape[0]
    C, Lb = b_values.shape
    bm = max(1, resolve_blocks("spmspm", bm=bm, bn=bn)["bm"])
    step = bm * max(1, CHUNK_BYTES // max(1, bm * C * Lb * 4))
    a_in = (a_cols >= 0) & (a_cols < contraction_dim)
    a_values, a_cols = torch.where(a_in, a_values, 0), torch.where(a_in, a_cols, 0)
    b_in = (b_rows >= 0) & (b_rows < contraction_dim)
    bv = torch.where(b_in, b_values.float(), 0.0)
    bidx = torch.where(b_in, b_rows, 0).long()
    out = torch.empty((R, C), dtype=torch.float32, device=a_values.device)
    for r0 in range(0, R, step):
        vals = a_values[r0:r0 + step]
        n = vals.shape[0]
        a_dense = torch.zeros((n, contraction_dim), dtype=torch.float32, device=vals.device)
        rows = torch.arange(n, device=vals.device)[:, None].expand(vals.shape)
        a_dense.index_put_((rows, a_cols[r0:r0 + step].long()), vals.float(),
                           accumulate=True)
        out[r0:r0 + n] = torch.einsum("cj,rcj->rc", bv, a_dense[:, bidx])
    return out


def stencil_blocked(grid, offsets, weights, *, bx=None):
    """Periodic stencil on grid (X, Y, Z): for each point p in order,
    ``acc = acc + float32(w_p) * roll(grid, -(dx, dy, dz))`` in fp32, the
    product and the sum each rounded to fp32, as the Pallas body and the
    Hopper kernel add them (so in fp32 all three agree bitwise); one cast
    to the grid's dtype at the end. offsets (P, 3) ints, weights (P,).
    The Pallas body's x-blocks of ``bx`` do not change an elementwise sum,
    so the whole grid goes at once."""
    w = torch.as_tensor(weights, dtype=torch.float32).cpu()
    acc = torch.zeros(grid.shape, dtype=torch.float32, device=grid.device)
    for p, (dx, dy, dz) in enumerate(np.asarray(offsets).tolist()):
        shifted = torch.roll(grid, (-dx, -dy, -dz), dims=(0, 1, 2)).float()
        acc = acc + float(w[p]) * shifted
    return acc.to(grid.dtype)


def linear_attention_blocked(r, k, v, w_log, u=None, s0=None, *, chunk=None):
    """Chunked decay scan (the reference's ``xla.linear_attention_xla``), the
    plain version of ``csrc/linear_attention.cu``: T padded with zeros to a
    multiple of ``chunk`` (a padded step decays by exp(0) = 1 and adds
    k v^T = 0), then a loop over chunks carrying the fp32 state, with
    batched products inside a chunk, all in fp32:

      inc = cumsum(w) (inclusive), exc = inc - w, e = inc (ssd) | exc (rwkv)
      o   = (r exp(e)) . S + mask((r exp(e)) (k exp(-inc))^T) . v
            [+ sum_n(r u k) v, rwkv]
      S   = exp(inc_last) S + (k exp(inc_last - inc))^T v

    with the mask t >= s (ssd) or t > s (rwkv). r, k, w_log (B, H, T, N);
    v (B, H, T, M); u (H, N) or None (ssd); s0 (B, H, N, M) or None.
    Returns (o (B, H, T, M) in v's dtype, S_final (B, H, N, M) fp32)."""
    chunk = resolve_blocks("linear_attention", chunk=chunk)["chunk"]
    B, H, T, N = r.shape
    M = v.shape[-1]
    pad = (-T) % chunk
    ct = compute_dtype(v)
    rf, kf, vf, wf = (F.pad(x.to(ct), (0, 0, 0, pad)) for x in (r, k, v, w_log))
    nc = (T + pad) // chunk
    ssd = u is None
    idx = torch.arange(chunk, device=v.device)
    mask = idx[:, None] >= idx[None, :] if ssd else idx[:, None] > idx[None, :]
    S = (torch.zeros((B, H, N, M), dtype=ct, device=v.device)
         if s0 is None else s0.to(ct))
    outs = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        rc, kc, vc, wc = rf[:, :, sl], kf[:, :, sl], vf[:, :, sl], wf[:, :, sl]
        inc = torch.cumsum(wc, dim=2)
        e = inc if ssd else inc - wc
        total = inc[:, :, -1:, :]
        r_dec = rc * torch.exp(e)
        o = torch.einsum("bhcn,bhnm->bhcm", r_dec, S)
        scores = torch.einsum("bhtn,bhsn->bhts", r_dec, kc * torch.exp(-inc))
        scores = torch.where(mask, scores, 0.0)
        o = o + torch.einsum("bhts,bhsm->bhtm", scores, vc)
        if not ssd:
            o = o + (rc * u[None, :, None].to(ct) * kc).sum(-1, keepdim=True) * vc
        k_tail = kc * torch.exp(total - inc)
        S = (torch.exp(total)[:, :, 0, :, None] * S
             + torch.einsum("bhsn,bhsm->bhnm", k_tail, vc))
        outs.append(o)
    o = (torch.cat(outs, 2)[:, :, :T] if outs
         else torch.zeros((B, H, 0, M), dtype=ct, device=v.device))
    return o.to(v.dtype), S
