"""The port's op entry points, dispatched through ``hopper.dispatch``.

Public signatures and argument checks follow ``repro.kernels.ops``'s
``gemm``, ``flash_attention``, ``decode_attention``, ``linear_attention``
(and its single-token ``linear_attention_step``), ``spmm``, ``bsr_spmm``,
``spmspm`` and ``stencil``. The implementations:

  - ``cuda``:  the Hopper kernels' wrappers, ``hopper/gemm.py``,
               ``hopper/gemm_scaled.py``, ``hopper/flash_attention.py``,
               ``hopper/flash_attention_scaled.py``,
               ``hopper/decode_attention.py``,
               ``hopper/linear_attention.py``, ``hopper/spmm.py``,
               ``hopper/bsr_spmm.py``, ``hopper/spmspm.py`` and
               ``hopper/stencil.py`` (the linear attention step has no
               kernel, as in the reference; decode attention has one,
               which the reference's XLA blocked form does not)
  - ``torch``: ``hopper/blocked.py``, the plain forms
  - ``ref``:   ``hopper/ref.py``, the naive oracles

Mamba-2's exact scan, ``ssd_scan`` (and its single-token ``ssd_step``),
is plain tensor code outside the dispatch table, as the linear attention
step is: one scalar decay per head and token, never clamped.

``precision=`` on ``gemm``, ``flash_attention`` and ``decode_attention``
selects a ``core.precision`` policy (fp32, bf16, fp8 = e4m3, fp8_e5m2):
operands are quantized (per K-block for the GEMM, per row over the head
dim for attention) and rescaled inside fp32 accumulation; it rides
dispatch only when set, so ``precision=None`` is the legacy path, bitwise.
Partitioning is the third dispatch axis (``hopper/partition.py``): every
op takes ``mesh=`` (a ``parallel.mesh.DeviceMesh`` or ``RingMesh``) or
picks the mesh up from ``parallel.sharding.use_mesh``, and ``_dispatch``
resolves the op's PartitionRule once per call: each rank runs the
selected impl on its own part, on its own stream, and the parts are
stitched back by the plan's collectives (the flash ring's hops go through
the ring-hop kernel with ``remote_copy=True``). An op whose rule declines
every level runs once, unsharded, with one ``ReproDegradeWarning``.

Gradients (``hopper/grads.py``): with grad enabled and an input that
requires grad, the ``cuda`` impls of ``flash_attention`` and
``linear_attention`` run their kernel forward inside an autograd Function
whose backward is plain tensor code; every other ``cuda`` impl, the
scaled attention form and the mesh path raise ``NotImplementedError``
instead of returning a result cut off from the graph. The ``torch`` and
``ref`` impls are plain tensor code, which autograd differentiates.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.core import precision as prec
from repro_torch.core.sparse import BsrMatrix, EllMatrix
from repro_torch.hopper import blocked as _blocked
from repro_torch.hopper import bsr_spmm as _bsr
from repro_torch.hopper import decode_attention as _decode
from repro_torch.hopper import dispatch
from repro_torch.hopper import flash_attention as _fa
from repro_torch.hopper import flash_attention_scaled as _fa_scaled
from repro_torch.hopper import gemm as _gemm
from repro_torch.hopper import gemm_scaled as _gemm_scaled
from repro_torch.hopper import grads
from repro_torch.hopper import linear_attention as _la
from repro_torch.hopper import partition as _partition
from repro_torch.hopper import ref as _ref
from repro_torch.hopper import spmm as _spmm
from repro_torch.hopper import spmspm as _spmspm
from repro_torch.hopper import stencil as _stencil
from repro_torch.hopper.dispatch import kernel_call, resolve_blocks
from repro_torch.parallel import sharding


def _dispatch(op, *args, mesh=None, impl=None, **kwargs):
    """The one mesh-aware seam: an explicit ``mesh=``, else the
    ``sharding.use_mesh`` context's, else the plain call, with the
    plan-only schedule keywords (``partition.PLAN_KWARGS``) stripped."""
    if mesh is None:
        mesh = sharding.kernel_mesh()
    if mesh is not None:
        if grads.needs_grad(*args, *kwargs.values()):
            grads.no_backward(f"ops.{op}(mesh=)",
                              "the mesh path's gradients wait for ROADMAP queue 1 item 2b")
        return _partition.sharded_call(op, mesh, *args, impl=impl, **kwargs)
    return kernel_call(op, *args, impl=impl, **_partition.strip_plan_kwargs(kwargs))


def _precision_kwargs(precision):
    # precision rides dispatch only when set, so the None path calls every
    # impl exactly as before the precision slice
    precision = prec.resolve(precision)
    return {} if precision is None else {"precision": precision}


# ---------------------------------------------------------------------------
# Dense GEMM
# ---------------------------------------------------------------------------


def gemm(a, b, *, out_dtype=None, accum_dtype=torch.float32, precision=None,
         impl=None, mesh=None, bm=None, bk=None, bn=None):
    """C = A @ B with widening accumulation: a (M, K), b (K, N); the
    output is ``out_dtype`` (default ``a.dtype``). ``bm``/``bk``/``bn``
    shape the plain form only.

    ``precision`` quantizes both operands per K-block of ``bk`` (the
    quantization block, so it reaches the kernel too) to the policy's
    compute dtype; each block's narrow product is rescaled by its fp32
    scales inside the fp32 accumulator, and the output defaults to fp32."""
    blocks = resolve_blocks("gemm", bm=bm, bk=bk, bn=bn)
    return _dispatch("gemm", a, b, out_dtype=out_dtype, accum_dtype=accum_dtype,
                     mesh=mesh, impl=impl, **_precision_kwargs(precision), **blocks)


@dispatch.register_kernel("gemm", impl="cuda")
@functools.partial(grads.forward_only, "gemm")
def _gemm_cuda(a, b, *, precision=None, **kwargs):
    if precision is not None:
        return _gemm_scaled.gemm_scaled_cuda(a, b, precision, **kwargs)
    return _gemm.gemm_cuda(a, b, **kwargs)


@dispatch.register_kernel("gemm", impl="torch")
def _gemm_torch(a, b, *, precision=None, **kwargs):
    if precision is not None:
        return _blocked.gemm_scaled_blocked(a, b, precision, **kwargs)
    return _blocked.gemm_blocked(a, b, **kwargs)


@dispatch.register_kernel("gemm", impl="ref")
def _gemm_ref(a, b, *, out_dtype=None, accum_dtype=torch.float32,
              precision=None, bm=None, bk=None, bn=None):
    if precision is not None:
        return _ref.gemm_scaled_ref(a, b, precision, out_dtype=out_dtype,
                                    accum_dtype=accum_dtype, bk=bk)
    return _ref.gemm_ref(a, b, out_dtype=out_dtype, accum_dtype=accum_dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                    scale=None, precision=None, impl=None, mesh=None,
                    bq=None, bk=None, block_k=None, return_lse=False,
                    overlap=True, zigzag=True, remote_copy=False):
    """q: (B,H,Sq,D); k,v: (B,K,Sk,D). Returns (B,H,Sq,D).

    ``window > 0`` is a lookback window: each query attends to keys in
    ``(q_pos - window, q_pos]``, so a window bounds future positions even
    with ``causal=False``. ``return_lse=True`` also returns the per-row
    log-sum-exp, (B,H,Sq) fp32. ``block_k`` is the historical spelling of
    ``bk``; ``bq``/``bk`` shape the plain form only.

    ``precision`` quantizes q/k/v per row over D (values plus one fp32
    scale per row); the scaled kernel rescales inside its fp32 block
    compute. Scaled attention always returns fp32.

    ``mesh`` shards the call (heads over ``pod``/``model``, the batch or
    the sequence ring over ``data``); ``overlap``, ``zigzag`` and
    ``remote_copy`` are the ring's schedule knobs (no-ops without a ring):
    ``overlap`` issues hop t+1's transfer before hop t's fold, ``zigzag``
    balances causal Q ownership over head and tail half-chunks,
    ``remote_copy`` sends each hop through the ring-hop kernel instead of
    ``copy_``. Numerics are the same either way.
    """
    if block_k is not None:
        if bk is not None and bk != block_k:
            raise TypeError(
                f"flash_attention: bk={bk} and its alias block_k={block_k} disagree"
            )
        bk = block_k
    blocks = resolve_blocks("flash_attention", bq=bq, bk=bk)
    return _dispatch("flash_attention", q, k, v, causal=causal, window=window,
                     q_offset=q_offset, scale=scale, return_lse=return_lse, mesh=mesh,
                     impl=impl, overlap=overlap, zigzag=zigzag, remote_copy=remote_copy,
                     **_precision_kwargs(precision), **blocks)


@dispatch.register_kernel("flash_attention", impl="cuda")
def _fa_cuda(q, k, v, *, precision=None, **kwargs):
    if precision is not None:
        if grads.needs_grad(q, k, v):
            grads.no_backward("flash_attention(precision=)'s cuda kernel",
                              "the reference's Pallas body has none either (impl='torch' has "
                              "the reference xla form's gradient)")
        return _fa_scaled.flash_attention_scaled_cuda(q, k, v, precision, **kwargs)
    if grads.needs_grad(q, k, v):  # the kernel forward, the plain FA-2 backward
        return grads.flash_attention(q, k, v, **kwargs)
    return _fa.flash_attention_cuda(q, k, v, **kwargs)


@dispatch.register_kernel("flash_attention", impl="torch")
def _fa_torch(q, k, v, *, precision=None, **kwargs):
    if precision is not None:
        return _blocked.flash_attention_scaled_blocked(q, k, v, precision, **kwargs)
    return _blocked.flash_attention_blocked(q, k, v, **kwargs)


@dispatch.register_kernel("flash_attention", impl="ref")
def _fa_ref(q, k, v, *, causal, window, q_offset, scale, precision=None,
            bq=None, bk=None, return_lse=False):
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              return_lse=return_lse)
    if precision is not None:
        return _ref.mha_scaled_ref(q, k, v, precision, **kw)
    return _ref.mha_ref(q, k, v, **kw)


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

    ``precision`` holds the cache quantized (values plus one fp32 scale per
    cached row) and dequantizes each streamed block at use.
    ``k_scale``/``v_scale`` ((P, K, bs, 1) fp32) are the scales of paged
    pools already held narrow; the contiguous path takes ``precision=``
    instead and raises ``TypeError`` on them."""
    if paged and block_table is None:
        raise TypeError("decode_attention: paged=True requires block_table")
    if block_table is not None and not paged:
        raise TypeError("decode_attention: block_table requires paged=True")
    scales = {}
    if paged:
        if k.dim() != 4 or k.shape[:3] != v.shape[:3]:
            raise ValueError(
                f"decode_attention(paged): pools must be (P, K, bs, D), got "
                f"k={tuple(k.shape)} v={tuple(v.shape)}"
            )
        if k_scale is not None:
            scales = dict(k_scale=k_scale, v_scale=v_scale)
        blocks = {}  # the pool's page extent pins bs
    else:
        if k_scale is not None or v_scale is not None:
            raise TypeError(
                "decode_attention: k_scale/v_scale are pool scales for the "
                "paged path; the contiguous path quantizes via precision="
            )
        blocks = resolve_blocks("decode_attention", bs=bs)
    return _dispatch(
        "decode_attention", q, k, v, position, window=window, scale=scale,
        block_table=block_table, pos_offset=pos_offset,
        return_lse=return_lse, mesh=mesh, impl=impl, **_precision_kwargs(precision),
        **scales, **blocks,
    )


dispatch.register_kernel("decode_attention", impl="cuda")(
    grads.forward_only("decode_attention", _decode.decode_attention_cuda)
)
dispatch.register_kernel("decode_attention", impl="torch")(
    _blocked.decode_attention_blocked
)


@dispatch.register_kernel("decode_attention", impl="ref")
def _decode_ref(q, k, v, position, *, window, scale, precision=None,
                block_table=None, k_scale=None, v_scale=None, pos_offset=0,
                return_lse=False, bs=None):
    kw = dict(window=window, scale=scale, pos_offset=pos_offset,
              return_lse=return_lse)
    if block_table is not None:
        return _ref.decode_attention_paged_ref(
            q, k, v, block_table, position, precision=precision,
            k_scale=k_scale, v_scale=v_scale, **kw,
        )
    if precision is not None:
        return _ref.decode_attention_scaled_ref(q, k, v, position,
                                                precision=precision, **kw)
    return _ref.decode_attention_ref(q, k, v, position, **kw)


# ---------------------------------------------------------------------------
# Chunked linear attention with data-dependent decay (RWKV6 / SSD)
# ---------------------------------------------------------------------------

# per-token decay floor; the chunked forms exponentiate at most
# chunk * |W_LOG_FLOOR| in one fp32 exp, so chunk is bounded by _MAX_CHUNK_EXP
# (log(f32max) ~= 88.7, kept with margin), as in the reference
W_LOG_FLOOR = -2.5
_MAX_CHUNK_EXP = 85.0


def _floor_decay(w_log):
    """max(w_log, W_LOG_FLOOR), computed once per stored value: dims that
    ``w_log`` broadcasts with stride 0 stay broadcast."""
    stored = tuple(slice(0, 1) if st == 0 else slice(None) for st in w_log.stride())
    return torch.clamp_min(w_log[stored], W_LOG_FLOOR).expand(w_log.shape)


def linear_attention(r, k, v, w_log, u=None, s0=None, *, impl=None, mesh=None,
                     chunk=None):
    """Chunked scan: S_t = diag(exp(w_t)) S_{t-1} + k_t v_t^T.

    u given  => RWKV6 read-out (o_t from S_{t-1} plus u-bonus for token t)
    u None   => SSD/Mamba read-out (o_t from S_t)
    r, k, w_log (B, H, T, N); v (B, H, T, M); u (H, N); s0 (B, H, N, M).
    Returns (o (B, H, T, M) in v's dtype, S_final (B, H, N, M) fp32).
    ``w_log`` is floored at ``W_LOG_FLOOR`` first; a ``chunk`` whose span
    could overflow one fp32 exp raises ``ValueError`` (not for ``ref``,
    the exact per-token scan)."""
    chunk = resolve_blocks("linear_attention", chunk=chunk)["chunk"]
    if (dispatch.resolve_impl("linear_attention", impl) != "ref"
            and chunk * -W_LOG_FLOOR > _MAX_CHUNK_EXP):
        raise ValueError(
            f"chunk={chunk} overflows fp32: chunk * |W_LOG_FLOOR| = "
            f"{chunk * -W_LOG_FLOOR} must stay <= {_MAX_CHUNK_EXP} "
            f"(max chunk {int(_MAX_CHUNK_EXP / -W_LOG_FLOOR)})"
        )
    return _dispatch("linear_attention", r, k, v, _floor_decay(w_log), u, s0,
                     chunk=chunk, mesh=mesh, impl=impl)


@dispatch.register_kernel("linear_attention", impl="cuda")
def _la_cuda(r, k, v, w_log, u=None, s0=None, *, chunk=None):
    if grads.needs_grad(r, k, v, w_log, u, s0):  # the kernel forward, the plain backward
        return grads.linear_attention(r, k, v, w_log, u, s0, chunk=chunk)
    return _la.linear_attention_cuda(r, k, v, w_log, u, s0, chunk=chunk)


dispatch.register_kernel("linear_attention", impl="torch")(_blocked.linear_attention_blocked)


@dispatch.register_kernel("linear_attention", impl="ref")
def _la_ref(r, k, v, w_log, u, s0, *, chunk=None):
    return _ref.linear_attention_scan_ref(r, k, v, w_log, u, s0)


def linear_attention_step(r, k, v, w_log, u, S):
    """Single-token decode step: r, k, w_log (B, H, N); v (B, H, M);
    S (B, H, N, M) fp32. Returns (o (B, H, M) in v's dtype, S_new). Plain
    tensor code on any device: the reference has no kernel for it."""
    w_log = torch.clamp_min(w_log, W_LOG_FLOOR)
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w_log))
    S_new = torch.exp(wf)[..., None] * S + kf[..., :, None] * vf[..., None, :]
    if u is None:
        o = torch.einsum("bhn,bhnm->bhm", rf, S_new)
    else:
        o = (torch.einsum("bhn,bhnm->bhm", rf, S)
             + (rf * (u[None].float() * kf)).sum(-1, keepdim=True) * vf)
    return o.to(v.dtype), S_new


# ---------------------------------------------------------------------------
# SSD scan (Mamba-2: one scalar decay per head and token, never clamped)
# ---------------------------------------------------------------------------

# tokens a chunk and heads a pass of the chunked scan: a pass holds
# (SSD_HEADS, S, SSD_CHUNK) fp32 decay and score matrices
SSD_CHUNK = 128
SSD_HEADS = 32


def _segsum(a):
    """a (..., T) -> (..., T, T): entry [t, s] is sum(a[s+1 .. t]) for
    s <= t, -inf above the diagonal. Each entry is a direct sum of its own
    terms, not a difference of two running sums, so exp() of it is <= 1
    exactly where every a <= 0."""
    T = a.shape[-1]
    rep = a[..., None].expand(*a.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device), -1)
    seg = torch.cumsum(rep.masked_fill(~below, 0), dim=-2)
    diag = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return seg.masked_fill(~diag, float("-inf"))


def _ssd_heads(xd, a, B, C, s0, Q):
    """One pass over a block of heads of one B/C group. xd (Bt, nc, Q, h,
    P) = dt * x; a (Bt, h, nc, Q) = dt * A; B, C (Bt, nc, Q, N), the
    group's; s0 (Bt, h, P, N). Returns (y (Bt, nc, Q, h, P), final state
    (Bt, h, P, N))."""
    acum = torch.cumsum(a, dim=-1)
    # within a chunk: y_t = sum_{s <= t} exp(a_{s+1..t}) (C_t . B_s) xd_s
    M = torch.exp(_segsum(a)).mul_(torch.einsum("bcln,bcsn->bcls", C, B)[:, None])
    y = torch.einsum("bhcls,bcshp->bclhp", M, xd)
    del M
    # each chunk's own state at its end: sum_s exp(a_{s+1..end}) xd_s B_s^T
    rest = torch.cat([a[..., 1:].flip(-1).cumsum(-1).flip(-1), torch.zeros_like(a[..., :1])], -1)
    states = torch.einsum("bcsn,bcshp->bchpn", B, xd * torch.exp(rest).permute(0, 2, 3, 1)[..., None])
    # the state entering each chunk, and the final one: the chunks' totals
    # segment-summed across chunks, s0 entering first
    decay = torch.exp(_segsum(F.pad(acum[..., -1], (1, 0))))  # (Bt, h, nc+1, nc+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay, torch.cat([s0[:, None], states], dim=1))
    # read-out of the entering state: y_t += exp(a_{..t}) C_t . S_in
    y += (torch.einsum("bcln,bchpn->bclhp", C, states[:, :-1])
          * torch.exp(acum).permute(0, 2, 3, 1)[..., None])
    return y, states[:, -1]


def ssd_scan(x, dt, A, B, C, D=None, s0=None):
    """Mamba-2's scan, exact: S_t = exp(dt_t A) S_{t-1} + dt_t x_t B_t^T,
    y_t = S_t C_t + D x_t, per head, with nothing clamped.

    x (Bt, S, nh, P); dt (Bt, S, nh) after softplus (a token with dt 0
    leaves the state as it was and adds nothing); A (nh,) <= 0; B, C
    (Bt, S, G, N), head h reading group h // (nh / G); D (nh,) or None;
    s0 (Bt, nh, P, N) or None (zeros). Returns (y (Bt, S, nh, P) fp32,
    final state (Bt, nh, P, N) fp32).

    The chunked form (SSD's block decomposition): every decay factor is
    exp of a direct sum of dt A over the tokens it spans, so each is at
    most 1 whatever the decay, where a chunked scan of exp(cumsum) ratios
    must bound the per-token decay (``linear_attention``'s floor). Plain
    tensor code in fp32 on any device, in passes of at most ``SSD_HEADS``
    heads of one group."""
    Q = SSD_CHUNK
    Bt, S, nh, P = x.shape
    G, N = B.shape[-2:]
    nc = -(-S // Q)
    pad = nc * Q - S
    xf, dtf = x.float(), dt.float()
    a = F.pad(dtf * A.float(), (0, 0, 0, pad)).view(Bt, nc, Q, nh).permute(0, 3, 1, 2)
    xd = F.pad(xf * dtf[..., None], (0, 0, 0, 0, 0, pad)).view(Bt, nc, Q, nh, P)
    Bc, Cc = (F.pad(t.float(), (0, 0, 0, 0, 0, pad)).view(Bt, nc, Q, G, N) for t in (B, C))
    s0 = (torch.zeros(Bt, nh, P, N, dtype=torch.float32, device=x.device)
          if s0 is None else s0.float())
    per = nh // G
    ys, finals = [], []
    for lo in range(0, nh, min(SSD_HEADS, per)):
        hi, g = min(lo + SSD_HEADS, (lo // per + 1) * per), lo // per
        y, final = _ssd_heads(xd[:, :, :, lo:hi], a[:, lo:hi], Bc[..., g, :], Cc[..., g, :],
                              s0[:, lo:hi], Q)
        ys.append(y)
        finals.append(final)
    y = torch.cat(ys, dim=3).reshape(Bt, nc * Q, nh, P)[:, :S]
    if D is not None:
        y = y + D.float()[:, None] * xf
    return y, torch.cat(finals, dim=1)


def ssd_step(x, dt, A, B, C, D, state):
    """One token of ``ssd_scan`` for each row, the state advanced **in
    place**: x (Bt, nh, P); dt (Bt, nh); B, C (Bt, G, N); D (nh,) or None;
    state (Bt, nh, P, N) fp32. Returns y (Bt, nh, P) fp32. The decay
    exp(dt A) is at most 1 and is not clamped."""
    Bt, nh, P = x.shape
    G, N = B.shape[-2:]
    g = torch.arange(nh, device=x.device) // (nh // G)
    Bh, Ch = B.float()[:, g], C.float()[:, g]  # (Bt, nh, N)
    dtf = dt.float()
    xd = x.float() * dtf[..., None]
    flat = state.view(Bt * nh, P, N)
    state.mul_(torch.exp(dtf * A.float())[..., None, None])
    flat.baddbmm_(xd.reshape(Bt * nh, P, 1), Bh.reshape(Bt * nh, 1, N))
    y = torch.bmm(flat, Ch.reshape(Bt * nh, N, 1)).view(Bt, nh, P)
    if D is not None:
        y = y + D.float()[:, None] * x.float()
    return y


# ---------------------------------------------------------------------------
# SpMM (sparse-dense: ELL value/index rows, BSR tiles)
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
    blocks = resolve_blocks("spmm", bm=bm)
    return _dispatch("spmm", values, cols, dense, mesh=mesh, impl=impl, **blocks)


dispatch.register_kernel("spmm", impl="cuda")(grads.forward_only("spmm", _spmm.spmm_cuda))
dispatch.register_kernel("spmm", impl="torch")(_blocked.spmm_blocked)


@dispatch.register_kernel("spmm", impl="ref")
def _spmm_ref(values, cols, dense, *, bm=None):
    return _ref.spmm_ref(values, cols, dense)


def bsr_spmm(tile_values, tile_rows=None, tile_cols=None, dense=None,
             num_rows=None, *, impl=None, mesh=None, bf=None):
    """Block-sparse rows x dense, fp32 out (num_rows, F). Either
    ``bsr_spmm(A, dense)`` with A a BsrMatrix, or the unpacked
    ``bsr_spmm(tile_values, tile_rows, tile_cols, dense, num_rows)``.
    ``bf`` is the reference grid's F block; no form here changes its sums
    with it."""
    if isinstance(tile_values, BsrMatrix):
        A = tile_values
        if (tile_cols is not None or num_rows is not None
                or (tile_rows is not None and dense is not None)):
            raise TypeError(
                "bsr_spmm(A, dense): extra operands alongside the BsrMatrix form"
            )
        if dense is None:  # positional form: bsr_spmm(A, dense)
            dense = tile_rows
        tile_values, tile_rows, tile_cols = A.tile_values, A.tile_rows, A.tile_cols
        num_rows = A.shape[0]
    if tile_rows is None or tile_cols is None or dense is None or num_rows is None:
        raise TypeError(
            "bsr_spmm: tile coordinates, dense operand and num_rows are required"
        )
    blocks = resolve_blocks("bsr_spmm", bf=bf)
    return _dispatch("bsr_spmm", tile_values, tile_rows, tile_cols, dense,
                     num_rows=num_rows, mesh=mesh, impl=impl, **blocks)


dispatch.register_kernel("bsr_spmm", impl="cuda")(grads.forward_only("bsr_spmm", _bsr.bsr_spmm_cuda))
dispatch.register_kernel("bsr_spmm", impl="torch")(_blocked.bsr_spmm_blocked)


@dispatch.register_kernel("bsr_spmm", impl="ref")
def _bsr_ref(tile_values, tile_rows, tile_cols, dense, num_rows, *, bf=None):
    return _ref.bsr_spmm_ref(tile_values, tile_rows, tile_cols, dense, num_rows)


# ---------------------------------------------------------------------------
# SpMSpM (sparse-sparse, index intersection)
# ---------------------------------------------------------------------------


def spmspm(a_values, a_cols, b_values=None, b_rows=None, contraction_dim=None,
           *, impl=None, mesh=None, bm=None, bn=None):
    """Sparse x sparse by index intersection, fp32 out (R, C). Either
    ``spmspm(A, B, k)`` with ELL operands (B holding the right matrix's
    columns), or unpacked arrays. ``bm``/``bn`` shape the plain form
    only. An index outside ``[0, contraction_dim)`` contributes nothing,
    in the kernel and in its plain version alike (``impl="ref"`` is the
    reference's twin, which such indices lie outside the contract of)."""
    if isinstance(a_values, EllMatrix):
        A, B = a_values, a_cols
        if not isinstance(B, EllMatrix):
            raise TypeError("spmspm(A, B, k): B must also be an EllMatrix")
        if b_rows is not None or (b_values is not None
                                  and contraction_dim is not None):
            raise TypeError(
                "spmspm(A, B, k): extra operands alongside the EllMatrix form"
            )
        if b_values is not None:  # positional form: spmspm(A, B, k)
            contraction_dim = b_values
        a_values, a_cols = A.values, A.cols
        b_values, b_rows = B.values, B.cols
    if b_values is None or b_rows is None or contraction_dim is None:
        raise TypeError(
            "spmspm: b_values, b_rows and contraction_dim are required"
        )
    blocks = resolve_blocks("spmspm", bm=bm, bn=bn)
    return _dispatch("spmspm", a_values, a_cols, b_values, b_rows,
                     contraction_dim=contraction_dim, mesh=mesh, impl=impl, **blocks)


dispatch.register_kernel("spmspm", impl="cuda")(grads.forward_only("spmspm", _spmspm.spmspm_cuda))
dispatch.register_kernel("spmspm", impl="torch")(_blocked.spmspm_blocked)


@dispatch.register_kernel("spmspm", impl="ref")
def _spmspm_ref(a_values, a_cols, b_values, b_rows, contraction_dim, *,
                bm=None, bn=None):
    return _ref.spmspm_ref(a_values, a_cols, b_values, b_rows, contraction_dim)


# ---------------------------------------------------------------------------
# Stencil (offset streams, periodic boundary)
# ---------------------------------------------------------------------------


def stencil(grid, offsets, weights, *, impl=None, mesh=None, bx=None,
            overlap=True):
    """Periodic stencil: grid (X, Y, Z), static offsets (P, 3), weights
    (P,); the output has the grid's dtype. ``overlap`` schedules the
    sharded halo exchange (the interior computed while the halo planes
    fly; bitwise the synchronous schedule) and is a no-op without a mesh.
    ``bx`` is the reference kernel's x-block: the ``cuda`` impl keeps its
    limits (X % bx == 0, |dx| <= bx)."""
    blocks = resolve_blocks("stencil", bx=bx)
    return _dispatch("stencil", grid, offsets=offsets, weights=weights, mesh=mesh,
                     impl=impl, overlap=overlap, **blocks)


dispatch.register_kernel("stencil", impl="cuda")(grads.forward_only("stencil", _stencil.stencil_cuda))
dispatch.register_kernel("stencil", impl="torch")(_blocked.stencil_blocked)


@dispatch.register_kernel("stencil", impl="ref")
def _stencil_ref(grid, offsets, weights, *, bx=None):
    return _ref.stencil_ref(grid, offsets, weights)
