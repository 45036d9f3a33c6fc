"""Gradients through the Hopper kernels on the training path.

The reference has no backward kernel (``src/repro`` holds no
``custom_vjp``): its training differentiates through the ``xla`` forms.
Here the two kernels a training step runs keep their Hopper forward and
take a backward in plain tensor code, each a ``torch.autograd.Function``
that ``hopper/ops.py``'s ``cuda`` impl calls when an input requires grad:

- ``flash_attention`` (the kernel of ``csrc/flash_attention.cu``,
  replacing ``repro/kernels/flash_attention.py:57`` ``_fa_kernel``): the
  forward is the kernel's ``return_lse`` form; it saves q, k, v, o and
  that lse. The backward is FA-2's, over blocks of keys: P recomputed from
  q, k and the saved lse, dV = P^T dO, dP = dO V^T,
  dS = P (dP - rowsum(dO O)), dQ and dK from dS, under the forward's
  causal, window and ``q_offset`` masks, with the query groups of a GQA
  head summed into dK and dV. A block holds B*H*Sq*bk scores, never
  Sq*Sk of them.
- ``linear_attention`` (``csrc/linear_attention.cu``, replacing
  ``repro/kernels/rwkv6.py:24`` ``_la_kernel``): the forward is the
  three-launch kernel; the backward recomputes the plain chunked form
  ``blocked.linear_attention_blocked`` under ``torch.enable_grad()`` and
  takes ``torch.autograd.grad`` of it, for both read-outs, ``s0`` and the
  final state's incoming gradient. That gradient is the plain form's, at
  the plain form's forward.

Each Function keeps its state in ``ctx`` only, so ``torch.utils.checkpoint``
may run its forward again in the backward (each rerun launches the
kernel again and counts in ``dispatch.LAUNCHES``). On CPU tensors the
kernels' wrappers run their plain forms (in fp64 for fp64 inputs), which is
what the gradient checks hold the Functions' backward to.

Every other kernel has no backward. ``forward_only`` wraps its ``cuda``
impl so that an input requiring grad (with grad enabled) raises before
anything is built or launched, rather than returning a result cut off
from the graph; the scaled attention form and the mesh path raise the
same way (``hopper/ops.py``).
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.hopper import blocked
from repro_torch.hopper import flash_attention as _fa
from repro_torch.hopper import linear_attention as _la

# scores a FA backward block may hold: B*H*Sq*bk <= this many values
BWD_BLOCK_ELEMS = 1 << 25


def needs_grad(*xs) -> bool:
    """Grad mode is on and one of the tensors among ``xs`` requires grad."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in xs)


def no_backward(what: str, where: str):
    raise NotImplementedError(
        f"{what} has no gradient: {where}. Call it under torch.no_grad() or "
        f"on inputs that do not require grad"
    )


def forward_only(op: str, fn):
    """``fn`` (an op's ``cuda`` impl) guarded: with grad enabled, a tensor
    argument that requires grad raises ``NotImplementedError`` before the
    wrapper runs."""
    @functools.wraps(fn)
    def guarded(*args, **kwargs):
        if needs_grad(*args, *kwargs.values()):
            no_backward(f"ops.{op}'s cuda kernel",
                        "the reference trains through no such op and the kernel has no backward")
        return fn(*args, **kwargs)

    return guarded


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------


def _key_block(B, H, Sq, Sk):
    bk = 1 << max(4, int(math.log2(max(BWD_BLOCK_ELEMS // max(B * H * Sq, 1), 1))))
    return max(1, min(bk, Sk))


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, window=0, q_offset=0,
                        scale=None, block=None):
    """FA-2 backward: (dq, dk, dv) in the inputs' shapes and dtypes from
    the forward's q (B, H, Sq, D), k/v (B, K, Sk, D), o, its lse (B, H, Sq)
    and dO. Computes in fp32 (fp64 for fp64 inputs) over blocks of
    ``block`` keys (by default as many as keep B*H*Sq*block within
    ``BWD_BLOCK_ELEMS``); a block that every query masks is skipped, and so
    are the query rows whose causal or window mask covers the whole block
    (the rows' scores are all masked, so they would add exact zeros)."""
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    ct = blocked.compute_dtype(q)
    dev = q.device
    qs = (q.to(ct) * scale).reshape(B, K, G, Sq, D)
    dof = do.to(ct).reshape(B, K, G, Sq, D)
    delta = (dof * o.to(ct).reshape(B, K, G, Sq, D)).sum(-1)
    lsef = lse.to(ct).reshape(B, K, G, Sq)
    q_pos = torch.arange(Sq, device=dev) + q_offset
    dq = torch.zeros((B, K, G, Sq, D), dtype=ct, device=dev)
    dk = torch.zeros((B, K, Sk, D), dtype=ct, device=dev)
    dv = torch.zeros((B, K, Sk, D), dtype=ct, device=dev)
    bk = block or _key_block(B, H, Sq, Sk)
    last_q = q_offset + Sq - 1
    for start in range(0, Sk, bk):
        stop = min(start + bk, Sk)
        if (causal or window) and start > last_q:
            break  # every later key lies in every query's future
        if window and stop - 1 <= q_offset - window:
            continue  # every key lies outside every query's window
        # the query rows this block reaches: q_pos >= start (causal) and
        # q_pos - window < stop - 1 (window)
        r0 = min(max(start - q_offset, 0), Sq) if (causal or window) else 0
        r1 = min(max(stop - 1 + window - q_offset, 0), Sq) if window else Sq
        if r0 >= r1:
            continue
        rows = slice(r0, r1)
        kb = k[:, :, start:stop].to(ct)
        vb = v[:, :, start:stop].to(ct)
        qr, dor = qs[:, :, :, rows], dof[:, :, :, rows]
        s = torch.einsum("bkgqd,bksd->bkgqs", qr, kb)
        k_pos = torch.arange(start, stop, device=dev)
        qp = q_pos[rows]
        mask = torch.ones((r1 - r0, stop - start), dtype=torch.bool, device=dev)
        if causal or window:
            mask = mask & (k_pos[None, :] <= qp[:, None])
        if window:
            mask = mask & (k_pos[None, :] > qp[:, None] - window)
        p = torch.where(mask, torch.exp(s - lsef[:, :, :, rows, None]), 0.0)
        dv[:, :, start:stop] = torch.einsum("bkgqs,bkgqd->bksd", p, dor)
        ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dor, vb) - delta[:, :, :, rows, None])
        dq[:, :, :, rows] += torch.einsum("bkgqs,bksd->bkgqd", ds, kb)
        dk[:, :, start:stop] = torch.einsum("bkgqs,bkgqd->bksd", ds, qr)
    dq = (dq * scale).reshape(B, H, Sq, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, opts):
        o, lse = _fa.flash_attention_cuda(q, k, v, return_lse=True, **opts)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = {n: opts[n] for n in ("causal", "window", "q_offset", "scale")}
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None


def flash_attention(q, k, v, *, causal=True, window=0, q_offset=0, scale=None,
                    return_lse=False, **blocks):
    """``flash_attention_cuda`` with a gradient: o (B, H, Sq, D).
    ``return_lse`` raises (no gradient flows through the lse)."""
    if return_lse:
        no_backward("flash_attention(return_lse=True)",
                    "the lse output takes no gradient (ROADMAP queue 1 item 2b, the ring path)")
    opts = dict(causal=causal, window=window, q_offset=q_offset, scale=scale, **blocks)
    return _FlashAttention.apply(q, k, v, opts)


# ---------------------------------------------------------------------------
# chunked linear attention
# ---------------------------------------------------------------------------


def linear_attention_bwd(inputs, needs, do, dS, *, chunk):
    """Gradients of ``blocked.linear_attention_blocked`` (o, S_final) at
    ``inputs`` = (r, k, v, w_log, u, s0) against the incoming (do, dS);
    ``needs`` flags which inputs want one (None for the others)."""
    with torch.enable_grad():
        xs = [None if x is None else x.detach().requires_grad_(bool(n))
              for x, n in zip(inputs, needs)]
        o, S = blocked.linear_attention_blocked(*xs, chunk=chunk)
        wrt = [i for i, x in enumerate(xs) if x is not None and needs[i]]
        gs = torch.autograd.grad((o, S), [xs[i] for i in wrt], (do, dS), allow_unused=True)
    out = [None] * len(inputs)
    for i, g in zip(wrt, gs):
        out[i] = None if g is None else g.to(inputs[i].dtype)
    return out


class _LinearAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w_log, u, s0, chunk):
        o, s_final = _la.linear_attention_cuda(r, k, v, w_log, u, s0, chunk=chunk)
        ctx.save_for_backward(r, k, v, w_log, u, s0)
        ctx.chunk = chunk
        return o, s_final

    @staticmethod
    def backward(ctx, do, dS):
        grads = linear_attention_bwd(ctx.saved_tensors, ctx.needs_input_grad[:6], do, dS,
                                     chunk=ctx.chunk)
        return (*grads, None)


def linear_attention(r, k, v, w_log, u=None, s0=None, *, chunk=None):
    """``linear_attention_cuda`` with a gradient: (o, S_final)."""
    return _LinearAttention.apply(r, k, v, w_log, u, s0, chunk)
