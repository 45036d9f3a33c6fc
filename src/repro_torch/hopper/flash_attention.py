"""FA-2 forward on Hopper: the wrapper of ``csrc/flash_attention.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/flash_attention.py``
``_fa_kernel`` (plain and ``return_lse`` forms). For CUDA tensors the
wrapper checks its inputs, allocates the outputs, launches the kernel on
PyTorch's current stream, raises on a launch error and adds one to
``dispatch.LAUNCHES["flash_attention"]``. For CPU tensors, and only for
them, it runs the plain version ``blocked.flash_attention_blocked``.

The kernel takes element strides, so the transformer's (B, S, H, D) ->
(B, H, S, D) transposed views go in without a copy; the head dim must be
unit-stride. Inputs it does not take raise; nothing is copied to make
them fit. The output has q's strides. The bf16 kernel's warpgroups a CTA
(1 or 2) are a run-time argument: 0, the kernel's own rule, unless a plan
override is set at the call's arguments (``plan``, ``candidates``).

``zigzag_indices`` / ``zigzag_inverse`` are the port's copies of the
reference's sequence permutation for the causal KV ring
(``kernels/flash_attention.py``), pure numpy.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.device import sm_count
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, KernelStreams, PlanCandidate, StreamOperand,
                                        lookup_plan, model_pick, register_streams)

HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's compiled head dims
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# csrc/flash_attention.cu's bf16 kernel: NWG warpgroups a CTA, each 64 q rows
WG_BQ = 64
WG_THREADS = 128
SMEM_PER_CTA = 232448  # 227 KB of shared memory a CTA may use
# The warpgroup model (the kernel's host rule, launch_d): a wave of 64-row
# CTAs costs 1; with two warpgroups a CTA, each wave past the first costs
# TWO_WG_WAVE (one's softmax hides behind the other's products), and the
# pair's shared tiles TWO_WG_SETUP more.
TWO_WG_WAVE = 0.5
TWO_WG_SETUP = 0.25

_fn = None


def zigzag_indices(S: int, d: int) -> np.ndarray:
    """The zigzag (head + tail) sequence permutation of a ``d``-rank causal
    KV ring: ``S`` rows split into ``2d`` half-chunks, rank ``r`` owning
    half-chunks ``r`` and ``2d-1-r``, so every rank does the same score
    work per hop. Returns the gather index: natural row ``idx[i]`` lands at
    zigzag position ``i``; each rank's two halves keep natural order, head
    first, so a rank's concatenated block is order-isomorphic to its global
    rows. Requires ``S % (2 * d) == 0``."""
    c2 = S // (2 * d)
    parts = []
    for r in range(d):
        parts.append(np.arange(r * c2, (r + 1) * c2))
        parts.append(np.arange((2 * d - 1 - r) * c2, (2 * d - r) * c2))
    return np.concatenate(parts)


def zigzag_inverse(S: int, d: int) -> np.ndarray:
    """Inverse of ``zigzag_indices``: gathering with it restores natural
    sequence order."""
    return np.argsort(zigzag_indices(S, d), kind="stable")


def wg_smem_bytes(D: int, nwg: int) -> int:
    """The bf16 kernel's shared memory (csrc/flash_attention.cu
    ``wg_smem_bytes<D, NWG>``): Q of each warpgroup and two stages of K
    and V, 64 x D bf16 each, and 1 KB of alignment."""
    return (nwg + 4) * 64 * D * 2 + 1024


def candidates(B: int, H: int, Sq: int, D: int, dtype: torch.dtype, sms: int, *,
               smem_budget: int = SMEM_PER_CTA) -> list[PlanCandidate]:
    """The warpgroups a CTA (1 or 2) of the bf16 kernel for q (B, H, Sq, D)
    on a card of ``sms`` SMs, each pruned where ``wg_smem_bytes`` passes
    ``smem_budget``; the fp32 kernel has one plan (0). The model: one
    warpgroup a CTA costs its waves of 64-row CTAs, w = ceil(ctas / sms);
    two cost 1 + TWO_WG_SETUP + TWO_WG_WAVE (w - 1). So one wins while
    the CTAs fit in one wave, two once they do not: the kernel's own rule
    (nwg 0)."""
    if dtype != torch.bfloat16:
        return [PlanCandidate(0, {"nwg": 0}, 0.0, (0.0,), 0, 0, 0)]
    waves = -(-(-(-Sq // WG_BQ) * H * B) // sms)
    out = []
    for nwg in (1, 2):
        smem = wg_smem_bytes(D, nwg)
        cost = float(waves) if nwg == 1 else 1 + TWO_WG_SETUP + TWO_WG_WAVE * (waves - 1)
        why = "shared memory" if smem > smem_budget else ""
        out.append(PlanCandidate(nwg, {"nwg": nwg}, float("inf") if why else cost,
                                 (float("inf"),) if why else (cost,), smem,
                                 nwg * WG_THREADS, 0, why))
    return out


def plan(B: int, H: int, Sq: int, D: int, dtype: torch.dtype, sms: int) -> int:
    """The warpgroups a CTA the kernel takes at these arguments: a plan
    override at exactly them (``dispatch.lookup_plan("flash_attention",
    ...)``), else ``candidates``' least-cost entry, which is the rule the
    kernel applies itself when the wrapper passes 0."""
    hit = lookup_plan("flash_attention", (B, H, Sq, D, dtype, sms))
    return hit if hit is not None else model_pick(candidates(B, H, Sq, D, dtype, sms)).plan


@register_streams("flash_attention", kernel="flash_attention")
def streams(structs, policy=None, *, return_lse=False, **_):
    """The kernel's streams for ``ops.flash_attention`` with no
    ``precision``: q (B, H, Sq, D), k and v (B, K, Sk, D) values; the row
    max, row sum and output block carried in fp32; o in q's shape and
    dtype, and the (B, H, Sq) fp32 log-sum-exp with ``return_lse``."""
    if policy is not None:
        return None
    (q_shape, dtype), (k_shape, _), (v_shape, _) = structs[:3]
    outs = (StreamOperand("value", q_shape, dtype),)
    if return_lse:
        outs += (StreamOperand("value", q_shape[:3], torch.float32),)
    return KernelStreams(
        "flash_attention/" + ("ffma" if dtype == torch.float32 else "mma"),
        tuple(StreamOperand("value", s, d) for s, d in structs[:3]), torch.float32, outs)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("flash_attention")
        fn = lib.repro_fa_fwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       i32, i32, i32, i32, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(q, k, v):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(
            f"flash_attention: q/k/v must share one CUDA device, got "
            f"{q.device}/{k.device}/{v.device}"
        )
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention kernel takes float32 or bfloat16 q/k/v of one "
            f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}"
        )
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: q (B,H,Sq,D), k/v (B,K,Sk,D), got "
            f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}"
        )
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[1]:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}"
        )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {D} not in {HEAD_DIMS}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(
                f"flash_attention kernel: {name} must be unit-stride in its "
                f"head dim, got strides {x.stride()}"
            )
        # the bf16 kernel moves rows in 16-byte chunks
        if x.dtype == torch.bfloat16 and (
            x.data_ptr() % 16 or any(s % 8 for s in x.stride()[:3])
        ):
            raise ValueError(
                f"flash_attention bf16 kernel: {name} needs a 16-byte aligned "
                f"start and (b, h, s) strides that are multiples of 8, got "
                f"strides {x.stride()}"
            )


def flash_attention_cuda(q, k, v, *, causal=True, window=0, q_offset=0,
                         scale=None, return_lse=False, **blocks):
    """q (B, H, Sq, D); k/v (B, K, Sk, D). Launches the Hopper kernel for
    CUDA tensors; runs ``blocked.flash_attention_blocked`` for CPU tensors
    (``blocks`` — the plain form's ``bq``/``bk`` — reach only that form).
    Returns o, and (o, lse) with ``return_lse``."""
    if q.device.type == "cpu":
        return blocked.flash_attention_blocked(
            q, k, v, causal=causal, window=window, q_offset=q_offset,
            scale=scale, return_lse=return_lse, **blocks,
        )
    _check(q, k, v)
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if Sq:
        lib, fn = _kernel()
        # warpgroups a CTA: a tuned plan at exactly this call's arguments,
        # else 0, the kernel's own rule (``plan``'s model)
        nwg = lookup_plan("flash_attention",
                          (B, H, Sq, D, q.dtype, sm_count(q.device.index))) or 0
        strides = (ctypes.c_longlong * 12)(
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3]
        )
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                DTYPES[q.dtype], B, H, K, Sq, Sk, D, strides, float(scale),
                int(bool(causal)), int(window), int(q_offset), int(nwg), stream,
            )
        build.check(lib, err, "flash_attention kernel launch")
        LAUNCHES["flash_attention"] += 1
    return (o, lse) if return_lse else o
