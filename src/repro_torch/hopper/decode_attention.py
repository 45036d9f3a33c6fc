"""Split-KV decode attention on Hopper: the wrapper of ``csrc/flash_decode.cu``.

Replaces no TPU kernel: the reference's decode attention is its XLA
blocked form, which the port's plain ``blocked.decode_attention_blocked``
follows, and that form set the serving engine's pace on the card (a gather
of the whole block table and a loop of small kernels over every column).
The kernel walks only each sequence's live pages, reads the pools as they
are stored and keeps the fp32 online softmax on chip; its source says how.

For CUDA tensors the wrapper checks its inputs, allocates the outputs (and,
where a call splits its pages over blocks, the fp32 partials), launches on
PyTorch's current stream, raises on a launch error and adds one to
``dispatch.LAUNCHES["decode_attention"]``; a call is one or two launches
(the pages, then the merge of the splits) and counts as one. For CPU
tensors, and only for them, it runs the plain version.

Both of the op's layouts take the kernel: paged pools (P, K, bs, D) through
``block_table`` (B, NB), and the contiguous cache (B, K, S, D) in blocks of
the plain form's ``bs``, as if through the identity table. ``precision=``
on the contiguous path quantizes the cache as the plain form does
(``precision.quantize_kv_cache``), then runs the kernel with the scales.
The pools may be fp32, bf16, fp16, or fp8 (e4m3, e5m2) with per-row fp32
``k_scale``/``v_scale``; q is fp32, bf16 or fp16 and o takes its dtype.
Head dims 64, 128 and 256, and at most ``MAX_G`` query heads a kv head;
anything else raises.

``plan`` picks the split from shapes alone, so a call's summation order
does not depend on the data, and ``live_pages`` is the kernel's count of
the pages it walks, on the host.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core import precision as prec
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, KernelStreams, StreamOperand, register_streams,
                                        resolve_blocks, resolve_impl)

HEAD_DIMS = (64, 128, 256)  # the kernel's compiled head dims
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
             torch.float8_e4m3fn: 3, torch.float8_e5m2: 4}
Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
INDEX_DTYPES = (torch.int32, torch.int64)
MAX_G = 8  # query heads a kv head: the kernel's largest instantiation
SPLIT_ROWS = 256  # rows a split takes, in whole pages, where the grid is full
MIN_CTAS = 264  # blocks below which the split halves: two for each of 132 SMs

_fn = None


def plan(B: int, K: int, bs: int, nb: int) -> tuple[int, int]:
    """(pages a split, splits) for B sequences of K kv heads over nb table
    columns (contiguous: blocks) of bs rows. A split takes SPLIT_ROWS rows
    in whole pages (at least one page); while the grid of (splits, K, B)
    blocks falls short of MIN_CTAS, the pages a split halve. Shapes only:
    the kernel's summation order follows from this and the positions."""
    pps = max(1, SPLIT_ROWS // bs)
    while pps > 1 and B * K * -(-nb // pps) < MIN_CTAS:
        pps //= 2
    return pps, -(-nb // pps)


def live_pages(position, *, bs: int, nb: int, window: int = 0, pos_offset: int = 0) -> np.ndarray:
    """The pages the kernel walks for each sequence of a paged call, as it
    counts them: the columns holding the live rows ``max(0, position -
    window + 1 - pos_offset)`` (0 without a window) to ``min(position -
    pos_offset, nb * bs - 1)``. A sequence with no live row walks none."""
    pos = np.asarray(position, np.int64)
    hi = np.minimum(pos - pos_offset + 1, nb * bs)
    lo = np.maximum(0, pos - window + 1 - pos_offset) if window > 0 else np.zeros_like(pos)
    return np.where(hi > lo, (hi - 1) // bs - lo // bs + 1, 0)


def walks_live_pages(device) -> bool:
    """Whether a decode on ``device`` runs this kernel, which walks live
    pages only; the plain form walks every table column."""
    return resolve_impl("decode_attention") == "cuda" and torch.device(device).type == "cuda"


@register_streams("decode_attention", kernel="flash_decode")
def streams(structs, policy=None, *, block_table=None, k_scale=None, return_lse=False, **_):
    """The kernel's streams for ``ops.decode_attention``: q (B, H, D), k and
    v (pools or cache) values, position and, paged, the block table as
    indices; under ``precision`` (quantized at the call) or with pool
    scales, k and v narrow with one fp32 scale a row (block D); the online
    softmax in fp32; o in q's shape and dtype, and the (B, H) fp32
    log-sum-exp with ``return_lse``. None for calls the kernel does not
    take (head dims outside HEAD_DIMS)."""
    if len(structs) < 4 or structs[1] is None or structs[1][0][-1] not in HEAD_DIMS:
        return None
    (q_shape, q_dtype), (k_shape, k_dtype), (v_shape, v_dtype), pos = structs[:4]
    if policy is not None and k_scale is None:
        k_dtype = v_dtype = policy.compute_dtype
    operands = (StreamOperand("value", q_shape, q_dtype), StreamOperand("value", k_shape, k_dtype),
                StreamOperand("value", v_shape, v_dtype), StreamOperand("index", *pos))
    if block_table is not None:
        operands += (StreamOperand("index", tuple(block_table.shape), block_table.dtype),)
    if policy is not None or k_scale is not None:
        rows = tuple(k_shape[:-1]) + (1,)
        operands += tuple(StreamOperand("scale", rows, torch.float32, k_shape[-1])
                          for _ in range(2))
    outs = (StreamOperand("value", q_shape, q_dtype),)
    if return_lse:
        outs += (StreamOperand("value", q_shape[:2], torch.float32),)
    layout = "paged" if block_table is not None else "contiguous"
    return KernelStreams(f"flash_decode/{layout}", operands, torch.float32, outs)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("flash_decode")
        fn = lib.repro_flash_decode
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr] * 10 + [i32] * 14 + [ctypes.POINTER(ctypes.c_longlong),
                                                 ctypes.c_float, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _aligned(x) -> bool:
    """A 16-byte start, and (dim 0, dim 1) strides of whole 16 bytes: the
    kernel copies rows in 16-byte pieces."""
    step = 16 // x.element_size()
    return x.data_ptr() % 16 == 0 and x.stride(0) % step == 0 and x.stride(1) % step == 0


def check_args(q, k, v, position, *, block_table=None, k_scale=None, v_scale=None, window=0):
    """Raise on a call the kernel does not take: dtypes, shapes, head dim,
    heads a kv head, row layout and alignment, scales, indices, window.
    Host-side only (the device check is the wrapper's), so the CPU tests
    reach it."""
    if q.dtype not in Q_DTYPES:
        raise TypeError(f"decode_attention kernel takes float32, bfloat16 or float16 q, "
                        f"got {q.dtype}")
    if k.dtype not in KV_DTYPES or v.dtype != k.dtype:
        raise TypeError(f"decode_attention kernel takes k and v of one dtype in "
                        f"{sorted(str(d) for d in KV_DTYPES)}, got {k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q (B, H, D) and k/v of one 4-d shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    B, H, D = q.shape
    K = k.shape[1]
    if k.shape[3] != D or H % K:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel: head dim {D} not in {HEAD_DIMS}")
    if H // K > MAX_G:
        raise ValueError(f"decode_attention kernel: {H // K} query heads a kv head, "
                         f"at most {MAX_G}")
    if q.stride(2) != 1:
        raise ValueError(f"decode_attention kernel: q must be unit-stride in D, got {q.stride()}")
    for name, x in (("k", k), ("v", v)):
        if x.stride(3) != 1 or x.stride(2) != D or not _aligned(x):
            raise ValueError(
                f"decode_attention kernel: {name} needs contiguous rows of D (strides (.., .., "
                f"{D}, 1)), a 16-byte aligned start and 16-byte (dim 0, dim 1) strides, got "
                f"strides {x.stride()}")
    if window < 0:
        raise ValueError(f"decode_attention kernel: window must be >= 0, got {window}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("decode_attention kernel: k_scale and v_scale go together")
    if k.dtype in (torch.float8_e4m3fn, torch.float8_e5m2) and k_scale is None:
        raise TypeError(f"decode_attention kernel: {k.dtype} pools need k_scale/v_scale")
    if k_scale is not None:
        want = tuple(k.shape[:3]) + (1,)
        for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(s.shape) != want or s.dtype != torch.float32 or s.stride(2) != 1:
                raise ValueError(f"decode_attention kernel: {name} must be float32 {want} with "
                                 f"rows 1 apart, got {s.dtype} {tuple(s.shape)} {s.stride()}")
    if position.dtype not in INDEX_DTYPES or tuple(position.shape) != (B,) or \
            (B > 1 and position.stride(0) != 1):
        raise ValueError(f"decode_attention kernel: position must be contiguous int32/int64 "
                         f"({B},), got {position.dtype} {tuple(position.shape)}")
    if block_table is not None and (block_table.dtype not in INDEX_DTYPES or block_table.dim() != 2
                                    or block_table.shape[0] != B or block_table.stride(1) != 1):
        raise ValueError(f"decode_attention kernel: block_table must be int32/int64 (B, NB) "
                         f"with unit column stride, got {block_table.dtype} "
                         f"{tuple(block_table.shape)} {block_table.stride()}")


def decode_attention_cuda(q, k, v, position, *, window=0, scale=None, bs=None,
                          precision=None, block_table=None, k_scale=None, v_scale=None,
                          pos_offset=0, return_lse=False):
    """``ops.decode_attention``'s arguments as the plain form takes them.
    Launches the Hopper kernel for CUDA tensors; runs
    ``blocked.decode_attention_blocked`` for CPU tensors. Returns o (B, H,
    D) in q's dtype, and (o, lse (B, H) fp32) with ``return_lse``."""
    if q.device.type == "cpu":
        return blocked.decode_attention_blocked(
            q, k, v, position, window=window, scale=scale, bs=bs, precision=precision,
            block_table=block_table, k_scale=k_scale, v_scale=v_scale,
            pos_offset=pos_offset, return_lse=return_lse)
    if precision is not None and k_scale is None:
        k, k_scale, v, v_scale = prec.quantize_kv_cache(k, v, precision)
    named = [("q", q), ("k", k), ("v", v), ("position", position), ("block_table", block_table),
             ("k_scale", k_scale), ("v_scale", v_scale)]
    if not all(x.is_cuda and x.device == q.device for _, x in named if x is not None):
        raise ValueError("decode_attention: inputs must share one CUDA device, got " + ", ".join(
            f"{n}={x.device}" for n, x in named if x is not None))
    check_args(q, k, v, position, block_table=block_table, k_scale=k_scale, v_scale=v_scale,
               window=window)
    B, H, D = q.shape
    K = k.shape[1]
    if block_table is not None:
        bs, nb = k.shape[2], block_table.shape[1]
        S = nb * bs
    else:
        S = k.shape[2]
        bs = min(resolve_blocks("decode_attention", bs=bs)["bs"], S)
        nb = -(-S // bs) if bs else 0
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) if return_lse else None
    if B and S:
        pps, nsplit = plan(B, K, bs, nb)
        part = (torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32, device=q.device)
                if nsplit > 1 else None)
        ks_st = k_scale.stride()[:2] if k_scale is not None else (0, 0)
        vs_st = v_scale.stride()[:2] if v_scale is not None else (0, 0)
        strides = (ctypes.c_longlong * 11)(
            *q.stride()[:2], *k.stride()[:2], *v.stride()[:2], *ks_st, *vs_st,
            block_table.stride(0) if block_table is not None else 0)

        def ptr(x):
            return x.data_ptr() if x is not None else None

        lib, fn = _kernel()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = fn(ptr(q), ptr(o), ptr(lse), ptr(k), ptr(v), ptr(k_scale), ptr(v_scale),
                     ptr(block_table), ptr(position), ptr(part),
                     KV_DTYPES[k.dtype], Q_DTYPES[q.dtype],
                     int(block_table is not None and block_table.dtype == torch.int64),
                     int(position.dtype == torch.int64), B, H, K, D, bs, S, int(window),
                     int(pos_offset), pps, nsplit, strides, float(scale), stream)
        build.check(lib, err, "decode_attention kernel launch")
        LAUNCHES["decode_attention"] += 1
    return (o, lse) if return_lse else o
