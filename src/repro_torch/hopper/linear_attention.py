"""Chunked linear attention on Hopper: the wrapper of ``csrc/linear_attention.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/rwkv6.py``
``_la_kernel`` (both read-outs: RWKV with ``u``, SSD without). For CUDA
tensors the wrapper checks its inputs, allocates the outputs, launches the
kernel on PyTorch's current stream, raises on a launch error and adds one
to ``dispatch.LAUNCHES["linear_attention"]``. For CPU tensors, and only for
them, it runs the plain version ``blocked.linear_attention_blocked``.

The kernel takes element strides, so the models' transposed
(B, S, H, N) -> (B, H, S, N) views and the SSD path's broadcast r/k (stride
0 over heads) and w (stride 0 over N) go in without a copy. r, k and v
share one dtype (fp32 or bf16); w is fp32; u and s0 are read as
fp32 (each a small copy where it is not already contiguous fp32). o takes
v's layout and dtype; S_final is fp32 (B, H, N, M). The ragged last chunk
of a T that ``chunk`` does not divide acts as the reference's zero padding.
One call is three launches (the chunks' state contributions, the
sequential pass over the chunks, the read-out; see the source) and counts
as one launch of the kernel. The wrapper allocates the launches' fp32
scratch, B*H*ceil(T/chunk)*N*(M + 1) values.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, KernelStreams, StreamOperand, register_streams,
                                        resolve_blocks)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK = 34  # csrc/linear_attention.cu MAX_CHUNK: ops.linear_attention's overflow guard
MAX_N = 128  # csrc/linear_attention.cu MAX_N

_fn = None


@register_streams("linear_attention", kernel="linear_attention")
def streams(structs, policy=None, **_):
    """The kernel's streams for ``ops.linear_attention``: r, k (B, H, T,
    N) and v (B, H, T, M) values of one dtype, w_log fp32, and where given
    u (H, N) and s0 (B, H, N, M), both read as fp32; the state carried in
    fp32; o (B, H, T, M) in v's dtype and S_final (B, H, N, M) fp32."""
    (r, rd), (k, kd), (v, vd), (w, wd) = structs[:4]
    u, s0 = (tuple(structs[4:6]) + (None, None))[:2]
    operands = (StreamOperand("value", r, rd), StreamOperand("value", k, kd),
                StreamOperand("value", v, vd), StreamOperand("value", w, wd))
    operands += tuple(StreamOperand("value", x[0], torch.float32) for x in (u, s0) if x)
    B, H, N, M = r[0], r[1], r[3], v[3]
    return KernelStreams("linear_attention", operands, torch.float32,
                         (StreamOperand("value", (B, H, r[2], M), vd),
                          StreamOperand("value", (B, H, N, M), torch.float32)))


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("linear_attention")
        fn = lib.repro_linear_attention
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32,
                       i32, i32, i32, i32, ctypes.POINTER(ctypes.c_longlong), ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(r, k, v, w_log, u, s0, chunk):
    tensors = [("r", r), ("k", k), ("v", v), ("w_log", w_log)]
    tensors += [(n, x) for n, x in (("u", u), ("s0", s0)) if x is not None]
    if not all(x.is_cuda and x.device == r.device for _, x in tensors):
        raise ValueError(
            "linear_attention: inputs must share one CUDA device, got "
            + ", ".join(f"{n}={x.device}" for n, x in tensors)
        )
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(
            f"linear_attention kernel takes float32 or bfloat16 r/k/v of one "
            f"dtype, got {r.dtype}/{k.dtype}/{v.dtype}"
        )
    if w_log.dtype != torch.float32:
        raise TypeError(f"linear_attention kernel takes a float32 w_log, got {w_log.dtype}")
    if r.dim() != 4 or k.shape != r.shape or w_log.shape != r.shape:
        raise ValueError(
            f"linear_attention: r, k, w_log must be one (B, H, T, N) shape, got "
            f"{tuple(r.shape)} {tuple(k.shape)} {tuple(w_log.shape)}"
        )
    B, H, T, N = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (B, H, T):
        raise ValueError(f"linear_attention: v must be (B, H, T, M), got {tuple(v.shape)}")
    M = v.shape[3]
    if u is not None and tuple(u.shape) != (H, N):
        raise ValueError(f"linear_attention: u must be (H, N) = {(H, N)}, got {tuple(u.shape)}")
    if s0 is not None and tuple(s0.shape) != (B, H, N, M):
        raise ValueError(
            f"linear_attention: s0 must be (B, H, N, M) = {(B, H, N, M)}, got {tuple(s0.shape)}"
        )
    if N > MAX_N:
        raise ValueError(f"linear_attention kernel takes N <= {MAX_N}, got {N}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"linear_attention kernel takes 1 <= chunk <= {MAX_CHUNK}, got {chunk}")


def linear_attention_cuda(r, k, v, w_log, u=None, s0=None, *, chunk=None):
    """r, k, w_log (B, H, T, N); v (B, H, T, M); u (H, N) or None (SSD);
    s0 (B, H, N, M) or None. Launches the Hopper kernel for CUDA tensors;
    runs ``blocked.linear_attention_blocked`` for CPU tensors. Returns
    (o (B, H, T, M) in v's dtype, S_final (B, H, N, M) fp32)."""
    if r.device.type == "cpu":
        return blocked.linear_attention_blocked(r, k, v, w_log, u, s0, chunk=chunk)
    chunk = resolve_blocks("linear_attention", chunk=chunk)["chunk"]
    _check(r, k, v, w_log, u, s0, chunk)
    B, H, T, N = r.shape
    M = v.shape[3]
    o = torch.empty_like(v)  # v's layout where it is dense, else contiguous
    s_out = torch.empty((B, H, N, M), dtype=torch.float32, device=v.device)
    if not s_out.numel():  # B, H, N or M is 0: nothing to scan (N = 0 reads out 0)
        return o.zero_(), s_out
    nc = -(-T // chunk)
    # the kernel's fp32 scratch: each chunk's state (B*H, nc, N, M), then
    # each chunk's total decay (B*H, nc, N)
    scratch = torch.empty(B * H * nc * N * (M + 1), dtype=torch.float32, device=v.device)
    uf = None if u is None else u.float().contiguous()
    s0f = None if s0 is None else s0.float().contiguous()
    strides = (ctypes.c_longlong * 20)(
        *r.stride(), *k.stride(), *v.stride(), *w_log.stride(), *o.stride()
    )
    lib, fn = _kernel()
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = fn(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w_log.data_ptr(),
            uf.data_ptr() if uf is not None else None,
            s0f.data_ptr() if s0f is not None else None,
            o.data_ptr(), s_out.data_ptr(), scratch.data_ptr(), DTYPES[v.dtype],
            B, H, T, N, M, chunk, strides, stream,
        )
    build.check(lib, err, "linear_attention kernel launch")
    LAUNCHES["linear_attention"] += 1
    return o, s_out
