"""Tiled GEMM on Hopper: the wrapper of ``csrc/gemm.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/gemm.py``
``_gemm_kernel``. For CUDA tensors the wrapper checks its inputs,
allocates the output, launches the kernel on PyTorch's current stream,
raises on a launch error and adds one to ``dispatch.LAUNCHES["gemm"]``.
For CPU tensors, and only for them, it runs the plain version
``blocked.gemm_blocked``.

A (M, K) and B (K, N) share one dtype, fp32 (CUDA-core FFMA) or bf16
(tensor cores); the output is ``out_dtype`` (fp32 or bf16, default
``a.dtype``), accumulated in fp32. Rows must be unit-stride; any row
stride is taken, so row slices go in without a copy. Ragged M, N, K are
masked in the kernel. Inputs it does not take raise; nothing is copied to
make them fit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import LAUNCHES

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("gemm")
        fn = lib.repro_gemm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i64, i64, i64, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(a, b, out_dtype):
    if not (a.is_cuda and b.device == a.device):
        raise ValueError(
            f"gemm: a and b must share one CUDA device, got {a.device}/{b.device}"
        )
    if a.dtype not in DTYPES or b.dtype != a.dtype:
        raise TypeError(
            f"gemm kernel takes float32 or bfloat16 a/b of one dtype, got "
            f"{a.dtype}/{b.dtype}"
        )
    if out_dtype not in DTYPES:
        raise TypeError(f"gemm kernel writes float32 or bfloat16, not {out_dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(
            f"gemm: a (M, K) and b (K, N), got {tuple(a.shape)} {tuple(b.shape)}"
        )
    for name, x in (("a", a), ("b", b)):
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(
                f"gemm kernel: {name} must be unit-stride along its rows, got "
                f"strides {x.stride()}"
            )


def gemm_cuda(a, b, *, out_dtype=None, accum_dtype=torch.float32, **blocks):
    """C = A @ B with fp32 accumulation. Launches the Hopper kernel for
    CUDA tensors; runs ``blocked.gemm_blocked`` for CPU tensors
    (``blocks`` — the plain form's ``bm``/``bk``/``bn`` — reach only that
    form). Accumulators other than fp32 raise ``NotImplementedError``."""
    if accum_dtype != torch.float32:
        raise NotImplementedError(
            f"gemm: accum_dtype={accum_dtype} is not ported; the kernel sums in float32"
        )
    if a.device.type == "cpu":
        return blocked.gemm_blocked(a, b, out_dtype=out_dtype, **blocks)
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype)
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M and N:
        lib, fn = _kernel()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), DTYPES[a.dtype],
                     DTYPES[out_dtype], M, N, K, a.stride(0), b.stride(0),
                     c.stride(0), stream)
        build.check(lib, err, "gemm kernel launch")
        LAUNCHES["gemm"] += 1
    return c
