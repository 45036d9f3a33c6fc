"""Per-K-block scaled GEMM on Hopper: the wrapper of ``csrc/gemm_scaled.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/gemm.py``
``_gemm_scaled_kernel``. ``gemm_scaled_kernel`` takes quantized operands
(values in one compute dtype, fp32 per-K-block scales); for CUDA tensors
it checks them, allocates the output, launches the kernel on PyTorch's
current stream, raises on a launch error and adds one to
``dispatch.LAUNCHES["gemm_scaled"]``. For CPU tensors, and only for them,
it runs the plain version ``blocked.gemm_scaled_values_blocked``.
``gemm_scaled_cuda`` is the op-level form: it quantizes a and b per
K-block of ``bk`` (``core/precision.py``, outside the kernel, as the
reference quantizes outside its Pallas body), then calls the kernel.

``bk`` is semantic: it is the quantization block, resolved as
``dispatch.resolve_blocks("gemm")`` gives it and capped at K; the kernel
takes any ``bk >= 1``. Values are fp32, bf16, fp8 e4m3 or fp8 e5m2 (one
dtype for both operands), unit-stride along their rows; scales are fp32
with any strides. The output is fp32 (default) or bf16. Inputs the kernel
does not take raise; nothing is copied to make them fit.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import precision as prec
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import LAUNCHES, resolve_blocks

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
          torch.float8_e5m2: 3}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("gemm_scaled")
        fn = lib.repro_gemm_scaled
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, i64, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(aq, bq, a_scale, b_scale, bk, out_dtype):
    tensors = (aq, bq, a_scale, b_scale)
    if not (aq.is_cuda and all(x.device == aq.device for x in tensors)):
        raise ValueError(
            "gemm_scaled: values and scales must share one CUDA device, got "
            + "/".join(str(x.device) for x in tensors)
        )
    if aq.dtype not in DTYPES or bq.dtype != aq.dtype:
        raise TypeError(
            f"gemm_scaled kernel takes float32, bfloat16, float8_e4m3fn or "
            f"float8_e5m2 values of one dtype, got {aq.dtype}/{bq.dtype}"
        )
    if a_scale.dtype != torch.float32 or b_scale.dtype != torch.float32:
        raise TypeError(
            f"gemm_scaled kernel takes float32 scales, got {a_scale.dtype}/{b_scale.dtype}"
        )
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"gemm_scaled kernel writes float32 or bfloat16, not {out_dtype}")
    if aq.dim() != 2 or bq.dim() != 2 or aq.shape[1] != bq.shape[0]:
        raise ValueError(
            f"gemm_scaled: a (M, K) and b (K, N), got {tuple(aq.shape)} {tuple(bq.shape)}"
        )
    M, K = aq.shape
    N = bq.shape[1]
    if bk < 1:
        raise ValueError(f"gemm_scaled: bk must be >= 1, got {bk}")
    nk = math.ceil(K / bk)
    if tuple(a_scale.shape) != (M, nk) or tuple(b_scale.shape) != (nk, N):
        raise ValueError(
            f"gemm_scaled: scales must be (M, ceil(K/bk)) = {(M, nk)} and "
            f"(ceil(K/bk), N) = {(nk, N)}, got {tuple(a_scale.shape)} {tuple(b_scale.shape)}"
        )
    for name, x in (("a", aq), ("b", bq)):
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(
                f"gemm_scaled kernel: {name} must be unit-stride along its rows, "
                f"got strides {x.stride()}"
            )


def gemm_scaled_kernel(aq, bq, a_scale, b_scale, *, bk, out_dtype=torch.float32):
    """C (M, N) = sum over K-blocks kb of (aq . bq)_kb * (a_scale[:, kb] (x)
    b_scale[kb, :]), in fp32. aq (M, K), bq (K, N) quantized values;
    a_scale (M, nk), b_scale (nk, N) fp32, nk = ceil(K / bk). Launches the
    Hopper kernel for CUDA tensors; runs
    ``blocked.gemm_scaled_values_blocked`` for CPU tensors."""
    if aq.device.type == "cpu":
        return blocked.gemm_scaled_values_blocked(aq, bq, a_scale, b_scale, bk=bk,
                                                  out_dtype=out_dtype)
    _check(aq, bq, a_scale, b_scale, bk, out_dtype)
    M, K = aq.shape
    N = bq.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=aq.device)
    if M and N:
        lib, fn = _kernel()
        with torch.cuda.device(aq.device):
            stream = torch.cuda.current_stream(aq.device).cuda_stream
            err = fn(aq.data_ptr(), bq.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(),
                     c.data_ptr(), DTYPES[aq.dtype], OUT_DTYPES[out_dtype], M, N, K, bk,
                     aq.stride(0), bq.stride(0), c.stride(0), *a_scale.stride(),
                     *b_scale.stride(), stream)
        build.check(lib, err, "gemm_scaled kernel launch")
        LAUNCHES["gemm_scaled"] += 1
    return c


def gemm_scaled_cuda(a, b, precision, *, out_dtype=None, accum_dtype=torch.float32,
                     bm=None, bk=None, bn=None):
    """``ops.gemm(..., precision=)`` on the kernel: a (M, K) and b (K, N)
    quantized per K-block of ``bk`` (at most K) to ``precision``'s compute
    dtype, then ``gemm_scaled_kernel``; the output defaults to fp32. CPU
    tensors run ``blocked.gemm_scaled_blocked``. Accumulators other than
    fp32 raise ``NotImplementedError``."""
    if accum_dtype != torch.float32:
        raise NotImplementedError(
            f"gemm: accum_dtype={accum_dtype} is not ported; the kernel sums in float32"
        )
    if a.device.type == "cpu":
        return blocked.gemm_scaled_blocked(a, b, precision, out_dtype=out_dtype,
                                           bm=bm, bk=bk, bn=bn)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm: a (M, K) and b (K, N), got {tuple(a.shape)} {tuple(b.shape)}")
    p = prec.resolve(precision)
    bk = min(resolve_blocks("gemm", bm=bm, bk=bk, bn=bn)["bk"], a.shape[1])
    aq, a_scale = prec.quantize_blockwise(a, p, axis=1, block=bk)
    bq, b_scale = prec.quantize_blockwise(b, p, axis=0, block=bk)
    return gemm_scaled_kernel(aq, bq, a_scale, b_scale, bk=bk,
                              out_dtype=out_dtype or torch.float32)
