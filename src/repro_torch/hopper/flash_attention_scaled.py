"""Scaled FA-2 forward on Hopper: the wrapper of ``csrc/flash_attention_scaled.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/flash_attention.py``
``_fa_kernel(scaled=True)``. ``flash_attention_scaled_kernel`` takes
quantized operands (q/k/v values in one compute dtype, one fp32 scale per
(b, h, s) row); for CUDA tensors it checks them, allocates the fp32
outputs, launches the kernel on PyTorch's current stream, raises on a
launch error and adds one to ``dispatch.LAUNCHES["flash_attention_scaled"]``.
For CPU tensors, and only for them, it runs the plain version
``blocked.flash_attention_scaled_values_blocked``.
``flash_attention_scaled_cuda`` is the op-level form: it quantizes q/k/v
per row over D (``core/precision.py``, outside the kernel, as the
reference quantizes outside its Pallas body), then calls the kernel.

Values are fp32, bf16, fp8 e4m3 or fp8 e5m2 (one dtype for q, k and v),
unit-stride in the head dim; the kernel takes element strides for the
values and the scales alike. The output is fp32, contiguous. Inputs the
kernel does not take raise; nothing is copied to make them fit. ``route``
names the source's kernel a value type takes: ``wgmma`` (bf16 and fp8,
widened to bf16 in shared memory) or ``ffma`` (fp32 on the CUDA cores).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core import precision as prec
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import LAUNCHES
from repro_torch.hopper.flash_attention import HEAD_DIMS  # compiled in both kernels

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
          torch.float8_e5m2: 3}

_fn = None


def route(dtype: torch.dtype) -> str:
    """The kernel of ``csrc/flash_attention_scaled.cu`` that values of
    ``dtype`` take: ``wgmma`` for bf16 and fp8, ``ffma`` for fp32."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention_scaled: no route for {dtype}")
    return "ffma" if dtype == torch.float32 else "wgmma"


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("flash_attention_scaled")
        fn = lib.repro_fa_scaled_fwd
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       i32, i32, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                       i32, i32, i32, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(qq, kq, vq, q_scale, k_scale, v_scale):
    tensors = (qq, kq, vq, q_scale, k_scale, v_scale)
    if not (qq.is_cuda and all(x.device == qq.device for x in tensors)):
        raise ValueError(
            "flash_attention_scaled: values and scales must share one CUDA device, got "
            + "/".join(str(x.device) for x in tensors)
        )
    if qq.dtype not in DTYPES or kq.dtype != qq.dtype or vq.dtype != qq.dtype:
        raise TypeError(
            f"flash_attention_scaled kernel takes float32, bfloat16, float8_e4m3fn "
            f"or float8_e5m2 q/k/v of one dtype, got {qq.dtype}/{kq.dtype}/{vq.dtype}"
        )
    if any(s.dtype != torch.float32 for s in (q_scale, k_scale, v_scale)):
        raise TypeError("flash_attention_scaled kernel takes float32 scales")
    if qq.dim() != 4 or kq.dim() != 4 or kq.shape != vq.shape:
        raise ValueError(
            f"flash_attention_scaled: q (B,H,Sq,D), k/v (B,K,Sk,D), got "
            f"{tuple(qq.shape)} {tuple(kq.shape)} {tuple(vq.shape)}"
        )
    B, H, _, D = qq.shape
    if kq.shape[0] != B or kq.shape[3] != D or H % kq.shape[1]:
        raise ValueError(
            f"flash_attention_scaled: k/v {tuple(kq.shape)} do not fit q {tuple(qq.shape)}"
        )
    for name, x, s in (("q", qq, q_scale), ("k", kq, k_scale), ("v", vq, v_scale)):
        if tuple(s.shape) != (*x.shape[:3], 1):
            raise ValueError(
                f"flash_attention_scaled: {name}_scale must be {(*x.shape[:3], 1)}, "
                f"got {tuple(s.shape)}"
            )
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_scaled kernel: head dim {D} not in {HEAD_DIMS}")
    for name, x in (("q", qq), ("k", kq), ("v", vq)):
        if x.stride(3) != 1:
            raise ValueError(
                f"flash_attention_scaled kernel: {name} must be unit-stride in its "
                f"head dim, got strides {x.stride()}"
            )
        # the tensor-core kernel moves rows in 8-value chunks
        align = 8 * x.element_size()
        if x.dtype != torch.float32 and (
            x.data_ptr() % align or any(s % 8 for s in x.stride()[:3])
        ):
            raise ValueError(
                f"flash_attention_scaled {x.dtype} kernel: {name} needs a {align}-byte "
                f"aligned start and (b, h, s) strides that are multiples of 8, got "
                f"strides {x.stride()}"
            )


def flash_attention_scaled_kernel(qq, kq, vq, q_scale, k_scale, v_scale, *,
                                  causal=True, window=0, q_offset=0, scale=None,
                                  return_lse=False, **blocks):
    """FA-2 forward on quantized operands: q (B, H, Sq, D), k/v (B, K, Sk, D)
    values with fp32 per-row scales (B, H|K, S, 1); fp32 out. Launches the
    Hopper kernel for CUDA tensors; runs
    ``blocked.flash_attention_scaled_values_blocked`` for CPU tensors
    (``blocks`` — the plain form's ``bq``/``bk`` — reach only that form).
    Returns o, and (o, lse) with ``return_lse``."""
    if qq.device.type == "cpu":
        return blocked.flash_attention_scaled_values_blocked(
            qq, kq, vq, q_scale, k_scale, v_scale, causal=causal, window=window,
            q_offset=q_offset, scale=scale, return_lse=return_lse, **blocks,
        )
    _check(qq, kq, vq, q_scale, k_scale, v_scale)
    B, H, Sq, D = qq.shape
    K, Sk = kq.shape[1], kq.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    o = torch.empty((B, H, Sq, D), dtype=torch.float32, device=qq.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=qq.device)
           if return_lse else None)
    if Sq:
        lib, fn = _kernel()
        strides = (ctypes.c_longlong * 21)(
            *(s for x in (qq, kq, vq, o, q_scale, k_scale, v_scale) for s in x.stride()[:3])
        )
        with torch.cuda.device(qq.device):
            stream = torch.cuda.current_stream(qq.device).cuda_stream
            err = fn(
                qq.data_ptr(), kq.data_ptr(), vq.data_ptr(), q_scale.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr(), o.data_ptr(),
                lse.data_ptr() if lse is not None else None,
                DTYPES[qq.dtype], B, H, K, Sq, Sk, D, strides, float(scale),
                int(bool(causal)), int(window), int(q_offset), stream,
            )
        build.check(lib, err, "flash_attention_scaled kernel launch")
        LAUNCHES["flash_attention_scaled"] += 1
    return (o, lse) if return_lse else o


def flash_attention_scaled_cuda(q, k, v, precision, *, causal=True, window=0,
                                q_offset=0, scale=None, return_lse=False, **blocks):
    """``ops.flash_attention(..., precision=)`` on the kernel: q/k/v
    quantized per row over D to ``precision``'s compute dtype, then
    ``flash_attention_scaled_kernel``; fp32 out. CPU tensors run
    ``blocked.flash_attention_scaled_blocked``."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
              return_lse=return_lse)
    if q.device.type == "cpu":
        return blocked.flash_attention_scaled_blocked(q, k, v, precision, **kw, **blocks)
    p = prec.resolve(precision)
    (qq, qs), (kq, ks), (vq, vs) = (
        prec.quantize_blockwise(x, p, axis=-1, block=x.shape[-1]) for x in (q, k, v)
    )
    return flash_attention_scaled_kernel(qq, kq, vq, qs, ks, vs, **kw)
