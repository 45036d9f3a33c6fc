"""ELL sparse-dense product on Hopper: the wrapper of ``csrc/spmm.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/spmm.py``
``_ell_kernel``. For CUDA tensors the wrapper checks its inputs,
allocates the output, launches the kernel on PyTorch's current stream,
raises on a launch error and adds one to ``dispatch.LAUNCHES["spmm"]``.
For CPU tensors, and only for them, it runs the plain version
``blocked.spmm_blocked``.

values (R, L) fp32 or bf16 and cols (R, L) int32 are ELL rows; dense (C, F)
fp32 or bf16; the output (R, F) has dense's dtype, summed in fp32. Rows
must be unit-stride (any row stride). Column indices are not checked here:
``core.sparse.EllMatrix`` checks them once, at construction; a launch does
not synchronise to check them again.
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
        lib = build.load("spmm")
        fn = lib.repro_ell_spmm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(values, cols, dense):
    if not (values.is_cuda and cols.device == values.device
            and dense.device == values.device):
        raise ValueError(
            f"spmm: values/cols/dense must share one CUDA device, got "
            f"{values.device}/{cols.device}/{dense.device}"
        )
    if values.dtype not in DTYPES or dense.dtype not in DTYPES:
        raise TypeError(
            f"spmm kernel takes float32 or bfloat16 values and dense, got "
            f"{values.dtype}/{dense.dtype}"
        )
    if cols.dtype != torch.int32:
        raise TypeError(f"spmm kernel takes int32 cols, got {cols.dtype}")
    if values.dim() != 2 or cols.shape != values.shape or dense.dim() != 2:
        raise ValueError(
            f"spmm: values/cols (R, L) and dense (C, F), got "
            f"{tuple(values.shape)} {tuple(cols.shape)} {tuple(dense.shape)}"
        )
    if values.numel() and dense.shape[0] == 0:
        raise ValueError("spmm: dense has no rows for the columns to name")
    for name, x in (("values", values), ("cols", cols), ("dense", dense)):
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(
                f"spmm kernel: {name} must be unit-stride along its rows, got "
                f"strides {x.stride()}"
            )


def spmm_cuda(values, cols, dense, **blocks):
    """out (R, F) = sum_j values[:, j] * dense[cols[:, j]]. Launches the
    Hopper kernel for CUDA tensors; runs ``blocked.spmm_blocked`` for CPU
    tensors (``blocks`` — the plain form's ``bm`` — reach only that
    form)."""
    if values.device.type == "cpu":
        return blocked.spmm_blocked(values, cols, dense, **blocks)
    _check(values, cols, dense)
    R, L = values.shape
    F = dense.shape[1]
    out = torch.empty((R, F), dtype=dense.dtype, device=dense.device)
    if R and F:
        lib, fn = _kernel()
        with torch.cuda.device(values.device):
            stream = torch.cuda.current_stream(values.device).cuda_stream
            err = fn(values.data_ptr(), cols.data_ptr(), dense.data_ptr(),
                     out.data_ptr(), DTYPES[values.dtype], DTYPES[dense.dtype],
                     R, L, F, values.stride(0), cols.stride(0), dense.stride(0),
                     out.stride(0), stream)
        build.check(lib, err, "spmm kernel launch")
        LAUNCHES["spmm"] += 1
    return out
