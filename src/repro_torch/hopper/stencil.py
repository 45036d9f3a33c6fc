"""Periodic stencil on Hopper: the wrapper of ``csrc/stencil.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/stencil.py``
``_stencil_kernel``. The wrapper keeps that kernel's accepted inputs: it
raises ``ValueError`` where ``stencil_pallas`` asserts (X not a multiple
of the x-block ``bx``, an x offset larger than ``bx``), for CPU and CUDA
tensors alike, though the CUDA kernel needs neither restriction. For CUDA
tensors it then checks the grid, allocates the output, launches the
kernel on PyTorch's current stream with the offsets (reduced to the
nearest equivalent shift of the periodic grid) and fp32 weights by value, raises on a launch error and adds one to
``dispatch.LAUNCHES["stencil"]``. For CPU tensors, and only for them, it
runs the plain version ``blocked.stencil_blocked``.

grid (X, Y, Z) contiguous, fp32 or bf16; offsets (P, 3) ints, P <= 64;
weights (P,) (host values, rounded to fp32); the output has the grid's
dtype.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import LAUNCHES, resolve_blocks

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_POINTS = 64  # csrc/stencil.cu MAX_POINTS: offsets travel in the launch's parameters

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("stencil")
        fn = lib.repro_stencil
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check_reference_limits(grid, offsets, bx):
    """Raise ``ValueError`` where the reference's ``stencil_pallas``
    asserts: X % bx != 0 or max |dx| > bx, with bx = min(bx, X)."""
    X = grid.shape[0]
    bx = min(resolve_blocks("stencil", bx=bx)["bx"], X)
    if X % bx:
        raise ValueError(f"stencil: X={X} is not a multiple of the x-block bx={bx}")
    dx = int(np.abs(offsets[:, 0]).max(initial=0))
    if dx > bx:
        raise ValueError(f"stencil: x offset {dx} exceeds the x-block bx={bx}")


def _offsets(offsets, weights):
    offsets = np.asarray(offsets)
    w = np.asarray(torch.as_tensor(weights, dtype=torch.float32).cpu())
    if offsets.ndim != 2 or offsets.shape[1] != 3 or w.shape != (offsets.shape[0],):
        raise ValueError(
            f"stencil: offsets (P, 3) and weights (P,), got {offsets.shape} and {w.shape}"
        )
    return offsets.astype(np.int64), w


def stencil_cuda(grid, offsets, weights, *, bx=None):
    """out (X, Y, Z) = sum_p w_p * grid shifted by -offsets[p], periodic,
    summed in fp32 in point order. Launches the Hopper kernel for CUDA
    tensors; runs ``blocked.stencil_blocked`` for CPU tensors."""
    offsets, w = _offsets(offsets, weights)
    if grid.dim() != 3:
        raise ValueError(f"stencil: grid must be (X, Y, Z), got {tuple(grid.shape)}")
    _check_reference_limits(grid, offsets, bx)
    if grid.device.type == "cpu":
        return blocked.stencil_blocked(grid, offsets, w, bx=bx)
    if not grid.is_cuda:
        raise ValueError(f"stencil: grid must lie on a CUDA device, got {grid.device}")
    if grid.dtype not in DTYPES:
        raise TypeError(f"stencil kernel takes a float32 or bfloat16 grid, got {grid.dtype}")
    if not grid.is_contiguous():
        raise ValueError("stencil kernel: grid must be contiguous")
    P = offsets.shape[0]
    if P > MAX_POINTS:
        raise ValueError(f"stencil kernel takes at most {MAX_POINTS} points, got {P}")
    out = torch.empty_like(grid)
    if grid.numel():
        X, Y, Z = grid.shape
        dims = np.array([X, Y, Z])
        red = offsets % dims
        red = np.where(2 * red > dims, red - dims, red).astype(np.int32)  # (-dim/2, dim/2]
        dx, dy, dz = (np.ascontiguousarray(red[:, a]) for a in range(3))
        lib, fn = _kernel()
        with torch.cuda.device(grid.device):
            stream = torch.cuda.current_stream(grid.device).cuda_stream
            err = fn(grid.data_ptr(), out.data_ptr(), DTYPES[grid.dtype], X, Y, Z, P,
                     dx.ctypes.data, dy.ctypes.data, dz.ctypes.data, w.ctypes.data, stream)
        build.check(lib, err, "stencil kernel launch")
        LAUNCHES["stencil"] += 1
    return out
