"""Periodic stencil on Hopper: the wrapper of ``csrc/stencil.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/stencil.py``
``_stencil_kernel``. The wrapper keeps that kernel's accepted inputs: it
raises ``ValueError`` where ``stencil_pallas`` asserts (X not a multiple
of the x-block ``bx``, an x offset larger than ``bx``), for CPU and CUDA
tensors alike, though the CUDA kernel needs neither restriction. For CUDA
tensors it then checks the grid, allocates the output, launches the
kernel on PyTorch's current stream with the offsets (reduced to the
nearest equivalent shift of the periodic grid), the fp32 weights and the
plan by value, raises on a launch error and adds one to
``dispatch.LAUNCHES["stencil"]``. For CPU tensors, and only for them, it
runs the plain version ``blocked.stencil_blocked``.

grid (X, Y, Z) contiguous, fp32 or bf16; offsets (P, 3) ints, P <= 64;
weights (P,) (host values, rounded to fp32); the output has the grid's
dtype.

The kernel's route and tiles come from ``plan`` (pure Python, so the CPU
tests reach it). ``march``: a block owns a (ty, tz) tile of the (y, z)
plane and marches along x, ``XR`` outputs a thread at a time, through a
window of ``XR + 2 rx`` planes in shared memory whose next planes load
while the current run is summed. ``direct``: one thread per (y, z)
column, each point read from L2, for offsets whose halo outgrows the
window.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import sm_count
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, PlanCandidate, lookup_plan, model_pick,
                                        resolve_blocks)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_POINTS = 64  # csrc/stencil.cu MAX_POINTS: offsets travel in the launch's parameters

# csrc/stencil.cu's march kernel
XR = 16               # x outputs a thread sums at a time (a run)
THREADS = 256         # threads a block, at most
CELLS_PER_THREAD = 2  # tile-plus-halo cells a thread stages
PITCH = CELLS_PER_THREAD * THREADS  # floats a window plane holds
MAX_SMEM = 100 * 1024  # the window's shared memory, at most
BLOCKS_PER_SM = 8     # the grid's target: x is cut until the card has this many blocks an SM

_fn = None


class Plan(NamedTuple):
    route: str   # "march" or "direct"
    ty: int      # march: the (y, z) tile
    tz: int
    runs: int    # march: runs of XR planes a block marches
    grid: int    # blocks
    smem: int    # bytes of shared memory a block


def _reach(red):
    red = np.asarray(red, dtype=np.int64).reshape(-1, 3)
    return tuple(int(np.abs(red[:, a]).max(initial=0)) for a in range(3))


def plan_args(shape, red, sms: int) -> tuple:
    """``plan``'s arguments as the hashable key a plan override takes."""
    red = np.asarray(red, dtype=np.int64).reshape(-1, 3)
    return (tuple(int(d) for d in shape), tuple(map(tuple, red.tolist())), int(sms))


def candidates(shape, red, sms: int, *, smem_budget: int = MAX_SMEM) -> list[PlanCandidate]:
    """Every plan ``plan``'s model weighs for a grid of ``shape`` (X, Y, Z)
    and offsets ``red`` (P, 3), reduced to (-dim/2, dim/2]: ``direct``,
    and ``march`` with each run length x can be cut into (runs of ``XR``
    planes a block). ``march`` is pruned where the tile plus its halo
    passes ``CELLS_PER_THREAD`` cells a thread or the window of ``XR + 2
    rx`` planes passes ``smem_budget`` (at most ``MAX_SMEM``). The model:
    a cut of x into s parts costs s (each re-reads 2 rx halo planes), and
    each block the grid falls short of ``BLOCKS_PER_SM`` an SM costs more
    than every cut (nruns + 1); a run length takes its best s. ``direct``
    reads each point from L2 and costs more than any march."""
    X, Y, Z = shape
    rx, ry, rz = _reach(red)
    tz = min(Z, 32)
    ty = THREADS // tz
    cells = (ty + 2 * ry) * (tz + 2 * rz)
    smem = 4 * PITCH * (XR + 2 * rx)
    nruns = -(-X // XR)
    tiles = -(-Y // ty) * -(-Z // tz)
    target = BLOCKS_PER_SM * sms
    miss = nruns + 1  # a block short of the target outweighs every cut
    why = ("cells a thread" if cells > CELLS_PER_THREAD * ty * tz
           else "shared memory" if smem > min(MAX_SMEM, smem_budget) else "")
    best_s = min(nruns, max(1, -(-target // tiles)))
    out = []
    spans = {}  # run length -> the cuts of x that give it
    for s_ in range(1, nruns + 1):
        spans.setdefault(-(-nruns // s_), []).append(s_)
    for runs, cuts in spans.items():
        s_ = min(max(best_s, cuts[0]), cuts[-1])
        cost = max(0, target - tiles * s_) * miss + s_
        pl = Plan("march", ty, tz, runs, tiles * -(-nruns // runs), smem)
        out.append(PlanCandidate(pl, {"route": 0, "runs": runs},
                                 float("inf") if why else float(cost),
                                 (float("inf"),) if why else (float(cost),), smem, THREADS, 0,
                                 why))
    direct = float(target * miss + nruns + 1)
    out.append(PlanCandidate(
        Plan("direct", 0, 0, 0, -(-(Y * Z) // THREADS) * min(X, 65535), 0),
        {"route": 1, "runs": 0}, direct, (direct,), 0, THREADS, 0))
    return out


@functools.lru_cache(maxsize=256)
def _model(shape: tuple, red: tuple, sms: int) -> Plan:
    return model_pick(candidates(shape, red, sms)).plan


def plan(shape, red, sms: int) -> Plan:
    """Route and tiles for a grid of ``shape`` (X, Y, Z) and offsets ``red``
    (P, 3), already reduced to (-dim/2, dim/2]: a plan override at exactly
    these arguments (``dispatch.lookup_plan("stencil", plan_args(...))``),
    else ``candidates``' least-cost entry. ``march`` where the tile plus
    its halo stays within ``CELLS_PER_THREAD`` cells a thread and the
    window of ``XR + 2 rx`` planes within ``MAX_SMEM``; else ``direct``.
    Lanes run along z (tz = min(Z, 32)), or along y when Z < 32, so a 2-D
    grid (Z = 1) keeps 256 lanes along y. x is cut into ``runs`` of ``XR``
    planes a block until the grid has about ``BLOCKS_PER_SM`` blocks an
    SM."""
    args = plan_args(shape, red, sms)
    return lookup_plan("stencil", args) or _model(*args)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("stencil")
        fn = lib.repro_stencil
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, ptr, ptr, ptr,
                       i32, i32, i32, i32, i32, ptr]
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


def reduce_offsets(offsets, shape):
    """Each offset as the equivalent shift of the periodic grid in
    (-dim/2, dim/2] of its axis (int32 (P, 3))."""
    dims = np.asarray(shape)
    red = np.asarray(offsets) % dims
    return np.where(2 * red > dims, red - dims, red).astype(np.int32)


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
        red = reduce_offsets(offsets, grid.shape)
        q = plan(grid.shape, red, sm_count(grid.device.index))
        dx, dy, dz = (np.ascontiguousarray(red[:, a]) for a in range(3))
        lib, fn = _kernel()
        with torch.cuda.device(grid.device):
            stream = torch.cuda.current_stream(grid.device).cuda_stream
            err = fn(grid.data_ptr(), out.data_ptr(), DTYPES[grid.dtype], X, Y, Z, P,
                     dx.ctypes.data, dy.ctypes.data, dz.ctypes.data, w.ctypes.data,
                     int(q.route == "direct"), q.ty, q.tz, q.runs, q.grid, stream)
        build.check(lib, err, "stencil kernel launch")
        LAUNCHES["stencil"] += 1
    return out

