"""Sparse x sparse product by index intersection on Hopper: the wrapper of
``csrc/spmspm.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/spmspm.py``
``_spmspm_kernel``. For CUDA tensors the wrapper checks its inputs,
allocates the output, launches the kernel on PyTorch's current stream,
raises on a launch error and adds one to ``dispatch.LAUNCHES["spmspm"]``.
For CPU tensors, and only for them, it runs the plain version
``blocked.spmspm_blocked``.

a_values/a_cols (R, La) are A's ELL rows, b_values/b_rows (C, Lb) B's ELL
columns, over a contraction dim K (``contraction_dim``); values fp32 or
bf16, indices int32, rows unit-stride (any row stride). The output (R, C)
is fp32. An index outside [0, K) contributes nothing. The kernel builds a
copy of B indexed by k (the wrapper allocates its scratch, ``plan``) and
then sums each output row on chip from the lists of A's entries, so its
work follows the nonzeros (see the source); the output's columns go in
tiles of at most 4096. Its four launches count as one.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, KernelStreams, PlanCandidate, StreamOperand,
                                        lookup_plan, model_pick, register_streams)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
CT_MAX = 4096  # csrc/spmspm.cu CT_MAX: output columns a warp sums in shared memory
WARPS = 4  # csrc/spmspm.cu WARPS: (row, tile) items of a CTA
MAX_TILES = 64  # the tile counts ``candidates`` weighs

_fn = None


@register_streams("spmspm", kernel="spmspm")
def streams(structs, policy=None, **_):
    """The kernel's streams for ``ops.spmspm``: a_values (R, La) and
    b_values (C, Lb) values, a_cols and b_rows int32 indices, summed in
    fp32; the (R, C) fp32 output."""
    (av, avd), ac, (bv, bvd), br = structs[:4]
    return KernelStreams(
        "spmspm", (StreamOperand("value", av, avd), StreamOperand("index", *ac),
                   StreamOperand("value", bv, bvd), StreamOperand("index", *br)),
        torch.float32, (StreamOperand("value", (av[0], bv[0]), torch.float32),))


class Plan(NamedTuple):
    ct: int  # output columns of a tile (a multiple of 4)
    tiles: int  # ceil(C / ct)
    smem: int  # the row kernel's shared memory per CTA, bytes
    grid: int  # the row kernel's CTAs: ceil(R * tiles / WARPS)
    scratch: int  # bytes: tiles * K + 1 counts and offsets (each to 4), C * Lb (n, b) pairs


def _plan(R: int, C: int, Lb: int, K: int, ct: int) -> Plan:
    tiles = -(-C // ct)
    offsets = -(-(tiles * K + 1) // 4) * 4
    return Plan(ct, tiles, 4 * WARPS * ct, -(-R * tiles // WARPS), 8 * offsets + 8 * C * Lb)


def candidates(R: int, C: int, Lb: int, K: int) -> list[PlanCandidate]:
    """Every column tile ``plan``'s model weighs for A (R rows) times B (C
    columns of Lb entries) over K: C cut evenly into t tiles (each rounded
    up to 4 columns), t from one below the fewest that fit ``CT_MAX`` to
    ``MAX_TILES`` more, or until a tile holds 4 columns; a tile wider than
    ``CT_MAX`` is pruned (a warp's shared memory). The model: each (row, tile) item walks its row
    of A's entries, and each tile scans its K offsets, so the cost is tiles
    x (R + K); ties go to the wider tile. The pick: one tile where C fits
    in ``CT_MAX``, else the fewest tiles of even width."""
    out, seen = [], set()
    fewest = -(-C // CT_MAX)
    for t in range(max(1, fewest - 1), min(-(-C // 4), fewest + MAX_TILES - 1) + 1):
        ct = (-(-C // t) + 3) // 4 * 4
        if ct in seen:
            continue
        seen.add(ct)
        pl = _plan(R, C, Lb, K, ct)
        why = "shared memory" if ct > CT_MAX else ""
        cost = float("inf") if why else float(pl.tiles * (R + K))
        out.append(PlanCandidate(pl, {"ct": ct}, cost, (cost, -ct), pl.smem, 32 * WARPS, 0, why))
    return out


@functools.lru_cache(maxsize=256)
def _model(R: int, C: int, Lb: int, K: int) -> Plan:
    return model_pick(candidates(R, C, Lb, K)).plan


def plan(R: int, C: int, Lb: int, K: int) -> Plan:
    """The output's column tiles and the scratch for A (R rows) times B (C
    columns of Lb entries) over K (csrc/spmspm.cu
    ``repro_spmspm_scratch_bytes``): a plan override at exactly these
    arguments (``dispatch.lookup_plan("spmspm", ...)``), else
    ``candidates``' least-cost entry: one tile where C fits in ``CT_MAX``,
    else the fewest tiles of even width, rounded up to 4."""
    return lookup_plan("spmspm", (R, C, Lb, K)) or _model(R, C, Lb, K)


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("spmspm")
        fn = lib.repro_spmspm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32,
                       i32, i64, i64, i64, i64, i64, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(a_values, a_cols, b_values, b_rows, contraction_dim):
    dev = a_values.device
    if not (a_values.is_cuda and all(x.device == dev for x in (a_cols, b_values, b_rows))):
        raise ValueError(
            f"spmspm: a_values/a_cols/b_values/b_rows must share one CUDA device, got "
            f"{a_values.device}/{a_cols.device}/{b_values.device}/{b_rows.device}"
        )
    if a_values.dtype not in DTYPES or b_values.dtype not in DTYPES:
        raise TypeError(
            f"spmspm kernel takes float32 or bfloat16 values, got "
            f"{a_values.dtype}/{b_values.dtype}"
        )
    if a_cols.dtype != torch.int32 or b_rows.dtype != torch.int32:
        raise TypeError(
            f"spmspm kernel takes int32 indices, got {a_cols.dtype}/{b_rows.dtype}"
        )
    if (a_values.dim() != 2 or a_cols.shape != a_values.shape
            or b_values.dim() != 2 or b_rows.shape != b_values.shape):
        raise ValueError(
            f"spmspm: A (R, La) and B (C, Lb) value/index pairs, got "
            f"{tuple(a_values.shape)}/{tuple(a_cols.shape)} and "
            f"{tuple(b_values.shape)}/{tuple(b_rows.shape)}"
        )
    if contraction_dim < 1:
        raise ValueError(f"spmspm: contraction_dim must be >= 1, got {contraction_dim}")
    for name, x in (("a_values", a_values), ("a_cols", a_cols),
                    ("b_values", b_values), ("b_rows", b_rows)):
        if x.shape[1] > 1 and x.stride(1) != 1:
            raise ValueError(
                f"spmspm kernel: {name} must be unit-stride along its rows, got "
                f"strides {x.stride()}"
            )


def spmspm_cuda(a_values, a_cols, b_values, b_rows, contraction_dim, **blocks):
    """fp32 out (R, C), out[m, n] = sum over a_cols[m, i] == b_rows[n, j]
    of a_values[m, i] * b_values[n, j]. Launches the Hopper kernel for CUDA
    tensors; runs ``blocked.spmspm_blocked`` for CPU tensors (``blocks`` —
    the plain form's ``bm``/``bn`` — reach only that form)."""
    if a_values.device.type == "cpu":
        return blocked.spmspm_blocked(a_values, a_cols, b_values, b_rows,
                                      contraction_dim, **blocks)
    _check(a_values, a_cols, b_values, b_rows, contraction_dim)
    R, La = a_values.shape
    C, Lb = b_values.shape
    out = torch.empty((R, C), dtype=torch.float32, device=a_values.device)
    if R and C:
        K = int(contraction_dim)
        pl = plan(R, C, Lb, K)
        scratch = torch.empty(pl.scratch, dtype=torch.uint8, device=a_values.device)
        lib, fn = _kernel()
        with torch.cuda.device(a_values.device):
            stream = torch.cuda.current_stream(a_values.device).cuda_stream
            err = fn(a_values.data_ptr(), a_cols.data_ptr(), b_values.data_ptr(),
                     b_rows.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     DTYPES[a_values.dtype], DTYPES[b_values.dtype], R, C, La, Lb, K, pl.ct,
                     a_values.stride(0), a_cols.stride(0), b_values.stride(0),
                     b_rows.stride(0), out.stride(0), stream)
        build.check(lib, err, "spmspm kernel launch")
        LAUNCHES["spmspm"] += 1
    return out
