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

The kernel's tiles come from ``plan`` (pure Python, so the CPU tests
reach it): a thread owns a (row, 16-byte vector) pair, and F goes in
slabs whose slice of dense fits the L2, the grid slab-major.
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

# csrc/spmm.cu's tiles and the card they are planned for
THREADS = 256             # a block's threads, at most
MAX_LANES = 64            # threads a row, at most
L2_SLAB_BYTES = 32 << 20  # dense's slice a slab may hold (of the H100's 50 MB L2)
LINE_BYTES = 128          # slabs of several go in whole lines of this many bytes
BATCHES = (8, 16)         # slots a thread loads together: 16 where a row has as many
L2_MISS_COST = 4          # the plan model: a gather from HBM against one from the L2
BATCH_COST = 1.05         # the plan model: the batch the rule does not pick

_fn = None


@register_streams("spmm", kernel="spmm")
def streams(structs, policy=None, **_):
    """The kernel's streams for ``ops.spmm``: values (R, L) and dense
    (C, F) values, cols (R, L) int32 indices, summed in fp32; the (R, F)
    output in dense's dtype."""
    (v_shape, v_dtype), (c_shape, c_dtype), (d_shape, d_dtype) = structs[:3]
    return KernelStreams(
        "spmm", (StreamOperand("value", v_shape, v_dtype), StreamOperand("index", c_shape, c_dtype),
                 StreamOperand("value", d_shape, d_dtype)),
        torch.float32, (StreamOperand("value", (v_shape[0], d_shape[1]), d_dtype),))


class Plan(NamedTuple):
    vec: int         # elements a load: 1, or 16 bytes of dense
    batch: int       # slots a thread loads together (8 or 16)
    slab: int        # columns a block covers
    lanes: int       # threads a row
    rows: int        # rows a block covers
    row_blocks: int  # blocks along R; the grid is slab-major
    grid: int        # blocks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def candidates(R: int, L: int, C: int, F: int, esize: int, vec_ok: bool) -> list[PlanCandidate]:
    """Every plan ``plan``'s model weighs for R ELL rows of L slots times
    dense (C, F) of ``esize``-byte elements (``vec_ok``: F, dense's row
    stride and its pointer allow 16-byte loads): F whole in one slab, or
    slabs of whole 128-byte lines, each with 8 or 16 slots a load batch.
    A slab wider than ``MAX_LANES`` vectors is pruned (a block's
    ``THREADS``). The model counts bytes: each slab reads the rows' values
    and indices again (at dense's element size; a row costs one slot at
    least), the gathers read R L F
    elements, ``L2_MISS_COST`` times over where a slab's slice of dense
    passes ``L2_SLAB_BYTES`` (a one-line slab always counts as fitting);
    the batch other than the rule's (16 where L >= 16, else 8, the faster
    on an H100) costs ``BATCH_COST`` times more. Ties go to the narrower
    slab. The pick: F in one slab where it fits, else the fewest slabs of
    whole lines that do (5 slabs of 32 columns at ogbn-arxiv's size)."""
    vec = 16 // esize if vec_ok else 1
    line = LINE_BYTES // esize  # a multiple of vec, and MAX_LANES * vec of it
    fit = max(line, L2_SLAB_BYTES // max(1, C * esize) // line * line)
    whole = _cdiv(F, vec) * vec
    widths = sorted({whole, *(line * j for j in range(1, MAX_LANES * vec // line + 1))})
    rule_batch = BATCHES[1] if L >= BATCHES[1] else BATCHES[0]
    out = []
    for slab in widths:
        lanes = slab // vec
        rows = max(1, THREADS // lanes)
        row_blocks = _cdiv(R, rows)
        slabs = _cdiv(F, slab)
        for batch in BATCHES:
            plan = Plan(vec, batch, slab, lanes, rows, row_blocks, row_blocks * slabs)
            knobs = {"slab": slab, "batch": batch}
            if lanes > MAX_LANES:
                out.append(PlanCandidate(plan, knobs, float("inf"), (float("inf"),), 0,
                                         lanes * rows, 0, "threads"))
                continue
            slots = R * max(L, 1)
            cost = (slabs * slots * (4 + esize)
                    + slots * F * esize * (1 if slab <= fit else L2_MISS_COST) + R * F * esize)
            cost *= 1.0 if batch == rule_batch else BATCH_COST
            out.append(PlanCandidate(plan, knobs, cost, (cost, slab), 0, lanes * rows, 0))
    return out


@functools.lru_cache(maxsize=256)
def _model(R, L, C, F, esize, vec_ok) -> Plan:
    return model_pick(candidates(R, L, C, F, esize, vec_ok)).plan


def plan(R: int, L: int, C: int, F: int, esize: int, vec_ok: bool) -> Plan:
    """Tiles for R ELL rows of L slots times dense (C, F) of ``esize``-byte
    elements: a plan override at exactly these arguments
    (``dispatch.lookup_plan("spmm", ...)``), else the least-cost entry of
    ``candidates``. F goes in one slab where it fits ``L2_SLAB_BYTES`` and
    ``MAX_LANES`` vectors, else in the fewest slabs of whole 128-byte lines
    that do (faster than 3 of 48 or 6 of 24 at ogbn-arxiv's size on an
    H100); a block holds as many whole rows of a slab as fit ``THREADS``;
    a thread loads 16 slots at once where L >= 16, else 8."""
    return (lookup_plan("spmm", (R, L, C, F, esize, vec_ok))
            or _model(R, L, C, F, esize, vec_ok))


def vec16(dense) -> bool:
    """16-byte loads of dense's rows (and stores of the output's): F and
    dense's row stride are multiples of 16 bytes' elements and its pointer
    is 16-byte aligned (the output is allocated fresh, so it follows)."""
    v = 16 // dense.element_size()
    return dense.shape[1] % v == 0 and dense.stride(0) % v == 0 and dense.data_ptr() % 16 == 0


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("spmm")
        fn = lib.repro_ell_spmm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, i32, i32, i32, i32, i32, i32, ptr]
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


def launch(values, cols, dense, out, q: Plan):
    """Launch the kernel with plan ``q`` into ``out`` (R, F) on the current
    stream, counting the launch; raises on a launch error."""
    R, L = values.shape
    F = dense.shape[1]
    lib, fn = _kernel()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), cols.data_ptr(), dense.data_ptr(), out.data_ptr(),
                 DTYPES[values.dtype], DTYPES[dense.dtype], R, L, F,
                 values.stride(0), cols.stride(0), dense.stride(0), out.stride(0),
                 q.vec, q.batch, q.slab, q.lanes, q.rows, q.row_blocks, stream)
    build.check(lib, err, "spmm kernel launch")
    LAUNCHES["spmm"] += 1


def spmm_cuda(values, cols, dense, **blocks):
    """out (R, F) = sum_j values[:, j] * dense[cols[:, j]]. Launches the
    Hopper kernel for CUDA tensors; runs ``blocked.spmm_blocked`` for CPU
    tensors (``blocks`` — the plain form's ``bm`` — reach only that
    form)."""
    if values.device.type == "cpu":
        return blocked.spmm_blocked(values, cols, dense, **blocks)
    _check(values, cols, dense)
    R, L = values.shape
    C, F = dense.shape
    out = torch.empty((R, F), dtype=dense.dtype, device=dense.device)
    if R and F:
        launch(values, cols, dense, out, plan(R, L, C, F, dense.element_size(), vec16(dense)))
    return out
