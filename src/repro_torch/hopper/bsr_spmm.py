"""Block-sparse-row x dense product on Hopper: the wrapper of
``csrc/bsr_spmm.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/spmm.py``
``_bsr_kernel``. For CUDA tensors the wrapper checks its inputs, computes
the row pointer of the sorted tile rows on the device (no sync),
allocates the output, launches the kernel on PyTorch's current stream,
raises on a launch error and adds one to ``dispatch.LAUNCHES["bsr_spmm"]``.
For CPU tensors, and only for them, it runs the plain version
``blocked.bsr_spmm_blocked``.

tile_values (T, bm, bk) contiguous, fp32 or bf16; tile_rows/tile_cols (T,)
int32, rows sorted; dense (K, F) fp32 or bf16, unit-stride rows (any row
stride); the output (num_rows, F) is fp32, summed in fp32. Tile
coordinates are not checked here: ``core.sparse.BsrMatrix`` checks them
once, at construction (``tile_cols * bk + bk <= K`` is the caller's
obligation in the unpacked form); a launch does not synchronise to check
them again. A zero tile value does no work in the kernel, so a non-finite
dense value facing one does not make the sum NaN, as the plain version's
dense product 0 * inf does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import LAUNCHES, KernelStreams, StreamOperand, register_streams

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_fn = None


@register_streams("bsr_spmm", kernel="bsr_spmm")
def streams(structs, policy=None, *, num_rows, **_):
    """The kernel's streams for ``ops.bsr_spmm``: tile_values (T, bm, bk)
    and dense (K, F) values, tile_rows and tile_cols (T,) int32 indices,
    summed in fp32; the (num_rows, F) fp32 output."""
    (t_shape, t_dtype), rows, cols, (d_shape, d_dtype) = structs[:4]
    return KernelStreams(
        "bsr_spmm", (StreamOperand("value", t_shape, t_dtype), StreamOperand("index", *rows),
                     StreamOperand("index", *cols), StreamOperand("value", d_shape, d_dtype)),
        torch.float32, (StreamOperand("value", (num_rows, d_shape[1]), torch.float32),))


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("bsr_spmm")
        fn = lib.repro_bsr_spmm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i64, i64, ptr]
        fn.restype = i32
        _fn = (lib, fn)
    return _fn


def _check(tile_values, tile_rows, tile_cols, dense, num_rows):
    dev = tile_values.device
    if not (tile_values.is_cuda and all(x.device == dev for x in (tile_rows, tile_cols, dense))):
        raise ValueError(
            f"bsr_spmm: tile_values/tile_rows/tile_cols/dense must share one CUDA "
            f"device, got {tile_values.device}/{tile_rows.device}/{tile_cols.device}/"
            f"{dense.device}"
        )
    if tile_values.dtype not in DTYPES or dense.dtype not in DTYPES:
        raise TypeError(
            f"bsr_spmm kernel takes float32 or bfloat16 tiles and dense, got "
            f"{tile_values.dtype}/{dense.dtype}"
        )
    if tile_rows.dtype != torch.int32 or tile_cols.dtype != torch.int32:
        raise TypeError(
            f"bsr_spmm kernel takes int32 tile coordinates, got "
            f"{tile_rows.dtype}/{tile_cols.dtype}"
        )
    if tile_values.dim() != 3 or dense.dim() != 2:
        raise ValueError(
            f"bsr_spmm: tile_values (T, bm, bk) and dense (K, F), got "
            f"{tuple(tile_values.shape)} {tuple(dense.shape)}"
        )
    T, bm, bk = tile_values.shape
    if tile_rows.shape != (T,) or tile_cols.shape != (T,):
        raise ValueError(
            f"bsr_spmm: tile_rows/tile_cols must be ({T},), got "
            f"{tuple(tile_rows.shape)}/{tuple(tile_cols.shape)}"
        )
    if bm < 1 or bk < 1 or num_rows % bm:
        raise ValueError(f"bsr_spmm: num_rows={num_rows} is not a multiple of bm={bm}")
    if T and dense.shape[0] < bk:
        raise ValueError(f"bsr_spmm: dense has {dense.shape[0]} rows, fewer than bk={bk}")
    if not tile_values.is_contiguous():
        raise ValueError("bsr_spmm kernel: tile_values must be contiguous")
    if not (tile_rows.is_contiguous() and tile_cols.is_contiguous()):
        raise ValueError("bsr_spmm kernel: tile_rows/tile_cols must be contiguous")
    if dense.shape[1] > 1 and dense.stride(1) != 1:
        raise ValueError(
            f"bsr_spmm kernel: dense must be unit-stride along its rows, got "
            f"strides {dense.stride()}"
        )


def row_pointer(tile_rows, nr):
    """(nr + 1,) int32: the tiles of block row r are ``[ptr[r], ptr[r + 1])``
    of the sorted ``tile_rows``. Built where ``tile_rows`` lies, without a
    sync (the kernel's schedule: each warp walks its block row's range)."""
    return torch.searchsorted(
        tile_rows, torch.arange(nr + 1, dtype=torch.int32, device=tile_rows.device),
        out_int32=True)


def bsr_spmm_cuda(tile_values, tile_rows, tile_cols, dense, num_rows, **blocks):
    """fp32 out (num_rows, F) = sum over tiles t of tile_values[t] @
    dense[tile_cols[t]*bk : +bk] at block row tile_rows[t]. Launches the
    Hopper kernel for CUDA tensors; runs ``blocked.bsr_spmm_blocked`` for
    CPU tensors (``blocks`` — the reference grid's ``bf`` — reach only that
    form)."""
    if tile_values.device.type == "cpu":
        return blocked.bsr_spmm_blocked(tile_values, tile_rows, tile_cols, dense,
                                        num_rows, **blocks)
    _check(tile_values, tile_rows, tile_cols, dense, num_rows)
    T, bm, bk = tile_values.shape
    F = dense.shape[1]
    out = torch.empty((num_rows, F), dtype=torch.float32, device=dense.device)
    nr = num_rows // bm
    if nr and F:
        rowptr = row_pointer(tile_rows, nr)
        lib, fn = _kernel()
        with torch.cuda.device(dense.device):
            stream = torch.cuda.current_stream(dense.device).cuda_stream
            err = fn(tile_values.data_ptr(), rowptr.data_ptr(), tile_cols.data_ptr(),
                     dense.data_ptr(), out.data_ptr(), DTYPES[tile_values.dtype],
                     DTYPES[dense.dtype], nr, bm, bk, F, dense.stride(0), out.stride(0),
                     stream)
        build.check(lib, err, "bsr_spmm kernel launch")
        LAUNCHES["bsr_spmm"] += 1
    return out
