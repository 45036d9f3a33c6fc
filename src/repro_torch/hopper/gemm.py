"""Tiled GEMM on Hopper: the wrapper of ``csrc/gemm.cu``.

Replaces the reference's Pallas kernel ``repro/kernels/gemm.py``
``_gemm_kernel``. For CUDA tensors the wrapper checks its inputs,
allocates the output, launches the kernel on PyTorch's current stream,
raises on a launch error and adds one to ``dispatch.LAUNCHES["gemm"]``.
For CPU tensors, and only for them, it runs the plain version
``blocked.gemm_blocked``.

A (M, K) and B (K, N) share one dtype, fp32 (CUDA-core FFMA) or bf16
(tensor cores); the output is ``out_dtype`` (fp32 or bf16, default
``a.dtype``), accumulated in fp32. bf16 takes one of two kernels, picked
by ``plan_bf16`` from shapes, strides and alignment alone: ``wgmma`` (a
TMA-fed warpgroup-MMA kernel) where both operands' rows start on 16 bytes
and M and N are at least 64, ``mma`` (mma.sync) at every other shape.
Each is a kernel of its own for its shapes, not a fallback: a build or
launch error raises. Rows must be unit-stride; any row
stride is taken, so row slices go in without a copy. Ragged M, N, K are
masked in the kernel. Inputs it does not take raise; nothing is copied to
make them fit.

``accum_dtype`` bf16 or fp16 is the reference kernel's accumulator in that
type: each K block of ``bk`` (the reference's, 256 by default) is summed
in fp32, rounded to it and added into a running sum rounded after each
add. Its plain version is ``blocked.gemm_accum_blocked``; ``bk`` must be a
multiple of the kernel's K step (``K_STEP``) or cover K.

The fp32 kernel's tiles, ring and grid are chosen here, by ``plan_f32``
(pure Python, so the CPU tests reach it; ``candidates`` lists every plan
its model weighs), and the bf16 route with its tile width, ring and grid
by ``plan_bf16`` (``candidates_bf16``): the kernels take them at run time
and refuse a plan that does not fit.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, KernelStreams, PlanCandidate, StreamOperand,
                                        lookup_plan, model_pick, register_streams,
                                        resolve_blocks)

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACCUM = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
K_STEP = {torch.float32: 16, torch.bfloat16: 32}  # each kernel's K step (csrc/gemm.cu)
ROUTES = {"ffma": 0, "mma": 1, "wgmma": 2}  # repro_gemm's route argument

# csrc/gemm.cu's fp32 kernel and the H100's limits the plan must fit
BK = 16                       # k values per ring stage
A_STRIDE = BK + 4             # floats per A row in a ring stage
TN = 12                       # columns per thread
MAX_THREADS = 512             # the kernel's __launch_bounds__
REGS = 128                    # the register cap that bound gives a thread
SMEM_PER_CTA = 232448         # 227 KB of shared memory a CTA may use
SMEM_PER_SM = 233472          # 228 KB an SM holds, 1 KB of it reserved per CTA
MAX_STAGES = 6

# The cost model's constants, fitted to the kernel's times on an H100 for
# plans swept at ogbn-arxiv's and cora's size
CHUNK_SLOTS = 20              # issue slots a warp spends per K chunk on the ring's barrier
COPY_SLOTS = 10               # and on each cp.async its threads issue
EFF = {1: 0.6, 2: 0.85, 3: 1.0}  # issue efficiency by warps a scheduler holds
COL_TILE_COST = 0.06          # each further column tile: A copied again (12% at 3 of 48)
STREAMED_COST = 1.1           # B streamed through the ring past a CTA's first tile


class F32Plan(NamedTuple):
    tm: int          # rows of a thread's register tile (4 or 2); 12 columns
    wr: int          # warps down the CTA: bm = 8 tm wr
    wc: int          # warps across: bn = 48 wc
    stages: int      # cp.async ring depth
    resident: bool   # B's (K, bn) panel stays in shared memory
    vec: bool        # 16-byte copies (A and B rows 16-byte aligned)
    grid: int        # col_tiles x groups persistent CTAs
    bm: int
    bn: int
    units: int       # row units of 8 tm rows (a warp row's share of a tile)
    col_tiles: int
    threads: int
    smem: int        # dynamic shared memory, bytes
    ctas_per_sm: int


def smem_bytes(tm, wr, wc, K, stages, resident) -> int:
    """Shared memory of a plan (csrc/gemm.cu ``f_smem_bytes``): the
    resident B panel (nk * BK rows of bn) and ``stages`` ring stages of A
    (bm rows of A_STRIDE) and, when B streams, B (BK rows of bn)."""
    bm, bn = 8 * tm * wr, 48 * wc
    nk = max(1, -(-K // BK))
    stage = bm * A_STRIDE + (0 if resident else BK * bn)
    return 4 * (stage * stages + (nk * BK * bn if resident else 0))


def vec16(a, b) -> bool:
    """Every row of the fp32 operands ``a`` and ``b`` starts on 16 bytes
    (the base address and the row stride): the kernel's 16-byte copies
    take them. Otherwise it copies 4 bytes at a time."""
    return all(x.data_ptr() % 16 == 0 and x.stride(0) % 4 == 0 for x in (a, b))


def candidates(M: int, N: int, K: int, sms: int, vec: bool, *,
               smem_budget: int = SMEM_PER_CTA) -> list[PlanCandidate]:
    """Every fp32 plan ``plan_f32``'s model weighs for C (M, N) = A (M, K)
    B (K, N) on a card of ``sms`` SMs, in its order: tm in {4, 2}, wc and
    wr in 1..4, B resident or streamed, 8..1 CTAs an SM. The ring takes
    the deepest stages (2..MAX_STAGES) that fit the shared memory a CTA
    gets (``smem_budget``, and the SM's share). A plan is pruned where its
    CTAs an SM pass the SM's 2048 threads or, at ``REGS`` registers a
    thread, its 64K registers, where not even two stages fit, or where the
    grid has no group. The model: the busiest scheduler of the busiest SM
    runs its warps with work, each for its warp row's units; a unit costs
    (tm x 12 FFMA + tm / 4 + 3 shared loads) instruction slots per k,
    plus CHUNK_SLOTS and COPY_SLOTS per cp.async a thread starts per K chunk,
    over EFF (by the warps with work a scheduler holds), times 1 +
    COL_TILE_COST for each column tile past the first and STREAMED_COST
    when B streams through more than one tile. Least cost wins; ties go to
    less padded work, fewer column tiles (A read fewer times), B resident,
    then the larger register tile and the deeper ring."""
    nk = max(1, -(-K // BK))
    out = []
    for tm in (4, 2):
        ffma = (tm * TN + tm / 4 + 3) * BK  # FFMA and shared loads per K chunk
        units = -(-M // (8 * tm))
        for wc in range(1, 5):
            bn = 48 * wc
            col_tiles = -(-N // bn)
            for wr in range(1, 5):
                threads = 32 * wr * wc
                bm = 8 * tm * wr
                for resident in (True, False):
                    for ctas in range(8, 0, -1):
                        room = min(smem_budget, SMEM_PER_SM // ctas - 1024)
                        stages = max((s for s in range(2, MAX_STAGES + 1)
                                      if smem_bytes(tm, wr, wc, K, s, resident) <= room),
                                     default=0)
                        smem = smem_bytes(tm, wr, wc, K, max(stages, 2), resident)
                        groups = min(units, sms * ctas // col_tiles)
                        grid = max(groups, 1) * col_tiles
                        knobs = {"tm": tm, "wr": wr, "wc": wc, "resident": int(resident),
                                 "ctas": ctas}
                        why = ""
                        if threads > MAX_THREADS or threads * ctas > 2048:
                            why = "threads"
                        elif threads * ctas * REGS > 65536:
                            why = "registers"
                        elif not stages:
                            why = "shared memory"
                        elif groups < 1:
                            why = "grid"
                        plan = F32Plan(tm, wr, wc, max(stages, 2), resident, vec, grid, bm, bn,
                                       units, col_tiles, threads, smem, ctas)
                        if why:
                            out.append(PlanCandidate(plan, knobs, float("inf"), (float("inf"),),
                                                     smem, threads, REGS, why))
                            continue
                        most = -(-units // groups)  # units of the busiest CTA
                        used = -(-grid // sms)  # CTAs on the busiest SM
                        # warps with work on the busiest scheduler, each
                        # with its warp row's units
                        per_sched = -(-used * min(wr, most) * wc // 4)
                        load = per_sched * max(most / wr, 1.0)
                        # cp.async a thread issues per chunk: A's share, and
                        # B's (resident: over the CTA's tiles)
                        tiles = -(-most // wr)
                        copies = tm / wc + 6 / wr / (tiles if resident else 1)
                        slots = nk * (ffma + CHUNK_SLOTS + COPY_SLOTS * copies)
                        cost = (load * slots / EFF[min(per_sched, 3)]
                                * (1 + COL_TILE_COST * (col_tiles - 1))
                                * (STREAMED_COST if not resident and most > wr else 1.0))
                        padded = -(-most // wr) * wr * groups * bm * col_tiles * bn
                        key = (round(cost, 3), padded, col_tiles, not resident, -tm, -stages)
                        out.append(PlanCandidate(plan, knobs, cost, key, smem, threads, REGS))
    return out


@functools.lru_cache(maxsize=256)
def _model_f32(M: int, N: int, K: int, sms: int, vec: bool) -> F32Plan:
    return model_pick(candidates(M, N, K, sms, vec)).plan


def plan_f32(M: int, N: int, K: int, sms: int, vec: bool) -> F32Plan:
    """The fp32 kernel's tiles, ring and grid for C (M, N) = A (M, K) B (K, N)
    on a card of ``sms`` SMs: a plan override at exactly these arguments
    (``dispatch.lookup_plan("gemm", ...)``), else the least-cost feasible
    entry of ``candidates`` (cached; an override is looked up before the
    cache, so a cached pick never masks one). The grid is col_tiles x
    groups, each group an even share of the row units (8 tm rows), as many
    groups as the CTAs an SM allow."""
    return lookup_plan("gemm", (M, N, K, sms, vec)) or _model_f32(M, N, K, sms, vec)


plan_f32.cache_clear = _model_f32.cache_clear


# csrc/gemm.cu's bf16 wgmma kernel: 128 x bn output tiles, a stage holds
# 64 k of A's 128 rows and of B's bn columns; 384 threads (a producer
# warpgroup and two consumer warpgroups) at the register cap of one CTA an
# SM (168; setmaxnreg gives the consumers 232 and the producer 40)
W_BM = 128
W_STAGE_K = 64
W_BNS = (256, 128)            # an fp32 accumulator's tile widths; a narrow one takes 128
W_MAX_STAGES = 8
W_THREADS = 384
W_REGS = 168
MIN_MN = 64                   # below it a 128-row tile is mostly padding
# csrc/gemm.cu's bf16 mma kernel: 128 threads, (128 + 64) rows of 40 bf16
# in static shared memory, at most 255 registers a thread
MMA_THREADS = 128
MMA_SMEM = (128 + 64) * 40 * 2
MMA_REGS = 255
# The wgmma model, in units of one 256-column stage's products: a stage
# costs bn / 256 of them plus W_STAGE_COST (its barrier waits, issue and
# release), a tile's epilogue W_EPILOGUE x bn / 256, and a ring shallower
# than W_DEPTH stages exposes (W_DEPTH - stages) / W_DEPTH of a load's
# latency a stage. Among rings of W_DEPTH stages or more, an fp32
# accumulator takes W_DEPTH and a narrow one the deepest: swept on an H100
# at 4096^3 (gemm_plans.py, PERF.md), the 128-column fp32 tile ran slower
# past 4 stages and the narrow accumulators faster (their folds hold a
# stage longer).
W_STAGE_COST = 0.25
W_EPILOGUE = 1.0
W_DEPTH = 4


class Bf16Plan(NamedTuple):
    route: str        # "wgmma" or "mma"
    bn: int = 0       # wgmma: the output tile's columns (256 or 128)
    stages: int = 0   # wgmma: TMA ring depth
    grid: int = 0     # wgmma: persistent CTAs
    smem: int = 0     # wgmma: dynamic shared memory, bytes

    def args(self) -> tuple:
        """The route and seven plan integers ``repro_gemm`` takes."""
        if self.route == "wgmma":
            return (ROUTES["wgmma"], self.bn, self.stages, self.grid, 0, 0, 0, 0)
        return (ROUTES["mma"],) + (0,) * 7


def wgmma_smem_bytes(bn: int, stages: int) -> int:
    """The wgmma kernel's shared memory (csrc/gemm.cu ``w_smem_bytes``):
    ``stages`` stages of A's 128 rows and B's ``bn`` columns, 128 bytes of k
    each, 1 KB to align them for the 128-byte swizzle, and a full and an
    empty mbarrier a stage."""
    return stages * (W_BM + bn) * 128 + 1024 + 16 * stages


def rows16(*xs) -> bool:
    """Every row of every matrix in ``xs`` starts on 16 bytes (its base
    address and its row stride in bytes): TMA and 16-byte copies take it."""
    return all(x.data_ptr() % 16 == 0 and x.stride(0) * x.element_size() % 16 == 0
               for x in xs)


def candidates_bf16(M: int, N: int, K: int, aligned: bool, sms: int = 132, narrow: bool = False,
                    *, smem_budget: int = SMEM_PER_CTA) -> list[PlanCandidate]:
    """Every bf16 plan ``plan_bf16``'s model weighs for C (M, N) = A (M, K)
    B (K, N) on a card of ``sms`` SMs; ``aligned``: both operands' rows
    start on 16 bytes (``rows16``); ``narrow``: a bf16 or fp16 accumulator.
    The ``mma`` kernel alone (no run-time geometry) where the rows are not
    aligned or M or N is below MIN_MN; else the ``wgmma`` kernel's tile
    width (``W_BNS``; 128 for a narrow accumulator, whose two partial tiles
    take the registers) and ring depth (W_MAX_STAGES..2, pruned where it
    passes ``smem_budget``), on min(tiles, sms) persistent CTAs. The model
    (see W_STAGE_COST): each CTA walks ``rounds`` tiles of ceil(K / 64)
    stages and an epilogue. Least cost wins; ties go to W_DEPTH stages
    (an fp32 accumulator) or the deepest ring (a narrow one)."""
    if not aligned or min(M, N) < MIN_MN:
        return [PlanCandidate(Bf16Plan("mma"), {}, 0.0, (0.0,), MMA_SMEM, MMA_THREADS, MMA_REGS)]
    nkt = -(-K // W_STAGE_K)
    out = []
    for bn in ((128,) if narrow else W_BNS):
        tiles = -(-M // W_BM) * -(-N // bn)
        grid = min(tiles, sms)
        rounds = -(-tiles // grid)
        for stages in range(W_MAX_STAGES, 1, -1):
            smem = wgmma_smem_bytes(bn, stages)
            plan = Bf16Plan("wgmma", bn, stages, grid, smem)
            knobs = {"bn": bn, "stages": stages}
            if smem > smem_budget:
                out.append(PlanCandidate(plan, knobs, float("inf"), (float("inf"),), smem,
                                         W_THREADS, W_REGS, "shared memory"))
                continue
            exposed = 1 + max(0, W_DEPTH - stages) / W_DEPTH
            cost = rounds * (nkt * (bn / 256 + W_STAGE_COST) * exposed + W_EPILOGUE * bn / 256)
            depth = -stages if narrow else abs(stages - W_DEPTH)
            out.append(PlanCandidate(plan, knobs, cost, (round(cost, 6), depth), smem,
                                     W_THREADS, W_REGS))
    return out


@functools.lru_cache(maxsize=256)
def _model_bf16(M: int, N: int, K: int, aligned: bool, sms: int, narrow: bool) -> Bf16Plan:
    return model_pick(candidates_bf16(M, N, K, aligned, sms, narrow)).plan


def plan_bf16(M: int, N: int, K: int, aligned: bool, sms: int = 132,
              narrow: bool = False) -> Bf16Plan:
    """The bf16 kernel, and its tile width, ring and grid, for C (M, N) =
    A (M, K) B (K, N) on a card of ``sms`` SMs: a plan override at exactly
    these arguments (``dispatch.lookup_plan("gemm", ("bf16", M, N, K,
    aligned, sms, narrow))``, a key no fp32 plan has), else the least-cost
    feasible entry of ``candidates_bf16`` (cached behind the lookup)."""
    return (lookup_plan("gemm", ("bf16", M, N, K, aligned, sms, narrow))
            or _model_bf16(M, N, K, aligned, sms, narrow))


plan_bf16.cache_clear = _model_bf16.cache_clear


@register_streams("gemm", kernel="gemm")
def streams(structs, policy=None, *, out_dtype=None, accum_dtype=torch.float32, **_):
    """The kernel's streams for ``ops.gemm`` with no ``precision``: a
    (M, K) and b (K, N) values, summed in ``accum_dtype`` (fp32, or the
    narrow bf16/fp16 running sum), written as ``out_dtype`` (default a's
    dtype). The route is ``ffma`` for fp32 values; for bf16 it is
    ``plan_bf16``'s at these shapes with contiguous, 16-byte-aligned
    operands (``wgmma`` or ``mma``)."""
    if policy is not None:
        return None
    (a_shape, dtype), (b_shape, b_dtype) = structs[:2]
    if dtype == torch.float32:
        route = "ffma"
    else:
        (M, K), N = a_shape, b_shape[1]
        aligned = K * 2 % 16 == 0 and N * 2 % 16 == 0
        route = plan_bf16(M, N, K, aligned, narrow=accum_dtype != torch.float32).route
    name = f"gemm/{route}"
    if accum_dtype != torch.float32:
        name += f"+{str(accum_dtype).replace('torch.', '')}-accum"
    return KernelStreams(
        name, (StreamOperand("value", a_shape, dtype), StreamOperand("value", b_shape, b_dtype)),
        accum_dtype, (StreamOperand("value", (a_shape[0], b_shape[1]), out_dtype or dtype),))


_fn = None
_lib = None


def _kernel():
    global _fn, _lib
    if _fn is None:
        lib = build.load("gemm")
        fn = lib.repro_gemm
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i64, i64, i64,
                       i32, i32, i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        _lib, _fn = lib, fn
    return _fn


def _check(a, b, out_dtype, accum_dtype, bk):
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
    if accum_dtype not in ACCUM:
        raise TypeError(f"gemm kernel accumulates in float32, bfloat16 or float16, not {accum_dtype}")
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
    if accum_dtype != torch.float32 and (bk < 1 or bk % K_STEP[a.dtype] and bk < a.shape[1]):
        raise ValueError(
            f"gemm kernel: a {accum_dtype} accumulator's K block bk={bk} must be a "
            f"multiple of {K_STEP[a.dtype]} (the {a.dtype} kernel's K step) or cover K"
        )


def gemm_cuda(a, b, *, out_dtype=None, accum_dtype=torch.float32, bm=None, bk=None, bn=None):
    """C = A @ B, accumulated in ``accum_dtype``. Launches the Hopper kernel
    for CUDA tensors; runs its plain version for CPU tensors:
    ``blocked.gemm_blocked`` (``bm``/``bk``/``bn`` shape only that form)
    for an fp32 accumulator, ``blocked.gemm_accum_blocked`` at K blocks of
    ``bk`` for a narrow one. The kernel reads ``bk`` only for a narrow
    accumulator (default: the block table's, at most K)."""
    bk = min(bk or resolve_blocks("gemm")["bk"], max(a.shape[-1], 1))
    if a.device.type == "cpu":
        if accum_dtype == torch.float32:
            return blocked.gemm_blocked(a, b, out_dtype=out_dtype, bm=bm, bk=bk, bn=bn)
        return blocked.gemm_accum_blocked(a, b, bk=bk, accum_dtype=accum_dtype,
                                          out_dtype=out_dtype)
    out_dtype = out_dtype or a.dtype
    _check(a, b, out_dtype, accum_dtype, bk)
    M, K = a.shape
    N = b.shape[1]
    c = torch.empty((M, N), dtype=out_dtype, device=a.device)
    if M and N:
        fn = _fn or _kernel()
        dev = a.device.index
        if a.dtype == torch.float32:
            q = plan_f32(M, N, K, sm_count(dev), vec16(a, b))
            plan = (ROUTES["ffma"], q.tm, q.wr, q.wc, q.stages, int(q.resident), int(q.vec), q.grid)
            route = "ffma"
        else:
            q = plan_bf16(M, N, K, rows16(a, b), sm_count(dev), accum_dtype != torch.float32)
            plan, route = q.args(), q.route
        args = (a.data_ptr(), b.data_ptr(), c.data_ptr(), DTYPES[a.dtype], DTYPES[out_dtype],
                ACCUM[accum_dtype], bk, M, N, K, a.stride(0), b.stride(0), c.stride(0), *plan)
        if torch.cuda.current_device() == dev:  # the usual case: no device switch
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        if err:
            build.check(_lib, err, f"gemm kernel launch ({route} route)")
        LAUNCHES["gemm"] += 1
    return c

