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
``dispatch.resolve_blocks("gemm")`` gives it and capped at K; any
``bk >= 1`` is taken. Values are fp32, bf16, fp8 e4m3 or fp8 e5m2 (one
dtype for both operands), unit-stride along their rows; scales are fp32
with any strides. The output is fp32 (default) or bf16. Inputs the kernel
does not take raise; nothing is copied to make them fit (the fp8 wgmma
route transposes B into a scratch, inside the call).

``plan`` (pure Python, so the CPU tests reach it) picks one of the
source's three kernels from shapes and types alone: ``wgmma`` (bf16 and
fp8 on Hopper's warpgroup MMA, where bk is a multiple of a stage's k and
the rows are 16-byte aligned), ``ffma`` (fp32 on the CUDA cores) or
``mma`` (bf16 and fp8 at every other shape). Each is a kernel of its own
for its shapes, not a fallback: a build or launch error raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core import precision as prec
from repro_torch.device import sm_count
from repro_torch.hopper import blocked, build
from repro_torch.hopper.dispatch import (LAUNCHES, KernelStreams, PlanCandidate, StreamOperand,
                                        lookup_plan, model_pick, register_streams,
                                        resolve_blocks)
from repro_torch.hopper.gemm import CHUNK_SLOTS, COPY_SLOTS, EFF, SMEM_PER_CTA

DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
          torch.float8_e5m2: 3}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FP8 = (torch.float8_e4m3fn, torch.float8_e5m2)
ROUTES = {"mma": 0, "wgmma": 1, "ffma": 2}

# csrc/gemm_scaled.cu's wgmma kernel: a stage holds 128 bytes of k for 128
# rows of A and 128 columns of B; a wgmma k-step is 32 bytes of k
W_TILE = 128                  # rows and columns of an output tile
W_STAGE_BYTES = 2 * 128 * 128
W_MAX_STAGES = 7
STAGE_K = {torch.bfloat16: 64, torch.float8_e4m3fn: 128, torch.float8_e5m2: 128}
K_STEP = {torch.bfloat16: 16, torch.float8_e4m3fn: 32, torch.float8_e5m2: 32}
MIN_MN = 64                   # below it a 128 x 128 tile is mostly padding
# k values of the wgmma partial before it is scaled into the fp32
# accumulator (the MMA promotion interval): half a stage, a stage or (bf16)
# two; the plan takes its largest common divisor with bk. The fp8
# tensor-core sum keeps fewer bits than fp32, so for fp8 it is the largest
# at which every chip_smoke.py GEMM_SCALED_CASES case on this route and the
# ladder's card shape held SCALED_REL_TOL on an H100 (PERF.md); bf16's sum is
# fp32, and two stages halve the scaling work.
PROMOTE = {torch.bfloat16: 128, torch.float8_e4m3fn: 64, torch.float8_e5m2: 128}

# csrc/gemm_scaled.cu's ffma kernel (gemm.cu's fp32 design, B streamed)
F_BK = 32                     # k values per ring stage
F_AS = F_BK + 4               # floats per A row in a ring stage
F_TN = 12                     # columns per thread
F_MAX_THREADS = 384           # acc, part and scales need up to 168 registers
F_REGS = 168                  # the ffma kernel's registers a thread, at most
W_THREADS = 384               # the wgmma kernel's CTA: a producer and two consumer warpgroups
F_MAX_STAGES = 8


class Plan(NamedTuple):
    route: str               # "wgmma", "ffma" or "mma"
    stages: int = 0          # ring depth (wgmma, ffma)
    promote: int = 0         # wgmma: k values per partial (half a stage to two stages)
    grid: int = 0            # persistent CTAs (wgmma, ffma)
    tm: int = 0              # ffma: rows of a thread's register tile; 12 columns
    wr: int = 0              # ffma: warps down the CTA: bm = 8 tm wr
    wc: int = 0              # ffma: warps across: bn = 48 wc
    vec: bool = False        # ffma: 16-byte copies
    smem: int = 0            # dynamic shared memory, bytes

    def args(self) -> tuple:
        """The six plan integers ``repro_gemm_scaled`` takes."""
        if self.route == "wgmma":
            return (self.stages, self.promote, self.grid, 0, 0, 0)
        if self.route == "ffma":
            return (self.tm, self.wr, self.wc, self.stages, int(self.vec), self.grid)
        return (0,) * 6


def wgmma_smem_bytes(stages: int) -> int:
    """The wgmma kernel's shared memory (csrc/gemm_scaled.cu
    ``w_smem_bytes``): the stages, 1 KB to align them for the 128-byte
    swizzle, two mbarriers a stage, and two K-blocks' b_s for the tile's
    128 columns for each consumer warp."""
    return stages * W_STAGE_BYTES + 1024 + 16 * stages + 8 * 256 * 4


def ffma_smem_bytes(tm: int, wr: int, wc: int, stages: int) -> int:
    """The ffma kernel's shared memory (csrc/gemm_scaled.cu
    ``f_smem_bytes``): ``stages`` ring stages of A (bm rows of F_AS) and B
    (F_BK rows of bn)."""
    return 4 * stages * (8 * tm * wr * F_AS + F_BK * 48 * wc)


def rows16(*xs) -> bool:
    """Every row of every matrix in ``xs`` starts on 16 bytes (its base
    address and its row stride in bytes): TMA and 16-byte copies take it."""
    return all(x.data_ptr() % 16 == 0 and x.stride(0) * x.element_size() % 16 == 0
               for x in xs)


def _ffma_candidates(M, N, K, bk, sms, vec, smem_budget) -> list[PlanCandidate]:
    """The ffma kernel's register tiles, warps, ring and grid. Candidates:
    tm in {4, 2}, wr and wc in 1..4 (pruned past F_MAX_THREADS threads),
    the deepest ring that fits ``smem_budget`` (pruned where two stages do
    not); the grid is min(tiles, sms) persistent CTAs walking 8 tm wr x 48
    wc tiles. The model (gemm.py ``plan_f32``'s constants): the busiest
    scheduler runs ceil(warps / 4) warps for each of ``rounds`` tiles, each
    issuing (tm x 12 FFMA + tm / 4 + 3 shared loads) slots per k, plus
    CHUNK_SLOTS and COPY_SLOTS per cp.async per chunk of F_BK k, over EFF.
    Least cost wins; ties go to less padded work, then the larger tile."""
    nk = -(-K // bk)
    chunks = (nk - 1) * -(-bk // F_BK) + -(-(K - (nk - 1) * bk) // F_BK)
    out = []
    for tm in (4, 2):
        for wr in range(1, 5):
            for wc in range(1, 5):
                threads = 32 * wr * wc
                bm, bn = 8 * tm * wr, 48 * wc
                stages = max((s for s in range(2, F_MAX_STAGES + 1)
                              if ffma_smem_bytes(tm, wr, wc, s) <= smem_budget), default=0)
                smem = ffma_smem_bytes(tm, wr, wc, max(stages, 2))
                tiles = -(-M // bm) * -(-N // bn)
                grid = min(tiles, sms)
                plan = Plan("ffma", max(stages, 2), 0, grid, tm, wr, wc, vec, smem)
                knobs = {"tm": tm, "wr": wr, "wc": wc}
                why = ("threads" if threads > F_MAX_THREADS
                       else "shared memory" if not stages else "")
                if why:
                    out.append(PlanCandidate(plan, knobs, float("inf"), (float("inf"),), smem,
                                             threads, F_REGS, why))
                    continue
                rounds = -(-tiles // grid)
                per_sched = -(-(wr * wc) // 4)
                copies = (bm * F_BK / 4 + F_BK * bn / 4) / threads
                slots = (tm * F_TN + tm / 4 + 3) * F_BK + CHUNK_SLOTS + COPY_SLOTS * copies
                cost = rounds * chunks * per_sched * slots / EFF[min(per_sched, 3)]
                padded = rounds * grid * bm * bn
                key = (round(cost / 1e3), padded, -bm * bn, -stages)
                out.append(PlanCandidate(plan, knobs, cost, key, smem, threads, F_REGS))
    return out


def _wgmma_candidates(M, N, K, bk, dtype, sms, smem_budget) -> list[PlanCandidate]:
    """The wgmma kernel's ring depth (2..W_MAX_STAGES, pruned where it
    passes ``smem_budget``, or below 5 stages where a partial spans 8
    k-steps: the kernel refuses that) and persistent grid (min(tiles, sms) CTAs, or
    as few as keep the same rounds of tiles). ``PROMOTE``'s interval is
    held: it sets what the fp8 sum rounds. The model: each CTA walks
    ``rounds`` output tiles, each streaming ceil(K / stage k) stages, and a
    ring shallower than W_MAX_STAGES exposes (W_MAX_STAGES - stages) /
    W_MAX_STAGES of a load's latency a stage. Least cost wins; ties go to
    the larger grid."""
    tiles = -(-M // W_TILE) * -(-N // W_TILE)
    nks = -(-K // STAGE_K[dtype])
    grids = []
    for rounds in (-(-tiles // sms), -(-tiles // sms) + 1):
        g = -(-tiles // rounds)
        if g not in grids:
            grids.append(g)
    grids[0] = min(tiles, sms)
    promote = math.gcd(PROMOTE[dtype], bk)
    units = promote // (STAGE_K[dtype] // 4)  # wgmma k-steps a partial
    out = []
    for stages in range(W_MAX_STAGES, 1, -1):
        smem = wgmma_smem_bytes(stages)
        for grid in grids:
            rounds = -(-tiles // grid)
            cost = rounds * nks * (1 + (W_MAX_STAGES - stages) / W_MAX_STAGES)
            plan = Plan("wgmma", stages, promote, grid, smem=smem)
            # a partial of 8 k-steps keeps two units of two stages in flight
            why = ("shared memory" if smem > smem_budget
                   else "ring" if units == 8 and stages < 5 else "")
            out.append(PlanCandidate(plan, {"stages": stages, "grid": grid},
                                     float("inf") if why else cost,
                                     (float("inf"),) if why else (cost, -grid), smem,
                                     W_THREADS, 0, why))
    return out


def candidates(M: int, N: int, K: int, bk: int, dtype: torch.dtype, aligned: bool,
               sms: int = 132, *, smem_budget: int = SMEM_PER_CTA) -> list[PlanCandidate]:
    """Every plan ``plan``'s model weighs at these arguments: the ffma
    kernel's tiles for fp32, the wgmma kernel's ring and grid where bf16
    and fp8 take that route (bk held: it is the quantization block), and
    the mma kernel alone (no run-time geometry) at every other shape."""
    if dtype == torch.float32:
        return _ffma_candidates(M, N, K, bk, sms, aligned and bk % 4 == 0, smem_budget)
    if dtype not in STAGE_K:
        raise TypeError(f"gemm_scaled: no route for {dtype}")
    if (K == 0 or bk % STAGE_K[dtype] or not aligned or min(M, N) < MIN_MN
            or (dtype in FP8 and N % 16)):  # B's transpose moves 16-byte chunks of its rows
        return [PlanCandidate(Plan("mma"), {}, 0.0, (0.0,), 0, 0, 0)]
    return _wgmma_candidates(M, N, K, bk, dtype, sms, smem_budget)


@functools.lru_cache(maxsize=256)
def _model(M, N, K, bk, dtype, aligned, sms) -> Plan:
    return model_pick(candidates(M, N, K, bk, dtype, aligned, sms)).plan


def plan(M: int, N: int, K: int, bk: int, dtype: torch.dtype, aligned: bool,
         sms: int = 132) -> Plan:
    """The route, and its ring and grid, for C (M, N) = A (M, K) B (K, N)
    per K-block of ``bk`` with values of ``dtype`` on a card of ``sms``
    SMs; ``aligned``: both operands' rows start on 16 bytes (``rows16``).
    A plan override at exactly these arguments
    (``dispatch.lookup_plan("gemm_scaled", ...)``) comes first; else the
    least-cost feasible entry of ``candidates`` (cached behind the
    lookup).

    fp32 takes ``ffma``. bf16 and fp8 take ``wgmma`` where bk is a
    multiple of a stage's k (64 bf16, 128 fp8 values), the rows are
    aligned, M and N are at least 64 and (fp8) N is a multiple of 16, with the deepest ring that fits,
    ``PROMOTE``'s interval and one CTA an SM; at every other shape they
    take ``mma``."""
    return (lookup_plan("gemm_scaled", (M, N, K, bk, dtype, aligned, sms))
            or _model(M, N, K, bk, dtype, aligned, sms))


plan.cache_clear = _model.cache_clear


@register_streams("gemm", kernel="gemm_scaled")
def streams(structs, policy=None, *, out_dtype=None, accum_dtype=torch.float32, bk=None, **_):
    """The kernel's streams for ``ops.gemm(precision=policy)``: a (M, K)
    and b (K, N) quantized to the policy's compute dtype per K-block of
    ``bk`` (the block table's, at most K), with fp32 scales (M, nk) and
    (nk, N), summed in fp32 and written as ``out_dtype`` (default fp32).
    The route (``ffma``, ``wgmma`` or ``mma``) is the model's at these
    shapes with 16-byte rows. A narrow ``accum_dtype`` is no call of this
    kernel (it raises)."""
    if policy is None or accum_dtype != torch.float32:
        return None
    (M, K), _ = structs[0]
    N = structs[1][0][1]
    dtype = policy.compute_dtype
    bk = min(resolve_blocks("gemm", bk=bk)["bk"], K)
    nk = math.ceil(K / bk)
    esize = torch.empty((), dtype=dtype).element_size()
    aligned = K * esize % 16 == 0 and N * esize % 16 == 0
    route = model_pick(candidates(M, N, K, bk, dtype, aligned)).plan.route
    return KernelStreams(
        f"gemm_scaled/{route}@{policy.name}",
        (StreamOperand("value", (M, K), dtype), StreamOperand("value", (K, N), dtype),
         StreamOperand("scale", (M, nk), torch.float32, bk),
         StreamOperand("scale", (nk, N), torch.float32, bk)),
        torch.float32, (StreamOperand("value", (M, N), out_dtype or torch.float32),))


_fn = None
_lib = None


def _kernel():
    global _fn, _lib
    if _fn is None:
        lib = build.load("gemm_scaled")
        fn = lib.repro_gemm_scaled
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                       i64, i64, i64, i64, i64, i64, i64, i64, i32,
                       i32, i32, i32, i32, i32, i32, ptr]
        fn.restype = i32
        _lib, _fn = lib, fn
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
    if K == 0:  # an empty sum: no kernel runs
        return torch.zeros((M, N), dtype=out_dtype, device=aq.device)
    c = torch.empty((M, N), dtype=out_dtype, device=aq.device)
    if M and N:
        fn = _fn or _kernel()
        dev = aq.device.index
        pl = plan(M, N, K, bk, aq.dtype, rows16(aq, bq), sm_count(dev))
        bt, ldbt = None, 0
        if pl.route == "wgmma" and aq.dtype in FP8:  # B's transpose, rows padded to 16 bytes
            ldbt = -(-K // 16) * 16
            bt = torch.empty((N, ldbt), dtype=torch.uint8, device=aq.device)
        args = (aq.data_ptr(), bq.data_ptr(), a_scale.data_ptr(), b_scale.data_ptr(),
                c.data_ptr(), None if bt is None else bt.data_ptr(), DTYPES[aq.dtype],
                OUT_DTYPES[out_dtype], M, N, K, bk, aq.stride(0), bq.stride(0), c.stride(0),
                *a_scale.stride(), *b_scale.stride(), ldbt, ROUTES[pl.route], *pl.args())
        if torch.cuda.current_device() == dev:  # the usual case: no device switch
            err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(*args, torch._C._cuda_getCurrentRawStream(dev))
        if err:
            build.check(_lib, err, f"gemm_scaled kernel launch ({pl.route} route)")
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
            f"gemm: accum_dtype={accum_dtype} with precision=: the kernel sums in float32, "
            f"and the reference's kernel paths refuse a narrow accumulator too (its xla "
            f"scan and its Pallas body raise); only impl='ref' computes it"
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
