"""Precision policies with expanding accumulation (port of
``repro.core.precision``; the paper's C6 / Fig. 10 ladder).

A ``Precision`` is a policy: the compute dtype the operands travel in, the
accumulator dtype a kernel carries at full width, and ``scale_block``, the
per-block scaling granularity of the narrow formats. fp8 policies quantize
per contiguous block of ``scale_block`` elements along the contraction
axis: operands travel as (values, fp32 per-block scales) and kernels
rescale inside the fp32 accumulator. bf16/fp32 set ``scale_block=0``:
unit scales, plain casts.

Policies ride the ops' signatures as ``precision=None`` keywords; ``None``
is the exact legacy full-precision path. ``resolve`` is the one
name -> policy seam every consumer shares.

Quantization is bitwise the reference's for the same fp32 input: scale =
amax / finfo(compute).max per block (1.0 for a zero-amax block), values =
x / scale cast to the compute dtype (round to nearest even), the ragged
final block padded with zeros for its amax. Nothing clamps: an input the
narrow format cannot hold gives what the cast gives.

``flop_multiplier`` is a policy's peak rate against the card's bf16
tensor-core peak (``core.topology.PEAK_FLOPS_BF16``), and ``peak_flops``
the rate itself: 2.0 for fp8 (its tensor-core rate), 1.0 for bf16, and
67 / 989.4 for fp32, whose kernels in the port run on the CUDA cores
(FFMA, ``hopper/gemm.py``), not TF32. The reference's 0.5 for fp32 is a
TPU's.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.topology import PEAK_FLOPS_BF16

# fp32 outside the tensor cores, FLOP/s (H100 SXM5 datasheet: 67 TFLOP/s)
PEAK_FLOPS_FP32_FFMA = 67e12


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    compute_dtype: torch.dtype
    accum_dtype: torch.dtype  # the expanding accumulator
    flop_multiplier: float  # peak rate relative to the card's bf16 peak
    scale_block: int = 0  # per-block scale granularity; 0 = unit scales


POLICIES = {
    "fp32": Precision("fp32", torch.float32, torch.float32,
                      PEAK_FLOPS_FP32_FFMA / PEAK_FLOPS_BF16),
    "bf16": Precision("bf16", torch.bfloat16, torch.float32, 1.0),
    "fp8": Precision("fp8", torch.float8_e4m3fn, torch.float32, 2.0, 128),
    "fp8_e5m2": Precision("fp8_e5m2", torch.float8_e5m2, torch.float32, 2.0, 128),
}

# the policies each op's scaled path takes; ops absent here run fp32 only
SUPPORTED_OPS = {
    "gemm": ("fp32", "bf16", "fp8", "fp8_e5m2"),
    "flash_attention": ("fp32", "bf16", "fp8", "fp8_e5m2"),
    "decode_attention": ("fp32", "bf16", "fp8", "fp8_e5m2"),
}


def supported_policies(op: str) -> tuple[str, ...]:
    """Policy names ``op`` accepts through ``precision=`` (``("fp32",)``
    for ops without a scaled path)."""
    return SUPPORTED_OPS.get(op, ("fp32",))


def resolve(policy) -> Precision | None:
    """None passes through (the legacy path), a name looks up ``POLICIES``,
    a ``Precision`` returns itself. Unknown names raise ``KeyError``
    listing the known ones."""
    if policy is None or isinstance(policy, Precision):
        return policy
    try:
        return POLICIES[policy]
    except KeyError:
        raise KeyError(
            f"unknown precision policy {policy!r}; known: {sorted(POLICIES)}"
        ) from None


def peak_flops(policy) -> float:
    """The card's peak FLOP/s for the kernels ``policy`` (a name or a
    ``Precision``) runs on."""
    return PEAK_FLOPS_BF16 * resolve(policy).flop_multiplier


def peak_flops_of(dtype: torch.dtype) -> float:
    """``peak_flops`` of the policy whose compute dtype is ``dtype``."""
    for p in POLICIES.values():
        if p.compute_dtype == dtype:
            return peak_flops(p)
    raise KeyError(f"no precision policy computes in {dtype}")


def quantize_blockwise(x, policy, *, axis: int = -1, block: int | None = None):
    """Quantize ``x`` to (values, scales), one fp32 scale per contiguous
    ``block`` elements along ``axis``.

    ``block`` defaults to the policy's ``scale_block`` (the whole axis when
    0). Policies with ``scale_block == 0`` return unit scales: a plain
    cast. ``scales`` has ``x``'s shape with ``axis`` shrunk to
    ``ceil(n / block)``; ``values`` has ``x``'s shape in the compute dtype.
    Both are contiguous.
    """
    p = resolve(policy)
    axis = axis % x.dim()
    n = x.shape[axis]
    if block is None:
        block = p.scale_block or n
    block = max(1, min(block, n))
    nb = math.ceil(n / block)
    pad = nb * block - n
    xf = x.to(torch.float32).movedim(axis, -1)
    if pad:
        xf = torch.nn.functional.pad(xf, (0, pad))
    grouped = xf.reshape(*xf.shape[:-1], nb, block)
    if p.scale_block > 0:
        amax = grouped.abs().amax(dim=-1)
        fmax = float(torch.finfo(p.compute_dtype).max)
        scales = torch.where(amax > 0, amax / fmax, torch.ones((), device=x.device))
    else:
        scales = torch.ones(grouped.shape[:-1], dtype=torch.float32, device=x.device)
    values = (grouped / scales[..., None]).reshape(*grouped.shape[:-2], nb * block)
    if pad:
        values = values[..., :n]
    # both come back contiguous in x's layout (a kernel reads rows)
    values = values.movedim(-1, axis).contiguous().to(p.compute_dtype)
    return values, scales.movedim(-1, axis).contiguous()


def dequantize_blockwise(values, scales, *, axis: int = -1,
                         block: int | None = None):
    """Inverse of ``quantize_blockwise``: the fp32 reconstruction. Pass the
    ``block`` used to quantize; when omitted it is ``ceil(n / nb)``, exact
    whenever the block count is 1 or divides the axis."""
    axis = axis % values.dim()
    n = values.shape[axis]
    nb = scales.shape[axis]
    if block is None:
        block = math.ceil(n / nb)
    # element i reads scale block min(i // block, nb - 1)
    idx = torch.clamp(torch.arange(n, device=values.device) // block, max=nb - 1)
    return values.to(torch.float32) * scales.index_select(axis, idx)


def quantize_kv_cache(k, v, policy):
    """Quantize a KV cache per row over the head dimension: values in the
    compute dtype plus one fp32 scale per row, (..., 1): the serving
    engine's cache layout, where each cached token's key/value carries one
    scale."""
    p = resolve(policy)
    kq, ks = quantize_blockwise(k, p, axis=-1, block=k.shape[-1])
    vq, vs = quantize_blockwise(v, p, axis=-1, block=v.shape[-1])
    return kq, ks, vq, vs


def cast_gemm_operands(a, b, policy):
    """Both operands cast to the policy's compute dtype, and the policy."""
    p = resolve(policy)
    return a.to(p.compute_dtype), b.to(p.compute_dtype), p


def expanding_gemm(a, b, policy="bf16", impl=None):
    """GEMM of the operands cast to the policy's compute dtype, with the
    policy's expanding accumulation and output (Fig. 10). The plain GEMM
    kernel takes fp32 and bf16 operands: fp8 casts go through
    ``impl="ref"`` or ``"torch"``, as the reference's callers run it."""
    from repro_torch.hopper import ops

    a, b, p = cast_gemm_operands(a, b, policy)
    return ops.gemm(a, b, out_dtype=p.accum_dtype, accum_dtype=p.accum_dtype,
                    impl=impl)
