"""Seeded-bad precision dataflow: fp8 values, fp16 accumulator, no scales.

``make_streams()`` builds the ``KernelStreams`` of a kernel that takes fp8
values but sums them in float16 and takes no fp32 scales — both halves of
the block-scaling contract broken at once (saturating accumulation AND
narrowing without a scale), so ``check_dtype_dataflow`` must report
exactly two problems. ``make_pool()`` builds a ``PagedKVCache`` whose value
pools are fp8 with ``k_scale``/``v_scale`` dropped — the quantized-pool
bypass ``check_quantized_pool`` must flag once per pool side.

Imported by ``tests/test_torch_explore.py``.
"""
import torch

from repro_torch.hopper.dispatch import KernelStreams, StreamOperand
from repro_torch.serving.paged_cache import PagedKVCache

BM = BN = BK = 8


def make_streams() -> KernelStreams:
    """An fp8 GEMM tile with a float16 accumulator and no scales."""
    f8 = torch.float8_e4m3fn
    return KernelStreams(
        "bad_fp8_gemm",
        (StreamOperand("value", (2 * BM, BK), f8), StreamOperand("value", (BK, 2 * BN), f8)),
        torch.float16,  # BUG: the running sum saturates
        (StreamOperand("value", (2 * BM, 2 * BN), torch.float16),),
    )


def make_pool() -> PagedKVCache:
    """fp8 KV pools whose per-row scales were dropped."""
    shape = (1, 3, 2, 2, 4)  # (nl, P, K, bs, hd)
    return PagedKVCache(
        k_pool=torch.zeros(shape, dtype=torch.uint8).view(torch.float8_e4m3fn),
        v_pool=torch.zeros(shape, dtype=torch.uint8).view(torch.float8_e4m3fn),
        block_size=2,
        k_scale=None,  # BUG: quantized reads bypass the scales
        v_scale=None,
        policy="fp8",
    )
