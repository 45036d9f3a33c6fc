"""The precision ladder (the paper's Fig. 10) on the port: twin of
``benchmarks/bench_precision.py``.

Sweeps the ``core.precision`` policies (fp32, bf16, fp8 = e4m3, fp8_e5m2)
through the scaled paths of the three ops that have one: ``ops.gemm`` and
``ops.flash_attention`` (the scaled GEMM and scaled FA-2 kernels on the
card) and ``ops.decode_attention`` (the cache quantized per row, then the
split-KV decode kernel with the scales). Each row gives the call's wall time,
its GFLOP/s (the bench's operation counts), the card's bound for the same
work, and the numerics: ``max_err`` / ``rel_err`` (Frobenius) against the
fp32 oracle on the same operands, so the accuracy cost of each rung sits
next to its speed.

Operands are drawn fp32 with the bench's numpy calls and order from
``default_rng(seed)``. ``BENCH`` is the bench's own sizes; ``CARD`` is
occamy-gptj's full width (the MLP up-projection of a 2048-token prefill,
prefill attention at GPT-J's 2048-token context, decode over 4 slots).

    PYTHONPATH=src python -m repro_torch.launch.precision_ladder   # on the card
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import precision as prec
from repro_torch.device import resolve_device
from repro_torch.hopper import build, ops, ref
from repro_torch.launch import roofline

POLICY_NAMES = ("fp32", "bf16", "fp8", "fp8_e5m2")
# csrc/ sources the sweep launches
KERNELS = ("gemm_scaled", "flash_attention_scaled", "flash_decode")


@dataclasses.dataclass(frozen=True)
class Sizes:
    gemm: tuple[int, int, int]  # (m, k, n)
    fa: tuple[int, int, int, int, int]  # (B, H, K, S, D), causal
    decode: tuple[int, int, int, int, int]  # (B, H, K, S, D), position S - 1


BENCH = Sizes(gemm=(256, 256, 256), fa=(1, 4, 4, 128, 64), decode=(2, 4, 4, 256, 64))
CARD = Sizes(gemm=(2048, 4096, 16384), fa=(1, 16, 16, 2048, 256),
             decode=(4, 16, 16, 2048, 256))


@dataclasses.dataclass
class Case:
    """One op of the sweep: its fp32 operands, the bench's operation count
    and the operations its data needs (causal pairs only)."""

    op: str  # "gemm" | "flash_attention" | "decode_attention"
    operands: tuple
    flops: int  # the bench's count, for GFLOP/s
    work_ops: int  # what this data needs, for the bound


@dataclasses.dataclass
class Row:
    op: str
    policy: str
    wall_ms: float  # host clock around one warm call, ended by a device sync
    gflops: float  # ``flops`` / wall
    bound_ms: float
    bound_by: str  # "bytes" | "operations"
    max_err: float  # against the fp32 oracle on the same operands
    rel_err: float  # Frobenius, against the fp32 oracle
    out: torch.Tensor


def make_cases(sizes=BENCH, seed=0) -> list[Case]:
    """The three ops' fp32 operands on the host, drawn in the bench's order
    (a, b; q, k, v; decode q, k, v) from one ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    m, k, n = sizes.gemm
    a, b = draw(m, k), draw(k, n)
    B, H, K, S, D = sizes.fa
    q, kf, vf = draw(B, H, S, D), draw(B, K, S, D), draw(B, K, S, D)
    Bd, Hd, Kd, Sd, Dd = sizes.decode
    qd, kc, vc = draw(Bd, Hd, Dd), draw(Bd, Kd, Sd, Dd), draw(Bd, Kd, Sd, Dd)
    pos = torch.full((Bd,), Sd - 1, dtype=torch.long)
    return [
        Case("gemm", (a, b), 2 * m * k * n, 2 * m * k * n),
        Case("flash_attention", (q, kf, vf), 4 * B * H * S * S * D,
             4 * B * H * D * S * (S + 1) // 2),
        Case("decode_attention", (qd, kc, vc, pos), 4 * Bd * Hd * Sd * Dd,
             4 * Bd * Hd * Dd * Sd),
    ]


def oracle(case: Case) -> torch.Tensor:
    """The fp32 oracle of the case's op on its unquantized operands."""
    if case.op == "gemm":
        return ref.gemm_ref(*case.operands, torch.float32)
    if case.op == "flash_attention":
        return ref.mha_ref(*case.operands, causal=True)
    return ref.decode_attention_ref(*case.operands)


def call(case: Case, policy, impl=None):
    """The case's op under ``policy``."""
    if case.op == "gemm":
        return ops.gemm(*case.operands, precision=policy, impl=impl)
    if case.op == "flash_attention":
        return ops.flash_attention(*case.operands, causal=True, precision=policy, impl=impl)
    return ops.decode_attention(*case.operands, precision=policy, impl=impl)


def bound_ms(case: Case, policy) -> tuple[float, str]:
    """Least time for the call on an H100: the larger of its fp32 operands
    read once and its fp32 output written once over HBM bandwidth, and the
    operations its data needs over the policy's compute-dtype peak."""
    out_elems = {"gemm": case.operands[0].shape[0] * case.operands[1].shape[1],
                 "flash_attention": case.operands[0].numel(),
                 "decode_attention": case.operands[0].numel()}[case.op]
    nbytes = sum(x.numel() * x.element_size() for x in case.operands) + 4 * out_elems
    return roofline.bound_ms(case.work_ops, nbytes, prec.peak_flops(policy))


def errors(got, want) -> tuple[float, float]:
    """(max |got - want|, ||got - want|| / ||want||), in fp32."""
    diff = got.float() - want.float()
    rel = float(torch.linalg.vector_norm(diff) /
                torch.linalg.vector_norm(want.float()).clamp_min(1e-30))
    return float(diff.abs().max()), rel


@contextlib.contextmanager
def _full_fp32_matmul():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def run(*, device=None, seed=0, cases=None, impl=None) -> list[Row]:
    """Every case under every policy on ``device`` (default ``cuda``; raises
    without CUDA unless a device is given). ``cases`` default to
    ``make_cases(BENCH, seed)``; their operands move to the device and the
    kernels are built (each kernel module loads its own library at its
    first launch). Each op is called once untimed (paying its first-launch
    costs, the load included) before its timed call, whose output the errors
    are read from; the fp32 oracle runs with TF32 off."""
    device = resolve_device(device)
    cases = make_cases(BENCH, seed) if cases is None else cases
    cases = [dataclasses.replace(c, operands=tuple(x.to(device) for x in c.operands))
             for c in cases]
    if device.type == "cuda":
        build.build(KERNELS)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rows = []
    with torch.no_grad(), _full_fp32_matmul():
        for case in cases:
            want = oracle(case)
            for pol in POLICY_NAMES:
                call(case, pol, impl)
                sync()
                t = time.perf_counter()
                out = call(case, pol, impl)
                sync()
                wall = time.perf_counter() - t
                max_err, rel = errors(out, want)
                rows.append(Row(case.op, pol, wall * 1e3, case.flops / wall / 1e9,
                                *bound_ms(case, pol), max_err, rel, out))
            del want
    return rows


def main():
    print("name,us_per_call,derived")
    for r in run(cases=make_cases(CARD)):
        print(f"precision_{r.op}_{r.policy},{r.wall_ms * 1e3:.1f},"
              f"{r.gflops:.2f} GFLOP/s;bound={r.bound_ms * 1e3:.1f}us ({r.bound_by});"
              f"max_err={r.max_err:.2e};rel_err={r.rel_err:.2e}")


if __name__ == "__main__":
    main()
