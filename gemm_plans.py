#!/usr/bin/env python3
"""Device time of every plan of the plain GEMM's bf16 wgmma route, on one
NVIDIA card.

    python3 gemm_plans.py

For each shape below (bf16 operands, fp32 out) and accumulator, times the
planner's pick (``repro_torch.hopper.gemm.plan_bf16``) and then every
feasible ``candidates_bf16`` plan, staged through
``dispatch.plan_override``, twice each, by device time (``chip_smoke``'s
``device_ms``: CUDA events around one replay of a CUDA graph of 20 calls).
Prints one line a plan and, last, ``PLANS {json}``. Imports nothing of JAX.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# (label, M, K, N, accumulator): the timed shape with each accumulator,
# the GCN's widths, the precision ladder's card GEMM and the checker's probe
SHAPES = (
    ("4096^3", 4096, 4096, 4096, "float32"),
    ("4096^3 accum bf16", 4096, 4096, 4096, "bfloat16"),
    ("4096^3 accum fp16", 4096, 4096, 4096, "float16"),
    ("gcn 3327", 3327, 144, 144, "float32"),
    ("gcn ogbn-arxiv", 169343, 144, 144, "float32"),
    ("ladder 2048x4096x16384", 2048, 4096, 16384, "float32"),
    ("probe 128x4096x128", 128, 4096, 128, "float32"),
)


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    if not torch.cuda.is_available():
        print("gemm_plans: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.device import sm_count
    from repro_torch.hopper import dispatch, gemm, ops

    print(smoke.card_line())
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = sm_count(0)
    out = {}
    for label, M, K, N, acc in SHAPES:
        a = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
        b = torch.randn((K, N), generator=gen, device="cuda").to(torch.bfloat16)
        adt = getattr(torch, acc)
        narrow = adt != torch.float32
        fn = lambda: ops.gemm(a, b, impl="cuda", out_dtype=torch.float32, accum_dtype=adt)  # noqa: E731
        pick = gemm.plan_bf16(M, N, K, gemm.rows16(a, b), sms, narrow)
        rows = {"pick": dict(bn=pick.bn, stages=pick.stages, grid=pick.grid, ms=smoke.device_ms(fn))}
        print(f"{label}: the model's pick bn {pick.bn} stages {pick.stages} grid {pick.grid}: "
              f"{rows['pick']['ms']:.5f} ms")
        for c in gemm.candidates_bf16(M, N, K, gemm.rows16(a, b), sms, narrow):
            if not c.feasible:
                continue
            key = ("bf16", M, N, K, gemm.rows16(a, b), sms, narrow)
            with dispatch.plan_override("gemm", key, c.plan):
                t = [smoke.device_ms(fn), smoke.device_ms(fn)]
            rows[f"bn{c.plan.bn}/s{c.plan.stages}"] = dict(ms=t, model_cost=c.cost)
            print(f"  bn {c.plan.bn} stages {c.plan.stages} (model cost {c.cost:.3f}): "
                  f"{min(t):.5f} ms {t}")
        out[label] = rows
        del a, b
        torch.cuda.empty_cache()
    print("PLANS " + json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
