"""Quickstart (port of ``examples/quickstart.py``): the Occamy programming
model on an H100, in four acts.

1. A dense GEMM through the hand-written kernel (``ops.gemm``), with the
   plan its planner picked and the bytes it must move. The reference's
   first act builds a ``StreamProgram``; the port's counterpart of that
   substrate is ``hopper/`` and ``csrc/``, so the act runs the kernel.
2. Indirect/sparse compute (Fig. 4b): SpMM with a value/index ELL matrix.
3. Multi-precision expanding accumulation (Fig. 10): fp32/bf16/fp8 GEMM.
4. Ten training steps of REDUCED occamy-gptj on the full stack.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import precision, sparse
from repro_torch.device import resolve_device
from repro_torch.hopper import ops, ref

H100_SMS = 132  # the planner's card where the act runs on the CPU


def act1_gemm(device) -> float:
    """ops.gemm of two fp32 256 x 256 operands; returns max |err| against
    the fp32 product."""
    from repro_torch.device import sm_count
    from repro_torch.hopper import gemm

    M = N = K = 256
    a = torch.from_numpy(np.random.default_rng(0).standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((K, N)).astype(np.float32))
    a, b = a.to(device), b.to(device)
    out = ops.gemm(a, b)
    err = float((out - ref.gemm_ref(a, b)).abs().max())
    sms = sm_count(device.index or 0) if device.type == "cuda" else H100_SMS
    q = gemm.plan_f32(M, N, K, sms, gemm.vec16(a, b))
    hbm = 4 * (M * K + K * N + M * N)
    print(f"[1] kernel GEMM  max|err| = {err:.2e}  (plan tm={q.tm} warps {q.wr}x{q.wc} "
          f"stages={q.stages} resident={q.resident} grid={q.grid} on {sms} SMs, "
          f"{hbm / 1e6:.1f} MB to move at least)")
    return err


def act2_sparse(device) -> float:
    rng = np.random.default_rng(0)
    A = sparse.random_ell(rng, 128, 256, density=0.05).to(device)
    D = torch.from_numpy(rng.standard_normal((256, 64)).astype(np.float32)).to(device)
    out = ops.spmm(A, D)  # EllMatrix operand
    err = float((out - A.todense() @ D).abs().max())
    print(f"[2] indirect-stream SpMM (density 5%)  max|err| = {err:.2e}")
    return err


def act3_precision(device) -> dict:
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32)).to(device)
    b = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32)).to(device)
    exact = ref.gemm_ref(a, b)
    rels = {}
    for pol in ("fp32", "bf16", "fp8"):
        out = precision.expanding_gemm(a, b, pol, impl="ref")
        rels[pol] = float(torch.linalg.norm(out.float() - exact) / torch.linalg.norm(exact))
        peak = precision.peak_flops(pol) / 1e12
        print(f"[3] {pol:8s} expanding-accum GEMM rel_err {rels[pol]:.1e} "
              f"(peak {peak:.0f} TFLOP/s/card)")
    return rels


def act4_train(device, initial_state=None) -> list[float]:
    """Ten steps of REDUCED occamy-gptj (B 4 x 64 tokens); ``initial_state``
    replaces the seeded one (tests carry the reference's). Returns the
    losses."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.runtime import train_loop

    cfg = get_config("occamy-gptj", reduced=True)
    _, losses, _ = train_loop.run_training(
        cfg, SHAPES["train_4k"], num_steps=10, batch_override=4, seq_override=64,
        log_every=5, device=device, initial_state=initial_state)
    print(f"[4] trained tiny GPT-J 10 steps: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="default cuda; cpu runs here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with torch.no_grad():
        out = {"gemm_err": act1_gemm(device), "spmm_err": act2_sparse(device),
               "precision_rel": act3_precision(device)}
    out["losses"] = act4_train(device)
    return out


if __name__ == "__main__":
    main()
