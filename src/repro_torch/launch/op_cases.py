"""Representative operand shapes per partitioned op, at GPT-J / Fig. 9
scale (port of ``repro.launch.op_cases``).

One table for the op-roofline cells (``launch.shape_run --op-roofline``)
and for anything else that resolves the same cases against a production
mesh. Operands are ``meta`` tensors: ``hopper.partition.plan_for`` plans
from their shapes and dtypes, and nothing here touches a device.
"""
from __future__ import annotations

import numpy as np
import torch


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def op_roofline_cases() -> list[tuple]:
    """The case table, as ``(op, args, kwargs, flops, bytes)`` tuples: one
    case per op with a PartitionRule, the reference's shapes, dtypes and
    keywords, and its analytic per-call ``flops`` and ``bytes``, which a
    cell divides by the plan's device count."""
    bf2, f4 = 2, 4
    # GPT-J attention geometry at long context: Sq large enough that the
    # per-hop ring kernel outweighs the per-hop KV transfer
    B, H, K, Sq, D = 1, 16, 16, 32768, 128
    M = N = Kd = 4096  # dense GEMM
    R = C = 4096
    L = 32  # ELL nnz/row
    F = 128
    T, tbm, tbk = 512, 8, 128  # BSR tiles
    X = Y = Z = 128
    offs = np.array(
        [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
         (0, 0, 1), (0, 0, -1)], np.int32,
    )
    w = np.full((len(offs),), 1.0 / len(offs), np.float32)
    bf16, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    att = (_meta((B, H, Sq, D), bf16), _meta((B, K, Sq, D), bf16),
           _meta((B, K, Sq, D), bf16))
    la = tuple(_meta((B, H, Sq, 64), f32) for _ in range(4))
    return [
        ("gemm", (_meta((M, Kd), bf16), _meta((Kd, N), bf16)), {},
         2 * M * Kd * N, (M * Kd + Kd * N + M * N) * bf2),
        ("flash_attention", att, {},
         4 * B * H * Sq * Sq * D, (B * (H + 2 * K) * Sq * D * 2) * bf2),
        ("decode_attention",
         (_meta((8, H, D), bf16), _meta((8, K, Sq, D), bf16),
          _meta((8, K, Sq, D), bf16), _meta((8,), i32)), {},
         4 * 8 * H * Sq * D, 8 * 2 * K * Sq * D * bf2),
        ("linear_attention", la, {},
         4 * B * H * Sq * 64 * 64, 4 * B * H * Sq * 64 * f4),
        ("spmm", (_meta((R, L), f32), _meta((R, L), i32), _meta((C, F), f32)), {},
         2 * R * L * F, (2 * R * L + C * F + R * F) * f4),
        ("bsr_spmm", (_meta((T, tbm, tbk), f32), _meta((T,), i32),
                      _meta((T,), i32), _meta((Kd, 512), f32)),
         {"num_rows": R},
         2 * T * tbm * tbk * 512, (T * tbm * tbk + Kd * 512 + R * 512) * f4),
        ("spmspm", (_meta((R, L), f32), _meta((R, L), i32),
                    _meta((C, L), f32), _meta((C, L), i32)),
         {"contraction_dim": Kd},
         2 * R * C * L, (4 * R * L + R * C) * f4),
        ("stencil", (_meta((X, Y, Z), f32),),
         {"offsets": offs, "weights": w},
         2 * len(offs) * X * Y * Z, 2 * X * Y * Z * f4),
    ]
