#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. build every Hopper kernel from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together) and print ptxas's registers, shared
     memory and spills (every instantiation of the redesigned kernels);
     check in the scaled libraries' disassembly that every wgmma-route
     kernel issues the warpgroup MMA (HGMMA, QGMMA for fp8) and no other
     kernel does;
  2. hold each kernel against its plain version on the card: the FA kernel
     at the shapes the serving path gives it (bf16, full width), at every
     bf16 head dim with GQA, window, q_offset, ragged Sk and return_lse,
     on zigzag half views, at grids of more 64-row tiles than SMs (its
     two-warpgroup CTAs), and at small fp32 shapes; the GEMM at the GCN shapes and at ragged fp32/bf16 ones;
     the ELL SpMM at the GCN adjacencies and at wider random ELL matrices;
     the scaled GEMM and scaled FA-2 (phase 5's kernels) at their shapes,
     the GEMM through each of its three routes (wgmma, ffma, mma) and the
     fp8 wgmma route at both promotion intervals it offers;
  3. run the GCN path (``repro_torch.launch.gcn_inference.run``): two
     144-wide layers over the paper's three graphs and one graph of
     ogbn-arxiv's size, with the launch counts zeroed just before and read
     just after; each output is held to the plain path and, on the three
     small graphs, to the dense oracle;
  4. run the sparse-LA path (``repro_torch.launch.sparse_la.run``, the
     paper's Fig. 9b-d at card size): BSR SpMM, SpMSpM and stencil first
     held against their plain versions on the card (small ragged shapes;
     BSR at bm 8 / 16 / 3, bk 128 / 20, F 256 / 300 with every pair of
     tile and dense types and unsorted, repeated tiles; SpMSpM at R = 1, a
     ragged C, C past one 4096-column tile, La = 0, Lb = 0, duplicates,
     padding and out-of-range indices, K = 40000, every pair of value
     types, a repeated call bitwise equal, and its planner's card tile and
     scratch sizes against the kernel's; every card-size
     case, BSR also with bf16 tiles and dense), then the entry point once with the launch
     counts zeroed just before and read just after (stencil 5, ELL SpMM 3,
     BSR SpMM 3, SpMSpM 3), each output held to the plain path, each case
     profiled warm;
  5. run the precision ladder (``repro_torch.launch.precision_ladder.run``,
     the paper's Fig. 10, at occamy-gptj's full width): the scaled GEMM and
     scaled FA-2 kernels first held against their plain versions on the
     same quantized operands for every policy (fp32, bf16, fp8 e4m3, fp8
     e5m2) at ragged shapes, and the ops against the fp32 oracle; then the
     entry point once with the launch counts zeroed just before and read
     just after (gemm_scaled 8, flash_attention_scaled 8), each row within
     the reference's tolerance of the fp32 oracle and the errors ordered
     as the ladder;
  6. build ``occamy-gptj`` (GPT-J-6B) at full width with random weights
     from a seeded ``torch.Generator``, on the card;
  7. serve a few requests through ``ServingEngine.with_model`` over the
     paged KV cache, with a pool tight enough to preempt; the kernels'
     launch counts are zeroed just before and read just after; then serve
     the same requests again with fp8 KV pools (``precision="fp8"``);
  8. check the runs (all requests complete, no leaked blocks, one FA launch
     per layer per prefill, a prefill's logits with the kernel vs with the
     plain version; the fp8 run's preemptions and first tokens equal the
     bf16 run's);
  9. with GPT-J's weights freed, the recurrent families: the chunked
     linear-attention kernel first held against its plain version (the
     reference suite's fp32 cases, both read-outs, chunk 16 and 32; edge
     shapes: T of 0, 1 and 33, chunk 1 and 34, N of 5 and 128, ragged
     64-column blocks; both models' card shapes in bf16, with a ragged T
     and hymba's broadcast inputs), then ``rwkv6-3b`` and ``hymba-1.5b`` at full width and depth
     with random weights: ``registry.forward`` and ``loss_fn`` on
     B x 2048 tokens (launch counts zeroed just before and read just
     after: linear_attention 32, and flash_attention 32 for hymba),
     ``launch.serve.generate`` (no linear_attention launch: decode runs the
     step), for rwkv6 layer 0's scan against 2048 decode steps, and a
     profile of a warm forward; rwkv6's card-shape o is held against the
     fp64 per-token oracle on b = 0, heads 0-7, and on the (b, head) of
     the tensor's worst bf16 entry, with that entry's values, its fp64
     terms and each form's miss in fp32 spacings of the largest printed;
  10. the sequence-parallel ring at occamy-gptj's attention width on a
     ``RingMesh`` of 4 ranks (one stream each, on one card or one card
     each): the ring-hop kernel (``remote_ring_hop``'s port) held bitwise
     to ``copy_`` at byte-odd sizes and offsets, and the flash ring in fp32
     to the unsharded FA kernel at S=2048 and 16384; then
     ``repro_torch.launch.ring_attention.run`` once with the launch counts
     zeroed just before and read just after (the Fig. 13b hop sweep,
     timed cold and warm; ``ops.flash_attention(mesh=, remote_copy=)`` at
     S=2048 and 16384, zigzag, contiguous and window 512, overlap on and
     off, remote_copy on and off, and a B=4 batch split, then timed; ring
     decode with bf16 and fp8 pools): each call's launches equal its
     plan's (zigzag 24 ring_hop + 28 FA, contiguous 24 + 16, window
     8 + 8) and the run's totals the per-call launches times the calls
     made, the outputs bitwise invariant to overlap and remote_copy and
     within 1e-2 (Frobenius) and four bf16 steps (elementwise) of the
     unsharded kernel, the ring with its last hop left out beyond 1e-2,
     ring decode bitwise ``ring_decode_reference``; then profiles of a
     warm ring call;
  11. time every kernel against its plain version, the library call and
     its bound (CUDA events over back-to-back calls); the FA, BSR, SpMSpM,
     stencil, scan and both scaled kernels and their library calls also by
     device time (events around a CUDA graph's replay of 20 calls, which
     the host's issue does not set), and the FA wrapper's host time per
     call; the scan at both card shapes with each of its three launches'
     share of the call from a profile. The scaled kernels at the ladder's card shapes under every
     policy, each asserted to take its route (wgmma at bf16 and fp8, ffma
     at fp32), beside ``torch.matmul`` and SDPA on the values at bf16 and
     fp32, where unit scales make them the same function.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the reference package.
"""
from __future__ import annotations

import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9  # one way, card to card
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "float8_e4m3fn": 1979e12,
            "float8_e5m2": 1979e12}

# the serving run: requests, pool and slots (full-width occamy-gptj)
SEED = 0
N_REQUESTS = 6
PROMPT_LENS = (100, 500)
NEW_TOKENS = 16
SLOTS = 4
BLOCK_SIZE = 16
MAX_BLOCKS_PER_SEQ = 33  # ceil((500 + 16) / 16)
NUM_BLOCKS = 56  # tight: this workload preempts twice (checked below)

# the sources whose every ptxas line (registers, shared memory, spills)
# the build step prints
REDESIGNED = ("flash_attention", "bsr_spmm", "linear_attention", "gemm", "ring_hop", "gemm_scaled",
              "flash_attention_scaled", "spmspm")
FA_REPLACES = "src/repro/kernels/flash_attention.py:57"
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
GEMM_REPLACES = "src/repro/kernels/gemm.py:23"
GEMM_SOURCE = "src/repro_torch/csrc/gemm.cu"
SPMM_REPLACES = "src/repro/kernels/spmm.py:38"
SPMM_SOURCE = "src/repro_torch/csrc/spmm.cu"

# A graph of ogbn-arxiv's public size (Open Graph Benchmark: 169,343 nodes,
# 1,166,243 edges, mean undirected degree ~13.7, so 15 ELL slots with the
# self loop), built like the paper's graphs; nothing is downloaded.
OGBN_ARXIV = ("ogbn-arxiv-size", 169343, 13.7)


class SmokeFailure(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=20):
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Device time of one call of ``fn``, which the host's issue does not
    set: CUDA events around one replay of a CUDA graph of ``iters`` calls
    (captured after a warm-up call, replayed once untimed), divided by
    ``iters``. Every kernel the call launches counts, with the device's
    own gaps between them. None (printed "not measured") where the call
    cannot be captured."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"device time: the call could not be captured in a CUDA graph ({str(e)[:200]})")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def _ms(x):
    return "not measured" if x is None else f"{x:.5f} ms"


def _in_turns(kernel, plain, plain_iters):
    """plain, kernel, kernel, plain: two turns of each, in one call."""
    p = [time_ms(plain, plain_iters)]
    k = [time_ms(kernel), time_ms(kernel)]
    p.append(time_ms(plain, plain_iters))
    return k, p


def fa_bound_ms(B, H, K, Sq, Sk, D, dtype_name, *, causal, window=0,
                q_offset=0):
    """Least time for one FA-2 forward on an H100: the larger of its bytes
    (q, k, v read once, o written once) over HBM bandwidth and its matrix
    operations (2 * 2 * D per unmasked (q, k) pair) over the type's peak."""
    import numpy as np

    esize = 2 if dtype_name == "bfloat16" else 4
    nbytes = esize * D * (2 * B * H * Sq + 2 * B * K * Sk)
    q_pos = np.arange(Sq)[:, None] + q_offset
    k_pos = np.arange(Sk)[None, :]
    mask = np.ones((Sq, Sk), bool)
    if causal or window:
        mask &= k_pos <= q_pos
    if window:
        mask &= k_pos > q_pos - window
    ops = 4 * B * H * D * int(mask.sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels vs plain versions
# ---------------------------------------------------------------------------

# (label, B, H, K, Sq, Sk, D, dtype, causal, window, q_offset, return_lse,
# half): `half` takes q, k, v as the second half of tensors twice as long
# along S, as the zigzag ring hands the kernel its halves
FA_CASES = [
    ("prefill S=208 bf16", 1, 16, 16, 208, 208, 256, "bfloat16", True, 0, 0, False, False),
    ("prefill S=512 bf16", 1, 16, 16, 512, 512, 256, "bfloat16", True, 0, 0, False, False),
    ("gqa causal lse f32", 2, 8, 2, 100, 100, 64, "float32", True, 0, 0, True, False),
    ("window non-causal f32", 1, 4, 4, 130, 130, 32, "float32", False, 17, 0, True, False),
    ("q_offset ragged Sk f32", 2, 4, 1, 37, 101, 16, "float32", True, 0, 64, True, False),
    ("non-causal ragged f32", 1, 2, 2, 45, 77, 128, "float32", False, 0, 0, True, False),
    ("window+q_offset bf16 lse", 1, 4, 2, 70, 150, 256, "bfloat16", True, 40, 80, True, False),
    ("gqa ragged bf16 D=64", 2, 8, 2, 100, 130, 64, "bfloat16", True, 0, 0, True, False),
    ("window non-causal bf16 D=128", 1, 4, 4, 77, 77, 128, "bfloat16", False, 20, 0, True, False),
    ("q_offset bf16 D=16", 1, 2, 1, 37, 101, 16, "bfloat16", True, 0, 64, True, False),
    ("non-causal bf16 D=32", 2, 2, 2, 45, 70, 32, "bfloat16", False, 0, 0, True, False),
    # every bf16 head dim with GQA, a window, q_offset, ragged Sk and lse
    ("gqa window q_offset bf16 D=16", 2, 4, 2, 90, 150, 16, "bfloat16", True, 33, 60, True, False),
    ("gqa window q_offset bf16 D=32", 1, 8, 2, 129, 190, 32, "bfloat16", True, 50, 61, True, False),
    ("gqa window q_offset bf16 D=64", 1, 4, 2, 100, 164, 64, "bfloat16", True, 70, 64, True, False),
    ("gqa q_offset ragged bf16 D=128", 2, 8, 4, 75, 203, 128, "bfloat16", True, 0, 128, True, False),
    ("gqa non-causal ragged bf16 D=256", 1, 8, 2, 33, 97, 256, "bfloat16", False, 0, 0, True, False),
    # zigzag halves: the diagonal block and a block wholly in the past
    ("zigzag half diagonal bf16 D=256", 1, 4, 4, 320, 320, 256, "bfloat16", True, 0, 0, True, True),
    ("zigzag half past bf16 D=128", 1, 4, 2, 192, 256, 128, "bfloat16", True, 0, 256, True, True),
    # grids of more 64-row tiles than the card has SMs: two warpgroups a CTA
    ("ring block S=2048 bf16 D=256", 1, 16, 16, 2048, 2048, 256, "bfloat16", True, 0, 0, True, False),
    ("long gqa window q_offset ragged bf16 D=128", 2, 8, 2, 600, 777, 128, "bfloat16", True, 300, 150,
     True, False),
    ("long causal bf16 D=16", 2, 8, 8, 700, 700, 16, "bfloat16", True, 0, 0, True, False),
    ("long non-causal gqa ragged bf16 D=32", 1, 16, 4, 555, 800, 32, "bfloat16", False, 0, 0, True,
     False),
    ("long window gqa bf16 D=64", 2, 8, 2, 640, 640, 64, "bfloat16", True, 100, 0, True, False),
]
# |kernel - plain| <= ATOL + RTOL * |plain|. fp32: both sum in fp32 in
# different orders (the reference suite's 1e-4). bf16: both round an fp32
# result to bf16 (8-bit mantissa), so they may differ by one bf16 step.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = (1e-4, 1e-4)


def _fa_inputs(case, gen, *, transposed):
    import torch

    _, B, H, K, Sq, Sk, D, dt, *_, half = case
    dtype = getattr(torch, dt)

    def make(heads, S):
        # the transformer hands the kernel (B, S, H, D) -> (B, H, S, D) views
        n = 2 * S if half else S
        shape = (B, n, heads, D) if transposed else (B, heads, n, D)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        x = x.transpose(1, 2) if transposed else x
        return x[:, :, S:] if half else x

    return make(H, Sq), make(K, Sk), make(K, Sk)


def check_kernels(report):
    """Phase 2: every case through the kernel and the plain version on the
    same inputs; record errors against the stated tolerances."""
    import torch

    from repro_torch.hopper import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for case in FA_CASES:
        label, B, H, K, Sq, Sk, D, dt, causal, window, q_offset, lse, _ = case
        for transposed in (False, True):
            q, k, v = _fa_inputs(case, gen, transposed=transposed)
            kw = dict(causal=causal, window=window, q_offset=q_offset,
                      return_lse=lse)
            got = ops.flash_attention(q, k, v, impl="cuda", **kw)
            want = ops.flash_attention(q, k, v, impl="torch", **kw)
            torch.cuda.synchronize()
            if not lse:
                got, want = (got,), (want,)
            atol, rtol = TOL[dt]
            errs = []
            for i, (g, w) in enumerate(zip(got, want)):
                a, r = (atol, rtol) if i == 0 else LSE_TOL
                g, w = g.float(), w.float()
                need(bool(torch.isfinite(g).all()), f"{label}: non-finite kernel output")
                err = (g - w).abs()
                max_abs = float(err.max())
                max_rel = float((err / w.abs().clamp_min(1e-6)).max())
                ok = bool((err <= a + r * w.abs()).all())
                errs.append(max_abs)
                print(f"kernel flash_attention [{label}{' view' if transposed else ''}]"
                      f" {'o' if i == 0 else 'lse'}: max_abs={max_abs:.3e} "
                      f"max_rel={max_rel:.3e} tol=atol {a:g} + rtol {r:g}"
                      f" {'ok' if ok else 'FAIL'}")
                need(ok, f"flash_attention kernel disagrees with plain version: {label}")
            report.setdefault("fa_err", {})[label] = max(
                report.get("fa_err", {}).get(label, 0.0), errs[0]
            )


def time_kernels(report):
    """Kernel, plain version and library call at the main path's largest
    prefill shape (S=512 bucket, bf16); the other shapes are printed.
    Beside the CUDA events' time of back-to-back calls (which the host's
    issue sets when a call's device time is below the wrapper's host
    cost), the device time of the kernel and of the library call
    (``device_ms``), and the wrapper's host time per call."""
    import torch
    import torch.nn.functional as F

    from repro_torch.hopper import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for case in FA_CASES[:2]:
        label, B, H, K, Sq, Sk, D, dt, causal, window, q_offset, *_ = case
        q, k, v = _fa_inputs(case, gen, transposed=True)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        kern_fn = lambda: ops.flash_attention(q, k, v, impl="cuda", **kw)
        lib_fn = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        kern, plain = _in_turns(kern_fn, lambda: ops.flash_attention(q, k, v, impl="torch", **kw), 20)
        lib = time_ms(lib_fn)
        dev, lib_dev = device_ms(kern_fn), device_ms(lib_fn)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(50):
            kern_fn()
        host = (time.perf_counter() - t) / 50 * 1e3
        torch.cuda.synchronize()
        bound, by = fa_bound_ms(B, H, K, Sq, Sk, D, dt, causal=causal)
        row = dict(shape=f"B={B} H={H} K={K} S={Sq} D={D} {dt} causal",
                   ms=min(kern), plain_ms=min(plain), library_ms=lib,
                   bound_ms=bound, bound_by=by, device_ms=dev, library_device_ms=lib_dev,
                   host_ms=host)
        print(f"time flash_attention [{label}]: kernel {kern} ms, plain {plain} ms, "
              f"sdpa {lib:.4f} ms (events, back to back); device time kernel {_ms(dev)}, "
              f"sdpa {_ms(lib_dev)}; the wrapper's host time per call {host:.5f} ms "
              f"(ops.flash_attention, 50 calls); bound {bound:.5f} ms ({by})")
        report.setdefault("fa_time", {})[label] = row


# ---------------------------------------------------------------------------
# phases 2-3: the GCN path's kernels (GEMM, ELL SpMM), then the GCN path
# ---------------------------------------------------------------------------

# (label, M, K, N, input dtype, output dtype); the GCN shapes are added
# from the graphs in check_gcn_kernels
GEMM_CASES = [
    ("ragged f32", 100, 70, 130, "float32", "float32"),
    ("ragged odd f32", 257, 129, 65, "float32", "float32"),
    ("ragged bf16", 100, 70, 130, "bfloat16", "bfloat16"),
    ("ragged odd bf16 -> f32", 257, 129, 65, "bfloat16", "float32"),
    ("gcn width bf16 -> f32", 3327, 144, 144, "bfloat16", "float32"),
    ("gcn width bf16 -> bf16", 2708, 144, 144, "bfloat16", "bfloat16"),
    ("f32 -> bf16", 300, 64, 96, "float32", "bfloat16"),
]
# Drawn with B / sqrt(K), so that C is of unit scale as the GCN's layers
# give it: B's (2048, 1024) panel is far above the shared memory, so the
# kernel streams it. With unit-variance B at K = 2048 the sums reach ~200,
# and any two fp32 orders of them differ by a few 1e-4 (3.8e-4 measured,
# kernel against torch.matmul), which GEMM_TOL's absolute 1e-4 does not
# leave room for; at unit scale it does, at the same tolerance.
GEMM_CASES_UNIT_SCALE = [
    ("f32 K x N past the shared memory", 1000, 2048, 1024, "float32", "float32"),
]
# |kernel - plain| <= ATOL + RTOL * |plain|, by output dtype. fp32 out: both
# sum exact fp32 (or bf16) products in fp32, in different K orders (the
# reference suite's 1e-4). bf16 out: both round an fp32 sum to bf16, so
# they may differ by one bf16 step.
GEMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}

# (label, rows, cols, density, F, values dtype, dense dtype); the GCN
# adjacencies are added from the graphs in check_gcn_kernels
SPMM_CASES = [
    ("random L=41 f32", 4096, 4096, 0.01, 144, "float32", "float32"),
    ("random L=41 bf16", 4096, 4096, 0.01, 144, "bfloat16", "bfloat16"),
    ("random L=41 f32 values bf16 dense", 4096, 4096, 0.01, 144, "float32", "bfloat16"),
    ("random L=25 F=300", 1000, 500, 0.05, 300, "float32", "float32"),
    ("random L=64 F=40", 333, 1280, 0.05, 40, "float32", "float32"),
]
# by output (dense) dtype. fp32: kernel and plain version add the slots in
# the same order with the same roundings (the reference suite's 1e-5 is
# stated; they agree bitwise). bf16: one bf16 step of the rounded sum.
SPMM_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}

# GCN outputs against the plain path and the dense oracle: max |diff| over
# max |reference|; only the summation order differs, in fp32
GCN_REL_TOL = 1e-4
DENSE_ORACLE_MAX_NODES = 5000  # the (n, n) dense adjacency of the small graphs


def _hold(name, label, got, want, tol):
    """Kernel output against the plain version's, elementwise, within
    ``tol`` = (atol, rtol); returns the largest absolute difference."""
    import torch

    atol, rtol = tol
    g, w = got.float(), want.float()
    need(bool(torch.isfinite(g).all()), f"{name} [{label}]: non-finite kernel output")
    need(g.shape == w.shape, f"{name} [{label}]: shape {tuple(g.shape)} != {tuple(w.shape)}")
    err = (g - w).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    ok = bool((err <= atol + rtol * w.abs()).all())
    print(f"kernel {name} [{label}]: max_abs={max_abs:.3e} tol=atol {atol:g} + rtol {rtol:g}"
          f" {'ok' if ok else 'FAIL'}")
    need(ok, f"{name} kernel disagrees with plain version: {label}")
    return max_abs


def _gcn_graphs():
    from repro_torch.launch import gcn_inference as gi

    return (*gi.GRAPHS, OGBN_ARXIV)


def check_gcn_kernels(report):
    """Phase 2 for the GCN path: GEMM and ELL SpMM through the kernel and
    the plain version on the same inputs, at the GCN path's shapes and at
    ragged and wider ones."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import sparse
    from repro_torch.hopper import ops
    from repro_torch.launch import gcn_inference as gi

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    F = gi.FEATURES
    gemm_cases = [(f"gcn {name}", n, F, F, "float32", "float32")
                  for name, n, _ in _gcn_graphs()] + GEMM_CASES + GEMM_CASES_UNIT_SCALE
    errs = []
    for label, M, K, N, dt, odt in gemm_cases:
        a = torch.randn((M, K), generator=gen, device="cuda").to(getattr(torch, dt))
        b = torch.randn((K, N), generator=gen, device="cuda")
        if (label, M, K, N, dt, odt) in GEMM_CASES_UNIT_SCALE:
            b /= math.sqrt(K)
        b = b.to(getattr(torch, dt))
        kw = dict(out_dtype=getattr(torch, odt))
        got = ops.gemm(a, b, impl="cuda", **kw)
        want = ops.gemm(a, b, impl="torch", **kw)
        torch.cuda.synchronize()
        errs.append(_hold("gemm", f"{label} ({M},{K})x({K},{N})", got, want, GEMM_TOL[odt]))
    # a row slice of a wider matrix: row stride != K, no copy
    wide = torch.randn((500, 200), generator=gen, device="cuda")
    a, b = wide[:, 30:174], torch.randn((F, F), generator=gen, device="cuda")
    errs.append(_hold("gemm", "strided rows f32", ops.gemm(a, b, impl="cuda"),
                      ops.gemm(a, b, impl="torch"), GEMM_TOL["float32"]))
    report["gemm_err"] = max(errs)

    rng = np.random.default_rng(SEED + 2)
    errs = []
    for name, n, deg in _gcn_graphs():
        adj = gi.adjacency(rng, n, deg).to("cuda")
        dense = torch.randn((n, F), generator=gen, device="cuda")
        got = ops.spmm(adj, dense, impl="cuda")
        want = ops.spmm(adj, dense, impl="torch")
        torch.cuda.synchronize()
        label = f"gcn {name} ({n},{adj.values.shape[1]})x({n},{F})"
        errs.append(_hold("spmm", label, got, want, SPMM_TOL["float32"]))
    for label, R, C, density, Fd, vdt, ddt in SPMM_CASES:
        A = sparse.random_ell(rng, R, C, density)
        values = A.values.to("cuda", getattr(torch, vdt))
        cols = A.cols.to("cuda")
        dense = torch.randn((C, Fd), generator=gen, device="cuda").to(getattr(torch, ddt))
        got = ops.spmm(values, cols, dense, impl="cuda")
        want = ops.spmm(values, cols, dense, impl="torch")
        torch.cuda.synchronize()
        errs.append(_hold("spmm", f"{label} ({R},{values.shape[1]})x({C},{Fd})", got, want,
                          SPMM_TOL[ddt]))
    report["spmm_err"] = max(errs)


def _rel(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def gcn_phase(report):
    """Phase 3: the GCN path through its entry point, on the card; launch
    counts zeroed just before and read just after; outputs held to the
    plain path and (small graphs) the dense oracle."""
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.launch import gcn_inference as gi
    from repro_torch.models import gcn

    graphs = _gcn_graphs()
    params = gcn.init_params([gi.FEATURES] * (gi.LAYERS + 1), seed=SEED, device="cuda")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    runs = gi.run(device="cuda", seed=SEED, graphs=graphs, params=params)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    expected = gi.LAYERS * len(runs)
    print(f"gcn: {len(runs)} forwards x {gi.LAYERS} layers, {gi.FEATURES} features; kernel "
          f"launches during the run: {launches}; expected gemm = spmm = {expected}")
    need(launches == {"gemm": expected, "spmm": expected},
         "GCN launch counts != layers x forwards for each of gemm and spmm")

    for r in runs:
        n = r.adj.shape[0]
        need(tuple(r.out.shape) == (n, gi.FEATURES), f"gcn {r.name}: shape {tuple(r.out.shape)}")
        need(bool(torch.isfinite(r.out).all()), f"gcn {r.name}: non-finite output")
        with torch.no_grad(), dispatch.default_impl("torch"):
            plain = gcn.forward(params, r.adj, r.feats)
        rel_plain = _rel(r.out, plain)
        need(rel_plain <= GCN_REL_TOL, f"gcn {r.name}: kernel path vs plain path rel {rel_plain:.3e}")
        oracle = "dense oracle not run (n > %d)" % DENSE_ORACLE_MAX_NODES
        if n <= DENSE_ORACLE_MAX_NODES:
            a, h = r.adj.todense(), r.feats
            for i, w in enumerate(params):
                h = a @ (h @ w)
                if i < len(params) - 1:
                    h = torch.relu(h)
            rel_dense = _rel(r.out, h)
            need(rel_dense <= GCN_REL_TOL, f"gcn {r.name}: kernel path vs dense oracle rel {rel_dense:.3e}")
            oracle = f"vs dense oracle rel {rel_dense:.3e}"
        print(f"gcn {r.name}: n={n} L={r.adj.values.shape[1]} nnz={r.adj.nnz} out "
              f"{tuple(r.out.shape)} finite; vs plain path rel {rel_plain:.3e}, {oracle} "
              f"(tol rel {GCN_REL_TOL:g}); forward wall {r.forward_ms:.3f} ms in the run")

        def forward(r=r):
            with torch.no_grad():
                gcn.forward(params, r.adj, r.feats)

        profile_fn(f"gcn forward {r.name}", forward, report)
    report["gcn_launches"] = launches


def gemm_bound_ms(M, K, N, dt, odt):
    """Least time for C (M, N) = A (M, K) . B (K, N) on an H100: the larger
    of A and B read once and C written once over HBM bandwidth, and 2MNK
    operations over the input type's peak."""
    esize = {"float32": 4, "bfloat16": 2}
    nbytes = (M * K + K * N) * esize[dt] + M * N * esize[odt]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * M * N * K / PEAK_OPS[dt] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def spmm_bound_ms(adj, dense):
    """Least time for the ELL product on an H100: the larger of values and
    cols read once, dense read once and out written once over HBM
    bandwidth, and 2 * nnz * F operations (this matrix's nonzeros) over the
    fp32 peak."""
    R, L = adj.values.shape
    C, F = dense.shape
    nbytes = (R * L * (adj.values.element_size() + adj.cols.element_size())
              + (C + R) * F * dense.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * adj.nnz * F / PEAK_OPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def time_gcn_kernels(report):
    """GEMM and ELL SpMM at the GCN path's shapes on cora and on the graph of
    ogbn-arxiv's size (fp32, 144 features): kernel, plain version, the
    library call (``torch.matmul``; ``torch.sparse.mm`` on a CSR tensor
    built outside the timed window) and the bound."""
    import math

    import numpy as np
    import torch

    from repro_torch.core import sparse
    from repro_torch.hopper import ops
    from repro_torch.launch import gcn_inference as gi

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rng = np.random.default_rng(SEED + 3)
    F = gi.FEATURES
    cora = next(g for g in gi.GRAPHS if g[0] == "cora")
    for name, n, deg in (cora, OGBN_ARXIV):
        plain_iters = 2 if n > 10000 else 10  # the plain SpMM is a Python loop of small ops
        a = torch.randn((n, F), generator=gen, device="cuda")
        w = torch.randn((F, F), generator=gen, device="cuda") / math.sqrt(F)
        kern_fn, lib_fn = lambda: ops.gemm(a, w, impl="cuda"), lambda: torch.matmul(a, w)
        kern, plain = _in_turns(kern_fn, lambda: ops.gemm(a, w, impl="torch"), 20)
        lib = time_ms(lib_fn)
        dev = [device_ms(kern_fn), device_ms(lib_fn), device_ms(lib_fn), device_ms(kern_fn)]
        bound, by = gemm_bound_ms(n, F, F, "float32", "float32")
        report.setdefault("gemm_time", {})[name] = dict(
            shape=f"({n},{F})x({F},{F}) float32", ms=min(kern), plain_ms=min(plain),
            library_ms=lib, bound_ms=bound, bound_by=by, device_ms=min(dev[0], dev[3]),
            library_device_ms=min(dev[1], dev[2]))
        print(f"time gemm [{name} ({n},{F})x({F},{F}) f32]: kernel {kern} ms, plain {plain} ms, "
              f"torch.matmul {lib:.4f} ms (events, back to back); device time in turns kernel "
              f"{_ms(dev[0])}, {_ms(dev[3])}, torch.matmul {_ms(dev[1])}, {_ms(dev[2])}; bound "
              f"{bound:.5f} ms ({by}); {2 * n * F * F / min(dev[0], dev[3]) / 1e9:.1f} TFLOP/s "
              f"at the kernel's device time")

        adj = gi.adjacency(rng, n, deg).to("cuda")
        dense = torch.randn((n, F), generator=gen, device="cuda")
        csr = sparse.ell_to_csr(adj)
        lib_a = torch.sparse_csr_tensor(
            csr.indptr.long().cuda(), csr.indices.long().cuda(), csr.data.cuda(),
            size=adj.shape)
        kern, plain = _in_turns(lambda: ops.spmm(adj, dense, impl="cuda"),
                                lambda: ops.spmm(adj, dense, impl="torch"), plain_iters)
        lib = time_ms(lambda: torch.sparse.mm(lib_a, dense))
        lib_err = float((torch.sparse.mm(lib_a, dense) - ops.spmm(adj, dense)).abs().max())
        bound, by = spmm_bound_ms(adj, dense)
        L = adj.values.shape[1]
        report.setdefault("spmm_time", {})[name] = dict(
            shape=f"ELL ({n},{L}) nnz={adj.nnz} x ({n},{F}) float32", ms=min(kern),
            plain_ms=min(plain), library_ms=lib, bound_ms=bound, bound_by=by)
        print(f"time spmm [{name} ELL ({n},{L}) x ({n},{F}) f32]: kernel {kern} ms, plain "
              f"{plain} ms, torch.sparse.mm (CSR) {lib:.4f} ms (max |diff| vs kernel "
              f"{lib_err:.2e}), bound {bound:.5f} ms ({by})")


# ---------------------------------------------------------------------------
# the sparse-LA path (paper Fig. 9b-d): BSR SpMM, SpMSpM, stencil
# ---------------------------------------------------------------------------

# |kernel - plain| <= ATOL + RTOL * |plain|. BSR and SpMSpM: both sum fp32
# products in fp32 in different orders (the reference suite's 1e-4,
# tests/test_kernels.py). Stencil: kernel and plain version add the points
# in the same order with the same roundings, so they must agree bitwise.
SPARSE_TOL = (1e-4, 1e-4)
STENCIL_TOL = (0.0, 0.0)
SPARSE_LA_REL_TOL = 1e-4  # each sparse_la output vs the plain path, max|diff| / max|plain|
# per run: each case's op once warm-up and once timed
SPARSE_LA_LAUNCHES = {"stencil": 2 * 5, "spmm": 2 * 3, "bsr_spmm": 2 * 3, "spmspm": 2 * 3}


def _sparse_la_cases():
    """The entry point's card-size cases, built on the host and moved to
    the card once (outside every timed window)."""
    from repro_torch.launch import sparse_la as sl

    t = time.perf_counter()
    cases = sl.make_cases(SEED, sl.CARD)
    t_host = time.perf_counter() - t
    cases = sl.cases_to(cases, "cuda")
    print(f"sparse_la: {len(cases)} card-size cases built in {t_host:.1f} s on the host, "
          f"moved to the card in {time.perf_counter() - t - t_host:.1f} s")
    return cases


def _call(case, impl):
    from repro_torch.hopper import ops

    return getattr(ops, case.op)(*case.args, impl=impl)


def _random_ell_dups(rng, rows, width, slots):
    """ELL rows with indices drawn with replacement (duplicates in a row)."""
    import torch

    from repro_torch.core import sparse

    cols = rng.integers(0, width, (rows, slots)).astype("int32")
    vals = rng.standard_normal((rows, slots)).astype("float32")
    vals[:, -1] = 0  # an ELL padding slot: value 0 at column 0
    cols[:, -1] = 0
    return sparse.EllMatrix(torch.from_numpy(vals), torch.from_numpy(cols), (rows, width))


def check_sparse_la_kernels(report, cases):
    """Phase 2 for the sparse-LA path: each new kernel against its plain
    version on the card, at small ragged shapes (an F not a multiple of
    the kernel's 256-column slice, a hand-built row-block with no tiles,
    duplicate indices and padding in SpMSpM, K beyond one shared-memory
    pass, offsets of 2 and more that wrap every face, bf16) and at every
    card-size case of the entry point. The plain outputs of the card-size
    cases are kept for the path's check."""
    import numpy as np
    import torch

    from repro_torch.hopper import ops
    from repro_torch.launch import sparse_la as sl

    rng = np.random.default_rng(SEED + 4)
    errs = {"bsr_spmm": [], "spmspm": [], "stencil": []}

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).cuda()

    # BSR: hand-built tiles, block row 2 of 5 left without tiles; the edge
    # shapes (bm 8 / 16 / 3 against the kernel's 8-row groups, bk 128 / 20
    # against its 128-column chunks and 16-byte granules, F 256 / 300
    # against its 256-column slices) with every pair of tile and dense
    # types; then unsorted columns with a repeated tile (summed)
    bsr_cases = [(8, 128, 300, "float32", "float32"), (16, 64, 96, "float32", "float32"),
                 (8, 128, 520, "bfloat16", "bfloat16"), (4, 32, 17, "float32", "float32")]
    bsr_cases += [(bm, bk, F, vt, dt) for bm in (8, 16, 3) for bk in (128, 20) for F in (256, 300)
                  for vt in ("float32", "bfloat16") for dt in ("float32", "bfloat16")]
    layouts = [(np.array([0, 0, 1, 3, 4, 4, 4], np.int32), np.array([0, 1, 1, 0, 0, 1, 2], np.int32),
                "empty block row")] * len(bsr_cases)
    bsr_cases.append((8, 128, 256, "float32", "float32"))
    layouts.append((np.array([0, 0, 1, 4, 4, 4, 4], np.int32), np.array([2, 0, 1, 1, 2, 0, 2], np.int32),
                    "empty block rows 2-3, unsorted columns, tile (4, 2) twice"))
    for (bm, bk, F, vt, dt), (rows, cols, what) in zip(bsr_cases, layouts):
        tiles = rng.standard_normal((len(rows), bm, bk)).astype(np.float32)
        tiles[rng.random(tiles.shape) < 0.9] = 0
        wide = dev(rng.standard_normal((3 * bk, F + 7)).astype(np.float32))
        dense = wide[:, 3:3 + F].to(getattr(torch, dt))  # row stride F + 7 for fp32
        tv = dev(tiles).to(getattr(torch, vt))
        args = (tv, dev(rows), dev(cols), dense, 5 * bm)
        got = ops.bsr_spmm(*args, impl="cuda")
        want = ops.bsr_spmm(*args, impl="torch")
        torch.cuda.synchronize()
        label = f"hand-built bm={bm} bk={bk} F={F} tiles {vt} dense {dt}, {what}"
        errs["bsr_spmm"].append(_hold("bsr_spmm", label, got, want, SPARSE_TOL))
        need(bool((got[2 * bm:3 * bm] == 0).all()), "bsr_spmm: the empty block row is not 0")
    # SpMSpM: duplicate indices and padding slots in both operands; R = 1;
    # a ragged C; C wider than one 4096-column tile; La = 0 and Lb = 0;
    # K = 40000; every pair of value types; indices outside [0, K) (held
    # against the plain version on the same operands with those entries
    # made padding); a repeated call gives the same bits
    from repro_torch.hopper import spmspm as sp

    lib = sp._kernel()[0]
    lib.repro_spmspm_scratch_bytes.restype = ctypes.c_longlong
    R, C, K = sl.CARD.spmspm
    card = sp.plan(R, C, 164, K)
    need((card.ct, card.tiles) == (4096, 1), f"spmspm: the card size takes {card.tiles} tiles of {card.ct}")
    for c, lb, k in ((C, 164, K), (9000, 7, 300), (7, 200, 40000), (1, 0, 10)):
        want_bytes = sp.plan(1, c, lb, k).scratch
        got_bytes = lib.repro_spmspm_scratch_bytes(c, lb, k, sp.plan(1, c, lb, k).ct)
        need(got_bytes == want_bytes, f"spmspm scratch {got_bytes} (C) != {want_bytes} (planner)")
    print(f"kernel spmspm: the card size takes one {card.ct}-column tile; scratch sizes agree")
    for R, C, K, La, Lb in ((1, 50, 64, 9, 7), (13, 130, 64, 9, 11), (5, 9000, 300, 20, 7),
                            (4, 7, 10, 0, 5), (4, 7, 10, 5, 0), (7, 50, 40000, 300, 200),
                            (33, 65, 1000, 40, 3)):
        for at in ("float32", "bfloat16"):
            for bt in ("float32", "bfloat16"):
                A = _random_ell_dups(rng, R, K, max(La, 1))
                B = _random_ell_dups(rng, C, K, max(Lb, 1))
                a_cols, b_rows = A.cols[:, :La].clone(), B.cols[:, :Lb].clone()
                if La:
                    a_cols[0, 0] = K + 3
                if Lb:
                    b_rows[-1, 0] = -1
                a_vals, b_vals = A.values[:, :La], B.values[:, :Lb]
                a = (a_vals.cuda().to(getattr(torch, at)).contiguous(), a_cols.cuda().contiguous())
                b = (b_vals.cuda().to(getattr(torch, bt)).contiguous(), b_rows.cuda().contiguous())
                got = ops.spmspm(*a, *b, K, impl="cuda")
                again = ops.spmspm(*a, *b, K, impl="cuda")
                a_in, b_in = (a_cols >= 0) & (a_cols < K), (b_rows >= 0) & (b_rows < K)
                a_p = (torch.where(a_in, a_vals, 0).cuda().to(getattr(torch, at)),
                       torch.where(a_in, a_cols, 0).cuda().contiguous())
                b_p = (torch.where(b_in, b_vals, 0).cuda().to(getattr(torch, bt)),
                       torch.where(b_in, b_rows, 0).cuda().contiguous())
                want = ops.spmspm(*a_p, *b_p, K, impl="torch")
                torch.cuda.synchronize()
                label = (f"dups+padding+out-of-range R={R} C={C} K={K} La={La} Lb={Lb} A {at} B {bt}")
                errs["spmspm"].append(_hold("spmspm", label, got, want, SPARSE_TOL))
                need(torch.equal(got, again), f"spmspm: a repeated call changed the result ({label})")
    # stencil: |d| = 2 on every axis (wrapping every face), box on tiny
    # dims, offsets past the grid's extent in y/z, a 2-D grid, bf16, and y
    # offsets of 40 whose halo outgrows the tiled kernel's shared memory
    # (the direct kernel's path)
    far = np.array([[0, 0, 0], [2, -7, 3], [-2, 5, -9], [1, 1, 1]])
    wide = np.array([[0, 0, 0], [1, 40, 0], [-1, -40, 3], [0, 1, -1]])
    for shape, offs, dt in (((16, 12, 10), sl.star(2, 3), "float32"),
                            ((8, 5, 3), sl.BOX27, "float32"), ((8, 5, 2), far, "float32"),
                            ((64, 48, 1), sl.star(2, 2), "float32"),
                            ((16, 40, 24), sl.BOX27, "bfloat16"),
                            ((40, 96, 40), wide, "float32"), ((40, 96, 40), wide, "bfloat16")):
        g = dev(rng.standard_normal(shape).astype(np.float32)).to(getattr(torch, dt))
        w = rng.standard_normal(len(offs)).astype(np.float32)
        got = ops.stencil(g, offs, w, impl="cuda")
        want = ops.stencil(g, offs, w, impl="torch")
        torch.cuda.synchronize()
        label = f"{shape} {len(offs)}pt {dt}"
        errs["stencil"].append(_hold("stencil", label, got, want, STENCIL_TOL))

    plain = {}
    for case in cases:
        got = _call(case, "cuda")
        want = _call(case, "torch")
        torch.cuda.synchronize()
        tol = STENCIL_TOL if case.op == "stencil" else SPARSE_TOL
        err = _hold(case.op, f"card {case.name} ({case.note})", got, want, tol)
        if case.op in errs:
            errs[case.op].append(err)
        plain[case.name] = want
        if case.op == "bsr_spmm":  # the same case with bf16 tiles and dense
            A, D = case.args
            args = (A.tile_values.bfloat16(), A.tile_rows, A.tile_cols, D.bfloat16(), A.shape[0])
            got = ops.bsr_spmm(*args, impl="cuda")
            want = ops.bsr_spmm(*args, impl="torch")
            torch.cuda.synchronize()
            errs["bsr_spmm"].append(_hold("bsr_spmm", f"card {case.name} ({case.note}), bf16 tiles "
                                          f"and dense", got, want, SPARSE_TOL))
            del args, got, want
    report["sparse_la_err"] = {op: max(e) for op, e in errs.items()}
    report["sparse_la_plain"] = plain


def sparse_la_phase(report, cases):
    """The sparse-LA path through its entry point on the card: launch
    counts zeroed just before and read just after; every output held to
    the plain path's; one warm call of each case profiled."""
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.launch import sparse_la as sl

    torch.cuda.synchronize()
    dispatch.reset_launches()
    runs = sl.run(device="cuda", seed=SEED, cases=cases)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    print(f"sparse_la: {len(runs)} cases; kernel launches during the run: {launches}; "
          f"expected {SPARSE_LA_LAUNCHES} (a warm-up and a timed call per case)")
    need(launches == SPARSE_LA_LAUNCHES, "sparse_la launch counts != the case counts")

    plain = report.pop("sparse_la_plain")
    for r in runs:
        want = plain[r.name]
        need(tuple(r.out.shape) == tuple(want.shape), f"sparse_la {r.name}: shape {tuple(r.out.shape)}")
        need(bool(torch.isfinite(r.out).all()), f"sparse_la {r.name}: non-finite output")
        rel = _rel(r.out, want)
        need(rel <= SPARSE_LA_REL_TOL, f"sparse_la {r.name}: kernel path vs plain path rel {rel:.3e}")
        print(f"sparse_la {r.name}: {r.wall_ms:.3f} ms wall (warm call in the run), "
              f"{r.merit:.2f} {r.unit}; {r.note}; out {tuple(r.out.shape)} finite; "
              f"vs plain path rel {rel:.3e} (tol rel {SPARSE_LA_REL_TOL:g})")
    del plain
    for case in cases:
        profile_fn(f"sparse_la {case.name}", lambda case=case: _call(case, "cuda"), report)
    report["sparse_la_launches"] = launches
    report["sparse_la_runs"] = {r.name: dict(wall_ms=r.wall_ms, merit=r.merit, unit=r.unit)
                                for r in runs}


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bsr_bound_ms(A, dense):
    """Least time for the BSR product on an H100: tiles, tile coordinates
    and dense read once and the fp32 out written once, over HBM bandwidth;
    or 2 * nnz * F operations (the nonzero tile values in this run's data:
    a zero slot of a tile needs no work), over the fp32 peak."""
    tv = A.tile_values
    nnz = int((tv != 0).sum())
    nbytes = (tv.numel() * tv.element_size() + 8 * tv.shape[0]
              + dense.numel() * dense.element_size() + 4 * A.shape[0] * dense.shape[1])
    return _bound(nbytes, 2 * nnz * dense.shape[1])


def spmspm_bound_ms(A, B):
    """Least time for the intersection product on an H100: both ELL
    operands read once and the fp32 (R, C) out written once, over HBM
    bandwidth; or 2 operations per index pair that matches in this run's
    data (sum over k of A's and B's nonzero counts at k), over the fp32
    peak."""
    import torch

    K = A.shape[1]
    ca = torch.bincount(A.cols[A.values != 0].long(), minlength=K)
    cb = torch.bincount(B.cols[B.values != 0].long(), minlength=K)
    matches = int((ca * cb).sum())
    nbytes = sum(x.numel() * x.element_size() for x in (A.values, A.cols, B.values, B.cols))
    nbytes += 4 * A.shape[0] * B.shape[0]
    return _bound(nbytes, 2 * matches)


def stencil_bound_ms(grid, points):
    """Least time for the stencil on an H100: the grid read once and out
    written once over HBM bandwidth, or 2 operations per point per output
    over the fp32 peak."""
    return _bound(2 * grid.numel() * grid.element_size(), 2 * grid.numel() * points)


def _library(case):
    """One PyTorch call computing the case's function, built outside the
    timed window: cuSPARSE SpMM on the matrix as CSR, cuSPARSE SpGEMM on
    both operands as CSR (densified), or a circular pad and a cuDNN conv3d
    with the weights laid at their offsets (TF32 off)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    if case.op == "bsr_spmm":
        A, dense = case.args
        a_csr = A.todense().to_sparse_csr()
        return lambda: torch.sparse.mm(a_csr, dense)
    if case.op == "spmspm":
        A, B, _ = case.args
        a_csr = A.todense().float().to_sparse_csr()
        bt_csr = B.todense().float().t().contiguous().to_sparse_csr()  # (K, C)
        return lambda: torch.sparse.mm(a_csr, bt_csr).to_dense()
    grid, offs, w = case.args
    r = np.abs(offs).max(axis=0)
    kernel = torch.zeros(tuple(int(2 * x + 1) for x in r), dtype=torch.float32)
    for (dx, dy, dz), wp in zip(offs.tolist(), w.tolist()):
        kernel[dx + r[0], dy + r[1], dz + r[2]] += wp
    kernel = kernel.cuda()[None, None]
    pad = (int(r[2]), int(r[2]), int(r[1]), int(r[1]), int(r[0]), int(r[0]))
    x = grid[None, None]
    return lambda: F.conv3d(F.pad(x, pad, mode="circular"), kernel)[0, 0]


def time_sparse_la_kernels(report, cases):
    """Every card-size BSR, SpMSpM and stencil case: kernel and plain
    version in turns (plain, kernel, kernel, plain), the library call and
    the bound; the densest BSR and SpMSpM cases and the 27-point stencil
    go into the kernels line."""
    import torch

    for case in cases:
        if case.op == "spmm":
            continue  # the ELL kernel is timed on the GCN path
        plain_iters = 3
        kern, plain = _in_turns(lambda: _call(case, "cuda"), lambda: _call(case, "torch"),
                                plain_iters)
        lib_fn = _library(case)
        lib = time_ms(lib_fn)
        dev = device_ms(lambda: _call(case, "cuda"))
        # cuSPARSE's SpGEMM sizes its output on the host while it is being
        # captured, so a graph would hold only part of the call: not measured
        lib_dev = None if case.op == "spmspm" else device_ms(lib_fn)
        lib_err = float((lib_fn().float() - _call(case, "cuda").float()).abs().max())
        if case.op == "bsr_spmm":
            bound, by = bsr_bound_ms(*case.args)
        elif case.op == "spmspm":
            bound, by = spmspm_bound_ms(*case.args[:2])
        else:
            bound, by = stencil_bound_ms(case.args[0], len(case.args[1]))
        row = dict(shape=f"{case.name} ({case.note})", ms=min(kern), plain_ms=min(plain),
                   library_ms=lib, bound_ms=bound, bound_by=by, device_ms=dev,
                   library_device_ms=lib_dev)
        print(f"time {case.op} [{case.name} {case.note}]: kernel {kern} ms, plain {plain} ms, "
              f"library {lib:.4f} ms (events; max |diff| vs kernel {lib_err:.2e}); device time "
              f"kernel {_ms(dev)}, library {_ms(lib_dev)}; "
              f"bound {bound:.5f} ms ({by}); {case.work / min(kern) / 1e6:.2f} {case.unit} "
              f"at the kernel's time")
        report.setdefault(f"{case.op}_time", {})[case.name] = row
    torch.cuda.synchronize()


SPARSE_LA_JSON = (  # (kernel, source, replaces, the case that goes into the kernels line)
    ("bsr_spmm", "src/repro_torch/csrc/bsr_spmm.cu", "src/repro/kernels/spmm.py:87",
     "fig9c_spmm_bsr_d2.80pct"),
    ("spmspm", "src/repro_torch/csrc/spmspm.cu", "src/repro/kernels/spmspm.py:19",
     "fig9d_spmspm_d2.80pct"),
    ("stencil", "src/repro_torch/csrc/stencil.cu", "src/repro/kernels/stencil.py:23",
     "fig9b_j3d27pt_512c"),
)


# ---------------------------------------------------------------------------
# the precision ladder (paper Fig. 10): scaled GEMM, scaled FA-2
# ---------------------------------------------------------------------------

POLICIES = ("fp32", "bf16", "fp8", "fp8_e5m2")
# kernel vs its plain version on the same quantized operands: Frobenius
# relative error, the reference suite's cross-impl bound
# (tests/test_precision.py:125-126, 142-143)
SCALED_REL_TOL = 1e-4
# against the fp32 oracle on the unquantized operands: the reference's
# tolerances (_GEMM_TOL, tests/test_precision.py:108; FA :129, with fp32 at
# the GEMM's 1e-5 and e5m2 at 0.2, which the reference does not test)
ORACLE_TOL = {"gemm": {"fp32": 1e-5, "bf16": 0.02, "fp8": 0.1, "fp8_e5m2": 0.2},
              "flash_attention": {"fp32": 1e-5, "bf16": 0.02, "fp8": 0.1, "fp8_e5m2": 0.2},
              "decode_attention": {"fp32": 1e-5, "bf16": 0.02, "fp8": 0.1, "fp8_e5m2": 0.2}}
# per ladder run: four policies, a warm-up and a timed call each; decode
# has no kernel
LADDER_LAUNCHES = {"gemm_scaled": 2 * len(POLICIES), "flash_attention_scaled": 2 * len(POLICIES)}
GEMM_SCALED_REPLACES = "src/repro/kernels/gemm.py:96"
GEMM_SCALED_SOURCE = "src/repro_torch/csrc/gemm_scaled.cu"
FA_SCALED_REPLACES = "src/repro/kernels/flash_attention.py:57"
FA_SCALED_SOURCE = "src/repro_torch/csrc/flash_attention_scaled.cu"

# (label, M, K, N, bk); every case runs under every policy, through the
# route hopper/gemm_scaled.py `plan` gives it (printed with each hold). fp32
# takes the ffma route. bf16 and fp8 take wgmma where bk is a multiple of a
# stage's k (64 / 128 values) and the rows are 16-byte aligned, mma
# otherwise: rows of K or N elements not a multiple of 8, and K-blocks that
# start off a multiple of 8, take its single-load path.
GEMM_SCALED_CASES = [
    ("ragged bk=64", 100, 70, 130, 64),
    ("ragged last block bk=64", 257, 300, 65, 64),
    ("ragged bk=256", 130, 600, 200, 256),
    ("K < bk=256", 64, 160, 96, 256),
    ("odd bk=48", 96, 200, 72, 48),
    ("bk=20, blocks off the 8-value chunks", 64, 200, 40, 20),
    ("wide bk=256", 512, 1024, 768, 256),
    ("wgmma ragged M, N bk=128", 200, 512, 144, 128),
    ("wgmma ragged last K-block bk=128", 192, 304, 256, 128),
    ("wgmma bk=512", 256, 1024, 384, 512),
    ("wgmma bf16 bk=64", 130, 256, 144, 64),
]
# the routes the ladder's card shape must take, by policy
CARD_GEMM_ROUTES = {"fp32": "ffma", "bf16": "wgmma", "fp8": "wgmma", "fp8_e5m2": "wgmma"}
CARD_FA_ROUTES = {"fp32": "ffma", "bf16": "wgmma", "fp8": "wgmma", "fp8_e5m2": "wgmma"}
# (label, B, H, K, Sq, Sk, D, causal, window, q_offset, return_lse)
FA_SCALED_CASES = [
    ("gqa causal lse D=64", 2, 8, 2, 100, 100, 64, True, 0, 0, True),
    ("window non-causal D=128", 1, 4, 4, 130, 130, 128, False, 17, 0, True),
    ("window+q_offset ragged Sk D=256", 1, 4, 2, 70, 150, 256, True, 40, 80, True),
    ("non-causal ragged D=256", 1, 2, 2, 45, 77, 256, False, 0, 0, False),
    ("q_offset gqa D=64", 2, 4, 1, 37, 101, 64, True, 0, 64, True),
    ("causal S=512 D=256", 1, 16, 16, 512, 512, 256, True, 0, 0, False),
]


def _frob(got, want):
    import torch

    diff = got.float() - want.float()
    return float(torch.linalg.vector_norm(diff) / torch.linalg.vector_norm(want.float()).clamp_min(1e-30))


def _hold_scaled(name, label, got, want):
    """Kernel output against the plain version's on the same quantized
    operands: Frobenius relative error within ``SCALED_REL_TOL``; returns
    the largest absolute difference."""
    import torch

    need(bool(torch.isfinite(got).all()), f"{name} [{label}]: non-finite kernel output")
    need(got.shape == want.shape, f"{name} [{label}]: shape {tuple(got.shape)} != {tuple(want.shape)}")
    need(got.dtype == torch.float32, f"{name} [{label}]: output {got.dtype}, not float32")
    rel = _frob(got, want)
    max_abs = float((got.float() - want.float()).abs().max())
    ok = rel <= SCALED_REL_TOL
    print(f"kernel {name} [{label}]: vs plain rel {rel:.3e} max_abs={max_abs:.3e} "
          f"tol rel {SCALED_REL_TOL:g} {'ok' if ok else 'FAIL'}")
    need(ok, f"{name} kernel disagrees with plain version: {label}")
    return max_abs


def _hold_oracle(op, label, pol, got, oracle):
    rel = _frob(got, oracle)
    tol = ORACLE_TOL[op][pol]
    print(f"op {op} [{label}] {pol}: vs fp32 oracle rel {rel:.3e} tol {tol:g} "
          f"{'ok' if rel <= tol else 'FAIL'}")
    need(rel <= tol, f"{op} {pol}: beyond the reference's tolerance vs the fp32 oracle: {label}")
    return rel


def _promote_sweep(cases, report):
    """The fp8 wgmma route's promotion interval: each case held to its plain
    version at every interval the kernel offers (half a stage, 64 values,
    or a whole one, 128), worst Frobenius error per type and interval
    printed and kept; ``gemm_scaled.PROMOTE`` must be the largest interval
    within SCALED_REL_TOL for its type. The card shape's errors join in
    ``time_precision_kernels``."""
    import torch

    from repro_torch.hopper import gemm_scaled as gs

    chosen = dict(gs.PROMOTE)
    worst = report.setdefault("promote_rel", {})
    try:
        for dt in gs.FP8:
            for interval in (64, 128):
                gs.PROMOTE[dt] = interval
                gs.plan.cache_clear()
                for label, aq, bq, a_s, b_s, bk, want in cases:
                    if aq.dtype != dt:
                        continue
                    rel = _frob(gs.gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk), want)
                    key = f"{str(dt).replace('torch.', '')} promote {interval}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    print(f"promote sweep [{label} {key}]: vs plain rel {rel:.3e}")
    finally:
        gs.PROMOTE.update(chosen)
        gs.plan.cache_clear()
    torch.cuda.synchronize()


def _check_promote(report):
    """PROMOTE is, for each fp8 type, the largest swept interval whose worst
    error held SCALED_REL_TOL."""
    from repro_torch.hopper import gemm_scaled as gs

    for dt in gs.FP8:
        name = str(dt).replace("torch.", "")
        rel = {i: report["promote_rel"][f"{name} promote {i}"] for i in (64, 128)}
        held = [i for i in (64, 128) if rel[i] <= SCALED_REL_TOL]
        print(f"promote {name}: worst rel {rel}; largest within {SCALED_REL_TOL:g}: "
              f"{max(held) if held else None}; chosen {gs.PROMOTE[dt]}")
        need(held and gs.PROMOTE[dt] == max(held), f"gemm_scaled.PROMOTE[{name}] is not the largest that holds")


def check_precision_kernels(report):
    """Phase 2 for the precision slice: the scaled GEMM and scaled FA-2
    kernels against their plain versions on the same quantized operands,
    for every policy, at ragged shapes (bk 64, 256 and an odd 48; GQA,
    causal, window, q_offset, return_lse; D 64, 128, 256); and the op
    through the kernel against the fp32 oracle at the reference's
    tolerances."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.device import sm_count
    from repro_torch.hopper import blocked, ops, ref
    from repro_torch.hopper import gemm_scaled as gs
    from repro_torch.hopper.flash_attention_scaled import flash_attention_scaled_kernel
    from repro_torch.hopper.gemm_scaled import gemm_scaled_kernel

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    errs = {"gemm_scaled": [], "flash_attention_scaled": []}
    routes, wgmma_cases = set(), []
    for label, M, K, N, bk in GEMM_SCALED_CASES:
        a = torch.randn((M, K), generator=gen, device="cuda")
        b = torch.randn((K, N), generator=gen, device="cuda")
        oracle = ref.gemm_ref(a, b, torch.float32)
        for pol in POLICIES:
            aq, a_s = prec.quantize_blockwise(a, pol, axis=1, block=bk)
            bq, b_s = prec.quantize_blockwise(b, pol, axis=0, block=bk)
            plan = gs.plan(M, N, K, bk, aq.dtype, gs.rows16(aq, bq), sm_count(0))
            routes.add(plan.route)
            got = gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk)
            want = blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=bk)
            torch.cuda.synchronize()
            tag = f"{label} ({M},{K})x({K},{N}) {pol} [{plan.route}]"
            errs["gemm_scaled"].append(_hold_scaled("gemm_scaled", tag, got, want))
            _hold_oracle("gemm", tag, pol, ops.gemm(a, b, precision=pol, bk=bk, impl="cuda"), oracle)
            if plan.route == "wgmma" and aq.dtype in gs.FP8:
                wgmma_cases.append((label, aq, bq, a_s, b_s, bk, want))
    need(routes == {"mma", "wgmma", "ffma"}, f"scaled GEMM cases cover the routes {sorted(routes)}")
    _promote_sweep(wgmma_cases, report)
    # bf16 output from each route: one rounding of the fp32 sum (the last
    # case's operands: wgmma at fp8 bk=256, mma at bf16 bk=48, ffma at fp32)
    for pol, bk in (("fp8", 256), ("bf16", 48), ("fp32", 256)):
        aq, a_s = prec.quantize_blockwise(a, pol, axis=1, block=bk)
        bq, b_s = prec.quantize_blockwise(b, pol, axis=0, block=bk)
        route = gs.plan(a.shape[0], b.shape[1], a.shape[1], bk, aq.dtype, gs.rows16(aq, bq), sm_count(0)).route
        got = gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk, out_dtype=torch.bfloat16)
        want = blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=bk)
        _hold("gemm_scaled", f"{tuple(a.shape)}x{tuple(b.shape)} bk={bk} {pol} [{route}] -> bf16 out",
              got, want, GEMM_TOL["bfloat16"])

    for case in FA_SCALED_CASES:
        label, B, H, K, Sq, Sk, D, causal, window, q_offset, lse = case
        q = torch.randn((B, H, Sq, D), generator=gen, device="cuda")
        k = torch.randn((B, K, Sk, D), generator=gen, device="cuda")
        v = torch.randn((B, K, Sk, D), generator=gen, device="cuda")
        kw = dict(causal=causal, window=window, q_offset=q_offset, return_lse=lse)
        oracle = ref.mha_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
        for pol in POLICIES:
            (qq, qs), (kq, ks), (vq, vs) = (
                prec.quantize_blockwise(x, pol, axis=-1, block=D) for x in (q, k, v))
            got = flash_attention_scaled_kernel(qq, kq, vq, qs, ks, vs, **kw)
            want = blocked.flash_attention_scaled_values_blocked(qq, kq, vq, qs, ks, vs, **kw)
            torch.cuda.synchronize()
            if not lse:
                got, want = (got,), (want,)
            tag = f"{label} {pol}"
            errs["flash_attention_scaled"].append(
                _hold_scaled("flash_attention_scaled", tag, got[0], want[0]))
            if lse:
                _hold("flash_attention_scaled", f"{tag} lse", got[1], want[1], LSE_TOL)
            out = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                      precision=pol, impl="cuda")
            _hold_oracle("flash_attention", tag, pol, out, oracle)
    report["scaled_err"] = {name: max(e) for name, e in errs.items()}


def precision_ladder_phase(report):
    """The precision ladder through its entry point on the card, at
    occamy-gptj's full width (``precision_ladder.CARD``): launch counts
    zeroed just before and read just after (gemm_scaled 8,
    flash_attention_scaled 8, nothing else); each row's output finite and of
    the oracle's shape, within the reference's tolerance of the fp32
    oracle, and the error ordering of the ladder (fp32 < bf16 < fp8 <=
    fp8_e5m2) for each op."""
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.launch import precision_ladder as pl

    t = time.perf_counter()
    cases = pl.make_cases(pl.CARD, SEED)
    print(f"precision_ladder: card-size operands drawn in {time.perf_counter() - t:.1f} s on the host")
    torch.cuda.synchronize()
    dispatch.reset_launches()
    rows = pl.run(device="cuda", seed=SEED, cases=cases, impl="cuda")
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    print(f"precision_ladder: {len(rows)} rows; kernel launches during the run: {launches}; "
          f"expected {LADDER_LAUNCHES} (four policies, a warm-up and a timed call each; "
          f"decode has no kernel)")
    need(launches == LADDER_LAUNCHES, "precision_ladder launch counts != the path's counts")
    shapes = {"gemm": (cases[0].operands[0].shape[0], cases[0].operands[1].shape[1]),
              "flash_attention": tuple(cases[1].operands[0].shape),
              "decode_attention": tuple(cases[2].operands[0].shape)}
    by_op = {}
    for r in rows:
        need(tuple(r.out.shape) == shapes[r.op], f"ladder {r.op} {r.policy}: shape {tuple(r.out.shape)}")
        need(bool(torch.isfinite(r.out).all()), f"ladder {r.op} {r.policy}: non-finite output")
        tol = ORACLE_TOL[r.op][r.policy]
        print(f"ladder {r.op} {r.policy}: {r.wall_ms:.3f} ms wall (warm call), {r.gflops:.1f} GFLOP/s, "
              f"bound {r.bound_ms:.5f} ms ({r.bound_by}); vs fp32 oracle max_err {r.max_err:.3e} "
              f"rel_err {r.rel_err:.3e} (tol {tol:g})")
        need(r.rel_err <= tol, f"ladder {r.op} {r.policy}: rel_err {r.rel_err:.3e} beyond {tol:g}")
        by_op.setdefault(r.op, {})[r.policy] = r.rel_err
    for op, rel in by_op.items():
        ordered = rel["fp32"] < rel["bf16"] < rel["fp8"] <= rel["fp8_e5m2"]
        print(f"ladder {op}: rel_err fp32 {rel['fp32']:.3e} < bf16 {rel['bf16']:.3e} < fp8 "
              f"{rel['fp8']:.3e} <= fp8_e5m2 {rel['fp8_e5m2']:.3e}: {'ok' if ordered else 'FAIL'}")
        need(ordered, f"ladder {op}: rel_err does not follow the precision ladder")
    report["ladder_launches"] = launches
    report["ladder"] = [dict(op=r.op, policy=r.policy, wall_ms=r.wall_ms, gflops=r.gflops,
                             bound_ms=r.bound_ms, max_err=r.max_err, rel_err=r.rel_err) for r in rows]


def _narrow_bound(nbytes, ops, dtype):
    """The larger of ``nbytes`` over HBM bandwidth and ``ops`` over the
    compute dtype's peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype).replace("torch.", "")] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*xs):
    return sum(x.numel() * x.element_size() for x in xs)


def time_precision_kernels(report):
    """Both scaled kernels at the ladder's card shapes, each policy: the
    route each takes (asserted: wgmma at bf16 and fp8, ffma at fp32), the
    kernel on the quantized operands held to its plain version
    (SCALED_REL_TOL; for the GEMM also at every fp8 promotion interval the
    kernel offers) and timed against it in turns by events, the device
    time (CUDA-graph replay), the library call that computes the same
    function where one exists (unit scales at bf16 and fp32:
    ``torch.matmul`` and SDPA on the compute-type values) by events and by
    device time, and the bound (values and scales read once, the fp32
    output written once; the operations over the compute dtype's peak)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import precision as prec
    from repro_torch.device import sm_count
    from repro_torch.hopper import blocked
    from repro_torch.hopper import flash_attention_scaled as fs
    from repro_torch.hopper import gemm_scaled as gs
    from repro_torch.launch import precision_ladder as pl

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    m, k, n = pl.CARD.gemm
    bk = 256  # resolve_blocks("gemm")'s default, as the ladder's ops.gemm takes it
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    for pol in POLICIES:
        dt = prec.resolve(pol).compute_dtype
        aq, a_s = prec.quantize_blockwise(a, pol, axis=1, block=bk)
        bq, b_s = prec.quantize_blockwise(b, pol, axis=0, block=bk)
        plan = gs.plan(m, n, k, bk, dt, gs.rows16(aq, bq), sm_count(0))
        label = f"({m},{k})x({k},{n}) bk={bk} {pol}"
        need(plan.route == CARD_GEMM_ROUTES[pol],
             f"gemm_scaled [{label}] takes the {plan.route} route, not {CARD_GEMM_ROUTES[pol]}")
        got = gs.gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk)
        want = blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=bk)
        err = _hold_scaled("gemm_scaled", f"card {label} [{plan.route}]", got, want)
        if dt in gs.FP8:
            _promote_sweep([(f"card {label}", aq, bq, a_s, b_s, bk, want)], report)
        del got, want
        call = lambda: gs.gemm_scaled_kernel(aq, bq, a_s, b_s, bk=bk)  # noqa: E731
        kern, plain = _in_turns(call, lambda: blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=bk), 3)
        dev = device_ms(call)
        bound, by = _narrow_bound(_nbytes(aq, bq, a_s, b_s) + 4 * m * n, 2 * m * n * k, dt)
        lib = lib_dev = None
        lib_text = "none (no single call scales per K-block)"
        if dt in (torch.float32, torch.bfloat16):  # unit scales: the same function
            lib, lib_dev = time_ms(lambda: torch.matmul(aq, bq)), device_ms(lambda: torch.matmul(aq, bq))
            lib_text = f"torch.matmul on the {pol} values {lib:.4f} ms, device {_ms(lib_dev)}"
        elif dt == torch.float8_e4m3fn:
            lib, lib_text = _scaled_mm_blockwise(aq, bq, a_s, b_s, bk)
            lib_text += "; " + _scaled_mm_reference(aq, bq)
        report.setdefault("gemm_scaled_time", {})[pol] = dict(
            shape=label, route=plan.route, promote=plan.promote or None, ms=min(kern), device_ms=dev,
            plain_ms=min(plain), library_ms=lib, library_device_ms=lib_dev, bound_ms=bound, bound_by=by,
            max_abs_err=err, library=lib_text)
        print(f"time gemm_scaled [{label}] {plan.route} route"
              f"{f', promote {plan.promote}' if plan.promote else ''}: kernel {kern} ms (events), device "
              f"{_ms(dev)}; plain {plain} ms; library {lib_text}; bound {bound:.5f} ms ({by}); "
              f"{2 * m * n * k / (dev or min(kern)) / 1e9:.1f} TFLOP/s at the kernel's device time")
        del aq, bq, a_s, b_s
    del a, b
    torch.cuda.empty_cache()
    _check_promote(report)

    B, H, K, S, D = pl.CARD.fa
    q = torch.randn((B, H, S, D), generator=gen, device="cuda")
    kk = torch.randn((B, K, S, D), generator=gen, device="cuda")
    v = torch.randn((B, K, S, D), generator=gen, device="cuda")
    for pol in POLICIES:
        dt = prec.resolve(pol).compute_dtype
        (qq, qs), (kq, ks), (vq, vs) = (
            prec.quantize_blockwise(x, pol, axis=-1, block=D) for x in (q, kk, v))
        ops_ = (qq, kq, vq, qs, ks, vs)
        label = f"B={B} H={H} K={K} S={S} D={D} causal {pol}"
        route = fs.route(dt)
        need(route == CARD_FA_ROUTES[pol], f"flash_attention_scaled [{label}] takes {route}")
        got = fs.flash_attention_scaled_kernel(*ops_, causal=True)
        want = blocked.flash_attention_scaled_values_blocked(*ops_, causal=True)
        err = _hold_scaled("flash_attention_scaled", f"card {label} [{route}]", got, want)
        del got, want
        call = lambda: fs.flash_attention_scaled_kernel(*ops_, causal=True)  # noqa: E731
        kern, plain = _in_turns(call, lambda: blocked.flash_attention_scaled_values_blocked(*ops_, causal=True), 3)
        dev = device_ms(call)
        lib = lib_dev = None
        lib_text = "none (no single call takes per-row scales)"
        if dt in (torch.float32, torch.bfloat16):  # unit scales: the same function
            sdpa = lambda: F.scaled_dot_product_attention(qq, kq, vq, is_causal=True)  # noqa: E731
            lib, lib_dev = time_ms(sdpa), device_ms(sdpa)
            lib_text = f"SDPA on the {pol} values {lib:.4f} ms, device {_ms(lib_dev)}"
        bound, by = _narrow_bound(_nbytes(*ops_) + 4 * B * H * S * D,
                                  4 * B * H * D * S * (S + 1) // 2, dt)
        report.setdefault("fa_scaled_time", {})[pol] = dict(
            shape=label, route=route, ms=min(kern), device_ms=dev, plain_ms=min(plain), library_ms=lib,
            library_device_ms=lib_dev, bound_ms=bound, bound_by=by, max_abs_err=err, library=lib_text)
        print(f"time flash_attention_scaled [{label}] {route} route: kernel {kern} ms (events), device "
              f"{_ms(dev)}; plain {plain} ms; library {lib_text}; bound {bound:.5f} ms ({by}); "
              f"{4 * B * H * D * S * (S + 1) / 2 / (dev or min(kern)) / 1e9:.1f} TFLOP/s at the kernel's "
              f"device time")
    torch.cuda.synchronize()


def _scaled_mm_blockwise(aq, bq, a_s, b_s, bk):
    """``torch.nn.functional.scaled_mm`` with ``BlockWise1x128`` scales on
    both operands and an fp32 output: A's scales per (row, 128 of K), B's
    per (128 of K, column) as the column-major (N, K / 128) the call takes;
    the ladder's per-``bk`` scales repeated bk / 128 times along K, so it is
    the kernel's function. Held to the plain version at SCALED_REL_TOL
    (Frobenius). Returns (ms, text), ms None with the reason where the call
    is refused or misses the hold: a library's yardstick, not a gate."""
    import torch

    from repro_torch.hopper import blocked

    try:
        F = torch.nn.functional
        rep = bk // 128
        sa = a_s.repeat_interleave(rep, dim=1).t().contiguous().t()  # (M, K/128), stride (1, M)
        sb = b_s.repeat_interleave(rep, dim=0).t()  # (N, K/128), stride (1, N)
        bt = bq.t().contiguous().t()  # column-major B
        call = lambda: F.scaled_mm(aq, bt, sa, F.ScalingType.BlockWise1x128, sb,
                                   F.ScalingType.BlockWise1x128, output_dtype=torch.float32)
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, TypeError, AttributeError, ValueError) as e:
        return None, (f"scaled_mm (BlockWise1x128 x BlockWise1x128, fp32 out) refused: "
                      f"{str(e).splitlines()[0][:160]}")
    rel = _frob(got, blocked.gemm_scaled_values_blocked(aq, bq, a_s, b_s, bk=bk))
    if rel > SCALED_REL_TOL:
        return None, (f"scaled_mm (BlockWise1x128 x BlockWise1x128, fp32 out) misses the hold: "
                      f"rel {rel:.3e} > {SCALED_REL_TOL:g}")
    ms = time_ms(call)
    return ms, (f"scaled_mm (BlockWise1x128 x BlockWise1x128, fp32 out) {ms:.4f} ms, vs plain "
                f"rel {rel:.3e}")


def _scaled_mm_reference(aq, bq):
    """``torch._scaled_mm`` on the e4m3 values with unit row-wise scales, a
    reference point only (it scales per row and column, not per K-block,
    so it computes another function); its absence is printed, not failed."""
    import torch

    try:
        bt = bq.t().contiguous().t()  # column-major B, as the call requires
        sa = torch.ones((aq.shape[0], 1), device="cuda")
        sb = torch.ones((1, bq.shape[1]), device="cuda")
        ms = time_ms(lambda: torch._scaled_mm(aq, bt, scale_a=sa, scale_b=sb,
                                              out_dtype=torch.bfloat16))
        return f"reference point: torch._scaled_mm (row-wise scales, bf16 out) {ms:.4f} ms"
    except (RuntimeError, TypeError) as e:  # not a gate: a library's reference point
        return f"reference point: torch._scaled_mm not available here ({str(e).splitlines()[0][:100]})"


# ---------------------------------------------------------------------------
# phases 4-6: full-width occamy-gptj through the serving engine
# ---------------------------------------------------------------------------


def make_requests(vocab):
    """Seeded workload: prompts of 100..500 tokens (the first one 500, so
    the largest bucket, 512, is served), NEW_TOKENS new tokens each,
    arriving two per engine step."""
    import numpy as np

    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(SEED)
    lens = rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1, N_REQUESTS)
    lens[0] = PROMPT_LENS[1]
    return [
        Request(rid=i, prompt=tuple(int(x) for x in rng.integers(1, vocab, int(n))),
                max_new_tokens=NEW_TOKENS, arrival=i // 2)
        for i, n in enumerate(lens)
    ]


def serve(report):
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    cfg = get_config("occamy-gptj")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    leaves = [params["embed"], params["final_norm"], params["lm_head"],
              *params["layers"].values()]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"model occamy-gptj full width: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}x{cfg.resolved_head_dim()} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} {cfg.dtype} params={nbytes / 1e9:.2f} GB, "
          f"init {time.perf_counter() - t0:.2f} s (depth not cut)")

    reqs = make_requests(cfg.vocab_size)
    engine = ServingEngine.with_model(
        cfg, params, num_blocks=NUM_BLOCKS, block_size=BLOCK_SIZE,
        max_slots=SLOTS, max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, device="cuda",
    )
    run = _drive(engine, reqs)
    out, launches = run["out"], run["launches"]
    fa = launches.get("flash_attention", 0)
    print(f"serve: completed={len(out)}/{len(reqs)} steps={engine.step_count} "
          f"preemptions={run['preempts']} prefills={run['prefills']} resumes={run['resumes']} "
          f"leaked={engine.leaked_blocks()} wall={run['wall']:.3f} s")
    print(f"serve: kernel launches during the run: {launches}; expected "
          f"flash_attention = {cfg.num_layers} layers x {run['prefills']} prefills "
          f"= {cfg.num_layers * run['prefills']}")
    need(len(out) == len(reqs), "not every request completed")
    need(all(len(out[r.rid]) == r.max_new_tokens for r in reqs), "short token stream")
    need(engine.leaked_blocks() == 0, "leaked cache blocks")
    need(run["preempts"] >= 1, "the pool never preempted")
    need(fa == cfg.num_layers * run["prefills"], "flash_attention launch count != layers x prefills")

    for n, ms in run["prefill_ms"]:
        print(f"time prefill: prompt {n} tokens -> {ms:.2f} ms")
    decode_step_ms, tok_s = _decode_rate(run)
    print(f"time decode: {len(run['decode_ms'])} steps, mean {decode_step_ms:.2f} ms/step "
          f"over {SLOTS} slots, {tok_s:.1f} tok/s (first step excluded)")
    report["fa_launches"] = fa
    report["serve"] = dict(prefill_ms=run["prefill_ms"], decode_tok_s=tok_s)

    check_prefill_logits(cfg, params, reqs, out)
    profile_steps(engine, reqs, report)
    serve_fp8(report, cfg, params, engine, run)


def _drive(engine, reqs):
    """Submit ``reqs`` and run the engine to the end, with a host clock
    around each model call (both end in a device->host copy) and the
    kernels' launch counts zeroed just before and read just after."""
    import torch

    from repro_torch.hopper import dispatch

    for r in reqs:
        engine.submit(r)
    model = engine.model
    prefill_ms, decode_ms, decode_tokens = [], [], []
    real_prefill, real_decode = model.prefill, model.decode

    def timed_prefill(seq, block_ids):
        t = time.perf_counter()
        out = real_prefill(seq, block_ids)
        prefill_ms.append((len(seq.req.prompt), (time.perf_counter() - t) * 1e3))
        return out

    def timed_decode(tokens, positions, tables, active):
        t = time.perf_counter()
        out = real_decode(tokens, positions, tables, active)
        decode_ms.append((time.perf_counter() - t) * 1e3)
        decode_tokens.append(int(active.sum()))
        return out

    model.prefill, model.decode = timed_prefill, timed_decode
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t = time.perf_counter()
    out = engine.run(max_steps=1000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(dispatch.LAUNCHES)
    model.prefill, model.decode = real_prefill, real_decode
    events = engine.scheduler.events
    return dict(
        out=out, wall=wall, launches=launches, prefill_ms=prefill_ms, decode_ms=decode_ms,
        decode_tokens=decode_tokens,
        preempts=sum(1 for e in events if e[0] == "preempt"),
        prefills=sum(1 for e in events if e[0] == "admit" and e[5] == 0),
        resumes=sum(1 for e in events if e[0] == "admit" and e[5] > 0),
    )


def _decode_rate(run):
    """Mean decode ms per step and tokens/s, the first step excluded."""
    steady = run["decode_ms"][1:] or run["decode_ms"]
    tokens = run["decode_tokens"][1:] or run["decode_tokens"]
    return sum(steady) / len(steady), sum(tokens) / (sum(steady) / 1e3)


def _pool_bytes(cache):
    pools = [cache.k_pool, cache.v_pool]
    if cache.quantized:
        pools += [cache.k_scale, cache.v_scale]
    return sum(x.numel() * x.element_size() for x in pools)


def serve_fp8(report, cfg, params, bf16_engine, bf16_run):
    """The same requests and pool served with fp8 (e4m3) KV pools: all
    complete, none leak, the preemptions equal the bf16 run's (the
    scheduler sees lengths only), every first token equals the bf16 run's
    (prefill attention is unquantized; only the pages are fp8), one FA
    launch per layer per prefill and no other launch (decode is the plain
    paged form, dequantizing each page at use)."""
    import torch

    from repro_torch.serving.engine import ServingEngine

    reqs = make_requests(cfg.vocab_size)
    engine = ServingEngine.with_model(
        cfg, params, num_blocks=NUM_BLOCKS, block_size=BLOCK_SIZE, max_slots=SLOTS,
        max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, precision="fp8", device="cuda",
    )
    cache = engine.model.cache
    need(cache.quantized and cache.k_pool.dtype == torch.float8_e4m3fn,
         "the fp8 engine's pools are not float8_e4m3fn with scales")
    run = _drive(engine, reqs)
    out, launches, want = run["out"], run["launches"], bf16_run["out"]
    same_first = sum(out[r.rid][0] == want[r.rid][0] for r in reqs)
    same_stream = sum(out[r.rid] == want[r.rid] for r in reqs)
    expected = {"flash_attention": cfg.num_layers * run["prefills"]}
    print(f"serve fp8: completed={len(out)}/{len(reqs)} steps={engine.step_count} "
          f"preemptions={run['preempts']} (bf16 {bf16_run['preempts']}) prefills={run['prefills']} "
          f"resumes={run['resumes']} leaked={engine.leaked_blocks()} wall={run['wall']:.3f} s")
    print(f"serve fp8: first token equal to the bf16 run's for {same_first}/{len(reqs)} requests; "
          f"whole stream equal for {same_stream}/{len(reqs)} (printed, not a gate)")
    print(f"serve fp8: kernel launches during the run: {launches}; expected {expected}")
    need(len(out) == len(reqs), "fp8: not every request completed")
    need(all(len(out[r.rid]) == r.max_new_tokens for r in reqs), "fp8: short token stream")
    need(engine.leaked_blocks() == 0, "fp8: leaked cache blocks")
    need(run["preempts"] == bf16_run["preempts"], "fp8: preemptions differ from the bf16 run's")
    need(same_first == len(reqs), "fp8: a first token differs from the bf16 run's")
    need(launches == expected, "fp8: launch counts != one FA launch per layer per prefill")
    step_ms, tok_s = _decode_rate(run)
    bf16_step_ms, _ = _decode_rate(bf16_run)
    fp8_bytes, bf16_bytes = _pool_bytes(cache), _pool_bytes(bf16_engine.model.cache)
    print(f"time decode fp8 pools: {len(run['decode_ms'])} steps, mean {step_ms:.2f} ms/step "
          f"({tok_s:.1f} tok/s, first step excluded); bf16 pools {bf16_step_ms:.2f} ms/step")
    print(f"serve fp8: resident pool bytes fp8 {fp8_bytes} (values + fp32 scales) vs bf16 "
          f"{bf16_bytes}: {fp8_bytes / bf16_bytes:.4f}")
    report["serve_fp8"] = dict(decode_ms_per_step=step_ms, bf16_decode_ms_per_step=bf16_step_ms,
                               pool_bytes=fp8_bytes, bf16_pool_bytes=bf16_bytes)


# A random-weight GPT-J amplifies rounding differences layer by layer: at
# full depth the plain version against itself at another KV block size
# drifts as well (both drifts are printed), so full-depth logits of two
# summation orders are not comparable. The kernel is held to its plain
# version on the first LOGIT_CHECK_LAYERS layers of the same full-width
# model, where only rounding separates them: in fp32 (the CUDA-core kernel)
# to 1e-3 of the largest logit, and in bf16 (the tensor-core kernel the
# serving path runs) to 5e-2, a few bf16 steps of logits rounded to bf16.
LOGIT_CHECK_LAYERS = 2
LOGIT_REL_TOL = {"float32": 1e-3, "bfloat16": 5e-2}


def check_prefill_logits(cfg, params, reqs, served):
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.models import transformer

    req = min(reqs, key=lambda r: abs(len(r.prompt) - 208))
    tokens = torch.tensor([req.prompt], device="cuda")
    n = len(req.prompt)
    with torch.no_grad(), dispatch.default_impl("cuda"):
        full, _ = transformer.prefill_step(params, cfg, {"tokens": tokens}, max_len=n)
    full = full[0, :, : cfg.vocab_size]
    need(tuple(full.shape) == (n, cfg.vocab_size), f"logits shape {tuple(full.shape)}")
    need(bool(torch.isfinite(full).all()), "non-finite prefill logits")
    first = int(full[-1].argmax())
    print(f"prefill logits (rid {req.rid}, {n} tokens, {cfg.num_layers} layers, kernel): "
          f"finite, shape {tuple(full.shape)}, first token {first}, served {served[req.rid][0]}")
    need(first == served[req.rid][0], "the engine's first token differs from a direct prefill")

    def drift(impl, **blocks):  # full depth, bf16: printed, not a gate
        with torch.no_grad(), dispatch.default_impl(impl), \
                dispatch.block_override("flash_attention", **blocks):
            other, _ = transformer.prefill_step(params, cfg, {"tokens": tokens}, max_len=n)
        other = other[0, :, : cfg.vocab_size].float()
        rel = float((other - ref).abs().max() / ref.abs().max())
        agree = float((other.argmax(-1) == ref.argmax(-1)).float().mean())
        return f"rel {rel:.3e}, argmax agreement {agree:.3f}"

    with torch.no_grad(), dispatch.default_impl("torch"):
        ref, _ = transformer.prefill_step(params, cfg, {"tokens": tokens}, max_len=n)
    ref = ref[0, :, : cfg.vocab_size].float()
    print(f"prefill logits at full depth, bf16, vs the plain version (bk 128): kernel "
          f"{drift('cuda', bk=128)}; plain at bk 64 {drift('torch', bk=64)}")

    nl = LOGIT_CHECK_LAYERS
    for dt, tol in LOGIT_REL_TOL.items():
        dtype = getattr(torch, dt)
        cut = cfg.replace(num_layers=nl, dtype=dt)
        pc = {k: params[k].to(dtype) for k in ("embed", "final_norm", "lm_head")}
        pc["layers"] = {k: v[:nl].to(dtype) for k, v in params["layers"].items()}
        out = {}
        for impl in ("cuda", "torch"):
            with torch.no_grad(), dispatch.default_impl(impl):
                out[impl], _ = transformer.prefill_step(pc, cut, {"tokens": tokens}, max_len=n)
        got, want = (out[i][0, :, : cfg.vocab_size].float() for i in ("cuda", "torch"))
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"prefill logits kernel vs plain (first {nl} layers, full width, {dt}): "
              f"max_abs={err:.3e} max|logit|={scale:.3f} rel={err / scale:.3e} tol rel {tol:g}")
        need(err <= tol * scale, f"prefill logits ({dt}): kernel vs plain beyond tolerance")


def profile_steps(engine, reqs, report):
    """Warm timings and a device-time breakdown of one prefill at the
    512 bucket and one all-slot decode step (torch.profiler)."""
    import numpy as np
    import torch

    model = engine.model
    cfg, params = model.cfg, model.params
    from repro_torch.models import transformer

    prompt = max(reqs, key=lambda r: len(r.prompt)).prompt
    sb = model._bucket(len(prompt))
    tokens = torch.zeros((1, sb), dtype=torch.long, device="cuda")
    tokens[0, : len(prompt)] = torch.tensor(prompt, device="cuda")
    positions = np.full(SLOTS, len(prompt), np.int64)
    tables = np.arange(SLOTS * MAX_BLOCKS_PER_SEQ, dtype=np.int32).reshape(
        SLOTS, MAX_BLOCKS_PER_SEQ) % (NUM_BLOCKS - 1) + 1
    last = np.ones(SLOTS, np.int64)
    active = np.ones(SLOTS, bool)

    def prefill():
        with torch.no_grad():
            transformer.prefill_step(params, cfg, {"tokens": tokens}, max_len=sb)

    def decode():
        model.decode(last, positions, tables, active)

    for name, fn in (("prefill S=%d" % sb, prefill), ("decode %d slots" % SLOTS, decode)):
        profile_fn(name, fn, report)


def _union_ms(prof):
    """The time the device was busy in a trace: the union of its device
    records' intervals (kernels on several streams overlap, so their sum
    can exceed the wall); None where the trace holds no device record."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type.name == "CUDA")
    if not spans:
        return None
    total, (lo, hi) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > hi:
            total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return (total + hi - lo) / 1e3


def profile_fn(name, fn, report):
    """Warm wall time of ``fn`` (min of 3, host clock ended by a sync), the
    span of one more call on the device (CUDA events, no profiler), and a
    device-time breakdown of another (torch.profiler). The idle share is
    1 - device busy / wall, device busy being the union of the trace's
    device records (kernels of concurrent streams counted once); where the
    trace holds no device time it is None. The kernels' summed time is
    printed beside it. The span share (span / wall) is reported on its
    own: it comes from another call and counts the gaps between kernels as
    busy, so it is not an idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    span_ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

    def dev(e):
        t = getattr(e, "self_device_time_total", None)
        return e.self_cuda_time_total if t is None else t

    sum_ms = sum(dev(e) for e in events) / 1e3
    union_ms = _union_ms(prof)
    busy_ms = sum_ms if union_ms is None else union_ms  # records without intervals: their sum
    top = sorted(events, key=dev, reverse=True)[:10]
    launches = sum(e.count for e in events)
    wall = min(walls)
    idle = 1 - busy_ms / wall if busy_ms else None
    idle_text = f"{idle:.3f}" if busy_ms else "None (the trace holds no device time)"
    print(f"profile {name}: wall {wall:.3f} ms (min of {walls}), device busy "
          f"{busy_ms:.3f} ms (kernel times summed {sum_ms:.3f} ms), idle share {idle_text}, "
          f"{launches} kernel launches in the trace; "
          f"span by CUDA events {span_ms:.3f} ms, span share {span_ms / wall:.3f}")
    for e in top:
        print(f"profile {name}:   {dev(e) / 1e3:8.3f} ms x{e.count:5d}  {e.key[:90]}")
    report.setdefault("profile", {})[name] = dict(wall_ms=wall, busy_ms=busy_ms, idle_share=idle,
                                                  span_ms=span_ms, span_share=span_ms / wall)


# ---------------------------------------------------------------------------
# phase 9: the recurrent families (rwkv6-3b, hymba-1.5b) and their chunked
# linear-attention scan
# ---------------------------------------------------------------------------

LA_REPLACES = "src/repro/kernels/rwkv6.py:24"
LA_SOURCE = "src/repro_torch/csrc/linear_attention.cu"
# the reference suite's (t, n, m) cases (tests/test_kernels.py
# test_linear_attention), B=2 H=3, fp32 with s0, both read-outs, chunk 16
# and 32: elementwise |kernel - plain| <= 1e-4 + 1e-4 |plain|, the
# reference's tolerance (both sum fp32 in other orders)
LA_CASES = [(40, 8, 12), (64, 16, 16), (33, 8, 8)]
LA_TOL = (1e-4, 1e-4)
# card shapes, bf16 r/k/v: the fp32 state to max|diff| <= 1e-4 max|plain|
# (relative to the largest entry: the state's entries span decades, and
# near-zero ones cancel); o, rounded to bf16 by both, to max|diff| <= one
# bf16 step at max|plain|: an entry far smaller than the terms it sums
# carries their fp32 rounding, which can exceed its own bf16 step, so the
# step is taken at the output's scale (the elementwise worst is printed);
# and the same inputs in fp32, o to 1e-4 of max|plain|
LA_REL_TOL = 1e-4
# on two slices of rwkv6's card shape (b = 0 with the first LA_ORACLE_HEADS
# heads, and the (b, head) that holds the whole tensor's worst bf16 o entry,
# counted in bf16 steps of the entry's own magnitude) the kernel and the
# plain version both stand against the exact per-token recurrence in fp64:
# the kernel's max|o - oracle| may exceed the plain version's by at most one
# bf16 step at max|oracle| (bf16 o) or by LA_REL_TOL max|oracle| (o from
# fp32 inputs); each one's elementwise worst, in bf16 steps of the entry's
# own magnitude, is printed beside it, and at the worst entry itself both
# forms' values beside the oracle's
LA_ORACLE_HEADS = 8
# the cross-route check: the kernel against a loop of the decode step over
# the same tokens (exact per-token recurrence vs the chunked form): the
# state to LA_REL_TOL, o (bf16) to max|diff| <= 1e-2 max|step|, two bf16
# steps of the largest output
LA_STEP_O_REL_TOL = 1e-2
RECURRENT = (("rwkv6-3b", 4), ("hymba-1.5b", 2))  # (arch, batch)
RECURRENT_T = 2048
GEN_PROMPT, GEN_NEW = 64, 16


def _bf16_step(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    import torch

    mag = x.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.ldexp(torch.ones_like(mag), torch.floor(torch.log2(mag)).int() - 7)


def _hold_bf16(name, label, got, want):
    """max|got - want| <= one bf16 step at max|want| (both round an fp32
    result to bf16); the elementwise worst, in steps at each entry's own
    magnitude, is printed beside it."""
    import torch

    g, w = got.float(), want.float()
    need(bool(torch.isfinite(g).all()), f"{name} [{label}]: non-finite kernel output")
    err = (g - w).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    step = float(_bf16_step(w.abs().max()))
    worst = float((err / _bf16_step(torch.maximum(g.abs(), w.abs()))).max()) if err.numel() else 0.0
    ok = max_abs <= step
    print(f"kernel {name} [{label}] o (bf16): max_abs={max_abs:.3e}, one bf16 step at "
          f"max|plain| {float(w.abs().max()):.3e} is {step:g} {'ok' if ok else 'FAIL'} "
          f"(elementwise worst {worst:.0f} steps of the entry's own magnitude)")
    need(ok, f"{name} kernel disagrees with plain version by more than one bf16 step: {label}")
    return max_abs


def _hold_rel(name, label, got, want, tol):
    """max|got - want| <= tol * max|want|."""
    import torch

    need(bool(torch.isfinite(got).all()), f"{name} [{label}]: non-finite output")
    max_abs = float((got.float() - want.float()).abs().max())
    rel = _rel(got, want)
    print(f"kernel {name} [{label}]: max_abs={max_abs:.3e} rel={rel:.3e} (tol {tol:g} of max) "
          f"{'ok' if rel <= tol else 'FAIL'}")
    need(rel <= tol, f"{name} disagrees: {label} rel {rel:.3e} > {tol:g}")
    return max_abs


def _la_card_inputs(arch, T, gen):
    """The scan's inputs at ``arch``'s card shape, built the way the
    model builds them from random activations: rwkv6's transposed
    (B, S, H, N) views (bf16 r/k/v, fp32 Finch decay ``-exp(w0 + small)``,
    fp32 u); hymba's ``hybrid._ssd_inputs`` on random weights (broadcast
    r/k/w). Returns (r, k, v, w_log, u, label)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import hybrid, layers as L, ssm

    cfg = get_config(arch)
    B = dict(RECURRENT)[arch]
    d = cfg.d_model
    if cfg.family == "ssm":
        N, H = cfg.resolved_head_dim(), ssm._num_heads(cfg)
        r, k, v = (ssm._heads(torch.randn((B, T, d), generator=gen, device="cuda").bfloat16(), H, N)
                   for _ in range(3))
        w0 = torch.linspace(-5.0, -0.5, d, device="cuda")
        w = ssm._heads(-torch.exp(w0 + 0.5 * torch.randn((B, T, d), generator=gen, device="cuda")),
                       H, N)
        u = 0.5 * torch.randn((H, N), generator=gen, device="cuda")
        return r, k, v, w, u, f"{arch} B={B} H={H} T={T} N=M={N} bf16 r/k/v, fp32 w"
    di, N = cfg.resolved_d_inner(), cfg.ssm_state
    nh = hybrid.ssm_heads(cfg)
    p = {name: L.dense_init(gen, shape, dtype=torch.bfloat16, device="cuda")
         for name, shape in (("ssm_in", (d, 2 * di)), ("ssm_dt", (d, nh)), ("ssm_bc", (d, 2 * N)))}
    p["dt_bias"] = torch.zeros(nh, device="cuda")
    x = torch.randn((B, T, d), generator=gen, device="cuda").bfloat16()
    r, k, v, w, _, _ = hybrid._ssd_inputs(p, cfg, x)
    need(r.stride(1) == 0 and k.stride(1) == 0 and w.stride(3) == 0,
         f"hymba's SSD inputs are not the broadcast views: {r.stride()} {w.stride()}")
    return r, k, v, w, None, (f"{arch} B={B} nh={nh} T={T} N={N} M={cfg.ssm_head_dim} "
                              f"bf16 broadcast r/k, fp32 broadcast w")


def _worst_entry(got, want):
    """The index (b, h, t, m) of the largest |got - want| counted in bf16
    steps of the entry's own magnitude (``_hold_bf16``'s elementwise
    worst), and that count."""
    import numpy as np
    import torch

    g, w = got.float(), want.float()
    steps = (g - w).abs() / _bf16_step(torch.maximum(g.abs(), w.abs()))
    idx = np.unravel_index(int(steps.argmax()), tuple(steps.shape))
    return tuple(int(i) for i in idx), float(steps.max())


def _la_oracle(label, inputs, outs, b, heads):
    """``inputs`` (r, k, v, w, u) at rwkv6's card shape and ``outs`` the
    (kernel, plain) o from bf16 inputs and from the same inputs in fp32:
    on the slice (b, heads), both forms against the per-token recurrence
    (``impl="ref"``) in fp64. Returns the kernel's largest |o - oracle|
    from fp32 inputs, and the fp64 oracle of the slice."""
    import torch

    from repro_torch.hopper import ops

    r, k, v, w, u = inputs
    sl = (slice(b, b + 1), heads)
    where = f"b={b} heads {heads.start}..{heads.stop - 1}"
    oracle, _ = ops.linear_attention(*(x[sl].double() for x in (r, k, v, w)), u[heads].double(),
                                     impl="ref")
    torch.cuda.synchronize()
    scale = float(oracle.abs().max())
    step = float(_bf16_step(oracle.abs().max()))
    own_step = _bf16_step(oracle)
    errs = {}
    for kind, (kern, plain) in outs.items():
        err = {}
        for form, o in (("kernel", kern), ("plain", plain)):
            d = (o[sl].double() - oracle).abs()
            err[form] = float(d.max())
            print(f"kernel linear_attention [{label} {where}, o from {kind} inputs] {form} "
                  f"vs fp64 per-token oracle: max_abs={err[form]:.3e} (max|oracle| {scale:.3e}), "
                  f"elementwise worst {float((d / own_step).max()):.0f} bf16 steps of the "
                  f"entry's own magnitude")
        slack = step if kind == "bf16" else LA_REL_TOL * scale
        ok = err["kernel"] <= err["plain"] + slack
        print(f"kernel linear_attention [{label} {where}, {kind} inputs]: kernel's error vs the "
              f"oracle within the plain version's + {slack:.3e} {'ok' if ok else 'FAIL'}")
        need(ok, f"linear_attention kernel further from the fp64 oracle than the plain version "
                 f"({where}, {kind} inputs): {err['kernel']:.3e} > {err['plain']:.3e} + {slack:.3e}")
        errs[kind] = err["kernel"]
    return errs["fp32"], oracle


def _la_worst_entry_oracle(label, inputs, outs, report):
    """The fp64 oracle on the (b, head) of the whole tensor's worst bf16 o
    entry (kernel vs plain, in the entry's own bf16 steps): both forms held
    against it on that slice (``_la_oracle``), and at the entry itself the
    kernel's, the plain version's and the oracle's values, each form's
    distance from the oracle in bf16 steps of the oracle's magnitude and
    as a share of max|oracle| on the slice."""
    kern, plain = outs["bf16"]
    (b, h, t, m), steps = _worst_entry(kern, plain)
    print(f"kernel linear_attention [{label}] worst bf16 o entry (b={b}, h={h}, t={t}, m={m}): "
          f"{steps:.0f} bf16 steps of its own magnitude between kernel and plain")
    err32, oracle = _la_oracle(label, inputs, outs, b, slice(h, h + 1))
    want = float(oracle[0, 0, t, m])
    scale = float(oracle.abs().max())
    own = float(_bf16_step(oracle[0, 0, t, m].abs()))
    entry = dict(b=b, h=h, t=t, m=m, steps_kernel_vs_plain=steps, oracle=want,
                 max_abs_oracle_slice=scale)
    for form, o in (("kernel", kern), ("plain", plain)):
        got = float(o[b, h, t, m])
        entry[form] = got
        entry[f"{form}_steps_vs_oracle"] = abs(got - want) / own
        entry[f"{form}_err_share_of_max"] = abs(got - want) / scale
        print(f"kernel linear_attention [{label}] at the worst entry: {form} {got:.6e}, fp64 oracle "
              f"{want:.6e}: {abs(got - want) / own:.1f} bf16 steps of the oracle's magnitude, "
              f"{abs(got - want) / scale:.3e} of max|oracle| on the slice")
    miss = {form: abs(entry[form] - want) for form in ("kernel", "plain")}
    entry["kernel_within_2x_plain"] = miss["kernel"] <= 2 * miss["plain"]
    print(f"kernel linear_attention [{label}] at the worst entry: kernel's miss {miss['kernel']:.3e}, "
          f"plain's {miss['plain']:.3e}: within 2x {'yes' if entry['kernel_within_2x_plain'] else 'no'}")
    entry["terms"] = _la_entry_terms(inputs, b, h, t, m, miss)
    report["la_worst_entry"] = entry
    return err32


def _la_entry_terms(inputs, b, h, t, m, miss, chunk=32):
    """The fp64 terms of rwkv6's o at (b, h, t, m) as the chunked scan
    forms them (chunk 32): the read-out of the state entering t's chunk
    (the per-token recurrence up to the chunk's first step), the
    intra-chunk scores times v, and the bonus sum_n r u k v. Printed
    beside the fp32 spacing at the largest term's magnitude, the scale
    at which an fp32 sum of these terms rounds, and each form's miss
    (``miss``) in units of it and in fp32 roundings (2^-24) of the sum of
    the terms' magnitudes."""
    import numpy as np
    import torch

    from repro_torch.hopper import ops

    r, k, v, w, u = inputs
    w = w.clamp_min(ops.W_LOG_FLOOR)
    c0 = (t // chunk) * chunk
    sl = (slice(b, b + 1), slice(h, h + 1), slice(0, c0))
    N, M = r.shape[3], v.shape[3]
    if c0:
        _, S = ops.linear_attention(*(x[sl].double() for x in (r, k, v, w)), u[h:h + 1].double(),
                                    impl="ref")
        S = S[0, 0]
    else:
        S = torch.zeros((N, M), dtype=torch.float64, device=r.device)
    rc, kc, vc, wc = (x[b, h, c0:t + 1].double() for x in (r, k, v, w))
    inc = torch.cumsum(wc, 0)
    te = t - c0
    r_dec = rc[te] * torch.exp(inc[te] - wc[te])  # RWKV: the exclusive decay
    inter = float(r_dec @ S[:, m])
    scores = (r_dec[None, :] * torch.exp(-inc[:te]) * kc[:te]).sum(1)  # steps c0 .. t - 1
    intra_terms = scores * vc[:te, m]
    intra = float(intra_terms.sum())
    bonus = float((rc[te] * u[h].double() * kc[te]).sum() * vc[te, m])
    largest = max(abs(inter), abs(intra), abs(bonus), float(intra_terms.abs().max()) if te else 0.0)
    ulp = float(np.spacing(np.float32(largest)))
    # the sum of the magnitudes of all the per-token terms: the recurrence on |r|, |k|, |v|, |u|
    sl_t = (slice(b, b + 1), slice(h, h + 1), slice(0, t + 1))
    mag, _ = ops.linear_attention(*(x[sl_t].double().abs() for x in (r, k, v)), w[sl_t].double(),
                                  u[h:h + 1].double().abs(), impl="ref")
    mag = float(mag[0, 0, t, m])
    terms = dict(inter=inter, intra=intra, bonus=bonus, total=inter + intra + bonus,
                 largest=largest, fp32_spacing=ulp, magnitude_sum=mag,
                 kernel_miss_in_spacings=miss["kernel"] / ulp, plain_miss_in_spacings=miss["plain"] / ulp,
                 kernel_miss_in_roundings_of_sum=miss["kernel"] / mag / 2.0 ** -24,
                 plain_miss_in_roundings_of_sum=miss["plain"] / mag / 2.0 ** -24)
    print(f"kernel linear_attention at the worst entry, fp64 terms of o (chunk {chunk}, step {te} "
          f"of its chunk): state read-out {inter:.6e}, intra-chunk {intra:.6e} (largest of its "
          f"{te} terms {float(intra_terms.abs().max()) if te else 0.0:.6e}), bonus {bonus:.6e}, sum "
          f"{inter + intra + bonus:.6e}; fp32 spacing at the largest term {ulp:.3e}: the kernel "
          f"misses by {miss['kernel'] / ulp:.2f} of it, the plain form by "
          f"{miss['plain'] / ulp:.2f}; the terms' magnitudes sum to {mag:.3e}, of which the "
          f"kernel misses by {terms['kernel_miss_in_roundings_of_sum']:.2f} fp32 roundings "
          f"(2^-24), the plain form by {terms['plain_miss_in_roundings_of_sum']:.2f}")
    return terms


def check_la_kernels(report):
    """The linear-attention kernel against its plain version on the card:
    the reference suite's cases (fp32, s0, both read-outs, chunk 16 and
    32), then both models' card shapes (T and a ragged T - 1), and a slice
    of rwkv6's card shape against the fp64 per-token oracle. Records the
    largest |kernel - plain| from fp32 inputs and from bf16 inputs apart."""
    import torch

    from repro_torch.hopper import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    errs = {"fp32": [], "bf16": []}
    for mode in ("rwkv", "ssd"):
        for t, n, m in LA_CASES:
            r, k = (torch.randn((2, 3, t, n), generator=gen, device="cuda") for _ in range(2))
            v = torch.randn((2, 3, t, m), generator=gen, device="cuda")
            w = -(0.001 + 1.999 * torch.rand((2, 3, t, n), generator=gen, device="cuda"))
            u = torch.randn((3, n), generator=gen, device="cuda") if mode == "rwkv" else None
            s0 = torch.randn((2, 3, n, m), generator=gen, device="cuda")
            for chunk in (16, 32):
                got = ops.linear_attention(r, k, v, w, u, s0, impl="cuda", chunk=chunk)
                want = ops.linear_attention(r, k, v, w, u, s0, impl="torch", chunk=chunk)
                torch.cuda.synchronize()
                label = f"{mode} t={t} n={n} m={m} chunk={chunk} fp32 s0"
                errs["fp32"].append(_hold("linear_attention", label + " o", got[0], want[0], LA_TOL))
                errs["fp32"].append(_hold("linear_attention", label + " S", got[1], want[1], LA_TOL))
    # edge shapes: T of 0, 1 and 33; chunk 1 and 34; N of 128 (a thread's
    # staging batch of 8 values) and 5 (not a multiple of 4); M of 80 and 20
    # (a last 64-column block narrower than 64)
    for T, n, m, chunk in ((0, 16, 24, 32), (1, 16, 24, 32), (33, 64, 80, 16), (45, 128, 80, 34),
                           (40, 5, 20, 1)):
        r, k = (torch.randn((2, 3, T, n), generator=gen, device="cuda") for _ in range(2))
        v = torch.randn((2, 3, T, m), generator=gen, device="cuda")
        w = -(0.001 + 1.999 * torch.rand((2, 3, T, n), generator=gen, device="cuda"))
        s0 = torch.randn((2, 3, n, m), generator=gen, device="cuda")
        for u in (torch.randn((3, n), generator=gen, device="cuda"), None):
            got = ops.linear_attention(r, k, v, w, u, s0, impl="cuda", chunk=chunk)
            want = ops.linear_attention(r, k, v, w, u, s0, impl="torch", chunk=chunk)
            torch.cuda.synchronize()
            label = f"{'rwkv' if u is not None else 'ssd'} T={T} n={n} m={m} chunk={chunk} fp32 s0"
            errs["fp32"].append(_hold("linear_attention", label + " o", got[0], want[0], LA_TOL))
            errs["fp32"].append(_hold("linear_attention", label + " S", got[1], want[1], LA_TOL))
    for arch, _ in RECURRENT:
        for T in (RECURRENT_T, RECURRENT_T - 1):
            r, k, v, w, u, label = _la_card_inputs(arch, T, gen)
            got = ops.linear_attention(r, k, v, w, u, impl="cuda")
            want = ops.linear_attention(r, k, v, w, u, impl="torch")
            torch.cuda.synchronize()
            errs["bf16"].append(_hold_bf16("linear_attention", label, got[0], want[0]))
            errs["bf16"].append(_hold_rel("linear_attention", label + " S (fp32)", got[1], want[1],
                                          LA_REL_TOL))
            r32, k32, v32 = (x.float() for x in (r, k, v))
            got32 = ops.linear_attention(r32, k32, v32, w, u, impl="cuda")
            want32 = ops.linear_attention(r32, k32, v32, w, u, impl="torch")
            torch.cuda.synchronize()
            errs["fp32"].append(_hold_rel("linear_attention", label + ", in fp32: o", got32[0],
                                          want32[0], LA_REL_TOL))
            if arch == RECURRENT[0][0] and T == RECURRENT_T:
                inputs = (r, k, v, w, u)
                outs = {"bf16": (got[0], want[0]), "fp32": (got32[0], want32[0])}
                err_heads, _ = _la_oracle(label, inputs, outs, 0, slice(0, LA_ORACLE_HEADS))
                err_worst = _la_worst_entry_oracle(label, inputs, outs, report)
                report["la_err_oracle_fp32"] = max(err_heads, err_worst)
                del inputs, outs
            del r, k, v, w, r32, k32, v32, got, want, got32, want32
    report["la_err"] = {kind: max(e) for kind, e in errs.items()}


def _stored_bytes(x):
    """Bytes a tensor's distinct elements take: broadcast (stride-0) dims
    count once."""
    n = 1
    for size, stride in zip(x.shape, x.stride()):
        n *= size if stride else 1
    return n * x.element_size()


def la_bound_ms(r, k, v, w, u, chunk=32):
    """Least time for one scan on an H100: the larger of its bytes (each
    input's distinct elements read once, o and the fp32 state written
    once) over HBM bandwidth and its fp32 operations over the CUDA-core
    peak: per (b, h) and chunk of c steps, 2 N for each unmasked score
    pair, 2 M for each pair's share of the read-out, 2 c N M each for
    the read-out against the state and the state update (c(c-1)/2 pairs
    for the RWKV mask t > s plus its c-term bonus, c(c+1)/2 for SSD)."""
    B, H, T, N = r.shape
    M = v.shape[3]
    out_bytes = B * H * T * M * v.element_size() + 4 * B * H * N * M
    nbytes = sum(_stored_bytes(x) for x in (r, k, v, w)) + out_bytes
    if u is not None:
        nbytes += _stored_bytes(u)
    ops_ = 0
    for c0 in range(0, T, chunk):
        c = min(chunk, T - c0)
        pairs = c * (c + 1) // 2 if u is None else c * (c - 1) // 2
        bonus = 0 if u is None else c * (3 * N + 2 * M)
        ops_ += 2 * pairs * (N + M) + 4 * c * N * M + bonus
    ops_ *= B * H
    return _bound(nbytes, ops_)


def _launch_shares(fn):
    """Each kernel's share of one call's device time, from a profile of
    three calls: [(kernel and its launches in the trace, share)], empty
    where the trace holds no device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # acc_events: keep every call's records (without it the profiler may
    # report only the last cycle's)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type.name == "CUDA":
            t = getattr(e, "self_device_time_total", None)
            rows.append((e.key, e.count, e.self_cuda_time_total if t is None else t))
    total = sum(t for _, _, t in rows)
    return [(f"{name[:60]} x{count}", t / total) for name, count, t in rows] if total else []


def time_la_kernels(report):
    """Kernel and plain version at both card shapes (in turns), against
    the bound, and each of the kernel's three launches' share of its device
    time (profile, taken before the CUDA-graph timing); no single PyTorch
    call computes a chunked decay scan, so there is no library time."""
    import torch

    from repro_torch.hopper import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    for arch, _ in RECURRENT:
        r, k, v, w, u, label = _la_card_inputs(arch, RECURRENT_T, gen)
        kern_fn = lambda: ops.linear_attention(r, k, v, w, u, impl="cuda")
        shares = _launch_shares(kern_fn)
        kern, plain = _in_turns(kern_fn, lambda: ops.linear_attention(r, k, v, w, u, impl="torch"), 3)
        dev = device_ms(kern_fn)
        bound, by = la_bound_ms(r, k, v, w, u)
        report.setdefault("la_time", {})[arch] = dict(
            shape=label, ms=min(kern), plain_ms=min(plain), library_ms=None, bound_ms=bound,
            bound_by=by, device_ms=dev, library_device_ms=None,
            launch_shares={name: share for name, share in shares})
        parts = "; ".join(f"{name} {share:.1%}" for name, share in shares)
        print(f"time linear_attention [{label}]: kernel {kern} ms (device time {_ms(dev)}; launch "
              f"shares (profile, the decay floor's clamp included): "
              f"{parts or 'the trace holds no device record'}), plain {plain} ms, library none "
              f"(no single PyTorch call computes a chunked decay scan), bound {bound:.5f} ms ({by})")
        del r, k, v, w


def cross_route_check(cfg, params, tokens):
    """Layer 0's scan inputs from the forward (rwkv6): the kernel's o and
    S_final against a loop of ``ops.linear_attention_step`` over every
    token (the exact per-token recurrence the decode path runs)."""
    import torch

    from repro_torch.hopper import ops
    from repro_torch.models import layers as L, ssm

    lp = ssm._layer(params, 0)
    x = L.rms_norm(params["embed"][tokens.long()], lp["tm_norm"], cfg.norm_eps)
    r, k, v, w, _ = ssm.time_mix_inputs(lp, cfg, x, ssm._shift(x))
    o, S = ops.linear_attention(r, k, v, w, lp["u"], impl="cuda")
    B, H, T, N = r.shape
    S_step = torch.zeros((B, H, N, v.shape[3]), device="cuda")
    o_step = []
    for t in range(T):
        o_t, S_step = ops.linear_attention_step(r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t],
                                                lp["u"], S_step)
        o_step.append(o_t)
    o_step = torch.stack(o_step, 2)
    torch.cuda.synchronize()
    label = f"{cfg.name} layer 0, kernel vs {T} decode steps"
    _hold_rel("linear_attention", label + " S (fp32)", S, S_step, LA_REL_TOL)
    _hold_rel("linear_attention", label + " o (bf16)", o, o_step, LA_STEP_O_REL_TOL)


def recurrent_phase(report, arch, batch):
    """``arch`` at full width and depth with random weights from seed
    ``SEED`` on the card: ``registry.forward`` and ``loss_fn`` on
    batch x RECURRENT_T tokens (launch counts zeroed just before each and
    read just after: linear_attention once per layer, and for hymba
    flash_attention once per layer; finite logits of the padded-vocab
    shape, a finite loss near ln(vocab)), ``serve.generate`` from a
    GEN_PROMPT-token prompt (no linear_attention launch: decode runs the
    step), the cross-route check for rwkv6, and a profile of a warm
    forward."""
    import math

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.hopper import dispatch
    from repro_torch.launch import serve
    from repro_torch.models import layers as L, registry

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    leaves = [x for x in params.values() if torch.is_tensor(x)] + list(params["layers"].values())
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"model {arch} full width: family={cfg.family} layers={cfg.num_layers} "
          f"d_model={cfg.d_model} heads={cfg.num_heads}x{cfg.resolved_head_dim()} d_ff={cfg.d_ff} "
          f"vocab={cfg.vocab_size} {cfg.dtype} params={nbytes / 1e9:.2f} GB, init "
          f"{time.perf_counter() - t0:.2f} s (depth not cut)")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, RECURRENT_T))).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, RECURRENT_T))).cuda()
    want = {"linear_attention": cfg.num_layers}
    if cfg.family == "hybrid":
        want["flash_attention"] = cfg.num_layers
        need(RECURRENT_T > cfg.sliding_window, "the forward must be longer than the window")

    with torch.no_grad():
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t = time.perf_counter()
        logits, _ = registry.forward(params, cfg, {"tokens": tokens})
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t) * 1e3
        launches = dict(dispatch.LAUNCHES)
        print(f"{arch} forward B={batch} T={RECURRENT_T}: {fwd_ms:.1f} ms (first call), kernel "
              f"launches {launches}, expected {want}")
        need(launches == want, f"{arch} forward launch counts != {want}")
        need(tuple(logits.shape) == (batch, RECURRENT_T, L.padded_vocab(cfg.vocab_size)),
             f"{arch} logits shape {tuple(logits.shape)}")
        need(bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits")
        del logits
        dispatch.reset_launches()
        loss = float(registry.loss_fn(params, cfg, {"tokens": tokens, "labels": labels}))
        torch.cuda.synchronize()
        launches_loss = dict(dispatch.LAUNCHES)
        print(f"{arch} loss_fn: {loss:.4f} (ln vocab = {math.log(cfg.vocab_size):.4f}), "
              f"launches {launches_loss}")
        need(math.isfinite(loss), f"{arch}: non-finite loss")
        need(launches_loss == want, f"{arch} loss_fn launch counts != {want}")

        prompt = tokens[:, :GEN_PROMPT]
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t = time.perf_counter()
        out = serve.generate(cfg, params, prompt, GEN_NEW, GEN_PROMPT + GEN_NEW + 1)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        gen_launches = dict(dispatch.LAUNCHES)
        steps = GEN_PROMPT + GEN_NEW - 1
        print(f"{arch} generate B={batch} prompt {GEN_PROMPT} + {GEN_NEW} new: {gen_s:.3f} s, "
              f"{steps} decode steps ({gen_s / steps * 1e3:.2f} ms/step), "
              f"{batch * GEN_NEW / gen_s:.1f} new tok/s (prompt included in the time); "
              f"kernel launches {gen_launches}")
        need(tuple(out.shape) == (batch, GEN_PROMPT + GEN_NEW), f"{arch} generate shape")
        need(bool((out[:, :GEN_PROMPT] == prompt).all()), f"{arch} generate changed the prompt")
        new = out[:, GEN_PROMPT:]
        need(bool(((new >= 0) & (new < cfg.vocab_size)).all()), f"{arch}: token outside the vocab")
        need(gen_launches.get("linear_attention", 0) == 0,
             f"{arch} generate launched the chunked scan: decode runs the step")
        print(f"{arch} generate sample: {new[0].tolist()}")

        if cfg.family == "ssm":
            cross_route_check(cfg, params, tokens)
        profile_fn(f"{arch} forward B={batch} T={RECURRENT_T}",
                   lambda: registry.forward(params, cfg, {"tokens": tokens}), report)
    report.setdefault("recurrent", {})[arch] = dict(
        forward_ms=fwd_ms, launches=launches, loss=loss, gen_s=gen_s,
        gen_tok_s=batch * GEN_NEW / gen_s, gen_ms_per_step=gen_s / steps * 1e3)


# ---------------------------------------------------------------------------
# phase 10: the sequence-parallel ring (remote_ring_hop's kernel, the flash
# KV ring, cache-sharded ring decode) at occamy-gptj's attention width
# ---------------------------------------------------------------------------

RING_HOP_REPLACES = "src/repro/core/streams.py:256"
RING_HOP_SOURCE = "src/repro_torch/csrc/ring_hop.cu"
RING_N = 4
# (bytes, src byte offset, dst byte offset): odd sizes, a common offset
# (the kernel's head, body and tail) and offsets that differ mod 16 (its
# byte loop); held bitwise to copy_
RING_HOP_CASES = [(1, 0, 0), (15, 0, 0), (16, 0, 0), (17, 3, 3), (33, 1, 2), (4099, 5, 0),
                  (65543, 7, 7), (1 << 20, 0, 0), (3000001, 13, 13), (4 << 20, 0, 8)]
# the flash ring's output against the unsharded FA kernel on the same card:
# fp32 elementwise to 1e-4 + 1e-4 |full| (both sum in fp32, in other
# orders). bf16 in the Frobenius norm, ||ring - full|| <= RING_BF16_REL
# ||full||: each hop's partial is rounded to bf16 before the fp32 merge and
# the merged output once more; one bf16 rounding leaves at most 2^-9 of
# each entry, about 2^-9/sqrt(3) ~ 1.1e-3 in the norm, so the ring's
# roundings and the unsharded kernel's come to about 2-3e-3 together, and
# RING_BF16_REL is four times that. The same ring with its last hop left
# out (a planted fault, read in the phase) must lie above it. On an H100
# the sound rings read 0.8e-3 to 1.7e-3 and the rings without their last
# hop 0.12 to 1.24, at the CARD cases' seeds. Elementwise,
# max|ring - full| <= RING_BF16_STEPS bf16 steps at max|full| (a partial
# over fewer keys can reach max|v|, about twice max|o|)
RING_F32_TOL = (1e-4, 1e-4)
RING_BF16_REL = 1e-2
RING_BF16_STEPS = 4
# fp32 cases of the hold (label, B, H, S, D, causal, window, zigzag), at
# the head dim the fp32 kernel is held at in phase 2, at GPT-J's context
# and at the long-context length of the bf16 ring
RING_F32_CASES = [("fp32 S=2048 D=128 causal zigzag", 1, 16, 2048, 128, True, 0, True),
                  ("fp32 S=2048 D=128 causal contiguous", 1, 16, 2048, 128, True, 0, False),
                  ("fp32 S=2048 D=128 window 512", 1, 16, 2048, 128, True, 512, True),
                  ("fp32 S=16384 D=128 causal zigzag", 1, 16, 16384, 128, True, 0, True),
                  ("fp32 S=16384 D=128 causal contiguous", 1, 16, 16384, 128, True, 0, False)]


def _ring_devices():
    """One card per rank when the machine has RING_N cards, else None (all
    ranks on cuda:0)."""
    import torch

    n = torch.cuda.device_count()
    return [torch.device("cuda", r) for r in range(RING_N)] if n >= RING_N else None


def _ring_expected(row, n=RING_N):
    """The launches one ring call of ``row`` makes: per rank, one ring_hop
    per leaf (k and v) per send and one FA call per hop (zigzag: one at
    hop 0, two at every later hop); the batch split one FA call per rank."""
    hops = row["hops"]
    if not hops:
        return {"flash_attention": n}
    fa = n * (1 + 2 * (hops - 1)) if "zigzag" in row["note"] else n * hops
    return {"ring_hop": 2 * (hops - 1) * n, "flash_attention": fa}


def check_ring_kernels(report):
    """The ring-hop kernel against copy_ (bitwise) at byte-odd sizes and
    offsets, and the flash ring in fp32 against the unsharded FA kernel at
    RING_F32_TOL, with remote_copy on the ring's every send."""
    import torch

    from repro_torch.hopper import ops, ring_hop
    from repro_torch.parallel.mesh import RingMesh

    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    devices = _ring_devices() or [torch.device("cuda", 0)] * 2
    worst = 0
    for nbytes, a, b in RING_HOP_CASES:
        src = torch.randint(0, 256, (nbytes + a,), dtype=torch.uint8, generator=gen,
                            device=devices[0])[a:]
        dst = torch.zeros(nbytes + b, dtype=torch.uint8, device=devices[1])[b:]
        ref = torch.zeros_like(dst)
        torch.cuda.synchronize()
        ring_hop.ring_hop_cuda(src, dst)
        ring_hop.ring_hop_plain(src, ref)
        torch.cuda.synchronize()
        err = int((dst.int() - ref.int()).abs().max())
        worst = max(worst, err)
        print(f"kernel ring_hop [{nbytes} B, src offset {a}, dst offset {b}]: max_abs={err} "
              f"{'ok' if err == 0 else 'FAIL'} (bitwise vs copy_)")
        need(err == 0, f"ring_hop kernel differs from copy_ at {nbytes} B offsets {a}/{b}")
    report["ring_hop_err"] = float(worst)
    mesh = RingMesh(RING_N, devices=_ring_devices())
    for label, B, H, S, D, causal, window, zigzag in RING_F32_CASES:
        q, k, v = (torch.randn((B, H, S, D), generator=gen, device="cuda") for _ in range(3))
        full = ops.flash_attention(q, k, v, causal=causal, window=window)
        got = ops.flash_attention(q, k, v, causal=causal, window=window, zigzag=zigzag,
                                  mesh=mesh, remote_copy=True)
        torch.cuda.synchronize()
        _hold("flash ring", label, got, full, RING_F32_TOL)
        del q, k, v, full, got


def _ring_without_last_hop(q, k, v, mesh, **kw):
    """The ring with its last hop left out: a planted fault, to show that
    the bf16 hold sees one."""
    from repro_torch.hopper import ops, partition

    ring_scan = partition.ring_scan
    partition.ring_scan = lambda *a, hops, **k_: ring_scan(*a, hops=hops - 1, **k_)
    try:
        return ops.flash_attention(q, k, v, mesh=mesh, remote_copy=True, **kw)
    finally:
        partition.ring_scan = ring_scan


def ring_phase(report):
    """The ring's entry point (``repro_torch.launch.ring_attention.run``)
    once, with the launch counts zeroed just before and read just after:
    the hop sweep (bitwise, then timed cold and warm), the flash ring at
    S=2048 and 16384 (zigzag, contiguous, window 512; overlap on and off,
    remote_copy on and off; then timed) and a batch split, and ring decode
    with bf16 and fp8 pools. Each ring call's launches equal the plan's
    (``_ring_expected``; 0 ring_hop launches with remote_copy off and in
    ring decode), and the run's totals equal the per-call launches times
    the calls the run made; overlap and remote_copy leave the output
    bitwise unchanged; the bf16 ring within RING_BF16_REL (Frobenius) and
    RING_BF16_STEPS (elementwise) of the unsharded kernel, and the ring
    with its last hop left out beyond RING_BF16_REL; ring decode bitwise
    ``ring_decode_reference`` and within ORACLE_TOL of contiguous decode.
    Then a profile of a warm zigzag ring call at each S."""
    import torch

    from repro_torch.hopper import dispatch, ops
    from repro_torch.launch import ring_attention as ra
    from repro_torch.parallel.mesh import RingMesh

    devices = _ring_devices()
    cards = len(set(devices)) if devices else 1
    torch.cuda.synchronize()
    dispatch.reset_launches()
    out = ra.run(n=RING_N, cases=ra.CARD, devices=devices)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    want = {"ring_hop": sum(r["calls"] for r in out["hops"])}
    for row in out["flash"]:
        exp = _ring_expected(row)
        exp_copy = {k: v for k, v in exp.items() if k != "ring_hop"}
        print(f"ring {row['name']}: {row['note']}; launches per call {row['launches']}, "
              f"expected {exp} (copy route {exp_copy}); calls {row['calls']}; "
              f"||ring - full|| / ||full|| {row['rel_err']:.4e}; max|ring - full| "
              f"{row['max_abs_err']:.4e} at max|full| {row['max_abs_full']:.4e}; bitwise "
              f"overlap on/off {row['bitwise_overlap']}, remote_copy on/off "
              f"{row['bitwise_remote_copy']}")
        need(row["launches"]["overlap"] == exp and row["launches"]["sync"] == exp,
             f"{row['name']}: launches {row['launches']} != {exp}")
        need(row["launches"]["copy"] == exp_copy,
             f"{row['name']}: remote_copy=False launched {row['launches']['copy']}")
        need(row["bitwise_overlap"] and row["bitwise_remote_copy"],
             f"{row['name']}: overlap or remote_copy changed the output")
        need(row["rel_err"] <= RING_BF16_REL,
             f"{row['name']}: ||ring - full|| / ||full|| {row['rel_err']:.4e} > {RING_BF16_REL}")
        step = float(_bf16_step(torch.tensor(row["max_abs_full"])))
        need(row["max_abs_err"] <= RING_BF16_STEPS * step,
             f"{row['name']}: max|ring - full| {row['max_abs_err']:.4e} > {RING_BF16_STEPS} "
             f"bf16 steps ({step:g}) at max|full|")
        for key in ("overlap", "sync", "copy"):
            for name, count in row["launches"][key].items():
                want[name] = want.get(name, 0) + count * row["calls"][key]
        want["flash_attention"] = want.get("flash_attention", 0) + row["calls"]["full"]
    for row in out["decode"]:
        tol = ORACLE_TOL["decode_attention"]["fp8" if row["pools"] == "fp8" else "bf16"]
        print(f"ring {row['name']}: bitwise ring_decode_reference {row['bitwise_reference']}, "
              f"overlap invariant {row['bitwise_overlap']}, Frobenius rel to contiguous decode "
              f"{row['rel_err_contiguous']:.3e} (tol {tol}), launches {row['launches']}")
        need(row["bitwise_reference"] and row["bitwise_overlap"],
             f"{row['name']}: not bitwise ring_decode_reference / overlap invariant")
        need(row["rel_err_contiguous"] <= tol, f"{row['name']}: far from contiguous decode")
        need("ring_hop" not in row["launches"], f"{row['name']}: ring decode launched ring_hop")
    need(all(r["bitwise"] for r in out["hops"]), "hop sweep: the hop differs from copy_")
    print(f"ring phase ({RING_N} ranks on {cards} card(s)): launches {launches}, expected {want}")
    need(launches == want, f"ring phase launch counts {launches} != {want}")
    report["ring_launches"] = launches
    report["ring_cards"] = cards

    for row in out["flash"]:
        print(f"time ring {row['name']}: ring {row['ring_ms']:.4f} ms (overlap), "
              f"{row['ring_sync_ms']:.4f} ms (sync); unsharded kernel {row['full_ms']:.4f} ms; "
              f"ring / unsharded {row['ring_ms'] / row['full_ms']:.2f}")
    for row in out["decode"]:
        print(f"time ring {row['name']}: ring {row['ring_ms']:.4f} ms, one-card reference "
              f"{row['reference_ms']:.4f} ms")
    report["ring_time"] = {r["name"]: r for r in out["flash"] + out["decode"]}

    report["ring_hop_time"] = {}
    for row in out["hops"]:
        nbytes = row["bytes"]
        if cards == 1:  # read and written once in HBM
            bound = 2 * nbytes / HBM_BYTES_PER_S * 1e3
        else:  # one way over NVLink
            bound = nbytes / NVLINK_BYTES_PER_S * 1e3
        report["ring_hop_time"][nbytes] = dict(
            ms=row["hop_ms"], plain_ms=row["copy_ms"], bound_ms=bound,
            warm_ms=row["hop_warm_ms"], warm_plain_ms=row["copy_warm_ms"])
        print(f"time ring_hop [{nbytes} B, {cards} card(s)]: cold (L2 flushed before each "
              f"call, events around the one call) kernel {row['hop_turns_ms']} ms, copy_ "
              f"{row['copy_turns_ms']} ms (the plain version and the library call); bound "
              f"{bound:.5f} ms (bytes); kernel / bound {row['hop_ms'] / bound:.2f}, "
              f"{(1 if cards > 1 else 2) * nbytes / row['hop_ms'] / 1e6:.1f} GB/s; warm (back "
              f"to back on the same buffers, L2-resident below 50 MB, host launch cost "
              f"included) kernel {row['hop_warm_ms']:.5f} ms, copy_ {row['copy_warm_ms']:.5f} ms")

    mesh = RingMesh(RING_N, devices=devices)
    for case, row in zip(ra.CARD.flash, out["flash"]):
        label, _, S, causal, window, zigzag = case
        if row["hops"] < 2:
            continue
        kw = dict(causal=causal, window=window, zigzag=zigzag)
        q, k, v = ra.flash_inputs(case, ra.CARD, "cuda")
        full = ops.flash_attention(q, k, v, causal=causal, window=window).float()
        fault = _ring_without_last_hop(q, k, v, mesh, **kw).float()
        rel = float((fault - full).norm() / full.norm())
        print(f"ring planted fault [{label}, last hop left out]: ||ring - full|| / ||full|| "
              f"{rel:.4e} (hold {RING_BF16_REL}; the sound ring "
              f"{row['rel_err']:.4e})")
        need(rel > RING_BF16_REL, f"ring [{label}]: the bf16 hold misses a left-out hop")
        if zigzag and causal and not window:
            profile_fn(f"flash ring S={S} zigzag, {RING_N} ranks",
                       lambda: ops.flash_attention(q, k, v, mesh=mesh, remote_copy=True), report)
            profile_fn(f"flash unsharded S={S}", lambda: ops.flash_attention(q, k, v), report)
        del q, k, v, full, fault


# ---------------------------------------------------------------------------


def check_hgmma(paths):
    """The disassembly of the built scaled libraries: every wgmma kernel
    (each instantiation of the GEMM's and the FA's wgmma route) issues the
    warpgroup MMA (HGMMA for 16-bit inputs, QGMMA for fp8), and the other
    routes' kernels do not."""
    import re

    for name in ("gemm_scaled", "flash_attention_scaled"):
        sass = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(paths[name])],
                              capture_output=True, text=True, check=True, timeout=120).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
                counts[fn] = {}
            elif fn is not None:
                for op in re.findall(r"\b([HQ]GMMA)\.", line):
                    counts[fn][op] = counts[fn].get(op, 0) + 1
        wg = {fn: ops for fn, ops in counts.items() if "wgmma_kernel" in fn}
        kinds = sorted({"+".join(sorted(ops)) or "none" for ops in wg.values()})
        print(f"sass {name}: {len(wg)} wgmma-route kernels, each issuing {kinds} "
              f"({min(sum(o.values()) for o in wg.values())}-{max(sum(o.values()) for o in wg.values())} "
              f"instructions); {len(counts) - len(wg)} other kernels, none")
        for fn, ops in counts.items():
            if fn in wg:
                need(sum(ops.values()) > 0, f"{name}: wgmma-route kernel {fn} issues no warpgroup MMA")
            else:
                need(not ops, f"{name}: warpgroup MMA outside the wgmma route ({fn})")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke run needs the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print(f"chip_smoke: no src/repro_torch under {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.hopper import build

    card = card_line()
    t_start = time.perf_counter()
    report = {}
    try:
        t = time.perf_counter()
        paths = build.build()
        print(f"build: {sorted(paths)} in {time.perf_counter() - t:.2f} s")
        for name, log in build.build_logs.items():
            regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            # the kernels this slice redesigned or repaired: every instantiation
            shown = regs if name in REDESIGNED else regs[:4]
            print(f"build {name}: " + " | ".join(shown))
        check_hgmma(paths)
        check_kernels(report)
        check_gcn_kernels(report)
        check_precision_kernels(report)
        gcn_phase(report)
        cases = _sparse_la_cases()
        check_sparse_la_kernels(report, cases)
        sparse_la_phase(report, cases)
        precision_ladder_phase(report)
        serve(report)
        gc.collect()  # occamy-gptj's weights went with serve()
        torch.cuda.empty_cache()
        print(f"after serving: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated on the card")
        check_la_kernels(report)
        for arch, batch in RECURRENT:
            recurrent_phase(report, arch, batch)
            gc.collect()
            torch.cuda.empty_cache()
        check_ring_kernels(report)
        ring_phase(report)
        time_kernels(report)
        time_gcn_kernels(report)
        time_sparse_la_kernels(report, cases)
        time_precision_kernels(report)
        time_la_kernels(report)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    t512 = report["fa_time"]["prefill S=512 bf16"]
    kernels = [{
        "name": "flash_attention", "route": "cuda", "source": FA_SOURCE,
        "replaces": FA_REPLACES, "launches": report["fa_launches"],
        "max_abs_err": max(report["fa_err"].values()),
        "ms": t512["ms"], "plain_ms": t512["plain_ms"],
        "bound_ms": t512["bound_ms"], "bound_by": t512["bound_by"],
        "library_ms": t512["library_ms"], "shape": t512["shape"],
        # device times (torch.profiler) beside the events' back-to-back ms
        "device_ms": t512["device_ms"], "library_device_ms": t512["library_device_ms"],
        "host_ms": t512["host_ms"],
    }]
    for name, source, replaces in (("gemm", GEMM_SOURCE, GEMM_REPLACES),
                                   ("spmm", SPMM_SOURCE, SPMM_REPLACES)):
        t = report[f"{name}_time"][OGBN_ARXIV[0]]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": report["gcn_launches"][name],
            "max_abs_err": report[f"{name}_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
        })
        if name == "gemm":  # device times (CUDA-graph replay) beside the events' ms
            kernels[-1].update(device_ms=t["device_ms"], library_device_ms=t["library_device_ms"])
    for name, source, replaces, case in SPARSE_LA_JSON:
        t = report[f"{name}_time"][case]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": report["sparse_la_launches"][name],
            "max_abs_err": report["sparse_la_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "device_ms": t["device_ms"], "library_device_ms": t["library_device_ms"],
        })
    for name, source, replaces, key in (
            ("gemm_scaled", GEMM_SCALED_SOURCE, GEMM_SCALED_REPLACES, "gemm_scaled_time"),
            ("flash_attention_scaled", FA_SCALED_SOURCE, FA_SCALED_REPLACES, "fa_scaled_time")):
        t = report[key]["fp8"]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": report["ladder_launches"][name],
            "max_abs_err": max(report["scaled_err"][name],
                               *(r["max_abs_err"] for r in report[key].values())),
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
            "policy": "fp8", "device_ms": t["device_ms"], "library": t["library"],
            # every policy: the kernel of the source it takes ("kernel_route"),
            # events and device times, the same-function library call's
            "policies": {pol: {f: r.get(f) for f in (
                "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "bound_by",
                "plain_ms", "promote")} | {"kernel_route": r["route"]}
                for pol, r in report[key].items()},
        })
    t = report["la_time"]["rwkv6-3b"]
    kernels.append({
        "name": "linear_attention", "route": "cuda", "source": LA_SOURCE,
        "replaces": LA_REPLACES,
        # one launch per layer in each model's forward (the slice's main path)
        "launches": sum(report["recurrent"][a]["launches"]["linear_attention"] for a, _ in RECURRENT),
        # the largest |kernel - plain| over every check; from fp32 inputs
        # (the kernel's own fp32 accuracy) and from bf16 inputs (the bf16
        # rounding of o at |o| ~ 1e2) apart, and the kernel's error against
        # the fp64 per-token oracle on a slice of this shape, fp32 inputs
        "max_abs_err": max(report["la_err"].values()),
        "max_abs_err_fp32_inputs": report["la_err"]["fp32"],
        "max_abs_err_bf16_inputs": report["la_err"]["bf16"],
        "max_abs_err_vs_fp64_oracle": report["la_err_oracle_fp32"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"], "shape": t["shape"],
        "device_ms": t["device_ms"],
        # both card shapes: device time, bound and each launch's share
        "card_shapes": {a: {f: r[f] for f in ("shape", "device_ms", "bound_ms", "bound_by",
                                                "launch_shares")}
                        for a, r in report["la_time"].items()},
    })
    t = report["ring_hop_time"][4 << 20]
    kernels.append({
        "name": "ring_hop", "route": "cuda", "source": RING_HOP_SOURCE,
        "replaces": RING_HOP_REPLACES,
        # the ring entry point's run: one launch per leaf (k, v) per send of
        # each flash ring call (checked and timed), and the hop sweep's
        # calls; ring decode sends none
        "launches": report["ring_launches"]["ring_hop"],
        "max_abs_err": report["ring_hop_err"],
        # 4 MiB, the K chunk of the S=2048 ring, cold (the L2 flushed before
        # each call); plain and library are copy_
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": t["plain_ms"], "shape": "4 MiB per hop",
        # the same two calls back to back on the same buffers: L2-resident,
        # so below the HBM bound
        "warm_ms": t["warm_ms"], "warm_plain_ms": t["warm_plain_ms"],
        # every size of the sweep, cold: [kernel ms, copy_ ms]
        "cold_ms_by_bytes": {str(n): [r["ms"], r["plain_ms"]]
                             for n, r in report["ring_hop_time"].items()},
        "ranks": RING_N, "cards": report["ring_cards"],
    })
    print(f"card: {card}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
