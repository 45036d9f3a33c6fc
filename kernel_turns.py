#!/usr/bin/env python3
"""Device times of the port's redesigned kernels and of the ring call, for
one checkout of the repo, on one NVIDIA card.

    python3 kernel_turns.py <checkout root> <label>

Builds that checkout's kernels and times them with its own
``repro_torch`` and ``chip_smoke.py`` helpers: the bf16 FA-2 forward
(B=1 H=16 D=256 causal; S = 512, and 2048-row ring blocks on and below
the diagonal), the BSR SpMM and the SpMSpM at the sparse trio's three
card densities ((8192, 16384) and (4096, 16384) x (16384, 4096)
operands), the ELL SpMM at the same three densities ((8192, 16384)
rows of sorted columns x (16384, 256)) and at the GCN's ogbn-arxiv size
((169343, 15) x (169343, 144)), the sparse trio's five fp32 stencils
(j2d5pt and j2d9pt on 8192^2, j3d7pt, j3d13pt and j3d27pt on 512^3), the
chunked scan at both recurrent models' card shapes, the
fp32 GEMM at the GCN's ogbn-arxiv and cora sizes ((n, 144) x (144, 144)),
the bf16 GEMM at 4096^3 (fp32 and bf16 out, and with the bf16 and fp16
accumulators at bk 256) and at the GCN width ((3327, 144) x (144, 144)),
and the
precision ladder's two kernels at its card shapes under every policy (the
scaled GEMM (2048, 4096) x (4096, 16384) with bk = 256, the scaled FA-2
B=1 H=K=16 S=2048 D=256 causal, on operands quantized as the ladder
quantizes them), each as a
device time (CUDA events around one replay of a CUDA graph of 20 calls);
the ring hop cold (L2 flushed before each call, events around the one
call, the median of 40) at 4 MiB and 64 MiB and warm (back to back, events over 50 calls,
the wrapper's host time included) at 4 MiB; then zigzag flash rings on
4 ranks of one card, at S = 2048 with every K/V send through the ring-hop
kernel (``remote_copy=True``) and at S = 16384 with ``copy_`` sends, and
one unsharded call at 16384 (host wall ended by a sync; the rings' min of
3 warm calls).
Prints one line, ``CMP {json}``.

To compare two versions on one card, unpack the other into a directory of
this checkout that ``.gitignore`` lists (``git archive``) and run both in
one command, in turns: old, new, new, old. Imports nothing of JAX.
"""
import json
import sys
import time

DENSITIES = (0.0012, 0.01, 0.028)  # launch/sparse_la.py's card densities


def graph_ms(fn, iters=20):
    """Mean device time of ``fn`` over one replay of a CUDA graph of
    ``iters`` calls, by CUDA events (``chip_smoke.device_ms``'s method, kept
    here since an older checkout's ``chip_smoke.py`` lacks it)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, flush, iters=40):
    """Median device time of one call of ``fn`` with the L2 flushed
    (``flush`` written) before it, by CUDA events around the call, after a
    warm-up (the median: a host stall that lets the flush end before the
    call is issued lands in one pair's time)."""
    import torch

    fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)[iters // 2]


def warm_ms(fn, iters=50):
    """Mean time per call of ``fn`` back to back, by CUDA events over
    ``iters`` calls: the host's issue sets it where it exceeds the device's."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn):
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main(root, label):
    sys.path[:0] = [f"{root}/src", root]
    import numpy as np
    import torch

    import chip_smoke as smoke
    from repro_torch.core import precision as prec
    from repro_torch.core import sparse
    from repro_torch.hopper import build, ops, ring_hop
    from repro_torch.hopper.flash_attention_scaled import flash_attention_scaled_kernel
    from repro_torch.hopper.gemm_scaled import gemm_scaled_kernel
    from repro_torch.launch import precision_ladder as pl
    from repro_torch.parallel.mesh import RingMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(("flash_attention", "bsr_spmm", "spmspm", "linear_attention", "ring_hop", "gemm",
                 "gemm_scaled", "flash_attention_scaled", "spmm", "stencil"))
    out = {"label": label}
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(S):  # the transformer's (B, S, H, D) -> (B, H, S, D) views
        return [torch.randn((1, S, 16, 256), generator=gen, device="cuda").bfloat16().transpose(1, 2)
                for _ in range(3)]

    q, k, v = qkv(512)
    out["fa_s512"] = graph_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", causal=True))
    q, k, v = qkv(2048)
    for name, off in (("fa_s2048_diag", 0), ("fa_s2048_past", 2048)):
        out[name] = graph_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", causal=True, q_offset=off,
                                                         return_lse=True))

    rng = np.random.default_rng(0)
    for d in DENSITIES:
        E = sparse.random_ell(rng, 8192, 16384, d)
        A = sparse.ell_to_bsr(E, 8, 128).to("cuda")
        D = torch.from_numpy(rng.standard_normal((16384, 256)).astype(np.float32)).cuda()
        out[f"bsr_{d}"] = graph_ms(lambda: ops.bsr_spmm(A, D, impl="cuda"))
        E = E.to("cuda")
        out[f"ell_{d}"] = graph_ms(lambda: ops.spmm(E, D, impl="cuda"))
    from repro_torch.launch import gcn_inference as gi
    from repro_torch.launch import sparse_la as sl

    adj = gi.adjacency(rng, 169343, 13.7).to("cuda")  # chip_smoke.OGBN_ARXIV's graph
    D = torch.randn((169343, 144), generator=gen, device="cuda")
    out["ell_ogbn"] = graph_ms(lambda: ops.spmm(adj, D, impl="cuda"))
    del adj, E
    for name, kind, offs in sl.STENCILS:
        shape = sl.CARD.grid_2d if kind == "2d" else sl.CARD.grid_3d
        g = torch.randn(shape, generator=gen, device="cuda")
        w = rng.standard_normal(len(offs)).astype(np.float32)
        out[f"stencil_{name}"] = graph_ms(lambda: ops.stencil(g, offs, w, impl="cuda"))
    del g

    R, C, K = sl.CARD.spmspm
    rng = np.random.default_rng(0)
    for d in DENSITIES:  # launch/sparse_la.py make_cases's operands
        A = sparse.random_ell(rng, R, K, d).to("cuda")
        B = sparse.random_ell(rng, C, K, sl.RIGHT_DENSITY).to("cuda")
        out[f"spmspm_{d}"] = graph_ms(lambda: ops.spmspm(A, B, K, impl="cuda"))
    del B
    for arch, _ in smoke.RECURRENT:
        r, k, v, w, u, _ = smoke._la_card_inputs(arch, smoke.RECURRENT_T, gen)
        out[f"la_{arch}"] = graph_ms(lambda: ops.linear_attention(r, k, v, w, u, impl="cuda"))
    del q, k, v, r, w, A, D
    for name, n in (("gemm_ogbn", 169343), ("gemm_cora", 2708)):  # the GCN's (n, 144) x (144, 144)
        a = torch.randn((n, 144), generator=gen, device="cuda")
        w = torch.randn((144, 144), generator=gen, device="cuda") / 12
        out[name] = graph_ms(lambda: ops.gemm(a, w, impl="cuda"))
    for name, (m, k, n) in (("4096", (4096, 4096, 4096)), ("gcn3327", (3327, 144, 144))):
        a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
        w = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
        out[f"gemm_bf16_{name}"] = graph_ms(lambda: ops.gemm(a, w, impl="cuda", out_dtype=torch.float32))
        out[f"gemm_bf16_{name}_bf16out"] = graph_ms(lambda: ops.gemm(a, w, impl="cuda"))
        if m == 4096:
            for acc in (torch.bfloat16, torch.float16):
                out[f"gemm_bf16_{name}_accum_{str(acc)[6:]}"] = graph_ms(
                    lambda: ops.gemm(a, w, impl="cuda", out_dtype=torch.float32, accum_dtype=acc, bk=256))
    del a, w
    m, k, n = pl.CARD.gemm
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    for pol in smoke.POLICIES:
        (aq, a_s), (bq, b_s) = (prec.quantize_blockwise(x, pol, axis=ax, block=256) for x, ax in ((a, 1), (b, 0)))
        out[f"gemm_scaled_{pol}"] = graph_ms(lambda: gemm_scaled_kernel(aq, bq, a_s, b_s, bk=256))
    del a, b, aq, bq
    torch.cuda.empty_cache()
    B, H, K, S, D = pl.CARD.fa
    q, k, v = (torch.randn((B, h, S, D), generator=gen, device="cuda") for h in (H, K, K))
    for pol in smoke.POLICIES:
        qkv_s = [prec.quantize_blockwise(x, pol, axis=-1, block=D) for x in (q, k, v)]
        vals, scales = [x for x, _ in qkv_s], [s_ for _, s_ in qkv_s]
        out[f"fa_scaled_{pol}"] = graph_ms(lambda: flash_attention_scaled_kernel(*vals, *scales, causal=True))
    del q, k, v, vals, scales
    torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")  # 5x the 50 MB L2
    for nbytes in (4 << 20, 64 << 20):
        src = torch.randint(0, 256, (nbytes,), dtype=torch.uint8, generator=gen, device="cuda")
        dst = torch.empty_like(src)
        out[f"hop_{nbytes >> 20}MiB_cold"] = cold_ms(lambda: ring_hop.ring_hop_cuda(src, dst), flush)
        if nbytes == 4 << 20:
            out["hop_4MiB_warm"] = warm_ms(lambda: ring_hop.ring_hop_cuda(src, dst))
    del flush, src, dst
    torch.cuda.empty_cache()

    mesh = RingMesh(4)
    q, k, v = qkv(2048)  # its K/V hops through the ring-hop kernel: 24 launches a call
    walls = [wall_ms(lambda: ops.flash_attention(q, k, v, causal=True, mesh=mesh, remote_copy=True))
             for _ in range(4)]
    out["ring_s2048_zigzag_hop_wall"] = min(walls[1:])
    q, k, v = qkv(16384)
    walls = [wall_ms(lambda: ops.flash_attention(q, k, v, causal=True, mesh=mesh)) for _ in range(4)]
    out["ring_s16384_zigzag_wall"] = min(walls[1:])
    out["fa_s16384_unsharded_wall"] = wall_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", causal=True))
    print("CMP " + json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
