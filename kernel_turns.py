#!/usr/bin/env python3
"""Device times of the port's redesigned kernels and of the ring call, for
one checkout of the repo, on one NVIDIA card.

    python3 kernel_turns.py <checkout root> <label>

Builds that checkout's kernels and times them with its own
``repro_torch`` and ``chip_smoke.py`` helpers: the bf16 FA-2 forward
(B=1 H=16 D=256 causal; S = 512, and 2048-row ring blocks on and below
the diagonal), the BSR SpMM at the sparse trio's three card densities,
and the chunked scan at both recurrent models' card shapes, each as a
device time (CUDA events around one replay of a CUDA graph of 20 calls);
then a zigzag flash ring at S = 16384 on 4 ranks of one card and one
unsharded call (host wall ended by a sync; the ring's min of 3 warm
calls). Prints one line, ``CMP {json}``.

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
    from repro_torch.core import sparse
    from repro_torch.hopper import build, ops
    from repro_torch.parallel.mesh import RingMesh

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build(("flash_attention", "bsr_spmm", "linear_attention", "ring_hop"))
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
        A = sparse.ell_to_bsr(sparse.random_ell(rng, 8192, 16384, d), 8, 128).to("cuda")
        D = torch.from_numpy(rng.standard_normal((16384, 256)).astype(np.float32)).cuda()
        out[f"bsr_{d}"] = graph_ms(lambda: ops.bsr_spmm(A, D, impl="cuda"))
    for arch, _ in smoke.RECURRENT:
        r, k, v, w, u, _ = smoke._la_card_inputs(arch, smoke.RECURRENT_T, gen)
        out[f"la_{arch}"] = graph_ms(lambda: ops.linear_attention(r, k, v, w, u, impl="cuda"))
    del q, k, v, r, w, A, D
    torch.cuda.empty_cache()

    mesh = RingMesh(4)
    q, k, v = qkv(16384)
    walls = [wall_ms(lambda: ops.flash_attention(q, k, v, causal=True, mesh=mesh)) for _ in range(4)]
    out["ring_s16384_zigzag_wall"] = min(walls[1:])
    out["fa_s16384_unsharded_wall"] = wall_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", causal=True))
    print("CMP " + json.dumps(out))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    main(sys.argv[1], sys.argv[2])
