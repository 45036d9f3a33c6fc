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
     the ELL SpMM at the GCN adjacencies, at wider random ELL matrices and
     at edge shapes (F of 1, 33, 144, 300, also in slabs of a shrunk L2
     budget; L of 0, 1, 9, 37; strided rows; every type pair; sorted and
     unsorted rows with repeats; fp32 bitwise; a repeated call equal);
     the GEMM with a narrow accumulator (``accum_dtype`` bf16 and fp16,
     both routes, K blocks of 256 and 64, a ragged last block, one block)
     against its per-block plain version;
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
     the stencil bitwise at each route's edge shapes (radius 2 wrapping
     every face, grids smaller than a tile, 2-D, bf16, X of 5, 20 and 100,
     an x halo of 9, 40 random points, halos past the window), the route
     asserted from its planner, a repeated call equal;
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
  9. still with GPT-J's weights, dense ``launch.serve.generate`` through
     the contiguous cache: 4 prompts of 512 tokens + 16 new ones, with the
     launch counts zeroed just before and read just after (28 FA launches,
     all in the prefill; a prefill alone 28, a decode step alone none);
     the prefill's cache copied into shuffled pages of 16 and one
     contiguous ``decode_step`` (its scan pinned to bs 16) held bitwise
     against ``decode_step_paged``; decode against the teacher-forced
     forward (the reference's 2e-2 of max|logits|, on the first 2 layers
     in fp32; all layers in bf16 printed); the prefill, the contiguous
     decode step (at its own bs and at bs 16) and the paged step profiled
     at the same B and lengths (wall, device busy, idle share);
  10. with GPT-J's weights freed, gemma-2b, qwen1.5-4b, qwen3-14b and
     command-r-35b at full width (command-r-35b cut to 8 of its 40 layers,
     the cut and its reason printed) with random weights from seed 0, one
     after another through the same generate, launch counts, decode
     against the forward and profiles;
  10b. with the dense models freed, the remaining families at full width
     with random weights from seed 0, each freed before the next:
     phi3.5-moe-42b-a6.6b (8 of 32 layers) through the paged engine
     (serve()'s requests, slots and pool, so it preempts; one FA launch a
     layer per prefill, no leak) and generate; grok-1-314b (2 of 64
     layers) through generate; pixtral-12b (40 layers) through generate
     with 64 patch embeddings before each 512-token prompt; whisper-large-v3
     (32 + 32 layers) through a teacher-forced forward (B 4 x 448 tokens
     against 1500 frames: 96 FA launches) and generate (the encoder once,
     32 launches; the 64-token prompt through decode_step). Each depth cut
     and its reason printed; launch counts zeroed just before and read
     just after each run; a prefill and a decode step alone with their
     counts; decode against the teacher-forced forward (2e-2 of
     max|logits| in fp32 on the first layers, MoE at capacity_factor 8;
     full depth in bf16 printed); the prefill (whisper: the forward and
     the cross cache) and a decode step profiled (wall, busy, idle
     share); the FA kernel first held to its plain version at the four
     shapes these paths add (phase 2: D 64 at S 1500 and 448 x 1500
     non-causal, GQA 48/8 and 32/8 at D 128);
  11. with the dense models freed, the recurrent families: the chunked
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
  12. the sequence-parallel ring at occamy-gptj's attention width on a
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
  13. the partition layer (``hopper/partition.py``) on three meshes of
     ranks, each rank a stream of the one card (or a card of its own where
     the machine has them): pod2 x model2, data2 x model2 and pod2 x data2
     x model2. For every op, the plan's levels and note, the launches of
     one sharded call (counts zeroed just before and read just after)
     equal to the plan's (every rank runs its part; replicas over an axis
     the plan leaves out too), the hold against the unsharded call, and
     the sharded and single walls: the GCN at 169,344 nodes (ogbn-arxiv's
     size rounded up to a multiple of 8), 2 layers of 144, fp32, with
     ``mesh=`` at 1e-4 (8 gemm and 8 spmm launches on pod2 x model2), under
     ``use_mesh`` once, and the 169,343-node graph, whose spmm replicates
     with one warning; phase 4's sparse trio (ELL SpMM and the five
     stencils bitwise the unsharded call, the overlapped stencil bitwise
     its sync schedule at 3 launches a rank against 1; BSR and SpMSpM at
     1e-4); attention at occamy-gptj's width in bf16 (flash at B=4 S=2048
     head x batch, B=1 S=16384 with the ring composed with heads and its
     hops through the ring-hop kernel, the scaled FA under bf16, decode at
     B=4 x 2048) and rwkv6-3b's scan shape, at the ring phase's
     tolerances; the GEMM (2048, 4096) . (4096, 16384) in fp32 and under
     ``precision="bf16"`` (the plan's bf16 psum). Then
     ``launch.mesh_rows`` (the twin of ``benchmarks/bench_mesh.py``) on
     pod2 x data2 x model2, every row within 1e-3 of its single call and
     the overlap rows bitwise;
  14. the training path at full width: (a) the two autograd Functions
     (``hopper/grads.py``: the FA kernel's forward with the plain FA-2
     backward, the scan kernel's forward with the plain form's backward)
     against the torch impl's gradients on the same inputs and upstream
     gradient, FA at hymba-1.5b's shapes (a window layer and a global one)
     and gemma-2b's (MQA, D 256), the scan at rwkv6-3b's card shape (u)
     and hymba's SSD read-out (broadcast inputs, s0), and small fp32 cases
     (fp32 max rel 1e-4, bf16 Frobenius rel 1e-2), the scan's kernel
     forward (o, S_final) held to the plain one, each backward timed;
     hymba-1.5b below keeps 8 of its 32 layers at full width (its
     host-bound steps are the phase's cost; the cut and its reason
     printed);
     (b) one hymba-1.5b step, B 1 x 2048, cuda against torch: the loss and the global gradient norm to 1e-2, every
     leaf finite and nonzero, every leaf's cosine >= 0.975 in bf16 (beside
     each kernel alone and plain controls that round as the kernels do)
     and >= 0.9999 in fp32; (c) hymba-1.5b through
     ``launch.train.main`` (bf16, remat full, B 2 x 2048): a straight 6-step
     run, a run crashed at step 4 (exit 42, checkpoint at 3) and its
     restart (resumes at 3 and writes no checkpoint, ends at opt.step 6,
     final loss within 1e-3 of
     the straight run's), 16 FA and 16 scan launches a step (8 layers x
     forward and recompute), then a profiled step (wall, busy, idle share,
     top device operations, tokens/s, peak memory, 6 N T model FLOPs and
     their share of the bf16 peak); (d) gemma-2b and rwkv6-3b the same way
     at full width, 3 steps each; (e) the twin of ``examples/train_llm.py``
     (gptj-100m, 60 steps, crash at 30, restart, the loss down by more
     than 0.1), microbatched gradients against the full batch's (rtol /
     atol 1e-3) and one hymba step each with ``--microbatches 2`` and
     ``--grad-compression``;
  15. training on a mesh, every rank a stream of the one card (bf16
     parameters, fp32 AdamW, remat full, seed 0, the training phase's
     stream at B 2 x 2048): (a) phi3.5-moe-42b-a6.6b at 2 of 32 layers on
     data2 x model2 (``run_training``'s meshed step) against its unsharded
     twin from the same state on the same batches, 3 steps: every placed
     part of its spec's shard shape, each step's loss and grad norm within
     1e-3, FA launches a step equal, the MoE dispatch once per data rank
     and layer in the forward and the recompute (a no-grad forward: once
     each, logits bitwise); then ``launch/train.py --mesh 2x2`` at 1
     layer: a straight run, a crash at step 1 (checkpoint 1, gathered) and
     the restart to the straight run's loss (1e-3); (b) rwkv6-3b at 8 of 32
     layers with the halo shift on data1 x model4: logits bitwise with and
     without the halo and unsharded, then 2 twin steps as in (a), scan
     launches a step equal; (c) occamy-gptj at 4 of 28 layers in fp32
     through ``ServingEngine.with_model(mesh={"data": 4})`` (ring decode)
     against the unsharded engine: serve()'s requests, slots and pool with
     tables of 36, streams equal, 4 decode-attention partials a layer a
     step; (d) each twin's step walls, a profiled step (wall, busy, idle
     share), launches, peak memory and the gathered bytes a step, the ring
     engine's decode rate, and the phase's seconds. Each depth cut and its
     reason printed;
  16. the card's roofline (``core/topology.py``, ``launch/roofline.py``,
     ``launch/op_cases.py``, ``launch/shape_run.py``): (a) every op-roofline
     cell on the 16 x 16 and 2 x 16 x 16 production meshes under no policy
     and each of fp32, bf16, fp8 and fp8_e5m2 (the dominant term, the
     per-level seconds); (b) each of the eight op cases unsharded on the
     card at its shapes and dtypes (flash attention non-causal: the case
     counts every (q, k) pair) with the launch counts zeroed just before
     and read just after, each kernel's output held to its plain version
     (flash attention to SDPA), timed warm and cold (the L2 flushed before
     each call) beside its bound at its dtype's peak and the cell's bound;
     the run fails where an op's cold time beats its bound by more than
     the timing's noise; (c) ``parallel.collectives.ep_expert_ffn`` at
     phi3.5-moe's full width (a prefill dispatch of 4 x 2048 tokens
     through layer 0's router) on data2 x model2 and data1 x model4, held
     to the TP path's three einsums in bf16, with its wall, busy, idle
     share and the bytes its two all-to-alls exchange; (d) phi3.5-moe's
     training state at 2 layers placed on data2 x model2, one data row
     lost (``elastic_remesh``) and the state resharded onto data1 x model2
     (``reshard_state``): every old part bitwise its slab of the new leaf,
     and one meshed step there at the unsharded step's loss (1e-5); (e)
     ``make_production_mesh(multi_pod=True)``: every op case's plan
     resolves on it and on its ``MeshSpec`` alike; (f) phase 13's
     ``mesh_rows`` carry their roofline columns, and the D2D rows
     (``launch.d2d_rows``) print, the pod all-reduce measured over 4
     ranks;
  17. the dry run without XLA (``launch/step_count.py``,
     ``launch/shape_run.py`` ``count_cell``, ``launch/shape_report.py``,
     ``launch/shape_climb.py``, ``launch/op_doc.py``): (a) every config x
     shape on the 16 x 16 mesh counted device-free, one line a cell (GB
     per device, fits, FLOPs per device, the dominant term, the roofline
     fraction, the useful-FLOPs ratio), a cell with an error failing the
     run, and ``topology.HBM_BYTES`` beside the card's own memory size;
     (b) the count held to the card on a 1 x 1 mesh in two cells cut to
     one card, occamy-gptj prefill (B = 1, S = 4096, 4 layers) and a
     gemma-2b train step (B = 1, S = 2048, all 18 layers), both at full
     width: the counted argument bytes against the growth of
     ``memory_allocated()`` from placing the parameters (or state) and the
     batch (1 %), the counted aten-matmul FLOPs against
     ``FlopCounterMode`` over the real step (1 %), the counted temp bytes
     beside the step's peak, and the warm step no faster than the count's
     bound (the 5 % + 1 us of phase 16), with the launch counts zeroed
     just before the counted steps and read just after; (c) one
     ``shape_climb`` override with its term deltas; (d) ``op_doc
     --check``;
  18. the block-geometry search on the card (``launch/block_search.py``,
     ``launch/bench_run.py``, ``launch/quickstart.py``): (a) ``autotune``
     over ``full_suite()`` at the card's shapes (``TUNE_BUDGET`` candidates
     timed an entry, the default first and last), one line an entry
     (candidates, pruned with their bytes, timed, mismatched, the
     default's two readings, the winner and its time, the model's pick's
     rank among the timed plans), a kernel plan whose output differs from
     the model's pick failing the run; (b) the record saved, loaded and
     applied: each entry's call launches the winner's plan (a plan
     override hit at the planner's arguments, the planner returning the
     winner) and gives the output it gave in the search (its fp64 sums),
     with the launch counts zeroed just before and read just after, and
     winner and default re-timed interleaved; (c) occamy-gptj's contiguous
     decode step at full width (``TUNE_GPTJ_LAYERS`` layers) at the
     default ``bs`` and with the ``decode_attention#decode`` winner: wall,
     busy, launches; (d) ``bench_run --autotune-only`` on the record, then
     every harness row on the card, the row names the reference
     harness's; (e) the quickstart's four acts, each error under its
     bound; (f) ``shape_climb --autotune-record`` on one cell, and a
     record from another card refused;
  19. the static checker on the card (``repro_torch.analysis``): (a)
     ``python -m repro_torch.analysis --format json`` in a subprocess on
     the card's host, which must exit 0, each rule's finding count and
     each exploration's states printed, the states equal to the CPU
     tests' (28,871 scheduler, 588 hop); (b) ``smem-budget`` with
     ``device="cuda"``: the card's limits as read (SMs, opt-in shared
     memory a block, threads, registers) beside the H100 constants, then
     each planned suite case's pick launched once at its card shape
     through its op under ``dispatch.plan_override`` at the planner's
     arguments, each showing its kernel's launch and its plan hit; (c)
     the accumulator of every ``KernelStreams`` declaration taking
     sub-fp32 floats probed in the compiled kernel on a sum of 4096
     terms, a large head then a tail whose every block (widths 1 to 256)
     is below half a bf16 and an fp16 ulp of the head, so that only an
     fp32 running sum takes the tail in; the script checks that before
     each read (GEMM bf16 and the scaled GEMM: 256 rows of ones, then
     2^-12, 256.9375; FA and the scaled FA: 32 keys 10 above the rest,
     the row sum 32.1845 read from the log-sum-exp; the scan: state 256
     plus 2^-12 a step, 257), each within 2^-10 of its exact sum, and the
     GEMM with ``accum_dtype`` bf16 and fp16 as the controls outside it
     (256); (d) the phase's time, which fails past 60 s. The launch
     counts are zeroed before (b) and read after (c);
  20. time every kernel against its plain version, the library call and
     its bound (CUDA events over back-to-back calls); the FA, BSR, SpMSpM,
     stencil, scan and both scaled kernels and their library calls also by
     device time (events around a CUDA graph's replay of 20 calls, which
     the host's issue does not set), and the FA wrapper's host time per
     call; the ELL kernel also at the sparse trio's three densities and,
     at ogbn-arxiv's size, beside a probe of its L2 gather rate (the same
     plan on an L2-resident dense) and one slab of all 144 columns; each
     stencil's plan; the scan at both card shapes with each of its three launches'
     share of the call from a profile. The scaled kernels at the ladder's card shapes under every
     policy, each asserted to take its route (wgmma at bf16 and fp8, ffma
     at fp32), beside ``torch.matmul`` and SDPA on the values at bf16 and
     fp32, where unit scales make them the same function. The GEMM with
     a narrow accumulator at 4096^3, both input types, beside the same
     kernel with an fp32 accumulator and the per-block plain version.

Prints the card's name and power limit, one JSON line of per-kernel
numbers (each kernel's mesh-phase launches by mesh under
``mesh_launches``, FA's and the scan's training launches a step by model
under ``train_launches_per_step``, and a meshed step's under
``mesh_train_launches_per_step``, and phase 16's op cases' under
``op_roofline_launches`` with each kernel's op case timed under
``op_roofline``, phase 17's grounding steps' under ``dryrun_launches``,
phase 18's tuned calls' under ``block_search_launches``, and phase 19's
picks and probes under ``analysis_launches``), and as its last line ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the reference package.
"""
from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
              "flash_attention_scaled", "spmspm", "spmm", "stencil")
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


def bound_ms(nbytes, ops, dtype="float32"):
    """Least time on the card for ``ops`` operations of ``dtype``'s kernels
    (a torch dtype or its name) and ``nbytes`` read or written once, ``(ms,
    "operations" | "bytes")``: ``launch.roofline.bound_ms`` at the port's
    constants (``core.topology``, ``core.precision.peak_flops``)."""
    import torch

    from repro_torch.core import precision as prec
    from repro_torch.launch import roofline

    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return roofline.bound_ms(ops, nbytes, prec.peak_flops_of(dtype))


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
    return bound_ms(nbytes, ops, dtype_name)


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
    # the remaining families' shapes (phase 10b): whisper's encoder and
    # cross-attention, grok-1's and pixtral-12b's prefills
    ("whisper encoder non-causal bf16 D=64", 1, 20, 20, 1500, 1500, 64, "bfloat16", False, 0, 0,
     False, False),
    ("whisper cross Sq=448 Sk=1500 bf16 D=64", 1, 20, 20, 448, 1500, 64, "bfloat16", False, 0, 0,
     False, False),
    ("grok prefill gqa 48/8 bf16 D=128", 1, 48, 8, 512, 512, 128, "bfloat16", True, 0, 0, False,
     False),
    ("pixtral prefill gqa 32/8 S=576 bf16 D=128", 1, 32, 8, 576, 576, 128, "bfloat16", True, 0, 0,
     False, False),
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
# by output (dense) dtype. fp32: kernel (either route) and plain version add
# the slots in the same order with the same roundings, so they must agree
# bitwise. bf16: one bf16 step of the rounded sum.
SPMM_TOL = {"float32": (0.0, 0.0), "bfloat16": (1e-2, 1e-2)}

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


# The GEMM with a narrow accumulator (ops.gemm accum_dtype=bf16 / fp16):
# (label, M, K, N, input dtype, bk). Each runs with both accumulators and is
# held to the per-block plain version (blocked.gemm_accum_blocked): K blocks
# of bk, each block's fp32 dot rounded to the accumulator and added into a
# running sum rounded after each add. The kernel's fp32 order inside a
# block is its own, so a block's rounding may land one step of the
# accumulator away and the running sum carries it on: each entry within
# one step of the coarser of the input and accumulator types at max|C| per
# K block, and at least ACCUM_EQUAL of the entries equal bitwise. The last
# case is the timed shape (16 K blocks).
GEMM_ACCUM_CASES = [
    ("ragged, 4 blocks", 257, 1000, 65, "float32", 256),
    ("one block", 100, 70, 130, "float32", 256),
    ("bk 64", 64, 512, 144, "float32", 64),
    ("ragged, 4 blocks", 257, 1000, 65, "bfloat16", 256),
    ("one block", 100, 70, 130, "bfloat16", 256),
    ("bk 64", 64, 512, 144, "bfloat16", 64),
    ("timed", 4096, 4096, 4096, "float32", 256),
    ("timed", 4096, 4096, 4096, "bfloat16", 256),
]
ACCUMS = ("bfloat16", "float16")
ACCUM_EQUAL = 0.99


def check_gemm_accum(report):
    """Phase 2 for ``ops.gemm(accum_dtype=)``: the GEMM kernel (both routes)
    with each narrow accumulator against its per-block plain version."""
    import torch

    from repro_torch.hopper import blocked, ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    errs = {}
    for label, M, K, N, dt, bk in GEMM_ACCUM_CASES:
        dtype = getattr(torch, dt)
        a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        b = torch.randn((K, N), generator=gen, device="cuda").to(dtype)
        for acc in ACCUMS:
            adt = getattr(torch, acc)
            got = ops.gemm(a, b, impl="cuda", accum_dtype=adt, bk=bk, out_dtype=torch.float32)
            want = blocked.gemm_accum_blocked(a, b, bk=min(bk, K), accum_dtype=adt,
                                              out_dtype=torch.float32)
            torch.cuda.synchronize()
            blocks = -(-K // min(bk, K))
            eps = max(torch.finfo(dtype).eps, torch.finfo(adt).eps)
            tol = blocks * eps * float(want.abs().max())
            err = float((got - want).abs().max())
            equal = float((got == want).float().mean())
            ok = bool(torch.isfinite(got).all()) and err <= tol and equal >= ACCUM_EQUAL
            print(f"kernel gemm accum {acc} [{label} ({M},{K})x({K},{N}) {dt}, bk {bk}]: "
                  f"max_abs={err:.3e} tol {tol:.3e} ({blocks} blocks x eps {eps:g} x max|C|), "
                  f"bitwise equal {equal:.5f} (>= {ACCUM_EQUAL}) {'ok' if ok else 'FAIL'}")
            need(ok, f"gemm accum {acc} kernel disagrees with its per-block plain version: {label} {dt}")
            errs[acc] = max(errs.get(acc, 0.0), err)
    report["gemm_accum_err"] = errs


def time_gemm_accum(report):
    """The narrow-accumulator GEMM at the timed shape, both input types:
    the kernel with each accumulator and with fp32 beside it (the same
    kernel without the block folds), the per-block plain version, and the
    bound. No PyTorch call computes a sum rounded per K block."""
    import torch

    from repro_torch.hopper import blocked, ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    label, M, K, N = next((c[0], c[1], c[2], c[3]) for c in GEMM_ACCUM_CASES if c[0] == "timed")
    out = {}
    for dt in ("float32", "bfloat16"):
        dtype = getattr(torch, dt)
        a = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
        b = torch.randn((K, N), generator=gen, device="cuda").to(dtype)
        bound, by = gemm_bound_ms(M, K, N, dt, "float32")
        f32 = device_ms(lambda: ops.gemm(a, b, impl="cuda", out_dtype=torch.float32))
        for acc in ACCUMS:
            adt = getattr(torch, acc)
            kern_fn = lambda: ops.gemm(a, b, impl="cuda", accum_dtype=adt, out_dtype=torch.float32)  # noqa: E731
            plain_fn = lambda: blocked.gemm_accum_blocked(  # noqa: E731
                a, b, bk=256, accum_dtype=adt, out_dtype=torch.float32)
            kern, plain = _in_turns(kern_fn, plain_fn, 5)
            dev = device_ms(kern_fn)
            out[f"{dt}/{acc}"] = dict(
                shape=f"({M},{K})x({K},{N}) {dt} accum {acc}, bk 256", ms=min(kern),
                plain_ms=min(plain), device_ms=dev, fp32_accum_device_ms=f32,
                bound_ms=bound, bound_by=by, library_ms=None)
            print(f"time gemm accum {acc} [({M},{K})x({K},{N}) {dt}]: kernel {kern} ms, per-block "
                  f"plain {plain} ms (events, back to back); device time {_ms(dev)}, the same "
                  f"kernel with an fp32 accumulator {_ms(f32)}; bound {bound:.5f} ms ({by}); no "
                  f"library call rounds per K block")
    report["gemm_accum_time"] = out


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
    errs += check_ell_edges(rng)
    report["spmm_err"] = max(errs)


def check_ell_edges(rng):
    """The ELL kernel at edge shapes, held to the plain version (fp32
    bitwise, bf16 one step): F of 1, 33, 144 and 300 (one-element and
    16-byte loads), also with the L2 budget shrunk to a quarter of dense so
    that F goes in about 4 slabs (a ragged last one for bf16 at 144); L of
    0, 1, 9 (a batch of 8 and one more) and 37 (two batches of 16 and 5
    more); R = 1000, not a multiple of a block; values, cols and dense as row slices of
    wider tensors; every pair of value and dense types; sorted and unsorted
    slots, each row with a repeated column; a repeated call bitwise equal.
    Returns the largest differences."""
    import numpy as np
    import torch

    from repro_torch.hopper import ops
    from repro_torch.hopper import spmm as sp

    errs, vecs = [], {}
    R, C = 1000, 700
    for F in (1, 33, 144, 300):
        for L in (0, 1, 9, 37):
            for vt in ("float32", "bfloat16"):
                for dt in ("float32", "bfloat16"):
                    cols = rng.integers(0, C, (R, L + 3)).astype(np.int32)
                    cols[:, 1:3] = cols[:, :1]  # repeated columns
                    vals = torch.from_numpy(rng.standard_normal((R, L + 3)).astype(np.float32))
                    wide = torch.randn((C, F + 8), device="cuda").to(getattr(torch, dt))
                    dense, values = wide[:, :F], vals.cuda().to(getattr(torch, vt))[:, :L]
                    for srt in (True, False):
                        c = torch.from_numpy(np.sort(cols, axis=1) if srt else cols).cuda()[:, :L]
                        want = ops.spmm(values, c, dense, impl="torch")
                        esize = dense.element_size()
                        for budget in (sp.L2_SLAB_BYTES, C * F * esize // 4):
                            q = sp.plan(R, L, C, F, esize, sp.vec16(dense))
                            if budget != sp.L2_SLAB_BYTES:
                                sp.L2_SLAB_BYTES, full = budget, sp.L2_SLAB_BYTES
                                q = sp.plan(R, L, C, F, esize, sp.vec16(dense))
                                sp.L2_SLAB_BYTES = full
                            outs = []
                            for _ in range(2):
                                outs.append(torch.empty((R, F), dtype=dense.dtype, device="cuda"))
                                sp.launch(values, c, dense, outs[-1], q)
                            torch.cuda.synchronize()
                            label = (f"edge R={R} L={L} F={F} values {vt} dense {dt} "
                                     f"{'sorted' if srt else 'unsorted'} strided, vec {q.vec}, batch {q.batch}, "
                                     f"{-(-F // q.slab)} slabs of {q.slab}")
                            need(torch.equal(outs[0], outs[1]), f"spmm: a repeated call changed ({label})")
                            if dt == "float32":
                                need(torch.equal(outs[0], want), f"spmm: {label} not bitwise the plain version")
                            errs.append(_hold("spmm", label, outs[0], want, SPMM_TOL[dt]))
                            vecs[q.vec] = vecs.get(q.vec, 0) + 1
    print(f"kernel spmm: edge shapes held, by vector width {vecs}")
    return errs


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
    return bound_ms(nbytes, 2 * M * N * K, dt)


def spmm_bound_ms(adj, dense):
    """Least time for the ELL product on an H100: the larger of values and
    cols read once, dense read once and out written once over HBM
    bandwidth, and 2 * nnz * F operations (this matrix's nonzeros) over the
    fp32 peak."""
    R, L = adj.values.shape
    C, F = dense.shape
    nbytes = (R * L * (adj.values.element_size() + adj.cols.element_size())
              + (C + R) * F * dense.element_size())
    return bound_ms(nbytes, 2 * adj.nnz * F)


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
        kern_fn, lib_fn = lambda: ops.spmm(adj, dense, impl="cuda"), lambda: torch.sparse.mm(lib_a, dense)
        kern, plain = _in_turns(kern_fn, lambda: ops.spmm(adj, dense, impl="torch"), plain_iters)
        lib = time_ms(lib_fn)
        dev = [device_ms(kern_fn), device_ms(lib_fn), device_ms(lib_fn), device_ms(kern_fn)]
        lib_err = float((lib_fn() - ops.spmm(adj, dense)).abs().max())
        bound, by = spmm_bound_ms(adj, dense)
        L = adj.values.shape[1]
        dev_k = min((d for d in (dev[0], dev[3]) if d is not None), default=None)
        dev_l = min((d for d in (dev[1], dev[2]) if d is not None), default=None)
        gathered = adj.values.numel() * F * dense.element_size()
        report.setdefault("spmm_time", {})[name] = dict(
            shape=f"ELL ({n},{L}) nnz={adj.nnz} x ({n},{F}) float32", ms=min(kern),
            plain_ms=min(plain), library_ms=lib, bound_ms=bound, bound_by=by,
            device_ms=dev_k, library_device_ms=dev_l, gathered_bytes=gathered)
        print(f"time spmm [{name} ELL ({n},{L}) x ({n},{F}) f32]: kernel {kern} ms, plain "
              f"{plain} ms, torch.sparse.mm (CSR) {lib:.4f} ms (events; max |diff| vs kernel "
              f"{lib_err:.2e}); device time in turns kernel {_ms(dev[0])}, {_ms(dev[3])}, "
              f"torch.sparse.mm {_ms(dev[1])}, {_ms(dev[2])}; bound {bound:.5f} ms ({by}); "
              f"{gathered / 1e9:.3f} GB gathered"
              + (f", {gathered / dev_k / 1e9:.3f} TB/s at the kernel's device time" if dev_k else ""))
        if name == OGBN_ARXIV[0]:
            ell_l2_probe(rng, gen, adj, dense, report)


def ell_l2_probe(rng, gen, adj, dense, report):
    """The rate at which the ELL kernel reads gathered rows from L2: the
    ogbn-arxiv-size adjacency's shape (R, L, F) and plan (its slabs of F)
    with its columns drawn over a dense of 16384 rows (9.4 MB, L2-resident),
    so every gather hits L2 and the device time is the gathered bytes at
    L2's rate for this access pattern; beside it the same plan on the real
    dense (97.5 MB), and one slab of all F columns (the whole of dense at
    once, past the L2)."""
    import numpy as np
    import torch

    from repro_torch.core import sparse
    from repro_torch.hopper import spmm as sp

    R, L = adj.values.shape
    F = dense.shape[1]
    small = torch.randn((16384, F), generator=gen, device="cuda")
    cols = torch.from_numpy(rng.integers(0, 16384, (R, L)).astype(np.int32)).cuda()
    probe = sparse.EllMatrix(adj.values, cols, (R, 16384))
    out = torch.empty((R, F), device="cuda")
    gathered = R * L * F * 4
    qs = sp.plan(R, L, R, F, 4, sp.vec16(dense))  # the real dense's slabs, for both
    t_l2 = device_ms(lambda: sp.launch(probe.values, probe.cols, small, out, qs))
    t_slabs = device_ms(lambda: sp.launch(adj.values, adj.cols, dense, out, qs))
    rows = sp.THREADS // (F // 4)  # one slab: a row's F // 4 vectors in one block
    q1 = qs._replace(slab=F, lanes=F // 4, rows=rows, row_blocks=-(-R // rows), grid=-(-R // rows))
    t_one = device_ms(lambda: sp.launch(adj.values, adj.cols, dense, out, q1))
    report["spmm_l2_probe"] = dict(gathered_bytes=gathered, l2_resident_ms=t_l2,
                                   l2_read_tb_s=gathered / t_l2 / 1e9, slabs_ms=t_slabs,
                                   one_slab_ms=t_one, slabs=-(-F // qs.slab))
    print(f"probe spmm L2 gather rate: ({R},{L}) x (16384,{F}) f32 (dense L2-resident): "
          f"{_ms(t_l2)} device, {gathered / 1e9:.3f} GB gathered, {gathered / t_l2 / 1e9:.3f} "
          f"TB/s; the real ({R},{F}) dense in {-(-F // qs.slab)} slabs of {qs.slab} columns "
          f"{_ms(t_slabs)}, in one slab of {F} {_ms(t_one)}")


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
    # dims (grids smaller than a tile), offsets past the grid's extent in
    # y/z, 2-D grids, bf16, X not a multiple of the 16-plane run (20 with
    # bx = 4, 100, and 5), 40 random points of radius 2, x offsets of 9
    # (a halo wider than half the run), and y offsets of 40 whose halo
    # outgrows the window (the direct kernel's path); each call repeated
    # bitwise
    from repro_torch.hopper import stencil as st

    far = np.array([[0, 0, 0], [2, -7, 3], [-2, 5, -9], [1, 1, 1]])
    wide = np.array([[0, 0, 0], [1, 40, 0], [-1, -40, 3], [0, 1, -1]])
    many = rng.integers(-2, 3, (40, 3))
    routes = {"march": 0, "direct": 0}
    for shape, offs, dt, bx, route in (
            ((16, 12, 10), sl.star(2, 3), "float32", None, "march"),
            ((8, 5, 3), sl.BOX27, "float32", None, "march"), ((8, 5, 2), far, "float32", None, "direct"),
            ((64, 48, 1), sl.star(2, 2), "float32", None, "march"),
            ((24, 70, 1), sl.star(1, 2), "bfloat16", None, "march"),
            ((16, 40, 24), sl.BOX27, "bfloat16", None, "march"),
            ((20, 33, 40), sl.BOX27, "float32", 4, "march"), ((5, 40, 36), sl.star(1, 3), "float32", None, "march"),
            ((48, 9, 64), many, "float32", None, "march"),
            ((100, 20, 33), sl.star(2, 3), "float32", 4, "march"),
            ((64, 8, 40), np.array([[9, 0, 0], [-9, 1, 0], [0, 0, 0]]), "float32", 16, "march"),
            ((40, 96, 40), wide, "float32", None, "direct"), ((40, 96, 40), wide, "bfloat16", None, "direct")):
        g = dev(rng.standard_normal(shape).astype(np.float32)).to(getattr(torch, dt))
        w = rng.standard_normal(len(offs)).astype(np.float32)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        q = st.plan(shape, st.reduce_offsets(offs, shape), sms)
        need(q.route == route, f"stencil {shape}: the planner took {q.route}, not {route}")
        routes[route] += 1
        got = ops.stencil(g, offs, w, impl="cuda", bx=bx)
        again = ops.stencil(g, offs, w, impl="cuda", bx=bx)
        want = ops.stencil(g, offs, w, impl="torch", bx=bx)
        torch.cuda.synchronize()
        label = f"{shape} {len(offs)}pt {dt} {route}"
        need(torch.equal(got, again), f"stencil: a repeated call changed ({label})")
        errs["stencil"].append(_hold("stencil", label, got, want, STENCIL_TOL))
    print(f"kernel stencil: edge shapes through each route {routes}")

    plain = {}
    for case in cases:
        got = _call(case, "cuda")
        want = _call(case, "torch")
        torch.cuda.synchronize()
        tol = STENCIL_TOL if case.op == "stencil" else SPARSE_TOL
        if case.op in ("spmm", "stencil"):  # fp32, the plain version's order: bitwise
            need(torch.equal(got, want), f"{case.op} card {case.name}: not bitwise the plain version")
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


def bsr_bound_ms(A, dense):
    """Least time for the BSR product on an H100: tiles, tile coordinates
    and dense read once and the fp32 out written once, over HBM bandwidth;
    or 2 * nnz * F operations (the nonzero tile values in this run's data:
    a zero slot of a tile needs no work), over the fp32 peak."""
    tv = A.tile_values
    nnz = int((tv != 0).sum())
    nbytes = (tv.numel() * tv.element_size() + 8 * tv.shape[0]
              + dense.numel() * dense.element_size() + 4 * A.shape[0] * dense.shape[1])
    return bound_ms(nbytes, 2 * nnz * dense.shape[1])


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
    return bound_ms(nbytes, 2 * matches)


def stencil_bound_ms(grid, points):
    """Least time for the stencil on an H100: the grid read once and out
    written once over HBM bandwidth, or 2 operations per point per output
    over the fp32 peak."""
    return bound_ms(2 * grid.numel() * grid.element_size(), 2 * grid.numel() * points)


def _library(case):
    """One PyTorch call computing the case's function, built outside the
    timed window: cuSPARSE SpMM on the matrix as CSR, cuSPARSE SpGEMM on
    both operands as CSR (densified), or a circular pad and a cuDNN conv3d
    with the weights laid at their offsets (TF32 off)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core import sparse

    if case.op == "bsr_spmm":
        A, dense = case.args
        a_csr = A.todense().to_sparse_csr()
        return lambda: torch.sparse.mm(a_csr, dense)
    if case.op == "spmm":
        A, dense = case.args
        csr = sparse.ell_to_csr(A)
        a_csr = torch.sparse_csr_tensor(csr.indptr.long().cuda(), csr.indices.long().cuda(),
                                        csr.data.cuda(), size=A.shape)
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
    """Every card-size ELL, BSR, SpMSpM and stencil case: kernel and plain
    version in turns (plain, kernel, kernel, plain), the library call and
    the bound; the densest BSR and SpMSpM cases and the 27-point stencil
    go into the kernels line (the ELL cases beside the GCN's)."""
    import torch

    from repro_torch.hopper import stencil as st

    for case in cases:
        if case.op == "stencil":
            grid, offs = case.args[:2]
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            q = st.plan(grid.shape, st.reduce_offsets(offs, grid.shape), sms)
            print(f"stencil plan [{case.name}]: {q.route} tile {q.ty}x{q.tz}, {q.runs} runs of "
                  f"{st.XR} planes a block, {q.grid} blocks, {q.smem} B shared")
        plain_iters = 3
        kern, plain = _in_turns(lambda: _call(case, "cuda"), lambda: _call(case, "torch"),
                                plain_iters)
        lib_fn = _library(case)
        lib = time_ms(lib_fn)
        dev = device_ms(lambda: _call(case, "cuda"))
        # cuSPARSE's SpGEMM sizes its output on the host while it is being
        # captured, so a graph would hold only part of the call: not measured
        lib_dev = None if case.op == "spmspm" else device_ms(lib_fn)
        if case.op in ("spmm", "stencil"):  # the kernel's device time in turns with the library's
            dev = min((d for d in (dev, device_ms(lambda: _call(case, "cuda"))) if d is not None),
                      default=None)
        lib_err = float((lib_fn().float() - _call(case, "cuda").float()).abs().max())
        if case.op == "bsr_spmm":
            bound, by = bsr_bound_ms(*case.args)
        elif case.op == "spmm":
            bound, by = spmm_bound_ms(*case.args)
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
        bound, by = bound_ms(_nbytes(aq, bq, a_s, b_s) + 4 * m * n, 2 * m * n * k, dt)
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
        bound, by = bound_ms(_nbytes(*ops_) + 4 * B * H * S * D,
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
    engine, run = _engine_run("serve", cfg, params, reqs)
    out = run["out"]
    report["fa_launches"] = run["launches"]["flash_attention"]
    report["serve"] = dict(prefill_ms=run["prefill_ms"], decode_tok_s=run["tok_s"])

    check_prefill_logits(cfg, params, reqs, out)
    profile_steps(engine, reqs, report)
    serve_fp8(report, cfg, params, engine, run)
    del engine
    dense_generate_phase(report, "occamy-gptj", cfg, params, paged=True)


def _engine_run(label, cfg, params, reqs):
    """``reqs`` through ``ServingEngine.with_model`` over a pool tight
    enough to preempt (NUM_BLOCKS of BLOCK_SIZE, SLOTS slots): every
    request complete, no leaked block, at least one preemption, and one
    FA launch per layer per prefill and no other launch, with the counts
    zeroed just before and read just after. Returns (engine, the run with
    its decode ``tok_s``)."""
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine.with_model(
        cfg, params, num_blocks=NUM_BLOCKS, block_size=BLOCK_SIZE,
        max_slots=SLOTS, max_blocks_per_seq=MAX_BLOCKS_PER_SEQ, device="cuda",
    )
    run = _drive(engine, reqs)
    out, launches = run["out"], run["launches"]
    expected = {"flash_attention": cfg.num_layers * run["prefills"]}
    print(f"{label}: completed={len(out)}/{len(reqs)} steps={engine.step_count} "
          f"preemptions={run['preempts']} prefills={run['prefills']} resumes={run['resumes']} "
          f"leaked={engine.leaked_blocks()} wall={run['wall']:.3f} s")
    print(f"{label}: kernel launches during the run: {launches}; expected {expected} "
          f"({cfg.num_layers} layers x {run['prefills']} prefills)")
    need(len(out) == len(reqs), f"{label}: not every request completed")
    need(all(len(out[r.rid]) == r.max_new_tokens for r in reqs), f"{label}: short token stream")
    need(all(0 <= t < cfg.vocab_size for s in out.values() for t in s),
         f"{label}: token outside the vocab")
    need(engine.leaked_blocks() == 0, f"{label}: leaked cache blocks")
    need(run["preempts"] >= 1, f"{label}: the pool never preempted")
    need(launches == expected, f"{label}: launch counts != one FA launch per layer per prefill")
    for n, ms in run["prefill_ms"]:
        print(f"{label} time prefill: prompt {n} tokens -> {ms:.2f} ms")
    step_ms, run["tok_s"] = _decode_rate(run)
    print(f"{label} time decode: {len(run['decode_ms'])} steps, mean {step_ms:.2f} ms/step "
          f"over {SLOTS} slots, {run['tok_s']:.1f} tok/s (first step excluded)")
    run["step_ms"] = step_ms
    return engine, run


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


def profile_fn(name, fn, report, walls=3, cpu=True, warm=False):
    """Warm wall time of ``fn`` (min of ``walls``, host clock ended by a sync), the
    span of one more call on the device (CUDA events, no profiler), and a
    device-time breakdown of another (torch.profiler). The idle share is
    1 - device busy / wall, device busy being the union of the trace's
    device records (kernels of concurrent streams counted once); where the
    trace holds no device time it is None. The kernels' summed time is
    printed beside it. The span share (span / wall) is reported on its
    own: it comes from another call and counts the gaps between kernels as
    busy, so it is not an idle share. ``cpu=False`` traces the device
    alone (a training step's hundreds of thousands of host ops would take
    minutes to collect; the host's ops add nothing to busy or wall).
    ``warm=True``: ``fn`` has just run, so no warm-up call precedes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not warm:
        fn()
    torch.cuda.synchronize()
    reps, walls = walls, []
    for _ in range(reps):
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
    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
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
                                                  span_ms=span_ms, span_share=span_ms / wall,
                                                  launches=launches)


# ---------------------------------------------------------------------------
# phases 9-10: dense contiguous-cache decode and generate at full width:
# occamy-gptj (its weights still resident after serving), then the four
# other dense configs
# ---------------------------------------------------------------------------

DENSE_B, DENSE_PROMPT, DENSE_NEW = 4, 512, 16
DENSE_PAGE = 16  # the paged step's page size; the contiguous scan pinned to it for the bitwise check
# (arch, layers kept or None, why): full width and, where it fits, depth
DENSE_OTHERS = (
    ("gemma-2b", None, None),
    ("qwen1.5-4b", None, None),
    ("qwen3-14b", None, None),
    ("command-r-35b", 8, "its 40 layers take ~60.6 GB in bf16, and layers.dense_init draws each "
                         "stacked leaf whole in fp32 (the (40, 8192, 22528) wi alone is 29.5 GB), "
                         "which puts the peak past the card's 80 GB"),
)
# Decode against the teacher-forced forward, at the reference's bound
# (tests/test_models.py: max|decode - forward| / max|forward| < 2e-2). The
# reference holds it in fp32; random full-depth bf16 weights amplify any
# two summation orders apart (layers.dense_init scales the stacked leaves
# by 1/sqrt(num_layers), see check_prefill_logits), so the bound is held on
# the first DECODE_CHECK_LAYERS layers of the full-width model in fp32,
# and the full-depth bf16 figure is printed beside it, not gated.
DECODE_CHECK_LAYERS = 2
DECODE_CHECK_STEPS = 4
DECODE_FWD_REL_TOL = 2e-2


def _layers_cut(params, cfg, layers, dtype_name):
    """The first ``layers`` decoder (and encoder) layers of ``params`` in
    ``dtype_name``."""
    import torch

    dtype = getattr(torch, dtype_name)
    cut = {}
    for k, v in params.items():
        if k in ("layers", "enc_layers"):
            cut[k] = {n: x[:layers].to(dtype) for n, x in v.items()}
        elif isinstance(v, dict):
            cut[k] = {n: x.to(dtype) for n, x in v.items()}
        else:
            cut[k] = v.to(dtype)
    kw = dict(num_layers=layers, dtype=dtype_name)
    if cfg.encoder_layers:
        kw["encoder_layers"] = layers
    return cut, cfg.replace(**kw)


def _decode_vs_forward(params, cfg, seq, S0, steps, extra=None):
    """``seq[:, :S0]`` prefilled (the vlm's patches first; the audio
    family's prompt fed through decode_step after its cross cache), then
    ``steps`` decode steps teacher-forced with ``seq``'s tokens, against
    the forward of ``seq[:, :S0 + steps]``: max|decode - forward| over
    those positions' logits, relative to the forward's largest."""
    import torch

    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import multimodal, registry, transformer

    B = seq.shape[0]
    extra = {k: v[:B] for k, v in (extra or {}).items()}
    P = cfg.num_patches if cfg.family == "vlm" else 0
    with torch.no_grad():
        if cfg.family == "audio":
            cache = registry.init_cache(cfg, B, S0 + steps, device="cuda")
            cache["cross_k"], cache["cross_v"] = multimodal.build_cross_cache(
                params, cfg, extra["frames"])
            launch_serve.scan_prefill(params, cfg, cache, seq[:, :S0])
        else:
            _, cache = transformer.prefill_step(params, cfg, {"tokens": seq[:, :S0], **extra},
                                                P + S0 + steps)
        dec = []
        for i in range(steps):
            pos = torch.full((B,), P + S0 + i, dtype=torch.int32, device="cuda")
            lg, cache = registry.decode_step(params, cfg, cache, {"token": seq[:, S0 + i],
                                                                  "position": pos})
            dec.append(lg)
        full, _ = registry.forward(params, cfg, {"tokens": seq[:, :S0 + steps], **extra})
    full = full[:, P + S0:P + S0 + steps].float()
    return float((torch.stack(dec, 1) - full).abs().max() / full.abs().max())


def _paged_copy(cfg, cache, rng):
    """The contiguous cache (nl, B, K, S, hd) in pages of DENSE_PAGE rows at
    shuffled pool slots: (PagedKVCache, block table (B, S / DENSE_PAGE))."""
    import torch

    from repro_torch.serving.paged_cache import init_paged_cache

    nl, B, K, S, hd = cache["k"].shape
    nb = S // DENSE_PAGE
    paged = init_paged_cache(cfg, num_blocks=B * nb + 1, block_size=DENSE_PAGE, device="cuda")
    slots = torch.from_numpy(rng.permutation(B * nb) + 1).cuda()
    for name, pool in (("k", paged.k_pool), ("v", paged.v_pool)):
        pages = cache[name].reshape(nl, B, K, nb, DENSE_PAGE, hd).permute(0, 1, 3, 2, 4, 5)
        pool[:, slots] = pages.reshape(nl, B * nb, K, DENSE_PAGE, hd)
    return paged, slots.reshape(B, nb).to(torch.int32)


def dense_generate_phase(report, arch, cfg, params, *, paged=False):
    """``launch.serve.generate`` of DENSE_B prompts of DENSE_PROMPT tokens
    plus DENSE_NEW new ones through the contiguous cache, with the launch
    counts zeroed just before and read just after (one FA launch per layer,
    all in the prefill); a prefill and a decode step alone with their
    counts; decode against the teacher-forced forward; the prefill and the
    contiguous decode step profiled (wall, device busy, idle share). With
    ``paged``: the prefill's cache in pages, one contiguous step bitwise
    against ``decode_step_paged`` at a pinned page size, and the paged step
    profiled at the same B and lengths."""
    import numpy as np
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer

    nl, S0 = cfg.num_layers, DENSE_PROMPT
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (DENSE_B, S0))).cuda()
    fa = {"flash_attention": nl}
    with torch.no_grad():
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t = time.perf_counter()
        out = launch_serve.generate(cfg, params, tokens, DENSE_NEW, S0 + DENSE_NEW)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        launches = dict(dispatch.LAUNCHES)
        print(f"{arch} generate B={DENSE_B} prompt {S0} + {DENSE_NEW} new (contiguous cache): "
              f"{gen_s:.3f} s (first call), kernel launches {launches}, expected {fa} "
              f"(the prefill's, one a layer; none in the {DENSE_NEW - 1} decode steps)")
        need(launches == fa, f"{arch} generate launch counts != {fa}")
        need(tuple(out.shape) == (DENSE_B, S0 + DENSE_NEW), f"{arch} generate shape")
        need(bool((out[:, :S0] == tokens).all()), f"{arch} generate changed the prompt")
        new = out[:, S0:]
        need(bool(((new >= 0) & (new < cfg.vocab_size)).all()), f"{arch}: token outside the vocab")
        print(f"{arch} generate sample: {new[0].tolist()}")

        dispatch.reset_launches()
        logits, cache = transformer.prefill_step(params, cfg, {"tokens": tokens}, S0 + DENSE_NEW)
        torch.cuda.synchronize()
        pre = dict(dispatch.LAUNCHES)
        need(bool((logits[:, -1, : cfg.vocab_size].argmax(-1) == new[:, 0]).all()),
             f"{arch}: generate's first token != a direct prefill's argmax")
        del logits
        step = {"token": new[:, 0], "position": torch.full((DENSE_B,), S0, dtype=torch.int32,
                                                           device="cuda")}
        dispatch.reset_launches()
        transformer.decode_step(params, cfg, {k: v.clone() for k, v in cache.items()}, step)
        torch.cuda.synchronize()
        dec = dict(dispatch.LAUNCHES)
        print(f"{arch} launches: prefill alone {pre}, one contiguous decode step alone {dec}")
        need(pre == fa and dec == {}, f"{arch}: prefill / decode launch counts")

        res = dict(gen_s=gen_s, launches=launches, cut_layers=nl)
        if paged:
            pcache, table = _paged_copy(cfg, cache, rng)
            with dispatch.block_override("decode_attention", bs=DENSE_PAGE):
                want, _ = transformer.decode_step(params, cfg,
                                                  {k: v.clone() for k, v in cache.items()}, step)
            got, _ = transformer.decode_step_paged(params, cfg, pcache, dict(step, block_table=table))
            torch.cuda.synchronize()
            same = torch.equal(got, want)
            print(f"{arch} decode step contiguous (scan pinned to bs {DENSE_PAGE}) vs paged (pages of "
                  f"{DENSE_PAGE}, shuffled), B={DENSE_B} at position {S0}: bitwise equal {same}; "
                  f"max|diff| {float((got - want).abs().max()):.3e}")
            need(same, f"{arch}: contiguous decode != paged decode bitwise")
            res["paged_bitwise"] = same

        seq = out[:2, : S0 + DECODE_CHECK_STEPS]
        ncheck = min(DECODE_CHECK_LAYERS, nl)
        cut, cut_cfg = _layers_cut(params, cfg, ncheck, "float32")
        rel = _decode_vs_forward(cut, cut_cfg, seq, S0, DECODE_CHECK_STEPS)
        del cut
        torch.cuda.empty_cache()
        deep = _decode_vs_forward(params, cfg, seq, S0, DECODE_CHECK_STEPS)
        print(f"{arch} decode vs teacher-forced forward, {DECODE_CHECK_STEPS} steps after a "
              f"{S0}-token prefill, B=2, full width: first {ncheck} layers fp32 rel "
              f"{rel:.3e} (tol {DECODE_FWD_REL_TOL:g}); all {nl} layers {cfg.dtype} rel {deep:.3e} "
              f"(printed, not a gate)")
        need(rel < DECODE_FWD_REL_TOL, f"{arch}: decode vs forward beyond the reference's bound")
        res.update(decode_vs_forward_rel=rel, decode_vs_forward_rel_full_depth=deep)

        prof = report.setdefault("profile", {})
        name = f"{arch} prefill B={DENSE_B} S={S0}"
        profile_fn(name, lambda: transformer.prefill_step(params, cfg, {"tokens": tokens}, S0 + DENSE_NEW),
                   report)
        res["prefill"] = prof[name]
        name = f"{arch} decode contiguous B={DENSE_B} at {S0}"
        profile_fn(name, lambda: transformer.decode_step(params, cfg, cache, step), report)
        res["decode_contiguous"] = prof[name]
        if paged:
            name = f"{arch} decode contiguous B={DENSE_B} at {S0}, scan pinned to bs {DENSE_PAGE}"
            with dispatch.block_override("decode_attention", bs=DENSE_PAGE):
                profile_fn(name, lambda: transformer.decode_step(params, cfg, cache, step), report)
            res["decode_contiguous_bs16"] = prof[name]
            name = f"{arch} decode paged B={DENSE_B} at {S0}, pages of {DENSE_PAGE}"
            profile_fn(name, lambda: transformer.decode_step_paged(
                params, cfg, pcache, dict(step, block_table=table)), report)
            res["decode_paged"] = prof[name]
    report.setdefault("dense", {})[arch] = res


def dense_config_phase(report, arch, layers, why):
    """``arch`` at full width (depth cut to ``layers`` where given, for
    ``why``) with random weights from seed SEED, through
    ``dense_generate_phase``; the weights are freed after."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers:
        cfg = cfg.replace(num_layers=layers)
        print(f"model {arch}: depth cut to {layers} of {full_layers} layers: {why}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    leaves = [x for x in params.values() if torch.is_tensor(x)] + list(params["layers"].values())
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"model {arch} full width: layers={cfg.num_layers} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}x{cfg.resolved_head_dim()} kv_heads={cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.activation} qkv_bias={cfg.qkv_bias} "
          f"qk_norm={cfg.qk_norm} parallel_block={cfg.parallel_block} {cfg.dtype} "
          f"params={nbytes / 1e9:.2f} GB, init {time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({'depth cut' if layers else 'depth not cut'})")
    dense_generate_phase(report, arch, cfg, params)
    report["dense"][arch].update(params_gb=nbytes / 1e9, full_layers=full_layers)
    del params


# ---------------------------------------------------------------------------
# phase 10b: the remaining families at full width: phi3.5-moe (the paged
# engine, then generate), grok-1 (generate), pixtral-12b (generate with
# patch embeddings), whisper-large-v3 (a teacher-forced forward against
# 1500 frames, then generate)
# ---------------------------------------------------------------------------

# (arch, layers kept or None, why, layers of the fp32 decode check)
FAMILY_CONFIGS = (
    ("phi3.5-moe-42b-a6.6b", 8,
     "its 32 layers take ~84 GB in bf16, past the card's 80 GB, and layers.dense_init draws "
     "each stacked leaf whole in fp32 (moe_wi at 8 layers, (8, 16, 4096, 6400), is 13.4 GB)", 2),
    ("grok-1-314b", 2,
     "its 64 layers take ~628 GB in bf16; 2 layers are ~22.9 GB, and the whole-leaf fp32 draw "
     "of moe_wi (2, 8, 6144, 32768) adds 12.9 GB; the fp32 decode check takes 1 layer "
     "(19.3 GB of fp32 experts)", 1),
    ("pixtral-12b", None, None, 2),
    ("whisper-large-v3", None, None, 2),
)
WHISPER_B, WHISPER_TOKENS = 4, 448  # the teacher-forced forward: B x 448 tokens vs 1500 frames
WHISPER_PROMPT = 64
MOE_CHECK_CAPACITY = 8.0  # decode vs forward with no token dropped (tests/test_models.py)


def _family_extra(cfg, B, rng):
    """The vlm's patch embeddings or the audio family's frames, standard
    normal from ``rng``, on the card in the config's dtype (the stubbed
    vision tower's and conv frontend's outputs)."""
    import torch

    if cfg.family == "vlm":
        shape = (B, cfg.num_patches, cfg.d_model)
        name = "patches"
    elif cfg.family == "audio":
        shape = (B, cfg.encoder_seq, cfg.d_model)
        name = "frames"
    else:
        return None
    x = torch.from_numpy(rng.standard_normal(shape).astype("float32"))
    return {name: x.cuda().to(getattr(torch, cfg.dtype))}


def _family_engine(arch, cfg, params):
    """phi3.5-moe through the paged engine with serve()'s requests, slots
    and pool (``_engine_run``); the prefill runs on the block-padded
    bucket, so MoE capacity comes from it."""
    engine, run = _engine_run(f"{arch} serve", cfg, params, make_requests(cfg.vocab_size))
    return dict(serve_launches=run["launches"], serve_preempts=run["preempts"],
                serve_leaked=engine.leaked_blocks(), serve_wall_s=run["wall"],
                serve_decode_ms_per_step=run["step_ms"], serve_tok_s=run["tok_s"])


def family_phase(report, arch, layers, why, check_layers):
    """``arch`` at full width (depth cut to ``layers`` where given, for
    ``why``) with random weights from seed SEED: phi3.5-moe through the
    paged engine; every config through ``launch.serve.generate`` (MoE and
    vlm: B x (prompt + new), the vlm's 64 patch embeddings first; whisper:
    the encoder once, B x (64 + 16)) and whisper through a teacher-forced
    forward, with the launch counts zeroed just before and read just
    after; decode against the teacher-forced forward (fp32 on the first
    ``check_layers`` layers, the gate; full depth in bf16, printed); the
    prefill (whisper: the forward) and a decode step profiled. The weights
    are freed after."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.hopper import dispatch
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import multimodal, registry, transformer

    cfg = get_config(arch)
    full_layers = cfg.num_layers
    if layers:
        cfg = cfg.replace(num_layers=layers)
        print(f"model {arch}: depth cut to {layers} of {full_layers} layers: {why}")
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = registry.init_params(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [x for v in params.values() for x in (v.values() if isinstance(v, dict) else [v])]
    nbytes = sum(x.numel() * x.element_size() for x in leaves)
    print(f"model {arch} full width: family={cfg.family} layers={cfg.num_layers} "
          f"encoder_layers={cfg.encoder_layers} d_model={cfg.d_model} "
          f"heads={cfg.num_heads}x{cfg.resolved_head_dim()} kv_heads={cfg.num_kv_heads} "
          f"d_ff={cfg.d_ff} experts={cfg.num_experts} top{cfg.experts_per_token} "
          f"vocab={cfg.vocab_size} {cfg.activation} {cfg.dtype} params={nbytes / 1e9:.2f} GB, "
          f"init {init_s:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({'depth cut' if layers else 'depth not cut'})")
    res = dict(params_gb=nbytes / 1e9, init_s=init_s, layers=cfg.num_layers,
               full_layers=full_layers)
    if arch.startswith("phi3.5"):
        res.update(_family_engine(arch, cfg, params))

    rng = np.random.default_rng(SEED)
    audio = cfg.family == "audio"
    S0 = WHISPER_PROMPT if audio else DENSE_PROMPT
    B = DENSE_B
    P = cfg.num_patches if cfg.family == "vlm" else 0
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S0))).cuda()
    extra = _family_extra(cfg, B, rng)
    fa_gen = cfg.encoder_layers if audio else cfg.num_layers
    prof = report.setdefault("profile", {})
    with torch.no_grad():
        if audio:  # the teacher-forced forward: encoder + decoder self + cross
            seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (WHISPER_B, WHISPER_TOKENS))).cuda()
            batch = {"tokens": seq, "frames": extra["frames"][:WHISPER_B]}
            want = {"flash_attention": cfg.encoder_layers + 2 * cfg.num_layers}
            torch.cuda.synchronize()
            dispatch.reset_launches()
            t = time.perf_counter()
            logits, _ = registry.forward(params, cfg, batch)
            torch.cuda.synchronize()
            fwd_s = time.perf_counter() - t
            launches = dict(dispatch.LAUNCHES)
            print(f"{arch} forward B={WHISPER_B} x {WHISPER_TOKENS} tokens vs {cfg.encoder_seq} "
                  f"frames: {fwd_s:.3f} s (first call), kernel launches {launches}, expected "
                  f"{want} ({cfg.encoder_layers} encoder + {cfg.num_layers} self + "
                  f"{cfg.num_layers} cross)")
            need(launches == want, f"{arch} forward launch counts != {want}")
            need(tuple(logits.shape[:2]) == (WHISPER_B, WHISPER_TOKENS), f"{arch} forward shape")
            need(bool(torch.isfinite(logits).all()), f"{arch}: non-finite forward logits")
            res.update(forward_launches=launches, forward_s=fwd_s)
            del logits
        torch.cuda.synchronize()
        dispatch.reset_launches()
        t = time.perf_counter()
        out = launch_serve.generate(cfg, params, tokens, DENSE_NEW, P + S0 + DENSE_NEW, extra)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        launches = dict(dispatch.LAUNCHES)
        want = {"flash_attention": fa_gen}
        where = ("the encoder's, once; the prompt is fed through decode_step" if audio else
                 "the prefill's, one a layer")
        print(f"{arch} generate B={B} {f'{P} patches + ' if P else ''}prompt {S0} + {DENSE_NEW} "
              f"new: {gen_s:.3f} s (first call), kernel launches {launches}, expected {want} "
              f"({where}; none in the decode steps)")
        need(launches == want, f"{arch} generate launch counts != {want}")
        need(tuple(out.shape) == (B, S0 + DENSE_NEW), f"{arch} generate shape")
        need(bool((out[:, :S0] == tokens).all()), f"{arch} generate changed the prompt")
        new = out[:, S0:]
        need(bool(((new >= 0) & (new < cfg.vocab_size)).all()), f"{arch}: token outside the vocab")
        print(f"{arch} generate sample: {new[0].tolist()}")
        res.update(launches=launches, gen_s=gen_s)

        # one prefill (whisper: the cross cache) and one decode step alone
        dispatch.reset_launches()
        if audio:
            cache = registry.init_cache(cfg, B, S0 + DENSE_NEW, device="cuda")
            cache["cross_k"], cache["cross_v"] = multimodal.build_cross_cache(
                params, cfg, extra["frames"])
            pre_want = {"flash_attention": cfg.encoder_layers}
        else:
            _, cache = transformer.prefill_step(params, cfg, {"tokens": tokens, **(extra or {})},
                                                P + S0 + DENSE_NEW)
            pre_want = {"flash_attention": cfg.num_layers}
        torch.cuda.synchronize()
        pre = dict(dispatch.LAUNCHES)
        step = {"token": new[:, 0],
                "position": torch.full((B,), P + S0, dtype=torch.int32, device="cuda")}
        dispatch.reset_launches()
        registry.decode_step(params, cfg, {k: v.clone() for k, v in cache.items()}, step)
        torch.cuda.synchronize()
        dec = dict(dispatch.LAUNCHES)
        print(f"{arch} launches: {'cross cache' if audio else 'prefill'} alone {pre}, one decode "
              f"step alone {dec}")
        need(pre == pre_want and dec == {}, f"{arch}: prefill / decode launch counts")

        seq = out[:2, : S0 + DECODE_CHECK_STEPS]
        check_cfg = cfg
        if cfg.num_experts:
            check_cfg = cfg.replace(capacity_factor=MOE_CHECK_CAPACITY)
        cut, cut_cfg = _layers_cut(params, check_cfg, check_layers, "float32")
        rel = _decode_vs_forward(cut, cut_cfg, seq, S0, DECODE_CHECK_STEPS, extra)
        del cut
        torch.cuda.empty_cache()
        deep = _decode_vs_forward(params, check_cfg, seq, S0, DECODE_CHECK_STEPS, extra)
        print(f"{arch} decode vs teacher-forced forward, {DECODE_CHECK_STEPS} steps after a "
              f"{S0}-token prompt{f' ({P} patches first)' if P else ''}, B=2, "
              f"full width{f', capacity_factor {MOE_CHECK_CAPACITY:g}' if cfg.num_experts else ''}: "
              f"first {check_layers} layers fp32 rel {rel:.3e} (tol {DECODE_FWD_REL_TOL:g}); all "
              f"{cfg.num_layers} layers {cfg.dtype} rel {deep:.3e} (printed, not a gate)")
        need(rel < DECODE_FWD_REL_TOL, f"{arch}: decode vs forward beyond the reference's bound")
        res.update(decode_vs_forward_rel=rel, decode_vs_forward_rel_full_depth=deep)

        if audio:
            name = f"{arch} forward B={WHISPER_B} x {WHISPER_TOKENS} vs {cfg.encoder_seq} frames"
            profile_fn(name, lambda: registry.forward(params, cfg, batch), report)
            res["forward"] = prof[name]
            name = f"{arch} cross cache B={B} ({cfg.encoder_seq} frames)"
            profile_fn(name, lambda: multimodal.build_cross_cache(
                params, cfg, extra["frames"]), report)
            res["cross_cache"] = prof[name]
        else:
            name = f"{arch} prefill B={B} S={P + S0}"
            profile_fn(name, lambda: transformer.prefill_step(
                params, cfg, {"tokens": tokens, **(extra or {})}, P + S0 + DENSE_NEW), report)
            res["prefill"] = prof[name]
        name = f"{arch} decode B={B} at {P + S0}"
        profile_fn(name, lambda: registry.decode_step(params, cfg, cache, step), report)
        res["decode"] = prof[name]
        res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"{arch} peak memory allocated {res['peak_gb']:.2f} GB")
    report.setdefault("families", {})[arch] = res
    del params, cache


# ---------------------------------------------------------------------------
# phase 11: the recurrent families (rwkv6-3b, hymba-1.5b) and their chunked
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


def _la_card_inputs(arch, T, gen, B=None):
    """The scan's inputs at ``arch``'s card shape, built the way the
    model builds them from random activations: rwkv6's transposed
    (B, S, H, N) views (bf16 r/k/v, fp32 Finch decay ``-exp(w0 + small)``,
    fp32 u); hymba's ``hybrid._ssd_inputs`` on random weights (broadcast
    r/k/w). Returns (r, k, v, w_log, u, label)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import hybrid, layers as L, ssm

    cfg = get_config(arch)
    B = B or dict(RECURRENT)[arch]
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
    return bound_ms(nbytes, ops_)


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
# phase 12: the sequence-parallel ring (remote_ring_hop's kernel, the flash
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

    from repro_torch.core import topology
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
            bound = bound_ms(2 * nbytes, 0)[0]
        else:  # one way over NVLink
            bound = nbytes / topology.NVLINK_BW * 1e3
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
# the partition layer: every op over named-axis meshes of ranks on the
# streams of one card (or one card a rank where the machine has them)
# ---------------------------------------------------------------------------

MESHES = (("pod2xmodel2", {"pod": 2, "model": 2}), ("data2xmodel2", {"data": 2, "model": 2}),
          ("pod2xdata2xmodel2", {"pod": 2, "data": 2, "model": 2}))
# ogbn-arxiv's size rounded up to a multiple of 8 so the row split engages
# on every mesh; the 169,343-node graph walks spmm's ladder to replication
MESH_GCN_NODES = 169344
MESH_FLASH = (("flash B=4 S=2048", 4, 2048), ("flash B=1 S=16384 ring", 1, 16384))
MESH_ATTN = (16, 16, 256)  # occamy-gptj's attention: heads, kv heads, head dim (bf16)
MESH_DECODE = (4, 2048)  # B, cache length
MESH_GEMM = (2048, 4096, 16384)  # the precision ladder's card GEMM: M, K, N (fp32)
MESH_WALL_REPS = 3


def _mesh_devices(n):
    """One card a rank when the machine has ``n`` cards, else None (every
    rank on cuda:0's streams)."""
    import torch

    return [torch.device("cuda", r) for r in range(n)] if torch.cuda.device_count() >= n else None


def _wall_ms(fn, reps=MESH_WALL_REPS):
    """Median host wall of ``fn`` over ``reps`` calls after a warm one, each
    ended by a device sync."""
    import torch

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return sorted(walls)[len(walls) // 2]


def _mesh_launches(op, plan, mesh, **kw):
    """The kernel launches one call of ``op`` makes by ``plan`` on ``mesh``:
    every rank (replicas over an axis the plan leaves out included) runs
    the local function; a plan of None is one unsharded call."""
    kernel = {"gemm": "gemm_scaled" if kw.get("precision") else "gemm",
              "flash_attention": "flash_attention_scaled" if kw.get("precision")
              else "flash_attention"}.get(op, op)
    if op == "decode_attention":
        return {}  # no kernel (as in the reference)
    if plan is None:
        return {kernel: 1}
    per_rank = {kernel: 1}
    if op == "stencil" and plan.overlappable:
        per_rank = {kernel: 3}  # the interior and two strips
    if op == "flash_attention" and plan.hops:
        zig = "zigzag" in plan.note
        per_rank = {kernel: 1 + 2 * (plan.hops - 1) if zig else plan.hops}
        if kw.get("remote_copy") and plan.hops > 1:
            per_rank["ring_hop"] = 2 * (plan.hops - 1)  # k and v a send
    return {k: v * mesh.n for k, v in per_rank.items()}


def _hold_mesh_bf16(label, got, want):
    """The ring phase's bf16 hold: Frobenius RING_BF16_REL, elementwise
    RING_BF16_STEPS bf16 steps at max|want|."""
    import torch

    need(bool(torch.isfinite(got.float()).all()), f"mesh [{label}]: non-finite output")
    rel = _frob(got, want)
    err = float((got.float() - want.float()).abs().max())
    step = float(_bf16_step(want.float().abs().max()))
    print(f"mesh hold [{label}] (bf16): ||sharded - single|| / ||single|| {rel:.3e} (tol "
          f"{RING_BF16_REL:g}), max_abs {err:.3e} ({RING_BF16_STEPS} steps at max|single| = "
          f"{RING_BF16_STEPS * step:g})")
    need(rel <= RING_BF16_REL and err <= RING_BF16_STEPS * step,
         f"mesh [{label}]: sharded output off the single one")
    return err


def _hold_mesh_bitwise(label, got, want):
    import torch

    same = bool(torch.equal(got, want))
    err = float((got.float() - want.float()).abs().max())
    print(f"mesh hold [{label}]: bitwise {same} (max_abs {err:.3e})")
    need(same, f"mesh [{label}]: not bitwise the single call")
    return err


def _mesh_plan(op, mesh, *args, **kw):
    """``op``'s plan on ``mesh`` and the launches one call makes by it."""
    from repro_torch.hopper import partition

    plan = partition.plan_for(op, mesh, *args, **kw)
    return plan, _mesh_launches(op, plan, mesh, **kw)


def _mesh_row(report, mname, mesh, label, call, hold, plan, want):
    """One call on ``mesh``: the launches of one sharded call (the counts
    zeroed just before and read just after) against ``want``, the hold
    against the unsharded call, and both walls. ``plan`` is the op's plan
    (None: replicated), or a note for a call of several ops."""
    import torch

    from repro_torch.hopper import dispatch

    with torch.no_grad():
        single = call(None)
        torch.cuda.synchronize()
        dispatch.reset_launches()
        got = call(mesh)
        torch.cuda.synchronize()
        launches = dict(dispatch.LAUNCHES)
        pairs = list(zip(got, single)) if isinstance(got, tuple) else [(got, single)]
        err = max(hold(f"{mname} {label}" + (f" out {i}" if len(pairs) > 1 else ""), g, s)
                  for i, (g, s) in enumerate(pairs))
        del single, got, pairs
        single_ms = _wall_ms(lambda: call(None))
        sharded_ms = _wall_ms(lambda: call(mesh))
    if isinstance(plan, str) or plan is None:
        levels, note = "-", plan or "replicated"
    else:
        levels, note = "x".join(f"{a}={n}" for a, n in plan.levels), plan.note
    print(f"mesh {mname} {label}: levels {levels}; {note}; launches {launches} (expected "
          f"{want}); max_abs vs single {err:.3e}; wall sharded {sharded_ms:.3f} ms, single "
          f"{single_ms:.3f} ms, sharded / single {sharded_ms / single_ms:.2f}")
    need(launches == want, f"mesh {mname} {label}: launches {launches} != {want}")
    per = report["mesh_launches"].setdefault(mname, {})
    for k, v in launches.items():
        per[k] = per.get(k, 0) + v
    report["mesh_rows"].append(dict(mesh=mname, op=label, levels=levels, note=note,
                                     launches=launches, max_abs_err=err,
                                     sharded_ms=sharded_ms, single_ms=single_ms))


def mesh_phase(report, cases):
    """Every op of the partition layer on three meshes of ranks on one
    card's streams (pod2 x model2, data2 x model2, pod2 x data2 x model2):
    the GCN at ogbn-arxiv's scale (``mesh=`` on every mesh, ``use_mesh``
    once, and the 169,343-node graph whose spmm replicates with one
    warning), the sparse trio at card size (ELL SpMM and the stencils
    bitwise; the overlapped stencil bitwise its sync schedule at 3 launches
    a rank against 1), attention at occamy-gptj's width (flash head x
    batch, the long ring composed with heads, decode, the scaled FA),
    rwkv6-3b's scan shape and the ladder's GEMM in fp32 and under bf16.
    Then ``launch.mesh_rows`` (the bench twin) on pod2 x data2 x model2."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.diagnostics import ReproDegradeWarning, reset_degrade_warnings
    from repro_torch.hopper import dispatch, ops, partition
    from repro_torch.launch import gcn_inference as gi, mesh_rows
    from repro_torch.models import gcn
    from repro_torch.parallel import sharding
    from repro_torch.parallel.mesh import DeviceMesh

    t0 = time.perf_counter()
    report["mesh_launches"], report["mesh_rows"] = {}, []
    gen = torch.Generator(device="cuda").manual_seed(SEED + 23)
    rng = np.random.default_rng(SEED)
    params = gcn.init_params([gi.FEATURES] * (gi.LAYERS + 1), seed=SEED, device="cuda")
    adj = gi.adjacency(rng, MESH_GCN_NODES, OGBN_ARXIV[2]).to("cuda")
    feats = torch.from_numpy(rng.standard_normal((MESH_GCN_NODES, gi.FEATURES))
                             .astype(np.float32)).to("cuda")
    adj_odd = gi.adjacency(rng, OGBN_ARXIV[1], OGBN_ARXIV[2]).to("cuda")
    feats_odd = feats[:OGBN_ARXIV[1]].contiguous()
    H, Kh, D = MESH_ATTN
    flash_in = {label: tuple(torch.randn((B, h, S, D), generator=gen, device="cuda").bfloat16()
                             for h in (H, Kh, Kh)) for label, B, S in MESH_FLASH}
    Bd, Sd = MESH_DECODE
    qd = torch.randn((Bd, H, D), generator=gen, device="cuda").bfloat16()
    kd, vd = (torch.randn((Bd, Kh, Sd, D), generator=gen, device="cuda").bfloat16()
              for _ in range(2))
    pos = torch.randint(1, Sd, (Bd,), generator=gen, device="cuda", dtype=torch.int32)
    la = _la_card_inputs("rwkv6-3b", RECURRENT_T, gen)[:5]
    M, K, N = MESH_GEMM
    ga, gb = (torch.randn(s, generator=gen, device="cuda") for s in ((M, K), (K, N)))

    def rel(label, got, want):
        return _hold_rel("mesh", label, got, want, 1e-4)

    def fp32(label, got, want):
        return _hold(f"mesh {label}", "sharded vs single", got, want, RING_F32_TOL)

    def sparse(label, got, want):
        return _hold(f"mesh {label}", "sharded vs single", got, want, SPARSE_TOL)

    def gcn_rel(label, got, want):
        return _hold_rel("mesh gcn", label, got, want, GCN_REL_TOL)

    def scan(label, got, want):  # o in bf16, the final state in fp32
        return (_hold_mesh_bf16 if got.dtype == torch.bfloat16 else fp32)(label, got, want)

    for mname, shape in MESHES:
        n = int(np.prod(list(shape.values())))
        mesh = DeviceMesh(shape, devices=_mesh_devices(n))
        # the GCN: per layer, gemm K-sharded with its psum, then spmm's rows
        g_plan, g_want = _mesh_plan("gemm", mesh, feats, params[0])
        s_plan, s_want = _mesh_plan("spmm", mesh, adj.values, adj.cols, feats)
        want = {"gemm": gi.LAYERS * g_want["gemm"], "spmm": gi.LAYERS * s_want["spmm"]}
        _mesh_row(report, mname, mesh, f"gcn forward n={MESH_GCN_NODES}",
                  lambda m: gcn.forward(params, adj, feats, mesh=m), gcn_rel,
                  f"gemm: {g_plan.note}; spmm: {s_plan.note}", want)
        if mname == "pod2xmodel2":
            need(want == {"gemm": 8, "spmm": 8}, f"gcn on {mname}: {want}, not 8 gemm + 8 spmm")
            with torch.no_grad():
                single = gcn.forward(params, adj, feats)
                with sharding.use_mesh(mesh):
                    need(sharding.kernel_mesh() is mesh, "use_mesh did not set the kernel mesh")
                    dispatch.reset_launches()
                    ctx = gcn.forward(params, adj, feats)
                    torch.cuda.synchronize()
                    ctx_launches = dict(dispatch.LAUNCHES)
                need(sharding.kernel_mesh() is None, "use_mesh did not restore the kernel mesh")
                gcn_rel(f"{mname} gcn under use_mesh", ctx, single)
                print(f"mesh {mname} gcn under use_mesh: launches {ctx_launches} (expected {want})")
                need(ctx_launches == want, f"gcn under use_mesh launched {ctx_launches}")
                # 169,343 rows: spmm's ladder replicates with one warning; gemm shards
                reset_degrade_warnings()
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    dispatch.reset_launches()
                    odd = gcn.forward(params, adj_odd, feats_odd, mesh=mesh)
                    torch.cuda.synchronize()
                    odd_launches = dict(dispatch.LAUNCHES)
                degraded = [str(w.message) for w in caught
                            if issubclass(w.category, ReproDegradeWarning)]
                gcn_rel(f"{mname} gcn n={OGBN_ARXIV[1]}, spmm replicated", odd,
                        gcn.forward(params, adj_odd, feats_odd))
                odd_plan = partition.plan_for("spmm", mesh, adj_odd.values, adj_odd.cols,
                                              feats_odd)
                odd_want = {"gemm": want["gemm"], "spmm": gi.LAYERS}
                print(f"mesh {mname} gcn n={OGBN_ARXIV[1]}: spmm plan {odd_plan}; warnings "
                      f"{degraded}; launches {odd_launches} (expected {odd_want})")
                need(odd_plan is None and len(degraded) == 1 and "'spmm'" in degraded[0],
                     f"the {OGBN_ARXIV[1]}-row spmm did not replicate with one warning")
                need(odd_launches == odd_want, f"gcn n={OGBN_ARXIV[1]} launched {odd_launches}")
                del single, ctx, odd
            profile_fn(f"mesh {mname} gcn forward n={MESH_GCN_NODES}",
                       lambda: gcn.forward(params, adj, feats, mesh=mesh), report)
            profile_fn(f"mesh unsharded gcn forward n={MESH_GCN_NODES}",
                       lambda: gcn.forward(params, adj, feats), report)

        # the sparse trio at card size, on phase 4's operands
        for case in cases:
            A = case.args[0]
            if case.op == "stencil":
                grid, offs, w = case.args
                for overlap in (False, True):
                    plan, want = _mesh_plan("stencil", mesh, grid, offsets=offs, weights=w,
                                            overlap=overlap)
                    need(plan.overlappable == overlap, f"{case.name}: {plan.note}")
                    _mesh_row(report, mname, mesh, f"{case.name} overlap={overlap}",
                              lambda m, g=grid, o=offs, w_=w, ov=overlap: ops.stencil(
                                  g, o, w_, mesh=m, overlap=ov),
                              _hold_mesh_bitwise, plan, want)
                with torch.no_grad():
                    _hold_mesh_bitwise(f"{mname} {case.name} overlap vs sync",
                                       ops.stencil(grid, offs, w, mesh=mesh, overlap=True),
                                       ops.stencil(grid, offs, w, mesh=mesh, overlap=False))
            elif case.op == "spmm":
                dense = case.args[1]
                _mesh_row(report, mname, mesh, case.name,
                          lambda m, A=A, d=dense: ops.spmm(A, d, mesh=m), _hold_mesh_bitwise,
                          *_mesh_plan("spmm", mesh, A.values, A.cols, dense))
            elif case.op == "bsr_spmm":
                dense = case.args[1]
                _mesh_row(report, mname, mesh, case.name,
                          lambda m, A=A, d=dense: ops.bsr_spmm(A, d, mesh=m), sparse,
                          *_mesh_plan("bsr_spmm", mesh, A.tile_values, A.tile_rows,
                                      A.tile_cols, dense, num_rows=A.shape[0]))
            else:
                B, Kc = case.args[1], case.args[2]
                _mesh_row(report, mname, mesh, case.name,
                          lambda m, A=A, B=B, k=Kc: ops.spmspm(A, B, k, mesh=m), sparse,
                          *_mesh_plan("spmspm", mesh, A.values, A.cols, B.values, B.cols,
                                      contraction_dim=Kc))

        # attention at occamy-gptj's width (bf16): heads x batch, the long
        # ring composed with heads (its hops through the ring-hop kernel),
        # the scaled FA under bf16, decode
        for label, B, S in MESH_FLASH:
            q, k, v = flash_in[label]
            kw = {"remote_copy": True} if B == 1 else {}
            _mesh_row(report, mname, mesh, label,
                      lambda m, q=q, k=k, v=v, kw=kw: ops.flash_attention(q, k, v, mesh=m, **kw),
                      _hold_mesh_bf16, *_mesh_plan("flash_attention", mesh, q, k, v, **kw))
        q, k, v = flash_in[MESH_FLASH[0][0]]
        _mesh_row(report, mname, mesh, f"{MESH_FLASH[0][0]} precision=bf16",
                  lambda m: ops.flash_attention(q, k, v, mesh=m, precision="bf16"), fp32,
                  *_mesh_plan("flash_attention", mesh, q, k, v, precision="bf16"))
        _mesh_row(report, mname, mesh, f"decode B={Bd} S={Sd}",
                  lambda m: ops.decode_attention(qd, kd, vd, pos, mesh=m), _hold_mesh_bf16,
                  *_mesh_plan("decode_attention", mesh, qd, kd, vd, pos))
        _mesh_row(report, mname, mesh, f"linear_attention rwkv6-3b B=4 T={RECURRENT_T}",
                  lambda m: ops.linear_attention(*la, mesh=m), scan,
                  *_mesh_plan("linear_attention", mesh, *la))
        # the ladder's GEMM: fp32 (K-split, fp32 psum) and bf16 (bf16 psum)
        _mesh_row(report, mname, mesh, f"gemm {M}x{K}x{N} fp32",
                  lambda m: ops.gemm(ga, gb, mesh=m), rel, *_mesh_plan("gemm", mesh, ga, gb))
        plan, want = _mesh_plan("gemm", mesh, ga, gb, precision="bf16")
        need(plan.note.endswith("bfloat16 reduce"), f"gemm bf16 plan: {plan.note}")
        _mesh_row(report, mname, mesh, f"gemm {M}x{K}x{N} precision=bf16",
                  lambda m: ops.gemm(ga, gb, mesh=m, precision="bf16"), _hold_mesh_bf16,
                  plan, want)
        del mesh
        gc.collect()
        torch.cuda.empty_cache()

    mesh = DeviceMesh({"pod": 2, "data": 2, "model": 2}, devices=_mesh_devices(8))
    rows = mesh_rows.run(mesh, reps=MESH_WALL_REPS).json_rows
    for r in rows:
        need(r["max_err"] <= (0.0 if r["overlap"] else 1e-3), f"mesh_rows {r['name']}: {r}")
    report["mesh_bench_rows"] = rows
    print(f"mesh phase: {time.perf_counter() - t0:.1f} s; launches by mesh "
          f"{report['mesh_launches']}")


# ---------------------------------------------------------------------------
# phase 14: the training path (launch/train.py -> runtime/train_loop.py,
# AdamW, compression, checkpoint/restart, the synthetic data stream) with
# gradients through the FA-2 and scan kernels (hopper/grads.py)
# ---------------------------------------------------------------------------

# (a) each Function's input gradients (kernel forward + plain backward)
# against the same call's gradients through the torch impl (autograd of the
# plain forms), same inputs and upstream gradient: fp32 inputs to max|diff|
# <= 1e-4 max|torch| per gradient (fp32 sums in other orders); bf16 inputs
# to a Frobenius |diff| <= 1e-2 |torch| per gradient (each side rounds its
# forward to bf16 at other points, and the gradients carry it)
GRAD_FP32_REL = 1e-4
GRAD_BF16_FRO = 1e-2
# (label, B, H, K, Sq, Sk, D, dtype, window, q_offset), all causal:
# hymba-1.5b's attention (a window layer and a global one), gemma-2b's (MQA
# at D 256), and small fp32 ones with GQA, a window and q_offset (Sq < Sk)
GRAD_FA_CASES = [
    ("hymba-1.5b window", 2, 25, 5, 2048, 2048, 64, "bfloat16", 1024, 0),
    ("hymba-1.5b global", 2, 25, 5, 2048, 2048, 64, "bfloat16", 0, 0),
    ("gemma-2b", 2, 8, 1, 2048, 2048, 256, "bfloat16", 0, 0),
    ("small fp32 GQA q_offset", 2, 4, 2, 130, 200, 64, "float32", 0, 70),
    ("small fp32 window", 2, 4, 1, 130, 130, 32, "float32", 50, 0),
]
# (b) one full-width hymba step, cuda against torch: the loss and the
# global gradient norm to GRAD_NORM_REL of the torch path's, every leaf
# finite and nonzero, and every leaf's cosine: in fp32 >= GRAD_COSINE_FP32
# (only fp32 summation order separates the two paths); in bf16, the
# model's dtype, >= GRAD_COSINE_BF16. There a random-weight model at full
# depth amplifies where o is rounded, and the kernels round it from other
# sums than the plain forms: FA's P . V from P split into bf16 hi + lo
# (~16 bits), the scan's o from fp64 running sums. Plain controls that
# round so (FA: 64-key tiles with P split; the scan: chunk 16 for 32) drift
# from the torch path as far as the kernels do, one op at a time and both
# together (worst cosine ~0.9806 either way on an H100), so the bound sits
# under that reading: a leaf 1.3x further from the torch path than a
# correctly rounded path fails
GRAD_NORM_REL = 1e-2
GRAD_COSINE_FP32 = 0.9999
GRAD_COSINE_BF16 = 0.975
TRAIN_ARCH = "hymba-1.5b"
TRAIN_B, TRAIN_S = 2, 2048
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_CRASH_AT = 6, 3, 4
# hymba-1.5b trains at full width with 8 of its 32 layers in (b), (c) and
# (e): the hymba steps are host-bound (0.12-0.3 s a layer, by the host the
# card sits on) and the phase's largest cost; on a slow host the whole
# script came within 80 s of its 1200 s limit at 16 layers. A layer's
# shapes, kernels and launches do not change with depth
TRAIN_LAYERS = 8
TRAIN_CUT_WHY = ("hymba's host-bound training steps are the phase's largest cost, and on a slow "
                 "host the script came within 80 s of its time limit at 16 layers; a layer's "
                 "shapes, kernels and launches do not change with depth")
TRAIN_RESUME_RTOL = 1e-3  # straight vs resumed final loss (CUDA's embedding atomics)
# (d) the other two families: (arch, steps)
TRAIN_OTHERS = (("gemma-2b", 3), ("rwkv6-3b", 3))
# (e) the example's twin: gptj-100m, B 4 x 128, 60 steps, crash at 30
LLM_STEPS, LLM_CRASH_AT = 60, 30
TRAIN_CKPT_DIR = ROOT / "chip_scratch" / "train_ckpt"


def _fro_rel(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm().clamp_min(1e-30))


def _hold_grads(label, names, got, want, dtype_name):
    for name, g, w in zip(names, got, want):
        need(g is not None and w is not None, f"grad [{label}] {name}: missing gradient")
        need(tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype,
             f"grad [{label}] {name}: {tuple(g.shape)} {g.dtype} vs {tuple(w.shape)} {w.dtype}")
        need(bool(g.isfinite().all()), f"grad [{label}] {name}: non-finite")
        if dtype_name == "float32":
            rel = _rel(g, w)
            ok = rel <= GRAD_FP32_REL
            print(f"grad [{label}] d{name}: max rel {rel:.3e} (tol {GRAD_FP32_REL:g}) "
                  f"{'ok' if ok else 'FAIL'}")
        else:
            rel = _fro_rel(g, w)
            ok = rel <= GRAD_BF16_FRO
            print(f"grad [{label}] d{name}: Frobenius rel {rel:.3e} (tol {GRAD_BF16_FRO:g}), "
                  f"max rel {_rel(g, w):.3e} {'ok' if ok else 'FAIL'}")
        need(ok, f"grad [{label}] d{name}: kernel path disagrees with the torch path")
    return max(_rel(g, w) for g, w in zip(got, want))


def _bwd_ms(fn, inputs, upstream, reps=3):
    """Device time of one backward of ``fn`` (CUDA events, warm)."""
    import torch

    outs = fn()
    torch.autograd.grad(outs, inputs, upstream, retain_graph=True)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        torch.autograd.grad(outs, inputs, upstream, retain_graph=True)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_grad_functions(report):
    """(a): both autograd Functions on the card at the training path's
    shapes, against the torch impl's gradients."""
    import torch

    from repro_torch.hopper import dispatch, ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    errs, times = {}, {}
    for label, B, H, K, Sq, S, D, dt, window, q_offset in GRAD_FA_CASES:
        dtype = getattr(torch, dt)
        # (B, S, H, D) -> (B, H, S, D) views, as the transformer passes them
        q = torch.randn((B, Sq, H, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
        k, v = (torch.randn((B, S, K, D), generator=gen, device="cuda").to(dtype).transpose(1, 2)
                for _ in range(2))
        for x in (q, k, v):
            x.requires_grad_(True)
        do = torch.randn((B, H, Sq, D), generator=gen, device="cuda").to(dtype)
        kw = dict(causal=True, window=window, q_offset=q_offset)
        res = {}
        for impl in ("cuda", "torch"):
            dispatch.reset_launches()
            o = ops.flash_attention(q, k, v, impl=impl, **kw)
            res[impl] = torch.autograd.grad(o, (q, k, v), do)
            torch.cuda.synchronize()
            if impl == "cuda":
                need(dict(dispatch.LAUNCHES) == {"flash_attention": 1},
                     f"grad [{label}]: the Function's forward launched {dict(dispatch.LAUNCHES)}")
        errs[f"fa {label}"] = _hold_grads(f"flash_attention {label}", "qkv", res["cuda"],
                                          res["torch"], dt)
        if label.startswith(TRAIN_ARCH):
            times[f"fa {label}"] = _bwd_ms(
                lambda: ops.flash_attention(q, k, v, impl="cuda", **kw), (q, k, v), do)
        del q, k, v, do, res
    # the scan: rwkv6-3b's card shape (u), hymba's SSD read-out (broadcast
    # r/k/w, s0), and a small fp32 case with u and s0 at chunk 16
    r, k, v, w, u, lab = _la_card_inputs("rwkv6-3b", RECURRENT_T, gen, TRAIN_B)
    scan_cases = [(lab, (r, k, v, w, u, None), 32, "bfloat16")]
    r, k, v, w, _, lab = _la_card_inputs(TRAIN_ARCH, RECURRENT_T, gen, TRAIN_B)
    s0 = torch.randn((r.shape[0], r.shape[1], r.shape[3], v.shape[3]), generator=gen,
                     device="cuda")
    scan_cases.append((lab + " s0", (r, k, v, w, None, s0), 32, "bfloat16"))
    small = [torch.randn((2, 3, 70, n), generator=gen, device="cuda") for n in (8, 8, 12)]
    small_w = -torch.rand((2, 3, 70, 8), generator=gen, device="cuda") - 0.05
    scan_cases.append(("small fp32 u s0 chunk 16",
                       (*small, small_w, torch.randn((3, 8), generator=gen, device="cuda"),
                        torch.randn((2, 3, 8, 12), generator=gen, device="cuda")), 16, "float32"))
    for label, args, chunk, dt in scan_cases:
        names = [n for n, x in zip(("r", "k", "v", "w_log", "u", "s0"), args) if x is not None]
        leaves = [x.detach().requires_grad_(True) if x is not None else None for x in args]
        wrt = [x for x in leaves if x is not None]
        o_like = leaves[2]
        do = torch.randn(o_like.shape, generator=gen, device="cuda").to(o_like.dtype)
        dS = torch.randn((o_like.shape[0], o_like.shape[1], args[0].shape[3], o_like.shape[3]),
                         generator=gen, device="cuda")
        res, outs = {}, {}
        for impl in ("cuda", "torch"):
            dispatch.reset_launches()
            outs[impl] = ops.linear_attention(*leaves, impl=impl, chunk=chunk)
            res[impl] = torch.autograd.grad(outs[impl], wrt, (do, dS))
            torch.cuda.synchronize()
            if impl == "cuda":
                need(dict(dispatch.LAUNCHES) == {"linear_attention": 1},
                     f"grad [{label}]: the Function's forward launched {dict(dispatch.LAUNCHES)}")
        # both backwards differentiate the plain form at the plain forward,
        # so what separates training's gradient from the torch path's is
        # the kernel's forward: its o and S_final held to the plain ones at
        # the forward check's tolerances
        (o_k, s_k), (o_t, s_t) = ((o.detach(), S.detach()) for o, S in outs.values())
        if dt == "bfloat16":
            _hold_bf16("linear_attention", f"{label} Function forward", o_k, o_t)
        else:
            _hold_rel("linear_attention", f"{label} Function forward o", o_k, o_t, LA_REL_TOL)
        _hold_rel("linear_attention", f"{label} Function forward S_final", s_k, s_t, LA_REL_TOL)
        del outs, o_k, s_k, o_t, s_t
        errs[f"scan {label}"] = _hold_grads(f"linear_attention {label}", names, res["cuda"],
                                            res["torch"], dt)
        if label.startswith(TRAIN_ARCH):
            times[f"scan {TRAIN_ARCH}"] = _bwd_ms(
                lambda: ops.linear_attention(*leaves, impl="cuda", chunk=chunk), wrt, (do, dS))
        del leaves, wrt, res
    for name, ms in times.items():
        print(f"backward {name}: {ms:.3f} ms a layer (plain torch, CUDA events, warm)")
    report["grad_err"] = errs
    report["grad_bwd_ms"] = times
    gc.collect()
    torch.cuda.empty_cache()


def _state_gb(state):
    """'params P GB + AdamW moments M GB' of a train state."""
    from repro_torch.core import tree

    def gb(t):
        return sum(x.numel() * x.element_size() for x in tree.leaves(t)) / 1e9

    return (f"params {gb(state['params']):.2f} GB + AdamW moments "
            f"{gb(state['opt']['m']) + gb(state['opt']['v']):.2f} GB")


def _fa_plain_split_p(q, k, v, *, causal, window, q_offset, scale, return_lse=False,
                      bq=None, bk=None):
    """A plain control of the bf16 FA kernel's rounding: the blocked
    FA-2 loop over the kernel's 64-key tiles with P . V taken from P split
    into two bf16 terms, hi + lo (~16 bits, where the plain form keeps
    fp32's 24), and the row sums from the fp32 P, as the kernel does;
    differentiated by autograd like the plain form."""
    import math

    import torch

    from repro_torch.hopper import blocked

    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G, bk = H // K, 64
    need(Sk % bk == 0 and not return_lse, f"the split-P control takes Sk % {bk} == 0: {Sk}")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qf = (q.float() * scale).reshape(B, K, G, Sq, D)
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, K, G, Sq), blocked.NEG, device=q.device)
    denom = torch.zeros((B, K, G, Sq), device=q.device)
    acc = torch.zeros((B, K, G, Sq, D), device=q.device)
    for start in range(0, Sk, bk):
        s = torch.einsum("bkgqd,bksd->bkgqs", qf, k[:, :, start:start + bk].float())
        k_pos = torch.arange(start, start + bk, device=q.device)
        mask = torch.ones((Sq, bk), dtype=torch.bool, device=q.device)
        if causal or window:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, blocked.NEG)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        hi = p.bfloat16().float()
        split = hi + (p - hi).bfloat16().float()
        acc = acc * corr[..., None] + torch.einsum("bkgqs,bksd->bkgqd", split,
                                                   v[:, :, start:start + bk].float())
        m = m_new
    return (acc / denom.clamp_min(1e-30)[..., None]).reshape(B, H, Sq, D).to(q.dtype)


@contextlib.contextmanager
def _torch_impl_of(op, fn):
    """Within the block, ``op``'s ``torch`` registration is ``fn``: under
    the default impl ``torch`` that one op runs ``fn``."""
    from repro_torch.hopper import dispatch

    old = dispatch._REGISTRY[op]["torch"]
    dispatch.register_kernel(op, impl="torch")(fn)
    try:
        yield
    finally:
        dispatch.register_kernel(op, impl="torch")(old)


def _step_grads(cfg, params, batch, impl, want=None, *, blocks=None, kernel_only=None,
                fa_torch=None):
    """One step's (loss, gradients) through ``impl``, timed; ``blocks``
    overrides the plain forms' blocks ({op: {name: size}}); ``kernel_only``
    (an op) runs that op's cuda impl inside the torch path; ``fa_torch``
    replaces the torch path's attention. With ``want``, the kernels'
    launches are held to it."""
    from repro_torch.hopper import dispatch
    from repro_torch.hopper import ops as hops
    from repro_torch.runtime import train_loop

    import torch

    torch.cuda.synchronize()
    dispatch.reset_launches()
    t = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(dispatch.default_impl(impl))
        for op, sizes in (blocks or {}).items():
            stack.enter_context(dispatch.block_override(op, **sizes))
        if kernel_only:
            cuda_impl = {"flash_attention": hops._fa_cuda, "linear_attention": hops._la_cuda}
            stack.enter_context(_torch_impl_of(kernel_only, cuda_impl[kernel_only]))
        if fa_torch:
            stack.enter_context(_torch_impl_of("flash_attention", fa_torch))
        out = train_loop.loss_and_grads_fn(cfg)(params, batch)
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    print(f"step grads {cfg.name} {cfg.dtype} B=1 T={TRAIN_S} impl={impl} {blocks or ''}"
          f"{f' {kernel_only} kernel only' if kernel_only else ''}"
          f"{f' attention {fa_torch.__name__}' if fa_torch else ''}: loss {float(out[0]):.6f}, "
          f"{(time.perf_counter() - t) * 1e3:.1f} ms, launches {launches}")
    if want is not None:
        need(launches == want, f"one {cfg.remat}-remat step launched {launches}, want {want}")
    return out


def _cosines(a, b):
    """[(cosine, path)] of two gradient trees, worst first."""
    import torch

    from repro_torch.core import tree

    paths, la = tree.flatten_with_paths(a)
    out = []
    for path, x, y in zip(paths, la, tree.leaves(b)):
        x, y = x.float().flatten(), y.float().flatten()
        need(bool(torch.isfinite(x).all()) and bool(x.abs().max() > 0),
             f"grad {path}: non-finite or zero")
        out.append((float(torch.dot(x, y) / (x.norm() * y.norm()).clamp_min(1e-30)), path))
    return sorted(out)


def _hold_step(label, got, want, bound=None):
    """The loss and the global gradient norm of ``got`` to GRAD_NORM_REL
    of ``want``'s, every leaf finite and nonzero; with ``bound``, every
    leaf's cosine to it (else printed)."""
    from repro_torch.optim import adamw

    loss_rel = abs(float(got[0]) - float(want[0])) / abs(float(want[0]))
    ng, nw = float(adamw.global_norm(got[1])), float(adamw.global_norm(want[1]))
    norm_rel = abs(ng - nw) / nw
    cos = _cosines(got[1], want[1])
    print(f"step grads {label}: loss rel {loss_rel:.3e}, global grad norm {ng:.5f} vs {nw:.5f} "
          f"(rel {norm_rel:.3e}, tol {GRAD_NORM_REL:g}), {len(cos)} leaves finite and nonzero, "
          f"cosines worst {cos[0][0]:.6f} ({cos[0][1]}), median {cos[len(cos) // 2][0]:.6f}"
          + (f" (tol {bound})" if bound is not None else " (a control, no bound)"))
    need(loss_rel <= GRAD_NORM_REL, f"{label}: loss rel {loss_rel:.3e}")
    need(norm_rel <= GRAD_NORM_REL, f"{label}: global grad norm rel {norm_rel:.3e}")
    if bound is not None:
        need(cos[0][0] >= bound, f"{label}: grad {cos[0][1]} cosine {cos[0][0]:.5f} < {bound}")
    return dict(loss_rel=loss_rel, norm_rel=norm_rel, worst_cosine=cos[0][0],
                median_cosine=cos[len(cos) // 2][0])


def check_full_width_step(report):
    """(b): one hymba-1.5b step at full width (TRAIN_LAYERS layers), B 1 x 2048,
    through the kernels (cuda) against the torch impl, in bf16 (the
    model's dtype) and in fp32: the loss, the global gradient norm and
    every leaf's cosine. In bf16 each kernel alone in the torch path, and
    the plain controls that round as the kernels do (``_fa_plain_split_p``,
    the scan at chunk 16, both), are held to the torch path the same way
    with their cosines printed beside the bound."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core import tree
    from repro_torch.models import registry

    cfg = get_config(TRAIN_ARCH).replace(num_layers=TRAIN_LAYERS)
    nl = cfg.num_layers
    print(f"train {TRAIN_ARCH}: depth cut to {nl} of {get_config(TRAIN_ARCH).num_layers} layers "
          f"(full width): {TRAIN_CUT_WHY}")
    want = {"flash_attention": 2 * nl, "linear_attention": 2 * nl}
    params = registry.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, TRAIN_S)).astype(np.int32))
             .cuda() for k in ("tokens", "labels")}
    plain = _step_grads(cfg, params, batch, "torch", {})
    res = {"bfloat16": _hold_step(f"{TRAIN_ARCH} bf16 cuda vs torch",
                                  _step_grads(cfg, params, batch, "cuda", want), plain,
                                  GRAD_COSINE_BF16)}
    controls = {  # each kernel alone, and plain controls that round as it does
        "torch, FA kernel": dict(kernel_only="flash_attention",
                                 want={"flash_attention": 2 * nl}),
        "torch, FA split P": dict(fa_torch=_fa_plain_split_p),
        "torch, scan kernel": dict(kernel_only="linear_attention",
                                   want={"linear_attention": 2 * nl}),
        "torch, scan chunk 16": dict(blocks={"linear_attention": {"chunk": 16}}),
        "torch, FA split P, scan chunk 16": dict(fa_torch=_fa_plain_split_p,
                                                 blocks={"linear_attention": {"chunk": 16}}),
    }
    for name, kw in controls.items():
        got = _step_grads(cfg, params, batch, "torch", kw.pop("want", {}), **kw)
        res[f"bfloat16 {name}"] = _hold_step(f"{TRAIN_ARCH} bf16 {name} vs torch", got, plain)
        del got
    del plain
    cfg32 = cfg.replace(dtype="float32")
    params = tree.tree_map(lambda x: x.float(), params)
    gc.collect()
    torch.cuda.empty_cache()
    kern = _step_grads(cfg32, params, batch, "cuda", want)
    plain = _step_grads(cfg32, params, batch, "torch", {})
    res["float32"] = _hold_step(f"{TRAIN_ARCH} fp32 cuda vs torch", kern, plain, GRAD_COSINE_FP32)
    report["train_grad_check"] = res
    del params, kern, plain
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _depth_cut(cut_arch, layers):
    """``launch.train``'s configs with ``cut_arch`` cut to ``layers`` layers
    (full width); every other config as it is."""
    from repro_torch.launch import train

    real = train.get_config

    def cut(arch, reduced=False):
        cfg = real(arch, reduced)
        return cfg.replace(num_layers=layers) if arch == cut_arch and not reduced else cfg

    train.get_config = cut
    try:
        yield
    finally:
        train.get_config = real


def _train_run(argv, cut=(TRAIN_ARCH, TRAIN_LAYERS)):
    """``launch.train.main(argv)`` (``cut``: an arch and the layers it keeps,
    by default TRAIN_ARCH at TRAIN_LAYERS) with the launch counts zeroed
    just before and read just after: (result or the exit code, launches,
    wall seconds, peak GB)."""
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    dispatch.reset_launches()
    t = time.perf_counter()
    try:
        with _depth_cut(*cut):
            out = train.main(argv)
    except SystemExit as e:  # the injected crash, and only it
        need(e.code == train.CRASH_EXIT, f"train {argv}: exit {e.code}")
        out = e.code
    torch.cuda.synchronize()
    return (out, dict(dispatch.LAUNCHES), time.perf_counter() - t,
            torch.cuda.max_memory_allocated() / 1e9)


def _per_step(launches, steps, want_per_step, label):
    got = {k: v // steps for k, v in launches.items()}
    print(f"{label}: launches {launches} over {steps} steps = {got} a step, "
          f"expected {want_per_step} a step")
    need(launches == {k: v * steps for k, v in want_per_step.items()},
         f"{label}: launches {launches} != {want_per_step} x {steps}")
    return got


def _profile_step(report, arch, cfg, state, steps_done):
    """The warm step's wall, busy and idle share and top device operations
    (``profile_fn``), tokens/s, and the model FLOPs (6 N T, the
    reference's MODEL_FLOPS) with their share of the bf16 dense peak."""
    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.core import precision as prec
    from repro_torch.data.synthetic import batch_at_step
    from repro_torch.runtime import train_loop

    step = train_loop.make_train_step(cfg)
    host = batch_at_step(cfg, SHAPES["train_4k"], SEED, steps_done, TRAIN_B, TRAIN_S)
    b = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    name = f"train {arch} step B={TRAIN_B} T={TRAIN_S}"
    # a step takes seconds, and the run has just taken several: one timed
    # wall, one span, one trace
    profile_fn(name, lambda: step(state, b), report, walls=1, cpu=False, warm=True)
    prof = report["profile"][name]
    tokens = TRAIN_B * TRAIN_S
    flops = 6 * cfg.num_params() * tokens
    tok_s = tokens / (prof["wall_ms"] / 1e3)
    peak = prec.peak_flops("bf16")
    mfu = flops / (prof["wall_ms"] / 1e3) / peak
    print(f"{name}: {tok_s:.1f} tokens/s; model FLOPs 6*N*T = 6 x {cfg.num_params():,} x "
          f"{tokens} = {flops:.4e} a step, {mfu:.4f} of the bf16 dense peak "
          f"({peak:.4g} FLOP/s)")
    return dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"], idle_share=prof["idle_share"],
                tokens_per_s=tok_s, model_flops=flops, mfu=mfu)


def train_path_phase(report):
    """(c) hymba-1.5b through ``launch/train.py``'s ``main`` at full width
    (TRAIN_LAYERS layers): a straight run, a crashed run (exit 42), the restart from
    its checkpoint; launches a step, the two final losses, a profiled
    step. (d) gemma-2b and rwkv6-3b the same way, 3 steps each."""
    import math
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.runtime import checkpoint as ckpt

    cfg = get_config(TRAIN_ARCH).replace(num_layers=TRAIN_LAYERS)
    nl = cfg.num_layers
    want = {"flash_attention": 2 * nl, "linear_attention": 2 * nl}  # forward and recompute
    base = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
            "--steps", str(TRAIN_STEPS), "--seed", str(SEED), "--log-every", "1"]
    print(f"train {TRAIN_ARCH}: full width, depth cut to {nl} of "
          f"{get_config(TRAIN_ARCH).num_layers} layers ({cfg.num_params():,} parameters by "
          f"cfg.num_params()): {TRAIN_CUT_WHY}; {cfg.dtype}, remat={cfg.remat}, "
          f"B={TRAIN_B} x S={TRAIN_S}")
    (state, straight, _), launches, wall, peak = _train_run(base)
    per_step = _per_step(launches, TRAIN_STEPS, want, f"train {TRAIN_ARCH} straight run")
    need(all(math.isfinite(x) for x in straight), f"non-finite loss {straight}")
    print(f"train {TRAIN_ARCH} straight run: {TRAIN_STEPS} steps in {wall:.1f} s (init "
          f"included), losses {straight}, peak allocated {peak:.2f} GB, {_state_gb(state)}")
    del state
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    ck = ["--ckpt-dir", str(TRAIN_CKPT_DIR), "--ckpt-every", str(TRAIN_CKPT_EVERY)]
    code, launches_crash, wall_crash, _ = _train_run(base + ck + ["--inject-crash-at",
                                                                  str(TRAIN_CRASH_AT)])
    need(code == 42, f"the crashed run exited {code}, not 42")
    need(ckpt.latest_step(str(TRAIN_CKPT_DIR)) == TRAIN_CKPT_EVERY,
         f"checkpoint after the crash: {ckpt.latest_step(str(TRAIN_CKPT_DIR))}")
    _per_step(launches_crash, TRAIN_CRASH_AT, want, f"train {TRAIN_ARCH} crashed run")
    print(f"train {TRAIN_ARCH} crashed run: exit 42 at step {TRAIN_CRASH_AT} after "
          f"{wall_crash:.1f} s, latest checkpoint step {TRAIN_CKPT_EVERY}")
    # the restart restores from the same directory; its --ckpt-every lies
    # past the last step, so it writes no checkpoint that nothing would read
    (state, resumed, _), launches_res, wall_res, peak_res = _train_run(
        base + ["--ckpt-dir", str(TRAIN_CKPT_DIR), "--ckpt-every", str(TRAIN_STEPS + 1)])
    need(ckpt.latest_step(str(TRAIN_CKPT_DIR)) == TRAIN_CKPT_EVERY,
         f"the resumed run wrote a checkpoint: {ckpt.latest_step(str(TRAIN_CKPT_DIR))}")
    resumed_steps = TRAIN_STEPS - TRAIN_CKPT_EVERY
    _per_step(launches_res, resumed_steps, want, f"train {TRAIN_ARCH} resumed run")
    need(len(resumed) == resumed_steps and int(state["opt"]["step"]) == TRAIN_STEPS,
         f"resumed {len(resumed)} steps to opt.step {int(state['opt']['step'])}")
    rel = abs(resumed[-1] - straight[-1]) / abs(straight[-1])
    print(f"train {TRAIN_ARCH} resumed run: from step {TRAIN_CKPT_EVERY}, {len(resumed)} steps "
          f"in {wall_res:.1f} s (restore included), opt.step {int(state['opt']['step'])}, "
          f"final loss {resumed[-1]:.6f} vs straight {straight[-1]:.6f} (rel {rel:.3e}, rtol "
          f"{TRAIN_RESUME_RTOL:g}), peak allocated {peak_res:.2f} GB")
    need(rel <= TRAIN_RESUME_RTOL, "the resumed run's final loss is not the straight run's")
    shutil.rmtree(TRAIN_CKPT_DIR, ignore_errors=True)
    prof = _profile_step(report, TRAIN_ARCH, cfg, state, TRAIN_STEPS)
    train = {TRAIN_ARCH: dict(launches_per_step=per_step, losses=straight, resumed=resumed,
                              resume_rel=rel, peak_gb=peak, **prof)}
    # the plain backward's share: (a)'s warm backward times at this B and
    # T, one a layer (window layers, global layers, the scan in every one)
    bwd = report["grad_bwd_ms"]
    n_global = cfg.num_global_layers
    plain_bwd = (bwd[f"fa {TRAIN_ARCH} window"] * (nl - n_global)
                 + bwd[f"fa {TRAIN_ARCH} global"] * n_global
                 + sum(v for k, v in bwd.items() if k.startswith("scan")) * nl)
    share = plain_bwd / prof["wall_ms"]
    print(f"train {TRAIN_ARCH}: the plain FA and scan backward, from (a)'s times a layer, "
          f"~{plain_bwd:.1f} ms a step = {share:.3f} of the step's wall")
    prof.update(plain_bwd_ms=plain_bwd, plain_bwd_share=share)
    del state
    for arch, steps in TRAIN_OTHERS:
        c = get_config(arch)
        want_o = ({"linear_attention": 2 * c.num_layers} if c.family == "ssm"
                  else {"flash_attention": 2 * c.num_layers})
        (state, losses, _), launches, wall, peak = _train_run(
            ["--arch", arch, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--steps",
             str(steps), "--seed", str(SEED), "--log-every", "1"])
        per = _per_step(launches, steps, want_o, f"train {arch}")
        need(all(math.isfinite(x) for x in losses), f"{arch}: non-finite loss {losses}")
        print(f"train {arch}: full width and depth ({c.num_layers} layers, {c.num_params():,} "
              f"parameters), {steps} steps in {wall:.1f} s, losses {losses}, peak allocated "
              f"{peak:.2f} GB, {_state_gb(state)} (depth not cut)")
        prof = _profile_step(report, arch, c, state, steps)
        train[arch] = dict(launches_per_step=per, losses=losses, peak_gb=peak, **prof)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    report["train"] = train


def train_options_phase(report):
    """(e) the twin of examples/train_llm.py (gptj-100m, fp32) with its
    crash and restart; microbatched gradients against the full batch's
    (the reference's bar); one step each with --microbatches 2 and
    --grad-compression at hymba-1.5b's full width (TRAIN_LAYERS layers)."""
    import math

    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.core import pipeline, tree
    from repro_torch.data.synthetic import batch_at_step
    from repro_torch.hopper import dispatch
    from repro_torch.launch import train_llm
    from repro_torch.runtime import train_loop

    t = time.perf_counter()
    dispatch.reset_launches()
    llm_losses, state = train_llm.run(LLM_STEPS, 4, 128, LLM_CRASH_AT, device="cuda")
    torch.cuda.synchronize()
    first = train_llm.first_loss(4, 128, device="cuda")
    resumed_from = (LLM_CRASH_AT // train_llm.CKPT_EVERY) * train_llm.CKPT_EVERY
    print(f"train_llm {train_llm.CFG.name} ({train_llm.CFG.num_params() / 1e6:.0f}M, fp32): "
          f"{time.perf_counter() - t:.1f} s, first loss {first:.4f}, resumed from step "
          f"{resumed_from} for {len(llm_losses)} steps, last loss {llm_losses[-1]:.4f}, "
          f"launches {dict(dispatch.LAUNCHES)}")
    need(len(llm_losses) == LLM_STEPS - resumed_from and int(state["opt"]["step"]) == LLM_STEPS,
         "train_llm did not resume and finish")
    need(llm_losses[-1] < first - 0.1, f"train_llm loss {first} -> {llm_losses[-1]} did not descend")
    cfg = train_llm.CFG
    host = batch_at_step(cfg, SHAPES["train_4k"], SEED, 0, 4, 128)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    lg = train_loop.loss_and_grads_fn(cfg)
    l_full, g_full = lg(state["params"], batch)
    l_micro, g_micro = pipeline.microbatched(lg, 2)(state["params"], batch)
    worst = 0.0
    for a, b in zip(tree.leaves(g_full), tree.leaves(g_micro)):
        diff = (a.float() - b).abs()
        worst = max(worst, float((diff - 1e-3 * b.abs()).max()))
        need(bool((diff <= 1e-3 + 1e-3 * b.abs()).all()), "microbatched grads != full batch's")
    print(f"microbatches 2 vs 1 ({cfg.name}, fp32, B=4 x 128): loss {float(l_micro):.6f} vs "
          f"{float(l_full):.6f}, every gradient within rtol 1e-3 / atol 1e-3 (largest "
          f"|diff| - 1e-3 |full| = {worst:.3e})")
    del state, g_full, g_micro
    base = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--steps",
            "1", "--seed", str(SEED), "--log-every", "1"]
    for flag in (["--microbatches", "2"], ["--grad-compression"]):
        (st, losses, _), launches, wall, peak = _train_run(base + flag)
        need(len(losses) == 1 and math.isfinite(losses[0]), f"{flag}: loss {losses}")
        if flag[0] == "--grad-compression":
            need(all(bool(torch.isfinite(e).all()) for e in tree.leaves(st["grad_err"])),
                 "non-finite compression residual")
        print(f"train {TRAIN_ARCH} {' '.join(flag)}: 1 step, loss {losses[0]:.5f}, launches "
              f"{launches}, {wall:.1f} s, peak allocated {peak:.2f} GB")
        del st
    report["train_llm"] = dict(first=first, last=llm_losses[-1])


def _train_launches(report, kernel):
    return {a: r["launches_per_step"][kernel] for a, r in report["train"].items()
            if kernel in r["launches_per_step"]}


def training_phase(report):
    t0 = time.perf_counter()
    for part in (check_grad_functions, check_full_width_step, train_path_phase,
                 train_options_phase):
        t = time.perf_counter()
        part(report)
        print(f"training phase: {part.__name__} {time.perf_counter() - t:.1f} s")
    print(f"training phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: training on a data x model mesh (run_training(mesh=),
# launch/train.py --mesh), the model's explicit regions and the engine's
# ring decode; every rank a stream of the one card
# ---------------------------------------------------------------------------

MT_B, MT_S = 2, 2048  # the training phase's batch
MT_MOE = "phi3.5-moe-42b-a6.6b"
MT_MOE_LAYERS, MT_MOE_MESH, MT_MOE_STEPS = 2, {"data": 2, "model": 2}, 3
MT_MOE_WHY = ("~1.3 B parameters a layer: 2 layers are ~35 GB of parameters, gradients and "
              "fp32 moments on the one card, beside the gathered copy and the unsharded twin "
              "run before it; a layer's shapes, kernels and explicit regions do not change "
              "with depth")
# the crash and restart through launch/train.py --mesh 2x2: one layer, so
# its checkpoint (written gathered, read back and placed) is ~15 GB, not
# the 2-layer state's ~29 GB: the card machine's disk writes and reads a
# checkpoint at well under 1 GB/s
MT_CRASH_LAYERS, MT_CRASH_STEPS, MT_CRASH_AT = 1, 3, 1
MT_CRASH_WHY = ("the checkpoint holds the whole state (bf16 parameters, fp32 moments): ~29 GB at "
                "2 layers, ~15 GB at 1, written and read at the machine's disk rate")
MT_RWKV = "rwkv6-3b"
MT_RWKV_LAYERS, MT_RWKV_MESH, MT_RWKV_STEPS = 8, {"data": 1, "model": 4}, 2
MT_RWKV_WHY = "a layer's shapes, its scan launch and its two halo exchanges do not change with depth"
MT_ENGINE, MT_ENGINE_LAYERS, MT_RING = "occamy-gptj", 4, {"data": 4}
MT_ENGINE_BLOCKS_PER_SEQ = 36  # the multiple of 4 at or above serve()'s 33
MT_ENGINE_WHY = "ring decode's partials and merges are per layer; 4 of 28 layers hold them"
# meshed step vs its unsharded twin, each step's loss and global gradient
# norm: the forward is the same computation (the explicit regions are
# bitwise) and the norm sums the same squares in another order. Read on
# the card over four runs: every loss bitwise, grad norms within 3.3e-7
MT_LOSS_RTOL = MT_NORM_RTOL = 1e-5
# ... and the whole state after the twin steps, every rank's part of every
# leaf (replicas included) against the twin's: the worst leaf's relative
# Frobenius gap (``sharding.gap``) of the parameters, both moments and the
# step counter. The warm-up's learning rates (3e-6, 6e-6, 9e-6) move few
# bf16 parameters, so the fp32 moments carry what each rank's AdamW did.
# The gradients are bf16: the meshed step's per-rank slices sum their
# gradients in another order, which flips the rounding of a few elements
# (read on the card: 7.5e-5, phi3.5-moe's m). Two controls on one rank's
# part of one leaf must read past it: the part left as placed, and its
# last update undone
MT_STATE_GAP = 5e-4


def _mt_batch(cfg, step):
    import torch

    from repro_torch.configs.base import SHAPES
    from repro_torch.data.synthetic import batch_at_step

    host = batch_at_step(cfg, SHAPES["train_4k"], SEED, step, MT_B, MT_S)
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def _mt_steps(label, cfg, step_fn, state, steps, first=0):
    """``steps`` steps of ``step_fn`` on the training phase's stream (steps
    first..first+steps-1), each with the launch counts (and the MoE
    branch's per-rank calls) zeroed just before and read just after, its
    wall (host clock ended by a sync) and peak allocation. Returns (the
    per-step records, the state)."""
    import math

    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.models import moe

    rows = []
    for step in range(first, first + steps):
        batch = _mt_batch(cfg, step)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dispatch.reset_launches()
        moe.MESH_ROW_CALLS.clear()
        t = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss, norm = float(metrics["loss"]), float(metrics["grad_norm"])
        torch.cuda.synchronize()
        rows.append(dict(loss=loss, grad_norm=norm, wall_ms=(time.perf_counter() - t) * 1e3,
                         launches=dict(dispatch.LAUNCHES), rank_calls=dict(moe.MESH_ROW_CALLS),
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9))
        print(f"{label} step {step}: loss {loss:.6f} grad norm {norm:.6f} wall "
              f"{rows[-1]['wall_ms']:.1f} ms launches {rows[-1]['launches']} per-rank MoE calls "
              f"{rows[-1]['rank_calls']} peak allocated {rows[-1]['peak_gb']:.2f} GB")
        need(math.isfinite(loss) and math.isfinite(norm), f"{label}: non-finite step {step}")
    return rows, state


def _at(tree_, path):
    for k in path.split("/"):
        tree_ = tree_[k]
    return tree_


def _mt_state_gaps(label, state, twin, path, rank, controls):
    """Every leaf of the meshed ``state`` (params, opt.m, opt.v, opt.step;
    ``Placed``) against the unsharded ``twin`` (the same tree on the host)
    by ``sharding.gap``, the worst of each kind printed and held to
    MT_STATE_GAP; then each of ``controls`` ({name: rank ``rank``'s parts
    of the parameter and moments of leaf ``path``, by kind}) put in place
    of the current parts, each of whose readings must be past the bound.
    Returns (worst, {name: reading})."""
    from repro_torch.core import tree
    from repro_torch.parallel import sharding as sh

    t = time.perf_counter()
    paths, leaves = tree.flatten_with_paths(state)
    gaps = {p: sh.gap(x, _at(twin, p)) for p, x in zip(paths, leaves)}
    kinds = {}
    for p, g in gaps.items():
        kind = next(k for k in ("params", "opt/m", "opt/v", "opt/step") if p.startswith(k))
        if g >= kinds.get(kind, ("", -1.0))[1]:
            kinds[kind] = (p, g)
    worst = max(g for _, g in kinds.values())
    readings = {}
    for name, parts in controls.items():
        got = {}
        for kind, old in parts.items():
            leaf = _at(state, f"{kind}/{path}")
            now, leaf.parts[rank] = leaf.parts[rank], old
            got[kind] = sh.gap(leaf, _at(twin, f"{kind}/{path}"))
            leaf.parts[rank] = now
        readings[name] = max(got.values())
        print(f"{label} control, rank {rank}'s part of {path} {name}: "
              + ", ".join(f"{k} {g:.3e}" for k, g in got.items()))
    print(f"{label} state after the twin steps, mesh vs unsharded, worst leaf by kind "
          f"(relative Frobenius gap, every rank's part): "
          + ", ".join(f"{k} {p} {g:.3e}" for k, (p, g) in kinds.items())
          + f"; bound {MT_STATE_GAP:g}; controls "
          + ", ".join(f"{k} {g:.3e}" for k, g in readings.items())
          + f"; {len(gaps)} leaves compared in {time.perf_counter() - t:.1f} s")
    need(worst <= MT_STATE_GAP, f"{label}: the meshed state left the unsharded twin's")
    need(all(g > MT_STATE_GAP for g in readings.values()),
         f"{label}: the state check does not see a wrong rank update {readings}")
    return worst, readings


def _mt_sections(label, mode, cfg, mesh, state, batch):
    """Where a step's wall goes, each piece run once more after the timed
    steps and ended by a sync. Unsharded: the loss and gradients, the
    global norm, and AdamW (``apply_updates``, its own norm included). On
    the mesh: the parameters' gather; the loss and gradients under the
    activation specs (the explicit regions run per rank) and, on the same
    gathered parameters, without them; the gradients' split into parts;
    the norm over the owned parts (``mesh_grad_norm``); the per-rank AdamW
    (``mesh_apply_updates``). The updates advance the state one step."""
    import torch

    from repro_torch.core import tree
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import train_loop

    lg = train_loop.loss_and_grads_fn(cfg)
    ms = {}

    def timed(key, fn):
        gc.collect()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[key] = (time.perf_counter() - t) * 1e3
        return out

    with torch.no_grad():
        if mode == "mesh":
            act = sh.default_activation_specs(cfg, mesh, "train")
            params = timed("gather", lambda: tree.tree_map(lambda x: x.gather(),
                                                            state["params"]))

            def meshed():
                with torch.enable_grad(), sh.activation_sharding(act):
                    return lg(params, batch)

            _, grads = timed("loss+grads", meshed)
            with torch.enable_grad():
                timed("loss+grads without the activation specs", lambda: lg(params, batch))
            shardings = [x.sharding for x in tree.leaves(state["params"])]
            gs = timed("split", lambda: [sh.Placed.of(g, s)
                                         for g, s in zip(tree.leaves(grads), shardings)])
            del params, grads
            norm = timed("norm", lambda: train_loop.mesh_grad_norm(mesh, gs))
            timed("AdamW", lambda: train_loop.mesh_apply_updates(cfg, mesh, state, gs, norm))
            del gs
        else:
            with torch.enable_grad():
                _, grads = timed("loss+grads", lambda: lg(state["params"], batch))
            timed("norm", lambda: adamw.global_norm(grads))
            timed("AdamW", lambda: adamw.apply_updates(cfg, state["params"], grads,
                                                       state["opt"]))
            ms["AdamW"] -= ms["norm"]  # apply_updates takes its own norm first
            del grads
    print(f"{label} {mode} step sections (ms, each once more, ended by a sync): "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items()))
    return ms


def _mt_twins(report, label, cfg, mesh, steps, kernel):
    """The unsharded step and the meshed step from the same seeded state on
    the same batches: the placed parts against their specs, each step's
    loss and grad norm within MT_LOSS_RTOL / MT_NORM_RTOL, the whole state
    after the steps within MT_STATE_GAP with its control
    (``_mt_state_gaps``), ``kernel``'s launches a step equal, a warm
    profiled step of each and its sections (``_mt_sections``). Returns the
    meshed rows."""
    import math

    import torch

    from repro_torch.core import tree
    from repro_torch.parallel import sharding as sh
    from repro_torch.runtime import train_loop

    res = {}
    for mode in ("unsharded", "mesh"):
        gc.collect()
        torch.cuda.empty_cache()
        state = train_loop.init_train_state(cfg, SEED, device="cuda")
        if mode == "mesh":
            t = time.perf_counter()
            shardings = train_loop.state_shardings(cfg, state, mesh)
            sh.place_(state, shardings)
            torch.cuda.synchronize()
            placed = tree.leaves(state)
            for leaf in placed:
                want = leaf.sharding.shard_shape(leaf.shape)
                need(all(tuple(p.shape) == want for p in leaf.parts),
                     f"{label}: a part of {leaf} is not its spec's {want}")
            split = sum(1 for x in placed if any(e is not None for e in x.sharding.spec))
            gather_gb = sum(math.prod(x.shape) * x.parts[0].element_size()
                            for x in tree.leaves(state["params"])) / 1e9
            print(f"{label} mesh {mesh.shape}: {len(placed)} leaves placed in "
                  f"{time.perf_counter() - t:.2f} s, {split} of them split (the rest replicated), "
                  f"every part its spec's shard shape; the step gathers {gather_gb:.3f} GB of "
                  f"parameters and splits as many gradient bytes")
            step_fn = train_loop.make_mesh_train_step(cfg, mesh)
            # the controls' leaf: the last owner's part of the first split leaf
            paths, ps = tree.flatten_with_paths(state["params"])
            i = next(i for i, x in enumerate(ps) if any(e is not None for e in x.sharding.spec))
            rank = ps[i].owners[-1]

            def parts_now():
                return {k: _at(state, f"{k}/{paths[i]}").parts[rank].clone()
                        for k in ("params", "opt/m", "opt/v")}

            controls = {"left as placed": parts_now()}
            rows, state = _mt_steps(f"{label} {mode}", cfg, step_fn, state, steps - 1)
            controls["with its last update undone"] = parts_now()
            last, state = _mt_steps(f"{label} {mode}", cfg, step_fn, state, 1, first=steps - 1)
            rows += last
            gaps = _mt_state_gaps(label, state, twin, paths[i], rank, controls)
            del twin, controls
        else:
            step_fn = train_loop.make_train_step(cfg)
            rows, state = _mt_steps(f"{label} {mode}", cfg, step_fn, state, steps)
            t = time.perf_counter()
            twin = tree.tree_map(lambda x: x.to("cpu", copy=True), state)
            print(f"{label} unsharded state after {steps} steps copied to the host for the "
                  f"comparison: {sum(x.nbytes for x in tree.leaves(twin)) / 1e9:.2f} GB in "
                  f"{time.perf_counter() - t:.1f} s")
        b = _mt_batch(cfg, steps)
        name = f"mesh train {label} {mode} step B={MT_B} T={MT_S}"
        # the steps above warmed it: one timed wall, one span, one trace
        profile_fn(name, lambda: step_fn(state, b), report, walls=1, cpu=False, warm=True)
        res[mode] = dict(rows=rows, profile=report["profile"][name],
                         sections=_mt_sections(label, mode, cfg, mesh, state, b))
        if mode == "mesh":
            res[mode].update(gather_gb=gather_gb, state_gap=gaps[0], control_gap=gaps[1])
        del state, step_fn
    plain, meshed = res["unsharded"]["rows"], res["mesh"]["rows"]
    for i, (a, b) in enumerate(zip(plain, meshed)):
        rl = abs(b["loss"] - a["loss"]) / abs(a["loss"])
        rn = abs(b["grad_norm"] - a["grad_norm"]) / abs(a["grad_norm"])
        print(f"{label} step {i}: mesh vs unsharded loss {b['loss']:.6f} vs {a['loss']:.6f} "
              f"(rel {rl:.3e}, bitwise {b['loss'] == a['loss']}), grad norm {b['grad_norm']:.6f} "
              f"vs {a['grad_norm']:.6f} (rel {rn:.3e}); rtol {MT_LOSS_RTOL:g} each; {kernel} "
              f"launches {b['launches'].get(kernel)} vs {a['launches'].get(kernel)}")
        need(rl <= MT_LOSS_RTOL and rn <= MT_NORM_RTOL, f"{label} step {i}: mesh != unsharded")
        need(b["launches"].get(kernel, 0) == a["launches"].get(kernel, 0) == 2 * cfg.num_layers,
             f"{label} step {i}: {kernel} launches {b['launches']} vs {a['launches']}, "
             f"expected {2 * cfg.num_layers} (forward and recompute)")
    for mode, r in res.items():
        wall = sum(x["wall_ms"] for x in r["rows"][1:]) / max(len(r["rows"]) - 1, 1)
        p = r["profile"]
        print(f"time mesh train {label} {mode}: warm step wall {wall:.1f} ms (mean of steps 1..), "
              f"profiled step wall {p['wall_ms']:.1f} ms busy {p['busy_ms']:.1f} ms idle share "
              f"{p['idle_share']}, peak allocated {max(x['peak_gb'] for x in r['rows']):.2f} GB, "
              f"launches a step {r['rows'][-1]['launches']}"
              + (f", gathered {r['gather_gb']:.3f} GB a step" if mode == "mesh" else ""))
    report.setdefault("mesh_train", {})[label] = res
    return meshed


def mesh_train_moe(report):
    """(a) phi3.5-moe at MT_MOE_LAYERS layers on data2 x model2: the
    twins, the MoE branch's per-data-rank calls, then a crash and restart
    through ``launch/train.py --mesh 2x2`` (MT_CRASH_LAYERS layers)."""
    import shutil

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe, registry
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.mesh import DeviceMesh
    from repro_torch.runtime import checkpoint as ckpt

    full = get_config(MT_MOE)
    cfg = full.replace(num_layers=MT_MOE_LAYERS)
    mesh = DeviceMesh(MT_MOE_MESH)
    n_dp = mesh.shape["data"]
    print(f"mesh train {MT_MOE}: full width, depth cut to {MT_MOE_LAYERS} of {full.num_layers} "
          f"layers ({cfg.num_params():,} parameters): {MT_MOE_WHY}; {cfg.dtype} parameters, "
          f"{cfg.optimizer_dtype} AdamW, remat={cfg.remat}, B={MT_B} x S={MT_S}, mesh "
          f"{mesh.shape} on {len(set(mesh.devices))} card(s)")
    rows = _mt_twins(report, MT_MOE, cfg, mesh, MT_MOE_STEPS, "flash_attention")
    for i, r in enumerate(rows):
        # forward and remat recompute each dispatch once per data rank; the
        # recompute stops once the backward's saved tensors are back, so
        # its combines may stop short
        need(r["rank_calls"].get("dispatch") == 2 * n_dp * cfg.num_layers,
             f"step {i}: per-rank dispatches {r['rank_calls']} != 2 x {n_dp} x {cfg.num_layers}")
        need(r["rank_calls"].get("combine", 0) >= n_dp * cfg.num_layers,
             f"step {i}: per-rank combines {r['rank_calls']} < {n_dp} x {cfg.num_layers}")
    gc.collect()
    torch.cuda.empty_cache()
    params = registry.init_params(cfg, seed=SEED, device="cuda")
    batch = _mt_batch(cfg, 0)
    with torch.no_grad():
        want = registry.forward(params, cfg, batch)[0]
        moe.MESH_ROW_CALLS.clear()
        with sh.activation_sharding(sh.default_activation_specs(cfg, mesh, "train")):
            got = registry.forward(params, cfg, batch)[0]
        calls = dict(moe.MESH_ROW_CALLS)
    print(f"mesh forward {MT_MOE}: per-rank calls {calls} (expected {n_dp} x {cfg.num_layers} "
          f"each), logits bitwise the mesh-free forward's: {bool(torch.equal(got, want))}")
    need(calls == {"dispatch": n_dp * cfg.num_layers, "combine": n_dp * cfg.num_layers},
         f"mesh forward: per-rank calls {calls}")
    need(bool(torch.equal(got, want)), "the MoE mesh branch is not bitwise the mesh-free one")
    del params, batch, want, got
    gc.collect()
    torch.cuda.empty_cache()

    cut = (MT_MOE, MT_CRASH_LAYERS)
    base = ["--arch", MT_MOE, "--batch", str(MT_B), "--seq", str(MT_S), "--steps",
            str(MT_CRASH_STEPS), "--seed", str(SEED), "--log-every", "1", "--mesh", "2x2"]
    print(f"mesh train {MT_MOE} through launch/train.py --mesh 2x2: depth cut to "
          f"{MT_CRASH_LAYERS} layer: {MT_CRASH_WHY}")
    (state, straight, _), launches, wall, peak = _train_run(base, cut)
    nl = state["params"]["layers"]["wq"].shape[0]
    need(launches.get("flash_attention") == 2 * nl * MT_CRASH_STEPS,
         f"straight --mesh run: launches {launches}, expected 2 x {nl} x {MT_CRASH_STEPS}")
    print(f"mesh train {MT_MOE} straight --mesh run: {MT_CRASH_STEPS} steps in {wall:.1f} s (init "
          f"included), losses {straight}, launches {launches}, peak allocated {peak:.2f} GB")
    need(isinstance(state["params"]["embed"], torch.Tensor),
         "the meshed run did not return the gathered state")
    del state
    ckdir = TRAIN_CKPT_DIR.parent / "mesh_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    ck = ["--ckpt-dir", str(ckdir)]
    code, _, wall_c, _ = _train_run(base + ck + ["--ckpt-every", "1", "--inject-crash-at",
                                                 str(MT_CRASH_AT)], cut)
    need(code == 42 and ckpt.latest_step(str(ckdir)) == MT_CRASH_AT,
         f"crashed --mesh run: exit {code}, checkpoint {ckpt.latest_step(str(ckdir))}")
    size = sum(f.stat().st_size for f in ckdir.rglob("*") if f.is_file()) / 1e9
    print(f"mesh train {MT_MOE} crashed --mesh run: exit 42 at step {MT_CRASH_AT} after "
          f"{wall_c:.1f} s, checkpoint step {MT_CRASH_AT} ({size:.2f} GB, gathered leaves)")
    (state, resumed, _), launches_r, wall_r, peak_r = _train_run(
        base + ck + ["--ckpt-every", str(MT_CRASH_STEPS + 1)], cut)
    rel = abs(resumed[-1] - straight[-1]) / abs(straight[-1])
    print(f"mesh train {MT_MOE} resumed --mesh run: from step {MT_CRASH_AT}, {len(resumed)} steps "
          f"in {wall_r:.1f} s (restore and placement included), opt.step "
          f"{int(state['opt']['step'])}, final loss {resumed[-1]:.6f} vs straight "
          f"{straight[-1]:.6f} (rel {rel:.3e}, rtol {TRAIN_RESUME_RTOL:g}), peak allocated "
          f"{peak_r:.2f} GB")
    need(len(resumed) == MT_CRASH_STEPS - MT_CRASH_AT
         and int(state["opt"]["step"]) == MT_CRASH_STEPS, "the --mesh restart did not finish")
    need(rel <= TRAIN_RESUME_RTOL, "the resumed --mesh run's final loss is not the straight run's")
    shutil.rmtree(ckdir, ignore_errors=True)
    report["mesh_train_crash"] = dict(straight=straight, resumed=resumed, rel=rel,
                                      ckpt_gb=size, crash_s=wall_c, resume_s=wall_r)
    del state


def mesh_train_rwkv(report):
    """(b) rwkv6-3b at MT_RWKV_LAYERS layers with the halo shift on data1 x
    model4: the forward's logits bitwise with and without the halo on the
    mesh and unsharded, then the twins."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import registry
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.mesh import DeviceMesh

    full = get_config(MT_RWKV)
    cfg = full.replace(num_layers=MT_RWKV_LAYERS, halo_shift=True)
    mesh = DeviceMesh(MT_RWKV_MESH)
    print(f"mesh train {MT_RWKV}: full width, depth cut to {MT_RWKV_LAYERS} of {full.num_layers} "
          f"layers ({cfg.num_params():,} parameters): {MT_RWKV_WHY}; halo_shift, mesh "
          f"{mesh.shape}, B={MT_B} x S={MT_S}")
    params = registry.init_params(cfg, seed=SEED, device="cuda")
    batch = _mt_batch(cfg, 0)
    outs = {}
    with torch.no_grad():
        outs["unsharded"] = registry.forward(params, cfg, batch)[0]
        for halo in (False, True):
            c = cfg.replace(halo_shift=halo)
            with sh.activation_sharding(sh.default_activation_specs(c, mesh, "train")):
                outs[f"mesh halo={halo}"] = registry.forward(params, c, batch)[0]
    torch.cuda.synchronize()
    same = {k: bool(torch.equal(v, outs["unsharded"])) for k, v in outs.items()}
    print(f"mesh forward {MT_RWKV}: logits bitwise the unsharded forward's: {same}")
    need(all(same.values()), f"{MT_RWKV}: the meshed forwards are not bitwise the unsharded one")
    del params, batch, outs
    _mt_twins(report, MT_RWKV, cfg, mesh, MT_RWKV_STEPS, "linear_attention")


def mesh_train_engine(report):
    """(c) the engine's ring decode over {"data": 4}: occamy-gptj at
    MT_ENGINE_LAYERS layers, fp32, serve()'s requests, slots and pool,
    tables of MT_ENGINE_BLOCKS_PER_SEQ; token streams equal to the
    unsharded engine's at the same depth and pool; 4 decode-attention
    partials a layer a decode step."""
    import math

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import transformer
    from repro_torch.parallel.mesh import DeviceMesh
    from repro_torch.serving import ring_decode
    from repro_torch.serving.engine import ServingEngine

    full = get_config(MT_ENGINE)
    cfg = full.replace(num_layers=MT_ENGINE_LAYERS, dtype="float32")
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    reqs = make_requests(cfg.vocab_size)
    print(f"ring engine {MT_ENGINE}: full width, fp32, depth cut to {MT_ENGINE_LAYERS} of "
          f"{full.num_layers} layers: {MT_ENGINE_WHY}; {len(reqs)} requests, {SLOTS} slots, "
          f"{NUM_BLOCKS} blocks of {BLOCK_SIZE}, tables of {MT_ENGINE_BLOCKS_PER_SEQ}")
    counts = {"ring_decode": 0, "partials": 0}
    real_ring, real_part = ring_decode.ring_decode, ring_decode._shard_partial

    def ring(*a, **k):
        counts["ring_decode"] += 1
        return real_ring(*a, **k)

    def part(*a, **k):
        counts["partials"] += 1
        return real_part(*a, **k)

    runs = {}
    for label, mesh in (("unsharded", None), ("ring", DeviceMesh(MT_RING))):
        engine = ServingEngine.with_model(
            cfg, params, num_blocks=NUM_BLOCKS, block_size=BLOCK_SIZE, max_slots=SLOTS,
            max_blocks_per_seq=MT_ENGINE_BLOCKS_PER_SEQ, device="cuda", mesh=mesh)
        ring_decode.ring_decode, ring_decode._shard_partial = ring, part
        try:
            runs[label] = _drive(engine, reqs)
        finally:
            ring_decode.ring_decode, ring_decode._shard_partial = real_ring, real_part
        r = runs[label]
        r["counts"] = dict(counts)
        steps = len(r["decode_ms"])
        print(f"ring engine {label}: completed {len(r['out'])}/{len(reqs)}, preemptions "
              f"{r['preempts']}, prefills {r['prefills']}, {steps} decode steps, leaked "
              f"{engine.leaked_blocks()}, wall {r['wall']:.3f} s, launches {r['launches']}, "
              f"decode attention {counts}")
        need(len(r["out"]) == len(reqs) and engine.leaked_blocks() == 0,
             f"ring engine {label}: incomplete or leaking")
        n = MT_RING["data"] if mesh is not None else 0
        need(counts["ring_decode"] == (cfg.num_layers * steps if mesh is not None else 0)
             and counts["partials"] == n * counts["ring_decode"],
             f"ring engine {label}: decode attention {counts}, expected {n} partials a layer "
             f"over {cfg.num_layers} layers x {steps} steps")
        counts.update(ring_decode=0, partials=0)
        if mesh is not None:
            # ring_attn_fn's per-call page gather: every slot's table of
            # pages (null ones included) copied into a new pool, which
            # ring_decode then copies again into the ranks' shards
            cache = engine.model.cache
            page = math.prod(cache.k_pool.shape[2:]) * cache.k_pool.element_size()
            pages = SLOTS * MT_ENGINE_BLOCKS_PER_SEQ
            made = 2 * pages * page  # k and v
            r["gather"] = dict(pages=pages, pool_pages=cache.num_blocks, made_mib=made / 2**20,
                               moved_mib=4 * made / 2**20,
                               run_gib=4 * made * cfg.num_layers * steps / 2**30)
            print(f"ring engine gather: each layer-step copies {pages} pages ({SLOTS} slots x "
                  f"{MT_ENGINE_BLOCKS_PER_SEQ}) against a pool of {cache.num_blocks}: "
                  f"{made / 2**20:.1f} MiB made twice (the gathered pool, then its shards), "
                  f"{4 * made / 2**20:.1f} MiB read and written a layer-step, "
                  f"{r['gather']['run_gib']:.2f} GiB over the run's {steps} decode steps")
        del engine
    same = runs["ring"]["out"] == runs["unsharded"]["out"]
    print(f"ring engine: token streams equal to the unsharded engine's: {same}")
    need(same, "ring engine: token streams differ from the unsharded engine's")
    for label, r in runs.items():
        step_ms, tok_s = _decode_rate(r)
        print(f"time ring engine {label}: decode {step_ms:.2f} ms/step, {tok_s:.1f} tok/s "
              f"(first step excluded), run wall {r['wall']:.3f} s")
        runs[label]["step_ms"] = step_ms
    report["ring_engine"] = {k: dict(step_ms=v["step_ms"], wall=v["wall"], counts=v["counts"],
                                     gather=v.get("gather")) for k, v in runs.items()}
    del params


def mesh_train_phase(report):
    import torch

    t0 = time.perf_counter()
    for part in (mesh_train_moe, mesh_train_rwkv, mesh_train_engine):
        t = time.perf_counter()
        part(report)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"mesh training phase: {part.__name__} {time.perf_counter() - t:.1f} s")
    print(f"mesh training phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 16: the card's roofline (core/topology.py, launch/roofline.py, the
# op cases and their cells), the expert-parallel FFN, the elastic re-mesh,
# the production mesh and the bench twins' roofline columns
# ---------------------------------------------------------------------------

# each op case's kernel (its ``dispatch.LAUNCHES`` name); decode attention
# has none (its blocked form is plain tensor code, as the reference's)
OP_KERNELS = {"gemm": "gemm", "flash_attention": "flash_attention", "decode_attention": None,
              "linear_attention": "linear_attention", "spmm": "spmm", "bsr_spmm": "bsr_spmm",
              "spmspm": "spmspm", "stencil": "stencil"}
# an op may not run faster than its bound by more than the timing's noise,
# taken as 5 % of the bound plus 1 us (a CUDA event's resolution is ~0.5 us)
ROOFLINE_NOISE_REL, ROOFLINE_NOISE_MS = 0.05, 1e-3
OP_COLD_REPS = 5  # single calls, each after the L2 is flushed
OP_FLUSH_BYTES = 256 << 20  # written before each cold call: five times the 50 MB L2
# (c) the expert-parallel FFN at phi3.5-moe's width: a prefill dispatch of
# EP_B rows of EP_S tokens through layer 0's router, on each mesh
EP_B, EP_S = 4, 2048
EP_MESHES = (("data2xmodel2", {"data": 2, "model": 2}), ("data1xmodel4", {"data": 1, "model": 4}))


def _op_case_inputs(op, args, kw, gen):
    """The case's operands on the card, at its shapes and dtypes: unit
    normals; indices in range (ELL columns over the dense rows, BSR tiles
    sorted by row over the tile grid, SpMSpM columns over the contraction
    dim); the scan's log decays in [-1, -0.01]; decode at the cache's last
    position (the whole cache read). The case counts every (q, k) pair
    (4 B H Sq^2 D), so flash attention runs non-causal: the causal
    default does half that work."""
    import torch

    def normal(a):
        x = torch.randn(tuple(a.shape), generator=gen, device="cuda", dtype=torch.float32)
        return x.to(a.dtype)

    def ints(a, high):
        return torch.randint(0, high, tuple(a.shape), generator=gen, device="cuda",
                             dtype=torch.int32)

    if op == "decode_attention":
        q, k, v, pos = args
        return (normal(q), normal(k), normal(v),
                torch.full(tuple(pos.shape), k.shape[2] - 1, dtype=torch.int32, device="cuda")), kw
    if op == "flash_attention":
        return tuple(normal(a) for a in args), dict(kw, causal=False)
    if op == "linear_attention":
        r, k, v, w = args
        w_log = -(torch.rand(tuple(w.shape), generator=gen, device="cuda") * 0.99 + 0.01)
        return (normal(r), normal(k), normal(v), w_log), kw
    if op == "spmm":
        values, cols, dense = args
        return (normal(values), ints(cols, dense.shape[0]), normal(dense)), kw
    if op == "bsr_spmm":
        tv, tr, tc, dense = args
        rows = torch.sort(ints(tr, kw["num_rows"] // tv.shape[1])).values
        return (normal(tv), rows, ints(tc, dense.shape[0] // tv.shape[2]), normal(dense)), kw
    if op == "spmspm":
        av, ac, bv, br = args
        k_dim = kw["contraction_dim"]
        return (normal(av), ints(ac, k_dim), normal(bv), ints(br, k_dim)), kw
    return tuple(normal(a) for a in args), kw  # gemm, stencil


def _cold_ms(fn, flush, reps=OP_COLD_REPS):
    """Per-call device ms of ``fn`` over ``reps`` single calls, each after
    ``flush`` is written (the L2 holds none of the call's inputs), by CUDA
    events around the call alone."""
    import torch

    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sorted(s.elapsed_time(e) for s, e in pairs)


def _op_case_hold(op, call, out, args, kw):
    """The kernel's output at the case's shapes against its plain version
    (impl ``torch``) at the suite's tolerances; flash attention against
    SDPA (its plain form at Sq = 32768 would take minutes); decode
    attention, which launches no kernel, finite. Returns max|diff|."""
    import torch
    import torch.nn.functional as F

    if op == "decode_attention":
        need(bool(torch.isfinite(out.float()).all()), "op case decode_attention: non-finite")
        return 0.0
    if op == "flash_attention":
        want = F.scaled_dot_product_attention(*args, is_causal=False)
        rel = _frob(out, want)
        print(f"op case flash_attention: ||kernel - SDPA|| / ||SDPA|| {rel:.3e} (tol "
              f"{RING_BF16_REL:g})")
        need(rel <= RING_BF16_REL, "op case flash_attention: off SDPA")
        return float((out.float() - want.float()).abs().max())
    with torch.no_grad():
        want = call(impl="torch")
    if op == "linear_attention":
        return _hold_rel("linear_attention", "op case", out[0], want[0], LA_REL_TOL)
    tol = {"gemm": GEMM_TOL["bfloat16"], "spmm": SPMM_TOL["float32"], "bsr_spmm": SPARSE_TOL,
           "spmspm": SPARSE_TOL, "stencil": STENCIL_TOL}[op]
    return _hold(op, "op case", out, want, tol)


def op_case_phase(report):
    """(a) every op-roofline cell, (b) each op case on the card against its
    bound."""
    import functools

    import torch

    from repro_torch.core import precision as prec
    from repro_torch.hopper import dispatch, ops
    from repro_torch.launch import op_cases, roofline, shape_run

    for multi_pod in (False, True):
        for pol in (None, "fp32", "bf16", "fp8", "fp8_e5m2"):
            for c in shape_run.op_roofline_cells(multi_pod, pol):
                r = c["roofline"]
                per = ", ".join(f"{a} {s * 1e6:.3f} us" for a, s in
                                c["collective_s_per_level"].items()) or "none"
                ov = (f"; overlapped {c['overlap']['overlapped_s'] * 1e6:.3f} us of serial "
                      f"{c['overlap']['serial_s'] * 1e6:.3f} us" if "overlap" in c else "")
                print(f"op roofline [{c['mesh']} {pol}] {c['op']}: {c['partition']}; dominant "
                      f"{r['dominant']} (compute {r['compute_s'] * 1e6:.3f} us, memory "
                      f"{r['memory_s'] * 1e6:.3f} us, d2d {r.get('d2d_s', 0.0) * 1e6:.3f} us); "
                      f"per level {per}{ov}")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(OP_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    cases = op_cases.op_roofline_cases()
    inputs = {op: _op_case_inputs(op, args, kw, gen) for op, args, kw, _, _ in cases}
    calls = {op: functools.partial(getattr(ops, op), *a, **kw) for op, (a, kw) in inputs.items()}
    torch.cuda.synchronize()
    dispatch.reset_launches()
    with torch.no_grad():
        outs = {op: call() for op, call in calls.items()}
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    print(f"op cases: one call each, launches {launches}")
    for op, kernel in OP_KERNELS.items():
        need(kernel is None or launches.get(kernel, 0) >= 1,
             f"op case {op}: no {kernel} launch ({launches})")
    report["op_roofline_launches"] = launches
    rows = {}
    for op, args, kw, flops, nbytes in cases:
        real, kwr = inputs[op]
        err = _op_case_hold(op, calls[op], outs[op], real, kwr)
        dtype = args[0].dtype
        cell = roofline.roofline_terms(flops, nbytes, 0.0)  # the cell at n = 1
        cell_ms = max(cell["compute_s"], cell["memory_s"]) * 1e3
        bound, by = bound_ms(nbytes, flops, dtype)
        with torch.no_grad():
            warm = time_ms(calls[op], iters=5 if flops > 1e12 else 20)
            cold = _cold_ms(calls[op], flush)
        med = cold[len(cold) // 2]
        rows[op] = dict(shape=[list(a.shape) for a in args], dtype=str(dtype), flops=flops,
                        bytes=nbytes, ms=med, cold_ms=cold, warm_ms=warm, bound_ms=bound,
                        bound_by=by, cell_bound_ms=cell_ms, cell_dominant=cell["dominant"],
                        share=bound / med, max_abs_err=err)
        print(f"time op case {op} {rows[op]['shape']} {dtype}: cold {med:.5f} ms (median of "
              f"{OP_COLD_REPS}, range {cold[0]:.5f}-{cold[-1]:.5f}), warm {warm:.5f} ms; bound "
              f"{bound:.5f} ms ({by}, {dtype} peak {prec.peak_flops_of(dtype):.4g} FLOP/s, "
              f"{roofline.HBM_BW:.4g} B/s), share of the bound {bound / med:.4f}; the cell's "
              f"bound at n = 1 {cell_ms:.5f} ms ({cell['dominant']}, bf16 peak)")
        need(med >= bound * (1 - ROOFLINE_NOISE_REL) - ROOFLINE_NOISE_MS,
             f"op case {op}: {med:.5f} ms beats its bound {bound:.5f} ms: a wrong constant or count")
    report["op_roofline"] = rows
    del inputs, calls, outs, flush


def production_mesh_phase(report):
    """(e) every op case's plan on ``make_production_mesh(multi_pod=True)``
    (512 ranks on the card's streams) and on its ``MeshSpec``."""
    from repro_torch.hopper import partition
    from repro_torch.launch import op_cases
    from repro_torch.launch.mesh import make_production_mesh, production_mesh_spec

    spec = production_mesh_spec(True)
    mesh = make_production_mesh(True)
    need(mesh.shape == spec.shape == {"pod": 2, "data": 16, "model": 16},
         f"production mesh {mesh.shape} / {spec.shape}")
    for op, args, kw, _, _ in op_cases.op_roofline_cases():
        plan = partition.plan_for(op, spec, *args, **kw)
        twin = partition.plan_for(op, mesh, *args, **kw)
        need(plan is not None and twin is not None and plan.levels == twin.levels
             and plan.note == twin.note, f"production mesh: {op} does not resolve")
        print(f"production mesh {spec.shape}: {op} -> {plan.note} (levels {plan.levels})")


def ep_phase(report):
    """(c) ``ep_expert_ffn`` at phi3.5-moe's full width against the TP
    path's three einsums (``models/moe.py``) on the same dispatch."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe, registry
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.collectives import ep_expert_ffn
    from repro_torch.parallel.mesh import DeviceMesh

    cfg = get_config(MT_MOE).replace(num_layers=1)
    params = registry.init_params(cfg, seed=SEED, device="cuda")
    p = {k: v[0] for k, v in params["layers"].items()}
    del params
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(EP_B, EP_S, cfg.d_model, generator=gen, device="cuda").to(
        getattr(torch, cfg.dtype))
    act = L.activation_fn(cfg.activation)
    E, C = cfg.num_experts, moe.capacity(cfg, EP_S)
    with torch.no_grad():
        _, topi, _ = moe._route(p, x, cfg)
        disp = moe._dispatch(x, topi, E, C)[0]
        wi, wg, wo = p["moe_wi"], p["moe_wg"], p["moe_wo"]

        def tp():  # models/moe.py's einsums (h_dt fp32: tp_reduce_bf16 off)
            h = torch.einsum("becd,edf->becf", disp, wi)
            g = torch.einsum("becd,edf->becf", disp, wg)
            h = act(g.float()).to(torch.float32) * h.to(torch.float32)
            return torch.einsum("becf,efd->becd", h.to(disp.dtype), wo)

        want = tp()
    print(f"ep_expert_ffn {MT_MOE}: full width (d {cfg.d_model}, f {cfg.d_ff}, E {E}), layer 0's "
          f"router over {EP_B} x {EP_S} tokens, disp {tuple(disp.shape)} {disp.dtype} "
          f"(capacity {C})")
    profile_fn("ep tp einsums", tp, report, walls=3)
    res = {"tp_wall_ms": report["profile"]["ep tp einsums"]["wall_ms"]}
    for mname, shape in EP_MESHES:
        mesh = DeviceMesh(shape)
        ns = sh.NamedSharding(mesh, sh.P("model", None, None))
        placed = [sh.Placed.of(w, ns) for w in (wi, wg, wo)]

        def ep(mesh=mesh, placed=placed):
            return ep_expert_ffn(disp, *placed, act, mesh, "data")

        with torch.no_grad():
            got = ep()
            err = _hold_mesh_bf16(f"ep_expert_ffn {mname} vs the TP einsums", got, want)
            name = f"ep_expert_ffn {mname}"
            profile_fn(name, ep, report, walls=3)
        ep_n, n = mesh.shape["model"], mesh.n
        part = disp.numel() // mesh.shape["data"] * disp.element_size()
        off_rank = 2 * n * part * (ep_n - 1) // ep_n
        prof = report["profile"][name]
        print(f"ep_expert_ffn {mname}: wall {prof['wall_ms']:.3f} ms, busy {prof['busy_ms']:.3f} ms, "
              f"idle share {prof['idle_share']}; exchanged {off_rank / 1e9:.4f} GB between ranks "
              f"in two all-to-alls ({2 * n * part / 1e9:.4f} GB copied with each rank's own slab); "
              f"TP einsums {res['tp_wall_ms']:.3f} ms")
        res[mname] = dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                          idle_share=prof["idle_share"], exchanged_gb=off_rank / 1e9,
                          max_abs_err=err)
        del placed, got, mesh
    report["ep"] = res


def elastic_phase(report):
    """(d) phi3.5-moe at MT_MOE_LAYERS layers: the state placed on data2 x
    model2, one data row lost (``elastic_remesh(2, 2, lost_ranks=1)``) and
    the state resharded onto data1 x model2 (``reshard_state``): every old
    part bitwise its slab of the new gathered leaf, every new part its
    spec's shard shape; one meshed step there against the unsharded step's
    loss from the same seeded state on the same batch."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core import tree
    from repro_torch.parallel import sharding as sh
    from repro_torch.parallel.mesh import DeviceMesh
    from repro_torch.runtime import fault_tolerance as ft
    from repro_torch.runtime import train_loop

    cfg = get_config(MT_MOE).replace(num_layers=MT_MOE_LAYERS)
    batch = _mt_batch(cfg, 0)
    state = train_loop.init_train_state(cfg, SEED, device="cuda")
    state, metrics = train_loop.make_train_step(cfg)(state, batch)
    loss_u = float(metrics["loss"])
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    state = train_loop.init_train_state(cfg, SEED, device="cuda")
    m22 = DeviceMesh(MT_MOE_MESH)
    sh.place_(state, train_loop.state_shardings(cfg, state, m22))
    m12, new_dp = ft.elastic_remesh(m22.shape["data"], m22.shape["model"], lost_ranks=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    new = ft.reshard_state(state, cfg, m12)
    torch.cuda.synchronize()
    t_reshard = time.perf_counter() - t
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    paths, old_leaves = tree.flatten_with_paths(state)
    for path, old, leaf in zip(paths, old_leaves, tree.leaves(new)):
        need(leaf.sharding.mesh is m12 and all(
            tuple(q.shape) == leaf.sharding.shard_shape(leaf.shape) for q in leaf.parts),
            f"elastic: {path} parts not of its spec's shard shape")
        full = leaf.gather()
        for r, part in enumerate(old.parts):
            need(bool(torch.equal(part, m22.local(full, old.sharding.spec, r))),
                 f"elastic: {path} rank {r} of the old mesh differs from the resharded leaf")
        del full
    t_check = time.perf_counter() - t
    n_leaves = len(old_leaves)
    del state, old_leaves
    gc.collect()
    torch.cuda.empty_cache()
    new, metrics = train_loop.make_mesh_train_step(cfg, m12)(new, batch)
    loss_m = float(metrics["loss"])
    rel = abs(loss_m - loss_u) / abs(loss_u)
    print(f"elastic {MT_MOE} ({MT_MOE_LAYERS} layers): {n_leaves} leaves resharded from "
          f"{m22.shape} onto {m12.shape} (new_dp {new_dp}) in {t_reshard:.2f} s, peak allocated "
          f"{peak_gb:.2f} GB; every old part bitwise its slab of the new leaf (checked in "
          f"{t_check:.2f} s); a meshed step on {m12.shape}: loss {loss_m:.6f} vs the unsharded "
          f"step's {loss_u:.6f} (rel {rel:.3e}, bitwise {loss_m == loss_u}, rtol {MT_LOSS_RTOL:g})")
    need(rel <= MT_LOSS_RTOL, "elastic: the resharded step's loss is not the unsharded step's")
    report["elastic"] = dict(loss=loss_m, unsharded_loss=loss_u, rel=rel, reshard_s=t_reshard,
                             leaves=n_leaves)
    del new, metrics


def bench_columns_phase(report):
    """(f) the mesh rows' roofline columns (phase 13's run) and the D2D
    rows, the pod all-reduce measured over 4 ranks."""
    from repro_torch.launch import d2d_rows
    from repro_torch.parallel.mesh import DeviceMesh

    for r in report["mesh_bench_rows"]:
        need("d2d_model_s" in r and ("model_overlapped_s" in r if r["overlap"] else
                                     "coll_per_level_s" in r), f"mesh_rows {r['name']}: {r}")
        extra = (f"model overlapped {r['model_overlapped_s'] * 1e6:.1f} us" if r["overlap"]
                 else f"per level {r['coll_per_level_s']}")
        print(f"mesh row {r['name']}: {r['us_per_call']:.1f} us, d2d model "
              f"{r['d2d_model_s'] * 1e6:.2f} us, {extra}")
    rows = d2d_rows.run(DeviceMesh({"pod": 4}, devices=_mesh_devices(4))).json_rows
    need(sum(r["name"].startswith("fig13b_pod_allreduce") for r in rows) == 3,
         "d2d rows: no measured all-reduce rows")
    report["d2d_rows"] = rows


def roofline_phase(report):
    import torch

    t0 = time.perf_counter()
    print(f"roofline phase: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated at its start")
    for part in (op_case_phase, ep_phase, elastic_phase, production_mesh_phase,
                 bench_columns_phase):
        t = time.perf_counter()
        part(report)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"roofline phase: {part.__name__} {time.perf_counter() - t:.1f} s")
    print(f"roofline phase: {time.perf_counter() - t0:.1f} s")


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


# ---------------------------------------------------------------------------
# phase 17: the dry run without XLA (launch/step_count.py, shape_run's
# count_cell, shape_report, shape_climb, op_doc)
# ---------------------------------------------------------------------------

# (b) the two grounding cells, cut to one card: (arch, kind, B, S, layers)
DRYRUN_GROUND = (("occamy-gptj", "prefill", 1, 4096, 4), ("gemma-2b", "train", 1, 2048, None))
DRYRUN_ARG_REL = DRYRUN_FLOP_REL = 1e-2
DRYRUN_CLIMB = ("phi3.5-moe-42b-a6.6b", "prefill_32k", {"tp_reduce_bf16": True})


def dryrun_table_phase(report):
    """(a) every config x shape on the 16 x 16 mesh, device-free."""
    import torch

    from repro_torch.configs.base import SHAPES, all_arch_ids
    from repro_torch.core import topology
    from repro_torch.launch import shape_report
    from repro_torch.launch.shape_run import count_cell

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dry run: topology.HBM_BYTES {topology.HBM_BYTES:.4g} B, the card's total_memory "
          f"{total} B")
    need(topology.HBM_BYTES <= total <= 1.1 * topology.HBM_BYTES,
         f"dry run: the card holds {total} B, HBM_BYTES says {topology.HBM_BYTES:.4g}")
    rows = {}
    for arch in all_arch_ids():
        for shape in SHAPES:
            try:
                r = count_cell(arch, shape, False)
            except Exception as e:  # a failure here is a fault of the port
                r = {"arch": arch, "shape": shape, "mesh": "16x16",
                     "error": f"{type(e).__name__}: {e}"}
            rows[(arch, shape, "16x16")] = r
            need("error" not in r, f"dry run {arch} {shape}: {r.get('error')}")
            if "skipped" in r:
                print(f"dry run {arch} {shape} 16x16: skipped ({r['skipped']})")
                continue
            t = r["roofline"]
            print(f"dry run {arch} {shape} 16x16: {r['memory']['total_per_device'] / 1e9:.2f} "
                  f"GB/device, fits {r['fits']}, {r['flops_per_device']:.4g} FLOPs/device, "
                  f"{t['dominant']}, roofline fraction {t['roofline_fraction']:.3f}, useful "
                  f"FLOPs {r['useful_flops_ratio']:.3f}, count {r['count_s']} s")
    print(shape_report.roofline_table(rows))
    report["dryrun_cells"] = rows


def _ground_cell(report, arch, kind, B, S, layers):
    """(b) one cell counted on a 1 x 1 mesh and run on the card."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeSpec, get_config
    from repro_torch.hopper import dispatch
    from repro_torch.hopper.partition import MeshSpec
    from repro_torch.launch import roofline, step_count
    from repro_torch.models import registry
    from repro_torch.runtime import train_loop

    cfg = get_config(arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    shape = ShapeSpec(f"{kind}_{S}", kind, S, B)
    label = f"dry run ground {arch} {kind} B={B} S={S} L={cfg.num_layers}"
    c = step_count.count_step(cfg, shape, MeshSpec({"data": 1, "model": 1}))
    mem = c["memory"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    if kind == "train":
        state = train_loop.init_train_state(cfg, seed=0, device="cuda")
    else:
        params = registry.init_params(cfg, seed=0, device="cuda")
    batch = registry.make_batch(cfg, shape, device="cuda")
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - m0
    arg_rel = abs(grown - mem["argument_size_in_bytes"]) / mem["argument_size_in_bytes"]
    print(f"{label}: argument bytes counted {mem['argument_size_in_bytes']}, "
          f"memory_allocated grew {grown} (rel {arg_rel:.2e})")
    need(arg_rel <= DRYRUN_ARG_REL, f"{label}: argument bytes off by {arg_rel:.3g}")
    if kind == "train":
        step = train_loop.make_train_step(cfg)

        def run():
            return step(state, batch)
    else:
        step = train_loop.make_prefill_step(cfg)

        def run():
            return step(params, batch)
    run()  # warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dispatch.reset_launches()
    with FlopCounterMode(display=False) as fc:
        out = run()
    torch.cuda.synchronize()
    launches = dict(dispatch.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - base
    del out
    aten = fc.get_total_flops()
    flop_rel = abs(aten - c["matmul_flops"]) / max(aten, 1)
    print(f"{label}: aten matmul FLOPs counted {c['matmul_flops']:.6g}, FlopCounterMode "
          f"{aten:.6g} (rel {flop_rel:.2e}); kernel ops by formula {c['kernel_flops']}; "
          f"launches {launches}")
    need(flop_rel <= DRYRUN_FLOP_REL, f"{label}: matmul FLOPs off by {flop_rel:.3g}")
    need(launches.get("flash_attention", 0) >= cfg.num_layers,
         f"{label}: the FA kernel launched {launches} in the counted step")
    print(f"{label}: temp bytes counted {mem['temp_size_in_bytes']}, the step's peak above "
          f"its arguments {peak} (counted / measured "
          f"{mem['temp_size_in_bytes'] / max(peak, 1):.3f})")
    ms = time_ms(run, iters=3)
    terms = roofline.roofline_terms(c["flops"], c["hbm_bytes"], 0.0)
    bound = max(terms["compute_s"], terms["memory_s"]) * 1e3
    print(f"{label}: warm step {ms:.3f} ms, the count's bound {bound:.3f} ms "
          f"({terms['dominant']}; FLOPs {c['flops']:.4g}, HBM bytes {c['hbm_bytes']:.4g}), "
          f"share {bound / ms:.3f}")
    need(ms >= bound * (1 - ROOFLINE_NOISE_REL) - ROOFLINE_NOISE_MS,
         f"{label}: {ms:.3f} ms beats its bound {bound:.3f} ms")
    report.setdefault("dryrun_ground", {})[label] = {
        "argument_bytes": mem["argument_size_in_bytes"], "allocated_growth": grown,
        "matmul_flops": c["matmul_flops"], "flop_counter": aten,
        "temp_bytes": mem["temp_size_in_bytes"], "peak_bytes": peak,
        "ms": ms, "bound_ms": bound, "launches": launches}
    counts = report.setdefault("dryrun_launches", {})
    for name, n in launches.items():
        counts[name] = counts.get(name, 0) + n


def dryrun_phase(report):
    import torch

    from repro_torch.launch import op_doc, shape_climb

    t0 = time.perf_counter()
    dryrun_table_phase(report)
    print(f"dry run: the 16 x 16 table in {time.perf_counter() - t0:.1f} s")
    for row in DRYRUN_GROUND:
        t = time.perf_counter()
        _ground_cell(report, *row)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"dry run: {row[0]} {row[1]} grounded in {time.perf_counter() - t:.1f} s")
    arch, shape, over = DRYRUN_CLIMB
    r = shape_climb.climb(arch, shape, over)
    print(f"dry run climb {arch} {shape} {over}: deltas "
          + ", ".join(f"{k} {v:+.4g}" for k, v in r["deltas"].items()))
    need(r["deltas"]["hbm_bytes_per_device"] < 0,
         f"dry run climb: {over} did not lower {arch} {shape}'s HBM bytes: {r['deltas']}")
    need(op_doc.main(["--check", "--out", str(ROOT / "docs" / "op-reference-torch.md")]) == 0,
         "op_doc --check: docs/op-reference-torch.md is stale")
    print(f"dry run phase: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 18: the block-geometry search on the card (launch/block_search.py),
# the harness twin (launch/bench_run.py), the quickstart and
# shape_climb --autotune-record
# ---------------------------------------------------------------------------

TUNE_BUDGET = 8  # candidates timed a suite entry (the default always)
TUNE_REPS = 5  # groups of ~10 ms of back-to-back calls a candidate
TUNE_RECORD = ROOT / "chip_scratch" / "autotune_record.json"
TUNE_GPTJ_LAYERS = 8
TUNE_GPTJ_WHY = ("a decode step's attention and its launches repeat per layer; 8 of 28 layers "
                 "keep the phase near its time")
TUNE_CLIMB = ("occamy-gptj", "prefill_32k")
# the kernels whose plans or knobs the suite tunes (bsr_spmm: the default alone)
TUNE_KERNELS = ("gemm", "gemm_scaled", "flash_attention", "linear_attention", "spmm",
                "bsr_spmm", "spmspm", "stencil")
QUICKSTART_BOUNDS = {"gemm_err": 1e-3, "spmm_err": 1e-5, "fp32": 1e-6, "bf16": 1e-2, "fp8": 0.1}
# benchmarks/run.py's row names, in its order
REF_ROW_NAMES = (
    ["fig9a_gemm_512"] + [f"fig10_gemm_{p}" for p in ("fp32", "bf16", "fp8")]
    + ["fig9a_tiled_gemm_2048x512"]
    + [f"precision_{op}_{p}_{i}" for op in ("gemm", "flash_attention", "decode_attention")
       for p in ("fp32", "bf16", "fp8", "fp8_e5m2") for i in ("xla", "interpret")]
    + [f"fig9b_{n}" for n in ("j2d5pt_64x64", "j2d9pt_64x64", "j3d7pt_16c", "j3d13pt_16c",
                              "j3d27pt_16c")]
    + [f"fig9c_spmm_{f}_d{d}pct" for d in ("0.12", "1.00", "2.80") for f in ("ell", "bsr")]
    + [f"fig9d_spmspm_d{d}pct" for d in ("0.12", "1.00", "2.80")]
    + [f"fig11_gcn_{g}" for g in ("webkb", "cora", "citeseer")]
    + [f"fig12_gptj_prefill_s{s}" for s in (128, 256, 512, 1024)]
    + [f"fig13a_d2d_disable_{d}" for d in (0, 8, 16, 24)]
    + [f"fig13b_d2d_xfer_{n}B" for n in (1024, 4096, 16384, 65536, 262144, 1048576)]
    + [f"fig13_pod_allreduce_{g}GB" for g in (0.1, 1.0, 2.45)])


def _tune_line(name, key, e):
    timed = e["timed"]
    cands = len(timed) + len(e["pruned"]) + len(e["mismatched"]) + len(e["skipped_by_budget"])
    pruned = ", ".join(f"{p['blocks']} {p['smem_bytes']} B ({p['why']})" for p in e["pruned"][:3])
    more = f" +{len(e['pruned']) - 3} more" if len(e["pruned"]) > 3 else ""
    readings = ", ".join(f"{r:.3f}" for r in e["default_readings_us"])
    rank = (f"; the model's pick ranked {e['model_rank']} of {len(timed)} timed plans"
            if e["knob"] == "plan" else "")
    print(f"tune {name} [{e['knob']}]: {cands} candidates, {len(e['pruned'])} pruned"
          f"{' (' + pruned + more + ')' if pruned else ''}, {len(timed)} timed, "
          f"{len(e['mismatched'])} mismatched {[m['blocks'] for m in e['mismatched']]}, "
          f"{len(e['skipped_by_budget'])} past the budget; default {e['default_blocks']} "
          f"[{readings}] us; winner {e['blocks']} {e['us_per_call']:.3f} us{rank}"
          + (f"; {e['note']}" if e.get("note") else ""))


def _tuned_planner(plan_op, args):
    """The planner's return at ``args`` (an override there, else its model)."""
    from repro_torch.hopper import flash_attention, gemm, gemm_scaled, spmm, spmspm, stencil

    fn = {"gemm": gemm.plan_f32, "gemm_scaled": gemm_scaled.plan, "spmm": spmm.plan,
          "spmspm": spmspm.plan, "stencil": stencil.plan, "flash_attention": flash_attention.plan}
    return fn[plan_op](*args)


def tune_search_phase(report):
    """(a) and (b): the search at the card's shapes, then its record
    replayed."""
    import numpy as np
    import torch

    from repro_torch.hopper import dispatch
    from repro_torch.launch import block_search as bs

    t = time.perf_counter()
    keys = {}  # suite name -> record key

    def on_entry(name, key, e):
        keys[name] = key
        _tune_line(name, key, e)

    try:
        record = bs.autotune(suite=bs.full_suite(), reps=TUNE_REPS, trial_budget=TUNE_BUDGET,
                             device="cuda", on_entry=on_entry)
    except bs.SearchFault as e:
        raise SmokeFailure(f"block search: {e}") from e
    print(f"tune: the search over {len(record['entries'])} entries in "
          f"{time.perf_counter() - t:.1f} s on {record['backend']}")
    TUNE_RECORD.parent.mkdir(parents=True, exist_ok=True)
    bs.save_record(record, str(TUNE_RECORD))
    loaded = bs.load_record(str(TUNE_RECORD))
    need(loaded == json.loads(json.dumps(record)), "tune: the saved record does not load back")
    report["tune"] = {name: {f: e[f] for f in ("knob", "blocks", "us_per_call", "default_blocks",
                                               "default_us", "default_readings_us")}
                      | {"model_rank": e.get("model_rank"), "mismatched": len(e["mismatched"]),
                         "pruned": len(e["pruned"]), "timed": len(e["timed"])}
                      for name, e in ((n, record["entries"][k]) for n, k in keys.items())}

    rng = np.random.default_rng(0)  # the search's operand stream, case by case
    dispatch.reset_launches()
    launches = {}
    for name, factory in bs.full_suite().items():
        e = loaded["entries"][keys[name]]
        case = factory(rng, device="cuda", card=True)
        with dispatch.saved_overrides():
            applied = bs.apply_record(loaded, precision=case.precision, consumer=case.consumer)
            need(e["knob"] == "fixed" or applied.get(case.op) == e["blocks"],
                 f"tune {name}: apply_record gave {applied}, not {e['blocks']}")
            hits = dict(dispatch.PLAN_HITS)
            before = dict(dispatch.LAUNCHES)
            with torch.no_grad():
                out = case.fn(*case.args)
            torch.cuda.synchronize()
            for k, n in dispatch.LAUNCHES.items():
                launches[k] = launches.get(k, 0) + n - before.get(k, 0)
            if e["knob"] == "plan":
                args = bs.decode_args(e["plan_args"])
                want = bs.plan_of(e["plan_op"], args, e["blocks"])
                need(dispatch.PLAN_HITS[e["plan_op"]] > hits.get(e["plan_op"], 0),
                     f"tune {name}: the call did not reach the {e['plan_op']} plan override")
                need(_tuned_planner(e["plan_op"], args) == want,
                     f"tune {name}: the planner does not return the winner {e['blocks']}")
            elif e["knob"] == "blocks":
                need(dispatch.resolve_blocks(case.op) == e["blocks"],
                     f"tune {name}: the block table does not hold the winner {e['blocks']}")
            got = bs.checksum(out)
            was = next(t["checksum"] for t in e["timed"] if t["blocks"] == e["blocks"])
            rel = max(abs(a - b) / max(abs(b), 1.0) for a, b in zip(got, was))
            exact = case.exact
            print(f"tune {name}: the applied {e['blocks']} launched "
                  f"({'a plan override hit, the planner returns it' if e['knob'] == 'plan' else e['knob']}); "
                  f"output sums {got} against the search's {was} (rel {rel:.2e})")
            need(rel == 0 if exact else rel < 1e-5,
                 f"tune {name}: the applied winner's output differs from the search's")

            def call():
                with torch.no_grad():
                    case.fn(*case.args)

            if e["blocks"] != e["default_blocks"]:
                tw = bs._time_call(call, torch.device("cuda"), reps=TUNE_REPS)
                with dispatch.saved_overrides():
                    dispatch.clear_plan_overrides()
                    dispatch.clear_block_overrides()
                    td = bs._time_call(call, torch.device("cuda"), reps=TUNE_REPS)
                tw2 = bs._time_call(call, torch.device("cuda"), reps=TUNE_REPS)
                print(f"tune {name}: re-timed interleaved, winner {tw * 1e6:.3f} / "
                      f"{tw2 * 1e6:.3f} us, default {td * 1e6:.3f} us")
                report["tune"][name].update(retimed_winner_us=[tw * 1e6, tw2 * 1e6],
                                            retimed_default_us=td * 1e6)
        del case, out
        torch.cuda.empty_cache()
    report["block_search_launches"] = launches
    print(f"tune: the tuned calls' launches {launches}")
    for k in TUNE_KERNELS:
        need(launches.get(k, 0) > 0, f"tune: no {k} launch in the tuned calls")
    return loaded


def tune_decode_phase(report, record):
    """(c) occamy-gptj's contiguous decode step at the default bs and
    with the decode_attention#decode winner."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.hopper import dispatch
    from repro_torch.launch import block_search as bs
    from repro_torch.models import transformer

    cfg = get_config("occamy-gptj")
    full = cfg.num_layers
    cfg = cfg.replace(num_layers=TUNE_GPTJ_LAYERS)
    print(f"tune decode: occamy-gptj depth cut to {TUNE_GPTJ_LAYERS} of {full} layers: "
          f"{TUNE_GPTJ_WHY}")
    params = transformer.init_params(cfg, seed=SEED, device="cuda")
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (DENSE_B, DENSE_PROMPT))).cuda()
    res = {}
    with torch.no_grad():
        _, cache = transformer.prefill_step(params, cfg, {"tokens": tokens},
                                            DENSE_PROMPT + DENSE_NEW)
        step = {"token": tokens[:, -1], "position": torch.full((DENSE_B,), DENSE_PROMPT,
                                                               dtype=torch.int32, device="cuda")}
        win = next(e for e in record["entries"].values()
                   if e["op"] == "decode_attention" and e.get("consumer") == "decode")
        for label in ("default", "tuned"):
            with dispatch.saved_overrides():
                if label == "tuned":
                    bs.apply_record(record, consumer="decode")
                bsz = dispatch.resolve_blocks("decode_attention")["bs"]
                dispatch.reset_launches()
                transformer.decode_step(params, cfg, {k: v.clone() for k, v in cache.items()},
                                        step)
                torch.cuda.synchronize()
                kl = dict(dispatch.LAUNCHES)
                name = f"tune decode occamy-gptj {label} bs={bsz}"
                profile_fn(name, lambda: transformer.decode_step(params, cfg, cache, step), report)
                res[label] = dict(report["profile"][name], bs=bsz, kernel_launches=kl)
        print(f"tune decode: the #decode winner {win['blocks']} against the default "
              f"{win['default_blocks']}: wall {res['tuned']['wall_ms']:.3f} / "
              f"{res['default']['wall_ms']:.3f} ms, busy {res['tuned']['busy_ms']:.3f} / "
              f"{res['default']['busy_ms']:.3f} ms, launches {res['tuned']['launches']} / "
              f"{res['default']['launches']}")
    report["tune_decode"] = res
    del params, cache


def tune_harness_phase(report):
    """(d) bench_run on the card, (e) the quickstart, (f) shape_climb."""
    import copy

    import torch

    from repro_torch.launch import bench_run, block_search, quickstart, shape_climb

    t = time.perf_counter()
    out_dir = ROOT / "chip_scratch"
    bench_run.main(["--autotune-only", "--autotune-record", str(TUNE_RECORD),
                    "--json", str(out_dir / "bench_autotune.json")])
    rows = json.loads((out_dir / "bench_autotune.json").read_text())["rows"]
    need(len(rows) == len(block_search.full_suite()) and all(
         r["derived"].endswith(";loaded") for r in rows),
         f"bench_run --autotune-only: {len(rows)} rows, not the record's entries loaded")
    bench_run.main(["--json", str(out_dir / "bench_rows.json")])
    names = [r["name"] for r in json.loads((out_dir / "bench_rows.json").read_text())["rows"]]
    need(names == REF_ROW_NAMES, f"bench_run: row names differ from the reference harness's: "
                                 f"{sorted(set(names) ^ set(REF_ROW_NAMES))}")
    print(f"tune harness: bench_run's {len(names)} rows on the card, names the reference's, "
          f"in {time.perf_counter() - t:.1f} s")
    report["bench_rows"] = len(names)

    t = time.perf_counter()
    q = quickstart.main([])
    for key in ("gemm_err", "spmm_err"):
        need(q[key] <= QUICKSTART_BOUNDS[key], f"quickstart {key} {q[key]:.3e} past its bound")
    for pol, rel in q["precision_rel"].items():
        need(rel <= QUICKSTART_BOUNDS[pol], f"quickstart {pol} rel_err {rel:.3e} past its bound")
    need(len(q["losses"]) == 10 and all(torch.isfinite(torch.tensor(q["losses"]))),
         "quickstart act 4: losses")
    print(f"tune quickstart: {q} in {time.perf_counter() - t:.1f} s")
    report["quickstart"] = q

    t = time.perf_counter()
    arch, shape = TUNE_CLIMB
    res = shape_climb.climb_with_record(arch, shape, {}, str(TUNE_RECORD))
    need("autotune" in res and "error" not in res, f"shape_climb --autotune-record: {res}")
    print(f"tune climb {arch} {shape} with the record: {len(res['autotune'])} entries' deltas "
          f"{ {k: d['delta_pct'] for k, d in res['autotune'].items()} }, dominant "
          f"{res['roofline']['dominant']}, in {time.perf_counter() - t:.1f} s")
    foreign = copy.deepcopy(block_search.load_record(str(TUNE_RECORD)))
    foreign["backend"] = "another card (114 SMs)"
    path = out_dir / "autotune_foreign.json"
    block_search.save_record(foreign, str(path))
    try:
        shape_climb.climb_with_record(arch, shape, {}, str(path))
        need(False, "shape_climb took a record from another card")
    except ValueError as e:
        need("re-run the autotuner" in str(e), f"shape_climb refused with {e}")
        print(f"tune climb: a record from another card refused: {str(e)[:120]}")


def block_search_phase(report):
    import torch

    t0 = time.perf_counter()
    record = tune_search_phase(report)
    print(f"tune phase: (a, b) {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    tune_decode_phase(report, record)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"tune phase: (c) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    tune_harness_phase(report)
    print(f"tune phase: (d-f) {time.perf_counter() - t:.1f} s")
    print(f"tune phase: {time.perf_counter() - t0:.1f} s")
    report["tune_phase_s"] = time.perf_counter() - t0


# phase 19: the static checker on the card
ANALYSIS_STATES = {"scheduler-model": 28871, "overlap-interleavings": 588}  # the CPU tests' counts
ANALYSIS_BUDGET_S = 60.0  # the phase fails past this many seconds
# The probes' sums: a large head, then a long tail of terms each block of
# which is below half a bf16 (and fp16) ulp of the head, so only an fp32
# running sum takes the tail in; the script checks that for every block
# width in PROBE_BLOCKS (``_narrow_readings``) before it reads the kernel.
PROBE_K = 4096  # the terms of each probed sum
PROBE_REL = 2.0 ** -10  # a probe of an fp32 accumulator reads its exact sum within this
PROBE_BLOCKS = (1, 16, 32, 64, 128, 256)  # the narrow running sums' block widths
PROBE_GEMM_HEAD = 256  # GEMM: K rows of ones, then rows of PROBE_GEMM_TAIL
PROBE_GEMM_TAIL = 2.0 ** -12
PROBE_FA_HOT = 32  # attention: these first keys score PROBE_FA_GAP above the rest
PROBE_FA_GAP = 10.0
PROBE_SCAN_S0 = 256.0  # the scan: the state entry (0, 0) starts here, each step adds
PROBE_SCAN_STEP = 2.0 ** -12
PROBE_PLANNED = ("gemm", "gemm_scaled", "flash_attention", "spmm", "spmspm", "stencil")


def analysis_cli_phase(report):
    """(a) ``python -m repro_torch.analysis --format json`` on the card's
    host (the CPU tier): exit 0, each rule's finding count, each
    exploration's states, the totals equal to the CPU tests'."""
    import os

    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--format", "json"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    need(proc.returncode == 0, f"analysis CLI exit {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                               f"{proc.stderr[-2000:]}")
    rep = json.loads(proc.stdout)
    counts = {r: sum(f["rule"] == r for f in rep["findings"]) for r in rep["rules"]}
    print(f"analysis (a): the CLI exit 0 in {time.perf_counter() - t:.1f} s; findings per rule "
          f"{counts}")
    states = {}
    for rule, want in ANALYSIS_STATES.items():
        runs = rep["stats"][rule]
        states[rule] = sum(s["states"] for s in runs.values())
        print(f"analysis (a): {rule} {len(runs)} explorations, states "
              f"{ {tag: s['states'] for tag, s in runs.items()} }")
        need(states[rule] == want, f"analysis (a): {rule} explored {states[rule]} states, the "
                                   f"CPU tests {want}")
        need(not any(s["truncated"] for s in runs.values()), f"analysis (a): {rule} truncated")
    report["analysis_cli"] = {"findings": counts, "states": states}


def analysis_plans_phase(report, ctx):
    """(b) ``smem-budget`` at the card's own limits and shapes, then each
    planned case's pick launched once through its op under
    ``dispatch.plan_override`` at the planner's arguments."""
    import torch

    from repro_torch.analysis import plan_rules
    from repro_torch.hopper import dispatch
    from repro_torch.launch.block_search import H100_SMS, SMEM_BUDGET_BYTES

    findings = plan_rules.smem_budget(ctx)
    need(findings == [], "analysis (b): smem-budget on the card: "
                         + "; ".join(f.format() for f in findings))
    stats = ctx.stats["smem-budget"]
    limits = stats["limits"]
    print(f"analysis (b): the card's limits as read: {limits['sms']} SMs, "
          f"{limits['smem_per_block']} B opt-in shared memory a block, "
          f"{limits['threads_per_block']} threads, {limits['regs_per_block']} registers "
          f"({limits['source']}); the H100 constants: {H100_SMS} SMs, {SMEM_BUDGET_BYTES} B")
    print(f"analysis (b): unplanned {stats['unplanned']}")
    picks = {}
    card = plan_rules.CardLimits(**limits)
    for name, case, plan_op, plan_args, cands in plan_rules.suite_plans(ctx, card):
        pick = dispatch.model_pick(cands)
        with dispatch.plan_override(plan_op, plan_args, pick.plan):
            hits = dispatch.PLAN_HITS[plan_op]
            before = dict(dispatch.LAUNCHES)
            with torch.no_grad():
                out = case.fn(*case.args)
            torch.cuda.synchronize()
        delta = {k: n - before.get(k, 0) for k, n in dispatch.LAUNCHES.items()
                 if n != before.get(k, 0)}
        outs = out if isinstance(out, (tuple, list)) else (out,)
        print(f"analysis (b) {name}: {plan_op} pick {pick.knobs} ({pick.smem} B, {pick.threads} "
              f"threads, {pick.regs} registers a thread) at {plan_args}: launches {delta}, "
              f"plan hits {dispatch.PLAN_HITS[plan_op] - hits}")
        need(delta.get(plan_op, 0) >= 1, f"analysis (b) {name}: the pick did not launch {plan_op}")
        need(dispatch.PLAN_HITS[plan_op] > hits,
             f"analysis (b) {name}: the launch did not take the {plan_op} plan override")
        need(all(bool(torch.isfinite(o.float()).all()) for o in outs),
             f"analysis (b) {name}: non-finite output")
        picks[name] = {"plan_op": plan_op, "pick": pick.knobs, "smem": pick.smem,
                       "threads": pick.threads, "launches": delta}
        del out, outs
    need(sorted({p["plan_op"] for p in picks.values()}) == sorted(PROBE_PLANNED),
         f"analysis (b): planned kernels {sorted(p['plan_op'] for p in picks.values())}")
    report["analysis_limits"] = limits
    report["analysis_picks"] = picks


def _narrow_readings(terms, start=0.0):
    """What a running sum rounded to bf16, and one rounded to fp16, would
    read over ``terms`` (a 1-D float64 tensor) from ``start``, adding one
    block of terms (summed exactly) at a time: ``{"bfloat16": [...],
    "float16": [...]}``, one reading for each width of PROBE_BLOCKS."""
    import torch

    out = {}
    for dt in (torch.bfloat16, torch.float16):
        reads = []
        for b in PROBE_BLOCKS:
            s = torch.tensor(start, dtype=torch.float64).to(dt)
            for part in terms.reshape(-1, b).sum(1):
                s = (s.double() + part).to(dt)
            reads.append(float(s))
        out[str(dt).replace("torch.", "")] = reads
    return out


def _probe_sum(label, terms, start=0.0):
    """The exact sum of one probe's terms, after showing that a narrow
    running sum would read it farther than PROBE_REL off at every block
    width, so the probe tells an fp32 accumulator from a bf16 or fp16 one."""
    exact = float(start + terms.sum())
    narrow = _narrow_readings(terms, start)
    worst = min(abs(r - exact) / abs(exact) for rs in narrow.values() for r in rs)
    print(f"analysis (c) {label}: exact sum {exact!r}; a narrow running sum reads "
          f"{ {dt: sorted(set(rs)) for dt, rs in narrow.items()} } (rel >= {worst:.3e})")
    need(worst > PROBE_REL, f"analysis (c) {label}: the input does not separate a narrow "
                            f"running sum from the exact {exact} (rel {worst:.3e})")
    return exact, narrow


def _probe_reading(label, streams, got, exact, narrow, report):
    """Hold one accumulator probe: within PROBE_REL of ``exact`` where the
    declaration sums in fp32, beyond it where it declares a narrow sum."""
    rel = abs(got - exact) / abs(exact)
    wide = str(streams.accum) == "torch.float32"
    print(f"analysis (c) {label}: declared {streams.name}, accum "
          f"{str(streams.accum).replace('torch.', '')}; reads {got!r} against the exact "
          f"{exact!r} (rel {rel:.3e}, bound {PROBE_REL:.3e}: "
          f"{'within' if rel <= PROBE_REL else 'outside'})")
    need(rel <= PROBE_REL if wide else rel > PROBE_REL,
         f"analysis (c) {label}: a {'wide' if wide else 'narrow'} accumulator read {got} "
         f"against {exact}")
    report["analysis_probes"][label] = {"kernel": streams.name, "accum": str(streams.accum),
                                        "reading": got, "exact": exact, "rel": rel,
                                        "narrow": narrow}


def _worst(t, exact):
    """The entry of ``t`` farthest from ``exact``, as a float."""
    t = t.double().flatten()
    return float(t[(t - exact).abs().argmax()])


def _narrow(streams):
    return any(o.role == "value" and o.dtype.is_floating_point and o.dtype.itemsize < 4
               for o in streams.operands)


def analysis_probe_phase(report, ctx):
    """(c) the accumulator of every declaration taking sub-fp32 floats,
    probed in the compiled kernel on a sum whose tail only an fp32
    running sum takes in (``_probe_sum`` shows that a bf16 or fp16 one
    drops it at every block width); the GEMM with a bf16 and an fp16
    ``accum_dtype`` are the controls that must read away."""
    import math

    import torch

    from repro_torch.analysis import plan_rules
    from repro_torch.core import precision as prec
    from repro_torch.hopper import dispatch, ops

    report["analysis_probes"] = {}
    dev = torch.device("cuda")
    K, bf = PROBE_K, torch.bfloat16

    def declared(op, xs, policy=None, **kw):
        s = dispatch.kernel_streams(op, [(tuple(x.shape), x.dtype) for x in xs], policy, **kw)
        need(_narrow(s), f"analysis (c): {s.name} takes no sub-fp32 floats")
        return s

    probed = set()
    with torch.no_grad():
        # the GEMM: a is ones, b's first 256 rows ones and the rest 2^-12,
        # so every entry of c sums a head of 256 and a tail of 15/16
        a = torch.ones((128, K), dtype=bf, device=dev)
        b = torch.full((K, 128), PROBE_GEMM_TAIL, dtype=bf, device=dev)
        b[:PROBE_GEMM_HEAD] = 1.0
        exact, narrow = _probe_sum("gemm", b[:, 0].double().cpu())
        s = declared("gemm", (a, b))
        c = ops.gemm(a, b, out_dtype=torch.float32, impl="cuda")
        _probe_reading("gemm bf16", s, _worst(c, exact), exact, narrow, report)
        probed.add(s.name)
        # the scaled GEMM's routes under each narrow policy, on the same sum
        a32, b32 = a.float(), b.float()
        for pol in ("bf16", "fp8", "fp8_e5m2"):
            p = prec.resolve(pol)
            s = declared("gemm", (a32, b32), p)
            c = ops.gemm(a32, b32, precision=p, impl="cuda")
            _probe_reading(f"gemm@{pol}", s, _worst(c, exact), exact, narrow, report)
            probed.add(s.name)
        # the controls: the same sum in a declared bf16 or fp16 accumulator
        for accum in (torch.float32, bf, torch.float16):
            s = dispatch.kernel_streams("gemm", [(tuple(a.shape), bf), (tuple(b.shape), bf)],
                                        accum_dtype=accum)
            c = ops.gemm(a, b, out_dtype=torch.float32, accum_dtype=accum, impl="cuda")
            got = float(c[0, 0])
            need(bool((c == got).all()), f"analysis (c): the control's {accum} sums differ")
            _probe_reading(f"gemm control accum {str(accum).replace('torch.', '')}", s, got,
                           exact, narrow, report)
        # attention: q is one-hot and the first 32 keys score 10 above the
        # rest, so each row's softmax sum l is 32 after the first key block
        # and every later key adds e^-10; l is read from the fp32 log-sum-exp
        D = 64
        q = torch.zeros((1, 1, 64, D), dtype=bf, device=dev)
        q[..., 0] = 1.0
        k = torch.zeros((1, 1, K, D), dtype=bf, device=dev)
        k[:, :, :PROBE_FA_HOT, 0] = PROBE_FA_GAP * math.sqrt(D)
        v = torch.randn((1, 1, K, D), device=dev).to(bf)
        scores = k[0, 0, :, 0].double().cpu() / math.sqrt(D)
        exact, narrow = _probe_sum("flash_attention", torch.exp(scores - PROBE_FA_GAP))

        def row_sum(lse):
            need(bool(torch.isfinite(lse).all()), "analysis (c): a non-finite log-sum-exp")
            return _worst(torch.exp(lse.double() - PROBE_FA_GAP), exact)

        s = declared("flash_attention", (q, k, v), return_lse=True)
        o, lse = ops.flash_attention(q, k, v, causal=False, return_lse=True, impl="cuda")
        need(bool(torch.isfinite(o.float()).all()), "analysis (c): a non-finite attention output")
        _probe_reading("flash_attention bf16", s, row_sum(lse), exact, narrow, report)
        probed.add(s.name)
        for pol in ("bf16", "fp8", "fp8_e5m2"):
            p = prec.resolve(pol)
            s = declared("flash_attention", (q, k, v), p, return_lse=True)
            o, lse = ops.flash_attention(q.float(), k.float(), v.float(), causal=False,
                                         precision=p, return_lse=True, impl="cuda")
            need(bool(torch.isfinite(o).all()), f"analysis (c): non-finite attention@{pol}")
            _probe_reading(f"flash_attention@{pol}", s, row_sum(lse), exact, narrow, report)
            probed.add(s.name)
        # the scan (bf16 r/k/v, no decay): state entry (0, 0) starts at 256
        # and k_t v_t^T adds 2^-12 to it every step
        r = torch.zeros((1, 1, K, 64), dtype=bf, device=dev)
        r[..., 0] = 1.0
        kk = vv = r * 2.0 ** -6
        w = torch.zeros((1, 1, K, 64), device=dev)
        s0 = torch.zeros((1, 1, 64, 64), device=dev)
        s0[0, 0, 0, 0] = PROBE_SCAN_S0
        exact, narrow = _probe_sum("linear_attention",
                                   torch.full((K,), PROBE_SCAN_STEP, dtype=torch.float64),
                                   PROBE_SCAN_S0)
        s = declared("linear_attention", (r, kk, vv, w))
        _, S = ops.linear_attention(r, kk, vv, w, s0=s0, impl="cuda")
        _probe_reading("linear_attention bf16 state", s, float(S[0, 0, 0, 0]), exact, narrow,
                       report)
        need(float(S.abs().sum()) == float(S[0, 0, 0, 0]),
             "analysis (c): the scan's state holds other entries")
        probed.add(s.name)
    torch.cuda.synchronize()

    # every card-suite declaration taking sub-fp32 floats was probed
    narrow = {name: st.name for name, st, _ in plan_rules.suite_streams(ctx)
              if st is not None and _narrow(st)}
    print(f"analysis (c): the card suite's sub-fp32 declarations {narrow}; probed "
          f"{sorted(probed)}")
    need(set(narrow.values()) <= probed,
         f"analysis (c): unprobed declarations {set(narrow.values()) - probed}")
    report["analysis_narrow"] = narrow


def analysis_phase(report):
    """Phase 19: the static checker on the card, (a) to (d)."""
    import torch

    from repro_torch.analysis.base import Context, default_root
    from repro_torch.hopper import dispatch

    t0 = time.perf_counter()
    analysis_cli_phase(report)
    ctx = Context(default_root(), device="cuda")
    dispatch.reset_launches()
    analysis_plans_phase(report, ctx)
    analysis_probe_phase(report, ctx)
    report["analysis_launches"] = dict(dispatch.LAUNCHES)
    print(f"analysis: launches in (b) and (c) {report['analysis_launches']}")
    for k in PROBE_PLANNED + ("flash_attention_scaled", "linear_attention"):
        need(report["analysis_launches"].get(k, 0) > 0, f"analysis: no {k} launch")
    del ctx
    gc.collect()
    torch.cuda.empty_cache()
    report["analysis_phase_s"] = time.perf_counter() - t0
    print(f"analysis phase: {report['analysis_phase_s']:.1f} s (budget {ANALYSIS_BUDGET_S:.0f} s)")
    need(report["analysis_phase_s"] <= ANALYSIS_BUDGET_S,
         f"analysis phase: {report['analysis_phase_s']:.1f} s, past its {ANALYSIS_BUDGET_S} s")


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
        check_gemm_accum(report)
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
        for arch, layers, why in DENSE_OTHERS:
            dense_config_phase(report, arch, layers, why)
            gc.collect()
            torch.cuda.empty_cache()
        for arch, layers, why, check_layers in FAMILY_CONFIGS:
            family_phase(report, arch, layers, why, check_layers)
            gc.collect()
            torch.cuda.empty_cache()
        check_la_kernels(report)
        for arch, batch in RECURRENT:
            recurrent_phase(report, arch, batch)
            gc.collect()
            torch.cuda.empty_cache()
        check_ring_kernels(report)
        ring_phase(report)
        mesh_phase(report, cases)
        gc.collect()
        torch.cuda.empty_cache()
        training_phase(report)
        gc.collect()
        torch.cuda.empty_cache()
        mesh_train_phase(report)
        gc.collect()
        torch.cuda.empty_cache()
        roofline_phase(report)
        gc.collect()
        torch.cuda.empty_cache()
        dryrun_phase(report)
        gc.collect()
        torch.cuda.empty_cache()
        block_search_phase(report)
        gc.collect()
        torch.cuda.empty_cache()
        analysis_phase(report)
        time_kernels(report)
        time_gcn_kernels(report)
        time_gemm_accum(report)
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
        # each dense config's generate (B=4, 512 + 16 tokens, contiguous
        # cache), counted on its own: one launch a layer, all in the prefill
        "dense_generate_launches": {a: r["launches"].get("flash_attention", 0)
                                    for a, r in report["dense"].items()},
        # the remaining families (phase 10b), each counted on its own:
        # generate (one a layer in the prefill; whisper's encoder once),
        # phi3.5-moe's engine run, whisper's teacher-forced forward
        "families_launches": {a: {k: r[k].get("flash_attention", 0) for k in
                                  ("launches", "serve_launches", "forward_launches") if k in r}
                              for a, r in report["families"].items()},
        # the training phase (forward and remat recompute, launch.train's
        # main at full width): launches a step, per model
        "train_launches_per_step": _train_launches(report, "flash_attention"),
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
        # device times (CUDA-graph replay) beside the events' ms
        kernels[-1].update(device_ms=t["device_ms"], library_device_ms=t["library_device_ms"])
        if name == "gemm":  # ops.gemm(accum_dtype=bf16 / fp16): both routes, held per block
            kernels[-1]["accum"] = {
                key: dict(r, max_abs_err=report["gemm_accum_err"][key.split("/")[1]])
                for key, r in report["gemm_accum_time"].items()}
        if name == "spmm":  # the sparse trio's ELL cases and the L2 probe
            kernels[-1].update(
                trio_launches=report["sparse_la_launches"]["spmm"],
                trio={c: {f: r[f] for f in ("device_ms", "library_device_ms", "bound_ms", "bound_by")}
                      for c, r in report["spmm_time"].items() if c.startswith("fig9c")},
                l2_probe=report["spmm_l2_probe"])
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
        "train_launches_per_step": _train_launches(report, "linear_attention"),
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
    for k in kernels:  # the mesh phase's launches of each kernel, by mesh
        k["mesh_launches"] = {m: c.get(k["name"], 0) for m, c in report["mesh_launches"].items()}
        # phase 15: a meshed training step's launches, by model
        k["mesh_train_launches_per_step"] = {
            a: r["mesh"]["rows"][-1]["launches"].get(k["name"], 0)
            for a, r in report["mesh_train"].items()}
        # phase 16: the op cases' launches, and the case this kernel runs
        k["op_roofline_launches"] = report["op_roofline_launches"].get(k["name"], 0)
        # phase 17: the grounding steps' launches
        k["dryrun_launches"] = report["dryrun_launches"].get(k["name"], 0)
        # phase 18: the tuned calls' launches, and the entries' tuned times
        k["block_search_launches"] = report["block_search_launches"].get(k["name"], 0)
        # phase 19: the checker's planned picks and accumulator probes
        k["analysis_launches"] = report["analysis_launches"].get(k["name"], 0)
        case = next((op for op, name in OP_KERNELS.items() if name == k["name"]), None)
        if case is not None:
            r = report["op_roofline"][case]
            k["op_roofline"] = {f: r[f] for f in ("shape", "dtype", "ms", "warm_ms", "bound_ms",
                                                  "bound_by", "share", "cell_bound_ms")}
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
