#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

  1. build every Hopper kernel from ``src/repro_torch/csrc`` (one ``nvcc``
     per source, started together);
  2. hold each kernel against its plain version on the card, at the shapes
     the serving path gives it (bf16, full width) and at small fp32 shapes
     covering GQA, window, q_offset, ragged Sk and return_lse;
  3. build ``occamy-gptj`` (GPT-J-6B) at full width with random weights
     from a seeded ``torch.Generator``, on the card;
  4. serve a few requests through ``ServingEngine.with_model`` over the
     paged KV cache, with a pool tight enough to preempt; the kernels'
     launch counts are zeroed just before and read just after;
  5. check the run (all requests complete, no leaked blocks, one FA launch
     per layer per prefill, a prefill's logits with the kernel vs with the
     plain version) and time the kernels against their plain versions and
     the library call.

Prints the card's name and power limit, one JSON line of per-kernel
numbers, and as its last line ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the reference package.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# the serving run: requests, pool and slots (full-width occamy-gptj)
SEED = 0
N_REQUESTS = 6
PROMPT_LENS = (100, 500)
NEW_TOKENS = 16
SLOTS = 4
BLOCK_SIZE = 16
MAX_BLOCKS_PER_SEQ = 33  # ceil((500 + 16) / 16)
NUM_BLOCKS = 56  # tight: this workload preempts twice (checked below)

FA_REPLACES = "src/repro/kernels/flash_attention.py:57"
FA_SOURCE = "src/repro_torch/csrc/flash_attention.cu"


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

# (label, B, H, K, Sq, Sk, D, dtype, causal, window, q_offset, return_lse)
FA_CASES = [
    ("prefill S=208 bf16", 1, 16, 16, 208, 208, 256, "bfloat16", True, 0, 0, False),
    ("prefill S=512 bf16", 1, 16, 16, 512, 512, 256, "bfloat16", True, 0, 0, False),
    ("gqa causal lse f32", 2, 8, 2, 100, 100, 64, "float32", True, 0, 0, True),
    ("window non-causal f32", 1, 4, 4, 130, 130, 32, "float32", False, 17, 0, True),
    ("q_offset ragged Sk f32", 2, 4, 1, 37, 101, 16, "float32", True, 0, 64, True),
    ("non-causal ragged f32", 1, 2, 2, 45, 77, 128, "float32", False, 0, 0, True),
    ("window+q_offset bf16 lse", 1, 4, 2, 70, 150, 256, "bfloat16", True, 40, 80, True),
    ("gqa ragged bf16 D=64", 2, 8, 2, 100, 130, 64, "bfloat16", True, 0, 0, True),
    ("window non-causal bf16 D=128", 1, 4, 4, 77, 77, 128, "bfloat16", False, 20, 0, True),
    ("q_offset bf16 D=16", 1, 2, 1, 37, 101, 16, "bfloat16", True, 0, 64, True),
    ("non-causal bf16 D=32", 2, 2, 2, 45, 70, 32, "bfloat16", False, 0, 0, True),
]
# |kernel - plain| <= ATOL + RTOL * |plain|. fp32: both sum in fp32 in
# different orders (the reference suite's 1e-4). bf16: both round an fp32
# result to bf16 (8-bit mantissa), so they may differ by one bf16 step.
TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
LSE_TOL = (1e-4, 1e-4)


def _fa_inputs(case, gen, *, transposed):
    import torch

    _, B, H, K, Sq, Sk, D, dt, *_ = case
    dtype = getattr(torch, dt)

    def make(heads, S):
        # the transformer hands the kernel (B, S, H, D) -> (B, H, S, D) views
        shape = (B, S, heads, D) if transposed else (B, heads, S, D)
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        return x.transpose(1, 2) if transposed else x

    return make(H, Sq), make(K, Sk), make(K, Sk)


def check_kernels(report):
    """Phase 2: every case through the kernel and the plain version on the
    same inputs; record errors against the stated tolerances."""
    import torch

    from repro_torch.hopper import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for case in FA_CASES:
        label, B, H, K, Sq, Sk, D, dt, causal, window, q_offset, lse = case
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
    prefill shape (S=512 bucket, bf16); the other shapes are printed."""
    import torch
    import torch.nn.functional as F

    from repro_torch.hopper import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    for case in FA_CASES[:2]:
        label, B, H, K, Sq, Sk, D, dt, causal, window, q_offset, _ = case
        q, k, v = _fa_inputs(case, gen, transposed=True)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        # plain, kernel, kernel, plain: compare within one call, in turns
        plain = [time_ms(lambda: ops.flash_attention(q, k, v, impl="torch", **kw))]
        kern = [time_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", **kw))]
        kern.append(time_ms(lambda: ops.flash_attention(q, k, v, impl="cuda", **kw)))
        plain.append(time_ms(lambda: ops.flash_attention(q, k, v, impl="torch", **kw)))
        lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
        bound, by = fa_bound_ms(B, H, K, Sq, Sk, D, dt, causal=causal)
        row = dict(shape=f"B={B} H={H} K={K} S={Sq} D={D} {dt} causal",
                   ms=min(kern), plain_ms=min(plain), library_ms=lib,
                   bound_ms=bound, bound_by=by)
        print(f"time flash_attention [{label}]: kernel {kern} ms, plain {plain} ms, "
              f"sdpa {lib:.4f} ms, bound {bound:.5f} ms ({by})")
        report.setdefault("fa_time", {})[label] = row


# ---------------------------------------------------------------------------
# phases 3-5: full-width occamy-gptj through the serving engine
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
    from repro_torch.hopper import dispatch
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
    for r in reqs:
        engine.submit(r)

    # host clock around each model call; both end in a device->host copy
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

    events = engine.scheduler.events
    preempts = sum(1 for e in events if e[0] == "preempt")
    prefills = sum(1 for e in events if e[0] == "admit" and e[5] == 0)
    resumes = sum(1 for e in events if e[0] == "admit" and e[5] > 0)
    fa = launches.get("flash_attention", 0)
    print(f"serve: completed={len(out)}/{len(reqs)} steps={engine.step_count} "
          f"preemptions={preempts} prefills={prefills} resumes={resumes} "
          f"leaked={engine.leaked_blocks()} wall={wall:.3f} s")
    print(f"serve: kernel launches during the run: {launches}; expected "
          f"flash_attention = {cfg.num_layers} layers x {prefills} prefills "
          f"= {cfg.num_layers * prefills}")
    need(len(out) == len(reqs), "not every request completed")
    need(all(len(out[r.rid]) == r.max_new_tokens for r in reqs), "short token stream")
    need(engine.leaked_blocks() == 0, "leaked cache blocks")
    need(preempts >= 1, "the pool never preempted")
    need(fa == cfg.num_layers * prefills, "flash_attention launch count != layers x prefills")

    for n, ms in prefill_ms:
        print(f"time prefill: prompt {n} tokens -> {ms:.2f} ms")
    steady = decode_ms[1:] or decode_ms
    tok_s = sum(decode_tokens[1:] or decode_tokens) / (sum(steady) / 1e3)
    print(f"time decode: {len(decode_ms)} steps, mean {sum(steady) / len(steady):.2f} ms/step "
          f"over {SLOTS} slots, {tok_s:.1f} tok/s (first step excluded)")
    report["fa_launches"] = fa
    report["serve"] = dict(prefill_ms=prefill_ms, decode_tok_s=tok_s)

    check_prefill_logits(cfg, params, reqs, out)
    profile_steps(engine, reqs, report)


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
    from torch.profiler import ProfilerActivity, profile

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
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]

        def dev(e):
            return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total

        busy_ms = sum(dev(e) for e in events) / 1e3
        top = sorted(events, key=dev, reverse=True)[:6]
        launches = sum(e.count for e in events)
        print(f"profile {name}: wall {min(walls):.2f} ms (min of {walls}), device busy "
              f"{busy_ms:.2f} ms, idle share {1 - busy_ms / min(walls):.3f}, "
              f"{launches} kernel launches")
        for e in top:
            print(f"profile {name}:   {dev(e) / 1e3:8.3f} ms x{e.count:5d}  {e.key[:90]}")
        report.setdefault("profile", {})[name] = dict(wall_ms=min(walls), busy_ms=busy_ms)


# ---------------------------------------------------------------------------


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
            print(f"build {name}: " + " | ".join(regs[:4]))
        check_kernels(report)
        serve(report)
        time_kernels(report)
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
    }]
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
