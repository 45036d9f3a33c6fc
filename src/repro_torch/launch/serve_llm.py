"""Batched LLM serving on the port (port of ``examples/serve_llm.py``):
prefill + KV-cache decode, then the continuous-batching engine.

Part one mirrors the paper's GPT-J evaluation (Sec. V-C): ``generate``
prefills a batch of prompts through the FA-2 kernel and decodes from the
contiguous cache one token per step, and reports tok/s like Fig. 12. Part
two serves the same model behind the paged KV cache, with requests
arriving open-loop and a pool tight enough to preempt.

    PYTHONPATH=src python -m repro_torch.launch.serve_llm [--device cpu]

The config is the reference's cut of occamy-gptj (REDUCED with 4 layers,
d_model 256, 4 heads of 64, d_ff 1024, vocab 8192; fp32) with the port's
seeded weights; prompts and requests come from a numpy ``Generator`` of
seed 0, drawn in the reference's order.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch.prefill_rate import CFG
from repro_torch.launch.serve import generate
from repro_torch.models import registry
from repro_torch.serving.engine import Request, ServingEngine

BATCHES = ((4, 64, 32), (16, 64, 32))  # (batch, prompt length, new tokens)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_generate(params, rng, device, batches=BATCHES):
    for batch, prompt_len, gen_len in batches:
        tokens = torch.from_numpy(
            rng.integers(0, CFG.vocab_size, (batch, prompt_len)).astype(np.int32)).to(device)
        t0 = time.perf_counter()
        out = generate(CFG, params, tokens, gen_len, prompt_len + gen_len + 1)
        _sync(device)
        dt = time.perf_counter() - t0
        print(f"batch {batch:3d}: prefill {prompt_len} + decode {gen_len} "
              f"-> {batch * gen_len / dt:7.1f} tok/s  (shape {tuple(out.shape)})")


def continuous_batching(params, rng, device):
    """12 requests of mixed priority, two arriving per step, on a pool of
    11 usable pages for up to 4 sequences: the grow/preempt/resume
    machinery runs. Returns the engine."""
    engine = ServingEngine.with_model(
        CFG, params, num_blocks=12, block_size=16, max_slots=4,
        max_blocks_per_seq=6, device=device, eos_id=None,
    )
    for rid in range(12):
        plen = int(rng.integers(8, 48))
        engine.submit(Request(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(1, CFG.vocab_size, plen)),
            max_new_tokens=int(rng.integers(8, 24)),
            priority=int(rid % 2),
            arrival=rid // 2,
        ))
    t0 = time.perf_counter()
    completed = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in completed.values())
    preempts = sum(1 for e in engine.scheduler.events if e[0] == "preempt")
    print(f"engine: {len(completed)}/12 requests, {tokens} tokens in "
          f"{engine.step_count} steps -> {tokens / dt:7.1f} tok/s  "
          f"(preemptions {preempts}, leaked blocks {engine.leaked_blocks()})")
    if engine.leaked_blocks():
        raise RuntimeError(f"{engine.leaked_blocks()} leaked cache blocks")
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    params = registry.init_params(CFG, seed=0, device=device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"{CFG.name} cut to {CFG.num_layers} layers x d_model {CFG.d_model} on {where}")
    batch_generate(params, rng, device)
    return continuous_batching(params, rng, device)


if __name__ == "__main__":
    main()
