"""Serving-engine benchmark (port of ``benchmarks/bench_serve.py``):
continuous batching under Poisson load.

Drives the port's ``serving`` engine (continuous-batching scheduler over a
paged KV cache) with the reference's seeded open-loop workload and reports
its figures of merit: decode throughput (tok/s), request latency
percentiles (p50/p99, in engine steps), preemption and admission counts,
and the block-ledger audit (leaked blocks must be 0). EOS is disabled, so
the admission trace is scheduler arithmetic only: at the defaults its
SHA-256 is the one ``BENCH_serve.json`` pins, on any device.

    PYTHONPATH=src python -m repro_torch.launch.serve_bench [--device cpu] [--smoke] [--json PATH]

The model is the config's REDUCED form (gemma-2b by default), as in the
reference, with the port's seeded weights unless the caller passes
``params``. ``--smoke`` asserts the reference's invariants (every request
completed, no leaked block, a finite p99) and exits non-zero on a
violation.
"""
from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.bench_rows import Rows
from repro_torch.models import registry
from repro_torch.serving.engine import Request, ServingEngine


def poisson_requests(rng, *, n, lam, vocab, prompt_lens=(4, 24),
                     gen_lens=(4, 16), priorities=(0, 0, 0, 1)):
    """Seeded open-loop workload: ``n`` requests with Exp(1/lam)
    inter-arrival steps (a Poisson process in virtual time), uniform
    prompt/gen lengths and a priority mix, drawn from ``rng`` in the
    reference's order."""
    t = 0.0
    reqs = []
    for rid in range(n):
        t += rng.exponential(1.0 / lam)
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(x) for x in rng.integers(1, vocab, plen)),
            max_new_tokens=int(rng.integers(gen_lens[0], gen_lens[1] + 1)),
            priority=int(priorities[rng.integers(0, len(priorities))]),
            arrival=int(t),
        ))
    return reqs


def trace_hash(engine) -> str:
    """SHA-256 over the admission trace, the reproducibility artifact."""
    return hashlib.sha256(repr(engine.scheduler.admission_trace()).encode()).hexdigest()


def parser():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=1.5,
                    help="mean arrivals per engine step")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--num-blocks", type=int, default=12)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-blocks-per-seq", type=int, default=6)
    ap.add_argument("--max-steps", type=int, default=5000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    ap.add_argument("--smoke", action="store_true")
    return ap


def run(args, rows: Rows, *, params=None):
    """Serve the workload; returns the run's numbers and the completed
    token streams (``completed``: rid -> tokens)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=True)
    if params is None:
        params = registry.init_params(cfg, seed=0, device=device)
    rng = np.random.default_rng(args.seed)
    reqs = poisson_requests(rng, n=args.requests, lam=args.rate, vocab=cfg.vocab_size)

    engine = ServingEngine.with_model(
        cfg, params, num_blocks=args.num_blocks, block_size=args.block_size,
        max_slots=args.slots, max_blocks_per_seq=args.max_blocks_per_seq,
        device=device, eos_id=None,  # no EOS: the trace is scheduler arithmetic only
    )
    for r in reqs:
        engine.submit(r)

    t0 = time.perf_counter()
    engine.run(max_steps=args.max_steps)
    wall = time.perf_counter() - t0  # ends in the decode's device-to-host copy

    tokens = sum(len(v) for v in engine.completed.values())
    lat = np.array(sorted(engine.latency_steps.values()), np.float64)
    p50 = float(np.percentile(lat, 50)) if len(lat) else float("nan")
    p99 = float(np.percentile(lat, 99)) if len(lat) else float("nan")
    preempts = sum(1 for e in engine.scheduler.events if e[0] == "preempt")
    leaked = engine.leaked_blocks()
    thash = trace_hash(engine)

    rows.row("serve/throughput", wall / max(tokens, 1), f"{tokens / wall:.1f} tok/s",
             tokens=tokens, wall_s=wall, arch=args.arch, seed=args.seed,
             requests=args.requests, completed=len(engine.completed),
             steps=engine.step_count)
    rows.row("serve/latency", wall / max(engine.step_count, 1),
             f"p50={p50:.0f} p99={p99:.0f} steps",
             p50_steps=p50, p99_steps=p99, preemptions=preempts,
             leaked_blocks=leaked, trace_sha256=thash,
             num_blocks=args.num_blocks, block_size=args.block_size,
             slots=args.slots)
    print(f"completed={len(engine.completed)}/{args.requests} "
          f"tokens={tokens} steps={engine.step_count} "
          f"preemptions={preempts} leaked={leaked}")
    print(f"trace_sha256={thash}")
    return dict(completed=dict(engine.completed), tokens=tokens, steps=engine.step_count,
                preemptions=preempts, leaked=leaked, p50=p50, p99=p99,
                trace_sha256=thash, wall_s=wall)


def smoke_check(args, result) -> list[str]:
    """The reference's serving-job invariants; the violated ones."""
    bad = []
    if not result["completed"]:
        bad.append("no requests completed")
    if result["leaked"]:
        bad.append(f"{result['leaked']} leaked blocks")
    if not np.isfinite(result["p99"]):
        bad.append("p99 latency not finite")
    if len(result["completed"]) != args.requests:
        bad.append(f"only {len(result['completed'])}/{args.requests} finished")
    return bad


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    rows = Rows(resolve_device(args.device))
    result = run(args, rows)
    rc = 0
    if args.smoke:
        bad = smoke_check(args, result)
        for b in bad:
            print(f"smoke: {b}")
        rc = 1 if bad else 0
        if not bad:
            print("smoke OK")
    if args.json:
        rows.emit_json(args.json)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
