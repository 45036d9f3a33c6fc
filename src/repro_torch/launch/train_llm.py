"""Train a ~100M-parameter GPT-J-family LM on the full stack (port of
``examples/train_llm.py``): the data stream, AdamW, checkpoints, the
straggler monitor and a crash with restart.

    PYTHONPATH=src python -m repro_torch.launch.train_llm            # ~200 steps, cuda
    PYTHONPATH=src python -m repro_torch.launch.train_llm --steps 50 --device cpu

A crash is injected mid-run (at ``--crash-at``, default half the steps);
the run restarts from the last checkpoint (every 25 steps) and
finishes. The checkpoints go to a temporary directory, removed at the end.
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.runtime import train_loop
from repro_torch.runtime.fault_tolerance import FailureInjector

# ~100M params: 12L x d512 x ffn2048, vocab 32k (fp32, as the reference's)
CFG = get_config("occamy-gptj", reduced=True).replace(
    name="gptj-100m",
    num_layers=12,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    learning_rate=1e-3,
    warmup_steps=20,
)
CKPT_EVERY = 25


def first_loss(batch=4, seq=128, *, device=None):
    """The loss the first step takes: the seeded initial state on the
    (seed 0, step 0) batch."""
    import torch

    from repro_torch.data.synthetic import batch_at_step
    from repro_torch.models import registry

    state = train_loop.init_train_state(CFG, 0, device=device)
    b = batch_at_step(CFG, SHAPES["train_4k"], 0, 0, batch, seq)
    dev = state["opt"]["step"].device
    with torch.no_grad():
        return float(registry.loss_fn(state["params"], CFG,
                                      {k: torch.from_numpy(v).to(dev) for k, v in b.items()}))


def run(steps=200, batch=4, seq=128, crash_at=None, *, device=None, log_fn=print):
    """Train with a crash at ``crash_at`` (default ``steps // 2``), then
    restart from the last checkpoint and finish. Returns (the resumed
    run's losses, the final state)."""
    crash_at = crash_at if crash_at is not None else steps // 2
    ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_llm_")
    kw = dict(num_steps=steps, batch_override=batch, seq_override=seq, ckpt_dir=ckpt_dir,
              ckpt_every=CKPT_EVERY, log_every=10, log_fn=log_fn, device=device)
    try:
        try:
            train_loop.run_training(CFG, SHAPES["train_4k"],
                                    failure_injector=FailureInjector({crash_at: "crash"}), **kw)
        except RuntimeError as e:
            log_fn(f"[fault] {e} -> restarting from checkpoint")
        state, losses, _ = train_loop.run_training(CFG, SHAPES["train_4k"], **kw)
        log_fn(f"finished after restart: final loss {losses[-1]:.4f} "
               f"({len(losses)} post-restart steps)")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return losses, state


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    print(f"model: {CFG.name}  params ~{CFG.num_params() / 1e6:.0f}M  steps {args.steps}")
    return run(args.steps, args.batch, args.seq, args.crash_at, device=args.device)


if __name__ == "__main__":
    main()
