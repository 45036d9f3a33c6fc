"""Training launcher (port of ``repro.launch.train``).

On the card, at full width with random weights from ``--seed``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba-1.5b \\
        --steps 6 --batch 2 --seq 2048 --ckpt-dir ckpt --ckpt-every 3

On the CPU, at the REDUCED config:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --arch gemma-2b --steps 20 --batch 4 --seq 32

``--mesh DxM`` trains on a ``data`` x ``model`` ``DeviceMesh`` of D * M
ranks on ``--device`` (on one card every rank shares it and has its own
stream), through ``run_training(mesh=)``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --reduced --arch phi3.5-moe-42b-a6.6b --mesh 2x2 --steps 3 \\
        --batch 4 --seq 32

The flags are the reference's, with three differences: the default is
full width on ``cuda`` (``--reduced`` opts in to the REDUCED config, where
the reference's ``--reduced`` is always on), ``--device`` picks the
device, and ``--log-every`` sets the loop's log interval.
``--inject-crash-at N`` crashes the run at step N; the launcher then exits
42, and the same command resumes from the last checkpoint.
"""
from __future__ import annotations

import argparse

from repro_torch.configs.base import SHAPES, get_config
from repro_torch.parallel.mesh import DeviceMesh
from repro_torch.runtime import train_loop
from repro_torch.runtime.fault_tolerance import FailureInjector

CRASH_EXIT = 42


def main(argv=None):
    """Parse ``argv`` and train; returns (state, losses, monitor), or exits
    ``CRASH_EXIT`` at an injected crash."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--mesh", default=None, help="e.g. 1x1 / 4x2 (data x model)")
    ap.add_argument("--inject-crash-at", type=int, default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    mesh = None
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        mesh = DeviceMesh({"data": d, "model": m}, device=args.device)
    injector = (FailureInjector({args.inject_crash_at: "crash"})
                if args.inject_crash_at else None)
    try:
        state, losses, monitor = train_loop.run_training(
            cfg, SHAPES[args.shape], mesh,
            num_steps=args.steps,
            seed=args.seed,
            ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every,
            batch_override=args.batch,
            seq_override=args.seq,
            microbatches=args.microbatches,
            grad_compression=args.grad_compression,
            failure_injector=injector,
            log_every=args.log_every,
            device=args.device,
        )
    except RuntimeError as e:
        if not str(e).startswith("injected crash"):
            raise
        print(f"[fault] {e} — restart this command to resume from checkpoint")
        raise SystemExit(CRASH_EXIT) from e
    if losses:
        print(f"done: {len(losses)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f},"
              f" straggle events {monitor.events}")
    return state, losses, monitor


if __name__ == "__main__":
    main()
