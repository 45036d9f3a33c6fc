"""The readings that each limit of ``correct`` is set from, on the card.

    python portbench/control.py --workload gptj.prefill --seeds 11,12,13 \\
        --control-seeds 31,32,33 --seconds 30 [--out readings.jsonl]

In one process, for each of ``--seeds``, one run of the cell as
``run.py`` makes it (set-up, the window, the comparison): its numbers are
the lower readings. For each of ``--control-seeds`` the same run, with the
configuration's ``control`` (the reference in the precision below the
configuration's) judged in the program's place: its numbers are the upper
readings. One JSON line a run, on standard output and, with ``--out``,
appended to that file. A benchmark run never runs the control.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from portbench.lib import harness
    from portbench.lib import manifest as mf

    if not torch.cuda.is_available():
        print("portbench: no CUDA card", file=sys.stderr)
        return 2
    cell = mf.cell(mf.load_manifest(ROOT), args.workload, ROOT)
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), cell.config["control"]) for s in args.control_seeds.split(",") if s]
    for seed, control in runs:
        t0 = time.perf_counter()
        r = harness.run_cell(cell, seed=seed, seconds=args.seconds, trace=False,
                             device=torch.device("cuda", 0), t0=t0, control=control)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "side": control or "program", **r})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
