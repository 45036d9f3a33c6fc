"""One run of one cell of the PyTorch/CUDA port's benchmark.

    python portbench/run.py --workload gptj.prefill --seed 7 --seconds 30 --trace 0

The cell, its configuration and its traffic mix come from ``BENCHMARK.json``
at the checkout's root. Set-up (``setup_s``) runs from the start of this
script to the start of the window; the window lasts ``--seconds``; with
``--trace 1`` a traced slice follows it and the per-layer metrics are
reported in place of the end-to-end ones. The last line of standard output
is the result, one JSON object; the numbers compared with the reference,
each beside its limit, close both it and standard error.

Exits 2 without a result where there is no CUDA card (or fewer than the
cell asks for), and 3 where the port cannot be imported from ``src/`` or
JAX, ``jaxlib``, ``flax`` or the JAX package ``repro`` has been loaded.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def fail(code: int, message: str):
    print(f"portbench: {message}", file=sys.stderr)
    sys.exit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the program's kernel caches at fixed paths inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.lib import harness
    from portbench.lib import manifest as mf

    cell = mf.cell(mf.load_manifest(ROOT), args.workload, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail(2, "no CUDA card: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(2, f"{args.workload} asks for {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(3, f"the port (src/repro_torch) is not in {ROOT}")
    torch.set_num_threads(2)
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device=torch.device("cuda", 0), t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        fail(3, f"JAX or the JAX package was loaded: {', '.join(loaded)}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
