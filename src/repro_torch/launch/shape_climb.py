"""Re-count one dry-run cell with config overrides and report each
roofline term's change against the cell as configured (port of
``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.shape_climb --arch phi3.5-moe-42b-a6.6b \\
        --shape train_4k --set tp_reduce_bf16=True --set microbatches=2

Each ``--set k=v`` is a ``ModelConfig.replace`` keyword (ints, floats,
``True``/``False``, else a string). The cell is ``shape_run.count_cell``
on the 16 x 16 mesh; ``deltas`` holds, for each roofline term and each
per-device count, the overridden cell's value less the baseline's.
``--skip-full`` leaves the memory section out (the reference skips its
full-depth compile there; the port's count is one run either way). The
reference's ``--autotune-record`` (apply a block-size tuning record first)
waits for the port's autotuner and is refused here.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import get_config
from repro_torch.launch.shape_run import count_cell

TERMS = ("compute_s", "memory_s", "collective_s")
COUNTS = ("flops_per_device", "hbm_bytes_per_device", "coll_bytes_per_device")


def parse_override(kv: str):
    k, v = kv.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def climb(arch: str, shape: str, overrides: dict, *, skip_full: bool = False) -> dict:
    """The cell under ``overrides`` with ``overrides``, ``baseline`` (the
    roofline terms and counts as configured) and ``deltas``."""
    base = count_cell(arch, shape, False)
    res = count_cell(arch, shape, False, cfg_override=get_config(arch).replace(**overrides))
    res["overrides"] = overrides
    if "roofline" in res and "roofline" in base:
        res["baseline"] = {**{t: base["roofline"][t] for t in TERMS},
                           **{c: base[c] for c in COUNTS}}
        res["deltas"] = {**{t: res["roofline"][t] - base["roofline"][t] for t in TERMS},
                         **{c: res[c] - base[c] for c in COUNTS}}
    if skip_full:
        res.pop("memory", None)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="config overrides, e.g. tp_reduce_bf16=True")
    ap.add_argument("--skip-full", action="store_true",
                    help="leave the memory section out")
    ap.add_argument("--autotune-record", default=None,
                    help="not ported: waits for the autotuner")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.autotune_record:
        ap.error("--autotune-record waits for the port's autotuner (ROADMAP item 3)")
    overrides = dict(parse_override(s) for s in args.set)
    line = json.dumps(climb(args.arch, args.shape, overrides, skip_full=args.skip_full))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
