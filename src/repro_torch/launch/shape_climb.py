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
full-depth compile there; the port's count is one run either way).
``--autotune-record PATH`` applies a tuning record of
``launch.block_search`` first (the count reads the block sizes through
``dispatch.resolve_blocks``) and attaches its tuned-against-default
deltas under ``autotune``; a record tuned for another backend, impl or
mesh is refused.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import get_config
from repro_torch.hopper import dispatch
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


def climb_with_record(arch: str, shape: str, overrides: dict, record_path: str | None, *,
                      skip_full: bool = False) -> dict:
    """``climb`` with the tuning record at ``record_path`` applied (no
    search) for the counts, and its ``record_deltas`` under ``autotune``;
    the override tables return to what they held afterwards."""
    if record_path is None:
        return climb(arch, shape, overrides, skip_full=skip_full)
    from repro_torch.launch import block_search

    record = block_search.load_record(record_path)
    with dispatch.saved_overrides():
        block_search.apply_record(record)  # deterministic: no re-search
        res = climb(arch, shape, overrides, skip_full=skip_full)
    res["autotune"] = block_search.record_deltas(record)
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
                    help="apply a tuning record (launch.block_search) before counting and "
                         "attach its tuned-against-default deltas")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    overrides = dict(parse_override(s) for s in args.set)
    line = json.dumps(climb_with_record(args.arch, args.shape, overrides, args.autotune_record,
                                        skip_full=args.skip_full))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
