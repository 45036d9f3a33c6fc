"""Render the dry run's JSON lines as tables (port of
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.shape_report cells.jsonl
    PYTHONPATH=src python -m repro_torch.launch.shape_report cells.jsonl --kind dryrun

The lines are ``launch.shape_run``'s cells: the reference's columns, with
"count" (the count's seconds) where the reference has the compile's, the
collectives a layer adds where it has the full HLO's, and a "fits" column
(the cell's ``total_per_device`` within the card's ``topology.HBM_BYTES``).
"""
from __future__ import annotations

import argparse
import json
from collections import OrderedDict


def _fmt_bytes(b):
    if b is None:
        return "-"
    if b >= 1e12:
        return f"{b/1e12:.2f}T"
    if b >= 1e9:
        return f"{b/1e9:.2f}G"
    return f"{b/1e6:.1f}M"


def load(paths):
    """{(arch, shape, mesh): cell} over the JSON lines of ``paths``; a later
    line of the same cell replaces an earlier one."""
    rows = OrderedDict()
    for path in paths:
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                r = json.loads(line)
                rows[(r["arch"], r["shape"], r.get("mesh", "?"))] = r
    return rows


def dryrun_table(rows) -> str:
    out = ["| arch | shape | mesh | count | bytes/dev (arg+tmp) | fits | collectives (per layer) | status |",
           "|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in rows.items():
        if "error" in r:
            out.append(f"| {arch} | {shape} | {mesh} | - | - | - | - | ERROR: {r['error'][:80]} |")
            continue
        if "skipped" in r:
            out.append(f"| {arch} | {shape} | {mesh} | - | - | - | - | skipped: {r['skipped'][:60]} |")
            continue
        mem = r.get("memory", {})
        argb = mem.get("argument_size_in_bytes")
        tmpb = mem.get("temp_size_in_bytes")
        coll = r.get("coll_counts_per_layer", {})
        cstr = " ".join(f"{k.split('-')[-1][:4]}:{v:g}" for k, v in coll.items() if v)
        fits = {True: "yes", False: "no"}.get(r.get("fits"), "-")
        out.append(
            f"| {arch} | {shape} | {mesh} | {r.get('count_s', '-')}s | "
            f"{_fmt_bytes(argb)}+{_fmt_bytes(tmpb)} | {fits} | {cstr} | OK |"
        )
    return "\n".join(out)


def roofline_table(rows) -> str:
    out = ["| arch | shape | T_comp | T_mem | T_coll | dominant | roofline frac | mem eff | useful FLOPs | dominant collective |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, mesh), r in rows.items():
        if mesh != "16x16" or "roofline" not in r:
            continue
        t = r["roofline"]
        kinds = r.get("coll_by_kind", {})
        top = max(kinds, key=kinds.get) if kinds else "-"
        out.append(
            f"| {arch} | {shape} | {t['compute_s']*1e3:.1f}ms | "
            f"{t['memory_s']*1e3:.1f}ms | {t['collective_s']*1e3:.1f}ms | "
            f"{t['dominant'].replace('_s', '')} | {t['roofline_fraction']:.3f} | "
            f"{t.get('memory_efficiency', 0):.2f} | "
            f"{r.get('useful_flops_ratio', 0):.2f} | "
            f"{top}:{_fmt_bytes(kinds.get(top, 0))} |"
        )
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("jsonl", nargs="+")
    ap.add_argument("--kind", choices=["dryrun", "roofline", "both"], default="both")
    args = ap.parse_args(argv)
    rows = load(args.jsonl)
    if args.kind in ("dryrun", "both"):
        print(dryrun_table(rows))
    if args.kind == "both":
        print()
    if args.kind in ("roofline", "both"):
        print(roofline_table(rows))


if __name__ == "__main__":
    main()
