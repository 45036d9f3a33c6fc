"""The benchmark harness (port of ``benchmarks/run.py``): every bench
twin's rows as ``name,us_per_call,derived`` CSV, in the reference's order
(gemm, precision, stencil, spmm, spmspm, gcn, gptj, d2d) and with its row
names, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.bench_run [--device cpu] [--json rows.json]

``--autotune`` runs ``launch.block_search`` first: a record at
``--autotune-record`` that matches this backend, impl and mesh is loaded,
else the search runs (``DEFAULT_SUITE``, ``--autotune-reps``,
``--autotune-budget`` candidates a case) and saves one; the record is
applied, its tuned-against-default times print as ``autotune_<op>`` rows,
and the benches run under it. ``--autotune-only`` stops there.
``--mesh DxM`` or ``PxDxM`` adds the sharded-against-single rows
(``launch.mesh_rows``, every rank on one card's streams; ``--mesh-only``
stops there). ``--impl`` pins the dispatch impl (the reference's
``REPRO_BENCH_IMPL``); ``--json PATH`` writes every row as JSON
(``Rows.emit_json``) on every exit path.
"""
from __future__ import annotations

import argparse
import os

import torch

from repro_torch.hopper import dispatch
from repro_torch.launch.bench_rows import Rows, timeit

# the reference's precision rows name its impls: the plain form is its
# ``xla``, the kernel its ``interpret`` (the Pallas body)
PRECISION_IMPLS = (("torch", "xla"), ("cuda", "interpret"))
# benchmarks/bench_{stencil,spmm,spmspm}.py's own sizes
SPARSE_BENCH = dict(spmm=(1024, 2048, 256), spmspm=(512, 512, 2048), grid_2d=(64, 64, 1),
                    grid_3d=(16, 16, 16))


def autotune_rows(rows: Rows, *, device, record_path: str, reps: int, budget: int | None,
                  mesh=None) -> dict:
    """Load the record at ``record_path`` if it matches this session, else
    search and save one; apply it; one ``autotune_<op>`` row an entry.
    Returns the record."""
    from repro_torch.launch import block_search as bs

    record, source = None, "loaded"
    if os.path.exists(record_path):
        record = bs.load_record(record_path)
        if not bs.record_matches_environment(record, mesh=mesh, device=device):
            record = None  # tuned elsewhere: search again rather than mistune
    if record is None:
        record = bs.autotune(reps=reps, mesh=mesh, trial_budget=budget, device=device)
        bs.save_record(record, record_path)
        source = "searched"
    bs.apply_record(record, mesh=mesh, device=device)
    for op, d in sorted(bs.record_deltas(record).items()):
        delta = "n/a" if d["delta_pct"] is None else f"{d['delta_pct']:+.1f}%"
        default_us = "n/a" if d["default_us"] is None else f"{d['default_us']:.1f}"
        tuned_us = "n/a" if d["us_per_call"] is None else f"{d['us_per_call']:.1f}"
        blocks = "/".join(f"{k}={v}" for k, v in sorted(d["blocks"].items()))
        derived = f"default_us={default_us};delta={delta};blocks={blocks};{source}"
        print(f"autotune_{op},{tuned_us},{derived}", flush=True)
        rows.json_rows.append({"name": f"autotune_{op}", "us_per_call": d["us_per_call"],
                               "derived": derived, "op": op, "default_us": d["default_us"],
                               "blocks": d["blocks"], "default_blocks": d["default_blocks"],
                               "source": source})
    return record


def precision_rows(rows: Rows, *, device):
    """``benchmarks/bench_precision.py``'s rows: every op under every
    policy through the plain form and the kernel (``launch.precision_ladder``
    at the bench's sizes), GFLOP/s beside the card's peak for the policy
    and the error against the fp32 oracle."""
    from repro_torch.core import precision
    from repro_torch.launch import precision_ladder as pl

    cases = pl.make_cases(pl.BENCH)
    runs = {impl: pl.run(device=device, cases=cases, impl=impl) for impl, _ in PRECISION_IMPLS}
    for i in range(len(runs["torch"])):  # the bench's order: op, policy, then impl
        for impl, ref_name in PRECISION_IMPLS:
            r = runs[impl][i]
            peak = precision.peak_flops(r.policy)
            t = r.wall_ms / 1e3
            flops = r.gflops * 1e9 * t
            rows.row(f"precision_{r.op}_{r.policy}_{ref_name}", t,
                     f"{r.gflops:.2f} GFLOP/s;peak={peak / 1e12:.0f}TFLOP/s;"
                     f"max_err={r.max_err:.2e}",
                     op=r.op, impl=impl, precision=r.policy, flops=flops, flops_s=peak,
                     measured_flops_s=flops / t, max_err=r.max_err, rel_err=r.rel_err)


def sparse_rows(rows: Rows, *, device, seed: int = 0):
    """``benchmarks/bench_{stencil,spmm,spmspm}.py``'s rows at their sizes
    (``launch.sparse_la``'s cases), each the median of five warm calls."""
    from repro_torch.hopper import ops
    from repro_torch.launch import sparse_la

    cases = sparse_la.cases_to(sparse_la.make_cases(seed, sparse_la.Sizes(**SPARSE_BENCH)),
                               device)
    with torch.no_grad():
        for c in cases:
            t = timeit(getattr(ops, c.op), *c.args, device=device)
            note = "" if c.op == "spmspm" else f";{c.note}"
            rows.row(c.name, t, f"{c.work / t / 1e9:.2f} {c.unit}{note}", op=c.op)


def bench_rows(rows: Rows, *, device):
    """Every bench twin's rows, in ``benchmarks/run.py``'s order."""
    from repro_torch.launch import bench_rows as br
    from repro_torch.launch import d2d_rows, prefill_rate
    from repro_torch.parallel.mesh import DeviceMesh

    br.gemm_rows(rows, device=device)
    precision_rows(rows, device=device)
    sparse_rows(rows, device=device)
    br.gcn_rows(rows, device=device)
    prefill_rate.run(rows, device=device)
    d2d_rows.run(DeviceMesh({"pod": 1}, device=device), rows=rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--autotune", action="store_true",
                    help="tune first (or load the matching record)")
    ap.add_argument("--autotune-record", default="autotune_record.json")
    ap.add_argument("--autotune-reps", type=int, default=3)
    ap.add_argument("--autotune-budget", type=int, default=None, metavar="N",
                    help="time at most N candidates a case, in warm-start order "
                         "(the default always)")
    ap.add_argument("--autotune-only", action="store_true",
                    help="emit the autotune rows and stop")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write every row as JSON to PATH on exit")
    ap.add_argument("--mesh", default=None, metavar="DxM|PxDxM",
                    help="(data, model) or (pod, data, model) mesh on one card's streams for "
                         "the sharded-against-single rows")
    ap.add_argument("--mesh-only", action="store_true", help="emit the mesh rows and stop")
    ap.add_argument("--device", default=None, help="default cuda; cpu runs here")
    ap.add_argument("--impl", default=None, help="pin the dispatch impl (default: auto)")
    args = ap.parse_args(argv)
    if args.mesh_only and not args.mesh:
        raise SystemExit("--mesh-only needs --mesh DxM")

    from repro_torch.device import resolve_device

    device = resolve_device(args.device)
    rows = Rows(device)
    mesh = None
    if args.mesh:
        from repro_torch.launch.mesh_rows import parse_mesh

        mesh = parse_mesh(args.mesh, device=device)
    tune = args.autotune or args.autotune_only
    try:
        with dispatch.default_impl(args.impl), dispatch.saved_overrides():
            print("name,us_per_call,derived")
            if tune:
                autotune_rows(rows, device=device, record_path=args.autotune_record,
                              reps=args.autotune_reps, budget=args.autotune_budget, mesh=mesh)
                if args.autotune_only:
                    return
            if mesh is not None:
                from repro_torch.launch import mesh_rows

                mesh_rows.run(mesh, rows=rows)
                if args.mesh_only:
                    return
            bench_rows(rows, device=device)
    finally:
        if args.json:
            rows.emit_json(args.json)


if __name__ == "__main__":
    main()
