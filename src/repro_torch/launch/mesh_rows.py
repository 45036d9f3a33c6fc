"""Per-op sharded-vs-single rows (twin of ``benchmarks/bench_mesh.py``,
the paper's Fig. 13 made executable).

For every op with a PartitionRule, times the op once unsharded and once
over a ``DeviceMesh`` (``--mesh DxM`` or ``--mesh PxDxM``), with the same
``ops.*`` call and the mesh passed as ``mesh=``, on the reference bench's
operands (its numpy draws, in its order, from seed 0). Each row carries
the sharded wall, the single wall, the speedup, the plan's levels and
note, and the max error of the sharded output against the single one.
Two rows more flip only the schedule of the ops that overlap transfers
with compute (the long-context flash ring and the halo stencil): overlap
against sync.

Each sharded row also carries the reference's roofline columns at the
card's link constants (``launch/roofline.py``): the plan's collective
seconds in total (``d2d_model``) and per mesh level (``coll_per_level``);
each overlap row the plan's total and the pipeline model's time
(``model_overlapped_us``: the sync wall less the modelled transfers,
overlapped over the plan's hops).

On one card every rank is a stream of the same device: the ranks share
its SMs and its memory, so a sharded call pays for its copies and
collectives and gains nothing; the rows pin numerical agreement and the
plans, and time what the layer costs.

    PYTHONPATH=src python -m repro_torch.launch.mesh_rows --mesh 2x2x2   # on the card
    PYTHONPATH=src python -m repro_torch.launch.mesh_rows --mesh 2x4 --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import sparse
from repro_torch.hopper import dispatch, ops, partition
from repro_torch.launch import roofline
from repro_torch.launch.bench_rows import Rows, timeit
from repro_torch.launch.mesh import host_device_mesh


def _cases(rng, device):
    """(label, op, call(mesh) -> out, plan_args, plan_kwargs) rows, the
    reference's ``_cases`` on ``device``."""
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    a, b = t((256, 256)), t((256, 256))
    q, k, v = t((4, 8, 256, 64)), t((4, 8, 256, 64)), t((4, 8, 256, 64))
    # long context: B=1 blocks the batch split, so the data axis carries the
    # sequence (the ring seq-parallel row)
    qL, kL, vL = t((1, 8, 2048, 64)), t((1, 4, 2048, 64)), t((1, 4, 2048, 64))
    qd, kd, vd = t((8, 8, 64)), t((8, 8, 512, 64)), t((8, 8, 512, 64))
    pos = torch.full((8,), 511, dtype=torch.int32, device=device)
    r = t((1, 8, 512, 32))
    wl = -rng.uniform(0.01, 1.0, (1, 8, 512, 32))
    wl = torch.from_numpy(wl.astype(np.float32)).to(device)
    ell = sparse.random_ell(rng, 1024, 1024, 0.02).to(device)
    dn = t((1024, 64))
    bsr_dense = np.zeros((128, 1024), np.float32)
    bsr_dense[::2, ::9] = 1.0
    bsrA = sparse.dense_to_bsr(bsr_dense, bm=8, bk=128).to(device)
    brhs = t((1024, 64))
    sA = sparse.random_ell(rng, 256, 512, 0.05).to(device)
    sB = sparse.random_ell(rng, 256, 512, 0.05).to(device)
    grid = t((64, 32, 32))
    offs = np.array([(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1)], np.int32)
    w = np.full((5,), 0.2, np.float32)
    return [
        ("gemm", "gemm", lambda m: ops.gemm(a, b, mesh=m), (a, b), {}),
        ("flash_attention", "flash_attention",
         lambda m: ops.flash_attention(q, k, v, mesh=m), (q, k, v), {}),
        ("flash_attention_long", "flash_attention",
         lambda m: ops.flash_attention(qL, kL, vL, mesh=m), (qL, kL, vL), {}),
        ("decode_attention", "decode_attention",
         lambda m: ops.decode_attention(qd, kd, vd, pos, mesh=m), (qd, kd, vd, pos), {}),
        ("linear_attention", "linear_attention",
         lambda m: ops.linear_attention(r, r, r, wl, mesh=m)[0], (r, r, r, wl), {}),
        ("spmm", "spmm", lambda m: ops.spmm(ell, dn, mesh=m), (ell.values, ell.cols, dn), {}),
        ("bsr_spmm", "bsr_spmm", lambda m: ops.bsr_spmm(bsrA, brhs, mesh=m),
         (bsrA.tile_values, bsrA.tile_rows, bsrA.tile_cols, brhs),
         {"num_rows": bsrA.shape[0]}),
        ("spmspm", "spmspm", lambda m: ops.spmspm(sA, sB, 512, mesh=m),
         (sA.values, sA.cols, sB.values, sB.cols), {"contraction_dim": 512}),
        ("stencil", "stencil", lambda m: ops.stencil(grid, offs, w, mesh=m), (grid,),
         {"offsets": offs, "weights": w}),
    ]


def _overlap_cases(rng, device):
    """(label, op, call(mesh, overlap) -> out, plan_args, plan_kwargs) for
    the ops with an overlappable schedule: the long-context flash ring and
    the halo stencil (the reference's ``_overlap_cases``)."""
    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    qL, kL, vL = t((1, 8, 2048, 64)), t((1, 4, 2048, 64)), t((1, 4, 2048, 64))
    grid = t((64, 32, 32))
    offs = np.array([(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, 0, 1)], np.int32)
    w = np.full((5,), 0.2, np.float32)
    return [
        ("flash_attention_long", "flash_attention",
         lambda m, ov: ops.flash_attention(qL, kL, vL, mesh=m, overlap=ov), (qL, kL, vL), {}),
        ("stencil", "stencil", lambda m, ov: ops.stencil(grid, offs, w, mesh=m, overlap=ov),
         (grid,), {"offsets": offs, "weights": w}),
    ]


def _max_err(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def run(mesh, *, rows: Rows | None = None, reps: int = 3) -> Rows:
    """Every row on ``mesh`` (operands on its rank 0's device); returns the
    ``Rows``, each also printed as a CSV line."""
    device = mesh.devices[0]
    rows = Rows(device) if rows is None else rows
    rng = np.random.default_rng(0)
    levels = partition.partition_levels(mesh)
    levels_tag = "*".join(f"{a}{n}" for a, n in levels) or "none"
    for label, op, call, plan_args, plan_kwargs in _cases(rng, device):
        plan = partition.plan_for(op, mesh, *plan_args, **plan_kwargs)
        note = plan.note.replace(",", ";") if plan else "replicated"
        by_level = roofline.plan_collective_seconds_by_level(plan)
        d2d = sum(by_level.values())
        per_level = "/".join(f"{ax}={s * 1e6:.2f}us" for ax, s in by_level.items()) or "none"
        with torch.no_grad():
            t_single = timeit(call, None, device=device, reps=reps)
            t_shard = timeit(call, mesh, device=device, reps=reps)
            err = _max_err(call(mesh), call(None))
        rows.row(
            f"mesh_{label}", t_shard,
            f"single_us={t_single * 1e6:.1f};speedup={t_single / t_shard:.2f}x;"
            f"levels={levels_tag};{note};"
            f"d2d_model={d2d * 1e6:.2f}us;coll_per_level={per_level};max_err={err:.1e}",
            op=op, mesh=levels_tag, impl=dispatch.resolve_impl(op), overlap=None,
            single_us=t_single * 1e6, d2d_model_s=d2d, coll_per_level_s=by_level,
            max_err=err, note=note,
        )
    for label, op, call, plan_args, plan_kwargs in _overlap_cases(rng, device):
        plan = partition.plan_for(op, mesh, *plan_args, **plan_kwargs)
        if plan is None or not plan.overlappable:
            continue
        d2d = roofline.plan_collective_seconds(plan)
        with torch.no_grad():
            t_sync = timeit(call, mesh, False, device=device, reps=reps)
            t_ovl = timeit(call, mesh, True, device=device, reps=reps)
            err = _max_err(call(mesh, True), call(mesh, False))
        ovl_s = roofline.overlapped_seconds(max(t_sync - d2d, 0.0), d2d, plan.hops)
        rows.row(
            f"mesh_overlap_{label}", t_ovl,
            f"sync_us={t_sync * 1e6:.1f};hops={plan.hops};d2d_model={d2d * 1e6:.2f}us;"
            f"model_overlapped_us={ovl_s * 1e6:.1f};max_err={err:.1e}",
            op=op, mesh=levels_tag, impl=dispatch.resolve_impl(op), overlap=True,
            sync_us=t_sync * 1e6, hops=plan.hops, d2d_model_s=d2d,
            model_overlapped_s=ovl_s, max_err=err,
        )
    return rows


def parse_mesh(spec: str, *, device=None):
    """``"DxM"`` as ``(data, model)`` or ``"PxDxM"`` as ``(pod, data,
    model)``, every rank on ``device`` (default the first card's streams;
    raises without a card unless ``device="cpu"``)."""
    sizes = [int(s) for s in spec.lower().split("x")]
    if len(sizes) not in (2, 3) or min(sizes) < 1:
        raise ValueError(f"--mesh takes DxM or PxDxM, got {spec!r}")
    pods = sizes[0] if len(sizes) == 3 else 1
    return host_device_mesh(tp=sizes[-1], pods=pods, n=int(np.prod(sizes)), device=device)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mesh", default="2x2x2", help="DxM or PxDxM (default 2x2x2)")
    p.add_argument("--device", default=None, help="default cuda; cpu runs here")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--json", default=None, help="write the rows as JSON to this path")
    args = p.parse_args(argv)
    mesh = parse_mesh(args.mesh, device=args.device)
    rows = run(mesh, reps=args.reps)
    if args.json:
        rows.emit_json(args.json)


if __name__ == "__main__":
    main()
