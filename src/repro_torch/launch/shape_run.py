"""Shape-only runs on the production mesh (port of ``repro.launch.dryrun``):
every (arch x shape x mesh) cell counted per device, and the per-op
roofline cells.

    PYTHONPATH=src python -m repro_torch.launch.shape_run --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.shape_run --both-meshes --out cells.jsonl
    PYTHONPATH=src python -m repro_torch.launch.shape_run --op-roofline --multi-pod --precision fp8

A cell (``count_cell``, the counterpart of ``lower_cell``) runs one step of
the config at the shape's global sizes on the device-free production mesh
(``launch.mesh.production_mesh_spec``: 16 x 16 ``data`` x ``model``, or
2 x 16 x 16 with ``pod``) under the counter of ``launch.step_count``,
which stands in for XLA's ``memory_analysis()``, ``cost_analysis()`` and
the HLO's collectives: the per-device memory (and whether it ``fits`` the
card's ``topology.HBM_BYTES``), FLOPs, HBM bytes and collective bytes,
priced at the card's constants (``launch.roofline``). One JSON line per
cell; a cell with an ``"error"`` key makes the exit code 1.

An op-roofline cell resolves one op case (``launch.op_cases``) against the
production mesh and prices it: compute, memory and the plan's collectives
per mesh level. Importing this module sets no environment variable and
touches no device; the cells allocate nothing (``meta`` tensors).
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.configs.base import SHAPES, all_arch_ids, get_config, shape_applicable
from repro_torch.core import precision as prec
from repro_torch.core import topology
from repro_torch.hopper import partition
from repro_torch.launch import roofline, step_count
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.launch.op_cases import op_roofline_cases


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def per_layer_counts(cfg, shape, mesh) -> dict:
    """Collectives a layer adds, by kind: the count at two layers less the
    count at one (the encoder cut with the decoder)."""
    def at(n):
        c = cfg.replace(num_layers=n, encoder_layers=n if cfg.encoder_layers else 0)
        return step_count.count_step(c, shape, mesh)["coll_counts"]

    one, two = at(1), at(2)
    return {k: float(two[k] - one[k]) for k in one}


def count_cell(arch: str, shape_name: str, multi_pod: bool, *, cfg_override=None,
               with_cost: bool = True) -> dict:
    """One (arch x shape x mesh) cell: the reference's ``lower_cell`` keys
    that carry over (``memory``, the per-device FLOPs, HBM and collective
    bytes, ``coll_by_kind``, ``coll_counts_per_layer``, ``roofline`` with
    ``memory_floor_s`` and ``memory_efficiency``, ``model_flops_*`` and
    ``useful_flops_ratio``), from ``step_count.count_step`` at full width
    and depth, plus ``count_s`` (the count's seconds) and ``fits``
    (``total_per_device <= topology.HBM_BYTES``). A shape the config does
    not run returns the reference's ``skipped`` cell; ``with_cost=False``
    keeps the memory only."""
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason,
                "mesh": mesh_name(multi_pod)}
    mesh = production_mesh_spec(multi_pod)
    n_dev = math.prod(mesh.shape.values())
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name(multi_pod),
              "devices": n_dev}
    t0 = time.time()
    c = step_count.count_step(cfg, shape, mesh)
    result["count_s"] = round(time.time() - t0, 2)
    result["memory"] = c["memory"]
    result["fits"] = c["memory"]["total_per_device"] <= topology.HBM_BYTES
    if not with_cost:
        return result
    terms = roofline.roofline_terms(c["flops"], c["hbm_bytes"], c["coll_bytes"])
    floor = roofline.min_bytes_per_device(cfg, shape, n_dev)
    terms["memory_floor_s"] = floor / roofline.HBM_BW
    terms["memory_efficiency"] = floor / c["hbm_bytes"] if c["hbm_bytes"] else 0.0
    mf = roofline.model_flops(cfg, shape)
    result.update({
        "flops_per_device": c["flops"],
        "hbm_bytes_per_device": c["hbm_bytes"],
        "coll_bytes_per_device": c["coll_bytes"],
        "coll_by_kind": c["coll_by_kind"],
        "coll_counts_per_layer": per_layer_counts(cfg, shape, mesh),
        "roofline": terms,
        "model_flops_global": mf,
        "model_flops_per_device": mf / n_dev,
        "useful_flops_ratio": (mf / n_dev) / c["flops"] if c["flops"] else 0.0,
    })
    return result


def op_roofline_cells(multi_pod: bool = False, precision=None) -> list[dict]:
    """Per-op D2D-costed rooflines on the production mesh: each partitioned
    op's compute and memory terms per device, and the seconds of the
    collectives its plan fires at each level it crosses
    (``collective_s_per_level``: ``model`` and ``data`` on NVLink, ``pod``
    on the pod link). The B = 1 long-context flash case rides the
    sequence-parallel KV ring, whose per-hop permutes price into the
    ``data`` level.

    ``precision`` names a ``core.precision`` policy: for each op with a
    scaled path the case's floating operands are recast to the policy's
    compute dtype, the analytic bytes repriced at the narrow width plus
    one fp32 scale per ``scale_block`` elements, the compute ceiling
    becomes ``precision.peak_flops``, and the plan resolves under the
    policy. Ops without a scaled path keep their cell and report
    ``precision: "fp32"``."""
    pol = prec.resolve(precision)
    mesh = production_mesh_spec(multi_pod)
    shape = mesh.shape
    out = []
    for op, args, kwargs, flops, nbytes in op_roofline_cases():
        peak = None
        applied = pol is not None and pol.name in prec.supported_policies(op)
        if applied:
            orig_isz = args[0].dtype.itemsize
            new_isz = pol.compute_dtype.itemsize
            args = tuple(
                torch.empty(a.shape, dtype=pol.compute_dtype, device="meta")
                if a.dtype.is_floating_point else a
                for a in args
            )
            kwargs = dict(kwargs, precision=pol)
            elems = nbytes / orig_isz
            nbytes = elems * new_isz + (
                (elems / pol.scale_block) * 4 if pol.scale_block else 0.0
            )
            peak = prec.peak_flops(pol)
        plan = partition.plan_for(op, mesh, *args, **kwargs)
        n = plan.n if plan else 1
        by_level = roofline.plan_collective_seconds_by_level(plan)
        d2d = sum(by_level.values())
        terms = roofline.roofline_terms(flops / n, nbytes / n, 0.0, d2d_s=d2d,
                                        peak_flops=peak)
        cell = {
            "op": op,
            "mesh": "x".join(str(s) for s in shape.values()),
            "partition": plan.note if plan else "replicated",
            "partition_levels": [f"{a}={ln}" for a, ln in plan.levels] if plan else [],
            "devices_used": n,
            "flops_per_device": flops / n,
            "bytes_per_device": nbytes / n,
            "d2d_bytes": partition.plan_collective_bytes(plan),
            "collective_s_per_level": by_level,
            "oi_flops_per_byte": flops / nbytes if nbytes else 0.0,
            "roofline": terms,  # serial model: every transfer waits
            "overlappable": bool(plan and plan.overlappable),
        }
        if pol is not None:
            cell["precision"] = pol.name if applied else "fp32"
        if plan is not None and plan.overlappable and plan.hops > 1:
            # beside the serial cell: per-hop D2D hidden behind per-hop
            # compute, only the exposed remainder binds
            ov = roofline.overlapped_terms(flops / n, nbytes / n, 0.0, d2d, plan.hops,
                                           peak_flops=peak)
            cell["roofline_overlapped"] = ov
            cell["overlap"] = {
                "hops": plan.hops,
                "serial_s": ov["serial_s"],
                "overlapped_s": ov["overlapped_s"],
                "d2d_exposed_s": ov["d2d_exposed_s"],
            }
        out.append(cell)
    return out


def _emit(res: dict, out):
    line = json.dumps(res)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 pod x data x model mesh (default 16 x 16)")
    ap.add_argument("--both-meshes", action="store_true", help="each cell on both meshes")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    ap.add_argument("--no-cost", action="store_true",
                    help="memory and fits only (no roofline terms)")
    ap.add_argument("--op-roofline", action="store_true",
                    help="emit the per-op D2D-costed roofline cells and exit")
    ap.add_argument("--precision", default=None, choices=("fp32", "bf16", "fp8", "fp8_e5m2"),
                    help="price the --op-roofline cells under this core.precision policy")
    args = ap.parse_args(argv)
    if args.op_roofline:
        for cell in op_roofline_cells(multi_pod=args.multi_pod, precision=args.precision):
            _emit(cell, args.out)
        return 0
    archs = [args.arch] if args.arch else all_arch_ids()
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    res = count_cell(arch, shape, mp, with_cost=not args.no_cost)
                except Exception as e:  # a failure here is a fault of the port
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name(mp),
                           "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                _emit(res, args.out)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
