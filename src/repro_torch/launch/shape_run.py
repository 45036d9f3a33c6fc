"""Shape-only runs on the production mesh: the per-op roofline cells
(port of ``repro.launch.dryrun``'s ``op_roofline_cells`` and its
``--op-roofline`` CLI).

    PYTHONPATH=src python -m repro_torch.launch.shape_run --op-roofline
    PYTHONPATH=src python -m repro_torch.launch.shape_run --op-roofline --multi-pod --precision fp8

Each cell resolves one op case (``launch.op_cases``) against the
device-free production mesh (``launch.mesh.production_mesh_spec``: 16 x 16
``data`` x ``model``, or 2 x 16 x 16 with ``pod``) and prices it at the
card's constants (``launch.roofline``): compute, memory and the plan's
collectives per mesh level. Importing this module sets no environment
variable and touches no device; the cells allocate nothing (``meta``
operands).

The XLA-compiling half of the reference's dry run (``lower_cell``, its
cost extraction and extrapolation) has no counterpart yet.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.core import precision as prec
from repro_torch.hopper import partition
from repro_torch.launch import roofline
from repro_torch.launch.mesh import production_mesh_spec
from repro_torch.launch.op_cases import op_roofline_cases


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op-roofline", action="store_true",
                    help="emit the per-op D2D-costed roofline cells and exit")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2 x 16 x 16 pod x data x model mesh (default 16 x 16)")
    ap.add_argument("--precision", default=None, choices=("fp32", "bf16", "fp8", "fp8_e5m2"),
                    help="price the cells under this core.precision policy")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    args = ap.parse_args(argv)
    if not args.op_roofline:
        ap.error("only --op-roofline is ported: the XLA-compiling cells have no counterpart")
    for cell in op_roofline_cells(multi_pod=args.multi_pod, precision=args.precision):
        line = json.dumps(cell)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
