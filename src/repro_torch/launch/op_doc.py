"""The op reference, generated from the port's dispatch table (port of
``repro.launch.docgen``).

    PYTHONPATH=src python -m repro_torch.launch.op_doc           # write docs/op-reference-torch.md
    PYTHONPATH=src python -m repro_torch.launch.op_doc --check   # exit 2 on drift

Per op: its implementations (``hopper/dispatch.py``), the plain forms'
default blocks (``dispatch.resolve_blocks``), the ``core.precision``
policies it takes, and its partition plan resolved on both production
meshes (``launch.mesh.production_mesh_spec``: 16 x 16 and 2 x 16 x 16),
with per-level collectives and the overlap column, at the operand shapes
of ``launch.op_cases.op_roofline_cases`` (the cases the op-roofline cells
price). The output is deterministic (sorted ops, no timestamps), so
``--check`` fails whenever the committed file lags the code.
"""
from __future__ import annotations

import argparse
import sys

OUT = "docs/op-reference-torch.md"

HEADER = """\
# Op reference (the PyTorch port)

<!-- GENERATED FILE - do not edit by hand.
     Regenerate with:  PYTHONPATH=src python -m repro_torch.launch.op_doc
     `python -m repro_torch.launch.op_doc --check` fails on drift. -->

Every op of `src/repro_torch/hopper/ops.py` dispatches along three axes:
**impl** (`cuda`, the hand-written Hopper kernel's wrapper; `torch`, the
plain form; `ref`, the naive oracle; resolved by
`dispatch.resolve_impl`), **block geometry** (the plain forms' tiles,
`dispatch.resolve_blocks`: explicit keyword > `set_block_override` >
table default; a CUDA kernel's tiles are constants of its source), and
**partitioning** (`hopper/partition.py`: the op's PartitionRule resolved
against the `mesh=` keyword or the `sharding.use_mesh` context).

The partition tables resolve each rule at the operand shapes of the
op-roofline cases (`launch/op_cases.py`) on the production meshes:
`data=16, model=16` and `pod=2, data=16, model=16`. `model` and `data`
are NVLink 4 axes (one NVLink-Switch domain of 256 cards), `pod` is the
card's InfiniBand NIC (`core/topology.py`).
"""


def _collectives_cell(plan) -> str:
    if plan is None:
        return "—"
    if not plan.collectives:
        return "none"
    # run-length encoded: a ring plan fires many identical per-hop permutes
    runs = []
    for c in plan.collectives:
        cell = f"{c.kind}@{c.axis}(n={c.n}, {c.nbytes} B)"
        if runs and runs[-1][0] == cell:
            runs[-1][1] += 1
        else:
            runs.append([cell, 1])
    return "; ".join(cell if count == 1 else f"{count}× {cell}" for cell, count in runs)


def _overlap_cell(plan) -> str:
    if plan is None or not plan.overlappable:
        return "—"
    return f"yes ({plan.hops} hops)"


def plan_rows(multi_pod: bool) -> list[tuple]:
    """(op, partition, levels, overlap, collectives) per registered op on
    the production mesh: the partition table's cells."""
    from repro_torch.hopper import dispatch, partition
    from repro_torch.hopper import ops as _ops  # noqa: F401  (registers the ops)
    from repro_torch.launch.mesh import production_mesh_spec
    from repro_torch.launch.op_cases import op_roofline_cases

    cases = {c[0]: c for c in op_roofline_cases()}
    mesh = production_mesh_spec(multi_pod)
    rows = []
    for op in dispatch.registered_ops():
        if op not in cases:
            rows.append((op, "(no representative case)", "", "", ""))
            continue
        _, args, kwargs, _, _ = cases[op]
        plan = partition.plan_for(op, mesh, *args, **kwargs)
        levels = ", ".join(f"{a}={n}" for a, n in plan.levels) if plan else "—"
        rows.append((op, plan.note if plan else "replicated", levels,
                     _overlap_cell(plan), _collectives_cell(plan)))
    return rows


def generate() -> str:
    """The op reference as markdown (deterministic)."""
    from repro_torch.core import precision
    from repro_torch.hopper import dispatch
    from repro_torch.hopper import ops as _ops  # noqa: F401  (registers the ops)

    lines = [HEADER, "## Dispatch table\n", "| op | impls | default blocks | precisions |",
             "|---|---|---|---|"]
    for op in dispatch.registered_ops():
        impls = ", ".join(dispatch.implementations(op))
        blocks = ", ".join(f"{k}={v}" for k, v in sorted(dispatch.resolve_blocks(op).items()))
        precs = ", ".join(precision.supported_policies(op))
        lines.append(f"| `{op}` | {impls} | {blocks} | {precs} |")
    lines.append("")
    lines.append(
        "Plain tensor entries outside the dispatch table (one impl, any device, "
        "no mesh): `linear_attention_step` (one token of the chunked scan, its "
        "decay floored as the scan's is) and `ssd_scan` / `ssd_step` (Mamba-2's "
        "scan with one scalar decay a head and token, exact: every decay factor "
        "is exp of a direct sum of dt A, never clamped; the scan chunked, "
        "`SSD_CHUNK` tokens and `SSD_HEADS` heads a pass).\n")
    lines.append(
        "The precisions column lists the `core/precision.py` policies each op "
        "takes through `precision=` (fp32 is the `precision=None` path; the "
        "others run the block-scaled kernels). An op listing only fp32 has no "
        "scaled path.\n")
    for multi_pod, title, tag in (
            (False, "Partitioning on the single-pod mesh (`data=16, model=16`)",
             "one level: `model`, NVLink"),
            (True, "Partitioning on the two-pod mesh (`pod=2, data=16, model=16`)",
             "two levels: pods (the NIC) above `model` (NVLink)")):
        lines.append(f"## {title}\n")
        lines.append(f"Plans resolve over {tag}.\n")
        lines.append("| op | partition plan | levels | overlap | collectives |")
        lines.append("|---|---|---|---|---|")
        for op, note, levels, overlap, coll in plan_rows(multi_pod):
            lines.append(f"| `{op}` | {note} | {levels} | {overlap} | {coll} |")
        lines.append("")
    lines.append(
        "The overlap column marks plans that run the double-buffered schedule "
        "(`overlap=True`, the default): hop t+1's transfer is issued before hop "
        "t's compute, so up to `hops - 1` transfers hide behind it "
        "(`roofline.overlapped_seconds`). `overlap=False` runs the synchronous "
        "schedule.\n")
    lines.append(
        "Collective cells read `kind@axis(n=ring size, payload bytes)`; `pod` "
        "entries are priced at the NIC's rate, the others at NVLink's "
        "(`core/topology.py::collective_seconds`). An op that resolves to fewer "
        "levels than the mesh offers walked the replication fallback ladder.\n")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--check", action="store_true",
                    help="exit 2 if the committed file is not what the code generates")
    args = ap.parse_args(argv)
    text = generate()
    if args.check:
        try:
            with open(args.out) as f:
                committed = f.read()
        except FileNotFoundError:
            print(f"op_doc --check: {args.out} does not exist; run "
                  f"`python -m repro_torch.launch.op_doc` and commit it", file=sys.stderr)
            return 2
        if committed != text:
            print(f"op_doc --check: {args.out} is stale; regenerate with "
                  f"`PYTHONPATH=src python -m repro_torch.launch.op_doc`", file=sys.stderr)
            return 2
        print(f"op_doc --check: {args.out} is up to date")
        return 0
    with open(args.out, "w") as f:
        f.write(text)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
