"""The D2D-link rows of the paper's Fig. 13 (twin of
``benchmarks/bench_d2d.py``), at the card's pod-link constant.

The D2D link's counterpart is the ``pod`` axis: one InfiniBand NIC a card
(``core.topology.POD_LINK_BW``, a datasheet figure).

- **Fig. 13a**, lane disabling: the link's rate falls linearly with the
  lanes left (38 PHYs in the paper), the elastic re-mesh's contract
  (throughput follows the surviving data-parallel ranks). Analytic.
- **Fig. 13b**, transfer size: a per-hop latency plus the bytes over the
  link's rate, from the latency-bound to the bandwidth-bound regime.
  Analytic.
- **The pod all-reduce**: with more than one rank, measured through
  ``parallel.collectives.hierarchical_psum`` over a one-axis ``pod``
  ``DeviceMesh`` of all the ranks, the ring model's time beside it; with
  one rank, the ring model alone for two pods (tagged analytic-only).

On one card every rank is a stream of the same device: the measured rows
say what the single-controller all-reduce costs there, not what a pod
link does, and are tagged so.

    PYTHONPATH=src python -m repro_torch.launch.d2d_rows --ranks 4         # on the card
    PYTHONPATH=src python -m repro_torch.launch.d2d_rows --ranks 4 --device cpu
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core.topology import POD_LINK_BW, collective_seconds
from repro_torch.launch.bench_rows import Rows, timeit
from repro_torch.parallel.collectives import hierarchical_psum
from repro_torch.parallel.mesh import DeviceMesh

LINK_LATENCY = 1e-6  # per-hop launch overhead (the paper's 61-cycle analogue)
LANES = 38
ALLREDUCE_MBYTES = (1, 4, 16)  # per-rank buffers of the measured rows
ANALYTIC_GBYTES = (0.1, 1.0, 2.45)  # up to grok-1's per-device parameters


def _measured_allreduce_rows(mesh: DeviceMesh, rows: Rows, reps: int):
    """``hierarchical_psum`` over every rank of ``mesh`` (one ``pod`` axis)
    at each per-rank buffer size, with the ring model's time beside it."""
    n = mesh.n
    device = mesh.devices[0]
    tag = ("ranks on one card's streams" if len(set(mesh.devices)) == 1
           else f"{len(set(mesh.devices))} cards")
    levels = (("pod", n),)
    for mbytes in ALLREDUCE_MBYTES:
        per_rank = mbytes * (1 << 20)
        parts = mesh.shard(torch.ones(n * (per_rank // 4), dtype=torch.float32,
                                      device=device), 0)
        t = timeit(lambda: hierarchical_psum(parts, mesh, levels), device=device, reps=reps)
        model = collective_seconds("all_reduce", per_rank, "pod", n)
        eff = 2 * per_rank * (n - 1) / n / t  # the ring's bytes, over the measured time
        rows.row(
            f"fig13b_pod_allreduce_{mbytes}MBx{n}", t,
            f"{eff / 1e9:.2f} GB/s measured;model={model * 1e6:.1f}us;"
            f"model_bw={POD_LINK_BW / 1e9:.0f}GB/s;{tag}",
            model_s=model, ranks=n, measured_on=tag,
        )


def run(mesh: DeviceMesh, *, rows: Rows | None = None, reps: int = 3) -> Rows:
    """Every row; the all-reduce rows measured on ``mesh`` (a one-axis
    ``pod`` mesh) when it has more than one rank, analytic when it has one.
    Returns the ``Rows``, each also printed as a CSV line."""
    if tuple(mesh.axis_names) != ("pod",):
        raise ValueError(f"d2d_rows: the all-reduce runs over a one-axis pod mesh, got {mesh}")
    rows = Rows(mesh.devices[0]) if rows is None else rows
    for disabled in (0, 8, 16, 24):
        frac = (LANES - disabled) / LANES
        rows.row(f"fig13a_d2d_disable_{disabled}", LINK_LATENCY,
                 f"{frac * POD_LINK_BW / 1e9:.2f} GB/s;linear_frac={frac:.2f}",
                 model_bw=frac * POD_LINK_BW)
    for size in (1024, 4096, 16384, 65536, 262144, 1048576):
        t = LINK_LATENCY + size / POD_LINK_BW
        eff = size / t
        rows.row(f"fig13b_d2d_xfer_{size}B", t,
                 f"{eff / 1e9:.2f} GB/s;util={eff / POD_LINK_BW:.2%}", model_bw=eff)
    if mesh.n > 1:
        _measured_allreduce_rows(mesh, rows, reps)
    else:
        for gbytes in ANALYTIC_GBYTES:
            t = collective_seconds("all_reduce", gbytes * 1e9, "pod", 2)
            rows.row(f"fig13_pod_allreduce_{gbytes}GB", t,
                     f"{2 * gbytes / t:.1f} GB/s effective;model=analytic-only", model_s=t)
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=4, help="ranks of the pod axis (1: analytic)")
    p.add_argument("--device", default=None, help="default cuda; cpu runs here")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--json", default=None, help="write the rows as JSON to this path")
    args = p.parse_args(argv)
    mesh = DeviceMesh({"pod": args.ranks}, device=args.device)
    rows = run(mesh, reps=args.reps)
    if args.json:
        rows.emit_json(args.json)


if __name__ == "__main__":
    main()
