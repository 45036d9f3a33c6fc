"""The paper's sparse-compute trio on the port (twin of
``examples/sparse_demo.py`` and ``benchmarks/bench_{stencil,spmm,spmspm}.py``):

  Stencil (Fig. 9b)  periodic star and box stencils (SARIS offset streams)
  SpMM    (Fig. 9c)  unstructured sparse x dense, ELL rows and BSR tiles
  SpMSpM  (Fig. 9d)  sparse x sparse by index intersection, GCOMP/s

Operands are drawn with the reference benches' numpy calls and order (one
``Generator`` per figure, seeded with ``seed``), so the same seed gives the
reference's matrices, grids and weights. ``CARD`` scales the benches'
structure (their five stencils, densities, F = 256 and 8 x 128 tiles) up
from their sizes (64^2 and 16^3 grids, A 1024 x 2048, SpMSpM 512 x 512
over K = 2048) to sizes whose operands exceed the H100's 50 MB L2. Every
case runs once warm through ``hopper.ops``, and each reports the bench's
figure of merit.

    PYTHONPATH=src python -m repro_torch.launch.sparse_la   # on the card
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import sparse
from repro_torch.device import resolve_device
from repro_torch.hopper import build, ops

DENSITIES = (0.0012, 0.01, 0.028)  # the paper's 0.12%..2.8% range (Fig. 9c/d)
RIGHT_DENSITY = 0.01  # Fig. 9d: right-hand matrices at 1%
BSR_BLOCK = (8, 128)  # bench_spmm's ell_to_bsr(bm=8, bk=128)
KERNELS = ("stencil", "spmm", "bsr_spmm", "spmspm")  # csrc/ sources the cases launch


@dataclasses.dataclass(frozen=True)
class Sizes:
    spmm: tuple[int, int, int]  # A (R, C), dense (C, F)
    spmspm: tuple[int, int, int]  # A (R, K), B's columns (C, K)
    grid_2d: tuple[int, int, int]  # (X, Y, 1)
    grid_3d: tuple[int, int, int]  # (X, Y, Z)


CARD = Sizes(spmm=(8192, 16384, 256), spmspm=(4096, 4096, 16384),
             grid_2d=(8192, 8192, 1), grid_3d=(512, 512, 512))


def star(radius, dims=3):
    """Centre plus ``radius`` points each way along the first ``dims`` axes."""
    offs = [[0, 0, 0]]
    for a in range(dims):
        for r in range(1, radius + 1):
            for s in (1, -1):
                o = [0, 0, 0]
                o[a] = s * r
                offs.append(o)
    return np.asarray(offs)


BOX27 = np.asarray([[dx, dy, dz] for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                    for dz in (-1, 0, 1)])
# (name, 2-D or 3-D grid, offsets), in bench_stencil's order
STENCILS = (("j2d5pt", "2d", star(1, 2)), ("j2d9pt", "2d", star(2, 2)),
            ("j3d7pt", "3d", star(1, 3)), ("j3d13pt", "3d", star(2, 3)),
            ("j3d27pt", "3d", BOX27))


@dataclasses.dataclass
class Case:
    """One bench row: ``ops.<op>(*args)``."""

    name: str
    op: str  # "stencil" | "spmm" | "bsr_spmm" | "spmspm"
    args: tuple
    work: float  # operations (GFLOP/s) or index comparisons (GCOMP/s) per call
    unit: str
    note: str


@dataclasses.dataclass
class CaseRun:
    name: str
    op: str
    wall_ms: float  # host clock around one warm call, ended by a device sync
    merit: float  # ``work`` / wall, in ``unit``
    unit: str
    note: str
    out: torch.Tensor


def _grid_tag(shape):
    X, Y, Z = shape
    if Z == 1:
        return f"{X}x{Y}"
    return f"{X}c" if X == Y == Z else f"{X}x{Y}x{Z}"


def make_cases(seed=0, sizes=CARD) -> list[Case]:
    """Every case's operands, on the host, in bench order: Fig. 9b's five
    stencils, Fig. 9c's ELL and BSR SpMM per density, Fig. 9d's SpMSpM per
    density."""
    cases = []
    rng = np.random.default_rng(seed)
    for name, kind, offs in STENCILS:
        shape = sizes.grid_2d if kind == "2d" else sizes.grid_3d
        g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        w = rng.standard_normal(len(offs)).astype(np.float32)
        cases.append(Case(f"fig9b_{name}_{_grid_tag(shape)}", "stencil", (g, offs, w),
                          2 * g.numel() * len(offs), "GFLOP/s", f"{len(offs)}pt"))

    rng = np.random.default_rng(seed)
    R, C, F = sizes.spmm
    for d in DENSITIES:
        A = sparse.random_ell(rng, R, C, d)
        D = torch.from_numpy(rng.standard_normal((C, F)).astype(np.float32))
        cases.append(Case(f"fig9c_spmm_ell_d{d * 100:.2f}pct", "spmm", (A, D),
                          2 * A.values.numel() * F, "GFLOP/s", f"nnz={A.nnz}"))
        bsr = sparse.ell_to_bsr(A, *BSR_BLOCK)
        cases.append(Case(f"fig9c_spmm_bsr_d{d * 100:.2f}pct", "bsr_spmm", (bsr, D),
                          2 * bsr.tile_values.numel() * F, "GFLOP/s",
                          f"tile_density={bsr.density:.3f}"))

    rng = np.random.default_rng(seed)
    R, C, K = sizes.spmspm
    for d in DENSITIES:
        A = sparse.random_ell(rng, R, K, d)
        B = sparse.random_ell(rng, C, K, RIGHT_DENSITY)
        comps = R * C * A.values.shape[1] * B.values.shape[1]  # ref.spmspm_comparisons
        cases.append(Case(f"fig9d_spmspm_d{d * 100:.2f}pct", "spmspm", (A, B, K),
                          comps, "GCOMP/s", f"La={A.values.shape[1]} Lb={B.values.shape[1]}"))
    return cases


def _on(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, sparse.EllMatrix):
        return x if x.values.device == device else x.to(device)
    if isinstance(x, sparse.BsrMatrix):
        return x if x.tile_values.device == device else x.to(device)
    return x


def cases_to(cases, device) -> list[Case]:
    """The cases with their operands moved to ``device``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return [dataclasses.replace(c, args=tuple(_on(a, device) for a in c.args)) for c in cases]


def run(*, device=None, seed=0, cases=None) -> list[CaseRun]:
    """Each case once warm through ``hopper.ops`` on ``device`` (default
    ``cuda``; raises without CUDA unless a device is given). ``cases``
    default to ``make_cases(seed)`` at card size; their operands move to
    the device, the kernels are built and loaded, and each case is called
    once untimed (paying its first-launch costs) before its timed call.
    Returns one ``CaseRun`` per case."""
    device = resolve_device(device)
    cases = cases_to(make_cases(seed) if cases is None else cases, device)
    if device.type == "cuda":
        for name in KERNELS:
            build.load(name)
    runs = []
    for c in cases:
        fn = getattr(ops, c.op)
        with torch.no_grad():
            fn(*c.args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*c.args)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            wall = time.perf_counter() - t
        runs.append(CaseRun(c.name, c.op, wall * 1e3, c.work / wall / 1e9, c.unit, c.note, out))
    return runs


def main():
    for r in run():
        print(f"{r.name},{r.wall_ms * 1e3:.1f},{r.merit:.2f} {r.unit};{r.note};"
              f"out {tuple(r.out.shape)} finite={bool(torch.isfinite(r.out).all())}")


if __name__ == "__main__":
    main()
