# SEEDED VIOLATION (block-geometry-registry-only): "spmm" has a block table
# but never resolves its blocks through dispatch — split-brain geometry.
from repro_torch.hopper.dispatch import resolve_blocks


def gemm(a, b, bm=None):
    return a @ b, resolve_blocks("gemm", bm=bm)


def spmm(values, cols, dense):
    return values, cols, dense
