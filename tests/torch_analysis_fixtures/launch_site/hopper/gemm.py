# Fixture kernel module: loads its own library, as every kernel module must.
from repro_torch.hopper import build


def gemm_cuda(a, b):
    lib = build.load("gemm")
    return lib, a, b
