# SEEDED VIOLATIONS (single-launch-site): a harness loading a kernel library
# itself, and opening a shared library outside hopper/build.py.
import ctypes

from repro_torch.hopper import build

KERNELS = ("gemm",)


def warm_up():
    for name in KERNELS:
        build.load(name)
    return ctypes.CDLL("libcustom.so")
