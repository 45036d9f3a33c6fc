# Fixture build module: the one place a library may be opened, and the
# list of sources every kernel module is held to.
import ctypes

SOURCES = ("gemm", "spmm")


def load(name):
    return ctypes.CDLL(f"{name}.so")
