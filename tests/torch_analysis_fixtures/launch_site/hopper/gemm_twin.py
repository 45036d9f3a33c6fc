# SEEDED VIOLATION (single-launch-site): a second kernel module loading the
# gemm library; meanwhile no module loads build.SOURCES' "spmm".
from repro_torch.hopper import build


def gemm_again(a, b):
    return build.load("gemm"), a, b
