# The one exemption (CUDA_HOME, locating nvcc) is no finding; the second
# read in build.py is a SEEDED VIOLATION (no-environ-in-kernels).
import os


def nvcc_path():
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def nvcc_flags():
    return os.environ["NVCC_FLAGS"].split()
