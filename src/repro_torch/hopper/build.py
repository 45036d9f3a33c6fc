"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, bound with ``ctypes``. Builds
happen at first use, never at import, into ``_build/`` beside the package
(listed in ``.gitignore``); a library's file name carries a hash of its
source, the ``csrc/`` headers it includes and the flags, so an unchanged
source is not rebuilt. ``build`` starts
one ``nvcc`` per source, all at once, and waits for them together.

A failed build raises: nothing here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("flash_attention", "gemm", "spmm", "bsr_spmm", "spmspm", "stencil",
           "gemm_scaled", "flash_attention_scaled", "linear_attention", "ring_hop")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}  # name -> nvcc/ptxas output of its last build


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``CUDA_HOME``
    (default ``/usr/local/cuda``). Raises if neither exists.

    The ``CUDA_HOME`` read is the kernel layer's one environment read,
    the named exemption of the static checker's ``no-environ-in-kernels``
    rule: it locates the toolchain and configures no kernel."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the Hopper kernels are built "
        "on the machine with the card"
    )


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def local_includes(path: Path) -> list[Path]:
    """The files of ``csrc/`` that ``path`` includes with ``#include "..."``,
    directly or through each other, in the order first reached."""
    seen: list[Path] = []
    todo = [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_bytes()):
            dep = CSRC_DIR / inc.decode()
            if dep.exists() and dep not in seen:
                seen.append(dep)
                todo.append(dep)
    return seen


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lands, keyed by the hash of
    its source text, the headers of ``csrc/`` it includes, and the compiler
    flags: an edited header rebuilds every library that includes it."""
    src = CSRC_DIR / f"{name}.cu"
    text = b"".join(f.read_bytes() for f in [src, *local_includes(src)])
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together. Returns name ->
    library path; raises ``RuntimeError`` with the compiler's output if
    any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_logs[n] = out
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exit {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code other than 0."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
