"""One forward ring hop on Hopper: the wrapper of ``csrc/ring_hop.cu``.

Replaces the reference's Pallas kernel ``repro/core/streams.py``
``remote_ring_hop`` (an async remote DMA push to rank ``(me + 1) % n``).
``ring_hop_cuda(src, dst)`` pushes the bytes of the sender's block ``src``
into the receiver's landing buffer ``dst``. For CUDA tensors the wrapper
checks them, enables peer access when the two lie on different cards,
launches the kernel on the sender's current stream, raises on a launch
error and adds one to ``dispatch.LAUNCHES["ring_hop"]``. For CPU tensors,
and only for them, it runs the plain version ``ring_hop_plain``
(``dst.copy_(src)``, the counterpart of XLA's collective-permute).

The fences around the push (the landing buffer is free; the push has
landed) are the caller's: ``parallel/collectives.py`` records and waits on
them in the controller's program order.
"""
from __future__ import annotations

import ctypes

from repro_torch.hopper import build
from repro_torch.hopper.dispatch import LAUNCHES

_fn = None
_peers: set = set()  # (src card, dst card) pairs with peer access enabled


def _kernel():
    global _fn
    if _fn is None:
        lib = build.load("ring_hop")
        fn = lib.repro_ring_hop
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_ring_hop_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.repro_ring_hop_enable_peer.restype = ctypes.c_int
        _fn = (lib, fn)
    return _fn


def ring_hop_plain(src, dst):
    """The plain version: ``dst.copy_(src)``."""
    return dst.copy_(src)


def _check(src, dst):
    if not (src.is_cuda and dst.is_cuda):
        raise ValueError(
            f"ring_hop: src and dst must both be CUDA tensors, got {src.device}/{dst.device}"
        )
    if src.dtype != dst.dtype or src.shape != dst.shape:
        raise ValueError(
            f"ring_hop: dst {dst.dtype}{tuple(dst.shape)} does not match src "
            f"{src.dtype}{tuple(src.shape)}"
        )
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("ring_hop kernel: src and dst must be contiguous")


def _enable_peer(lib, a: int, b: int) -> None:
    if (a, b) in _peers:
        return
    err = lib.repro_ring_hop_enable_peer(a, b)
    if err != 0:
        raise RuntimeError(
            f"ring_hop: card {a} cannot store into card {b}: CUDA error {err} "
            f"({lib.repro_cuda_error_string(err).decode()})"
        )
    _peers.add((a, b))


def ring_hop_cuda(src, dst):
    """Push ``src``'s bytes into ``dst`` (same dtype and shape, both
    contiguous): the kernel on the sender's current stream for CUDA
    tensors, ``ring_hop_plain`` for CPU tensors. Returns ``dst``."""
    import torch

    if src.device.type == "cpu" and dst.device.type == "cpu":
        return ring_hop_plain(src, dst)
    _check(src, dst)
    nbytes = src.numel() * src.element_size()
    if nbytes:
        lib, fn = _kernel()
        if src.device != dst.device:
            _enable_peer(lib, src.device.index, dst.device.index)
        with torch.cuda.device(src.device):
            stream = torch.cuda.current_stream(src.device).cuda_stream
            err = fn(src.data_ptr(), dst.data_ptr(), nbytes, stream)
        build.check(lib, err, "ring_hop kernel launch")
        LAUNCHES["ring_hop"] += 1
    return dst
