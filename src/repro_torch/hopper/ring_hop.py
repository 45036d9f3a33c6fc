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
import functools

import torch

from repro_torch.device import sm_count
from repro_torch.hopper import build
from repro_torch.hopper.dispatch import LAUNCHES, KernelStreams, StreamOperand, register_streams

THREADS = 256             # csrc/ring_hop.cu's words kernel: threads a CTA
CTAS_PER_SM = 2           # either kernel's grid: at most this many CTAs an SM
CHUNK = 16 << 10          # the bulk kernel's stage, bytes
BULK_MIN_BYTES = 4 << 20  # from this size on one card, the bulk kernel (at 4 MiB it
                          # matched copy_ cold where the words kernel stayed ~7% short)

_fn = None
_lib = None
_peers: set = set()  # (src card, dst card) pairs with peer access enabled


@register_streams("ring_hop", kernel="ring_hop")
def streams(structs, policy=None, **_):
    """The kernel's streams for one hop: the sender's block, copied byte
    for byte into the receiver's landing buffer; no accumulator."""
    (shape, dtype), = structs[:1]
    return KernelStreams("ring_hop", (StreamOperand("value", shape, dtype),), None,
                         (StreamOperand("value", shape, dtype),))


def _kernel():
    global _fn, _lib
    if _fn is None:
        lib = build.load("ring_hop")
        fn = lib.repro_ring_hop
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.repro_ring_hop_enable_peer.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.repro_ring_hop_enable_peer.restype = ctypes.c_int
        _lib, _fn = lib, fn
    return _fn


@functools.lru_cache(maxsize=64)
def hop_plan(nbytes: int, sms: int, same_card: bool) -> tuple[bool, int]:
    """(bulk, grid) of the hop kernel for a block of ``nbytes`` on a card
    of ``sms`` SMs. From BULK_MIN_BYTES on one card, the bulk kernel: one
    CTA per CHUNK bytes, at most CTAS_PER_SM an SM. Else (and for every
    push to another card, whose bulk stores are unverified) the words
    kernel: one CTA per THREADS 16-byte words (so a thread's first pass
    moves one word and a block below the cap is one round trip), at most
    CTAS_PER_SM an SM; above the cap each thread moves its words in passes
    of the kernel's kUnroll."""
    cap = sms * CTAS_PER_SM
    if same_card and nbytes >= BULK_MIN_BYTES:
        return True, max(1, min(-(-nbytes // CHUNK), cap))
    return False, max(1, min(-(-nbytes // (16 * THREADS)), cap))


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
    tensors, ``ring_hop_plain`` for CPU tensors. Returns ``dst``.

    The caller is normally on the sender's device already (the ring's
    ``mesh.on(me)``): then the launch takes the current stream as a raw
    handle, with no device switch."""
    if src.device.type == "cpu" and dst.device.type == "cpu":
        return ring_hop_plain(src, dst)
    _check(src, dst)
    nbytes = src.nbytes
    if nbytes:
        fn = _fn or _kernel()
        dev = src.device.index
        same_card = dst.device.index == dev
        if not same_card:
            _enable_peer(_lib, dev, dst.device.index)
        bulk, grid = hop_plan(nbytes, sm_count(dev), same_card)
        if torch.cuda.current_device() == dev:
            err = fn(src.data_ptr(), dst.data_ptr(), nbytes, bulk, grid,
                     torch._C._cuda_getCurrentRawStream(dev))
        else:
            with torch.cuda.device(dev):
                err = fn(src.data_ptr(), dst.data_ptr(), nbytes, bulk, grid,
                         torch._C._cuda_getCurrentRawStream(dev))
        if err:
            build.check(_lib, err, "ring_hop kernel launch")
        LAUNCHES["ring_hop"] += 1
    return dst
