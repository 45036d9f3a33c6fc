"""A 1-D ring of ranks driven by one process: the port's counterpart of a
``shard_map`` over one mesh axis.

The reference is single-controller: one Python process traces a
``shard_map`` over every device of a mesh axis. ``RingMesh`` keeps that
shape. Rank ``r`` has its own device (``devices[r]``), on CUDA its own
``torch.cuda.Stream``, and its own buffers: ``shard`` hands every rank a
separate allocation, so a ring hop really moves bytes from one rank's
buffer into another's. The caller's code runs rank ``r``'s work inside
``mesh.on(r)``, which makes that rank's device and stream current, so the
kernels of different ranks are free to overlap.

On one card all ranks share ``cuda:0`` and differ by stream; with one
card per rank (``devices=[cuda:0, cuda:1, ...]``) a hop writes into a peer
card's memory.

Streams and the caching allocator: a tensor allocated under one stream and
read on another could be handed out again while the other still reads it.
``shard``/``replicate`` make each rank's stream wait for the caller's
stream and allocate each part under the rank's stream; ``collect`` makes
the caller's stream wait for the rank's; every tensor that crosses
streams is passed to ``record_stream``.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.device import resolve_device


class RingMesh:
    """``n`` ranks on a ring (the reference's ``data`` axis).

    ``devices``: one device per rank; ``None`` puts every rank on
    ``device`` (``resolve_device``: ``cuda`` unless the caller passes
    ``device="cpu"``), on CUDA the card's first device. On CUDA each rank
    gets its own stream (``streams[r]``); on the CPU there are none and
    every rank's work runs in program order.
    """

    def __init__(self, n: int, *, devices=None, device=None):
        if n < 1:
            raise ValueError(f"RingMesh: n must be >= 1, got {n}")
        if devices is None:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", 0)
            devices = [dev] * n
        elif device is not None:
            raise TypeError("RingMesh: pass devices= or device=, not both")
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"RingMesh: {len(devices)} devices for {n} ranks")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"RingMesh: ranks on mixed device types {devices}")
        self.n = n
        self.devices = devices
        self.is_cuda = devices[0].type == "cuda"
        self.streams = ([torch.cuda.Stream(device=d) for d in devices]
                        if self.is_cuda else [None] * n)

    @contextlib.contextmanager
    def on(self, r: int):
        """Make rank ``r``'s device and stream current (no-op on the CPU)."""
        if not self.is_cuda:
            yield
            return
        with torch.cuda.device(self.devices[r]), torch.cuda.stream(self.streams[r]):
            yield

    def _enter(self, x, r: int):
        """Rank ``r``'s stream waits for the stream that produced ``x``, and
        ``x`` is kept alive for it."""
        if self.is_cuda and x.is_cuda:
            producer = torch.cuda.current_stream(x.device)
            self.streams[r].wait_stream(producer)
            if x.device == self.devices[r]:
                x.record_stream(self.streams[r])

    def _own(self, view, r: int):
        """A copy of ``view`` in a new allocation of rank ``r``, made under
        rank ``r``'s stream."""
        self._enter(view, r)
        with self.on(r):
            part = torch.empty(view.shape, dtype=view.dtype, device=self.devices[r])
            part.copy_(view)
        return part

    def shard(self, x, dim: int) -> list:
        """``n`` per-rank parts of ``x`` split evenly along ``dim``, each its
        own contiguous allocation on its rank's device."""
        size = x.shape[dim]
        if size % self.n:
            raise ValueError(f"RingMesh.shard: dim {dim} of size {size} does not "
                             f"split over {self.n} ranks")
        c = size // self.n
        return [self._own(x.narrow(dim, r * c, c), r) for r in range(self.n)]

    def replicate(self, x) -> list:
        """One copy of ``x`` per rank, each its own allocation."""
        return [self._own(x, r) for r in range(self.n)]

    def collect(self, part, r: int, device=None):
        """Rank ``r``'s ``part`` handed to the caller's stream on ``device``
        (default: rank 0's device): the caller's stream waits for rank
        ``r``'s, and the part is moved there if it lies elsewhere."""
        if not self.is_cuda:
            return part if device is None else part.to(device)
        device = self.devices[0] if device is None else torch.device(device)
        here = torch.cuda.current_stream(part.device)
        here.wait_stream(self.streams[r])
        part.record_stream(here)
        if part.device != device:
            torch.cuda.current_stream(device).wait_stream(here)
            part = part.to(device)
        return part

    def gather(self, parts, dim: int, device=None):
        """The per-rank ``parts`` concatenated along ``dim`` on ``device``
        (default: rank 0's device), on the caller's stream."""
        return torch.cat([self.collect(p, r, device) for r, p in enumerate(parts)], dim=dim)
