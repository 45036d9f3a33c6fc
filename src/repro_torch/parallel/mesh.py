"""Named-axis meshes of ranks driven by one process: the port's counterpart
of a ``jax.sharding.Mesh`` and the ``shard_map`` over it.

The reference is single-controller: one Python process traces a
``shard_map`` over every device of a mesh. ``DeviceMesh`` keeps that
shape. Its ranks are numbered row-major over named axes (``{"pod": P,
"data": D, "model": M}``: rank ``(p * D + d) * M + m``). Rank ``r`` has
its own device (``devices[r]``), on CUDA its own ``torch.cuda.Stream``,
and its own buffers: ``shard`` hands every rank a separate allocation, so
a ring hop or a halo exchange really moves bytes from one rank's buffer
into another's. The caller's code runs rank ``r``'s work inside
``mesh.on(r)``, which makes that rank's device and stream current, so the
kernels of different ranks are free to overlap.

On one card all ranks share ``cuda:0`` and differ by stream; with one
card per rank (``devices=[cuda:0, cuda:1, ...]``) a hop writes into a peer
card's memory.

A spec entry says how one dimension of a tensor splits over the mesh, as
in a ``PartitionSpec``: ``None`` (every rank holds the whole dimension),
an axis name (split over that axis), or a tuple of names (split jointly,
the first axis major: ``("pod", "model")`` gives slab ``p * M + m`` to the
ranks at pod ``p`` and model ``m``).

Streams and the caching allocator: a tensor allocated under one stream and
read on another could be handed out again while the other still reads it.
``shard``/``replicate`` make each rank's stream wait for the caller's
stream and allocate each part under the rank's stream; ``collect`` makes
the caller's stream wait for the rank's; every tensor that crosses
streams is passed to ``record_stream``.

``RingMesh(n)`` is the one-axis mesh ``{"data": n}`` (the sequence ring's).
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.device import resolve_device

_ALL = object()  # shard()'s default entry: every axis jointly, i.e. rank order


class DeviceMesh:
    """Ranks on the named axes of ``shape`` (``{axis: size}``, in order).

    ``devices``: one device per rank; ``None`` puts every rank on
    ``device`` (``resolve_device``: ``cuda`` unless the caller passes
    ``device="cpu"``), on CUDA the card's first device. On CUDA each rank
    gets its own stream (``streams[r]``); on the CPU there are none and
    every rank's work runs in program order.
    """

    def __init__(self, shape: dict, *, devices=None, device=None):
        shape = {str(a): int(s) for a, s in dict(shape).items()}
        if not shape or any(s < 1 for s in shape.values()):
            raise ValueError(f"{type(self).__name__}: axis sizes must be >= 1, got {shape}")
        n = math.prod(shape.values())
        if devices is None:
            dev = resolve_device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", 0)
            devices = [dev] * n
        elif device is not None:
            raise TypeError(f"{type(self).__name__}: pass devices= or device=, not both")
        devices = [torch.device(d) for d in devices]
        if len(devices) != n:
            raise ValueError(f"{type(self).__name__}: {len(devices)} devices for {n} ranks")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"{type(self).__name__}: ranks on mixed device types {devices}")
        self.shape = shape
        self.axis_names = tuple(shape)
        self.n = n
        self.devices = devices
        self.is_cuda = devices[0].type == "cuda"
        self.streams = ([torch.cuda.Stream(device=d) for d in devices]
                        if self.is_cuda else [None] * n)

    def __repr__(self):
        return f"{type(self).__name__}({self.shape}, devices={len(set(self.devices))})"

    # -- rank arithmetic ----------------------------------------------------

    def coords(self, r: int) -> dict:
        """Rank ``r``'s index on every axis, ``{axis: index}``."""
        out = {}
        for a in reversed(self.axis_names):
            r, out[a] = divmod(r, self.shape[a])
        return {a: out[a] for a in self.axis_names}

    def rank(self, coords: dict) -> int:
        """The rank at ``coords`` (``{axis: index}`` for every axis)."""
        r = 0
        for a in self.axis_names:
            r = r * self.shape[a] + coords[a]
        return r

    def group(self, axis: str, r: int) -> list:
        """The ranks that differ from ``r`` only on ``axis``, in axis order
        (``r`` among them)."""
        c = self.coords(r)
        return [self.rank({**c, axis: i}) for i in range(self.shape[axis])]

    def groups(self, axis: str) -> list:
        """Every group of ``axis`` (``group(axis, r)``), each once."""
        return [self.group(axis, r) for r in range(self.n) if self.coords(r)[axis] == 0]

    def _entry(self, entry):
        """A spec entry as a tuple of axis names (``()`` for ``None``)."""
        if entry is _ALL:
            return self.axis_names
        names = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"{type(self).__name__}: no axis {a!r} in {self.axis_names}")
        return names

    def chunk(self, entry, r: int) -> tuple[int, int]:
        """``(index, count)``: which of the ``count`` slabs of a dimension
        split by ``entry`` rank ``r`` holds (``(0, 1)`` for ``None``)."""
        c, index, count = self.coords(r), 0, 1
        for a in self._entry(entry):
            index, count = index * self.shape[a] + c[a], count * self.shape[a]
        return index, count

    # -- streams and parts --------------------------------------------------

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

    def _handoff(self, x, src: int, dst: int):
        """Rank ``dst``'s stream waits for rank ``src``'s, which produced
        ``x``, and ``x`` is kept alive for it."""
        if self.is_cuda:
            self.streams[dst].wait_stream(self.streams[src])
            if x.device == self.devices[dst]:
                x.record_stream(self.streams[dst])

    def own(self, view, r: int, src: int | None = None):
        """A copy of ``view`` in a new allocation of rank ``r``, made under
        rank ``r``'s stream; ``view`` was produced on the caller's stream,
        or on rank ``src``'s when given."""
        if src is None:
            self._enter(view, r)
        else:
            self._handoff(view, src, r)
        with self.on(r):
            part = torch.empty(view.shape, dtype=view.dtype, device=self.devices[r])
            part.copy_(view)
        return part

    def local(self, x, spec, r: int):
        """The view of ``x`` that rank ``r`` holds under ``spec`` (one entry
        per leading dimension; missing entries are ``None``). No copy."""
        for dim, entry in enumerate(spec):
            index, count = self.chunk(entry, r)
            if count > 1:
                size = x.shape[dim]
                if size % count:
                    raise ValueError(f"{type(self).__name__}: dim {dim} of size {size} does "
                                     f"not split over {count} ranks ({entry!r})")
                x = x.narrow(dim, index * (size // count), size // count)
        return x

    def shard_spec(self, x, spec) -> list:
        """Every rank's part of ``x`` under ``spec``, each its own contiguous
        allocation on its rank's device."""
        return [self.own(self.local(x, spec, r), r) for r in range(self.n)]

    def shard(self, x, dim: int, entry=_ALL) -> list:
        """Every rank's part of ``x`` split along ``dim`` by ``entry`` (by
        default every axis jointly: the ``n`` slabs in rank order), each
        its own contiguous allocation on its rank's device."""
        return self.shard_spec(x, (None,) * dim + (entry,))

    def replicate(self, x) -> list:
        """One copy of ``x`` per rank, each its own allocation."""
        return [self.own(x, r) for r in range(self.n)]

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

    def gather_spec(self, parts, spec, device=None):
        """The global tensor whose per-rank parts under ``spec`` are
        ``parts``, on ``device`` (default: rank 0's device), on the
        caller's stream. Axes ``spec`` does not name are replicas: the
        ranks at index 0 on them supply the parts."""
        used = {a for e in spec for a in self._entry(e)}
        reps = [r for r in range(self.n)
                if all(i == 0 for a, i in self.coords(r).items() if a not in used)]
        grid = {tuple(self.chunk(e, r)[0] for e in spec): self.collect(parts[r], r, device)
                for r in reps}

        def cat(prefix, dim):
            if dim == len(spec):
                return grid[prefix]
            count = self.chunk(spec[dim], 0)[1]
            pieces = [cat(prefix + (i,), dim + 1) for i in range(count)]
            return pieces[0] if count == 1 else torch.cat(pieces, dim=dim)

        return cat((), 0)

    def gather(self, parts, dim: int, device=None, entry=_ALL):
        """The per-rank ``parts`` concatenated along ``dim`` by ``entry``
        (by default every axis jointly, in rank order) on ``device``
        (default: rank 0's device), on the caller's stream."""
        return self.gather_spec(parts, (None,) * dim + (entry,), device)


class RingMesh(DeviceMesh):
    """``n`` ranks on a ring: the one-axis mesh ``{"data": n}`` (the
    reference's ``data`` axis)."""

    def __init__(self, n: int, *, devices=None, device=None):
        if n < 1:
            raise ValueError(f"RingMesh: n must be >= 1, got {n}")
        super().__init__({"data": n}, devices=devices, device=device)
