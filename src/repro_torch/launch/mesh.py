"""Mesh construction (port of the reference's ``repro/launch/mesh.py``).

Axis mapping: ``model`` = the chiplet crossbar, ``data`` = the group
level, ``pod`` = the D2D link. Meshes are ``parallel.mesh.DeviceMesh``
objects: one rank per card, or ``n`` ranks on the streams of one card.
The production mesh (16 x 16, or 2 x 16 x 16 with ``pod``) comes as a
``DeviceMesh`` (``make_production_mesh``) and, for pricing a plan without
a device, as a ``hopper.partition.MeshSpec`` (``production_mesh_spec``).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.diagnostics import warn_degrade
from repro_torch.hopper.partition import MeshSpec
from repro_torch.parallel.mesh import DeviceMesh


def _production_shape(multi_pod: bool) -> dict:
    return {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}


def make_production_mesh(multi_pod: bool = False, *, device=None, devices=None) -> DeviceMesh:
    """The production mesh, 16 x 16 ``(data, model)`` or, with
    ``multi_pod``, 2 x 16 x 16 ``(pod, data, model)``: every rank on
    ``device``'s streams (default the first card), or one rank per entry of
    ``devices`` (256 or 512 of them)."""
    return DeviceMesh(_production_shape(multi_pod), device=device, devices=devices)


def production_mesh_spec(multi_pod: bool = False) -> MeshSpec:
    """``make_production_mesh``'s shape as a device-free ``MeshSpec``: what
    a plan is priced on (``launch.shape_run``)."""
    return MeshSpec(_production_shape(multi_pod))


def make_mesh(shape: tuple, axes: tuple, *, device=None, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes`` (``make_mesh((2, 2, 2), ("pod",
    "data", "model"))``): every rank on ``device``'s streams, or one rank
    per entry of ``devices``."""
    if len(shape) != len(axes):
        raise ValueError(f"make_mesh: {len(shape)} sizes for {len(axes)} axes")
    return DeviceMesh(dict(zip(axes, shape)), device=device, devices=devices)


def host_device_mesh(tp: int = 1, pods: int = 1, *, n: int | None = None,
                     device=None) -> DeviceMesh:
    """``n`` ranks as ``(data, model)``, or as ``(pod, data, model)`` when
    ``pods`` is not 1 (the pod axis stays even where it degrades to 1).

    ``n`` defaults to one rank per card (one rank on the CPU with
    ``device="cpu"``); given, it puts ``n`` ranks on the streams of
    ``device`` (default the first card). When ``pods * tp`` does not
    divide ``n``, degrades with a ``ReproDegradeWarning``: the largest
    ``pods`` that divides ``n`` first, then the largest ``tp`` that divides
    the per-pod remainder. Raises ``ValueError`` for ``tp < 1``,
    ``pods < 1`` or ``n < 1``."""
    if tp < 1 or pods < 1 or (n is not None and n < 1):
        raise ValueError(
            f"host_device_mesh: tp={tp}, pods={pods} is not a valid mesh "
            f"factorisation (need 1 <= pods and 1 <= tp, n={n} ranks)"
        )
    devices = None
    if n is None:
        dev = resolve_device(device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        if dev.type == "cuda":
            devices, device = [torch.device("cuda", i) for i in range(n)], None
    want_tp, want_pods = tp, pods
    if n % pods != 0:
        pods = max(p for p in range(1, min(pods, n) + 1) if n % p == 0)
    per_pod = n // pods
    if per_pod % tp != 0:
        tp = max(t for t in range(1, min(tp, per_pod) + 1) if per_pod % t == 0)
    if (tp, pods) != (want_tp, want_pods):
        warn_degrade(
            f"host_device_mesh: pods={want_pods} x tp={want_tp} does not "
            f"divide {n} ranks; degrading to tp={tp}, pods={pods}",
        )
    if want_pods == 1:
        shape = {"data": n // tp, "model": tp}
    else:
        shape = {"pod": pods, "data": per_pod // tp, "model": tp}
    return DeviceMesh(shape, device=device, devices=devices)
