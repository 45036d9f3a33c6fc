"""Straggler detection, failure injection and the elastic re-mesh (port
of ``repro.runtime.fault_tolerance``).

``StragglerMonitor`` keeps an EWMA of step times and flags a step slower
than ``threshold`` times it; ``FailureInjector`` is a fixed schedule of
faults for tests and examples. ``elastic_remesh`` rebuilds the ``data`` x
``model`` mesh with fewer data-parallel rows (the D2D link's disabled
lanes: throughput falls with the lost ranks) and ``reshard_state`` places
a training state on it, leaf by leaf, by the parameters' specs
(``parallel/sharding.py``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.parallel import sharding as sh
from repro_torch.parallel.mesh import DeviceMesh


@dataclasses.dataclass
class StragglerMonitor:
    threshold: float = 2.5  # x EWMA counts as a straggle
    alpha: float = 0.1
    ewma: float | None = None
    events: int = 0
    steps: int = 0

    def observe(self, step_seconds: float) -> bool:
        """Record one step's time; True where it straggled."""
        self.steps += 1
        if self.ewma is None:
            self.ewma = step_seconds
            return False
        straggled = step_seconds > self.threshold * self.ewma
        if straggled:
            self.events += 1
        else:  # outliers stay out of the EWMA
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * step_seconds
        return straggled

    @property
    def should_exclude(self) -> bool:
        """A host straggling persistently (3 events) would be left out at
        the next elastic boundary."""
        return self.events >= 3


class FailureInjector:
    """A fixed fault schedule {step: kind}: ``"crash"`` (the loop raises
    and must restart from a checkpoint) or ``"straggle"`` (a sleep)."""

    def __init__(self, schedule: dict[int, str] | None = None):
        self.schedule = schedule or {}
        self.triggered: list[tuple[int, str]] = []

    def check(self, step: int) -> str | None:
        kind = self.schedule.get(step)
        if kind:
            self.triggered.append((step, kind))
        return kind


def elastic_remesh(data_parallel: int, model_parallel: int, lost_ranks: int = 0, *,
                   device=None, devices=None):
    """The ``(data, model)`` mesh with ``lost_ranks`` fewer data-parallel
    rows: every rank on ``device``'s streams (default the first card), or
    one rank per entry of the first ``new_dp * model_parallel`` of
    ``devices`` (the ones that remain). Returns ``(DeviceMesh, new_dp)``.
    Raises ``ValueError`` below one data-parallel row, or where
    ``devices`` holds too few."""
    new_dp = data_parallel - lost_ranks
    if new_dp < 1:
        raise ValueError(f"elastic_remesh: cannot shrink below one data-parallel rank "
                         f"({data_parallel} - {lost_ranks} lost)")
    if devices is not None:
        n = new_dp * model_parallel
        if len(devices) < n:
            raise ValueError(f"elastic_remesh: {len(devices)} devices for {n} ranks")
        devices = list(devices)[:n]
    mesh = DeviceMesh({"data": new_dp, "model": model_parallel}, device=device, devices=devices)
    return mesh, new_dp


def _reshard(tree, shardings, device):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _reshard(x, shardings[k], device)
        else:
            full = x.gather(device) if isinstance(x, sh.Placed) else x
            out[k] = sh.Placed.of(full, shardings[k])
            del full
    return out


def reshard_state(state, cfg, mesh, mode: str = "train"):
    """``state`` placed on ``mesh`` (an elastic restart): a new tree whose
    leaves are ``sharding.Placed``, as ``place_`` places them, by
    ``param_specs(cfg, params, mesh, mode)`` for ``params``, ``opt.m``,
    ``opt.v`` (and ``grad_err``), ``opt.step`` replicated. ``state``'s
    leaves are tensors or ``Placed`` parts on an earlier mesh; each is
    gathered onto ``mesh``'s first device and split, one leaf at a time, so
    the new placement is bitwise the old when gathered. ``state`` itself is
    left as it was: the old placement lives until the caller drops it."""
    pspecs = sh.param_specs(cfg, state["params"], mesh, mode)
    specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs, "step": sh.P()}}
    if "grad_err" in state:
        specs["grad_err"] = pspecs
    return _reshard(state, sh.named(mesh, specs), mesh.devices[0])
