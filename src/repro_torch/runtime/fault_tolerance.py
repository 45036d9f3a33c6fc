"""Straggler detection and failure injection (port of
``repro.runtime.fault_tolerance``).

``StragglerMonitor`` keeps an EWMA of step times and flags a step slower
than ``threshold`` times it; ``FailureInjector`` is a fixed schedule of
faults for tests and examples. The reference's ``elastic_remesh`` and
``reshard_state`` rebuild a mesh and reshard the state onto it; they wait
for ROADMAP queue 1 item 2b (the rules and training on a mesh are in
``parallel/sharding.py`` and ``runtime/train_loop.py``).
"""
from __future__ import annotations

import dataclasses


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
