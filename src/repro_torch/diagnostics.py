"""Degrade-path diagnostics: one warning category, one emission channel.

A copy of the reference's ``repro/diagnostics.py``. Where the port
degrades instead of failing (``remote_copy=True`` on CPU tensors takes the
plain transport; the partition ladder replicates when an op's rule
declines every level; ``launch.mesh.host_device_mesh`` degrades a mesh
that does not divide its ranks), it warns through ``warn_degrade`` with the
``ReproDegradeWarning`` category, so callers can filter on exactly the
degraded-mode signal. Stdlib-only.
"""
from __future__ import annotations

import warnings

_SEEN: set = set()


class ReproDegradeWarning(UserWarning):
    """A requested configuration degraded to a weaker-but-correct mode
    (the partition ladder replicated, or ``remote_copy`` took the plain
    transport). Subclasses ``UserWarning``."""


def warn_degrade(message: str, *, key=None, stacklevel: int = 2) -> None:
    """Emit ``message`` as a ``ReproDegradeWarning``.

    ``key``: when set, the warning is one-shot per process for this key.
    ``stacklevel`` is forwarded to ``warnings.warn`` so the report points
    at the degrading caller.
    """
    if key is not None:
        if key in _SEEN:
            return
        _SEEN.add(key)
    warnings.warn(message, ReproDegradeWarning, stacklevel=stacklevel + 1)


def reset_degrade_warnings() -> None:
    """Clear the one-shot ``key`` memory (tests re-arm suppressed warnings)."""
    _SEEN.clear()
