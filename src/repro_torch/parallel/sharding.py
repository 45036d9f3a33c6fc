"""The kernel-mesh context (the port of ``use_mesh``, ``kernel_mesh`` and
``current_mesh`` from the reference's ``repro/parallel/sharding.py``).

``use_mesh(mesh)`` makes every ``ops.*`` call inside it partition over
``mesh`` (``hopper/partition.py``), as an explicit ``mesh=`` would. It
sets the kernel mesh only: ``current_mesh()``, the mesh the model-level
rules would lower for, stays as it was, so a kernel-only context never
re-routes model internals. The model-level rules themselves
(``param_specs``, ``batch_specs``, ``cache_specs``, ``constrain``) are
not ported, so ``current_mesh()`` is ``None`` here.
"""
from __future__ import annotations

from contextlib import contextmanager

_kernel_mesh = None


def current_mesh():
    """The mesh the model is lowered for: always ``None`` here, since the
    model-level rules that would set it are not ported."""
    return None


def kernel_mesh():
    """The mesh ``ops.*`` partitions over (``None`` outside ``use_mesh``)."""
    return _kernel_mesh


@contextmanager
def use_mesh(mesh):
    """Partition every ``ops.*`` call inside over ``mesh``; the previous
    kernel mesh comes back on exit."""
    global _kernel_mesh
    old, _kernel_mesh = _kernel_mesh, mesh
    try:
        yield mesh
    finally:
        _kernel_mesh = old
