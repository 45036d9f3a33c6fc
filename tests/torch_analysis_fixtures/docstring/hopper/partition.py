"""Fixture partition module: long enough to satisfy the module-docstring
check, so the member-level findings below are the only ones."""
import dataclasses


def plan_for(op, mesh):
    # SEEDED VIOLATION (docstring-contract): public function, no docstring
    return None


def sharded_call(op, mesh, *operands):
    """Dispatch the op over the mesh — a docstring long enough to pass the
    length gate but incomplete: ``op`` and ``mesh`` appear, while the
    variadic positional parameter is never named, seeding the
    parameter-coverage finding."""
    return None


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    """A resolved partitioning of one op call; documents ``op`` but says
    nothing about the second field, seeding the field-coverage finding."""

    op: str
    levels: tuple
