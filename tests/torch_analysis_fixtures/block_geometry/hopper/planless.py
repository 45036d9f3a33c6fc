# SEEDED VIOLATION (block-geometry-registry-only): run-time plans with no
# planner that asks dispatch.lookup_plan at all.
from repro_torch.hopper.dispatch import model_pick


def candidates(R, C):
    return [(R, C)]


def plan(R, C):
    return model_pick(candidates(R, C))
