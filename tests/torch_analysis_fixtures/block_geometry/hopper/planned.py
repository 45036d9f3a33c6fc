# SEEDED VIOLATION (block-geometry-registry-only): the planner asks its
# model before dispatch.lookup_plan, so a tuned plan can be masked.
from repro_torch.hopper.dispatch import lookup_plan, model_pick


def candidates(M, N):
    return [(M, N)]


def plan(M, N):
    pick = model_pick(candidates(M, N))
    return pick or lookup_plan("planned", (M, N))
