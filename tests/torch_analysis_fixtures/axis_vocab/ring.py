# SEEDED VIOLATIONS (axis-name-vocabulary): the port's collectives over axis
# names the partition layer never produces (the axis follows parts and mesh).
from repro_torch.parallel.collectives import (all_to_all, ep_expert_ffn, ppermute,
                                              ring_scan_carry)


def exchange(parts, mesh, perm, fn, xs, s0, w):
    left = ppermute(parts, mesh, "rows", perm)
    right = ppermute(parts, mesh, "model", perm)
    swapped = all_to_all(parts, mesh, "shard", 0, 1)
    carried = ring_scan_carry(fn, xs, s0, mesh, "data")
    routed = ep_expert_ffn(parts, w, w, w, fn, mesh, 2, ep_axis="expert")
    return left, right, swapped, carried, routed
