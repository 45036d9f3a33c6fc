"""The card's hierarchy and its bandwidth model (port of
``repro.core.topology``): the Occamy levels mapped onto a cluster of
NVIDIA H100s, and the ring formulas that price a collective at a level.

Occamy:  core -> cluster (SPM + DMA) -> group -> chiplet (HBM2E)
         -> system (2 chiplets over the D2D link)
H100:    SM -> card (HBM3) -> ``model`` / ``data`` (NVLink 4 through the
         NVLink Switch: a 16 x 16 mesh is 256 cards, one switch domain)
         -> ``pod`` (the node's InfiniBand NIC, the D2D analogue)

The constants are the H100's datasheet figures, not measurements:
"NVIDIA H100 Tensor Core GPU" datasheet and the H100 architecture
whitepaper, SXM5 part at its 700 W limit (the card the port runs on,
"NVIDIA H100 80GB HBM3, 700 W"), dense rates without sparsity. A card set
below 700 W reaches less. The reference's TPU constants have no place
here: every bound the port prices is this card's.
"""
from __future__ import annotations

import dataclasses

# bf16 dense tensor-core peak, FLOP/s (SXM5, 700 W; the whitepaper's 989.4)
PEAK_FLOPS_BF16 = 989.4e12
# HBM3 bandwidth, bytes/s (SXM5 datasheet: 3.35 TB/s)
HBM_BW = 3.35e12
# HBM3 capacity, bytes (SXM5 datasheet: 80 GB); a cell ``fits`` within it
HBM_BYTES = 80e9
# NVLink 4, bytes/s per direction (datasheet: 900 GB/s bidirectional)
NVLINK_BW = 450e9
# one NDR InfiniBand NIC per card (ConnectX-7, 400 Gb/s), bytes/s per direction
POD_LINK_BW = 400e9 / 8


@dataclasses.dataclass(frozen=True)
class Level:
    name: str
    occamy_analogue: str
    fanout: int
    bw: float  # bytes/s available to one participant at this level


def levels(multi_pod: bool = False):
    """The hierarchy, innermost first: the card, the two NVLink axes and,
    with ``multi_pod``, the pod link."""
    lv = [
        Level("chip", "cluster (SPM+DMA)", 1, HBM_BW),
        Level("model", "chiplet crossbar", 16, NVLINK_BW),
        Level("data", "group interconnect", 16, NVLINK_BW),
    ]
    if multi_pod:
        lv.append(Level("pod", "D2D link", 2, POD_LINK_BW))
    return lv


def axis_bw(axis: str) -> float:
    """The link rate one participant has on mesh ``axis``."""
    return POD_LINK_BW if axis == "pod" else NVLINK_BW


def collective_seconds(kind: str, nbytes: float, axis: str, n: int) -> float:
    """Ring-algorithm time for ``nbytes`` (the per-rank buffer) over ``n``
    participants of ``axis``."""
    bw = axis_bw(axis)
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if kind == "all_reduce":
        return 2 * frac * nbytes / bw
    if kind in ("all_gather", "reduce_scatter", "all_to_all"):
        return frac * nbytes / bw
    if kind == "permute":
        return nbytes / bw
    raise ValueError(kind)


def dp_allreduce_seconds(param_bytes_per_device: float, mesh_axes: dict) -> float:
    """The gradient all-reduce over the data axis and, where it has more
    than one member, the pod axis: the step's D2D term."""
    t = collective_seconds(
        "all_reduce", param_bytes_per_device, "data", mesh_axes.get("data", 1)
    )
    if mesh_axes.get("pod", 1) > 1:
        t += collective_seconds(
            "all_reduce", param_bytes_per_device, "pod", mesh_axes["pod"]
        )
    return t
