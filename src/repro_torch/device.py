"""Device choice for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else ``cuda``. With no device given and no CUDA
    present this raises: the port never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "explicitly to run on the CPU"
        )
    return torch.device("cuda")


_SMS: dict[int, int] = {}


def sm_count(index: int) -> int:
    """SMs of CUDA card ``index``, read once: the kernels' planners size
    their grids to the card by it."""
    n = _SMS.get(index)
    if n is None:
        n = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n
