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
