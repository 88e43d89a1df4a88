"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means CUDA, and raises when no GPU is present rather
than falling back to the CPU silently.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
