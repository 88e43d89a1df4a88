"""Device resolution shared by the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
``device=None`` means CUDA, and raises when no GPU is present rather
than falling back to the CPU silently. A CUDA device without an index
resolves to the card this process is bound to
(``torch.cuda.current_device()``: a rank of an NCCL group sets its own,
``launch/mesh.py``), so every device the port holds names its card.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device
