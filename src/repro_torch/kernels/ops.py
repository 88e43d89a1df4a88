"""Public kernel entry points, dispatched on the tensors' device.

CUDA tensors go to the hand-written kernels (``blind_agg``), which launch
or raise; CPU tensors go to the plain versions in ``ref``. Nothing falls
back from the kernel to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import blind_agg as _ba
from repro_torch.kernels import ref

PRNG_TODO = ("blind_agg_prng (in-kernel mask synthesis, the port of "
             "_prng_fwd_kernel) is not ported yet: ROADMAP.md queue 2 item 3")


def blind_agg(E_active: torch.Tensor, E_passive: torch.Tensor,
              masks: torch.Tensor) -> torch.Tensor:
    """E_active (..., d); E_passive/masks (K, ..., d). Returns (..., d).
    Differentiable on both devices."""
    devices = {E_active.device.type, E_passive.device.type,
               masks.device.type}
    if devices == {"cuda"}:
        return _ba.blind_agg(E_active, E_passive, masks)
    if devices == {"cpu"}:
        return ref.reference_blind_agg(E_active, E_passive, masks)
    raise ValueError(f"blind_agg needs all inputs on one device type, got "
                     f"{sorted(devices)}")


def blind_agg_prng(E_active, E_passive, engine, round_idx, *,
                   mask_scale: float = 1.0):
    raise NotImplementedError(PRNG_TODO)
