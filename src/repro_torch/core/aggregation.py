"""Secure embedding aggregation (paper §IV-C, Eq. 7), float wire.

The active party receives blinded embeddings [E_k] = E_k + r_k from the K
passive parties and averages them with its own E_a:

    E = (E_a + sum_k [E_k]) / C,   sum_k r_k == 0  =>  E == plain mean.

The masked aggregation always goes through ``kernels.ops.blind_agg``, which
picks by device: the CUDA blind+aggregate kernel for tensors on the card,
its plain version for CPU tensors. The reference's ``use_kernel`` switch
has no counterpart here; it only kept Pallas interpret mode off the TPU.
The ring wire modes (``aggregate_int32``, ``aggregate_int8``,
``aggregate_ring``) are ROADMAP queue 1 item 7.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import blinding
from repro_torch.kernels import ops as kernel_ops


def blind(E_passive: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """[E_k] = E_k + r_k. E_passive/masks: (K, ...)."""
    return blinding.blind_uplink(E_passive, masks, "float")


def aggregate(E_active: torch.Tensor,
              E_passive_blinded: torch.Tensor) -> torch.Tensor:
    """Global embedding (Eq. 7). E_active (...,), E_passive_blinded (K, ...).

    The already-blinded stack goes through the fused kernel with all-zero
    masks, as the reference's ``aggregate(use_kernel=True)`` does: the
    kernel then reads K*N*d zeros it does not need."""
    return kernel_ops.blind_agg(E_active, E_passive_blinded,
                                torch.zeros_like(E_passive_blinded))


def blind_and_aggregate(E_all: torch.Tensor,
                        masks: Optional[torch.Tensor]) -> torch.Tensor:
    """E_all (C, ...): party 0 = active. masks (K, ...) for parties 1..K.
    Without masks (K < 2 or blinding off) the plain mean, as the
    reference."""
    if masks is None:
        return torch.mean(E_all, dim=0)
    return kernel_ops.blind_agg(E_all[0], E_all[1:], masks)


def blind_and_aggregate_fused(E_all: torch.Tensor, engine, round_idx, *,
                              mask_scale: float = 1.0) -> torch.Tensor:
    """Blind + aggregate with in-kernel mask synthesis: waits for the port
    of ``_prng_fwd_kernel``."""
    raise NotImplementedError(kernel_ops.PRNG_TODO)
