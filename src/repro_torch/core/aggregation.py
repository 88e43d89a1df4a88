"""Secure embedding aggregation (paper §IV-C, Eq. 7).

The active party receives blinded embeddings [E_k] = E_k + r_k from the K
passive parties and averages them with its own E_a:

    E = (E_a + sum_k [E_k]) / C,   sum_k r_k == 0  =>  E == plain mean.

The masked float aggregation always goes through ``kernels.ops.blind_agg``
(or ``blind_agg_prng`` when the masks are made in the kernel), which picks
by device: the CUDA kernel for tensors on the card, its plain version for
CPU tensors. The reference's ``use_kernel`` switch has no counterpart
here; it only kept Pallas interpret mode off the TPU.

The ring wire modes (``aggregate_int32``, ``aggregate_int8``,
``aggregate_ring``) are integer sums and stay torch ops. ``torch.sum``
of an int32 or int8 tensor returns int64, so every ring sum is cast back
to the ring's width, which truncates: the wrapped word, on CPU and CUDA.
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
    """Blind + aggregate with in-kernel mask synthesis (float mode): on
    the card no (K, ...) mask tensor exists; CPU tensors take the plain
    version (MaskEngine masks through ``reference_blind_agg``)."""
    return kernel_ops.blind_agg_prng(E_all[0], E_all[1:], engine, round_idx,
                                     mask_scale=mask_scale)


def aggregate_int32_blinded(q_uplink: torch.Tensor) -> torch.Tensor:
    """Ring-mode aggregate from an already-blinded (C, ...) int32 stack."""
    C = q_uplink.shape[0]
    s = torch.sum(q_uplink, dim=0).to(torch.int32)
    return blinding.dequantize(s) / C


def aggregate_int32(E_all: torch.Tensor,
                    masks_i32: torch.Tensor) -> torch.Tensor:
    """Ring-exact fixed-point secure aggregation. E_all (C, ...) float;
    masks_i32 (K, ...) int32 with ring-sum zero. Returns the float mean;
    quantization error <= C / (2 * FIXED_POINT_SCALE)."""
    C = E_all.shape[0]
    up = blinding.blind_uplink(E_all[1:], masks_i32, "int32")
    s = (blinding.quantize(E_all[0]) + torch.sum(up, dim=0)).to(torch.int32)
    return blinding.dequantize(s) / C


def aggregate_int8_blinded(q_uplink: torch.Tensor, scale) -> torch.Tensor:
    """Narrow-ring aggregate from an already-blinded (C, ...) int8 stack
    quantized under ``scale``: the sum is wrapped back to int8, where by
    the ring_scale headroom the true C-party sum lies."""
    C = q_uplink.shape[0]
    s = torch.sum(q_uplink, dim=0).to(torch.int8)
    return blinding.dequantize(s, scale) / C


def aggregate_int8(E_all: torch.Tensor, masks_i8: torch.Tensor,
                   scale=None) -> torch.Tensor:
    """Ring-exact int8 secure aggregation. ``scale`` defaults to the
    per-round dynamic scale from max |E_all| (an exact float max, so every
    engine derives the same scalar)."""
    C = E_all.shape[0]
    if scale is None:
        scale = blinding.ring_scale(torch.max(torch.abs(E_all)), C, "int8")
    up = blinding.blind_uplink(E_all[1:], masks_i8, "int8", scale)
    q_a = blinding.quantize_ring(E_all[0], "int8", scale)
    return aggregate_int8_blinded(torch.cat([q_a[None], up], dim=0), scale)


def aggregate_ring(E_all: torch.Tensor, masks: torch.Tensor, mode: str,
                   scale=None) -> torch.Tensor:
    """One entry point for every Z_2^w wire mode."""
    if mode == "int32":
        return aggregate_int32(E_all, masks)
    if mode != "int8":
        raise ValueError(f"ring mode {mode!r}")
    return aggregate_int8(E_all, masks, scale)


def aggregate_ring_blinded(q_uplink: torch.Tensor, mode: str,
                           scale=None) -> torch.Tensor:
    """``aggregate_ring`` from an already-blinded (C, ...) stack."""
    if mode == "int32":
        return aggregate_int32_blinded(q_uplink)
    if mode != "int8":
        raise ValueError(f"ring mode {mode!r}")
    return aggregate_int8_blinded(q_uplink, scale)
