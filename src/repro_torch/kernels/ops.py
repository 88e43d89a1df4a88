"""Public kernel entry points, dispatched on the tensors' device.

CUDA tensors go to the hand-written kernels (``blind_agg``,
``flash_attention``, ``rglru_scan``), which launch or raise; tensors of
any other one device type (the CPU, or the meta device of the dry run)
go to the plain versions in ``ref``. Nothing falls back from the kernel
to the plain version."""
from __future__ import annotations

import torch

from repro_torch.kernels import blind_agg as _ba
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rg_lru as _rg
from repro_torch.kernels import ref


def blind_agg(E_active: torch.Tensor, E_passive: torch.Tensor,
              masks: torch.Tensor) -> torch.Tensor:
    """E_active (..., d); E_passive/masks (K, ..., d). Returns (..., d).
    Differentiable on both devices."""
    devices = {E_active.device.type, E_passive.device.type,
               masks.device.type}
    if devices == {"cuda"}:
        return _ba.blind_agg(E_active, E_passive, masks)
    if len(devices) == 1:           # one non-CUDA device type
        return ref.reference_blind_agg(E_active, E_passive, masks)
    raise ValueError(f"blind_agg needs all inputs on one device type, got "
                     f"{sorted(devices)}")


def blind_agg_prng(E_active: torch.Tensor, E_passive: torch.Tensor, engine,
                   round_idx, *, mask_scale: float = 1.0) -> torch.Tensor:
    """Blind + aggregate with the masks made from ``engine``'s seed tables
    for ``round_idx``. E_active (..., d); E_passive (K, ..., d). On the
    card no (K, ..., d) mask tensor exists; CPU tensors take the plain
    version, which materializes the MaskEngine's masks. Differentiable in
    both embeddings."""
    devices = {E_active.device.type, E_passive.device.type}
    if devices == {"cuda"}:
        return _ba.prng_blind_agg(E_active, E_passive, engine, round_idx,
                                  mask_scale)
    if len(devices) == 1:           # one non-CUDA device type
        return ref.reference_blind_agg_prng(E_active, E_passive, engine,
                                            round_idx, mask_scale=mask_scale)
    raise ValueError(f"blind_agg_prng needs all inputs on one device type, "
                     f"got {sorted(devices)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal and/or sliding-window GQA attention, forward only.
    q (B,S,Hq,hd), k/v (B,T,Hkv,hd) -> (B,S,Hq,hd) in q's dtype. Runs
    under ``torch.func.vmap`` on the card (the vmapped axis is folded into
    the batch axis around one launch)."""
    devices = {q.device.type, k.device.type, v.device.type}
    if devices == {"cuda"}:
        return _fa.flash_attention(q, k, v, causal=causal, window=window)
    if len(devices) == 1:           # one non-CUDA device type
        return ref.reference_attention(q, k, v, causal=causal, window=window)
    raise ValueError(f"flash_attention needs all inputs on one device type, "
                     f"got {sorted(devices)}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """The RG-LRU recurrence h_t = a_t * h_{t-1} + b_t, forward only.
    a/b (B,L,W), h0 (B,W) -> (h (B,L,W), h_last (B,W)) in float32. Runs
    under ``torch.func.vmap`` on the card (the vmapped axis is folded into
    the batch axis around one launch)."""
    devices = {a.device.type, b.device.type, h0.device.type}
    if devices == {"cuda"}:
        return _rg.rglru_scan(a, b, h0)
    if len(devices) == 1:           # one non-CUDA device type
        return ref.reference_rglru(a, b, h0)
    raise ValueError(f"rglru_scan needs all inputs on one device type, got "
                     f"{sorted(devices)}")
