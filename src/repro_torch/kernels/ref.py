"""Plain PyTorch versions of the port's kernels (the allclose targets, and
what the dispatcher in ``ops`` runs for CPU tensors)."""
from __future__ import annotations

import math

import torch

from repro_torch.core import blinding


def reference_blind_agg(E_active, E_passive, masks):
    """E = (E_a + sum_k (E_k + r_k)) / C — materializes [E_k] like the
    paper's wire protocol. E_active (..., d); E_passive/masks (K, ..., d)."""
    C = 1 + E_passive.shape[0]
    blinded = E_passive.float() + masks.float()
    tot = E_active.float() + torch.sum(blinded, dim=0)
    return (tot / C).to(E_active.dtype)


def reference_blind_agg_bwd(g, K: int, ep_dtype, mk_dtype, *,
                            need_mk: bool = True):
    """Cotangents of ``reference_blind_agg`` for an output cotangent g
    (N, d): dE_a = g / C in g's dtype and dE_k = dr_k = g / C for every
    passive party, materialized as (K, N, d) in ep's and mk's dtypes; the
    mask cotangent is None unless ``need_mk``."""
    s = g.float() / (K + 1)
    full = s.expand((K,) + tuple(g.shape))
    dmk = full.to(mk_dtype).contiguous() if need_mk else None
    return s.to(g.dtype), full.to(ep_dtype).contiguous(), dmk


def reference_blind_agg_prng(E_active, E_passive, engine, round_idx, *,
                             mask_scale: float = 1.0):
    """What the in-kernel-mask forward computes, as the reference computes
    it off the TPU: the MaskEngine's masks for ``round_idx`` (scaled, then
    cast to E_passive's dtype) through ``reference_blind_agg``.
    E_active (..., d); E_passive (K, ..., d)."""
    masks = engine.masks(E_passive.shape[1:], round_idx, "float",
                         scale=mask_scale, device=E_passive.device)
    return reference_blind_agg(E_active, E_passive,
                               masks.to(E_passive.dtype))


def reference_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) -> (B,S,Hq,hd) in q's dtype. Naive
    materialized GQA attention in float32 (query head h reads kv head
    h // (Hq / Hkv)); masked logits are -1e30, as the flash kernel's."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    kr = torch.repeat_interleave(k, G, dim=2)
    vr = torch.repeat_interleave(v, G, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q.float(),
                          kr.float()) / math.sqrt(hd)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window > 0:
        mask = mask & (k_pos > q_pos - window)
    logits = torch.where(mask[None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", probs, vr.float())
    return out.to(q.dtype)


def reference_rglru(a, b, h0):
    """Sequential h_t = a_t * h_{t-1} + b_t in float32 (a multiply, then
    an add, each rounded). a/b (B,L,W) of any float dtype, h0 (B,W).
    Returns (h (B,L,W) float32, h_last (B,W) float32)."""
    a32, b32 = a.float(), b.float()
    h = h0.float()
    hs = []
    for t in range(a32.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs.append(h)
    if not hs:
        return a32.new_zeros(a32.shape), h
    return torch.stack(hs, dim=1), h
