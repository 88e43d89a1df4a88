"""Mixture-of-Experts layer: a top-k router and capacity-based dispatch
(counterpart of ``repro.models.moe``).

The reference's semantics, step for step: a float32 router, softmax,
top-k and the renormalised gates; the Switch load-balance loss from each
token's first expert; ``cap = max(ceil(T*K/E * capacity_factor), 4)``
slots an expert, each (token, k) placed at its cumsum position in its
expert's buffer and sent to the overflow slot ``cap`` past it; the grouped
expert matmuls over the (E, cap+1, d) buffer; a combine that weights each
gathered row by gate x keep; the sigmoid-gated shared experts.

Two choices keep it deterministic on the card and legal under
``torch.func.vmap`` (the passive MoE proxies), with the same outputs and
gradients as the reference:

  * the dispatch writes, out of place, each kept (token, k) to its own
    slot and a zero row to the overflow slot for each dropped one, so no
    two writes to one row differ and no accumulation order enters; the
    reference adds the dropped rows into that slot, whose expert output
    the combine multiplies by keep = 0 either way;
  * the combine adds a token's K weighted rows in k order from zero (the
    reference's scatter-add order on the CPU), as K ordered adds over a
    (T, K, d) view instead of an atomic ``index_put(accumulate=True)``.

One-hot encodings are comparisons against ``torch.arange(E)``
(``F.one_hot`` checks its input's range, a data-dependent branch that
vmap refuses), and ``cap`` is a Python int from the logical T.

Under a sharding plan that splits the rows (``repro_torch.sharding``),
each rank routes its own tokens with the statistics of the global call:
the capacity from the global token count, each (token, k)'s slot after
every token of lower ranks (an exclusive prefix of the per-expert counts
over the batch axes), and the load-balance term from the global
per-expert fractions and mean probabilities (a product of global means,
not a mean of the ranks' products). A rank's buffer holds its own rows
at their global slots, so every kept token sees the one-process expert
output and every dropped one is dropped there too.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import MoEConfig
from repro_torch.models.layers import _dense_init, init_mlp, mlp


def init_moe(gen: torch.Generator, d_model: int, cfg: MoEConfig, act: str,
             dtype) -> dict:
    E, ff = cfg.n_experts, cfg.d_expert_ff
    p = {
        "router": _dense_init(gen, (d_model, E), torch.float32),
        "w_gate": _dense_init(gen, (E, d_model, ff), dtype),
        "w_up": _dense_init(gen, (E, d_model, ff), dtype),
        "w_down": _dense_init(gen, (E, ff, d_model), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, d_model, ff * cfg.n_shared_experts, act,
                               dtype)
        p["shared_gate"] = _dense_init(gen, (d_model, 1), torch.float32)
    return p


def capacity(T: int, cfg: MoEConfig, capacity_factor: float = 0.0) -> int:
    """Slots per expert for T tokens (the reference's rule)."""
    cf = capacity_factor or cfg.capacity_factor
    return max(int(math.ceil(T * cfg.top_k / cfg.n_experts * cf)), 4)


def route(p: dict, xt: torch.Tensor, cfg: MoEConfig):
    """xt (T, d) -> (probs (T, E), gates (T, K), expert_idx (T, K)), in
    float32."""
    logits = xt.float() @ p["router"]                      # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)
    return probs, gate_vals, expert_idx


def moe_ffn(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str,
            capacity_factor: float = 0.0):
    """x (B, S, d) -> (out (B, S, d), aux loss ())."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(T, d)
    experts = torch.arange(E, device=x.device)

    probs, gate_vals, expert_idx = route(p, xt, cfg)

    # load-balance aux loss (Switch-style)
    first = (expert_idx[:, 0, None] == experts).float()
    split = sharding.rows_split()
    if split:   # the global call's means: sums over the ranks / global T
        T_all = sharding.global_rows(B) * S
        me = sharding.batch_sum(torch.sum(probs, dim=0)) / T_all
        ce = sharding.batch_sum(torch.sum(first, dim=0)) / T_all
    else:
        T_all = T
        me = torch.mean(probs, dim=0)                      # (E,)
        ce = torch.mean(first, dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    cap = capacity(T_all, cfg, capacity_factor)

    # position of each (token, k) assignment inside its expert's buffer:
    # a running count along (t, k) per expert, scanned along the last
    # axis ((E, T*K): a scan down the first axis of a (T*K, E) tensor
    # runs one thread per expert on the card)
    e_flat = expert_idx.reshape(T * K)
    hit = (experts[:, None] == e_flat).to(torch.int32)     # (E, T*K)
    pos = torch.cumsum(hit, dim=-1, dtype=torch.int32) - 1
    if split:   # after every token of the ranks holding earlier rows
        pos = pos + sharding.batch_prefix(
            torch.sum(hit, dim=-1, dtype=torch.int32))[:, None]
    pos_in_e = torch.sum(pos * hit, dim=0)                 # (T*K,)
    keep = pos_in_e < cap
    slot = torch.where(keep, pos_in_e, cap)                # overflow slot

    # dispatch into (E, cap+1, d): kept rows to their own slot, zeros to
    # the overflow slot
    rows = xt.repeat_interleave(K, dim=0)                  # (T*K, d)
    rows = torch.where(keep[:, None], rows, 0)
    dest = (e_flat * (cap + 1) + slot)[:, None].expand(T * K, d)
    buf = x.new_zeros((E * (cap + 1), d)).scatter(0, dest, rows)
    buf = buf.reshape(E, cap + 1, d)

    # expert FFN: grouped matmuls (E, cap+1, d) x (E, d, ff)
    if act == "silu":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    else:
        h = F.gelu(torch.bmm(buf, p["w_up"]), approximate="tanh")
    out_buf = torch.bmm(h, p["w_down"])                    # (E, cap+1, d)

    # combine: gather back, weight by gate x keep, add in k order
    gathered = out_buf[e_flat, slot]                       # (T*K, d)
    w = (gate_vals.reshape(T * K) * keep).to(x.dtype)[:, None]
    contrib = (gathered * w).reshape(T, K, d)
    yt = x.new_zeros((T, d))
    for k in range(K):
        yt = yt + contrib[:, k]

    if "shared" in p:
        sg = torch.sigmoid(xt.float() @ p["shared_gate"])
        yt = yt + mlp(p["shared"], xt, act) * sg.to(x.dtype)
    return yt.reshape(B, S, d), aux
