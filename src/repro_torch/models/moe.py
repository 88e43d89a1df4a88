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

Over "model" (``tp``, layout "tp"), where the reference pins the dispatch
buffer to ("model", "batch", None) and GSPMD inserts an all-to-all, the
port moves activations with the dense MLP's operators instead. Each rank
routes the stream as it lies (its S block, or the whole stream), the
gates and expert indices are made whole along S as the stream is
entered (``tp.enter``: an all-gather over "model", or nothing), every
rank dispatches the tokens of its data rows into its own experts' slots
only ("experts": E / m experts a rank, the slots and capacity those of
the global call) or into every expert's ff columns ("ff"), runs the
three products on its blocks, combines with the other ranks' experts at
weight zero, adds its block of the shared experts, and one ``tp.exit``
(a reduce-scatter, or an all-reduce) sums the ranks' partial outputs.
A ragged all-to-all would need split sizes that depend on the routing,
which ``torch.func.vmap`` (the passive MoE proxies) refuses, and a
fixed-size one moves K times the gather's bytes; a decode round (a whole
stream) moves one all-reduce of (B, 1, d) a layer.
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
            capacity_factor: float = 0.0, tp=None):
    """x (B, S, d) -> (out (B, S, d), aux loss ()). Under ``tp`` (a
    ``sharding.TP`` whose ``moe`` is "experts" or "ff") x is the stream as
    it lies (this rank's S block where ``tp.seq``) and so is the output:
    the layer computes on this rank's "model" block (module docstring)."""
    tp = tp if tp is not None else sharding.WHOLE
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    experts = torch.arange(E, device=x.device)

    # routed on the stream as it lies (the router's cotangent, partial on
    # an S block, summed over "model" by ``tp.rep``)
    x_lies = x.reshape(B * S, d)
    probs, gate_vals, expert_idx = route({"router": tp.rep(p["router"])},
                                         x_lies, cfg)

    # load-balance aux loss (Switch-style)
    first = (expert_idx[:, 0, None] == experts).float()
    split = sharding.rows_split()
    if split or tp.seq:   # the global call's means: sums over the ranks
        T_all = sharding.global_rows(B) * S * (tp.m if tp.seq else 1)
        total = lambda v: sharding.batch_sum(
            sharding.reduce_from_model(v, tp.mesh) if tp.seq else v)
        me = total(torch.sum(probs, dim=0)) / T_all
        ce = total(torch.sum(first, dim=0)) / T_all
    else:
        T_all = B * S
        me = torch.mean(probs, dim=0)                      # (E,)
        ce = torch.mean(first, dim=0)
    aux = cfg.router_aux_coef * E * torch.sum(me * ce)

    cap = capacity(T_all, cfg, capacity_factor)

    # the tokens of this rank's rows, their gates and experts, whole along
    # S (gates and shared gate entered as the stream is: their cotangents
    # from this rank's partial output are summed over "model")
    x = tp.enter(x)
    S_all = x.shape[1]
    T = B * S_all
    xt = x.reshape(T, d)
    gate_vals = tp.enter(gate_vals.reshape(B, S, K)).reshape(T, K)
    expert_idx = tp.enter(expert_idx.reshape(B, S, K)).reshape(T, K)

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
    E_here = E
    if tp.moe == "experts":
        # this rank's experts only: another rank's (token, k) is written
        # as a zero row to this rank's first expert's overflow slot, and
        # combined with weight 0
        E_here = E // tp.m
        e0 = tp.coord * E_here
        mine = (e_flat >= e0) & (e_flat < e0 + E_here)
        keep = keep & mine
        e_flat = torch.where(mine, e_flat - e0, 0)
        slot = torch.where(keep, slot, cap)

    # dispatch into (E_here, cap+1, d): kept rows to their own slot, zeros
    # to the overflow slot
    rows = xt.repeat_interleave(K, dim=0)                  # (T*K, d)
    rows = torch.where(keep[:, None], rows, 0)
    dest = (e_flat * (cap + 1) + slot)[:, None].expand(T * K, d)
    buf = x.new_zeros((E_here * (cap + 1), d)).scatter(0, dest, rows)
    buf = buf.reshape(E_here, cap + 1, d)

    # expert FFN: grouped matmuls (E, cap+1, d) x (E, d, ff), on this
    # rank's experts or ff columns under ``tp``
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
        # the shared experts on this rank's columns / rows under ``tp``,
        # their gate on the stream as it lies
        sg = torch.sigmoid(x_lies.float() @ tp.rep(p["shared_gate"]))
        sg = tp.enter(sg.reshape(B, S, 1)).reshape(T, 1)
        yt = yt + mlp(p["shared"], xt, act) * sg.to(x.dtype)
    return tp.exit(yt.reshape(B, S_all, d)), aux
