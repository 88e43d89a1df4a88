"""Decoder-only transformer stacks of the dense, MoE, SSM and hybrid
families.

Counterpart of ``repro.models.transformer``. The layer stack keeps the
reference's (pattern, repeats) *segments* and its stacked parameter
layout: each segment position holds one tree whose leaves carry a leading
(reps, ...) axis, so the reference's weights carry over leaf for leaf.
Where the reference scans a segment with ``lax.scan``, the port loops over
the reps in Python, indexing each stacked leaf (a view, no copy).

  dense (no SWA):     [(("attn",), n_layers)]
  gemma3 (5:1):       [(("local",)*5 + ("global",), reps), (("local",)*rem, 1)]
  moe:                [(("moe",), n_layers)]
  ssm:                [(("ssm",), n_layers)]
  hybrid (1:2):       [(("lru","lru","attn"), reps), (rem_pattern, 1)]

Caches mirror the segment structure: per segment, per pattern position,
a stacked (reps, B, ...) tree: K/V caches for attention (the local
layers' a ring of ``window`` slots), {"conv" (reps, B, 3, W), "state"
(reps, B, W)} for an RG-LRU block (``models.griffin``), {"conv" (reps, B,
W-1, conv_dim), "state" (reps, B, H, P, N)} for a Mamba-2 block
(``models.ssm``). An MoE block is attention then ``moe.moe_ffn``, whose
load-balance loss is the block's aux. The encoder-decoder and vision
families raise ``NotImplementedError`` (ROADMAP.md queue 1 C.4-C.5).

``apply_lm`` is ``embed`` then ``apply_hidden``, so a grouped caller can
gather the embeddings itself (``layers.embed_grouped``) and start from
them. A training forward (``training=True``) takes the differentiable
plain paths on every device (the flash and RG-LRU kernels have no
backward) and, with ``remat="full"``, recomputes each layer repeat in the
backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` around its scan body). ``group=True`` runs K stacked
parties of one config: the leaves carry a leading (K,) axis and so does
x, each repeat is one ``torch.func.vmap`` over the group, and the
checkpoint wraps the vmap (a checkpoint inside vmap fails in backward).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, moe as moe_mod, ssm as ssm_mod
from repro_torch.models.layers import (
    apply_norm, embed, init_attention, init_embedding, init_linear, init_mlp,
    init_norm, linear, mlp, rope_cos_sin, self_attention,
)
from repro_torch.tree import stack_drawn, tree_map

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
_DENSE_KINDS = ("attn", "local", "global")
_KINDS = _DENSE_KINDS + ("lru", "moe", "ssm")
_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _unported(what: str):
    return NotImplementedError(
        f"{what}: the dense, MoE, SSM and hybrid families are ported; the "
        f"encoder-decoder (whisper) and vision (qwen2-vl) parties are "
        f"ROADMAP.md queue 1 C.4-C.5")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise _unported(f"family {cfg.family!r}")


# ---------------------------------------------------------------------------
# stack plan
# ---------------------------------------------------------------------------


def stack_plan(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    if cfg.family == "moe":
        kinds = ("moe",)
    elif cfg.family == "ssm":
        kinds = ("ssm",)
    elif cfg.family == "hybrid":
        kinds = tuple(cfg.hybrid.pattern)
    elif cfg.window > 0:
        l, g = cfg.swa_pattern
        kinds = ("local",) * l + ("global",) * g
    else:
        kinds = ("attn",)
    p = len(kinds)
    reps, rem = divmod(cfg.n_layers, p)
    plan = []
    if reps:
        plan.append((kinds, reps))
    if rem:
        plan.append((kinds[:rem], 1))
    return plan


def _layer_window(cfg: ModelConfig, kind: str) -> int:
    if kind == "local":
        return cfg.window
    if kind == "attn" and cfg.family == "hybrid":
        return cfg.hybrid.window
    return 0


# ---------------------------------------------------------------------------
# per-kind block init / apply
# ---------------------------------------------------------------------------


def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> Params:
    if kind not in _KINDS:
        raise _unported(f"block kind {kind!r}")
    dtype = torch_dtype(cfg.dtype)
    d = cfg.d_model
    dev = gen.device
    if kind == "ssm":
        return {"ln1": init_norm(cfg.norm, d, dtype, dev),
                "ssm": ssm_mod.init_ssm(gen, d, cfg.ssm, dtype)}
    if kind == "lru":
        w = cfg.hybrid.lru_width or d
        return {"ln1": init_norm(cfg.norm, d, dtype, dev),
                "rec": griffin.init_rglru(gen, d, w, dtype),
                "ln2": init_norm(cfg.norm, d, dtype, dev),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.act, dtype)}
    p = {"ln1": init_norm(cfg.norm, d, dtype, dev),
         "attn": init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                cfg.resolved_head_dim, cfg.qkv_bias, dtype),
         "ln2": init_norm(cfg.norm, d, dtype, dev)}
    if kind == "moe":
        p["moe"] = moe_mod.init_moe(gen, d, cfg.moe, cfg.act, dtype)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.act, dtype)
    return p


def apply_block(p: Params, x: torch.Tensor, *, cfg: ModelConfig, kind: str,
                cos, sin, cache: Optional[dict], window_override: int = -1,
                causal: bool = True, training: bool = False):
    """Returns (x, new_cache, aux)."""
    if kind not in _KINDS:
        raise _unported(f"block kind {kind!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        h, new_cache = ssm_mod.ssm_block(
            p["ssm"], apply_norm(p["ln1"], x, cfg.rms_eps), cfg.ssm, cache,
            cfg.rms_eps)
        return x + h, new_cache, aux
    if kind == "lru":
        h, new_cache = griffin.recurrent_block(
            p["rec"], apply_norm(p["ln1"], x, cfg.rms_eps), cache, training)
        x = x + h
        x = x + mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.rms_eps), cfg.act)
        return x, new_cache, aux
    window = (_layer_window(cfg, kind) if window_override < 0
              else window_override)
    h, new_cache = self_attention(
        p["attn"], apply_norm(p["ln1"], x, cfg.rms_eps),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim, causal=causal, window=window,
        cos=cos, sin=sin, cache=cache, training=training)
    x = x + h
    if kind == "moe":
        h, aux = moe_mod.moe_ffn(p["moe"], apply_norm(p["ln2"], x,
                                                      cfg.rms_eps),
                                 cfg.moe, cfg.act)
    else:
        h = mlp(p["mlp"], apply_norm(p["ln2"], x, cfg.rms_eps), cfg.act)
    return x + h, new_cache, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 window_override: int = -1, per_lane: bool = False,
                 device=None):
    if kind not in _KINDS:
        raise _unported(f"block kind {kind!r}")
    dtype = torch_dtype(cfg.dtype)
    if kind == "ssm":
        return ssm_mod.init_ssm_cache(batch, cfg.d_model, cfg.ssm, dtype,
                                      device)
    if kind == "lru":
        return griffin.init_rglru_cache(
            batch, cfg.hybrid.lru_width or cfg.d_model, dtype, device)
    window = (_layer_window(cfg, kind) if window_override < 0
              else window_override)
    T = min(cache_len, window) if window > 0 else cache_len
    hd = cfg.resolved_head_dim
    # per_lane: each batch row decodes at its own position (continuous
    # batching): "idx" is (batch,) and the decode path writes and masks
    # per row (layers.self_attention)
    idx0 = torch.zeros((batch,) if per_lane else (), dtype=torch.int32,
                       device=device)
    shape = (batch, T, cfg.n_kv_heads, hd)
    if cfg.kv_quant:
        sshape = (batch, T, cfg.n_kv_heads, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.bfloat16,
                                       device=device),
                "idx": idx0}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "idx": idx0}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               window_override: int = -1, per_lane: bool = False,
               device=None):
    """Stacked cache tree mirroring stack_plan: a list of segments, each a
    {"p<i>": leaves with a leading (reps,) axis} dict."""
    _check_family(cfg)
    segs = []
    for kinds, reps in stack_plan(cfg):
        seg = {}
        for i, kind in enumerate(kinds):
            one = _block_cache(cfg, kind, batch, cache_len, window_override,
                               per_lane, device)
            seg[f"p{i}"] = tree_map(
                lambda a: a[None].repeat((reps,) + (1,) * a.dim()), one)
        segs.append(seg)
    return segs


# ---------------------------------------------------------------------------
# LM init / apply
# ---------------------------------------------------------------------------


def init_lm(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Backbone parameters on the generator's device, in the reference's
    layout (segment leaves stacked over the reps axis, each block drawn
    into its row: one copy of the weights and one block's beside it)."""
    _check_family(cfg)
    dtype = torch_dtype(cfg.dtype)
    params: Params = {
        "embed": init_embedding(gen, cfg.vocab_size, cfg.d_model, dtype),
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, gen.device),
    }
    if not cfg.tie_embeddings:
        params["head"] = init_linear(gen, cfg.d_model, cfg.vocab_size, False,
                                     dtype)
    segs = []
    for kinds, reps in stack_plan(cfg):
        # each block drawn straight into its row of the (reps, ...) leaves
        segs.append({f"p{i}": stack_drawn(
            lambda _, kind=kind: init_block(gen, cfg, kind), reps)
            for i, kind in enumerate(kinds)})
    params["segments"] = segs
    return params


def _cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.rope_theta <= 0:
        return None, None
    if cfg.family == "vlm":
        raise _unported("M-RoPE (qwen2-vl)")
    return rope_cos_sin(positions, cfg.resolved_head_dim, cfg.rope_theta)


REMAT_DOTS_TODO = ("remat='dots' (save the matmul outputs, recompute the "
                   "rest) is not ported: ROADMAP.md queue 1 item A; use "
                   "remat='full' or 'none'")


def _remat(cfg: ModelConfig, training: bool) -> bool:
    if not training or cfg.remat == "none":
        return False
    if cfg.remat == "full":
        return True
    if cfg.remat == "dots":
        raise NotImplementedError(REMAT_DOTS_TODO)
    raise ValueError(f"remat {cfg.remat!r}")


def _run_segments(params, x, *, cfg: ModelConfig, cos, sin, caches,
                  window_override: int = -1, training: bool = False,
                  group: bool = False):
    """Every layer of every (pattern, reps) segment in order. Returns
    (x, new_caches, aux); with ``group`` x, aux and the leaves carry the
    party axis in front (no caches)."""
    if caches is not None and (group or training):
        raise ValueError("a grouped or training forward carries no caches")
    remat = _remat(cfg, training)
    aux_total = torch.zeros((x.shape[0],) if group else (),
                            dtype=torch.float32, device=x.device)
    new_caches = []
    for si, (kinds, reps) in enumerate(stack_plan(cfg)):
        seg_params = params["segments"][si]
        seg_cache = caches[si] if caches is not None else None

        def rep(p_rep, x, c_rep=None, kinds=kinds):
            """One repeat of the segment's pattern: (x, new_caches, aux)."""
            aux, new_c = None, {}
            for i, kind in enumerate(kinds):
                blk_cache = c_rep[f"p{i}"] if c_rep is not None else None
                x, nc, a = apply_block(
                    p_rep[f"p{i}"], x, cfg=cfg, kind=kind, cos=cos, sin=sin,
                    cache=blk_cache, window_override=window_override,
                    training=training)
                if nc is not None:
                    new_c[f"p{i}"] = nc
                aux = a if aux is None else aux + a
            return x, new_c, aux

        if group:   # (x, aux) of every party at once
            rep = vmap(lambda p_rep, x, rep=rep: rep(p_rep, x)[::2])
        if remat:
            rep = functools.partial(checkpoint, rep, use_reentrant=False,
                                    preserve_rng_state=False)
        per_rep = []
        for r in range(reps):
            take = (lambda a: a[:, r]) if group else (lambda a: a[r])
            p_rep = tree_map(take, seg_params)
            if seg_cache is not None:
                x, new_c, a = rep(p_rep, x, tree_map(take, seg_cache))
                per_rep.append(new_c)
            elif group:
                x, a = rep(p_rep, x)
            else:
                x, _, a = rep(p_rep, x)
            aux_total = aux_total + a
        if seg_cache is not None:
            new_caches.append({
                key: tree_map(lambda *xs: torch.stack(xs),
                              *[c[key] for c in per_rep])
                for key in per_rep[0]})
        else:
            new_caches.append(None)
    return x, (new_caches if caches is not None else None), aux_total


def apply_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: Optional[torch.Tensor] = None, caches=None,
                 pos_offset=0, window_override: int = -1,
                 return_hidden: bool = False, training: bool = False,
                 group: bool = False):
    """The stack after the token embedding: x (B, S, d_model), or (K, B,
    S, d_model) with ``group``. Returns (logits | hidden, new_caches,
    aux); ``group`` returns the hidden states only."""
    _check_family(cfg)
    B, S = x.shape[-3:-1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None] + pos_offset
        positions = positions.expand(B, S)
    cos, sin = _cos_sin(cfg, positions)
    x, new_caches, aux = _run_segments(
        params, x, cfg=cfg, cos=cos, sin=sin, caches=caches,
        window_override=window_override, training=training, group=group)
    if group:
        if not return_hidden:
            raise ValueError("a grouped forward returns the hidden states")
        norm = vmap(lambda p, x: apply_norm(p, x, cfg.rms_eps))
        return norm(params["final_norm"], x), None, aux
    x = apply_norm(params["final_norm"], x, cfg.rms_eps)
    if return_hidden:
        return x, new_caches, aux
    if cfg.tie_embeddings:
        logits = x @ params["embed"]["table"].T
    else:
        logits = linear(params["head"], x)
    return logits, new_caches, aux


def apply_lm(params: Params, tokens: torch.Tensor, cfg: ModelConfig, *,
             positions: Optional[torch.Tensor] = None, caches=None,
             pos_offset=0, window_override: int = -1,
             return_hidden: bool = False, training: bool = False,
             **frontend):
    """Forward pass. tokens (B, S). Returns (logits | hidden, new_caches,
    aux). Decode: pass ``caches`` (from init_cache or the previous step)
    and ``pos_offset`` = the current sequence index (an int, a 0-d tensor
    or a (B, 1) tensor of per-lane positions)."""
    _check_family(cfg)
    if frontend:
        raise _unported(f"frontend inputs {sorted(frontend)}")
    return apply_hidden(params, embed(params["embed"], tokens), cfg,
                        positions=positions, caches=caches,
                        pos_offset=pos_offset,
                        window_override=window_override,
                        return_hidden=return_hidden, training=training)
