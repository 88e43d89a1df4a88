"""Transformer stacks of every family: decoder-only (dense, MoE, SSM,
hybrid, vision) and encoder-decoder.

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
load-balance loss is the block's aux.

Frontends (the modality towers are stubs, as in the reference): the
encoder-decoder (whisper) runs ``encode`` over precomputed frame
embeddings (``audio_embed``, B x F x d) with fixed sinusoidal positions
and non-causal self-attention, projects the encoder output once into
every decoder layer's cross K/V (``_encoder_kv``, passed back as
``enc_kv`` in decode), and inserts a cross-attention after each decoder
block's MLP, as the reference does. Under a plan's tensor-parallel
compute the encoder is a stack of its own (its stream over the F frames
sequence-parallel where F divides the model axis, its blocks split as
the decoder's), and where the attention splits by heads the cross K/V
and the cross-attention are computed on the rank's heads. The decoder
adds sinusoidal positions to its token embeddings (``rope_theta = 0``).
The vision family (qwen2-vl) writes the patch embeddings
(``vision_embed``) over the first positions of a prompt at least as long
as them, and takes M-RoPE cos/sin from ``mrope_pos`` (3, B, S) when
given, plain RoPE otherwise.

``apply_lm`` is ``embed`` then ``apply_hidden``, so a grouped caller can
gather the embeddings itself (``layers.embed_grouped``) and start from
them; the patch insert and the decoder's sinusoidal positions are in
``apply_hidden``, which both routes pass. A training forward (``training=True``) takes the differentiable
plain paths on every device (the flash and RG-LRU kernels have no
backward) and, with ``remat="full"``, recomputes each layer repeat in the
backward pass (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` around its scan body); ``remat="dots"`` saves the
repeat's matrix products and recomputes the rest (a selective
checkpoint, the reference's ``dots_saveable`` policy). ``group=True``
runs K stacked parties of one config: the leaves carry a leading (K,)
axis and so does x, each repeat is one ``torch.func.vmap`` over the
group, and the checkpoint wraps the vmap (a checkpoint inside vmap fails
in backward).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.func import vmap
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.models import griffin, moe as moe_mod, ssm as ssm_mod
from repro_torch.models.layers import (
    apply_norm, cross_attend, embed, init_attention, init_embedding,
    init_linear, init_mlp, init_norm, linear, mlp, mrope_cos_sin,
    rope_cos_sin, self_attention,
)
from repro_torch.tree import stack_drawn, tree_map

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}
# "xattn" is the reference's public decoder block with its own
# cross-attention leaves; stack_plan never yields it (encdec keeps its
# cross-attention in params["xattn"])
_KINDS = ("attn", "local", "global", "xattn", "lru", "moe", "ssm")
_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"family {cfg.family!r} (one of {_FAMILIES})")


def _check_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"block kind {kind!r} (one of {_KINDS})")


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
    _check_kind(kind)
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
    if kind == "xattn":
        p["lnx"] = init_norm(cfg.norm, d, dtype, dev)
        p["xattn"] = init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.resolved_head_dim, cfg.qkv_bias,
                                    dtype)
    return p


def apply_block(p: Params, x: torch.Tensor, *, cfg: ModelConfig, kind: str,
                cos, sin, cache: Optional[dict], window_override: int = -1,
                causal: bool = True, training: bool = False, tp=None):
    """Returns (x, new_cache, aux). An "xattn" block applies as "attn"
    (its cross-attention leaves are unused), as in the reference.

    ``tp`` (``sharding.TP``, under a plan's tensor-parallel compute): the
    dense attention (``tp.attn`` "heads" / "kv"), MLP (``tp.mlp``), MoE
    FFN (``tp.moe``), SSD mixer (``tp.ssd``) and RG-LRU mixer (``tp.lru``)
    on this rank's "model" block, their norms on the stream as it lies
    (this rank's S block where ``tp.seq``); every other sub-block (an
    attention whose split would cut a head, a block whose widths do not
    divide the model axis) gathered and run whole (``tp.whole``), a whole
    attention's T-split cache (``tp.kv_t``) kept as this rank's T block.
    The encoder's blocks take the encoder stream's ``tp`` (``encode``);
    an encoder-decoder's cross-attention follows the block
    (``_apply_xattn``). Without it every sub-block runs whole."""
    _check_kind(kind)
    tp = tp if tp is not None else sharding.WHOLE
    eps = cfg.rms_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    norm = lambda name, x: apply_norm(tp.rep(p[name]), x, eps)

    def ffn(x):
        if kind == "moe" and tp.moe:
            h, a = moe_mod.moe_ffn(p["moe"], norm("ln2", x), cfg.moe, cfg.act,
                                   tp=tp)
            return x + h, a
        if kind == "moe":
            def whole(x):
                h, a = moe_mod.moe_ffn(p["moe"], apply_norm(p["ln2"], x, eps),
                                       cfg.moe, cfg.act)
                return x + h, a
            return tp.whole(x, whole)
        if tp.mlp:
            return x + mlp(p["mlp"], norm("ln2", x), cfg.act, tp), aux
        return tp.whole(x, lambda x: (x + mlp(
            p["mlp"], apply_norm(p["ln2"], x, eps), cfg.act), aux))

    if kind == "ssm":
        if tp.ssd:
            h, new_cache = ssm_mod.ssm_block(p["ssm"], norm("ln1", x),
                                             cfg.ssm, cache, eps, tp=tp)
            return x + h, new_cache, aux

        def whole(x):
            h, c = ssm_mod.ssm_block(p["ssm"], apply_norm(p["ln1"], x, eps),
                                     cfg.ssm, cache, eps)
            return x + h, c
        x, new_cache = tp.whole(x, whole)
        return x, new_cache, aux
    if kind == "lru":
        if tp.lru:
            h, new_cache = griffin.recurrent_block(
                p["rec"], norm("ln1", x), cache, training, tp=tp)
            x = x + h
        else:
            def whole(x):
                h, c = griffin.recurrent_block(
                    p["rec"], apply_norm(p["ln1"], x, eps), cache, training)
                return x + h, c
            x, new_cache = tp.whole(x, whole)
        x, _ = ffn(x)
        return x, new_cache, aux
    window = (_layer_window(cfg, kind) if window_override < 0
              else window_override)
    kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
              head_dim=cfg.resolved_head_dim, causal=causal, window=window,
              cos=cos, sin=sin, cache=cache, training=training)
    if tp.attn != "whole":
        h, new_cache = self_attention(p["attn"], norm("ln1", x), tp=tp, **kw)
        x = x + h
    else:
        def whole(x):       # a T-split cache (tp.kv_t) stays this rank's
            h, c = self_attention(p["attn"], apply_norm(p["ln1"], x, eps),
                                  tp=tp, **kw)
            return x + h, c
        x, new_cache = tp.whole(x, whole)
    x, aux = ffn(x)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------


def _block_cache(cfg: ModelConfig, kind: str, batch: int, cache_len: int,
                 window_override: int = -1, per_lane: bool = False,
                 device=None):
    _check_kind(kind)
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
    into its row: one copy of the weights and one block's beside it). An
    encoder-decoder adds "encoder" ({"blocks": (n_encoder_layers, ...),
    "norm"}) and "xattn" ({"lnx", "attn"}, (n_layers, ...))."""
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
    if cfg.family == "encdec":
        dtype_ = torch_dtype(cfg.dtype)
        params["encoder"] = {
            "blocks": stack_drawn(lambda _: init_block(gen, cfg, "attn"),
                                  cfg.n_encoder_layers),
            "norm": init_norm(cfg.norm, cfg.d_model, dtype_, gen.device)}
        params["xattn"] = stack_drawn(lambda _: {
            "lnx": init_norm(cfg.norm, cfg.d_model, dtype_, gen.device),
            "attn": init_attention(gen, cfg.d_model, cfg.n_heads,
                                   cfg.n_kv_heads, cfg.resolved_head_dim,
                                   cfg.qkv_bias, dtype_)}, cfg.n_layers)
    return params


def _sinusoid_rows(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Fixed sinusoidal positions [sin | cos] in float32, (..., d) for
    ``positions`` (...): the rows of the reference's table (32,776 x d,
    built whole on every apply_lm call there), computed alone, since
    every entry depends on its own position only."""
    i = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    ang = positions.float()[..., None] / torch.pow(10000.0, 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _sinusoid(S: int, d: int, dtype, device=None) -> torch.Tensor:
    """The first S rows (S, d), cast to ``dtype``."""
    return _sinusoid_rows(torch.arange(S, device=device), d).to(dtype)


def _cos_sin(cfg: ModelConfig, positions: torch.Tensor,
             mrope_pos: Optional[torch.Tensor] = None):
    hd = cfg.resolved_head_dim
    if cfg.rope_theta <= 0:
        return None, None
    if cfg.family == "vlm" and mrope_pos is not None:
        return mrope_cos_sin(mrope_pos, hd, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, hd, cfg.rope_theta)


# the matrix products whose outputs remat="dots" saves (jax's
# dots_saveable saves every dot_general's): linear layers, einsums and
# the attention's batched products reach these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_context():
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(cfg: ModelConfig, training: bool):
    """The checkpoint that wraps each repeat of a training forward, or
    None: ``remat="full"`` recomputes the repeat in the backward pass;
    ``"dots"`` saves its matrix products' outputs and recomputes the rest
    (the reference's ``jax.checkpoint_policies.dots_saveable``)."""
    if not training or cfg.remat == "none":
        return None
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"remat {cfg.remat!r}")
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "dots":
        kw["context_fn"] = _dots_context
    return functools.partial(checkpoint, **kw)


def _run_segments(params, x, *, cfg: ModelConfig, cos, sin, caches,
                  window_override: int = -1, training: bool = False,
                  group: bool = False, xattn=None):
    """Every layer of every (pattern, reps) segment in order. Returns
    (x, new_caches, aux); with ``group`` x, aux and the leaves carry the
    party axis in front (no caches). ``xattn`` = (cross-attention params,
    k, v), leaves with a leading layer axis (behind the party axis with
    ``group``): layer l's cross-attention follows layer l's block."""
    if caches is not None and (group or training):
        raise ValueError("a grouped or training forward carries no caches")
    remat = _remat(cfg, training)
    if xattn is not None:
        # a decoder layer's cross-attention reads lnx, wq and wo (its K/V
        # come made): only those leaves are taken
        xp, k, v = xattn
        xattn = ({"lnx": xp["lnx"],
                  "attn": {n: xp["attn"][n] for n in ("wq", "wo")}}, k, v)
    aux_total = torch.zeros((x.shape[0],) if group else (),
                            dtype=torch.float32, device=x.device)
    # under a plan's layout "tp", the dense blocks compute over "model":
    # the stream between layers is this rank's S block where S divides
    tp = sharding.stack_tp(cfg, x.shape[-2])
    if tp is not None and tp.seq:
        x = sharding.split_seq(x, tp.mesh)
    new_caches = []
    layer = 0
    for si, (kinds, reps) in enumerate(stack_plan(cfg)):
        seg_params = params["segments"][si]
        seg_cache = caches[si] if caches is not None else None
        if xattn is not None and len(kinds) != 1:
            raise ValueError("cross-attention needs a pattern of length 1")
        # each block's split, bound here (a recompute in the backward runs
        # outside the plan's scopes)
        tps = {f"p{i}": (sharding.block_tp(tp, si, f"p{i}")
                         if seg_cache is not None else tp)
               for i in range(len(kinds))}
        sharding.count_tp("kv T", reps * sum(
            t is not None and t.kv_t for t in tps.values()))

        def rep(p_rep, x, c_rep=None, x_rep=None, kinds=kinds, tps=tps):
            """One repeat of the segment's pattern: (x, new_caches, aux)."""
            aux, new_c = None, {}
            for i, kind in enumerate(kinds):
                blk_cache = c_rep[f"p{i}"] if c_rep is not None else None
                x, nc, a = apply_block(
                    p_rep[f"p{i}"], x, cfg=cfg, kind=kind, cos=cos, sin=sin,
                    cache=blk_cache, window_override=window_override,
                    training=training, tp=tps[f"p{i}"])
                if nc is not None:
                    new_c[f"p{i}"] = nc
                aux = a if aux is None else aux + a
                if x_rep is not None:
                    x = _apply_xattn(x_rep, x, cfg, training, tp)
            return x, new_c, aux

        if group:   # (x, aux) of every party at once
            rep = vmap(lambda p_rep, x, x_rep, rep=rep:
                       rep(p_rep, x, None, x_rep)[::2],
                       in_dims=(0, 0, None if xattn is None else 0))

        take = sharding.layer_taker(("segments", si), group, tp)
        xtake = (None if xattn is None
                 else sharding.layer_taker(("xattn",), group,
                                           sharding.cross_tp(tp), "xattn"))

        def run(seg_params, x, xattn, r, layer=layer, rep=rep, take=take):
            """Repeat r from the segment's stacked leaves: each layer's
            leaves taken here (under a sharding plan, gathered here), so
            that a checkpointed repeat gathers them again in its
            recompute instead of saving them."""
            p_rep = take(seg_params, r)
            x_rep = None
            if xattn is not None:
                xp, k, v = xattn
                sel = (lambda a: a[:, layer + r]) if group else \
                    (lambda a: a[layer + r])
                x_rep = (xtake(xp, layer + r), sel(k), sel(v))
            if group:
                return rep(p_rep, x, x_rep)
            return rep(p_rep, x, None, x_rep)[::2]

        if remat is not None:
            # under TP the recompute in the backward issues the repeat's
            # collectives (its leaves' gathers, the stream's all-gathers
            # and reduce-scatters) again, in the forward's order: every
            # rank recomputes the same repeats in the same order. Under
            # "dots" only the matrix products come from the saved outputs;
            # every collective runs again, on every rank alike
            run = functools.partial(remat, run)
        per_rep = []
        for r in range(reps):
            if seg_cache is not None:
                x_rep = None
                if xattn is not None:
                    xp, k, v = xattn
                    x_rep = (xtake(xp, layer + r), k[layer + r],
                             v[layer + r])
                x, new_c, a = rep(take(seg_params, r), x,
                                  sharding.cache_in(seg_cache, si, r, tp),
                                  x_rep)
                per_rep.append(sharding.cache_out(new_c, si, tp))
            else:
                x, a = run(seg_params, x, xattn, r)
            aux_total = aux_total + a
        layer += reps * len(kinds)
        if seg_cache is not None:
            new_caches.append({
                key: tree_map(lambda *xs: torch.stack(xs),
                              *[c[key] for c in per_rep])
                for key in per_rep[0]})
        else:
            new_caches.append(None)
    if tp is not None and tp.seq:
        x = sharding.join_seq(x, tp.mesh)
    return x, (new_caches if caches is not None else None), aux_total


def _apply_xattn(x_rep, x: torch.Tensor, cfg: ModelConfig,
                 training: bool = False, tp=None) -> torch.Tensor:
    """The decoder's cross-attention insert for one layer: x_rep =
    (params, k, v), k/v (B, F, Hkv, hd) of the encoder output. Under a
    stack ``tp`` whose attention splits by heads (``sharding.cross_tp``)
    on this rank's heads: the norm on the stream as it lies, the stream
    entered (``tp.enter``), q by this rank's columns of wq (Hq / m
    heads) against its Hkv / m heads of k/v (``_encoder_kv``), wo by rows
    into the stream (``tp.exit``), a wo bias added once after the
    reduction; under any other ``tp`` gathered and run whole
    (``tp.whole``)."""
    xp, ek, ev = x_rep
    hd = cfg.resolved_head_dim
    tp = tp if tp is not None else sharding.WHOLE
    xtp = sharding.cross_tp(tp)

    def attend(x, xtp):
        h = xtp.enter(apply_norm(xtp.rep(xp["lnx"]), x, cfg.rms_eps))
        B, S, _ = h.shape
        hq = cfg.n_heads // xtp.m
        q = linear(xp["attn"]["wq"], h).reshape(B, S, hq, hd)
        o = cross_attend(q, ek, ev, training)
        out = xtp.exit(o.reshape(B, S, hq * hd) @ xp["attn"]["wo"]["w"])
        if "b" in xp["attn"]["wo"]:
            out = out + xtp.rep(xp["attn"]["wo"]["b"])
        return (x + out,)

    if xtp is not None:
        return attend(x, xtp)[0]
    return tp.whole(x, lambda x: attend(x, sharding.WHOLE))[0]


def _layer_stack(tree, path, n: int, group: bool, tp=None, label=None):
    """Layers 0..n-1 of (n, ...) leaves, or of (K, n, ...) leaves with
    ``group``, one at a time (``sharding.layer_taker``: under a plan each is
    gathered when the loop reaches it, a leaf that ``tp`` computes on as
    its "model" block kept so)."""
    take = sharding.layer_taker(path, group, tp, label)
    return (take(tree, l) for l in range(n))


def encode(params: Params, audio_embed: torch.Tensor, cfg: ModelConfig, *,
           training: bool = False, group: bool = False) -> torch.Tensor:
    """Whisper-style encoder over stubbed frame embeddings (B, F, d):
    sinusoidal positions, then ``n_encoder_layers`` non-causal attention
    blocks and a norm. ``group``: the leaves carry K stacked parties in
    front, and so does the output (K, B, F, d). Under a plan's
    tensor-parallel compute the blocks split as a stack over F positions
    does (``sharding.stack_tp(cfg, F)``: the attention by heads where they
    divide the model axis, the MLP by columns and rows, the stream this
    rank's F block where F divides it); the stream is joined whole before
    the final norm, so the output is whole on every model rank."""
    x = audio_embed + _sinusoid(audio_embed.shape[-2], cfg.d_model,
                                audio_embed.dtype, audio_embed.device)
    enc = params["encoder"]
    tp = sharding.stack_tp(cfg, x.shape[-2])

    def block(p, x):
        return apply_block(p, x, cfg=cfg, kind="attn", cos=None, sin=None,
                           cache=None, causal=False, training=training,
                           tp=tp)[0]

    norm = functools.partial(apply_norm, eps=cfg.rms_eps)
    if group:
        block, norm = vmap(block), vmap(norm)
        x = x.expand((enc["norm"]["scale"].shape[0],) + tuple(x.shape))
    if tp is not None and tp.seq:
        x = sharding.split_seq(x, tp.mesh)
    for p in _layer_stack(enc["blocks"], ("encoder", "blocks"),
                          cfg.n_encoder_layers, group, tp, "enc"):
        x = block(p, x)
    if tp is not None and tp.seq:
        x = sharding.join_seq(x, tp.mesh)
    return norm(enc["norm"], x)


def _encoder_kv(params: Params, enc_out: torch.Tensor, cfg: ModelConfig, *,
                group: bool = False):
    """Every decoder layer's cross K/V from the encoder output (B, F, d):
    (k, v), each (n_layers, B, F, Hkv, hd). ``group``: enc_out (K, B, F,
    d) and leaves with K in front give (K, n_layers, B, F, Hkv, hd),
    laid out layer-major, so that one layer's K/V across the group,
    ``k[:, l]``, is one contiguous block. Where the cross-attention
    splits by heads (``sharding.cross_tp``) each layer's K/V are this
    rank's Hkv / m heads, from its columns of wk / wv (and of their
    biases); enc_out, whole on every model rank, enters once
    (``copy_to_model``: its cotangents are partial)."""
    tp = sharding.cross_tp(sharding.stack_tp(cfg, enc_out.shape[-2]))
    hk = cfg.n_kv_heads // (1 if tp is None else tp.m)
    shape = enc_out.shape[:-1] + (hk, cfg.resolved_head_dim)
    if tp is not None:
        enc_out = sharding.copy_to_model(enc_out, tp.mesh)
    lin = vmap(linear) if group else linear
    ks, vs = [], []
    for p in _layer_stack(params["xattn"], ("xattn",), cfg.n_layers, group,
                          tp):
        ks.append(lin(p["attn"]["wk"], enc_out).reshape(shape))
        vs.append(lin(p["attn"]["wv"], enc_out).reshape(shape))
    k, v = torch.stack(ks), torch.stack(vs)
    return (k.transpose(0, 1), v.transpose(0, 1)) if group else (k, v)


def apply_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: Optional[torch.Tensor] = None, caches=None,
                 pos_offset=0, window_override: int = -1,
                 return_hidden: bool = False, training: bool = False,
                 group: bool = False,
                 mrope_pos: Optional[torch.Tensor] = None,
                 vision_embed: Optional[torch.Tensor] = None,
                 audio_embed: Optional[torch.Tensor] = None,
                 enc_kv: Optional[Tuple] = None):
    """The stack after the token embedding: x (B, S, d_model), or (K, B,
    S, d_model) with ``group``. Returns (logits | hidden, new_caches,
    aux); ``group`` returns the hidden states only.

    Frontend inputs, shared by every party of a group: ``vision_embed``
    (B, n_vision_tokens, d) replaces the first positions of a prompt at
    least that long (decode steps carry no patches); ``mrope_pos`` (3, B,
    S) gives a vision model M-RoPE; an encoder-decoder takes
    ``audio_embed`` (B, F, d), encoded here, or the cross K/V ``enc_kv``
    computed from it once (``_encoder_kv``; with ``group`` K stacked
    ones)."""
    _check_family(cfg)
    B, S = x.shape[-3:-1]
    if cfg.family == "vlm" and vision_embed is not None \
            and S >= vision_embed.shape[-2]:
        n = vision_embed.shape[-2]
        ve = vision_embed.to(x.dtype).expand(x.shape[:-2] + (n, x.shape[-1]))
        x = torch.cat([ve, x[..., n:, :]], dim=-2)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None] + pos_offset
        positions = positions.expand(B, S)
    cos, sin = _cos_sin(cfg, positions, mrope_pos)
    xattn = None
    if cfg.family == "encdec":
        if cfg.rope_theta <= 0:
            # sinusoidal absolute positions for the whisper-style decoder
            x = x + _sinusoid_rows(positions, cfg.d_model).to(x.dtype)
        if enc_kv is None:
            if audio_embed is None:
                # the reference asserts here; a caller that feeds tokens
                # only (the launchers) gets this error, not invented audio
                raise ValueError(
                    f"{cfg.name}: an encoder-decoder needs audio_embed "
                    f"(B, {cfg.n_audio_frames}, {cfg.d_model}) frame "
                    f"embeddings or their enc_kv (EasterLM.encoder_kv)")
            enc_kv = _encoder_kv(
                params, encode(params, audio_embed, cfg, training=training,
                               group=group), cfg, group=group)
        k, v = enc_kv
        xattn = (params["xattn"], k, v)
    x, new_caches, aux = _run_segments(
        params, x, cfg=cfg, cos=cos, sin=sin, caches=caches,
        window_override=window_override, training=training, group=group,
        xattn=xattn)
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
    or a (B, 1) tensor of per-lane positions). ``frontend``: the
    ``apply_hidden`` keywords ``mrope_pos``, ``vision_embed``,
    ``audio_embed`` and ``enc_kv``."""
    return apply_hidden(params, embed(params["embed"], tokens), cfg,
                        positions=positions, caches=caches,
                        pos_offset=pos_offset,
                        window_override=window_override,
                        return_hidden=return_hidden, training=training,
                        **frontend)
