"""Step builders and abstract input specs for the dry run and the
launchers (counterpart of ``repro.launch.steps``).

The reference works on ``ShapeDtypeStruct``s so that its 512-device dry
run can lower and compile the full-size configs on a CPU host. The port's
stand-in is the meta device: ``input_specs``, ``abstract_params`` and
``abstract_state`` return meta tensors (shapes and dtypes, no storage),
and the step functions below run on them as they run on real tensors
(the kernel dispatcher sends every non-CUDA tensor to the plain
versions, which compute nothing on meta).

The sharding half: ``use_fsdp`` and ``train_shardings`` /
``serve_shardings`` / ``prefill_shardings`` return the reference's (in,
out) spec tuples (``repro_torch.sharding``'s rules), and ``shard_step``
runs a built step under the plan of a mesh on this rank's blocks
(``sharding.shard_tree`` cuts them): the counterpart of ``to_shardings``
+ ``jax.jit(in_shardings=, out_shardings=)``, which has none of its own.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch import sharding as shard_rules
from repro_torch.configs.base import EasterConfig, InputShape, ModelConfig
from repro_torch.core import train_loop
from repro_torch.core.easter_lm import EasterLM
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_map


def default_easter(cfg: ModelConfig, enabled: bool = True) -> EasterConfig:
    """LLM-scale EASTER defaults: C = 4 parties (the paper's setting),
    d_embed scaled to the family."""
    d_embed = max(128, min(1024, cfg.d_model // 4))
    return EasterConfig(num_passive=3, d_embed=d_embed, enabled=enabled)


def make_system(cfg: ModelConfig, easter: Optional[EasterConfig] = None,
                engine: str = "vectorized", group=None,
                device=None) -> EasterLM:
    """The EasterLM of ``cfg``; ``group`` is the sharded engine's party
    group (the reference's ``mesh=``), ``device`` None = the card."""
    return EasterLM(cfg=cfg, easter=easter or default_easter(cfg),
                    engine=engine, device=device, group=group)


# ---------------------------------------------------------------------------
# abstract inputs
# ---------------------------------------------------------------------------


def _long_ctx_override(cfg: ModelConfig, shape: InputShape) -> int:
    """Window override for long_500k on otherwise-full-attention archs."""
    if shape.name == "long_500k" and cfg.long_ctx_window:
        return cfg.long_ctx_window
    return -1


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape,
                sys: EasterLM) -> Dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this shape: the
    batch; for decode also the caches (``sys.init_caches`` on meta), the
    position (an int, the cache's last slot: the port derives a round's
    PRF keys from it on the host) and, for an encoder-decoder, the
    ``fe_list`` of ``encoder_kv``. ``sys`` must live on the meta
    device."""
    B, S = shape.global_batch, shape.seq_len
    adt = torch_dtype(cfg.dtype)
    frontend = {}
    if cfg.family == "encdec":
        frontend["audio_embed"] = _meta(
            (B, cfg.n_audio_frames, cfg.d_model), adt)
    if cfg.family == "vlm":
        frontend["vision_embed"] = _meta(
            (B, cfg.n_vision_tokens, cfg.d_model), adt)
    tok = _meta((B, S), torch.int32)
    if shape.kind == "train":
        return {"batch": {"tokens": tok,
                          "labels": _meta((B, S), torch.int32),
                          **frontend}}
    if shape.kind == "prefill":
        return {"batch": {"tokens": tok, **frontend}}
    # decode: one new token against a cache of length seq_len
    wo = _long_ctx_override(cfg, shape)
    out = {"batch": {"tokens": _meta((B, 1), torch.int32)},
           "caches": sys.init_caches(B, S, wo),
           "pos": S - 1}
    if cfg.family == "encdec":
        out["fe_list"] = sys.encoder_kv(abstract_params(sys),
                                        frontend["audio_embed"])
    return out


def abstract_params(sys: EasterLM):
    """``sys.init_params`` on the meta device: the parameter tree's shapes
    and dtypes, nothing drawn (``sys`` must live on the meta device)."""
    return sys.init_params(MetaGenerator())


def abstract_state(sys: EasterLM, optimizer):
    """(abstract params, the optimizer state ``optimizer`` (a name or an
    Optimizer) allocates for them, on meta: adam's float32 m and v)."""
    params = abstract_params(sys)
    opt = (optimizer if callable(getattr(optimizer, "init", None))
           else make_optimizer(optimizer, 1e-3))
    return params, opt.init({"parties": params["parties"]})


# ---------------------------------------------------------------------------
# step builders
# ---------------------------------------------------------------------------


def build_train_step(sys: EasterLM, optimizer, lr: float = 1e-4,
                     grad_clip: float = 1.0):
    """(train_step, opt) for one optimizer step.

    ``optimizer``: a name (one optimizer over every party's subtree,
    global-norm clipped jointly; on the sharded engine the norm sums over
    the ranks) or a prebuilt ``Optimizer`` / ``optim.make_party_optimizers``
    partitioned optimizer (per-party optimization, paper §IV-E; ``lr`` and
    ``grad_clip`` then live in the per-party specs). The step is
    ``core/train_loop.make_train_step``, the one a ``train_chunk`` runs."""
    opt = (optimizer if callable(getattr(optimizer, "update", None))
           else make_optimizer(optimizer, lr, grad_clip=grad_clip,
                               norm_reduce=sys.sum_over_ranks))
    return train_loop.make_train_step(sys, opt), opt


def build_serve_step(sys: EasterLM, shape: InputShape):
    """``serve_step(params, batch, caches, pos, fe_list=None) -> (logits,
    caches)``: one decode round. The DH ceremony is resolved once, here
    (``mask_seeds`` is memoized)."""
    seeds = sys.mask_seeds()
    wo = _long_ctx_override(sys.cfg, shape)

    def serve_step(params, batch, caches, pos, fe_list=None):
        return sys.serve_step(params, batch["tokens"], caches, pos, seeds,
                              window_override=wo, fe_list=fe_list)

    return serve_step


def build_prefill_step(sys: EasterLM, shape: InputShape):
    """``prefill_step(params, batch, round_idx=0) -> (E, caches)`` over
    fresh caches of the prompt's length. ``round_idx`` is the per-request
    nonce: a serving caller passes a fresh one per request, or two
    fresh-mask prefills reuse the pairwise pads (``EasterLM.prefill``)."""
    seeds = sys.mask_seeds()
    wo = _long_ctx_override(sys.cfg, shape)

    def prefill_step(params, batch, round_idx=0):
        B, S = batch["tokens"].shape
        fe = {k: v for k, v in batch.items() if k.endswith("_embed")}
        fe_list = [dict(fe) for _ in range(sys.C)] if fe else None
        caches = sys.init_caches(B, S, wo)
        return sys.prefill(params, batch["tokens"], caches,
                           window_override=wo, fe_list=fe_list, seeds=seeds,
                           round_idx=round_idx)

    return prefill_step


# ---------------------------------------------------------------------------
# sharding assembly
# ---------------------------------------------------------------------------


def use_fsdp(sys: EasterLM, kind: str = "train") -> bool:
    """FSDP parameter sharding for actives too big to replicate over the
    data axes: size-based for every step kind, as in the reference."""
    return sys.cfg.param_count() > 1e10


def train_shardings(sys: EasterLM, mesh, specs, params, opt_state,
                    zero1: bool = False, layout: str = "tp"):
    """(in specs, out specs) of ``build_train_step``'s step: params,
    optimizer state (ZeRO-1 with ``zero1``), batch, step."""
    P = shard_rules.P
    fsdp = use_fsdp(sys)
    pspec = shard_rules.param_specs(params, mesh, fsdp, layout)
    ospec = shard_rules.opt_state_specs(opt_state, params, mesh, zero1=zero1,
                                        fsdp=fsdp, layout=layout)
    bspec = shard_rules.batch_specs(specs["batch"], mesh, layout)
    return (pspec, ospec, bspec, P()), (pspec, ospec,
                                        {"loss": P(), "per_party": P()})


def serve_shardings(sys: EasterLM, mesh, specs, params,
                    fsdp: Optional[bool] = None):
    """(in specs, out specs) of ``build_serve_step``'s step: params, batch,
    caches, position (and an encoder-decoder's ``fe_list``, replicated);
    out: the logits (replicated) and the caches."""
    P = shard_rules.P
    if fsdp is None:
        fsdp = use_fsdp(sys, "serve")
    pspec = shard_rules.param_specs(params, mesh, fsdp)
    B = specs["batch"]["tokens"].shape[0]
    cspec = shard_rules.cache_specs(specs["caches"], mesh, B)
    bspec = shard_rules.batch_specs(specs["batch"], mesh)
    args = [pspec, bspec, cspec, P()]
    if "fe_list" in specs:
        args.append(tree_map(lambda l: P(), specs["fe_list"]))
    return tuple(args), (P(), cspec)


def prefill_shardings(sys: EasterLM, mesh, specs, params, out_caches,
                      fsdp: Optional[bool] = None):
    """(in specs, out specs) of ``build_prefill_step``'s step: params and
    batch in, the embedding (replicated) and the new caches out."""
    P = shard_rules.P
    if fsdp is None:
        fsdp = use_fsdp(sys, "prefill")
    pspec = shard_rules.param_specs(params, mesh, fsdp)
    bspec = shard_rules.batch_specs(specs["batch"], mesh)
    B = specs["batch"]["tokens"].shape[0]
    cspec = shard_rules.cache_specs(out_caches, mesh, B)
    return (pspec, bspec), (P(), cspec)


def shard_step(step, mesh, in_specs, out_specs, layout: str = "tp"):
    """``step`` (a train, prefill or serve step above) run under the plan
    of ``mesh`` (``sharding.ambient_mesh``), on and to this rank's blocks:
    the arguments are the blocks ``sharding.shard_tree`` cuts by
    ``in_specs`` (batch rows included), and the results come back as
    ``out_specs`` says: parameters, optimizer state and caches as this
    rank's blocks, updated in place; the loss, embedding and logits whole
    on every rank. The train step's gradients are reduced over the batch
    axes as its layers' leaves are materialised (``sharding.materialize``),
    before its optimizer runs on the blocks (ZeRO-1)."""
    pspec = in_specs[0]
    bspec = next(s for s in in_specs if isinstance(s, dict) and "tokens" in s)
    ospec = in_specs[1] if in_specs[1] is not bspec else None
    cspec = next((s for s in in_specs if isinstance(s, list)), None)
    split = bspec["tokens"][0] is not None
    del out_specs       # the step writes its results in these layouts

    def run(*args):
        with shard_rules.ambient_mesh(mesh, layout, {
                "params": pspec, "opt": ospec, "caches": cspec,
                "split": split}):
            return step(*args)

    return run
