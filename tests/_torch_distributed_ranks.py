"""The rank side of tests/test_torch_distributed.py: the FSDP plan's train,
prefill and serve steps on a 2 x 2 (data x model) gloo mesh on the CPU
(and serve steps on 4 x 1 and 1 x 4 meshes of the same ranks), every
case inside one spawned 4-rank group. Imports no JAX (the ranks are separate
processes); rank 0 returns numpy, the other ranks their block checks."""
import dataclasses

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import (EasterConfig, InputShape, get_config,
                                      smoke_variant)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.core import train_loop
from repro_torch.launch import steps
from repro_torch.tree import tree_leaves

B, S = 4, 16
# (name, arch, config changes, optimizer, layout, zero1): the reference's
# three test_sharded_train_step_matches_single_device archs (sgd, lr 1e-2,
# batch (4, 16), the reference's default layout "tp"); qwen3-moe with a
# capacity factor at which the one-process step drops tokens; and adam +
# ZeRO-1 under "zero3" on a widened qwen2.5-3b: at smoke size every leaf
# is below _add_fsdp's 2^20-element floor, so no leaf would be
# data-sharded; at vocab 4096 and d_ff 2048 the table (4096 x 256) and the
# stacked MLP leaves (2 x 256 x 2048) reach it (the floor is unchanged);
# with remat="full", as the full-size configs train, each layer's
# recompute in the backward gathers its leaves again; and the int8 wire,
# whose round scale is the max over every rank's rows (mask_mode goes to
# the EasterConfig)
TRAIN_CASES = (
    ("qwen2.5-3b", "qwen2.5-3b", {}, "sgd", "tp", False),
    ("qwen2.5-3b-int8", "qwen2.5-3b", {"mask_mode": "int8"}, "sgd", "tp",
     False),
    ("qwen3-moe", "qwen3-moe-235b-a22b", {}, "sgd", "tp", False),
    ("qwen3-moe-drops", "qwen3-moe-235b-a22b", {"capacity_factor": 0.25},
     "sgd", "tp", False),
    ("mamba2", "mamba2-2.7b", {}, "sgd", "tp", False),
    ("zero3-adam-zero1", "qwen2.5-3b", {"vocab_size": 4096, "d_ff": 2048,
                                        "remat": "full"},
     "adam", "zero3", True),
    # tensor-parallel attention's other two choices at m = 2: one kv head
    # that both model ranks' q heads read, and 3 q heads, whose column
    # split cuts inside a head, so the attention is gathered (the MLP is
    # still split)
    ("qwen2.5-3b-kv1", "qwen2.5-3b", {"n_kv_heads": 1}, "sgd", "tp", False),
    ("qwen2.5-3b-h3", "qwen2.5-3b", {"n_heads": 3, "n_kv_heads": 1}, "sgd",
     "tp", False),
    # the split MoE with its shared expert, by expert (4 experts over 2
    # model ranks) and by ff column (3 experts do not divide 2); the
    # Griffin stack's RG-LRU at half its width (with the "kv" attention)
    ("qwen2-moe", "qwen2-moe-a2.7b", {}, "sgd", "tp", False),
    ("qwen2-moe-ff", "qwen2-moe-a2.7b", {"n_experts": 3}, "sgd", "tp", False),
    ("recurrentgemma", "recurrentgemma-9b", {}, "sgd", "tp", False),
    # the encoder-decoder: its encoder (the stream over the 16 frames
    # sequence-parallel), cross K/V and cross-attention on each rank's 2 of
    # 4 heads, the batch carrying the frames; at vocab 510, which does not
    # divide the model axis, the rule splits the tables by their width, as
    # whisper-small's 51,865 rows at full size (each rank looks up its
    # columns); and remat="dots" (the matrix products saved, the rest and
    # every collective recomputed in the backward)
    ("whisper", "whisper-small", {"vocab_size": 510}, "sgd", "tp", False),
    ("qwen2.5-3b-dots", "qwen2.5-3b", {"remat": "dots"}, "sgd", "tp",
     False),
    # the vision model as it trains at full width on four cards: M-RoPE
    # and the patch insert (8 patch embeddings over the first positions of
    # each row, ``vision_embed`` in the batch, one row a rank) under adam +
    # ZeRO-1 and "zero3", widened as the zero3 case so that leaves reach
    # the 2^20 floor, remat="full"
    ("qwen2-vl-zero3", "qwen2-vl-7b", {"vocab_size": 4096, "d_ff": 2048,
                                       "remat": "full"},
     "adam", "zero3", True),
)
# the train cases whose replicated leaves' gradients are held against the
# one process's: each feeds a rank's block of a split product (the router,
# the shared gate, the SSD's in_proj, the convs' taps, the norms: whisper's
# layer norms, scale and bias, of its encoder blocks, the encoder's final
# norm and the cross-attentions' lnx)
GRAD_CASES = ("qwen3-moe", "mamba2", "qwen2-moe", "qwen2-moe-ff",
              "recurrentgemma", "whisper")
REPLICATED = ("router", "shared_gate", "in_proj", "conv_w", "conv_b",
              "scale", "bias")
SERVE_POS = 3
# (name, arch, config changes, mesh, lanes, blinded) of the decode rounds:
# on the 2 x 2 mesh (the heads split over "model"), blinded and unblinded
# (no mask seeds: the uplink ships raw, so whatever differs from one
# process is the tensor-parallel compute's alone); on 4 x 1 (data x
# model) over the same ranks, whose compute splits over the batch only,
# at 8 lanes (2 a rank, as the 2 x 2 mesh's data ranks hold: a one-row
# product takes another CPU GEMM path than the one process's, whose bits
# differ); one kv head, whose cache lies over "model" by T (the partial
# softmax merged over the ranks); the split MoE on 2 x 2 and on 1 x 4 (one
# expert a rank), the SSD on 2 x 2 (8 heads a rank), the RG-LRU on 1 x 4
# (a quarter of its width a rank); whisper-small on 2 x 2 and 1 x 4 (the
# encoder, cross K/V and cross-attention on each rank's heads; on 1 x 4 at
# vocab 510, the tables split by width, as at full size); 3 q heads and
# one kv head, whose attention stays whole (the split would cut a head)
# over a T-split cache (each rank's partial softmax merged), in qwen2.5-3b
# and in gemma3-4b's sliding layers, decoded at position 40 into a
# 64-slot cache, past the 32-slot ring of the window (``SERVE_AT``). The
# cases but the first four also run a (4, 16) prefill (``prefill_case``)
SERVE_CASES = (
    ("serve", "qwen2.5-3b", {}, (2, 2), B, True),
    ("serve-raw", "qwen2.5-3b", {}, (2, 2), B, False),
    ("serve-4x1", "qwen2.5-3b", {}, (4, 1), 2 * B, True),
    ("serve-t-split", "qwen2.5-3b", {"n_kv_heads": 1}, (2, 2), B, True),
    ("serve-moe", "qwen2-moe-a2.7b", {}, (2, 2), B, True),
    ("serve-moe-1x4", "qwen2-moe-a2.7b", {}, (1, 4), B, True),
    ("serve-mamba2", "mamba2-2.7b", {}, (2, 2), B, True),
    ("serve-rg-1x4", "recurrentgemma-9b", {}, (1, 4), B, True),
    ("serve-whisper", "whisper-small", {}, (2, 2), B, True),
    ("serve-whisper-1x4", "whisper-small", {"vocab_size": 510}, (1, 4), B,
     True),
    ("serve-h3", "qwen2.5-3b", {"n_heads": 3, "n_kv_heads": 1}, (2, 2), B,
     True),
    ("serve-gemma3-h3", "gemma3-4b", {"n_heads": 3, "n_kv_heads": 1},
     (2, 2), B, True),
)
PREFILL_CASES = SERVE_CASES[4:]
# (cache length, position) of a decode round, by case; else (S, SERVE_POS)
SERVE_AT = {"serve-gemma3-h3": (64, 40)}


def serve_at(name):
    return SERVE_AT.get(name, (S, SERVE_POS))

def config(arch, changes):
    """The smoke variant of ``arch`` with ``changes`` (``capacity_factor``
    and ``n_experts`` go to the MoE config, ``mask_mode`` to ``system``)."""
    cfg = smoke_variant(get_config(arch))
    changes = {k: v for k, v in changes.items() if k != "mask_mode"}
    moe = {k: changes.pop(k) for k in ("capacity_factor", "n_experts")
           if k in changes}
    if moe:
        changes["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **changes)


def system(cfg, device="cpu", mask_mode="float"):
    """The reference test's system: C = 4, d_embed 64, one decision layer,
    the vectorized engine."""
    return steps.make_system(
        cfg, EasterConfig(num_passive=3, d_embed=64, decision_layers=1,
                          mask_mode=mask_mode), device=device)


def audio(cfg, rows=B, seed=5):
    """An encoder-decoder's frame embeddings (rows, F, d), float32."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (rows, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))


def patches(cfg, rows=B, seed=6):
    """A vision model's patch embeddings (rows, n_vision_tokens, d),
    float32."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (rows, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32))


def train_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                            dtype=np.int32))
           for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        out["audio_embed"] = audio(cfg)
    if cfg.family == "vlm":
        out["vision_embed"] = patches(cfg)
    return out


def serve_inputs(cfg, seed=3, lanes=B):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (lanes, 1), dtype=np.int32))}


def _check_blocks(local, full_shapes, specs, mesh):
    """Every leaf of ``local`` has the shape its spec gives the whole
    leaf's shape; the list of leaves that do not."""
    bad = []
    for x, shape, s in zip(tree_leaves(local), full_shapes,
                           sharding.spec_leaves(specs)):
        if tuple(x.shape) != sharding.local_shape(shape, s, mesh):
            bad.append((tuple(shape), tuple(s), tuple(x.shape)))
    return bad


def _shapes(tree):
    return [tuple(x.shape) for x in tree_leaves(tree)]


def replicated_grads(grads, specs):
    """The gradients of the replicated leaves that feed a split product
    (``REPLICATED``, by path), from a ``{"parties": [...]}`` tree."""
    out = {}

    def one(names, g, s):
        if names[-1] in REPLICATED and "model" not in tuple(s):
            out["/".join(names)] = g
    sharding._zip_path(one, grads, specs)
    return out


def train_case(mesh, cfg, opt_name, layout, zero1, mask_mode="float",
               grads=False):
    """One sharded train step from seed-0 weights: rank 0 gets the loss,
    the per-party losses and the updated parameters gathered (with
    ``grads`` also the step's gradients of the replicated leaves that feed
    a split product, ``replicated_grads``); every rank its block
    checks."""
    sys_ = system(cfg, mask_mode=mask_mode)
    params = sys_.init_params(torch.Generator().manual_seed(0))
    batch = train_batch(cfg)
    train_step, opt = steps.build_train_step(sys_, opt_name, lr=1e-2)
    opt_state = opt.init({"parties": params["parties"]})
    in_sh, out_sh = steps.train_shardings(sys_, mesh, {"batch": batch},
                                          params, opt_state, zero1=zero1,
                                          layout=layout)
    pspec, ospec, bspec, _ = in_sh
    shapes = (_shapes(params), _shapes(opt_state))
    lp = sharding.shard_tree(params, pspec, mesh)
    lo = sharding.shard_tree(opt_state, ospec, mesh)
    lb = sharding.shard_tree(batch, bspec, mesh)
    del params, opt_state
    # the passive parties stay views of the stacked group's block
    stacked = tree_leaves(lp["passive_stacked"])[0]
    views = all(tree_leaves(lp["parties"][k])[0].untyped_storage().data_ptr()
                == stacked.untyped_storage().data_ptr() for k in (1, 2, 3))
    rep = None
    if grads:
        _, _, g = steps.shard_step(
            lambda p, o, b, i: train_loop.loss_and_grads(
                sys_, p, b, i, sys_.mask_seeds()),
            mesh, in_sh, out_sh, layout)(lp, lo, lb, 0)
        gspec = {"parties": pspec["parties"]}
        whole = sharding.gather_tree(g, gspec, mesh)     # every rank calls
        rep = None if whole is None else replicated_grads(whole, gspec)
        del g
    run = steps.shard_step(train_step, mesh, in_sh, out_sh, layout)
    lp, lo, m = run(lp, lo, lb, 0)
    bad = (_check_blocks(lp, shapes[0], pspec, mesh)
           + _check_blocks(lo, shapes[1], ospec, mesh))
    n_sharded = sum(any(e is not None for e in s)
                    for s in sharding.spec_leaves(pspec))
    got = sharding.gather_tree({"parties": lp["parties"]},
                               {"parties": pspec["parties"]}, mesh)
    out = {"bad_blocks": bad, "views": views, "n_sharded": n_sharded,
           "rows": int(lb["tokens"].shape[0])}
    if mesh.rank == 0:
        out.update(loss=float(m["loss"]), per_party=m["per_party"].numpy(),
                   params=got, grads=rep)
    return out


def serve_step(sys_, lanes, blinded=True):
    """The decode round: ``steps.build_serve_step``'s, or unblinded (no
    mask seeds, the uplink raw)."""
    if blinded:
        return steps.build_serve_step(sys_, InputShape("d", S, lanes,
                                                       "decode"))
    return lambda params, batch, caches, pos: sys_.serve_step(
        params, batch["tokens"], caches, pos, None)


def enc_kv(sys_, params, cfg, lanes=B, mesh=None, pspec=None):
    """An encoder-decoder's ``fe_list`` for ``lanes`` lanes of ``audio``:
    whole, or with ``mesh`` made under the plan from this rank's blocks
    ``params`` of ``pspec`` (this rank's rows and heads)."""
    run = lambda p, b: sys_.encoder_kv(p, b["audio_embed"])
    batch = {"tokens": torch.zeros((lanes, 1), dtype=torch.int32),
             "audio_embed": audio(cfg, lanes)}
    if mesh is None:
        return run(params, batch)
    bspec = sharding.batch_specs(batch, mesh)
    return steps.shard_step(run, mesh, (pspec, bspec), None)(
        params, sharding.shard_tree(batch, bspec, mesh))


def serve_case(mesh, cfg, lanes=B, blinded=True, at=(S, SERVE_POS)):
    """One decode round (the reference's serve test: batch 4, cache 16,
    position 3; ``lanes`` lanes; ``at`` another (cache, position)) under
    ``serve_shardings``: rank 0 gets the logits and the caches gathered;
    every rank the bytes its collectives moved and the all-gathers of a
    cache's shape (none: every cache block is kept). An encoder-decoder
    decodes with the cross K/V made under the plan (this rank's heads),
    then again with the whole ones (``logits_whole_kv``: the step takes
    this rank's heads)."""
    sys_ = system(cfg)
    T, pos = at
    params = sys_.init_params(torch.Generator().manual_seed(2))
    serve = serve_step(sys_, lanes, blinded)
    batch = serve_inputs(cfg, lanes=lanes)
    caches = sys_.init_caches(lanes, T)
    specs = {"batch": batch, "caches": caches, "pos": pos}
    in_sh, out_sh = steps.serve_shardings(sys_, mesh, specs, params)
    pspec, bspec, cspec, _ = in_sh
    shapes = _shapes(caches)
    whole_kv = (enc_kv(sys_, params, cfg, lanes)
                if cfg.family == "encdec" else None)
    lp = sharding.shard_tree(params, pspec, mesh)
    lb = sharding.shard_tree(batch, bspec, mesh)
    lc = sharding.shard_tree(caches, cspec, mesh)
    fe = ()
    if whole_kv is not None:
        fe = (enc_kv(sys_, lp, cfg, lanes, mesh, pspec),)
    rec = mesh_mod.RecordingMesh(mesh)
    run = steps.shard_step(serve, rec, in_sh, out_sh)
    logits, new_lc = run(lp, lb, lc, pos, *fe)
    bad = _check_blocks(new_lc, shapes, cspec, mesh)
    got = sharding.gather_tree(new_lc, cspec, mesh)
    t_split = []
    sharding._map_with_path(lambda names, s: t_split.append(
        names[-1] in ("k", "v") and _entries_t(s)), cspec)
    kv = set()
    sharding._map_with_path(lambda names, a: kv.add(tuple(a.shape[-3:]))
                            if names[-1] in ("k", "v") else None, caches)
    out = {"bad_blocks": bad, "bytes": dict(rec.bytes),
           "t_split": sum(t_split),
           "cache_gathers": [c for c in rec.calls if c[0] == "all-gather"
                             and len(c[2]) >= 4 and c[2][-3:] in kv]}
    if whole_kv is not None:
        lc = sharding.shard_tree(caches, cspec, mesh)
        out["logits_whole_kv"] = steps.shard_step(serve, mesh, in_sh, out_sh)(
            lp, lb, lc, pos, whole_kv)[0].numpy()
        out["enc_kv_shape"] = tuple(fe[0][0]["enc_kv"][0].shape)
    if mesh.rank == 0:
        out.update(logits=logits.numpy(), caches=got)
    return out


def _entries_t(spec) -> bool:
    """True for a K/V cache spec (reps, B, T, H, hd) whose T lies over
    "model"."""
    return len(spec) == 5 and spec[2] == "model"


def prefill_inputs(cfg, seed=4):
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32))}
    if cfg.family == "encdec":
        out["audio_embed"] = audio(cfg)
    return out


def meta_caches(sys_, b, t):
    from repro_torch.models import transformer
    return [transformer.init_cache(c, b, t, device="meta")
            for c in sys_.party_cfgs]


def prefill_case(mesh, cfg):
    """A (4, 16) prefill under ``prefill_shardings``: S divides the model
    axis, so the stream between layers is sequence-parallel. Rank 0 gets
    E and the caches gathered; every rank the bytes by kind."""
    sys_ = system(cfg)
    params = sys_.init_params(torch.Generator().manual_seed(2))
    prefill = steps.build_prefill_step(sys_, InputShape("p", S, B,
                                                        "prefill"))
    batch = prefill_inputs(cfg)
    in_sh, out_sh = steps.prefill_shardings(
        sys_, mesh, {"batch": batch}, params, meta_caches(sys_, B, S))
    lp = sharding.shard_tree(params, in_sh[0], mesh)
    lb = sharding.shard_tree(batch, in_sh[1], mesh)
    rec = mesh_mod.RecordingMesh(mesh)
    rec_blocks = {}

    def counted(*args):
        out = prefill(*args)
        rec_blocks.update(sharding.current().tp_blocks)
        return out
    E, lc = steps.shard_step(counted, rec, in_sh, out_sh)(lp, lb)
    got = sharding.gather_tree(lc, out_sh[1], mesh)
    out = {"bytes": dict(rec.bytes), "tp_blocks": dict(rec_blocks)}
    if mesh.rank == 0:
        out.update(E=E.numpy(), caches=got)
    return out


def run_cases():
    """Every case on this rank of the 2 x 2 mesh (and the 4 x 1 and 1 x 4
    ones)."""
    mesh = mesh_mod.make_debug_mesh(2, 2, device="cpu")
    meshes = {(2, 2): mesh}
    for shape in ((4, 1), (1, 4)):
        meshes[shape] = mesh_mod.make_debug_mesh(*shape, device="cpu")
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    for name, arch, changes, opt_name, layout, zero1 in TRAIN_CASES:
        out[name] = train_case(mesh, config(arch, changes), opt_name,
                               layout, zero1,
                               changes.get("mask_mode", "float"),
                               grads=name in GRAD_CASES)
    for name, arch, changes, shape, lanes, blinded in SERVE_CASES:
        out[name] = serve_case(meshes[shape], config(arch, changes), lanes,
                               blinded, serve_at(name))
    for name, arch, changes, shape, _, _ in PREFILL_CASES:
        out["prefill-" + name] = prefill_case(meshes[shape],
                                              config(arch, changes))
    out["prefill"] = prefill_case(mesh, config("qwen2.5-3b", {}))
    return out
