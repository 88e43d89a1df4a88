"""The rank side of tests/test_torch_distributed.py: the FSDP plan's train
and serve steps on a 2 x 2 (data x model) gloo mesh on the CPU, every case
inside one spawned 4-rank group. Imports no JAX (the ranks are separate
processes); rank 0 returns numpy, the other ranks their block checks."""
import dataclasses

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.configs.base import (EasterConfig, InputShape, get_config,
                                      smoke_variant)
from repro_torch.launch import mesh as mesh_mod
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
)
SERVE_POS = 3


def config(arch, changes):
    """The smoke variant of ``arch`` with ``changes`` (``capacity_factor``
    goes to the MoE config, ``mask_mode`` to ``system``)."""
    cfg = smoke_variant(get_config(arch))
    changes = {k: v for k, v in changes.items() if k != "mask_mode"}
    if "capacity_factor" in changes:
        changes["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=changes.pop("capacity_factor"))
    return dataclasses.replace(cfg, **changes)


def system(cfg, device="cpu", mask_mode="float"):
    """The reference test's system: C = 4, d_embed 64, one decision layer,
    the vectorized engine."""
    return steps.make_system(
        cfg, EasterConfig(num_passive=3, d_embed=64, decision_layers=1,
                          mask_mode=mask_mode), device=device)


def train_batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S),
                                             dtype=np.int32))
            for k in ("tokens", "labels")}


def serve_inputs(cfg, seed=3):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, 1), dtype=np.int32))}


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


def train_case(mesh, cfg, opt_name, layout, zero1, mask_mode="float"):
    """One sharded train step from seed-0 weights: rank 0 gets the loss,
    the per-party losses and the updated parameters gathered; every rank
    its block checks."""
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
                   params=got)
    return out


def serve_case(mesh, cfg):
    """One decode round (the reference's serve test: batch 4, cache 16,
    position 3) under ``serve_shardings``: rank 0 gets the logits and the
    caches gathered."""
    sys_ = system(cfg)
    params = sys_.init_params(torch.Generator().manual_seed(2))
    shape = InputShape("d", S, B, "decode")
    serve = steps.build_serve_step(sys_, shape)
    batch = serve_inputs(cfg)
    caches = sys_.init_caches(B, S)
    specs = {"batch": batch, "caches": caches, "pos": SERVE_POS}
    in_sh, out_sh = steps.serve_shardings(sys_, mesh, specs, params)
    pspec, bspec, cspec, _ = in_sh
    shapes = _shapes(caches)
    lp = sharding.shard_tree(params, pspec, mesh)
    lb = sharding.shard_tree(batch, bspec, mesh)
    lc = sharding.shard_tree(caches, cspec, mesh)
    run = steps.shard_step(serve, mesh, in_sh, out_sh)
    logits, lc = run(lp, lb, lc, SERVE_POS)
    bad = _check_blocks(lc, shapes, cspec, mesh)
    got = sharding.gather_tree(lc, cspec, mesh)
    out = {"bad_blocks": bad}
    if mesh.rank == 0:
        out.update(logits=logits.numpy(), caches=got)
    return out


def run_cases():
    """Every case on this rank of the 2 x 2 mesh."""
    mesh = mesh_mod.make_debug_mesh(2, 2, device="cpu")
    out = {"rank": mesh.rank, "coords": dict(mesh.coords)}
    for name, arch, changes, opt_name, layout, zero1 in TRAIN_CASES:
        out[name] = train_case(mesh, config(arch, changes), opt_name,
                               layout, zero1,
                               changes.get("mask_mode", "float"))
    out["serve"] = serve_case(mesh, config("qwen2.5-3b", {}))
    return out
