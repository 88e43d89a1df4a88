"""Dry run on the meta device: every (arch x input shape) at full size,
without a device (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all

The reference lowers and compiles each combination over 512 fake host
devices and reads XLA's cost and memory analyses. The port builds the
system on the meta device instead (``launch.steps``: parameters,
optimizer state, caches and inputs as meta tensors, nothing allocated)
and runs one train, prefill or decode step on them. For each (arch,
shape) it reports and saves (``experiments/dryrun/<arch>_<shape>.json``):

  * the parameter count: the active party's analytic ``param_count()``
    and ``active_param_count()`` (the reference's figures), beside the
    counts of the parameter tree the step runs on;
  * the output shapes of the step;
  * the bytes of the weights, of the optimizer state (``pick_optimizer``:
    adam up to 5e10 parameters, momentum above) and of the caches;
  * the step's FLOPs, counted by ``torch.utils.flop_counter.FlopCounterMode``
    over the meta step (the counterpart of XLA's ``cost_analysis()``).

The collective bytes the reference parses from the HLO have no
counterpart until the FSDP plan is ported (ROADMAP.md queue 1). A failed
combination is printed with its traceback and counted; the run exits 1
if any failed.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import steps as steps_mod
from repro_torch.tree import tree_leaves

SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec ASR decoder: a 500k-token decoder cache is out of the "
        "family's scope (max context 448 in the original)",
}


def pick_optimizer(cfg) -> str:
    """Adam states for <= 50B-parameter actives; momentum above."""
    return "momentum" if cfg.param_count() > 5e10 else "adam"


def tree_bytes(tree) -> int:
    """Bytes of a tree's tensors (meta or real), leaf by leaf."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _shapes(tree):
    if isinstance(tree, torch.Tensor):
        return [list(tree.shape), str(tree.dtype).replace("torch.", "")]
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(t) for t in tree]
    return tree


def run_one(arch: str, shape_name: str, *, easter_on: bool = True,
            save_dir: str = "experiments/dryrun", step: bool = True) -> dict:
    """One (arch, shape): the report above, saved to ``save_dir``.
    ``step=False`` builds the parameters, optimizer state and caches and
    counts them, without running the step (no FLOPs, no outputs)."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name,
                "skipped": SKIPS[(arch, shape_name)]}
    sys_ = steps_mod.make_system(
        cfg, steps_mod.default_easter(cfg, enabled=easter_on),
        device="meta")
    t0 = time.perf_counter()
    specs = steps_mod.input_specs(cfg, shape, sys_)
    params = steps_mod.abstract_params(sys_)
    parties = {"parties": params["parties"]}
    result = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "easter": bool(easter_on), "parties": sys_.C,
        "params_active_party": int(cfg.param_count()),
        "params_active_party_active": int(cfg.active_param_count()),
        "params_active_backbone_tree": sum(
            t.numel() for t in tree_leaves(params["parties"][0]["backbone"])),
        "params_all_parties_tree": sum(t.numel()
                                       for t in tree_leaves(parties)),
        "weight_bytes": tree_bytes(parties),
        "opt_state_bytes": 0, "cache_bytes": 0,
    }
    batch = specs["batch"]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt_name = pick_optimizer(cfg)
        _, opt_state = steps_mod.abstract_state(sys_, opt_name)
        result["optimizer"] = opt_name
        result["opt_state_bytes"] = tree_bytes(opt_state)
    elif shape.kind == "prefill":
        result["cache_bytes"] = tree_bytes(sys_.init_caches(
            B, S, steps_mod._long_ctx_override(cfg, shape)))
    else:
        result["cache_bytes"] = tree_bytes(specs["caches"])
    if step:
        with FlopCounterMode(display=False) as counter:
            if shape.kind == "train":
                train, _ = steps_mod.build_train_step(sys_, opt_name)
                out = train(params, opt_state, batch, 0)[2]
            elif shape.kind == "prefill":
                out = {"E": steps_mod.build_prefill_step(sys_, shape)(
                    params, batch)[0]}
            else:
                out = {"logits": steps_mod.build_serve_step(sys_, shape)(
                    params, batch, specs["caches"], specs["pos"],
                    specs.get("fe_list"))[0]}
        result["flops"] = float(counter.get_total_flops())
        result["outputs"] = _shapes(out)
    result["seconds"] = time.perf_counter() - t0
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{arch}_{shape_name}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    result["_path"] = path
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--no-easter", action="store_true")
    ap.add_argument("--save-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)
    archs = ([a for a in list_archs() if not a.startswith("easter")]
             if args.arch == "all" else args.arch.split(","))
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    failures = 0
    for arch in archs:
        for shape in shapes:
            label = f"{arch} x {shape}"
            try:
                r = run_one(arch, shape, easter_on=not args.no_easter,
                            save_dir=args.save_dir)
            except Exception as e:          # noqa: BLE001 - counted below
                failures += 1
                print(f"[FAIL] {label}: {type(e).__name__}: {e}")
                traceback.print_exc()
                continue
            if "skipped" in r:
                print(f"[SKIP] {label}: {r['skipped']}")
                continue
            print(f"[OK]   {label}: params {r['params_active_party']:.4g} "
                  f"(active {r['params_active_party_active']:.4g}, all "
                  f"parties {r['params_all_parties_tree']:.4g}) "
                  f"flops={r['flops']:.3e} weights="
                  f"{r['weight_bytes'] / 2**30:.2f}GiB opt="
                  f"{r['opt_state_bytes'] / 2**30:.2f}GiB caches="
                  f"{r['cache_bytes'] / 2**30:.2f}GiB outputs="
                  f"{json.dumps(r['outputs'])} ({r['seconds']:.2f}s)")
    print(f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
