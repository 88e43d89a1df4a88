"""Dry run on the meta device: every (arch x input shape x mesh) at full
size, without a device (counterpart of ``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --layout zero3 --zero1

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
    over the meta step (the counterpart of XLA's ``cost_analysis()``;
    ``--no-flops`` skips the count, which dispatches every op through
    Python).

The CLI runs each step under the FSDP plan of the reference's production
mesh (``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16 with
``--multi-pod``; ``--both-meshes`` runs both), with the reference's
options (``--zero1``, ``--layout {tp,zero3}``, ``--serve-fsdp``), as rank
0 of it: its parameters, optimizer state, caches and batch rows are rank
0's meta blocks (``sharding.shard_tree``), and the report adds their bytes
("per_rank") and ``collective_bytes``, the bytes the step's collectives
move, counted by a ``launch.mesh.RecordingMesh`` that stands in for the
group with the reference's HLO convention, and "tp_layers", the layers'
sub-blocks taken under the tensor-parallel compute by their split
(``sharding.TP.splits``: "attn heads" / "kv" / "whole", "mlp split",
"moe experts" / "ff", "ssm heads", "rec width"; "... whole" where the
split does not divide the model axis and the sub-block is gathered).
``run_one`` without a mesh
runs the whole step in one process, as before. A failed combination is
printed with its traceback and counted; the run exits 1 if any failed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import sharding
from repro_torch.configs.base import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.mesh import RecordingMesh, make_production_mesh
from repro_torch.tree import tree_leaves

SKIPS = {
    ("whisper-small", "long_500k"):
        "enc-dec ASR decoder: a 500k-token decoder cache is out of the "
        "family's scope (max context 448 in the original)",
}


def pick_optimizer(cfg) -> str:
    """Adam states for <= 50B-parameter actives; momentum above."""
    return "momentum" if cfg.param_count() > 5e10 else "adam"


def collective_bytes(recorder: RecordingMesh) -> dict:
    """The bytes a step's collectives moved, by kind, with the reference's
    HLO convention (an all-gather its gathered output, a reduce-scatter
    its output block, an all-reduce and a broadcast their operand), the
    number of collectives (``count``) and the sum (``total``)."""
    out = dict(recorder.bytes)
    out["count"] = recorder.count
    out["total"] = sum(recorder.bytes.values())
    return out


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


def run_one(arch: str, shape_name: str, multi_pod: Optional[bool] = None,
            *, easter_on: bool = True, zero1: bool = False,
            layout: str = "tp", serve_fsdp: Optional[bool] = None,
            save_dir: str = "experiments/dryrun", step: bool = True,
            flops: bool = True, tag: str = "") -> dict:
    """One (arch, shape): the report above, saved to ``save_dir``.
    ``multi_pod``: None runs the whole step in one process; False / True
    runs it as rank 0 of the 16 x 16 / 2 x 16 x 16 mesh (``zero1``,
    ``layout``, ``serve_fsdp`` as in the reference). ``step=False`` builds
    the parameters, optimizer state and caches and counts them, without
    running the step (no FLOPs, no outputs)."""
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
    caches = opt_state = None
    if shape.kind == "train":
        opt_name = pick_optimizer(cfg)
        _, opt_state = steps_mod.abstract_state(sys_, opt_name)
        result["optimizer"] = opt_name
        result["opt_state_bytes"] = tree_bytes(opt_state)
    elif shape.kind == "prefill":
        caches = sys_.init_caches(B, S,
                                  steps_mod._long_ctx_override(cfg, shape))
        result["cache_bytes"] = tree_bytes(caches)
    else:
        caches = specs["caches"]
        result["cache_bytes"] = tree_bytes(caches)
    if shape.kind == "train":
        fn, _ = steps_mod.build_train_step(sys_, opt_name)
        args = [params, opt_state, batch, 0]
    elif shape.kind == "prefill":
        fn = steps_mod.build_prefill_step(sys_, shape)
        args = [params, batch]
    else:
        fn = steps_mod.build_serve_step(sys_, shape)
        args = [params, batch, caches, specs["pos"], specs.get("fe_list")]
    mesh = None
    if multi_pod is not None:
        mesh = RecordingMesh(make_production_mesh(multi_pod=multi_pod))
        fn, args = _on_mesh(sys_, shape, mesh, fn, args, specs, caches,
                            zero1, layout, serve_fsdp, result)
    if step:
        with FlopCounterMode(display=False) if flops else \
                contextlib.nullcontext() as counter:
            out = fn(*args)
        out = ({"loss": out[2]["loss"]} if shape.kind == "train"
               else {"E" if shape.kind == "prefill" else "logits": out[0]})
        result["flops"] = (float(counter.get_total_flops()) if flops
                           else None)
        result["outputs"] = _shapes(out)
        if mesh is not None:
            result["collective_bytes"] = collective_bytes(mesh)
    result["seconds"] = time.perf_counter() - t0
    os.makedirs(save_dir, exist_ok=True)
    suffix = ("" if multi_pod is None else "_pod2" if multi_pod
              else "_16x16") + (f"_{tag}" if tag else "")
    path = os.path.join(save_dir, f"{arch}_{shape_name}{suffix}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    result["_path"] = path
    return result


def _on_mesh(sys_, shape, mesh, fn, args, specs, caches, zero1, layout,
             serve_fsdp, result):
    """The step and its arguments as rank 0 of ``mesh`` runs them: specs
    by the reference's rules, rank 0's meta blocks, the step under the
    plan (``steps.shard_step``); the blocks' bytes into ``result``."""
    params = args[0]
    if shape.kind == "train":
        in_sh, out_sh = steps_mod.train_shardings(
            sys_, mesh, specs, params, args[1], zero1=zero1, layout=layout)
    elif shape.kind == "prefill":
        in_sh, out_sh = steps_mod.prefill_shardings(sys_, mesh, specs,
                                                    params, caches)
    else:
        in_sh, out_sh = steps_mod.serve_shardings(sys_, mesh, specs, params,
                                                  fsdp=serve_fsdp)
    local = [sharding.shard_tree(a, s, mesh) if isinstance(s, (dict, list))
             else a for a, s in zip(args, in_sh)] + list(args[len(in_sh):])
    if shape.kind == "prefill":
        out_caches = sharding.shard_tree(caches, out_sh[1], mesh)
    else:
        out_caches = local[2] if shape.kind == "decode" else None
    result.update(
        mesh="x".join(str(n) for n in mesh.shape.values()),
        n_devices=mesh.size, zero1=bool(zero1), layout=layout,
        fsdp=bool(steps_mod.use_fsdp(sys_)),
        per_rank={"weight_bytes": tree_bytes({"parties":
                                              local[0]["parties"]}),
                  "opt_state_bytes": (tree_bytes(local[1])
                                      if shape.kind == "train" else 0),
                  "cache_bytes": (0 if out_caches is None
                                  else tree_bytes(out_caches))})
    step_layout = layout if shape.kind == "train" else "tp"

    def counted(*args):
        out = fn(*args)
        # the layers taken under the tensor-parallel compute, by their
        # sub-blocks' split ("attn whole": gathered, its heads not
        # aligned), an encoder-decoder's "enc heads|whole" encoder blocks
        # and "xattn heads|whole" cross-attentions, and "kv T" the blocks
        # whose K/V cache lies over "model" by T (kept, never gathered)
        result["tp_layers"] = dict(sharding.current().tp_blocks)
        return out
    return (steps_mod.shard_step(counted, mesh, in_sh, out_sh, step_layout),
            local)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--no-easter", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--layout", default="tp", choices=["tp", "zero3"])
    ap.add_argument("--serve-fsdp", action="store_true")
    ap.add_argument("--no-flops", action="store_true",
                    help="skip FlopCounterMode (the slow part on meta)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)
    archs = ([a for a in list_archs() if not a.startswith("easter")]
             if args.arch == "all" else args.arch.split(","))
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                label = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
                try:
                    r = run_one(arch, shape, mp, easter_on=not args.no_easter,
                                zero1=args.zero1, layout=args.layout,
                                serve_fsdp=args.serve_fsdp or None,
                                save_dir=args.save_dir,
                                flops=not args.no_flops, tag=args.tag)
                except Exception as e:      # noqa: BLE001 - counted below
                    failures += 1
                    print(f"[FAIL] {label}: {type(e).__name__}: {e}")
                    traceback.print_exc()
                    continue
                if "skipped" in r:
                    print(f"[SKIP] {label}: {r['skipped']}")
                    continue
                pr, cb = r["per_rank"], r["collective_bytes"]
                print(f"[OK]   {label}: params "
                      f"{r['params_active_party']:.4g} (all parties "
                      f"{r['params_all_parties_tree']:.4g}) flops="
                      f"{r['flops'] or 0:.3e} per rank: weights="
                      f"{pr['weight_bytes'] / 2**30:.3f}GiB opt="
                      f"{pr['opt_state_bytes'] / 2**30:.3f}GiB caches="
                      f"{pr['cache_bytes'] / 2**30:.3f}GiB coll="
                      f"{cb['total']:.3e}B ({cb['count']} collectives) "
                      f"tp_layers={json.dumps(r.get('tp_layers', {}))} "
                      f"outputs={json.dumps(r['outputs'])} "
                      f"({r['seconds']:.2f}s)", flush=True)
    print(f"{failures} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
