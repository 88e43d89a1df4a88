"""Training launcher: EASTER multi-party LM training end to end in PyTorch
(the flags of ``repro.launch.train``).

Runs on the card unless ``--device cpu`` is given:
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --steps 50 --batch 4 --seq 64 [--device cpu]

Training runs through the typed training surface (``core/api.py``):
``build_trainer(sys, TrainConfig)`` takes ``--chunk`` optimizer steps
(``TrainConfig.chunk``) per ``Trainer.run`` call, with ``TrainState``
(params, optimizer state, step) as the one carried object and the step
doubling as the TRAIN-domain PRF round. Heterogeneous per-party optimization (paper §IV-E) comes from
``--party-optimizers``, e.g. ``0=sgd:0.01,1=adagrad:0.005``; unlisted
parties fall back to ``--optimizer``/``--lr``, and the per-party states
ride the same checkpoint as the params (``--ckpt``, ``--resume``; the
reference's format, so either package resumes the other's run).
Parameters are random, drawn from ``--seed`` (on the card for ``--device
cuda``); the history is written to ``experiments/train/<arch>_train.json``
under the working directory.

``--engine sharded --party-devices N`` trains with the passive parties
over N ranks, started by torchrun (see ``launch/serve.py``):
    torchrun --nproc-per-node N -m repro_torch.launch.train \
        --engine sharded --party-devices N --smoke --num-passive 4
Each rank updates the parties it holds (one optimizer's clipping norm is
summed over the ranks); the checkpoint is gathered to rank 0, which
writes it and the history and prints.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch import checkpoint, optim
from repro_torch.configs.base import EasterConfig, get_config, smoke_variant
from repro_torch.core import api, party_group
from repro_torch.core.easter_lm import EasterLM
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.launch import mesh
from repro_torch.tree import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adam")
    ap.add_argument("--party-optimizers", default=None,
                    help="heterogeneous per-party optimizers (paper "
                         "§IV-E), e.g. '0=sgd:0.01,1=adagrad:0.005' "
                         "(k=name:lr[:hparam=v...]); unlisted parties "
                         "fall back to --optimizer/--lr")
    ap.add_argument("--chunk", type=int, default=8,
                    help="optimizer steps per Trainer.run call")
    ap.add_argument("--num-passive", type=int, default=3)
    ap.add_argument("--d-embed", type=int, default=128)
    ap.add_argument("--mask-mode", "--wire", dest="mask_mode",
                    default="float", choices=["float", "int32", "int8"],
                    help="wire format: float (paper) | int32 ring | int8 "
                         "narrow ring")
    ap.add_argument("--no-easter", action="store_true")
    ap.add_argument("--grad-mode", default="easter",
                    choices=["easter", "joint"])
    ap.add_argument("--engine", default="vectorized",
                    choices=["vectorized", "sharded", "loop"],
                    help="passive-party execution: grouped vmap | over "
                         "a party group of ranks | per-party loop")
    ap.add_argument("--party-devices", type=int, default=0,
                    help="ranks of the party group for --engine sharded "
                         "(0 = every rank torchrun started)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="restore params/opt state from --ckpt if present")
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint cadence in steps (saves on the first "
                         "chunk boundary past it)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    group, device = mesh.launcher_group(args)
    if args.engine == "sharded" and group is None:
        return None                  # a rank outside the party group
    mesh.quiet_other_ranks(group)
    easter = EasterConfig(num_passive=args.num_passive,
                          d_embed=args.d_embed, mask_mode=args.mask_mode,
                          enabled=not args.no_easter)
    sys_ = EasterLM(cfg=cfg, easter=easter, grad_mode=args.grad_mode,
                    engine=args.engine, device=device, group=group)
    lead = group is None or group.rank == 0
    print(f"arch={cfg.name} parties={sys_.C} engine={args.engine} "
          f"party_depths={[c.n_layers for c in sys_.party_cfgs]} "
          f"d_embed={easter.d_embed} device={device}")

    params = sys_.init_params(
        torch.Generator(device=device).manual_seed(args.seed))
    n = sum(t.numel() for p in params["parties"] for t in tree_leaves(p))
    print(f"total params ({'rank 0' if group else 'all parties'}): {n:,}")

    tcfg = api.TrainConfig(
        optimizer=args.optimizer, lr=args.lr, chunk=args.chunk,
        party_optimizers=(optim.parse_party_spec(args.party_optimizers)
                          if args.party_optimizers else None))
    trainer = api.build_trainer(sys_, tcfg)
    if tcfg.party_optimizers:
        print(f"party optimizers: {trainer.opt.name}")
    state = trainer.init(params)
    start_step = 0
    if args.resume and args.ckpt and os.path.exists(args.ckpt):
        restored, step0 = checkpoint.restore(
            args.ckpt, {"params": {"parties": state.params["parties"]},
                        "opt": state.opt_state})
        start_step = step0 or 0
        state = api.TrainState(sys_.group_params(restored["params"]),
                               restored["opt"], start_step)
        print(f"resumed from {args.ckpt} at step {start_step}")

    def save(step):
        tree = {"params": {"parties": state.params["parties"]},
                "opt": state.opt_state}
        if group is not None:
            tree = party_group.gather_tree(group, tree)
        if lead:
            checkpoint.save(args.ckpt, tree, step=step)

    it = lm_batch_iterator(cfg.vocab_size, args.batch, args.seq,
                           seed=args.seed)
    t0 = time.perf_counter()
    history = []
    end = start_step + args.steps
    chunk = trainer.chunk

    def log_steps(i0, losses, pers):
        # tok/s over the steps since the (re)start
        dt = time.perf_counter() - t0
        tok_s = (i0 + len(losses) - start_step) * args.batch * args.seq / dt
        for j in range(len(losses)):
            i = i0 + j
            if i % args.log_every == 0 or i == end - 1:
                loss = float(losses[j])
                per = np.round(np.asarray(pers[j]), 4)
                print(f"step {i:5d} loss {loss:9.4f} per-party {per} "
                      f"({tok_s:,.0f} tok/s)")
                history.append({"step": i, "loss": loss,
                                "per_party": per.tolist()})

    i = start_step
    while i < end:
        n_steps = min(chunk, end - i)
        state, metrics = trainer.run(
            state, [next(it) for _ in range(n_steps)])
        log_steps(i, metrics["loss"].cpu().numpy(),
                  metrics["per_party"].cpu().numpy())
        i += n_steps
        if args.ckpt and (i // args.ckpt_every
                          != (i - n_steps) // args.ckpt_every):
            save(i)
    if args.ckpt:
        save(end)
        print(f"checkpoint -> {args.ckpt}")
    out = {"arch": cfg.name, "history": history}
    if lead:
        os.makedirs("experiments/train", exist_ok=True)
        with open(f"experiments/train/{cfg.name}_train.json", "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
