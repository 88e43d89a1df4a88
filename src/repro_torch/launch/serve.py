"""Serving launcher: the EASTER continuous-batching serve tier in PyTorch
(the flags of ``repro.launch.serve``).

Runs on the card unless ``--device cpu`` is given.

Single-shot batched generation (R lanes, one request each):
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --smoke --batch 4 --prompt-len 32 --gen 32 [--device cpu]

Request-stream serving (continuous batching + EOS early-exit):
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke \\
        --requests 8 --poisson [--device cpu]

``--arch`` takes any registered architecture. Requests carry tokens
only, as the reference's: qwen2-vl-7b serves as a text model, and
whisper-small raises for want of audio (drive ``EasterLM.encoder_kv``,
``prefill(fe_list=)`` and ``decode.serve_tokens(fe_list=)`` instead).

Both modes run on the typed serving surface (core/api.py): requests are
``ServeRequest``s admitted into decode slots by the ``ServingEngine``
(core/serving.py); every decoded token is one blinded protocol round
shared by all live lanes. ``--step-loop`` drives single-stream decode one
``serve_step`` at a time. Parameters are random, drawn from ``--seed``
(on the card for ``--device cuda``).

``--engine sharded --party-devices N`` lays the passive parties over N
ranks (``launch/mesh.py``); start one process per rank with torchrun:
    torchrun --nproc-per-node N -m repro_torch.launch.serve \
        --engine sharded --party-devices N --arch qwen2.5-3b --num-passive 3
With N cards each rank takes one (NCCL); with one card every rank shares
it over gloo; ``--device cpu`` runs the ranks on the CPU over gloo. Rank 0
holds the active party and prints; the others hold their passive rows
and follow the sampled tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import EasterConfig, get_config, smoke_variant
from repro_torch.core import api, blinding, decode as decode_mod, serving
from repro_torch.core.easter_lm import EasterLM
from repro_torch.launch import mesh


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode lanes (R concurrent requests per round)")
    ap.add_argument("--prompt-len", type=int, default=0,
                    help="0 = 32, or 8 with --smoke")
    ap.add_argument("--gen", type=int, default=0,
                    help="0 = 32, or 8 with --smoke")
    ap.add_argument("--num-passive", type=int, default=3)
    ap.add_argument("--d-embed", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--engine", default="vectorized",
                    choices=["vectorized", "sharded", "loop"],
                    help="passive-party execution: grouped vmap | over "
                         "a party group of ranks | per-party loop")
    ap.add_argument("--party-devices", type=int, default=0,
                    help="ranks of the party group for --engine sharded "
                         "(0 = every rank torchrun started)")
    ap.add_argument("--requests", type=int, default=0,
                    help="serve a stream of N requests through the "
                         "continuous-batching scheduler (mixed lengths, "
                         "EOS early-exit) instead of one fixed batch")
    ap.add_argument("--poisson", action="store_true",
                    help="open-loop Poisson arrivals for --requests "
                         "(otherwise all requests arrive at t=0)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate in requests/s "
                         "(0 = saturating: mean interarrival = 1ms)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode rounds per decode call = scheduling quantum")
    ap.add_argument("--eos-id", type=int, default=7,
                    help="EOS token id for --requests mode (-1 disables "
                         "early exit)")
    ap.add_argument("--step-loop", action="store_true",
                    help="drive single-stream decode one serve_step at a "
                         "time")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    args.prompt_len = args.prompt_len or (8 if args.smoke else 32)
    args.gen = args.gen or (8 if args.smoke else 32)
    group, device = mesh.launcher_group(args)
    if args.engine == "sharded" and group is None:
        return None                  # a rank outside the party group
    sys_ = EasterLM(cfg=cfg, easter=EasterConfig(
        num_passive=args.num_passive, d_embed=args.d_embed),
        engine=args.engine, device=device, group=group)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = sys_.init_params(gen)
    mesh.quiet_other_ranks(group)
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{sys_.C} parties, {sys_.engine} engine on {device}"
          + (f", {group.size} ranks over {group.backend}, passive rows "
             f"{list(sys_._rows())} on rank 0" if group else ""))

    if args.requests > 0:
        _serve_stream(args, cfg, sys_, params)
    elif args.step_loop:
        _single_batch_step_loop(args, cfg, sys_, params)
    else:
        _single_batch(args, cfg, sys_, params)


def _mk_requests(args, cfg):
    """Mixed short/long workload: prompts from a few length buckets up to
    --prompt-len, budgets around --gen (some lanes EOS out early when
    --eos-id >= 0)."""
    rng = np.random.default_rng(args.seed)
    step = max(2, args.prompt_len // 4)
    buckets = sorted({max(2, b) for b in
                      range(step, args.prompt_len + 1, step)})
    reqs = []
    for _ in range(args.requests):
        plen = int(rng.choice(buckets))
        gen = max(1, int(rng.integers(max(1, args.gen // 4),
                                      args.gen + 1)))
        reqs.append(api.ServeRequest(
            tokens=tuple(int(t) for t in
                         rng.integers(0, cfg.vocab_size, size=plen)),
            max_new_tokens=gen, eos_id=args.eos_id,
            temperature=args.temperature))
    if args.poisson:
        rate = args.rate if args.rate > 0 else 1000.0
        arrivals = np.cumsum(rng.exponential(1.0 / rate,
                                             size=args.requests))
    else:
        arrivals = np.zeros(args.requests)
    return reqs, arrivals.tolist()


def _serve_stream(args, cfg, sys_, params):
    lanes = min(args.batch, args.requests)
    max_len = args.prompt_len + args.gen
    eng = serving.ServingEngine(sys_, params, lanes=lanes,
                                max_len=max_len, chunk=args.chunk,
                                base_key=args.seed)
    reqs, arrivals = _mk_requests(args, cfg)
    t0 = time.perf_counter()
    comps = eng.run(reqs, arrivals=arrivals)
    _sync(sys_.device)
    wall = time.perf_counter() - t0
    lat = sorted(c.latency_s for c in comps)
    toks = sum(len(c.tokens) for c in comps)
    p50 = lat[len(lat) // 2] * 1e3
    p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3
    print(f"served {len(comps)} requests on {lanes} lanes "
          f"(chunk={args.chunk}, {'poisson' if args.poisson else 'batch'} "
          f"arrivals) [first calls included]")
    print(f"  {toks} tokens in {wall * 1e3:.1f} ms "
          f"({toks / wall:.1f} tok/s aggregate), "
          f"{eng.rounds_run} protocol rounds over {eng.chunks_run} chunks")
    print(f"  latency p50 {p50:.1f} ms   p99 {p99:.1f} ms")
    first = min(comps, key=lambda c: c.nonce)
    print(f"  sample (nonce 0): {len(first.tokens)} toks "
          f"{first.tokens[:12]} ...")


def _prompts(args, cfg, device):
    gen = torch.Generator().manual_seed(args.seed + 1)
    return torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                         generator=gen, dtype=torch.int32).to(device)


def _single_batch(args, cfg, sys_, params):
    """R identical-shape requests, one per lane, through the lane engine."""
    dcfg = api.DecodeConfig(lanes=args.batch,
                            max_len=args.prompt_len + args.gen,
                            chunk=args.gen, base_key=args.seed)
    prefill_fn, decode_fn = api.build_decoder(sys_, dcfg)
    state = api.init_decode_state(sys_, dcfg)
    prompt = _prompts(args, cfg, sys_.device)
    t0 = time.perf_counter()
    for lane in range(args.batch):
        req = api.ServeRequest(
            tokens=tuple(prompt[lane].tolist()), max_new_tokens=args.gen,
            eos_id=-1, temperature=args.temperature)
        state = prefill_fn(params, state, req, lane, nonce=lane)
    _sync(sys_.device)
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    gen_toks, state, steps = decode_fn(params, state)
    _sync(sys_.device)
    dt = time.perf_counter() - t0
    seq = torch.cat([prompt, gen_toks], 1).cpu().numpy()
    B = args.batch
    print(f"prefill {args.prompt_len} tok x{B}: {t_prefill * 1e3:.1f} ms")
    print(f"decode  {steps} steps x{B}: {dt * 1e3:.1f} ms "
          f"({B * steps / dt:.1f} tok/s) [lane engine; first calls "
          f"included]")
    print("sample token ids (first row):", seq[0, :24].tolist(), "...")


def _single_batch_step_loop(args, cfg, sys_, params):
    """Single-stream decode driven one serve_step at a time."""
    seeds = sys_.mask_seeds()
    B = args.batch
    total = args.prompt_len + args.gen
    prompt = _prompts(args, cfg, sys_.device)
    caches = sys_.init_caches(B, total)
    t0 = time.perf_counter()
    # per-request nonce: fresh-mask prefills must never share a round
    _, caches = sys_.prefill(params, prompt, caches, seeds=seeds,
                             round_idx=args.seed)
    _sync(sys_.device)
    t_prefill = time.perf_counter() - t0
    key = decode_mod.key_tensor(blinding.prng_key(args.seed + 1),
                                sys_.device)
    t0 = time.perf_counter()
    gen_toks, caches, _, _ = decode_mod.serve_tokens(
        sys_, params, prompt[:, -1:], caches, args.prompt_len - 1, args.gen,
        seeds, key=key, temperature=args.temperature)
    _sync(sys_.device)
    dt = time.perf_counter() - t0
    seq = torch.cat([prompt, gen_toks], 1).cpu().numpy()
    print(f"prefill {args.prompt_len} tok x{B}: {t_prefill * 1e3:.1f} ms")
    print(f"decode  {args.gen} steps x{B}: {dt * 1e3:.1f} ms "
          f"({B * args.gen / dt:.1f} tok/s) [step loop]")
    print("sample token ids (first row):", seq[0, :24].tolist(), "...")


if __name__ == "__main__":
    main()
