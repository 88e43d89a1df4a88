#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:

  build   nvcc-builds every CUDA kernel source of the port (sm_90a).
  kernel  holds each kernel against its plain PyTorch version on the card,
          values and autograd gradients, over party counts K up to 127,
          odd and even (N, d), a 4-D input, float32 and bfloat16, and a
          mask dtype that differs from the embeddings'.
  slice   the paper's Table II setting (C = 4 heterogeneous MLP parties,
          d_embed 128, batch 128, adam 1e-3, mnist_like data, fresh masks,
          aggregation through the kernel, the classifier's default): 30
          training rounds on the card, then per-party
          test accuracy. Step 0 is compared with the same step on the CPU.
  joint   one round of grad_mode="joint", whose backward runs through the
          backward kernel; gradients compared with the CPU.
  timing  each kernel, its plain version and its bound, timed with CUDA
          events at the slice's shape and at the many-party shape.
  profile host-clock split of a round into masks and train step, and
          torch.profiler device time by kernel over 5 rounds.

The launch counters are set to 0 just before the slice and joint rounds
and read just after. The second-to-last line is the JSON kernel record;
the last line is {"ok": true, "device": {...}}. Any failed check raises:
the script then exits non-zero and prints no result. It needs a CUDA
device and the repository's src/ beside it.
"""
from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet peak
FP32_FLOPS = 67e12               # H100 SXM data sheet, float32 off the tensor cores
SLICE_ROUNDS = 30
SLICE_BATCH = 128
D_EMBED = 128


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def bf16_ulp(x):
    """One bfloat16 ulp at each value of float32 tensor x."""
    import torch
    _, e = torch.frexp(x.abs().clamp_min(torch.finfo(torch.float32).tiny))
    return torch.ldexp(torch.ones_like(x), e - 8)


def max_err(got, want, dtype):
    """(max abs error, passes): float32 within atol = rtol = 1e-5,
    bfloat16 within one bfloat16 ulp of the float32-accumulated value."""
    import torch
    g, w = got.detach().float(), want.detach().float()
    err = (g - w).abs()
    if dtype == torch.bfloat16:
        ok = bool((err <= bf16_ulp(w)).all())
    else:
        ok = bool((err <= 1e-5 + 1e-5 * w.abs()).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    path = build.build("blind_agg")
    dt = time.perf_counter() - t0
    logf = path.with_suffix(".log")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers",
                                       logf.read_text())] if logf.exists() else []
    spills = (len(re.findall(r"[1-9]\d* bytes spill", logf.read_text()))
              if logf.exists() else 0)
    log("build", f"blind_agg.cu -> {path.name} in {dt:.1f} s "
                 f"(nvcc sm_90a; {len(regs)} kernels, max {max(regs or [0])} "
                 f"registers, {spills} with spills)")
    build.load("blind_agg")


def _case(K, lead, d, dtype, mdtype, gen):
    import torch
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import ref
    dev = "cuda"
    ea = torch.randn(lead + (d,), generator=gen, device=dev).to(dtype)
    ep = torch.randn((K,) + lead + (d,), generator=gen, device=dev).to(dtype)
    mk = torch.randn((K,) + lead + (d,), generator=gen, device=dev).to(mdtype)
    g = torch.randn(lead + (d,), generator=gen, device=dev).to(dtype)
    ts = [t.clone().requires_grad_(True) for t in (ea, ep, mk)]
    ps = [t.clone().requires_grad_(True) for t in (ea, ep, mk)]
    out = tba.blind_agg(*ts)
    want = ref.reference_blind_agg(*ps)
    out.backward(g)
    want.backward(g)
    torch.cuda.synchronize()
    exact = ref.reference_blind_agg(ea.float(), ep.float(), mk.float())
    errs, oks = [], []
    e, ok = max_err(out, want, dtype)
    # bf16 output: compare against the float32 accumulation it rounds
    if dtype == torch.bfloat16:
        ok = ok and bool(((out.float() - exact).abs()
                          <= bf16_ulp(exact)).all())
    errs.append(e)
    oks.append(ok)
    for a, b in zip(ts, ps):
        if a.grad.dtype != b.grad.dtype:
            raise AssertionError(f"grad dtype {a.grad.dtype} != {b.grad.dtype}")
        e, ok = max_err(a.grad, b.grad, a.grad.dtype)
        errs.append(e)
        oks.append(ok)
    return errs, all(oks)


def phase_kernels():
    """Both kernels against their plain versions on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(K, (N,), d, dt, dt) for dt in (f32, bf16)
             for K in (1, 3, 15, 63, 127) for N in (128, 100)
             for d in (128, 64, 100)]
    cases += [(K, (2, 64), d, dt, dt) for K in (3, 63) for d in (128, 100)
              for dt in (f32, bf16)]                     # 4-D input
    cases += [(3, (128,), 128, bf16, f32), (63, (128,), 64, f32, bf16)]
    cases += [(3, (7,), 13, f32, f32), (5, (9,), 11, bf16, bf16)]  # N*d % 8
    worst = {f32: 0.0, bf16: 0.0}
    worst_f32 = {"blind_agg_fwd": 0.0, "blind_agg_bwd": 0.0}
    failed = []
    for K, lead, d, dt, mdt in cases:
        errs, ok = _case(K, lead, d, dt, mdt, gen)
        worst[dt] = max(worst[dt], max(errs))
        if dt == f32:
            worst_f32["blind_agg_fwd"] = max(worst_f32["blind_agg_fwd"],
                                             errs[0])
            worst_f32["blind_agg_bwd"] = max(worst_f32["blind_agg_bwd"],
                                             max(errs[1:]))
        tag = (f"K={K} shape={lead + (d,)} {str(dt)[6:]} "
               f"mask={str(mdt)[6:]}")
        log("kernel", f"{tag}: max_abs_err out {errs[0]:.3g} dEa {errs[1]:.3g} "
                      f"dEp {errs[2]:.3g} dr {errs[3]:.3g} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(tag)
    if failed:
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"{failed}")
    log("kernel", f"{len(cases)} cases within tolerance (float32 atol=rtol="
                  f"1e-5, bfloat16 one ulp); worst float32 "
                  f"{worst[f32]:.3g}, bfloat16 {worst[bf16]:.3g}")
    return worst_f32


# (embedding-net widths, decision-net widths) of the paper's Table II
# heterogeneous MLP parties, as benchmarks/harness.py::hetero_arches builds
# them at its default depth (el_pl = (2, 1): three embedding layers, one
# prediction layer); party k takes entry k % 4.
TABLE2_WIDTHS = [((256, 128, 256), (128,)),
                 ((128, 64, 128), (64,)),
                 ((512, 256, 512), (256,)),
                 ((96, 48, 96), (48,))]


def table2_arches(C: int, n_cls: int, d_embed: int):
    from repro_torch.core.party_models import PartyArch
    return [PartyArch("mlp", *TABLE2_WIDTHS[k % 4], d_embed, n_cls)
            for k in range(C)]


def _build_slice(grad_mode, device):
    from repro_torch.configs.base import EasterConfig
    from repro_torch.core.protocol import EasterClassifier
    return EasterClassifier(EasterConfig(num_passive=3, d_embed=D_EMBED),
                            table2_arches(4, 10, D_EMBED), [196] * 4,
                            grad_mode=grad_mode, device=device)


def _to(xs, y, device):
    import torch
    return ([torch.from_numpy(x).to(device) for x in xs],
            torch.from_numpy(y).to(device))


def phase_slice(ds, batches, params0):
    """30 Table II rounds on the card; step 0 against the CPU port."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import blind_agg as tba
    gpu, cpu = _build_slice("easter", "cuda"), _build_slice("easter", "cpu")
    params = checkpoint.params_from_numpy(params0, "cuda")
    cparams = checkpoint.params_from_numpy(params0, "cpu")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    cinit, cstep = cpu.make_train_step("adam", 1e-3)
    opt, copt = init_opt(params), cinit(cparams)
    totals, round_ms = [], []
    tba.reset_launches()
    for i in range(SLICE_ROUNDS):
        xs, y = _to(*batches[i], "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = gpu.masks(SLICE_BATCH, i)
        params, opt, total, per = step(params, opt, xs, y, masks)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        if tba.LAUNCHES["blind_agg_fwd"] != i + 1:
            raise AssertionError(f"round {i}: forward kernel launches "
                                 f"{tba.LAUNCHES['blind_agg_fwd']} != {i + 1}")
        totals.append(float(total))
        if i == 0:
            cm = cpu.masks(SLICE_BATCH, 0)
            mask_err = float((masks.cpu() - cm).abs().max())
            cxs, cy = _to(*batches[0], "cpu")
            _, _, ctotal, cper = cstep(cparams, copt, cxs, cy, masks.cpu())
            rel = float(((per.cpu() - cper).abs() / cper.abs()).max())
            log("slice", f"step 0 per-party losses card "
                         f"{[round(float(v), 6) for v in per]} cpu "
                         f"{[round(float(v), 6) for v in cper]}: max rel "
                         f"diff {rel:.3g} (limit 1e-4); masks made on the "
                         f"card vs the CPU: max abs diff {mask_err:.3g} "
                         f"(limit 4e-6)")
            if not rel <= 1e-4:
                raise AssertionError("step 0 differs between card and CPU")
            # same PRF bits on both; log1p/sqrt differ by an ulp or two
            # between CUDA and the CPU, in each of a party's two pair masks
            if not mask_err <= 4e-6:
                raise AssertionError("PRF masks differ between card and CPU")
    launches = dict(tba.LAUNCHES)
    if not all(math.isfinite(t) for t in totals):
        raise AssertionError(f"non-finite loss: {totals}")
    first, last = statistics.mean(totals[:3]), statistics.mean(totals[-3:])
    log("slice", f"{SLICE_ROUNDS} rounds: total loss {totals[0]:.4f} -> "
                 f"{totals[-1]:.4f} (mean of first 3 {first:.4f}, last 3 "
                 f"{last:.4f}); launches {launches}")
    if not last < first:
        raise AssertionError("total loss did not fall")
    xs_te, y_te = _to(ds.x_test_parts, ds.y_test, "cuda")
    acc = gpu.accuracy(params, xs_te, y_te)
    steady = statistics.median(round_ms[5:])
    log("slice", f"per-party test accuracy {[round(float(a), 4) for a in acc]}"
                 f"; ms per round (median of rounds 5-{SLICE_ROUNDS - 1}, "
                 f"masks + forward + backward + adam) {steady:.3f}")
    return launches, steady


def phase_joint(batches, params0):
    """One grad_mode="joint" round on the card; gradients vs the CPU."""
    import torch
    from repro_torch import checkpoint
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.tree import tree_leaves
    gpu, cpu = _build_slice("joint", "cuda"), _build_slice("joint", "cpu")
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    xs, y = _to(*batches[0], "cuda")
    masks = gpu.masks(SLICE_BATCH, 0)
    tba.reset_launches()
    step(params, opt, xs, y, masks)
    torch.cuda.synchronize()
    launches = dict(tba.LAUNCHES)
    if launches["blind_agg_bwd"] < 1 or launches["blind_agg_fwd"] < 1:
        raise AssertionError(f"joint round launches {launches}")
    # gradients of the same round from the same weights, card vs CPU
    gp = checkpoint.params_from_numpy(params0, "cuda")
    cp = checkpoint.params_from_numpy(params0, "cpu")
    gt, _ = gpu.loss_fn(gp, xs, y, masks)
    ct, _ = cpu.loss_fn(cp, *_to(*batches[0], "cpu"), masks.cpu())
    gg = torch.autograd.grad(gt, tree_leaves(gp))
    cg = torch.autograd.grad(ct, tree_leaves(cp))
    worst = 0.0
    for a, b in zip(gg, cg):
        err = float(((a.cpu() - b).abs() / (1e-5 + 1e-4 * b.abs())).max())
        worst = max(worst, err)
    log("joint", f"1 round: launches {launches}; gradients card vs CPU "
                 f"within atol 1e-5 + rtol 1e-4 (worst ratio {worst:.3g})")
    if not worst <= 1.0:
        raise AssertionError("joint-mode gradients differ between card and CPU")
    return launches


def phase_profile(batches, params0):
    """Where a slice round's time goes: host clock for masks vs the train
    step, and torch.profiler device time by kernel over 5 steady rounds.
    Launches here are not part of the counted slice and joint rounds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import checkpoint
    gpu = _build_slice("easter", "cuda")
    params = checkpoint.params_from_numpy(params0, "cuda")
    init_opt, step = gpu.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    data = [_to(*b, "cuda") for b in batches]
    mask_ms, step_ms = [], []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        masks = gpu.masks(SLICE_BATCH, i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, opt, _, _ = step(params, opt, *data[i], masks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if i >= 3:
            mask_ms.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
    log("profile", f"host clock, median of rounds 3-9: masks "
                   f"{statistics.median(mask_ms):.3f} ms, train step "
                   f"{statistics.median(step_ms):.3f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(10, 15):
            masks = gpu.masks(SLICE_BATCH, i)
            params, opt, _, _ = step(params, opt, *data[i], masks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    # kernels are the CUDA-side rows; the aten op rows repeat their time
    kern = [r for r in rows if r.device_type == DeviceType.CUDA]
    busy_ms = sum(r.self_device_time_total for r in kern) / 1e3
    launches = sum(r.count for r in kern)
    log("profile", f"5 rounds under torch.profiler: wall {wall_ms:.3f} ms, "
                   f"device busy {busy_ms:.3f} ms (idle share "
                   f"{1 - busy_ms / wall_ms:.3f}), {launches} kernels "
                   f"({launches / 5:.0f} a round)")
    ops = [r for r in rows if r.device_type != DeviceType.CUDA
           and r.self_device_time_total > 0]
    for r in sorted(ops, key=lambda r: -r.self_device_time_total)[:10]:
        log("profile", f"  {r.key[:40]:40s} calls {r.count:6d} device "
                       f"{r.self_device_time_total / 1e3:.3f} ms")


def _time_ms(fn, reps=25, inner=20):
    """Device time of one call: median over ``reps`` of the mean of
    ``inner`` back-to-back calls between two CUDA events. Each rep first
    queues a spin kernel (torch.cuda._sleep) so that the host has queued
    all ``inner`` calls before the card reaches the first event; then the
    events time the card, not the host's launch rate. A rep in which the
    card reached the first event before the host was done queueing is
    repeated with a longer spin."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times, spin = [], 4_000_000
    while len(times) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        host_behind = a.query()
        b.synchronize()
        if host_behind:
            spin *= 2
            if spin > 1_000_000_000:
                raise RuntimeError("host cannot queue ahead of the card")
            continue
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _host_ms(fn, calls=200):
    """Host time to issue one call (Python wrapper + launch), by the host
    clock over ``calls`` calls that are not waited for; the card works
    behind the host meanwhile."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e3


def phase_timing():
    """Kernel, plain version and bound at the slice's and many-party shape."""
    import torch
    from repro_torch.kernels import blind_agg as tba
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {}
    for label, K, N, d in (("slice", 3, 128, 128),
                           ("many_party", 63, 128, 64)):
        s = 4                                              # float32
        ea = torch.randn((N, d), generator=gen, device="cuda")
        ep = torch.randn((K, N, d), generator=gen, device="cuda")
        mk = torch.randn((K, N, d), generator=gen, device="cuda")
        g = torch.randn((N, d), generator=gen, device="cuda")
        nd = N * d
        fwd_bytes = (1 + 2 * K) * nd * s + nd * s
        bwd_bytes = nd * s + (1 + K) * nd * s     # mask grad not asked for
        fwd_ops, bwd_ops = (2 * K + 1) * nd, nd
        row = {}
        for name, kern, plain, nbytes, nops in (
                ("blind_agg_fwd", lambda: tba.blind_agg_fwd(ea, ep, mk),
                 lambda: ref.reference_blind_agg(ea, ep, mk),
                 fwd_bytes, fwd_ops),
                ("blind_agg_bwd",
                 lambda: tba.blind_agg_bwd(g, K, torch.float32, torch.float32,
                                           need_mk=False),
                 lambda: ref.reference_blind_agg_bwd(g, K, torch.float32,
                                                     torch.float32,
                                                     need_mk=False),
                 bwd_bytes, bwd_ops)):
            # turns: plain, kernel, kernel, plain
            p1 = _time_ms(plain)
            k1 = _time_ms(kern)
            k2 = _time_ms(kern)
            p2 = _time_ms(plain)
            hk, hp = _host_ms(kern), _host_ms(plain)
            bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_FLOPS) * 1e3
            row[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2),
                         "bound_ms": bound, "bytes": nbytes, "ops": nops,
                         "host_ms": hk, "plain_host_ms": hp}
            log("timing", f"{name} {label} K={K} N={N} d={d} float32: kernel "
                          f"{k1:.4f}/{k2:.4f} ms, plain {p1:.4f}/{p2:.4f} ms, "
                          f"bound {bound:.5f} ms ({nbytes} B at 3.35 TB/s, "
                          f"data-sheet peak; bound by bytes); no single "
                          f"PyTorch call computes it (library_ms null); "
                          f"host time per call: kernel wrapper {hk:.4f} ms, "
                          f"plain {hp:.4f} ms")
        out[label] = row
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    from repro_torch import checkpoint
    from repro_torch.data import batch_iterator, make_dataset, vertical_partition
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("setup", f"torch {torch.__version__} cuda {torch.version.cuda} on "
                 f"{torch.cuda.get_device_name(0)}; "
                 f"torch.backends.cuda.matmul.allow_tf32="
                 f"{torch.backends.cuda.matmul.allow_tf32} "
                 f"torch.backends.cudnn.allow_tf32="
                 f"{torch.backends.cudnn.allow_tf32}")

    phase_build()
    worst_f32 = phase_kernels()

    ds = make_dataset("mnist_like")
    ds.x_test_parts = vertical_partition(ds.x_test, 4, ds.image_hw)
    it = batch_iterator(ds.x_train, ds.y_train, SLICE_BATCH, seed=0)
    batches = []
    for _ in range(SLICE_ROUNDS):
        xb, yb = next(it)
        batches.append((vertical_partition(xb, 4, ds.image_hw), yb))
    table2 = _build_slice("easter", "cpu")
    params0 = checkpoint.params_to_numpy(
        table2.init_params(torch.Generator().manual_seed(0)))
    n_params = sum(a.size for a in tree_leaves(params0))
    log("slice", f"Table II: C=4 MLP parties, embedding widths "
                 f"{[a.hidden for a in table2.arches]}, d_embed {D_EMBED}, "
                 f"batch {SLICE_BATCH}, adam 1e-3, mnist_like split into "
                 f"4 strips of 28x7; {n_params} parameters, random from "
                 f"seed 0")

    slice_launches, ms_round = phase_slice(ds, batches, params0)
    joint_launches = phase_joint(batches, params0)
    timing = phase_timing()
    phase_profile(batches, params0)

    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
    if bad:
        raise AssertionError(f"the port imported {bad[:5]}")

    launches = {"blind_agg_fwd": slice_launches["blind_agg_fwd"]
                + joint_launches["blind_agg_fwd"],
                "blind_agg_bwd": slice_launches["blind_agg_bwd"]
                + joint_launches["blind_agg_bwd"]}
    src = "src/repro_torch/kernels/csrc/blind_agg.cu"
    replaces = {"blind_agg_fwd": "src/repro/kernels/blind_agg.py:38",
                "blind_agg_bwd": "src/repro/kernels/blind_agg.py:57"}
    kernels = []
    for name in ("blind_agg_fwd", "blind_agg_bwd"):
        t = timing["slice"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": worst_f32[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": "bytes",
            "library_ms": None})
    print(json.dumps({"kernels": kernels, "slice_ms_per_round": ms_round,
                      "many_party": timing["many_party"]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
