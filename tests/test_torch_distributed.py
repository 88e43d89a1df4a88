"""The FSDP plan (``repro_torch.sharding``, ``launch.steps.shard_step``) on
a 2 x 2 (data x model) gloo mesh on the CPU, held against the port's
one-process steps and the reference's single-device steps: the
counterpart of tests/test_distributed.py.

One module-scoped spawn starts 4 ranks (a FileStore under the test's
temporary directory, one torch thread a rank) and runs every case of
``_torch_distributed_ranks.run_cases``; the parent meanwhile runs the
port's one-process steps and the reference's jitted ones on the same
weights (the port's, seed 0, handed over as numpy) and batches.

  * train steps: qwen2.5-3b, qwen3-moe-235b-a22b and mamba2-2.7b (the
    reference test's three: sgd, lr 1e-2, batch (4, 16), layout "tp"),
    qwen2.5-3b on the int8 wire (the round scale a max over the ranks),
    qwen3-moe at capacity factor 0.25, where the one-process step drops
    tokens (so the global capacity, the slots after the lower ranks'
    tokens and the global load-balance statistics are held), and adam +
    ZeRO-1 under "zero3" on qwen2.5-3b widened to vocab 4096 / d_ff 2048
    (at smoke size no leaf reaches _add_fsdp's 2^20-element floor);
  * the serve step (one decode round at batch 4, cache 16, position 3,
    under ``serve_shardings``);
  * on every rank, every leaf's block has the shape its spec gives the
    whole leaf, before and after the step, and the passive parties stay
    views of the stacked group's block.

Tolerances. Against the port's one-process step: the losses rtol 1e-6
(7e-8 relative measured: the global mean sums the ranks' token sums in
another order), the sgd cases' updated parameters atol 1e-7 / rtol 1e-6
(1.5e-8 measured), the decode logits and caches bit for bit. Against the
reference: tests/test_torch_lm.py's rtol 1e-4 / atol 1e-5 for losses,
parameters, logits and caches. The adam case's first update is
lr * g / (|g| + eps), about lr * sign(g), so where the clipped gradient
is under 1e-4 its sign, and the update, may differ by up to 2 lr: held
at the tolerance above where |g| >= 1e-4 and within 2 lr + 1e-5 elsewhere,
as tests/test_torch_lm_train.py holds the reference's adam step.
"""
import concurrent.futures
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_distributed_ranks as ranks
from repro.configs import base as jcfg
from repro.configs.base import EasterConfig as JEasterConfig
from repro.configs.base import InputShape as JInputShape
from repro.launch import steps as jsteps
from repro_torch import checkpoint, sharding
from repro_torch.core import train_loop
from repro_torch.launch import mesh, steps
from repro_torch.models import moe
from repro_torch.optim import global_norm
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-5          # tests/test_torch_lm.py's, vs the reference
LR = 1e-2
# the reference's steps compiled with XLA's backend optimizations off: a
# third of the compile time, the same function (the losses move in the
# last float32 bits, far inside RTOL / ATOL)
_QUICK_XLA = {"xla_backend_optimization_level": 0,
              "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    """``fn`` compiled for ``args`` with _QUICK_XLA, applied to them."""
    return jax.jit(fn).lower(*args).compile(_QUICK_XLA)(*args)
CASES = {c[0]: c for c in ranks.TRAIN_CASES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Rank results (rank order) of one 4-rank run; the parent's own
    one-process and reference steps overlap it."""
    store = str(tmp_path_factory.mktemp("mesh_group"))
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(mesh.spawn_ranks, ranks.run_cases, 4, store_dir=store,
                    device="cpu", threads=1, timeout_s=240)
    # the reference's compiles, a few at once (XLA compiles without the GIL)
    with concurrent.futures.ThreadPoolExecutor(3) as refs:
        jobs = [refs.submit(_reference, name) for name in CASES]
        jobs.append(refs.submit(_reference_serve))
        for name in CASES:
            _one_process(name)
        _one_process_serve()
        for j in jobs:
            j.result()
    yield fut.result()
    ex.shutdown()


def _ref_cfg(arch, changes):
    cfg = jcfg.smoke_variant(jcfg.get_config(arch))
    changes = {k: v for k, v in changes.items() if k != "mask_mode"}
    if "capacity_factor" in changes:
        changes["moe"] = dataclasses.replace(
            cfg.moe, capacity_factor=changes.pop("capacity_factor"))
    return dataclasses.replace(cfg, **changes)


def _ref_system(arch, changes):
    return jsteps.make_system(_ref_cfg(arch, changes), JEasterConfig(
        num_passive=3, d_embed=64, decision_layers=1,
        mask_mode=changes.get("mask_mode", "float")))


def _np(tree):
    return checkpoint.params_to_numpy(tree)


@functools.lru_cache(maxsize=None)
def _one_process(name):
    """The port's one-process step on the case's weights and batch: (loss,
    per-party losses, updated params, clipped gradients) as numpy."""
    _, arch, changes, opt_name, _, _ = CASES[name]
    cfg = ranks.config(arch, changes)
    sys_ = ranks.system(cfg, mask_mode=changes.get("mask_mode", "float"))
    params = sys_.init_params(torch.Generator().manual_seed(0))
    batch = ranks.train_batch(cfg)
    _, _, grads = train_loop.loss_and_grads(sys_, params, batch, 0,
                                            sys_.mask_seeds())
    norm = float(global_norm(grads))
    clipped = _np(grads)
    scale = min(1.0, 1.0 / (norm + 1e-9))
    step, opt = steps.build_train_step(sys_, opt_name, lr=LR)
    state = opt.init({"parties": params["parties"]})
    params, state, m = step(params, state, batch, 0)
    return (float(m["loss"]), m["per_party"].numpy(),
            _np({"parties": params["parties"]}),
            [np.abs(g) * scale for g in tree_leaves(clipped)])


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference's jitted single-device step on the same weights."""
    _, arch, changes, opt_name, _, _ = CASES[name]
    cfg = ranks.config(arch, changes)
    tree = ranks.system(cfg).export_params(ranks.system(cfg).init_params(
        torch.Generator().manual_seed(0)))
    js = _ref_system(arch, changes)
    params = jax.tree.map(jnp.asarray, tree)
    step, opt = jsteps.build_train_step(js, opt_name, lr=LR)
    batch = {k: jnp.asarray(v.numpy())
             for k, v in ranks.train_batch(cfg).items()}
    new, _, m = _jit(step, params, opt.init(params), batch,
                     jnp.asarray(0, jnp.int32))
    return (float(m["loss"]), np.asarray(m["per_party"]),
            jax.tree.map(np.asarray, new))


@functools.lru_cache(maxsize=None)
def _one_process_serve():
    cfg = ranks.config("qwen2.5-3b", {})
    sys_ = ranks.system(cfg)
    params = sys_.init_params(torch.Generator().manual_seed(2))
    serve = steps.build_serve_step(sys_, ranks.InputShape(
        "d", ranks.S, ranks.B, "decode"))
    logits, caches = serve(params, ranks.serve_inputs(cfg),
                           sys_.init_caches(ranks.B, ranks.S),
                           ranks.SERVE_POS)
    return logits.numpy(), _np(caches)


@functools.lru_cache(maxsize=None)
def _reference_serve():
    cfg = ranks.config("qwen2.5-3b", {})
    sys_ = ranks.system(cfg)
    tree = sys_.export_params(sys_.init_params(
        torch.Generator().manual_seed(2)))
    js = _ref_system("qwen2.5-3b", {})
    serve = jsteps.build_serve_step(js, JInputShape("d", ranks.S, ranks.B,
                                                    "decode"))
    batch = {"tokens": jnp.asarray(ranks.serve_inputs(cfg)["tokens"].numpy())}
    logits, caches = _jit(serve, jax.tree.map(jnp.asarray, tree), batch,
                          js.init_caches(ranks.B, ranks.S),
                          jnp.asarray(ranks.SERVE_POS, jnp.int32))
    return np.asarray(logits), jax.tree.map(np.asarray, caches)


def _close(got, want, rtol, atol):
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=rtol, atol=atol)


def _adam_close(got, want, gabs):
    """The adam case's rule (module docstring)."""
    for a, b, g in zip(tree_leaves(got), tree_leaves(want), gabs):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        big = g >= 1e-4
        np.testing.assert_allclose(a[big], b[big], rtol=RTOL, atol=ATOL)
        assert np.all(np.abs(a - b) <= 2 * LR + ATOL)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_train_step_matches_single_device(spawned, name):
    _, arch, changes, opt_name, layout, zero1 = CASES[name]
    for r in spawned:
        got = r[name]
        assert got["bad_blocks"] == [], (r["rank"], got["bad_blocks"])
        assert got["views"]
        # the batch rows: 2 a rank over "data" (tp), 1 over both (zero3)
        assert got["rows"] == (1 if layout == "zero3" else 2)
        assert got["n_sharded"] > 0
    got = spawned[0][name]
    loss, per, params, gabs = _one_process(name)
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-6)
    np.testing.assert_allclose(got["per_party"], per, rtol=1e-6)
    r_loss, r_per, r_params = _reference(name)
    np.testing.assert_allclose(got["loss"], r_loss, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got["per_party"], r_per, rtol=RTOL,
                               atol=ATOL)
    if opt_name == "adam":
        _adam_close(got["params"], params, gabs)
        _adam_close(got["params"], r_params, gabs)
    else:
        _close(got["params"], params, 1e-6, 1e-7)
        _close(got["params"], r_params, RTOL, ATOL)


def test_moe_case_drops_tokens():
    """At capacity factor 0.25 the one-process step's tokens outnumber its
    slots: T*K assignments over E experts of ``capacity(T)`` slots."""
    cfg = ranks.config("qwen3-moe-235b-a22b", {"capacity_factor": 0.25})
    T = ranks.B * ranks.S
    assert T * cfg.moe.top_k > cfg.moe.n_experts * moe.capacity(T, cfg.moe)
    # and a rank's own tokens would fit under a capacity of its own count:
    # the global count is what drops them
    assert moe.capacity(T, cfg.moe) != moe.capacity(T // 2, cfg.moe)


def test_zero3_case_shards_over_data():
    """The widened case's table and stacked MLP leaves reach the 2^20
    floor and lie over both axes; ZeRO-1 shards the small leaves' state
    over "data"."""
    cfg = ranks.config("qwen2.5-3b", {"vocab_size": 4096, "d_ff": 2048})
    sys_ = steps.make_system(cfg, ranks.system(cfg).easter, device="meta")
    params = steps.abstract_params(sys_)
    m = mesh.abstract_mesh((2, 2), ("data", "model"))
    spec = sharding.param_specs(params, m, layout="zero3")
    bb = spec["parties"][0]["backbone"]
    assert bb["embed"]["table"] == (("data", "model"), None)
    assert bb["segments"][0]["p0"]["mlp"]["up"]["w"] == (None, None,
                                                         ("data", "model"))
    _, opt = steps.build_train_step(sys_, "adam")
    state = opt.init({"parties": params["parties"]})
    ospec = sharding.opt_state_specs(state, params, m, zero1=True,
                                     layout="zero3")
    assert ospec["m"]["parties"][0]["final_norm"]["scale"] == ("data",)


def test_sharded_serve_step_matches_single_device(spawned):
    for r in spawned:
        assert r["serve"]["bad_blocks"] == []
    got = spawned[0]["serve"]
    logits, caches = _one_process_serve()
    np.testing.assert_array_equal(got["logits"], logits)
    for a, b in zip(tree_leaves(got["caches"]), tree_leaves(caches)):
        np.testing.assert_array_equal(a, b)
    r_logits, r_caches = _reference_serve()
    np.testing.assert_allclose(got["logits"], r_logits, rtol=RTOL, atol=ATOL)
    _close(got["caches"], r_caches, RTOL, ATOL)


def test_collective_bytes_of_a_prefill():
    """The recording mesh on a smoke prefill (the meta device, rank 0 of an
    abstract 2 x 2 mesh, one prompt row, which does not divide over
    "data", so no embedding rows are gathered): its all-gathers move the
    whole bytes of every sharded parameter leaf, once each, but the token
    tables, whose prompt rows are looked up where they lie and summed over
    the vocabulary's axis (one all-reduce of (parties, tokens, d_model));
    nothing else moves."""
    from repro_torch.launch import dryrun
    cfg = ranks.config("qwen2.5-3b", {})
    sys_ = steps.make_system(cfg, ranks.system(cfg).easter, device="meta")
    params = steps.abstract_params(sys_)
    shape = ranks.InputShape("p", ranks.S, 1, "prefill")
    specs = steps.input_specs(cfg, shape, sys_)
    rec = mesh.RecordingMesh(mesh.abstract_mesh((2, 2), ("data", "model")))
    prefill = steps.build_prefill_step(sys_, shape)
    out_caches = prefill(params, specs["batch"])[1]
    in_sh, out_sh = steps.prefill_shardings(sys_, rec, specs, params,
                                            out_caches)
    lp = sharding.shard_tree(params, in_sh[0], rec)
    lb = sharding.shard_tree(specs["batch"], in_sh[1], rec)
    E, _ = steps.shard_step(prefill, rec, in_sh, out_sh)(lp, lb)
    assert tuple(E.shape) == (1, ranks.S, sys_.easter.d_embed)
    tree = {"parties": params["parties"]}
    leaves = list(zip(tree_leaves(tree), sharding.spec_leaves(
        {"parties": in_sh[0]["parties"]})))
    tables = {id(p["backbone"]["embed"]["table"]) for p in tree["parties"]}
    assert all(s == ("model", None) for x, s in leaves if id(x) in tables)
    want = sum(x.numel() * x.element_size() for x, s in leaves
               if any(e is not None for e in s) and id(x) not in tables)
    rows = sys_.C * ranks.S * cfg.d_model * 4
    coll = dryrun.collective_bytes(rec)
    assert want > 0
    assert coll["all-gather"] == want
    assert coll["all-reduce"] == rows
    assert coll["total"] == want + rows
    assert coll["count"] == len(rec.calls)


def test_dryrun_runs_a_step_as_rank_0_of_16x16(tmp_path):
    """The dry run's CLI path: a decode step as rank 0 of the reference's
    16 x 16 mesh (serve_shardings: the model axis shards the attention,
    the cache's heads and the data axis its lanes): per-rank bytes below
    the whole tree's, the collectives recorded, the logits whole."""
    from repro_torch.launch import dryrun
    r = dryrun.run_one("qwen2.5-3b", "decode_32k", False, layout="zero3",
                       zero1=True, flops=False, save_dir=str(tmp_path))
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    assert 0 < r["per_rank"]["weight_bytes"] < r["weight_bytes"] / 8
    # K/V split 256 ways (lanes over "data", heads over "model"); only the
    # layers' position counters are whole on every rank
    n = r["cache_bytes"] // 256
    assert n <= r["per_rank"]["cache_bytes"] < n + 1024
    assert r["collective_bytes"]["all-gather"] > 0
    assert r["outputs"] == {"logits": [[128, 1, 151936], "bfloat16"]}
    assert (tmp_path / "qwen2.5-3b_decode_32k_16x16.json").exists()
