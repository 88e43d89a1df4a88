"""The FSDP plan (``repro_torch.sharding``, ``launch.steps.shard_step``) on
a 2 x 2 (data x model) gloo mesh on the CPU, with its tensor-parallel
compute over "model" under layout "tp", held against the port's
one-process steps and the reference's single-device steps: the
counterpart of tests/test_distributed.py.

One module-scoped spawn starts 4 ranks (a FileStore under the test's
temporary directory, one torch thread a rank) and runs every case of
``_torch_distributed_ranks.run_cases``; the parent meanwhile runs the
port's one-process steps and the reference's jitted ones on the same
weights (the port's, seed 0, handed over as numpy) and batches.

  * train steps: qwen2.5-3b, qwen3-moe-235b-a22b and mamba2-2.7b (the
    reference test's three: sgd, lr 1e-2, batch (4, 16), layout "tp":
    S = 16 divides the model axis, so the stream is sequence-parallel;
    the MoE FFN split by expert, the SSD by heads),
    qwen2.5-3b on the int8 wire (the round scale a max over the ranks),
    qwen3-moe at capacity factor 0.25, where the one-process step drops
    tokens (so the global capacity, the slots after the lower ranks'
    tokens and the global load-balance statistics are held), adam +
    ZeRO-1 under "zero3" on qwen2.5-3b widened to vocab 4096 / d_ff 2048
    (at smoke size no leaf reaches _add_fsdp's 2^20-element floor), the
    same on qwen2-vl-7b with 8 patch embeddings in the batch (M-RoPE and
    the patch insert under the plan, one row a rank), and
    qwen2.5-3b with one kv head (both model ranks' q heads read it) and
    with 3 q heads (the split would cut a head: the attention gathered),
    qwen2-moe-a2.7b with its shared expert split by expert and, at 3
    experts, by ff column, and recurrentgemma-9b (the RG-LRU at half its
    width); the MoE, SSD and RG-LRU cases also hold the gradients of the
    replicated leaves that feed a split product (the router, the shared
    gate, the SSD's in_proj, the convs' taps, the norms) to one process's;
  * decode rounds (batch 4, cache 16, position 3, under
    ``serve_shardings``): on the 2 x 2 mesh, blinded and unblinded, on a
    4 x 1 mesh of the same ranks (compute over the batch only), and with
    one kv head, whose cache lies over "model" by T; the split MoE on
    2 x 2 and 1 x 4, the SSD on 2 x 2 and the RG-LRU on 1 x 4, each also
    a (4, 16) prefill; a (4, 16) qwen2.5-3b prefill, sequence-parallel;
  * on every rank, every leaf's block has the shape its spec gives the
    whole leaf, before and after the step, and the passive parties stay
    views of the stacked group's block;
  * the recording mesh's collectives of a prefill and of a decode round
    (the meta device, an abstract 2 x 2 mesh), a decode round also with
    MoE, SSD and RG-LRU layers: activations only, their bytes by
    formula.

Tolerances. Against the port's one-process step: the losses rtol 1e-6
(7e-8 relative measured: the global mean sums the ranks' token sums in
another order), the sgd cases' updated parameters atol 1e-7 / rtol 1e-6
(1.5e-8 measured); the replicated leaves' gradients ``_close_tp`` at 32
ulps (18 measured: the split products' partial cotangents summed over
the ranks); the 4 x 1 decode's logits and caches bit for bit; the
tensor-parallel decode and prefill as ``_close_tp`` and
``_close_tp_caches`` say. Against
the reference: tests/test_torch_lm.py's rtol 1e-4 / atol 1e-5 for
losses, parameters, E, logits and caches. The adam case's first update is
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
        jobs += [refs.submit(_reference_serve, name) for name in SERVES]
        jobs += [refs.submit(_reference_prefill, name) for name in PREFILLS]
        for name in CASES:
            _one_process(name)
        for name in SERVES:
            _one_process_serve(name)
        for name in PREFILLS:
            _one_process_prefill(name)
        for j in jobs:
            j.result()
    yield fut.result()
    ex.shutdown()


def _ref_cfg(arch, changes):
    cfg = jcfg.smoke_variant(jcfg.get_config(arch))
    changes = {k: v for k, v in changes.items() if k != "mask_mode"}
    moe = {k: changes.pop(k) for k in ("capacity_factor", "n_experts")
           if k in changes}
    if moe:
        changes["moe"] = dataclasses.replace(cfg.moe, **moe)
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
    per-party losses, updated params, clipped gradients' magnitudes, the
    gradients by path) as numpy."""
    _, arch, changes, opt_name, _, _ = CASES[name]
    cfg = ranks.config(arch, changes)
    sys_ = ranks.system(cfg, mask_mode=changes.get("mask_mode", "float"))
    params = sys_.init_params(torch.Generator().manual_seed(0))
    batch = ranks.train_batch(cfg)
    _, _, grads = train_loop.loss_and_grads(sys_, params, batch, 0,
                                            sys_.mask_seeds())
    norm = float(global_norm(grads))
    clipped = _np(grads)
    by_path = {}
    sharding._map_with_path(
        lambda names, g: by_path.__setitem__("/".join(names), g), clipped)
    scale = min(1.0, 1.0 / (norm + 1e-9))
    step, opt = steps.build_train_step(sys_, opt_name, lr=LR)
    state = opt.init({"parties": params["parties"]})
    params, state, m = step(params, state, batch, 0)
    return (float(m["loss"]), m["per_party"].numpy(),
            _np({"parties": params["parties"]}),
            [np.abs(g) * scale for g in tree_leaves(clipped)], by_path)


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


SERVES = {c[0]: c for c in ranks.SERVE_CASES}


@functools.lru_cache(maxsize=None)
def _one_process_serve(name):
    _, arch, changes, _, lanes, blinded = SERVES[name]
    cfg = ranks.config(arch, changes)
    sys_ = ranks.system(cfg)
    params = sys_.init_params(torch.Generator().manual_seed(2))
    serve = ranks.serve_step(sys_, lanes, blinded)
    T, pos = ranks.serve_at(name)
    fe = ((ranks.enc_kv(sys_, params, cfg, lanes),)
          if cfg.family == "encdec" else ())
    logits, caches = serve(params, ranks.serve_inputs(cfg, lanes=lanes),
                           sys_.init_caches(lanes, T), pos, *fe)
    return logits.numpy(), _np(caches)


def _weights(cfg):
    sys_ = ranks.system(cfg)
    return sys_.export_params(sys_.init_params(
        torch.Generator().manual_seed(2)))


@functools.lru_cache(maxsize=None)
def _reference_serve(name):
    _, arch, changes, _, lanes, blinded = SERVES[name]
    cfg = ranks.config(arch, changes)
    js = _ref_system(arch, changes)
    if blinded:
        serve = jsteps.build_serve_step(js, JInputShape("d", ranks.S, lanes,
                                                        "decode"))
    else:
        def serve(params, batch, caches, pos):
            return js.serve_step(params, batch["tokens"], caches, pos, None)
    batch = {"tokens": jnp.asarray(ranks.serve_inputs(
        cfg, lanes=lanes)["tokens"].numpy())}
    T, pos = ranks.serve_at(name)
    params = jax.tree.map(jnp.asarray, _weights(cfg))
    fe = ()
    if cfg.family == "encdec":
        fe = (_jit(js.encoder_kv, params,
                   jnp.asarray(ranks.audio(cfg, lanes).numpy())),)
    logits, caches = _jit(serve, params, batch, js.init_caches(lanes, T),
                          jnp.asarray(pos, jnp.int32), *fe)
    return np.asarray(logits), jax.tree.map(np.asarray, caches)


# the prefills: qwen2.5-3b's ("prefill") and the split blocks' serve
# cases' ("prefill-<case>"), by name -> (arch, config changes)
PREFILLS = {"prefill": ("qwen2.5-3b", {}),
            **{"prefill-" + c[0]: (c[1], c[2]) for c in ranks.PREFILL_CASES}}


@functools.lru_cache(maxsize=None)
def _one_process_prefill(name="prefill"):
    arch, changes = PREFILLS[name]
    cfg = ranks.config(arch, changes)
    sys_ = ranks.system(cfg)
    prefill = steps.build_prefill_step(sys_, ranks.InputShape(
        "p", ranks.S, ranks.B, "prefill"))
    E, caches = prefill(sys_.init_params(torch.Generator().manual_seed(2)),
                        ranks.prefill_inputs(cfg))
    return E.numpy(), _np(caches)


@functools.lru_cache(maxsize=None)
def _reference_prefill(name="prefill"):
    arch, changes = PREFILLS[name]
    cfg = ranks.config(arch, changes)
    js = _ref_system(arch, changes)
    prefill = jsteps.build_prefill_step(js, JInputShape(
        "p", ranks.S, ranks.B, "prefill"))
    batch = {k: jnp.asarray(v.numpy())
             for k, v in ranks.prefill_inputs(cfg).items()}
    E, caches = _jit(prefill, jax.tree.map(jnp.asarray, _weights(cfg)),
                     batch)
    return np.asarray(E), jax.tree.map(np.asarray, caches)


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
    loss, per, params, gabs, grads = _one_process(name)
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
    if name in ranks.GRAD_CASES:
        # every replicated leaf that feeds a split product, against the
        # one process's gradient (unclipped, before the update)
        kinds = {k.rsplit("/", 1)[-1] for k in got["grads"]}
        want = ({"scale", "router"} if "moe" in arch
                else {"scale", "bias"} if "whisper" in arch
                else {"scale", "conv_w"})
        assert want <= kinds, kinds
        if "mamba2" in arch:
            assert {"in_proj", "conv_b"} <= kinds
        if name.startswith("qwen2-moe"):
            assert "shared_gate" in kinds
        if "whisper" in arch:
            # the encoder blocks' and final norms, the cross-attentions'
            assert {"encoder/blocks/ln1", "encoder/norm", "xattn/lnx"} <= {
                k.rsplit("/", 1)[0].split("backbone/")[-1]
                for k in got["grads"]}
        for k, g in got["grads"].items():
            _close_tp(g, grads[k], ulps=32)


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


def _close_tp(got, want, ulps=16):
    """A tensor-parallel output against one process: rtol 1e-6 and an atol
    of ``ulps`` float32 ulps (2^-23) of the leaf's largest magnitude. The
    row-parallel products (wo, down) and the vocabulary's log-sum-exp add
    their partials in another order than one process's GEMM, and every
    later layer carries the difference; its error scales with the
    magnitudes summed, not with the element, so an element near 0 fails
    a plain atol 1e-7. Measured (2 x 2, smoke qwen2.5-3b): at most 8.2
    ulps of the largest logit, 4.8 of E, and the same with the uplink
    unblinded ("serve-raw": 2.62e-6 against 2.72e-6 blinded), so the
    blinding adds nothing to it."""
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        np.testing.assert_allclose(
            a, b, rtol=1e-6, atol=ulps * 2.0 ** -23 * np.abs(b).max())


def _close_tp_caches(got, want):
    """Tensor-parallel caches (by party, by segment, by block) against one
    process: the stack's first block bit for bit, as no row-parallel sum
    lies before it (its k / v come from the rank's columns of wk / wv and
    the vocabulary-parallel embedding, an RG-LRU's state from its columns
    of in_x and w_r / w_i, an SSD's conv from the replicated in_proj: all
    exact), every later block at ``_close_tp`` with 8 ulps (measured: at
    most 5.5). One exception: the SSD decode step's state, whose einsum
    over a rank's heads contracts in another order than over all of them
    (0.016 ulps of the leaf's largest measured), is held at 8 ulps in the
    first block too."""
    for party_got, party_want in zip(got, want):
        for si, (seg_got, seg_want) in enumerate(zip(party_got, party_want)):
            for key in seg_want:
                for leaf in seg_want[key]:
                    a = np.asarray(seg_got[key][leaf])
                    b = np.asarray(seg_want[key][leaf])
                    if b.dtype.kind != "f":
                        np.testing.assert_array_equal(a, b)
                        continue
                    if si == 0 and key == "p0" and not (
                            leaf == "state" and b.ndim == 5):
                        np.testing.assert_array_equal(a[0], b[0])
                        a, b = a[1:], b[1:]
                    if b.size:
                        _close_tp(a, b, ulps=8)


@pytest.mark.parametrize("name", list(SERVES))
def test_sharded_serve_step_matches_single_device(spawned, name):
    """On the 4 x 1 mesh (compute split over the batch only) the logits
    and caches are the one process's bits; under "tp" on 2 x 2 and 1 x 4
    they are held by ``_close_tp`` and ``_close_tp_caches``, blinded or
    not. The caches whose one kv head does not divide the model axis (the
    T-split case, and recurrentgemma's over 4 ranks) lie over "model" by
    T, the others' do not."""
    cfg = ranks.config(*SERVES[name][1:3])
    m = SERVES[name][3][1]
    for r in spawned:
        assert r[name]["bad_blocks"] == []
        assert bool(r[name]["t_split"]) == (name in (
            "serve-t-split", "serve-rg-1x4", "serve-h3", "serve-gemma3-h3"))
        # every cache block kept: no K/V cache all-gathered
        assert r[name]["cache_gathers"] == []
        if cfg.family == "encdec":
            # the cross K/V made under the plan: this rank's rows and heads
            assert r[name]["enc_kv_shape"] == (
                cfg.n_layers, ranks.B // SERVES[name][3][0],
                cfg.n_audio_frames, cfg.n_kv_heads // m,
                cfg.resolved_head_dim)
    got = spawned[0][name]
    logits, caches = _one_process_serve(name)
    if m == 1:
        np.testing.assert_array_equal(got["logits"], logits)
        for a, b in zip(tree_leaves(got["caches"]), tree_leaves(caches)):
            np.testing.assert_array_equal(a, b)
    else:
        _close_tp(got["logits"], logits)
        _close_tp_caches(got["caches"], caches)
        if cfg.family == "encdec":      # the whole cross K/V, cut by the step
            _close_tp(got["logits_whole_kv"], logits)
    r_logits, r_caches = _reference_serve(name)
    np.testing.assert_allclose(got["logits"], r_logits, rtol=RTOL, atol=ATOL)
    _close(got["caches"], r_caches, RTOL, ATOL)


def test_sharded_prefill_matches_single_device(spawned):
    """A (4, 16) prefill: S divides the model axis, so the stream between
    layers is sequence-parallel (reduce-scatters after the row-parallel
    products); E (``_close_tp``) and the caches (``_close_tp_caches``)
    against one process, and both against the reference."""
    for r in spawned:
        assert r["prefill"]["bytes"]["reduce-scatter"] > 0
    got = spawned[0]["prefill"]
    E, caches = _one_process_prefill()
    _close_tp(got["E"], E)
    _close_tp_caches(got["caches"], caches)
    r_E, r_caches = _reference_prefill()
    np.testing.assert_allclose(got["E"], r_E, rtol=RTOL, atol=ATOL)
    _close(got["caches"], r_caches, RTOL, ATOL)


@pytest.mark.parametrize("name", [n for n in PREFILLS if n != "prefill"])
def test_sharded_prefill_of_split_blocks(spawned, name):
    """A (4, 16) prefill of the split MoE (2 x 2 and 1 x 4), SSD (2 x 2)
    and RG-LRU (1 x 4) stacks: the stream sequence-parallel, each block
    on the rank's "model" block; E (``_close_tp``) and the caches
    (``_close_tp_caches``) against one process, both against the
    reference."""
    blocks = {"whisper": {"enc heads", "xattn heads", "attn heads"},
              "h3": {"attn whole", "kv T"}}
    for r in spawned:
        assert r[name]["bytes"]["reduce-scatter"] > 0
        for k, want in blocks.items():
            if k in name:
                assert want <= set(r[name]["tp_blocks"]), r[name]["tp_blocks"]
    got = spawned[0][name]
    E, caches = _one_process_prefill(name)
    _close_tp(got["E"], E)
    _close_tp_caches(got["caches"], caches)
    r_E, r_caches = _reference_prefill(name)
    np.testing.assert_allclose(got["E"], r_E, rtol=RTOL, atol=ATOL)
    _close(got["caches"], r_caches, RTOL, ATOL)


def _recorded_step(kind, B, S, changes=None, arch="qwen2.5-3b"):
    """A smoke ``arch`` step (``kind`` "prefill" or "decode", B rows of S)
    on the meta device as rank 0 of an abstract 2 x 2 mesh: (config,
    system, the recording mesh, the output, the step's parameter
    specs)."""
    cfg = ranks.config(arch, changes or {})
    sys_ = steps.make_system(cfg, ranks.system(cfg).easter, device="meta")
    params = steps.abstract_params(sys_)
    shape = ranks.InputShape("s", S, B, kind)
    specs = steps.input_specs(cfg, shape, sys_)
    rec = mesh.RecordingMesh(mesh.abstract_mesh((2, 2), ("data", "model")))
    if kind == "prefill":
        step = steps.build_prefill_step(sys_, shape)
        in_sh, out_sh = steps.prefill_shardings(
            sys_, rec, specs, params, ranks.meta_caches(sys_, B, S))
        args = [params, specs["batch"]]
    else:
        step = steps.build_serve_step(sys_, shape)
        in_sh, out_sh = steps.serve_shardings(sys_, rec, specs, params)
        args = [params, specs["batch"], specs["caches"], specs["pos"]]
        if "fe_list" in specs:      # an encoder-decoder's cross K/V, whole
            args.append(specs["fe_list"])
    local = [sharding.shard_tree(a, s, rec) if isinstance(s, (dict, list))
             else a for a, s in zip(args, in_sh)]
    out = steps.shard_step(step, rec, in_sh, out_sh)(*local)
    return cfg, sys_, rec, out, in_sh[0]


def _no_weight_gathered(rec, sys_, pspec, whole=()):
    """No all-gather or broadcast of the recording has the shape of a
    leaf the model axis splits, or of one layer (or one party's layer) of
    it: every moved tensor is an activation. ``whole``: path names of the
    sub-blocks gathered and run whole (their leaves' shapes left out: the
    byte count holds the rest)."""
    params = steps.abstract_params(sys_)
    split, gathered = [], []
    sharding._zip_path(
        lambda names, x, s: (gathered if set(names) & set(whole)
                             else split).append(tuple(x.shape))
        if "model" in tuple(s) else None,
        {"parties": params["parties"]}, {"parties": pspec["parties"]})
    shapes = ({sh[i:] for sh in split for i in range(3)}
              - {sh[i:] for sh in gathered for i in range(3)})
    assert split
    assert not [c for c in rec.calls if c[0] in ("all-gather", "broadcast")
                and c[2] in shapes]


def test_collective_bytes_of_a_prefill():
    """The recording mesh on a smoke prefill (the meta device, rank 0 of an
    abstract 2 x 2 mesh, one prompt row, which does not divide over
    "data", of S = 16 positions, which divides over "model") under the
    tensor-parallel compute: no parameter moves (the heads, the MLP's
    columns and rows and the vocabulary stay each rank's block); the
    token rows are summed over the vocabulary's axis (one all-reduce of
    (parties, S, d_model)); each party's stream enters its S blocks once
    (no traffic), and each of its layers' attention and MLP all-gathers
    its block (1, S, d) and reduce-scatters back (1, S / 2, d); the
    stream is all-gathered whole once at the stack's end; the passive
    group's 3 parties move as one (3, ...) tensor. Nothing else moves."""
    from repro_torch.launch import dryrun
    cfg, sys_, rec, (E, _), pspec = _recorded_step("prefill", 1, ranks.S)
    assert tuple(E.shape) == (1, ranks.S, sys_.easter.d_embed)
    S, d, f32 = ranks.S, cfg.d_model, 4
    n_act = sys_.party_cfgs[0].n_layers
    n_pas = sys_.party_cfgs[1].n_layers
    K = sys_.C - 1
    row = S * d * f32                       # one party's (1, S, d)
    rows = sys_.C * row
    gathers = (2 * n_act + 1) * row + (2 * n_pas + 1) * K * row
    scatters = (2 * n_act * row + 2 * n_pas * K * row) // 2
    coll = dryrun.collective_bytes(rec)
    assert coll["all-reduce"] == rows
    assert coll["all-gather"] == gathers
    assert coll["reduce-scatter"] == scatters
    assert coll["broadcast"] == 0
    assert coll["total"] == rows + gathers + scatters
    assert coll["count"] == len(rec.calls)
    _no_weight_gathered(rec, sys_, pspec)


def test_collective_bytes_of_a_decode_round():
    """A decode round (4 lanes, 2 a data rank, cache 16) as rank 0 of the
    abstract 2 x 2 mesh: the embedding's all-reduce of (parties, 2,
    d_model), two all-reduces of (2, 1, d_model) a dense layer (the
    attention's and the MLP's row-parallel sums; the passive group's as
    one (3, 2, 1, d_model)), the decision MLP's (2, 1, d_embed), and the
    logits' all-gathers (over the vocabulary, then the data rows); no
    weight moves."""
    from repro_torch.launch import dryrun
    B, T = 4, ranks.S
    cfg, sys_, rec, (logits, _), pspec = _recorded_step("decode", B, T)
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    d, de, f32 = cfg.d_model, sys_.easter.d_embed, 4
    b = B // 2
    n_act = sys_.party_cfgs[0].n_layers
    n_pas = sys_.party_cfgs[1].n_layers
    K = sys_.C - 1
    layers = 2 * (n_act + K * n_pas) * b * d * f32
    embed = sys_.C * b * d * f32
    decision = sys_.easter.decision_layers * b * de * f32
    want_ar = layers + embed + decision
    gathers = b * cfg.vocab_size * f32 + B * cfg.vocab_size * f32
    coll = dryrun.collective_bytes(rec)
    assert coll["all-reduce"] == want_ar
    assert coll["all-gather"] == gathers
    assert coll["reduce-scatter"] == 0 and coll["broadcast"] == 0
    assert coll["total"] == want_ar + gathers
    _no_weight_gathered(rec, sys_, pspec)


# the decode round's split blocks: an MoE stack (4 experts, 2 a model
# rank), an SSD stack (16 heads, 8 a rank), a Griffin stack (the RG-LRU
# at half its width; 2 kv heads, so that its attention splits by heads,
# as the dense layers of the test above), whisper-small (2 of 4 heads a
# rank in its self- and cross-attention, the cross K/V this rank's heads)
# and a whole attention over a T-split cache (3 q heads and one kv head:
# the split would cut a head), by name -> (arch, config changes)
SPLIT_DECODES = {"qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
                 "mamba2-2.7b": ("mamba2-2.7b", {}),
                 "recurrentgemma-9b": ("recurrentgemma-9b",
                                       {"n_kv_heads": 2}),
                 "whisper-small": ("whisper-small", {}),
                 "h3": ("qwen2.5-3b", {"n_heads": 3, "n_kv_heads": 1})}


def _layer_bytes(cfg, kind, B, m, n_data):
    """The collectives' bytes by (kind, axis) of one float32 layer of a
    decode round over B lanes (B / n_data a data rank) on ``m`` model
    ranks: the row-parallel sums into the stream (an encoder-decoder's
    cross-attention a third), an MoE's load-balance statistics and slot
    prefix over "data", the SSD conv cache gathered whole over "model"
    (its packed channels do not align with a rank's heads), the RG-LRU's
    conv output gathered for its gates, and the new caches that the
    reference's rule keeps whole over "data" (the SSD state and conv, the
    LRU's) gathered from the data ranks' rows. An attention whose heads
    do not divide the model axis runs whole: its stored blocks gathered
    (every leaf of wq / wk / wv / wo the rule splits), no exit, and its
    T-split cache's partial softmax merged (a max of (b, Hq) and a sum of
    the unnormalised outputs and weights (b, Hq, hd + 1)); its cache is
    never gathered."""
    from repro_torch import sharding
    from repro_torch.models import ssm
    b, d, f32 = B // n_data, cfg.d_model, 4
    out = {("all-reduce", "model"): 2 * b * d * f32}   # the mixer's, the FFN's
    if cfg.family == "encdec":
        out[("all-reduce", "model")] += b * d * f32    # the cross-attention
    hd, hq, hk = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    if kind in ("attn", "local", "global") and sharding.attn_mode(
            hq, hk, hd, m) == "whole":
        fits = lambda n: n >= m and n % m == 0
        leaves = [d * hq * hd, d * hk * hd, d * hk * hd]   # wq, wk, wv
        if cfg.qkv_bias:
            leaves += [hq * hd, hk * hd, hk * hd]
        split = [n for n, w in zip(leaves, [hq * hd, hk * hd, hk * hd] * 2)
                 if fits(w)]
        split += [hq * hd * d] if fits(hq * hd) else []    # wo by rows
        out[("all-gather", "model")] = sum(split) * f32
        out[("all-reduce", "model")] = (b * d + b * hq + b * hq * (hd + 1)) \
            * f32
    if kind == "moe":
        E = cfg.moe.n_experts
        out[("all-reduce", "data")] = 2 * E * f32      # the aux's two means
        out[("all-gather", "data")] = n_data * E * 4   # int32 slot prefix
    elif kind == "ssm":
        d_inner, H, conv_dim = ssm.ssm_dims(d, cfg.ssm)
        w = cfg.ssm.d_conv - 1
        out[("all-reduce", "model")] = b * d * f32 + b * f32   # exit, norm
        out[("all-gather", "model")] = b * w * conv_dim * f32
        out[("all-gather", "data")] = B * (w * conv_dim // m + H // m
                                           * cfg.ssm.head_dim
                                           * cfg.ssm.d_state) * f32
    elif kind == "lru":
        W = cfg.hybrid.lru_width
        out[("all-gather", "model")] = b * W * f32
        out[("all-gather", "data")] = B * (3 + 1) * (W // m) * f32
    return out


@pytest.mark.parametrize("arch", list(SPLIT_DECODES))
def test_collective_bytes_of_a_decode_round_split_blocks(arch):
    """A decode round of the split MoE, SSD and RG-LRU stacks, of
    whisper-small and of a whole attention over a T-split cache (4 lanes,
    2 a data rank, cache 16) as rank 0 of the abstract 2 x 2 mesh: every
    layer's collectives by kind and axis as ``_layer_bytes`` gives them
    (the passive group's 3 parties as one tensor), the embedding's and the
    decision MLP's all-reduces and the logits' all-gathers as in the
    dense round; no weight moves but a whole attention's, nothing else
    moves (no K/V cache: the round's cross K/V and T-split caches stay
    each rank's)."""
    import collections
    from repro_torch.models import transformer
    B, T, m, n_data = 4, ranks.S, 2, 2
    cfg, sys_, rec, (logits, _), pspec = _recorded_step(
        "decode", B, T, SPLIT_DECODES[arch][1], SPLIT_DECODES[arch][0])
    assert tuple(logits.shape) == (B, 1, cfg.vocab_size)
    b, f32 = B // n_data, 4
    want = collections.Counter({
        ("all-reduce", "model"): sys_.C * b * cfg.d_model * f32
        + sys_.easter.decision_layers * b * sys_.easter.d_embed * f32,
        ("all-gather", "model"): b * cfg.vocab_size * f32,
        ("all-gather", "data"): B * cfg.vocab_size * f32})
    kinds = set()
    for pcfg, parties in ((sys_.party_cfgs[0], 1),
                          (sys_.party_cfgs[1], sys_.C - 1)):
        for pattern, reps in transformer.stack_plan(pcfg):
            for kind in pattern:
                kinds.add(kind)
                for k, n in _layer_bytes(pcfg, kind, B, m, n_data).items():
                    want[k] += reps * parties * n
    assert kinds & {"moe", "ssm", "lru"} or arch in ("whisper-small", "h3")
    got = collections.Counter()
    for kind, axes, shape in rec.calls:
        size = 4 * int(np.prod(shape))       # float32 or int32
        got[(kind, "+".join(axes))] += size
    assert got == want
    _no_weight_gathered(rec, sys_, pspec, ("attn",) if arch == "h3" else ())


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
