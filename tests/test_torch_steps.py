"""The port's item-E modules against the JAX reference: ``INPUT_SHAPES``
and ``active_param_count`` (configs/base.py), ``launch/steps.py`` (the
abstract inputs on the meta device and the step builders),
``launch/dryrun.py`` and ``data/pipeline.Prefetcher``.

Weights are the port's ``init_params`` from a seeded torch generator,
handed to the reference as numpy arrays. One prefill and one decode round
through the builders at the qwen2.5-3b smoke variant (float32) are held
against the reference's builders, and the train step's losses against
the reference's ``loss_fn``, at the tolerances of
tests/test_torch_lm_train.py: rtol 1e-4 / atol 1e-5 (the frameworks sum
in other orders); the train step's update equals the port's
``train_loop`` step bit for bit. The dry run builds every (arch, input
shape) at full size on the meta device; the step itself, which takes
seconds to minutes a combination on meta, runs for one decode shape here
and for every combination in ``python -m repro_torch.launch.dryrun``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.launch import steps as jsteps
from repro_torch.configs import base as tcfg
from repro_torch.core import train_loop
from repro_torch.data import Prefetcher, batch_iterator
from repro_torch.launch import dryrun, steps
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves

SMOKE_ARCHS = ("qwen2.5-3b", "whisper-small", "qwen2-vl-7b")
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _archs():
    return [a for a in tcfg.list_archs() if not a.startswith("easter")]


def test_input_shapes_equal_reference():
    assert list(tcfg.INPUT_SHAPES) == list(jcfg.INPUT_SHAPES)
    for name, s in jcfg.INPUT_SHAPES.items():
        assert dataclasses.asdict(tcfg.INPUT_SHAPES[name]) == \
            dataclasses.asdict(s)


def test_default_easter_equals_reference():
    for arch in _archs():
        assert dataclasses.asdict(steps.default_easter(
            tcfg.get_config(arch))) == dataclasses.asdict(
            jsteps.default_easter(jcfg.get_config(arch)))


def _sds(tree):
    """(shape, dtype name) of every leaf: jax ShapeDtypeStructs or torch
    tensors, in the trees' common leaf order."""
    if isinstance(tree, torch.Tensor):
        return [(tuple(tree.shape), str(tree.dtype).replace("torch.", ""))]
    if hasattr(tree, "shape") and hasattr(tree, "dtype"):
        return [(tuple(tree.shape), str(tree.dtype))]
    return [x for leaf in tree_leaves(tree) for x in _sds(leaf)]


def _systems(arch, shape_name, seq=16, batch=2):
    """(port system on meta, reference system, shape) at the smoke
    variant, a small input shape of ``shape_name``'s kind."""
    kind = jcfg.INPUT_SHAPES[shape_name].kind
    shape_t = tcfg.InputShape(shape_name, seq, batch, kind)
    shape_j = jcfg.InputShape(shape_name, seq, batch, kind)
    ct = tcfg.smoke_variant(tcfg.get_config(arch))
    cj = jcfg.smoke_variant(jcfg.get_config(arch))
    st = steps.make_system(ct, steps.default_easter(ct), device="meta")
    sj = jsteps.make_system(cj, jsteps.default_easter(cj))
    return ct, cj, st, sj, shape_t, shape_j


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_input_specs_match_reference(arch, shape_name):
    ct, cj, st, sj, shape_t, shape_j = _systems(arch, shape_name)
    got = steps.input_specs(ct, shape_t, st)
    want = jsteps.input_specs(cj, shape_j, sj)
    assert sorted(got) == sorted(k for k in want if k != "pos") + (
        ["pos"] if "pos" in want else [])
    for key in want:
        if key == "pos":        # an int: the port's PRF rounds are host-side
            assert got["pos"] == shape_t.seq_len - 1
            continue
        assert _sds(got[key]) == _sds(want[key]), key
        assert all(t.device.type == "meta" for t in tree_leaves(got[key]))
    # the abstract state: adam's m and v in float32, shaped as the params
    params, state = steps.abstract_state(st, "adam")
    p_shapes = _sds({"parties": params["parties"]})
    assert _sds(state["m"]) == [(s, "float32") for s, _ in p_shapes]
    assert _sds(state["v"]) == _sds(state["m"])


def _real(arch):
    """A port system on the CPU with its drawn weights, and the reference
    system with the same weights."""
    ct = tcfg.smoke_variant(tcfg.get_config(arch))
    cj = jcfg.smoke_variant(jcfg.get_config(arch))
    st = steps.make_system(ct, steps.default_easter(ct), device="cpu")
    sj = jsteps.make_system(cj, jsteps.default_easter(cj))
    params = st.init_params(torch.Generator().manual_seed(0))
    # copies: the port's steps update its tensors in place, which numpy
    # views (and arrays made from them without a copy) would follow
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)),
                      st.export_params(params))
    return st, sj, params, jp


def _close(got, want):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(a.detach(), np.float32)
                                   if isinstance(a, torch.Tensor)
                                   else np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=RTOL, atol=ATOL)


def test_step_builders_match_reference():
    """One sgd train step, one prefill and one decode round through the
    builders, qwen2.5-3b smoke variant, float32."""
    st, sj, params, jp = _real("qwen2.5-3b")
    B, S = 2, 8
    rng = np.random.default_rng(0)
    V = st.cfg.vocab_size
    toks = rng.integers(0, V, (B, S)).astype(np.int32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    shape = tcfg.InputShape("prefill", S, B, "prefill")

    # prefill (nonce 5), then a decode round of the last prompt token at
    # its position, on the prefill's caches (it rewrites that slot)
    E, caches = steps.build_prefill_step(st, shape)(
        params, {"tokens": torch.from_numpy(toks)}, 5)
    jE, jcaches = jax.jit(jsteps.build_prefill_step(sj, shape))(
        jp, {"tokens": jnp.asarray(toks)}, jnp.int32(5))
    _close(E, jE)
    dec = tcfg.InputShape("decode", S, B, "decode")
    last = toks[:, -1:]
    logits, _ = steps.build_serve_step(st, dec)(
        params, {"tokens": torch.from_numpy(last)}, caches, S - 1)
    jlogits, _ = jax.jit(jsteps.build_serve_step(sj, dec))(
        jp, {"tokens": jnp.asarray(last)}, jcaches, jnp.int32(S - 1))
    _close(logits, jlogits)

    # one sgd step: its losses against the reference's jitted loss_fn (its
    # train step compiles for ~8 s), its update bit for bit the port's
    # train_loop step, which tests/test_torch_lm_train.py holds against
    # the reference's
    step, opt = steps.build_train_step(st, "sgd", lr=0.1)
    batch = {"tokens": toks, "labels": labels}
    seeds = sj.mask_seeds()
    jtotal, jper = jax.jit(lambda p, b: sj.loss_fn(p, b, 0, seeds))(
        jp, jax.tree.map(jnp.asarray, batch))
    again = st.load_params(st.export_params(params))
    params, _, m = step(params, opt.init({"parties": params["parties"]}),
                        batch, 0)
    _close([m["loss"], m["per_party"]], [jtotal, jper])
    same = train_loop.make_train_step(st, make_optimizer("sgd", 0.1,
                                                         grad_clip=1.0))
    again, _, m2 = same(again, {}, batch, 0)
    assert torch.equal(m["per_party"], m2["per_party"])
    for a, b in zip(tree_leaves(params["parties"]),
                    tree_leaves(again["parties"])):
        assert torch.equal(a, b)


def test_dryrun_counts_every_arch_and_shape(tmp_path):
    """Every (arch, shape) but SKIPS on the meta device: the reference's
    parameter counts, the bytes of the parameter tree and the optimizer
    state, and (decode) the reference's cache bytes for qwen2.5-3b and
    recurrentgemma-9b at decode_32k."""
    for arch in _archs():
        jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        for name in tcfg.INPUT_SHAPES:
            r = dryrun.run_one(arch, name, save_dir=str(tmp_path),
                               step=False)
            if (arch, name) in dryrun.SKIPS:
                assert "skipped" in r
                continue
            assert r["params_active_party"] == jc.param_count()
            assert r["params_active_party_active"] == jc.active_param_count()
            assert r["weight_bytes"] > 0
            assert (r["opt_state_bytes"] > 0) == (name == "train_4k")
    for arch in ("qwen2.5-3b", "recurrentgemma-9b"):
        cj = jcfg.get_config(arch)
        sj = jsteps.make_system(cj)
        shape = jcfg.INPUT_SHAPES["decode_32k"]
        want = jax.eval_shape(lambda: sj.init_caches(
            shape.global_batch, shape.seq_len, -1))
        want_bytes = sum(int(np.prod(x.shape)) * x.dtype.itemsize
                         for x in jax.tree.leaves(want))
        r = dryrun.run_one(arch, "decode_32k", save_dir=str(tmp_path),
                           step=False)
        assert r["cache_bytes"] == want_bytes


def test_dryrun_runs_a_decode_step(tmp_path):
    r = dryrun.run_one("qwen2.5-3b", "decode_32k", save_dir=str(tmp_path))
    assert r["outputs"] == {"logits": [[128, 1, 151936], "bfloat16"]}
    assert r["flops"] > 0
    assert (tmp_path / "qwen2.5-3b_decode_32k.json").exists()


def test_prefetcher():
    x = np.arange(100, dtype=np.float32)[:, None]
    y = np.arange(100, dtype=np.int32)
    it = Prefetcher(iter([next(batch_iterator(x, y, 32)) for _ in range(5)]))
    batches = list(it)
    assert len(batches) == 5
    assert batches[0][0].shape == (32, 1)
