"""The port's MoE parties (``repro_torch.models.moe``, the ``moe`` family
of ``models.transformer``, ``core.easter_lm``, ``core.serving``) against
the JAX reference (``repro.models.moe`` and the modules above it), on the
CPU, at the smoke variants of qwen2-moe-a2.7b (4 experts top-2, one
shared expert) and qwen3-moe-235b-a22b (no shared expert).

Weights cross as numpy arrays (``checkpoint.params_from_numpy`` /
``EasterLM.load_params``); inputs come from numpy seeds. Tolerances:

  * the layer in float32: outputs rtol 1e-5 / atol 1e-6 x max|out| (the
    same products, summed in another order by the two frameworks'
    matmuls, over outputs of a few hundred where the experts' fan-in
    scale is 1/sqrt(E): measured 2.7e-4 at worst, 4e-7 of max|out|), the
    aux loss rtol 1e-6 and the renormalised gates rtol 1e-5 (two
    softmaxes: measured 1.1e-6); ``expert_idx`` exactly;
  * the grouped (vmap) call against K single calls: the routing and the
    aux loss bit for bit, the outputs within 1e-6 x max|out| (measured
    4.3e-8 of it: the batched matmul blocks its sums otherwise);
  * the transformer and EasterLM: rtol 1e-4 / atol 1e-5 in float32, as
    the dense family's tests; integers bit for bit; served tokens equal.

Batched MoE serving couples the lanes through the capacity (the tokens of
one round share the experts' slots), as in the reference: the engine test
holds the port against a reference run with the same lane occupancy.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs import base as jcfg
from repro.core import api as japi
from repro.core import serving as jserving
from repro.core.easter_lm import EasterLM as JLM
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch import checkpoint
from repro_torch.configs import base as tcfg
from repro_torch.core import api as tapi
from repro_torch.core import serving as tserving
from repro_torch.core import train_loop
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

ARCHS = ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b")
RTOL, ATOL = 1e-4, 1e-5              # the LM level, float32
LAYER_RTOL, LAYER_ATOL = 1e-5, 1e-6  # the layer, float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: one thread beats a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _trees_close(got, want, rtol=RTOL, atol=ATOL):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, rtol, atol)


def _tree(x):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, x), "cpu",
                                        False)


def _cfgs(arch):
    return (jcfg.smoke_variant(jcfg.get_config(arch)),
            tcfg.smoke_variant(tcfg.get_config(arch)))


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _layer(arch, seed=2):
    jc, tc = _cfgs(arch)
    jp = JM.init_moe(jax.random.PRNGKey(seed), jc.d_model, jc.moe, jc.act,
                     jnp.float32)
    return jc, tc, jp, _tree(jp)


@pytest.mark.parametrize("cf", [0.0, 0.25], ids=["default_cap", "drops"])
@pytest.mark.parametrize("arch", ARCHS, ids=["shared", "no_shared"])
def test_moe_ffn_matches_reference(arch, cf):
    """32 tokens, 4 experts, top-2: the default capacity (20 slots) and
    capacity factor 0.25 (the floor of 4 slots, under the 16 a balanced
    expert gets), which drops tokens."""
    jc, tc, jp, tp = _layer(arch)
    assert ("shared" in tp) == (arch == ARCHS[0])
    x = np.random.default_rng(3).normal(size=(2, 16, jc.d_model))
    x = x.astype(np.float32)
    jo, jaux = JM.moe_ffn(jp, jnp.asarray(x), jc.moe, jc.act, cf)
    with torch.no_grad():
        to, taux = TM.moe_ffn(tp, torch.from_numpy(x), tc.moe, tc.act, cf)
        _, gates, idx = TM.route(tp, torch.from_numpy(x).reshape(32, -1),
                                 tc.moe)
    # the reference's routing, recomputed: top-k of the float32 softmax
    probs = jax.nn.softmax(jnp.asarray(x).reshape(32, -1) @ jp["router"], -1)
    jgates, jidx = jax.lax.top_k(probs, jc.moe.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    _close(gates, jgates / jgates.sum(-1, keepdims=True), 1e-5, 0)
    # capacity: the first `cap` assignments of each expert in (t, k)
    # order are kept
    cap = TM.capacity(32, tc.moe, cf)
    seen = np.zeros(jc.moe.n_experts, int)
    for t, k in itertools.product(range(32), range(jc.moe.top_k)):
        seen[int(jidx[t, k])] += 1
    if cf:
        assert cap == 4 and (seen > cap).sum() >= 3
    _close(to, jo, LAYER_RTOL, LAYER_ATOL * float(jnp.abs(jo).max()))
    _close(taux, jaux, 1e-6, 0)


def test_grouped_call_equals_single_calls():
    """K = 3 stacked expert sets under torch.func.vmap (the passive MoE
    proxies), capacity low enough to drop, against the three single
    calls."""
    jc, tc = _cfgs(ARCHS[0])
    ps = [_layer(ARCHS[0], seed)[3] for seed in (4, 5, 6)]
    stacked = jax.tree.map(lambda *a: torch.stack(a), *ps,
                           is_leaf=lambda a: isinstance(a, torch.Tensor))
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(3, 2, 16, jc.d_model)).astype(np.float32))
    run = lambda p, x: TM.moe_ffn(p, x, tc.moe, tc.act, 0.25)
    route = lambda p, x: TM.route(p, x.reshape(-1, jc.d_model), tc.moe)
    with torch.no_grad():
        grouped, g_routes = vmap(run)(stacked, x), vmap(route)(stacked, x)
        for k in range(3):
            out, aux = run(ps[k], x[k])
            assert torch.equal(grouped[1][k], aux)
            for g, r in zip(g_routes, route(ps[k], x[k])):
                assert torch.equal(g[k], r)
            _close(grouped[0][k], out, 0, 1e-6 * float(out.abs().max()))


# ---------------------------------------------------------------------------
# the MoE transformer
# ---------------------------------------------------------------------------

PREFILL, STEPS, MAX_LEN = 12, 3, 16


@pytest.mark.parametrize("arch", ARCHS)
def test_transformer_prefill_and_decode_match(arch):
    """The full forward (logits and the summed aux loss), then a 12-token
    prefill into per-lane caches and 3 decode steps, hidden states and
    caches against the reference's after each."""
    jc, tc = _cfgs(arch)
    jp = jax.jit(lambda k: JT.init_lm(k, jc))(jax.random.PRNGKey(1))
    tp = _tree(jp)
    assert TT.stack_plan(tc) == JT.stack_plan(jc) == [(("moe",), 2)]
    assert [tuple(t.shape) for t in tree_leaves(TT.init_lm(
        torch.Generator().manual_seed(0), tc))] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    tok = np.random.default_rng(5).integers(0, jc.vocab_size,
                                            (2, PREFILL + STEPS))
    tok = tok.astype(np.int32)
    japply = jax.jit(lambda p, t, c=None, pos=0: JT.apply_lm(
        p, t, jc, caches=c, pos_offset=pos, return_hidden=c is not None))
    jl, _, jaux = japply(jp, jnp.asarray(tok))
    with torch.no_grad():
        tl, _, taux = TT.apply_lm(tp, torch.from_numpy(tok), tc)
    _close(tl, jl, atol=ATOL * float(np.abs(np.asarray(jl)).max()))
    _close(taux, jaux)
    assert float(taux) > 0
    jcache = JT.init_cache(jc, 2, MAX_LEN, per_lane=True)
    tcache = TT.init_cache(tc, 2, MAX_LEN, per_lane=True)
    jh, jcache, _ = japply(jp, jnp.asarray(tok[:, :PREFILL]), jcache)
    with torch.no_grad():
        th, tcache, _ = TT.apply_lm(tp, torch.from_numpy(tok[:, :PREFILL]),
                                    tc, caches=tcache, return_hidden=True)
    _close(th, jh)
    _trees_close(tcache, jcache)
    for s in range(STEPS):
        p = PREFILL + s
        pos = np.full((2, 1), p, np.int32)
        jh, jcache, _ = japply(jp, jnp.asarray(tok[:, p:p + 1]), jcache,
                               jnp.asarray(pos))
        with torch.no_grad():
            th, tcache, _ = TT.apply_lm(
                tp, torch.from_numpy(tok[:, p:p + 1]), tc, caches=tcache,
                pos_offset=torch.from_numpy(pos), return_hidden=True)
        _close(th, jh)
        _trees_close(tcache, jcache)


# ---------------------------------------------------------------------------
# EasterLM: the serving engine and the loss
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(9)
REQUESTS = [dict(tokens=tuple(_RNG.integers(0, 512, n).tolist()),
                 max_new_tokens=m)
            for n, m in ((14, 5), (6, 4), (14, 3), (6, 5))]
ENGINE_MAX_LEN = 20


@functools.lru_cache(maxsize=None)
def _port_tree(arch, dense_passive=False):
    """The port's weights (drawn once, reference layout, numpy)."""
    tc = _cfgs(arch)[1]
    ts = TLM(tc, tcfg.EasterConfig(moe_dense_passive=dense_passive),
             engine="loop", device="cpu")
    return ts.export_params(ts.init_params(torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def ref_engine():
    """Four greedy requests through two lanes of the reference's engine
    (lanes re-admitted; each decode round routes both lanes' tokens
    through the experts together)."""
    js = JLM(_cfgs(ARCHS[0])[0], jcfg.EasterConfig())
    eng = jserving.ServingEngine(js, jax.tree.map(jnp.asarray,
                                                  _port_tree(ARCHS[0])),
                                 lanes=2, max_len=ENGINE_MAX_LEN, chunk=3,
                                 base_key=1)
    comps = eng.run([japi.ServeRequest(**r) for r in REQUESTS])
    return comps, eng.rounds_run, eng.chunks_run


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_serving_engine_matches_reference(ref_engine, engine):
    jcomps, jrounds, jchunks = ref_engine
    ts = TLM(_cfgs(ARCHS[0])[1], tcfg.EasterConfig(), engine=engine,
             device="cpu")
    params = ts.load_params(_port_tree(ARCHS[0]))
    if engine == "vectorized":
        w = ts._passive_stack(params)["backbone"]["segments"][0]["p0"][
            "moe"]["w_gate"]
        assert tuple(w.shape[:3]) == (3, 2, 4)   # (K, reps, E, ...)
    eng = tserving.ServingEngine(ts, params, lanes=2, max_len=ENGINE_MAX_LEN,
                                 chunk=3, base_key=1)
    comps = eng.run([tapi.ServeRequest(**r) for r in REQUESTS])
    key = lambda c: c.nonce
    assert [(c.nonce, c.lane, c.tokens) for c in sorted(comps, key=key)] == \
        [(c.nonce, c.lane, c.tokens) for c in sorted(jcomps, key=key)]
    assert (eng.rounds_run, eng.chunks_run) == (jrounds, jchunks)


B, S, STEP = 2, 8, 3


@functools.lru_cache(maxsize=None)
def _ref_grads(arch, dense_passive=False):
    """The reference's jitted value_and_grad of loss_fn at round STEP."""
    js = JLM(_cfgs(arch)[0], jcfg.EasterConfig(
        moe_dense_passive=dense_passive))
    batch = next(lm_batch_iterator(512, B, S, seed=0))
    seeds = js.mask_seeds()
    fn = jax.jit(lambda p, b, s: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, b, s, seeds))
    (total, per), g = fn(jax.tree.map(jnp.asarray,
                                      _port_tree(arch, dense_passive)),
                         batch, jnp.int32(STEP))
    return np.asarray(total), np.asarray(per), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("arch,dense_passive", [
    (ARCHS[0], False), (ARCHS[1], False), (ARCHS[0], True)],
    ids=["qwen2-moe", "qwen3-moe", "dense_passive"])
def test_loss_and_grads_match_reference(arch, dense_passive, engine):
    """loss_fn and its gradients; the total includes every MoE party's
    load-balance loss (with ``moe_dense_passive`` only the active
    party's: its proxies are dense)."""
    j_total, j_per, j_g = _ref_grads(arch, dense_passive)
    ts = TLM(_cfgs(arch)[1], tcfg.EasterConfig(
        moe_dense_passive=dense_passive), engine=engine, device="cpu")
    assert [c.family for c in ts.party_cfgs] == \
        ["moe"] + 3 * ["dense" if dense_passive else "moe"]
    params = ts.load_params(_port_tree(arch, dense_passive))
    batch = next(lm_batch_iterator(512, B, S, seed=0))
    total, per, g = train_loop.loss_and_grads(ts, params, batch, STEP,
                                              ts.mask_seeds())
    _close(per, j_per)
    _close(total, j_total)
    # the aux losses are in the total: it exceeds the sum of the parties'
    assert float(total - per.sum()) > 0
    _trees_close(g, j_g)
    router = g["parties"][0]["backbone"]["segments"][0]["p0"]["moe"][
        "router"]
    assert bool(router.abs().sum() > 0)
