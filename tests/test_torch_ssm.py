"""The port's Mamba-2 SSD parties (``repro_torch.models.ssm``, the ``ssm``
family of ``models.transformer``, ``core.easter_lm``, ``core.decode``)
against the JAX reference (``repro.models.ssm`` and the modules above
it), on the CPU, at mamba2-2.7b's smoke variant (d_model 256, 16 heads of
32, d_state 32, chunk 32).

Where the prompt length L is not a multiple of the chunk, the reference
runs the chunked form at gcd(L, chunk) (1 for L = 33: 33 chunks of one
token) and the port at the full chunk over L padded with dt = 0
(``ssm.ssd_padded``, ROADMAP.md queue 3): the same values in exact
arithmetic. Tolerances, float32:

  * ``_segsum``: the -inf pattern exactly, the values within atol 2e-6
    (XLA's cumsum adds in another order: measured 9.5e-7 on sums of 16
    terms of about 1);
  * ``ssd_chunked``, ``ssd_decode_step`` and ``ssm_block``: rtol 1e-5 /
    atol 1e-5 (matmuls and einsums summed in another order, the padded
    route at L = 33 against 33 one-token chunks included: measured
    2.4e-6 at worst on the block's outputs and conv cache);
  * the transformer and EasterLM: rtol 1e-4 / atol 1e-5, as the other
    families' tests;
  * a frozen lane's cache bit for bit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core.easter_lm import EasterLM as JLM
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import checkpoint
from repro_torch.configs import base as tcfg
from repro_torch.core import api as tapi
from repro_torch.core import train_loop
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

ARCH = "mamba2-2.7b"
RTOL, ATOL = 1e-4, 1e-5              # the LM level, float32
SSD_RTOL, SSD_ATOL = 1e-5, 1e-5      # the SSD pieces and the block


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


def _cfgs():
    return (jcfg.smoke_variant(jcfg.get_config(ARCH)),
            tcfg.smoke_variant(tcfg.get_config(ARCH)))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


# the reference's functions jitted (one compile per shape beats eager
# dispatch of every op)
_j_ssd = jax.jit(JS.ssd_chunked, static_argnums=5)
_j_block = jax.jit(JS.ssm_block, static_argnums=(2, 4))


# ---------------------------------------------------------------------------
# the SSD pieces
# ---------------------------------------------------------------------------


def test_segsum_matches():
    x = np.random.default_rng(0).normal(size=(2, 3, 16)).astype(np.float32)
    got = TS._segsum(torch.from_numpy(x)).numpy()
    want = np.asarray(JS._segsum(jnp.asarray(x)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(want[..., 0, 1]).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _ssd_inputs(L, seed, b=2, h=4, p=8, g=1, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, L, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, L, h)) - 2)).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    B = rng.normal(size=(b, L, g, n)).astype(np.float32)
    C = rng.normal(size=(b, L, g, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, A, B, C, s0


@pytest.mark.parametrize("init", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("L,chunk", [(64, 32), (64, 16), (33, 1)])
def test_ssd_chunked_matches(L, chunk, init):
    x, dt, A, B, C, s0 = _ssd_inputs(L, L + chunk)
    jy, js = _j_ssd(*map(jnp.asarray, (x, dt, A, B, C)), chunk,
                    jnp.asarray(s0) if init else None)
    ty, ts = TS.ssd_chunked(*_t(x, dt, A, B, C), chunk,
                            torch.from_numpy(s0) if init else None)
    _close(ty, jy, SSD_RTOL, SSD_ATOL)
    _close(ts, js, SSD_RTOL, SSD_ATOL)


@pytest.mark.parametrize("L", [33, 47])
def test_padded_route_equals_the_references_chunking(L):
    """L not a multiple of 32: the reference's gcd chunk (1) against the
    port's chunk of 32 over L padded with dt = 0."""
    x, dt, A, B, C, s0 = _ssd_inputs(L, L)
    jy, js = _j_ssd(*map(jnp.asarray, (x, dt, A, B, C)), int(np.gcd(L, 32)),
                    jnp.asarray(s0))
    ty, ts = TS.ssd_padded(*_t(x, dt, A, B, C), 32, torch.from_numpy(s0))
    assert tuple(ty.shape) == x.shape
    _close(ty, jy, SSD_RTOL, SSD_ATOL)
    _close(ts, js, SSD_RTOL, SSD_ATOL)


def test_ssd_decode_step_matches():
    x, dt, A, B, C, s0 = _ssd_inputs(1, 5)
    jy, js = JS.ssd_decode_step(jnp.asarray(s0), *map(
        jnp.asarray, (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0])))
    ty, ts = TS.ssd_decode_step(torch.from_numpy(s0), *_t(
        x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0]))
    _close(ty, jy, SSD_RTOL, SSD_ATOL)
    _close(ts, js, SSD_RTOL, SSD_ATOL)


@functools.lru_cache(maxsize=None)
def _block_params():
    jc, _ = _cfgs()
    jp = JS.init_ssm(jax.random.PRNGKey(3), jc.d_model, jc.ssm, jnp.float32)
    # non-trivial A, D, dt_bias and conv bias
    rng = np.random.default_rng(8)
    H = jp["A_log"].shape[0]
    jp = {**jp, "A_log": jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32),
          "D": jnp.asarray(rng.normal(size=H), jnp.float32),
          "dt_bias": jnp.asarray(rng.normal(size=H) - 2, jnp.float32),
          "conv_b": jnp.asarray(rng.normal(size=jp["conv_b"].shape) * 0.1,
                                jnp.float32)}
    return jp, _tree(jp)


@pytest.mark.parametrize("case", ["64", "33", "33_cache", "decode_step"])
def test_ssm_block_matches(case):
    """L = 64 (two chunks of 32), L = 33 (the reference's chunk 1, the
    port's padded chunk of 32) from zeros and from a cache (a
    continuation with a non-zero conv history and state), and one decode
    step."""
    jc, tc = _cfgs()
    jp, tp = _block_params()
    L = {"64": 64, "33": 33, "33_cache": 33, "decode_step": 1}[case]
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, jc.d_model)).astype(np.float32)
    jc0 = tc0 = None
    if case in ("33_cache", "decode_step"):
        c = JS.init_ssm_cache(2, jc.d_model, jc.ssm, jnp.float32)
        conv = rng.normal(size=c["conv"].shape).astype(np.float32)
        state = rng.normal(size=c["state"].shape).astype(np.float32)
        jc0 = {"conv": jnp.asarray(conv), "state": jnp.asarray(state)}
        tc0 = {"conv": torch.from_numpy(conv), "state": torch.from_numpy(state)}
    jo, jn = _j_block(jp, jnp.asarray(x), jc.ssm, jc0, jc.rms_eps)
    with torch.no_grad():
        to, tn = TS.ssm_block(tp, torch.from_numpy(x), tc.ssm, tc0, tc.rms_eps)
    _close(to, jo, SSD_RTOL, SSD_ATOL)
    _close(tn["conv"], jn["conv"], SSD_RTOL, SSD_ATOL)
    _close(tn["state"], jn["state"], SSD_RTOL, SSD_ATOL)
    assert tn["state"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the SSM stack
# ---------------------------------------------------------------------------

PREFILL, STEPS, MAX_LEN = 33, 3, 40


def test_transformer_prefill_and_decode_match():
    """The full forward, then a 33-token prefill (the reference's chunk 1)
    into per-lane caches and 3 recurrent decode steps, hidden states and
    caches against the reference's after each; the SSM cache carries the
    lane axis at position 1, as the serving splice and freeze assume."""
    jc, tc = _cfgs()
    assert TT.stack_plan(tc) == [(("ssm",), 2)]
    # attention-free at full size: head dim 0 passes through the rope
    full = tcfg.get_config(ARCH)
    assert full.resolved_head_dim == 0
    cos, _ = TT._cos_sin(full, torch.arange(5)[None])
    assert tuple(cos.shape) == (1, 5, 0)
    jp = jax.jit(lambda k: JT.init_lm(k, jc))(jax.random.PRNGKey(1))
    tp = _tree(jp)
    assert [tuple(t.shape) for t in tree_leaves(TT.init_lm(
        torch.Generator().manual_seed(0), tc))] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    tok = np.random.default_rng(5).integers(0, jc.vocab_size,
                                            (2, PREFILL + STEPS))
    tok = tok.astype(np.int32)
    japply = jax.jit(lambda p, t, c=None, pos=0: JT.apply_lm(
        p, t, jc, caches=c, pos_offset=pos, return_hidden=c is not None))
    jl, _, _ = japply(jp, jnp.asarray(tok))
    with torch.no_grad():
        tl, _, _ = TT.apply_lm(tp, torch.from_numpy(tok), tc)
    _close(tl, jl, atol=ATOL * float(np.abs(np.asarray(jl)).max()))
    jcache = JT.init_cache(jc, 2, MAX_LEN, per_lane=True)
    tcache = TT.init_cache(tc, 2, MAX_LEN, per_lane=True)
    c = tcache[0]["p0"]
    assert tuple(c["conv"].shape[:2]) == tuple(c["state"].shape[:2]) == (2, 2)
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


def test_frozen_lane_keeps_its_state_bit_for_bit():
    """Two lanes admitted, one finishes after one round: in the next
    chunk its SSM conv history and float32 state (every party's) keep
    their bits while the live lane's move on."""
    _, tc = _cfgs()
    ts = TLM(tc, tcfg.EasterConfig(), device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(0))
    dcfg = tapi.DecodeConfig(lanes=2, max_len=24, chunk=3)
    pf, df = tapi.build_decoder(ts, dcfg)
    state = tapi.init_decode_state(ts, dcfg)
    rng = np.random.default_rng(2)
    for lane, budget in ((0, 1), (1, 8)):
        req = tapi.ServeRequest(tokens=tuple(rng.integers(0, 512, 9)
                                             .tolist()),
                                max_new_tokens=budget)
        state = pf(params, state, req, lane, nonce=lane + 1)
    _, state, steps = df(params, state)
    assert steps == 3 and state.done.tolist() == [True, False]
    before = [t.clone() for t in tree_leaves(state.caches)]
    _, after, _ = df(params, state)
    ssm_leaves = 0
    for b, a in zip(before, tree_leaves(after.caches)):
        assert torch.equal(a[:, 0], b[:, 0])      # the frozen lane
        if a.dtype == torch.float32 and a.dim() == 5:
            ssm_leaves += 1
            assert not torch.equal(a[:, 1], b[:, 1])
    assert ssm_leaves == 4                        # one state per party


# ---------------------------------------------------------------------------
# EasterLM training
# ---------------------------------------------------------------------------

B, S, STEP = 2, 8, 3


@functools.lru_cache(maxsize=None)
def _port_tree():
    ts = TLM(_cfgs()[1], tcfg.EasterConfig(), engine="loop", device="cpu")
    return ts.export_params(ts.init_params(torch.Generator().manual_seed(0)))


@functools.lru_cache(maxsize=None)
def _ref_grads():
    js = JLM(_cfgs()[0], jcfg.EasterConfig())
    batch = next(lm_batch_iterator(512, B, S, seed=0))
    seeds = js.mask_seeds()
    fn = jax.jit(lambda p, b, s: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, b, s, seeds))
    (total, per), g = fn(jax.tree.map(jnp.asarray, _port_tree()), batch,
                         jnp.int32(STEP))
    return np.asarray(total), np.asarray(per), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_loss_and_grads_match_reference(engine):
    j_total, j_per, j_g = _ref_grads()
    ts = TLM(_cfgs()[1], tcfg.EasterConfig(), engine=engine, device="cpu")
    assert [c.n_layers for c in ts.party_cfgs] == [2, 2, 2, 2]
    params = ts.load_params(_port_tree())
    batch = next(lm_batch_iterator(512, B, S, seed=0))
    total, per, g = train_loop.loss_and_grads(ts, params, batch, STEP,
                                              ts.mask_seeds())
    _close(per, j_per)
    _close(total, j_total)
    _trees_close(g, j_g)
    a_log = g["parties"][0]["backbone"]["segments"][0]["p0"]["ssm"]["A_log"]
    assert bool(a_log.abs().sum() > 0)
