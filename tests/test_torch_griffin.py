"""The port's Griffin (recurrentgemma) parties against the JAX reference
(``repro.models.griffin``, ``repro.models.ssm._depthwise_conv``,
``repro.kernels.ref.reference_rglru`` and the Pallas ``rg_lru`` kernel in
interpret mode, ``repro.models.transformer`` on the hybrid family,
``repro.core.easter_lm``, ``repro.core.serving``), on the CPU.

Inputs come from numpy seeds; weights cross as numpy arrays
(``checkpoint.params_from_numpy`` / ``EasterLM.load_params``). On the CPU
the port's RG-LRU recurrence is the sequential plain version; the
reference model's default path is an associative scan, which rounds
differently. Tolerances, each beside its comparison below:

  * the plain recurrence (a multiply, then an add, each rounded, as the
    card's kernel computes it) against the reference's sequential oracle,
    which XLA contracts to one FMA on the CPU: rtol 1e-6 / atol 1e-6
    (measured: 1.2e-7, one ulp), and for the 512-step decay case rtol
    1e-5 / atol 1e-5; against the Pallas kernel in interpret mode: atol
    1e-5 and, for the decay case, rtol 1e-5, as the reference's own
    sweep;
  * the depthwise conv: bit for bit in float32 and bfloat16 (the same
    products summed in the same order; measured);
  * the recurrent block, float32: rtol 1e-5 / atol 1e-5 (measured: 3e-7
    relative on the state, the associative scan against the sequential
    form); bfloat16 outputs within atol 1e-2 / rtol 2e-2, two bfloat16
    ulps of the outputs' scale (measured: one ulp, 7.8e-3 at |out| ~1.8;
    the conv cache bit for bit, the float32 state within 1e-5);
  * the transformer and EasterLM: rtol 1e-4 / atol 1e-5 in float32, as
    the dense family's tests; integers bit for bit; served tokens equal.

The reference's EasterLM steps run jitted, once per wire, through
module-scoped fixtures, and both port engines are held against them.
int8 is held against a reference run with the same lane occupancy
(ROADMAP.md queue 3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import base as jcfg
from repro.core import api as japi
from repro.core import serving as jserving
from repro.core.easter_lm import EasterLM as JLM
from repro.kernels import ref as jref
from repro.kernels import rg_lru as jrg
from repro.models import griffin as JG
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import checkpoint
from repro_torch.configs import base as tcfg
from repro_torch.core import api as tapi
from repro_torch.core import serving as tserving
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as trg
from repro_torch.launch import serve as tlaunch
from repro_torch.models import build as tbuild
from repro_torch.models import griffin as TG
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: they finish sooner on one thread than
    on a thread pool contended by the other test workers on the same
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCH = "recurrentgemma-9b"
RTOL, ATOL = 1e-4, 1e-5              # the LM level, float32
BLOCK_RTOL, BLOCK_ATOL = 1e-5, 1e-5  # the recurrent block, float32
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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
        assert tuple(a.shape) == tuple(b.shape)
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b, rtol, atol)


def _tree(x):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, x), "cpu",
                                        False)


def _cfgs(n_layers=None):
    j = jcfg.smoke_variant(jcfg.get_config(ARCH))
    t = tcfg.smoke_variant(tcfg.get_config(ARCH))
    if n_layers is not None:
        j = dataclasses.replace(j, n_layers=n_layers)
        t = dataclasses.replace(t, n_layers=n_layers)
    return j, t


@functools.lru_cache(maxsize=None)
def _ref_params():
    """The reference EasterLM's init_params(PRNGKey(0)) at the smoke
    variant, drawn once (jitted); the wire does not enter the weights."""
    js = JLM(_cfgs()[0], jcfg.EasterConfig())
    return jax.jit(js.init_params)(jax.random.PRNGKey(0))


# ---------------------------------------------------------------------------
# the config copy
# ---------------------------------------------------------------------------


def test_config_copy_matches_reference():
    j, t = jcfg.get_config(ARCH), tcfg.get_config(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    js, ts = _cfgs()
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.param_count() == js.param_count()
    assert ARCH in tcfg.list_archs()
    # 12 repeats of (lru, lru, attn) and the (lru, lru) remainder; the
    # passive proxies aligned to the pattern (9 layers each)
    assert TT.stack_plan(t) == JT.stack_plan(j) == [
        (("lru", "lru", "attn"), 12), (("lru", "lru"), 1)]
    tl = TLM(t, tcfg.EasterConfig(), device="cpu")
    assert [c.n_layers for c in tl.party_cfgs] == \
        [c.n_layers for c in JLM(j, jcfg.EasterConfig()).party_cfgs] == \
        [38, 9, 9, 9]
    assert tbuild.build(t).cfg is t


# ---------------------------------------------------------------------------
# the recurrence's plain version
# ---------------------------------------------------------------------------


def _rglru_inputs(B, L, W, seed):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, L, W))))).astype(np.float32)
    b = (rng.normal(size=(B, L, W)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, W)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,W,chunk", [
    (2, 64, 128, 16), (1, 128, 256, 64), (4, 32, 64, 32), (3, 96, 128, 32)])
def test_reference_rglru_matches_jax_and_interpret_kernel(B, L, W, chunk,
                                                          dtype):
    """The reference sweep (tests/test_kernels.py), float32 and bfloat16
    a and b (the recurrence runs in float32 either way)."""
    a, b, h0 = _rglru_inputs(B, L, W, B * L + W)
    ja, jb = (jnp.asarray(x).astype(_JDT[dtype]) for x in (a, b))
    ta, tb = (torch.from_numpy(x).to(_TDT[dtype]) for x in (a, b))
    th0 = torch.from_numpy(h0)
    got_h, got_last = ref.reference_rglru(ta, tb, th0)
    assert got_h.dtype == got_last.dtype == torch.float32
    want_h, want_last = jref.reference_rglru(ja, jb, jnp.asarray(h0))
    # two roundings against XLA's one (an FMA)
    _close(got_h, want_h, 1e-6, 1e-6)
    _close(got_last, want_last, 1e-6, 1e-6)
    ih, il = jrg.rglru_scan(ja, jb, jnp.asarray(h0), chunk=chunk,
                            interpret=True)
    _close(got_h, ih, 0, 1e-5)
    _close(got_last, il, 0, 1e-5)
    # the CPU dispatch is the plain version
    oh, ol = ops.rglru_scan(ta, tb, th0)
    assert torch.equal(oh, got_h) and torch.equal(ol, got_last)


def test_reference_rglru_long_decay():
    """512 steps of a = 0.99, b = 0.01 from h0 = 0: no accumulated error
    against the oracle, the interpret kernel or the closed form."""
    B, L, W = 1, 512, 64
    a = np.full((B, L, W), 0.99, np.float32)
    b = np.full((B, L, W), 0.01, np.float32)
    h0 = np.zeros((B, W), np.float32)
    got_h, _ = ref.reference_rglru(*(torch.from_numpy(x) for x in (a, b, h0)))
    want_h, _ = jref.reference_rglru(jnp.asarray(a), jnp.asarray(b),
                                     jnp.asarray(h0))
    _close(got_h, want_h, 1e-5, 1e-5)
    ih, _ = jrg.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                           chunk=64, interpret=True)
    _close(got_h, ih, 1e-5, 1e-5)
    closed = 1.0 - 0.99 ** np.arange(1, L + 1, dtype=np.float64)
    _close(got_h[0, :, 0], closed, 1e-5, 1e-5)


def test_rglru_wrapper_takes_cuda_tensors_only():
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(1, 8, 16, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        trg.rglru_scan_fwd(a, b, h0)
    with pytest.raises(RuntimeError, match="no backward"):
        trg.rglru_scan(a.requires_grad_(True), b, h0)
    with pytest.raises(ValueError, match="one device type"):
        ops.rglru_scan(a.detach(), b.to("meta"), h0)


def test_rglru_vmap_rule_folds_the_party_axis(monkeypatch):
    """The autograd.Function's vmap rule, with the launch swapped for the
    plain version (the kernel needs the card): one call over the folded
    (n*B, L, W) batch, equal to the per-party recurrences."""
    calls = []

    def plain(a, b, h0):
        calls.append((tuple(a.shape), tuple(h0.shape)))
        return ref.reference_rglru(a, b, h0)

    monkeypatch.setattr(trg, "rglru_scan_fwd", plain)
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(3, 9, 16, 7))
    ab = torch.stack([a, b]).reshape(2, 3, 1, 9, 16)
    with torch.no_grad():
        h, last = torch.func.vmap(
            lambda x, y: trg.rglru_scan(x, y, h0[:1]))(ab[0], ab[1])
        hs, lasts = torch.func.vmap(
            lambda x, y, z: trg.rglru_scan(x, y, z))(ab[0], ab[1],
                                                     h0[:, None])
    assert calls == [((3, 9, 16), (3, 16))] * 2
    for i in range(3):
        wh, wl = ref.reference_rglru(a[i:i + 1], b[i:i + 1], h0[:1])
        assert torch.equal(h[i], wh) and torch.equal(last[i], wl)
        wh, wl = ref.reference_rglru(a[i:i + 1], b[i:i + 1], h0[i:i + 1])
        assert torch.equal(hs[i], wh) and torch.equal(lasts[i], wl)


# ---------------------------------------------------------------------------
# the conv and the recurrent block
# ---------------------------------------------------------------------------


def _block_params(dtype, d=32, w=48):
    jp = JG.init_rglru(jax.random.PRNGKey(3), d, w, _JDT[dtype])
    # non-zero biases and conv bias
    jp = jax.tree.map(lambda x: (x + 0.05).astype(x.dtype), jp)
    tp = _tree(jp)
    assert tp["lam"].dtype == torch.float32
    return jp, tp


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_depthwise_conv_matches(dtype, cached):
    jp, tp = _block_params(dtype)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 48)).astype(np.float32)
    cache = rng.normal(size=(2, 3, 48)).astype(np.float32)
    jy, jc = JS._depthwise_conv(
        jnp.asarray(x).astype(_JDT[dtype]), jp["conv_w"], jp["conv_b"],
        jnp.asarray(cache).astype(_JDT[dtype]) if cached else None)
    ty, tc = TS._depthwise_conv(
        torch.from_numpy(x).to(_TDT[dtype]), tp["conv_w"], tp["conv_b"],
        torch.from_numpy(cache).to(_TDT[dtype]) if cached else None)
    assert ty.dtype == tc.dtype == _TDT[dtype]
    # bit for bit: the same products summed in the same order
    np.testing.assert_array_equal(_np(ty), _np(jy))
    np.testing.assert_array_equal(_np(tc), _np(jc))


@pytest.mark.parametrize("case", ["no_cache", "cache", "decode_step"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrent_block_matches(dtype, case):
    """No cache (the prompt from zeros), a cache with a non-zero state and
    conv history (a 9-token continuation), and one decode step."""
    jp, tp = _block_params(dtype)
    rng = np.random.default_rng(0)
    L = 1 if case == "decode_step" else 9
    x = rng.normal(size=(2, L, 32)).astype(np.float32)
    conv = rng.normal(size=(2, 3, 48)).astype(np.float32)
    state = rng.normal(size=(2, 48)).astype(np.float32)
    jc = tc = None
    if case != "no_cache":
        jc = {"conv": jnp.asarray(conv).astype(_JDT[dtype]),
              "state": jnp.asarray(state)}
        tc = {"conv": torch.from_numpy(conv).to(_TDT[dtype]),
              "state": torch.from_numpy(state)}
    jo, jn = JG.recurrent_block(jp, jnp.asarray(x).astype(_JDT[dtype]), jc)
    to, tn = TG.recurrent_block(tp, torch.from_numpy(x).to(_TDT[dtype]), tc)
    assert to.dtype == _TDT[dtype] and tn["state"].dtype == torch.float32
    if dtype == "float32":
        _close(to, jo, BLOCK_RTOL, BLOCK_ATOL)
        _close(tn["conv"], jn["conv"], BLOCK_RTOL, BLOCK_ATOL)
    else:
        # two bfloat16 ulps of the outputs' scale; the conv cache is the
        # input rows themselves
        _close(to, jo, 2e-2, 1e-2)
        np.testing.assert_array_equal(_np(tn["conv"]), _np(jn["conv"]))
    _close(tn["state"], jn["state"], BLOCK_RTOL, BLOCK_ATOL)


# ---------------------------------------------------------------------------
# the hybrid transformer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[3, 5], ids=["smoke", "remainder"])
def backbone(request):
    """The smoke variant (one (lru, lru, attn) repeat) and a 5-layer cut
    that adds the (lru, lru) remainder segment."""
    jc, tc = _cfgs(request.param)
    jp = jax.jit(lambda k: JT.init_lm(k, jc))(jax.random.PRNGKey(1))
    return jc, tc, jp, _tree(jp)


PREFILL, STEPS, MAX_LEN = 40, 3, 48


@pytest.mark.parametrize("per_lane", [True, False])
def test_transformer_matches(backbone, per_lane):
    """The full forward, then a 40-token prefill into caches of 48 slots
    (the attention cache keeps min(48, window 32) = 32 slots, so the
    prefill writes the ring layout) and 3 decode steps past the window,
    with per-lane or shared positions; caches compared after each."""
    jc, tc, jp, tp = backbone
    fns = tbuild.build(tc)
    assert TT.stack_plan(tc) == JT.stack_plan(jc)
    shapes = [tuple(a.shape) for a in jax.tree.leaves(jp)]
    assert [tuple(t.shape) for t in
            tree_leaves(fns.init(torch.Generator().manual_seed(1)))] == shapes
    jcache0 = JT.init_cache(jc, 2, MAX_LEN, per_lane=per_lane)
    tcache0 = TT.init_cache(tc, 2, MAX_LEN, per_lane=per_lane)
    _trees_close(tcache0, jcache0, 0, 0)
    tok = np.random.default_rng(5).integers(0, jc.vocab_size,
                                            (2, PREFILL + STEPS))
    tok = tok.astype(np.int32)
    jl, _, _ = JT.apply_lm(jp, jnp.asarray(tok), jc)
    with torch.no_grad():
        tl, none, _ = fns.apply(tp, torch.from_numpy(tok))
    assert none is None
    _close(tl, jl, atol=ATOL * float(np.abs(np.asarray(jl)).max()))
    jh, jcache, _ = JT.apply_lm(jp, jnp.asarray(tok[:, :PREFILL]), jc,
                                caches=jcache0, return_hidden=True)
    with torch.no_grad():
        th, tcache, _ = TT.apply_lm(tp, torch.from_numpy(tok[:, :PREFILL]),
                                    tc, caches=tcache0, return_hidden=True)
    _close(th, jh)
    _trees_close(tcache, jcache)
    for s in range(STEPS):
        p = PREFILL + s
        pos = np.full((2, 1), p, np.int32) if per_lane else p
        jh, jcache, _ = JT.apply_lm(
            jp, jnp.asarray(tok[:, p:p + 1]), jc, caches=jcache,
            pos_offset=jnp.asarray(pos), return_hidden=True)
        with torch.no_grad():
            th, tcache, _ = TT.apply_lm(
                tp, torch.from_numpy(tok[:, p:p + 1]), tc, caches=tcache,
                pos_offset=torch.as_tensor(pos), return_hidden=True)
        _close(th, jh)
        _trees_close(tcache, jcache)


# ---------------------------------------------------------------------------
# EasterLM serving steps
# ---------------------------------------------------------------------------

B, P = 2, PREFILL + 1


@pytest.fixture(scope="module", params=["float", "int32", "int8"])
def served(request):
    """One jitted reference run per wire: the prefill of a 40-token prompt
    into per-lane caches (past the smoke window of 32), then a decode round
    at position 40 with per-lane nonces and lane 1 frozen."""
    mode = request.param
    jc, tc = _cfgs()
    js = JLM(jc, jcfg.EasterConfig(mask_mode=mode))
    params = _ref_params()
    tok = np.random.default_rng(6).integers(0, jc.vocab_size, (B, P))
    tok = tok.astype(np.int32)
    seeds = js.mask_seeds()
    E, caches = jax.jit(lambda p, t, c: js.prefill(
        p, t, c, seeds=seeds, round_idx=3))(
        params, jnp.asarray(tok[:, :-1]),
        js.init_caches(B, MAX_LEN, per_lane=True))
    pos = np.full((B,), P - 1, np.int32)
    nonces, lane_mask = np.array([4, 9], np.int32), np.array([True, False])
    logits, caches2 = jax.jit(lambda p, t, c, pos, lm, n: js.serve_step(
        p, t, c, pos, seeds, lane_mask=lm, nonces=n))(
        params, jnp.asarray(tok[:, -1:]), caches, jnp.asarray(pos),
        jnp.asarray(lane_mask), jnp.asarray(nonces))
    return dict(tc=tc, mode=mode, np_params=jax.tree.map(np.asarray, params),
                tok=tok, pos=pos, nonces=nonces, lane_mask=lane_mask,
                E=E, caches=caches, logits=logits, caches2=caches2)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_easter_lm_prefill_and_serve_step_match(served, engine):
    r = served
    ts = TLM(r["tc"], tcfg.EasterConfig(mask_mode=r["mode"]), engine=engine,
             device="cpu")
    params = ts.load_params(r["np_params"])
    if engine == "vectorized":
        # the passive group is stacked once, lru leaves included
        lam = ts._passive_stack(params)["backbone"]["segments"][0]["p0"][
            "rec"]["lam"]
        assert lam.shape == (3, 1, r["tc"].hybrid.lru_width)
    seeds = ts.mask_seeds()
    E, caches = ts.prefill(params, torch.from_numpy(r["tok"][:, :-1]),
                           ts.init_caches(B, MAX_LEN, per_lane=True),
                           seeds=seeds, round_idx=3)
    _close(E, r["E"])
    _trees_close(caches, r["caches"])
    logits, caches2 = ts.serve_step(
        params, torch.from_numpy(r["tok"][:, -1:]), caches,
        torch.from_numpy(r["pos"]), seeds,
        lane_mask=torch.from_numpy(r["lane_mask"]),
        nonces=torch.from_numpy(r["nonces"]))
    _close(logits, r["logits"])
    _trees_close(caches2, r["caches2"])


def test_bfloat16_hybrid_tree_npz_round_trip(tmp_path):
    """A bfloat16 hybrid EasterLM tree with float32 lam leaves: the
    reference's .npz checkpoint -> the port (grouped) -> back to numpy ->
    the reference's .npz again, bit for bit."""
    tc = dataclasses.replace(_cfgs()[1], dtype="bfloat16")
    # the reference's init_params of a bfloat16 config, without drawing it
    # again: every leaf cast to bfloat16 but lam, as init_rglru makes it
    tree = jax.tree_util.tree_map_with_path(
        lambda kp, a: a if jax.tree_util.keystr(kp).endswith("['lam']")
        else a.astype(jnp.bfloat16), _ref_params())
    path = jckpt.save(str(tmp_path / "rg.npz"), tree)
    restored, _ = jckpt.restore(path, tree)
    np_tree = jax.tree.map(np.asarray, restored)
    ts = TLM(tc, tcfg.EasterConfig(), device="cpu")
    params = ts.load_params(np_tree)
    lams = [t for p in params["parties"]
            for s in p["backbone"]["segments"] for t in
            (s["p0"]["rec"]["lam"], s["p1"]["rec"]["lam"])]
    assert {t.dtype for t in lams} == {torch.float32}
    assert {t.dtype for t in tree_leaves(params)} == {torch.bfloat16,
                                                      torch.float32}
    back = ts.export_params(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    again, _ = jckpt.restore(jckpt.save(str(tmp_path / "rg2.npz"), back),
                             tree)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


# ---------------------------------------------------------------------------
# the continuous-batching engine
# ---------------------------------------------------------------------------

# five greedy requests through two lanes: lanes are re-admitted, prompts of
# 30 tokens decode past the window of 32 (the ring wraps), and a request
# admitted after another finished starts from its own fresh prefill
_RNG = np.random.default_rng(9)
REQUESTS = [dict(tokens=tuple(_RNG.integers(0, 512, n).tolist()),
                 max_new_tokens=m)
            for n, m in ((30, 6), (12, 4), (30, 5), (12, 7), (30, 3))]
ENGINE_MAX_LEN = 40


@pytest.fixture(scope="module")
def ref_engine():
    js = JLM(_cfgs()[0], jcfg.EasterConfig())
    eng = jserving.ServingEngine(js, _ref_params(), lanes=2,
                                 max_len=ENGINE_MAX_LEN, chunk=3, base_key=1)
    comps = eng.run([japi.ServeRequest(**r) for r in REQUESTS])
    return comps, eng.rounds_run, eng.chunks_run


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_serving_engine_matches_reference(ref_engine, engine):
    jcomps, jrounds, jchunks = ref_engine
    ts = TLM(_cfgs()[1], tcfg.EasterConfig(), engine=engine, device="cpu")
    params = ts.load_params(jax.tree.map(np.asarray, _ref_params()))
    eng = tserving.ServingEngine(ts, params, lanes=2, max_len=ENGINE_MAX_LEN,
                                 chunk=3, base_key=1)
    comps = eng.run([tapi.ServeRequest(**r) for r in REQUESTS])
    key = lambda c: c.nonce
    assert [(c.nonce, c.lane, c.tokens) for c in sorted(comps, key=key)] == \
        [(c.nonce, c.lane, c.tokens) for c in sorted(jcomps, key=key)]
    assert (eng.rounds_run, eng.chunks_run) == (jrounds, jchunks)
    assert len(comps) == len(REQUESTS) > 2


def test_launch_serve_recurrentgemma_on_the_cpu(capsys):
    tlaunch.main(["--arch", ARCH, "--smoke", "--requests", "3",
                  "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "recurrentgemma-9b" in out and "served 3 requests" in out
    tlaunch.main(["--arch", ARCH, "--smoke", "--batch", "2", "--prompt-len",
                  "5", "--gen", "2", "--device", "cpu"])
    assert "decode  2 steps x2" in capsys.readouterr().out
