"""The port's decode drivers, typed serving surface and continuous-batching
engine (``core.decode``, ``core.api``, ``core.serving``,
``launch.serve``) against the JAX reference, on the CPU.

Sampling is rebuilt on the port's threefry: keys are held bit for bit
against ``jax.random`` (``fold_in``, ``split``), Gumbel noise within atol
1e-6 (float32 ``log`` differs by an ulp between XLA and torch; bfloat16
bit for bit) and tokens equal, on the same logits. Generated tokens,
``serve_round`` values, positions, budgets and keys are identical;
logits and caches within rtol 1e-4 / atol 1e-5 (float32). int8 serving
is held against a reference run with the same lane occupancy (one
dynamic scale per round over the live lanes), never against the
single-stream oracle. The reference runs once per configuration
(module-scoped fixtures) and both port engines are held against it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.core import api as japi
from repro.core import blinding as jb
from repro.core import decode as jdecode
from repro.core import serving as jserving
from repro.core.easter_lm import EasterLM as JLM
from repro_torch.configs import base as tcfg
from repro_torch.core import api as tapi
from repro_torch.core import blinding as tb
from repro_torch.core import decode as tdecode
from repro_torch.core import serving as tserving
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.launch import serve as tlaunch
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

ARCH = "qwen2.5-3b"
RTOL, ATOL = 1e-4, 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _keys(x) -> np.ndarray:
    """Key words as uint32, from a jax key array or an int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.numpy().astype(np.uint32)
    return np.asarray(jax.random.key_data(x) if jnp.issubdtype(
        x.dtype, jax.dtypes.prng_key) else x).astype(np.uint32)


def _systems(mode="float", engine="vectorized"):
    jc = jcfg.smoke_variant(jcfg.get_config(ARCH))
    tc = tcfg.smoke_variant(tcfg.get_config(ARCH))
    return (JLM(jc, jcfg.EasterConfig(mask_mode=mode)),
            TLM(tc, tcfg.EasterConfig(mask_mode=mode), engine=engine,
                device="cpu"))


@pytest.fixture(scope="module")
def weights():
    js, _ = _systems()
    return js.init_params(jax.random.PRNGKey(0))


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gumbel_and_keys_match_jax(dtype):
    base, nonce = 5, 77
    jkey = jax.random.fold_in(jax.random.PRNGKey(base), nonce)
    tkey = tdecode.key_tensor(tb.fold_in(tb.prng_key(base), nonce))
    np.testing.assert_array_equal(_keys(tkey), _keys(jkey))
    ja, jsub = jax.random.split(jkey)
    ta, tsub = tdecode.split_key(tkey)
    np.testing.assert_array_equal(_keys(ta), _keys(ja))
    np.testing.assert_array_equal(_keys(tsub), _keys(jsub))
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    g = np.asarray(jax.random.gumbel(jsub, (2048,), jdt), np.float32)
    tg = tdecode.gumbel(tsub, 2048, tdt).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(tg, g)
    else:
        np.testing.assert_allclose(tg, g, rtol=0, atol=1e-6)


def test_sample_token_matches_jax_on_the_same_logits():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(4, 512)).astype(np.float32) * 3
    tl = torch.from_numpy(logits)
    key = jax.random.PRNGKey(11)
    tkey = tdecode.key_tensor(tb.prng_key(11))
    # greedy and whole-batch sampling under one key
    np.testing.assert_array_equal(
        tdecode.sample_token(tl, tkey, 0.0).numpy(),
        np.asarray(jdecode.sample_token(jnp.asarray(logits), key, 0.0)))
    np.testing.assert_array_equal(
        tdecode.sample_token(tl, tkey, 0.8).numpy(),
        np.asarray(jdecode.sample_token(jnp.asarray(logits), key, 0.8)))
    # per-lane: greedy and sampled lanes in one batch, a finished lane pads
    keys = jax.random.split(key, 4)
    tkeys = torch.from_numpy(_keys(keys).astype(np.int64))
    temps = np.array([0.0, 0.7, 1.3, 0.9], np.float32)
    done = np.array([False, False, False, True])
    want = jdecode.sample_token(jnp.asarray(logits), keys, jnp.asarray(temps),
                                done=jnp.asarray(done), pad_id=3)
    got = tdecode.sample_token(tl, tkeys, torch.from_numpy(temps),
                               done=torch.from_numpy(done), pad_id=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and got[3, 0] == 3


def test_serve_round_schedule_and_rounds():
    np.testing.assert_array_equal(
        tdecode.serve_round_schedule(17, 5).numpy(),
        np.asarray(jdecode.serve_round_schedule(17, 5)))
    nonce, pos = np.array([0, 3, 16383]), np.array([5, 0, 32767])
    np.testing.assert_array_equal(
        tb.serve_round(torch.from_numpy(nonce), torch.from_numpy(pos))
        .numpy(), np.asarray(jb.serve_round(jnp.asarray(nonce),
                                            jnp.asarray(pos))))


# ---------------------------------------------------------------------------
# single-stream decode
# ---------------------------------------------------------------------------

PROMPT = np.random.default_rng(3).integers(0, 512, (2, 6)).astype(np.int32)
STEPS = 3


@pytest.fixture(scope="module")
def ref_stream(weights):
    js, _ = _systems()
    seeds = js.mask_seeds()
    caches = js.init_caches(2, 10)
    _, caches = js.prefill(weights, jnp.asarray(PROMPT[:, :-1]), caches,
                           seeds=seeds, round_idx=1)
    return jdecode._serve_tokens_impl(
        js, weights, jnp.asarray(PROMPT[:, -1:]), caches,
        PROMPT.shape[1] - 1, STEPS, seeds, key=jax.random.PRNGKey(2),
        temperature=0.9, return_logits=True)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_serve_tokens_matches_reference(weights, ref_stream, engine):
    _, ts = _systems(engine=engine)
    params = ts.load_params(_np_tree(weights))
    seeds = ts.mask_seeds()
    _, caches = ts.prefill(params, torch.from_numpy(PROMPT[:, :-1]),
                           ts.init_caches(2, 10), seeds=seeds, round_idx=1)
    toks, cc, pos, k, logits = tdecode.serve_tokens(
        ts, params, torch.from_numpy(PROMPT[:, -1:]), caches,
        PROMPT.shape[1] - 1, STEPS, seeds,
        key=tdecode.key_tensor(tb.prng_key(2)), temperature=0.9,
        return_logits=True)
    jtoks, jcc, jpos, jk, jlogits = ref_stream
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_allclose(_np(logits), _np(jlogits), rtol=RTOL,
                               atol=ATOL)
    assert int(pos) == int(jpos)
    np.testing.assert_array_equal(_keys(k), _keys(jk))
    for a, b in zip(tree_leaves(cc), jax.tree.leaves(jcc)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    # greedy: the argmax of the same logits, one step at a time
    greedy = tdecode.serve_tokens(
        ts, params, torch.from_numpy(PROMPT[:, -1:]), caches,
        PROMPT.shape[1] - 1, 1, seeds, return_logits=True)
    assert torch.equal(greedy[0][:, 0],
                       greedy[4][:, 0].argmax(-1).to(torch.int32))
    with pytest.raises(ValueError, match="PRNG key"):
        tdecode.serve_tokens(ts, params, torch.from_numpy(PROMPT[:, -1:]),
                             caches, 5, 1, seeds, temperature=0.5)


# ---------------------------------------------------------------------------
# the typed serving surface and the continuous-batching engine
# ---------------------------------------------------------------------------

LANES, MAX_LEN, CHUNK = 3, 14, 4
REQS = [dict(tokens=(11, 22, 33, 44, 55), max_new_tokens=6),
        dict(tokens=(7, 8, 9, 10, 11, 12, 13), max_new_tokens=3,
             temperature=0.8, eos_id=-1)]


@pytest.fixture(scope="module")
def ref_decoder(weights):
    js, _ = _systems()
    dcfg = japi.DecodeConfig(lanes=LANES, max_len=MAX_LEN, chunk=CHUNK,
                             base_key=4)
    prefill_fn, decode_fn = japi.build_decoder(js, dcfg)
    state = japi.init_decode_state(js, dcfg)
    for lane, r in enumerate(REQS):
        state = prefill_fn(weights, state, japi.ServeRequest(**r), lane,
                           nonce=10 + lane)
    admitted = jax.tree.map(np.asarray, state)
    buf, state, steps = decode_fn(weights, state)
    return admitted, np.asarray(buf), jax.tree.map(np.asarray, state), \
        int(steps)


def _state_equal(t, j):
    for f in ("tok", "pos", "done", "remaining", "nonce", "eos"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(j, f))
    np.testing.assert_array_equal(t.temp.numpy(), j.temp)
    np.testing.assert_array_equal(_keys(t.key), _keys(j.key))
    for a, b in zip(tree_leaves(t.caches), jax.tree.leaves(j.caches)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_build_decoder_matches_reference(weights, ref_decoder, engine):
    """Two requests admitted into lanes 0 and 1 (lane 2 stays idle), then
    one chunk: lane 1 spends its budget of 3 and freezes mid-chunk."""
    admitted, jbuf, jstate, jsteps = ref_decoder
    _, ts = _systems(engine=engine)
    params = ts.load_params(_np_tree(weights))
    dcfg = tapi.DecodeConfig(lanes=LANES, max_len=MAX_LEN, chunk=CHUNK,
                             base_key=4)
    prefill_fn, decode_fn = tapi.build_decoder(ts, dcfg)
    state = tapi.init_decode_state(ts, dcfg)
    for lane, r in enumerate(REQS):
        state = prefill_fn(params, state, tapi.ServeRequest(**r), lane,
                           nonce=10 + lane)
    _state_equal(state, admitted)
    before = state
    buf, state, steps = decode_fn(params, state)
    assert steps == jsteps
    np.testing.assert_array_equal(buf.numpy(), jbuf)
    _state_equal(state, jstate)
    # the idle lane's cache rows never moved
    for a, b in zip(tree_leaves(state.caches), tree_leaves(before.caches)):
        assert torch.equal(a[:, 2], b[:, 2])


def test_decoder_rejects_and_caps():
    _, ts = _systems()
    params = ts.init_params(torch.Generator().manual_seed(0))
    dcfg = tapi.DecodeConfig(lanes=2, max_len=8, chunk=16)
    prefill_fn, decode_fn = tapi.build_decoder(ts, dcfg)
    state = tapi.init_decode_state(ts, dcfg)
    with pytest.raises(ValueError, match="no nonce"):
        prefill_fn(params, state, tapi.ServeRequest((1, 2), 3), 0)
    with pytest.raises(ValueError, match="exceeds"):
        prefill_fn(params, state, tapi.ServeRequest(tuple(range(9)), 3), 0,
                   nonce=1)
    for bad in (dict(tokens=(1,), max_new_tokens=2),
                dict(tokens=(1, 2), max_new_tokens=0),
                dict(tokens=(1, 2), max_new_tokens=1,
                     nonce=tb.MAX_SERVE_NONCE + 1)):
        with pytest.raises(ValueError):
            tapi.ServeRequest(**bad)
    # the budget is capped to the slot, and the chunk stops early once
    # every lane is done
    state = prefill_fn(params, state, tapi.ServeRequest((1, 2, 3, 4, 5, 6),
                                                        50), 0, nonce=2)
    assert int(state.remaining[0]) == 8 - 6 + 1
    buf, state, steps = decode_fn(params, state)
    assert steps == 3 and bool(state.done.all())
    assert torch.all(buf[:, 3:] == 0) and torch.all(buf[1] == 0)


# two prompt lengths: the reference compiles one prefill per length
REQUESTS = [dict(tokens=(3, 1, 4, 1, 5), max_new_tokens=5),
            dict(tokens=(9, 2, 6, 5, 3, 5, 8), max_new_tokens=7, eos_id=3),
            dict(tokens=(5, 3, 5, 8, 9, 7, 9), max_new_tokens=3,
                 temperature=0.9),
            dict(tokens=(2, 7, 1, 8, 2), max_new_tokens=6, temperature=1.3)]


@pytest.fixture(scope="module", params=["float", "int32", "int8"])
def ref_engine(request, weights):
    js, _ = _systems(request.param)
    eng = jserving.ServingEngine(js, weights, lanes=2, max_len=12, chunk=3,
                                 base_key=1)
    comps = eng.run([japi.ServeRequest(**r) for r in REQUESTS])
    return request.param, comps, eng.rounds_run, eng.chunks_run


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_serving_engine_matches_reference(weights, ref_engine, engine):
    """Four requests (greedy, EOS, sampled) through two lanes: the same
    lane occupancy round by round as the reference's run, so int8's
    per-round scale sees the same live lanes."""
    mode, jcomps, jrounds, jchunks = ref_engine
    _, ts = _systems(mode, engine)
    params = ts.load_params(_np_tree(weights))
    eng = tserving.ServingEngine(ts, params, lanes=2, max_len=12, chunk=3,
                                 base_key=1)
    comps = eng.run([tapi.ServeRequest(**r) for r in REQUESTS])
    key = lambda c: c.nonce
    assert [(c.nonce, c.lane, c.tokens) for c in sorted(comps, key=key)] == \
        [(c.nonce, c.lane, c.tokens) for c in sorted(jcomps, key=key)]
    assert (eng.rounds_run, eng.chunks_run) == (jrounds, jchunks)
    assert all(c.latency_s >= c.queue_s >= 0 for c in comps)


def test_serving_engine_open_loop_and_no_exit():
    _, ts = _systems()
    params = ts.init_params(torch.Generator().manual_seed(1))
    eng = tserving.ServingEngine(ts, params, lanes=2, max_len=12, chunk=2,
                                 early_exit=False, no_exit_budget=4)
    reqs = [tapi.ServeRequest((1, 2, 3), 2, eos_id=5),
            tapi.ServeRequest((4, 5), 1)]
    comps = eng.run(reqs, arrivals=[0.0, 0.05])
    assert sorted(len(c.tokens) for c in comps) == [4, 4]
    assert sorted(c.nonce for c in comps) == [0, 1]
    eng.reset()
    assert eng.rounds_run == 0 and bool(eng.state.done.all())


def test_launch_serve_runs_on_the_cpu(capsys):
    qwen = ["--arch", "qwen2.5-3b"]
    tlaunch.main(qwen + ["--smoke", "--requests", "3", "--prompt-len", "6",
                         "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "tok/s" in out
    tlaunch.main(qwen + ["--smoke", "--batch", "2", "--prompt-len", "4",
                         "--gen", "2", "--device", "cpu", "--step-loop",
                         "--engine", "loop"])
    assert "[step loop]" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="torchrun"):
        tlaunch.main(["--smoke", "--engine", "sharded", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tlaunch.main(["--smoke"])
