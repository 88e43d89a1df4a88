"""The port's LM layers, transformer and EasterLM serving steps against the
JAX reference (``repro.models.layers``, ``repro.models.transformer``,
``repro.core.easter_lm``), on the CPU.

Weights cross as numpy arrays (``EasterLM.load_params``). The models run
the ``smoke_variant`` of qwen2.5-3b and of qwen2-1.5b in float32.

Tolerances: embeddings and logits rtol 1e-4 / atol 1e-5 (float32; the
two frameworks sum the matmuls and the softmax in other orders); caches
and layer outputs the same; int8 KV quantization and the wire integers
bit for bit. The reference is run once per configuration through
module-scoped fixtures and shared by both port engines: its vectorized
and loop engines are each other's oracle in its own tests, and the port
holds each of its engines against it.
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
from repro.kernels import flash_attention as jfa
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import checkpoint
from repro_torch.configs import base as tcfg
from repro_torch.core import aggregation
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.models import build as tbuild
from repro_torch.models import layers as TL
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

ARCHS = ("qwen2.5-3b", "qwen2-1.5b")
RTOL, ATOL = 1e-4, 1e-5


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


def _cfgs(arch):
    return (jcfg.smoke_variant(jcfg.get_config(arch)),
            tcfg.smoke_variant(tcfg.get_config(arch)))


@functools.lru_cache(maxsize=None)
def _ref_params():
    """The reference EasterLM's init_params(PRNGKey(0)) at the smoke
    variant, drawn once: both archs' smoke variants give trees of one
    shape (checked), and the wire mode does not enter the weights."""
    key = jax.random.PRNGKey(0)
    trees = [jax.eval_shape(JLM(_cfgs(a)[0], jcfg.EasterConfig()).init_params,
                            key) for a in ARCHS]
    assert jax.tree.map(lambda s: (s.shape, s.dtype), trees[0]) == \
        jax.tree.map(lambda s: (s.shape, s.dtype), trees[1])
    return JLM(_cfgs(ARCHS[0])[0], jcfg.EasterConfig()).init_params(key)


# ---------------------------------------------------------------------------
# configs and the weight hand-over
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match_reference(arch):
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.resolved_head_dim == j.resolved_head_dim
    assert t.param_count() == j.param_count()
    js, ts = _cfgs(arch)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.param_count() == js.param_count()
    assert set(tcfg.list_archs()) <= set(jcfg.list_archs())
    with pytest.raises(KeyError, match="unknown arch"):
        tcfg.get_config("no-such-arch")


def test_bfloat16_lm_tree_round_trip():
    tc = dataclasses.replace(_cfgs("qwen2.5-3b")[1], dtype="bfloat16")
    ts = TLM(tc, tcfg.EasterConfig(), device="cpu")
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)),
                        _ref_params())
    assert tree["parties"][1]["backbone"]["segments"][0]["p0"]["attn"][
        "wq"]["w"].dtype.name == "bfloat16"
    params = ts.load_params(tree)
    leaves = tree_leaves(params)
    assert {t.dtype for t in leaves} == {torch.bfloat16}
    back = ts.export_params(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))
    # and the tree goes back into JAX as it came
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(jnp.asarray(a), np.float32), np.asarray(b, np.float32)),
        back, tree)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _qkv(B, S, T, Hq, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, hd)).astype(np.float32))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norm_rope_mlp_match(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=(64,)).astype(np.float32)}
    if kind == "layer":
        p["bias"] = rng.normal(size=(64,)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    _close(TL.apply_norm(tp, torch.from_numpy(x)),
           JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x)))
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 64, 1e6)
    tc, ts = TL.rope_cos_sin(torch.from_numpy(pos), 64, 1e6)
    _close(tc, jc)
    _close(ts, js)
    q = rng.normal(size=(2, 5, 3, 64)).astype(np.float32)
    _close(TL.apply_rope(torch.from_numpy(q), tc, ts),
           JL.apply_rope(jnp.asarray(q), jc, js))
    for act in ("silu", "gelu"):
        mp = {n: {"w": rng.normal(size=s).astype(np.float32) * 0.1}
              for n, s in (("up", (64, 96)), ("down", (96, 64)),
                           ("gate", (64, 96)))}
        _close(TL.mlp(checkpoint.params_from_numpy(mp, "cpu", False),
                      torch.from_numpy(x), act),
               JL.mlp(jax.tree.map(jnp.asarray, mp), jnp.asarray(x), act))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 3), (False, 4)])
def test_dot_and_chunked_attention_match(causal, window):
    q, k, v = _qkv(2, 32, 32, 4, 2, 16, 1)
    _close(TL.dot_attention(*_t(q, k, v), causal=causal, window=window),
           JL.dot_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, window=window))
    _close(TL.chunked_attention(*_t(q, k, v), causal=causal, window=window,
                                q_chunk=8, kv_chunk=16),
           JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, window=window,
                                q_chunk=8, kv_chunk=16))
    valid = np.arange(32)[None] < np.array([[20], [32]])
    _close(TL.dot_attention(*_t(q[:, :1], k, v), causal=causal,
                            window=window, q_offset=19,
                            kv_valid=torch.from_numpy(valid)),
           JL.dot_attention(jnp.asarray(q[:, :1]), jnp.asarray(k),
                            jnp.asarray(v), causal=causal, window=window,
                            q_offset=19, kv_valid=jnp.asarray(valid)))


def test_quantize_kv_bit_exact():
    x = np.random.default_rng(2).normal(size=(2, 9, 2, 16)).astype(np.float32)
    jq, js = JL.quantize_kv(jnp.asarray(x))
    tq, ts = TL.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    np.testing.assert_array_equal(
        TL.dequantize_kv(tq, ts, torch.float32).numpy(),
        np.asarray(JL.dequantize_kv(jq, js, jnp.float32)))


def _attn_params(d, Hq, Hkv, hd, seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), d, Hq, Hkv, hd, True,
                           jnp.float32)
    jp = jax.tree.map(lambda a: a + 0.01, jp)      # nonzero biases
    return jp, checkpoint.params_from_numpy(jax.tree.map(np.asarray, jp),
                                            "cpu", False)


def _cache(T, B, Hkv, hd, idx, quant=False):
    if quant:
        return {"k": jnp.zeros((B, T, Hkv, hd), jnp.int8),
                "k_scale": jnp.zeros((B, T, Hkv, 1), jnp.bfloat16),
                "v": jnp.zeros((B, T, Hkv, hd), jnp.int8),
                "v_scale": jnp.zeros((B, T, Hkv, 1), jnp.bfloat16),
                "idx": jnp.asarray(idx, jnp.int32)}
    return {"k": jnp.zeros((B, T, Hkv, hd)), "v": jnp.zeros((B, T, Hkv, hd)),
            "idx": jnp.asarray(idx, jnp.int32)}


def _tcache(c):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, c), "cpu",
                                        False)


@pytest.mark.parametrize("window,T,per_lane,quant", [
    (0, 16, False, False), (0, 16, True, False), (6, 6, True, False),
    (6, 6, False, False), (0, 16, True, True), (4, 4, True, True)])
def test_self_attention_cache_path_matches(window, T, per_lane, quant):
    """Prefill (S = 9, the window's ring-buffer roll when S >= T) then two
    decode steps, scalar or per-lane positions, plain or int8 cache."""
    B, S, d, Hq, Hkv, hd = 2, 9, 32, 4, 2, 8
    jp, tp = _attn_params(d, Hq, Hkv, hd, 3)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, S + 2, d)).astype(np.float32)
    kw = dict(n_heads=Hq, n_kv_heads=Hkv, head_dim=hd, window=window)
    idx0 = np.zeros((B,) if per_lane else (), np.int32)
    jc = _cache(T, B, Hkv, hd, idx0, quant)
    tc = _tcache(jc)
    pos = np.arange(S)
    jcs, jsn = JL.rope_cos_sin(jnp.asarray(pos), hd, 1e4)
    tcs, tsn = TL.rope_cos_sin(torch.from_numpy(pos), hd, 1e4)
    jo, jc = JL.self_attention(jp, jnp.asarray(x[:, :S]), cos=jcs, sin=jsn,
                               cache=jc, **kw)
    to, tc = TL.self_attention(tp, torch.from_numpy(x[:, :S]), cos=tcs,
                               sin=tsn, cache=tc, **kw)
    _close(to, jo)
    _trees_close(tc, jc)
    for step in range(2):
        jcs, jsn = JL.rope_cos_sin(jnp.asarray(np.full((B, 1), S + step)),
                                   hd, 1e4)
        tcs, tsn = TL.rope_cos_sin(torch.full((B, 1), S + step), hd, 1e4)
        xs = x[:, S + step:S + step + 1]
        jo, jc = JL.self_attention(jp, jnp.asarray(xs), cos=jcs, sin=jsn,
                                   cache=jc, **kw)
        to, tc = TL.self_attention(tp, torch.from_numpy(xs), cos=tcs,
                                   sin=tsn, cache=tc, **kw)
        _close(to, jo)
        _trees_close(tc, jc)


# ---------------------------------------------------------------------------
# the flash kernel's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,Hq,Hkv,hd,causal,window", [
    (64, 4, 2, 64, True, 0), (128, 8, 1, 64, False, 0),
    (64, 2, 2, 32, True, 32), (128, 4, 2, 128, True, 32)])
def test_reference_attention_matches_jax_and_interpret_kernel(
        S, Hq, Hkv, hd, causal, window):
    q, k, v = _qkv(1, S, S, Hq, Hkv, hd, S + hd)
    want = jref.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal,
                                    window=window)
    got = ref.reference_attention(*_t(q, k, v), causal=causal, window=window)
    _close(got, want, 1e-5, 1e-6)
    interp = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=window,
                                 block_q=64, block_k=64, interpret=True)
    _close(got, interp, 1e-5, 3e-5)
    # the CPU dispatch is the plain version; the default path's
    # dot_attention agrees with it
    _close(ops.flash_attention(*_t(q, k, v), causal=causal, window=window),
           got, 0, 0)
    _close(TL.dot_attention(*_t(q, k, v), causal=causal, window=window), got,
           1e-5, 1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_rows_that_see_no_key_are_the_mean_of_v(causal):
    """S = 128 > T = 64 with a window of 16: rows from T + 16 - 1 = 79 on
    see no key. The reference's interpret-mode kernel scores every key of
    such a row -1e30 (a uniform softmax), and the port's CPU path agrees:
    both give the mean of v over the T keys there."""
    q, k, v = _qkv(1, 128, 64, 4, 2, 64, 9)
    interp = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, window=16,
                                 block_q=64, block_k=64, interpret=True)
    got = ops.flash_attention(*_t(q, k, v), causal=causal, window=16)
    _close(got, interp, 1e-5, 3e-5)
    mean = np.repeat(v.mean(axis=1), 2, axis=1)[:, None]   # (1, 1, Hq, hd)
    want = np.broadcast_to(mean, (1, 128 - 79, 4, 64))
    _close(got[:, 79:], want, 1e-5, 1e-6)
    _close(np.asarray(interp)[:, 79:], want, 1e-5, 1e-6)
    assert not np.allclose(_np(got[:, 78]), mean[:, 0], atol=1e-3)


def test_flash_wrapper_takes_cuda_tensors_only():
    q, k, v = _t(*_qkv(1, 8, 8, 2, 1, 32, 0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfa.flash_attention_fwd(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        tfa.flash_attention(q.requires_grad_(True), k, v)


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def backbone(request):
    jc, tc = _cfgs(request.param)
    p = _ref_params()["parties"][0]["backbone"]    # an init_lm tree
    return jc, tc, p, checkpoint.params_from_numpy(
        jax.tree.map(np.asarray, p), "cpu", False)


def test_transformer_matches(backbone):
    jc, tc, jp, tp = backbone
    fns = tbuild.build(tc)
    assert TT.stack_plan(tc) == JT.stack_plan(jc)
    # the stacked (reps, ...) layout carries over leaf for leaf
    shapes = [tuple(a.shape) for a in jax.tree.leaves(
        jax.eval_shape(lambda k: JT.init_lm(k, jc), jax.random.PRNGKey(1)))]
    assert [tuple(t.shape) for t in
            tree_leaves(fns.init(torch.Generator().manual_seed(1)))] == shapes
    tok = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 9))
    tok = tok.astype(np.int32)
    jl, jcache, _ = JT.apply_lm(jp, jnp.asarray(tok), jc,
                                caches=JT.init_cache(jc, 2, 12, per_lane=True))
    with torch.no_grad():
        tl, tcache, _ = fns.apply(tp, torch.from_numpy(tok),
                                  caches=TT.init_cache(tc, 2, 12,
                                                       per_lane=True))
    # tied-embedding logits reach |200| here (unit-normal table rows):
    # their atol is 1e-5 of that scale, as for the unit-scale outputs
    _close(tl, jl, atol=ATOL * float(np.abs(np.asarray(jl)).max()))
    _trees_close(tcache, jcache)
    pos = np.array([[9], [4]], np.int32)
    for seg in jcache:
        seg["p0"]["idx"] = jnp.broadcast_to(jnp.asarray(pos[:, 0]),
                                            seg["p0"]["idx"].shape)
    for seg in tcache:
        seg["p0"]["idx"] = torch.from_numpy(pos[:, 0]).expand(
            seg["p0"]["idx"].shape).clone()
    jh, jcache, _ = JT.apply_lm(jp, jnp.asarray(tok[:, :1]), jc,
                                caches=jcache, pos_offset=jnp.asarray(pos),
                                return_hidden=True)
    with torch.no_grad():
        th, tcache, _ = TT.apply_lm(tp, torch.from_numpy(tok[:, :1]), tc,
                                    caches=tcache,
                                    pos_offset=torch.from_numpy(pos),
                                    return_hidden=True)
    _close(th, jh)
    _trees_close(tcache, jcache)


def test_unported_families_raise():
    """The sharded engine needs a party group: without a launcher's
    ranks (torchrun, ``mesh.spawn_ranks``; tests/test_torch_sharded.py
    runs it) it raises. The encoder-decoder and vision families, the
    cross-attention block and the frontend inputs are ported
    (tests/test_torch_frontends.py holds them against the reference):
    they build, and a dense party's loss_fn ignores a frontend key, as
    the reference's does."""
    _, tc = _cfgs("qwen2.5-3b")
    with pytest.raises(RuntimeError, match="torchrun"):
        TLM(tc, tcfg.EasterConfig(), engine="sharded", device="cpu")
    for family in ("encdec", "vlm"):
        p = TT.init_lm(torch.Generator(), dataclasses.replace(
            tcfg.ModelConfig(family=family), n_encoder_layers=1))
        assert ("encoder" in p and "xattn" in p) == (family == "encdec")
    assert "xattn" in TT.init_block(torch.Generator(), tc, "xattn")
    sys_ = TLM(tc, tcfg.EasterConfig(), device="cpu")
    params = sys_.init_params(torch.Generator().manual_seed(0))
    tok = torch.zeros((1, 4), dtype=torch.int32)
    with torch.no_grad():
        plain = sys_.loss_fn(params, {"tokens": tok, "labels": tok}, 0, None)
        extra = sys_.loss_fn(params, {"tokens": tok, "labels": tok,
                                      "audio_embed": torch.ones(1, 3, 8),
                                      "note": "ignored"}, 0, None)
    assert all(torch.equal(a, b) for a, b in zip(plain, extra))


# ---------------------------------------------------------------------------
# EasterLM serving steps
# ---------------------------------------------------------------------------

B, P, MAX_LEN = 2, 7, 12


@pytest.fixture(scope="module", params=[(a, m) for a in ARCHS
                                        for m in ("float", "int32", "int8")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def served(request):
    """One reference run per (arch, wire): prefill of a 7-token prompt
    into per-lane caches, then a decode round with per-lane nonces and
    lane 1 frozen."""
    arch, mode = request.param
    jc, tc = _cfgs(arch)
    js = JLM(jc, jcfg.EasterConfig(mask_mode=mode))
    params = _ref_params()
    tok = np.random.default_rng(6).integers(0, jc.vocab_size, (B, P))
    tok = tok.astype(np.int32)
    seeds = js.mask_seeds()
    E, caches = js.prefill(params, jnp.asarray(tok[:, :-1]),
                           js.init_caches(B, MAX_LEN, per_lane=True),
                           seeds=seeds, round_idx=3)
    pos = np.full((B,), P - 1, np.int32)
    nonces, lane_mask = np.array([4, 9], np.int32), np.array([True, False])
    logits, caches2 = js.serve_step(
        params, jnp.asarray(tok[:, -1:]), caches, jnp.asarray(pos), seeds,
        lane_mask=jnp.asarray(lane_mask), nonces=jnp.asarray(nonces))
    return dict(tc=tc, mode=mode, np_params=jax.tree.map(np.asarray, params),
                tok=tok, pos=pos, nonces=nonces, lane_mask=lane_mask,
                E=E, caches=caches, logits=logits, caches2=caches2)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_easter_lm_prefill_and_serve_step_match(served, engine):
    r = served
    ts = TLM(r["tc"], tcfg.EasterConfig(mask_mode=r["mode"]), engine=engine,
             device="cpu")
    params = ts.load_params(r["np_params"])
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


def test_passive_group_is_stacked_once():
    _, tc = _cfgs("qwen2.5-3b")
    ts = TLM(tc, tcfg.EasterConfig(), device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(0))
    stacked = ts._passive_stack(params)
    # the per-party trees are row views of the stacked tree: no copy
    for k, party in enumerate(params["parties"][1:]):
        for leaf, base in zip(tree_leaves(party), tree_leaves(stacked)):
            assert leaf.data_ptr() == base[k].data_ptr()
    loose = {"parties": [params["parties"][0]] + [
        {key: val for key, val in checkpoint.params_from_numpy(
            checkpoint.params_to_numpy(p), "cpu", False).items()}
        for p in params["parties"][1:]]}
    with pytest.raises(ValueError, match="not stacked"):
        ts._passive_stack(loose)
    # the loop engine reads per-party trees and groups nothing
    lp = TLM(tc, tcfg.EasterConfig(), engine="loop", device="cpu")
    assert lp.group_params(loose) is loose


def test_frozen_lane_ships_zero_uplink(monkeypatch):
    """A frozen lane's rows of every passive uplink (E_k + r_k) are
    exactly zero, on the float and both ring wires."""
    _, tc = _cfgs("qwen2.5-3b")
    seen = []
    for mode in ("float", "int32", "int8"):
        ts = TLM(tc, tcfg.EasterConfig(mask_mode=mode), device="cpu")
        params = ts.init_params(torch.Generator().manual_seed(0))
        caches = ts.init_caches(3, 8, per_lane=True)
        tok = torch.tensor([[5], [6], [7]], dtype=torch.int32)

        def spy(E_all, masks, *a, **kw):
            seen.append((mode, E_all, masks))
            return orig[mode](E_all, masks, *a, **kw)

        orig = {"float": aggregation.blind_and_aggregate,
                "int32": aggregation.aggregate_ring,
                "int8": aggregation.aggregate_ring}
        name = ("blind_and_aggregate" if mode == "float"
                else "aggregate_ring")
        monkeypatch.setattr(aggregation, name, spy)
        ts.serve_step(params, tok, caches, torch.tensor([2, 3, 4]),
                      ts.mask_seeds(), lane_mask=torch.tensor(
                          [True, False, True]),
                      nonces=torch.tensor([1, 2, 3]))
        monkeypatch.undo()
    assert [m for m, _, _ in seen] == ["float", "int32", "int8"]
    for mode, E_all, masks in seen:
        assert torch.all(E_all[:, 1] == 0) and torch.all(masks[:, 1] == 0)
        assert torch.any(E_all[:, 0] != 0) and torch.any(masks[:, 0] != 0)


@pytest.mark.parametrize("mode", ["float", "int32", "int8", "unblinded"])
def test_aggregate_grouped_matches(mode):
    """Aggregation of an already-gathered passive uplink (the sharded
    engine's form) against the reference's, on the same uplink: the ring
    wires bit for bit."""
    from repro.core import blinding as jb
    from repro_torch.core import blinding as tb
    wire = "float" if mode == "unblinded" else mode
    jc, tc = _cfgs("qwen2.5-3b")
    js = JLM(jc, jcfg.EasterConfig(mask_mode=wire))
    ts = TLM(tc, tcfg.EasterConfig(mask_mode=wire), device="cpu")
    rng = np.random.default_rng(7)
    E_a = rng.normal(size=(2, 3, 16)).astype(np.float32)
    E_p = rng.normal(size=(3, 2, 3, 16)).astype(np.float32)
    masks = js.masks_for((2, 3, 16), 5, js.mask_seeds())
    scale = None
    if wire == "int8":
        scale = jb.ring_scale(jnp.max(jnp.abs(jnp.concatenate(
            [jnp.asarray(E_a)[None], jnp.asarray(E_p)]))), 4, "int8")
    blinded = mode != "unblinded"
    up = (jb.blind_uplink(jnp.asarray(E_p), masks, wire, scale) if blinded
          else jnp.asarray(E_p))
    want = js._aggregate_grouped(jnp.asarray(E_a), up, blinded, scale)
    got = ts._aggregate_grouped(
        torch.from_numpy(E_a), torch.from_numpy(np.array(up)), blinded,
        None if scale is None else torch.from_numpy(np.array(scale)))
    if wire in ("int32", "int8"):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert tb.RING_MODES == jb.RING_MODES
    else:
        _close(got, want)
