"""The port's sharded engine (``engine="sharded"`` over a party group of
``torch.distributed`` ranks) held against the single-process engines.

One module-scoped spawn starts a 4-rank gloo group on the CPU (a
FileStore under the test's temporary directory, one torch thread a rank)
and runs every case of ``_torch_sharded_ranks.run_cases`` in it; the
ranks send numpy back. Mirrors the reference's
tests/test_party_sharding.py, against the reference's vectorized engine
and the port's vectorized and loop engines (never the reference under
its multi-device flags):

  * forward losses, predictions, embeddings, serving embeddings, logits
    and caches equal the port's vectorized and loop engines bit for bit,
    on the float, int32 and int8 wires, masked and unmasked;
  * gradients within the reference's ``_grads_close``: atol 5e-6,
    rtol 1e-6;
  * against the reference (JAX) vectorized engine: the classifier's
    per-party losses agree to rtol 5e-7 (1.5e-7 measured); the LM's
    losses, prefill embeddings, decode logits and caches to
    the rtol 1e-4 / atol 1e-5 of tests/test_torch_lm.py and
    tests/test_torch_lm_train.py: torch and XLA round float32 matmuls in
    other orders (standing differences in ROADMAP.md queue 3);
  * the uplink audit by value: what the embedding-shaped collectives
    carry is E_raw + r for each passive party and exactly 0 for the
    active party, and the only other embedding-sized payload is the
    global embedding's broadcast.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_sharded_ranks as ranks
from repro.configs import base as jcfg
from repro.configs.base import EasterConfig as JEasterConfig
from repro.core import party_models as jpm
from repro.core.easter_lm import EasterLM as JLM
from repro.core.protocol import EasterClassifier as JClassifier
from repro_torch import checkpoint
from repro_torch.core import blinding, train_loop
from repro_torch.launch import mesh
from repro_torch.tree import tree_leaves

# the reference LM against the port: tests/test_torch_lm.py's and
# tests/test_torch_lm_train.py's float32 tolerances
LM_RTOL, LM_ATOL = 1e-4, 1e-5

N_RANKS = 4
B, D, N_CLS = ranks.B, ranks.D_EMBED, ranks.N_CLS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's results of one 4-rank run (rank order). The parent's
    own reference computations overlap the ranks' run."""
    store = str(tmp_path_factory.mktemp("party_group"))
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(mesh.spawn_ranks, ranks.run_cases, N_RANKS,
                    store_dir=store, device="cpu", threads=1,
                    timeout_s=240)
    _ref_lm()                      # the reference's compiles, meanwhile
    yield fut
    ex.shutdown()


def _results(spawned):
    return spawned.result()


def _grads_close(ga, gb, atol=5e-6):
    la, lb = tree_leaves(ga), tree_leaves(gb)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   atol=atol, rtol=1e-6)


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))


def _ref_loss(mode, gm, params, xs, y, masks):
    """The reference's vectorized engine on the same weights and masks."""
    jarches = [jpm.PartyArch("mlp", (32, 16) if k % 2 == 0 else (48,),
                             (16,), D, N_CLS) for k in range(8)]
    sys_ = JClassifier(JEasterConfig(num_passive=7, d_embed=D,
                                     mask_mode=mode), jarches, [10] * 8,
                       grad_mode=gm)
    jp = jax.tree.map(jnp.asarray, checkpoint.params_to_numpy(params))
    total, per = sys_.loss_fn(jp, [jnp.asarray(x.numpy()) for x in xs],
                              jnp.asarray(y.numpy()),
                              None if masks is None
                              else jnp.asarray(masks.numpy()))
    return np.asarray(total), np.asarray(per)


# ---------------------------------------------------------------------------
# classifier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ranks.CLS_CASES,
                         ids=lambda c: f"{c[0]}-{'masked' if c[1] else 'raw'}"
                                       f"-{c[2]}")
def test_classifier_sharded_loss_bitexact(spawned, case):
    mode, masked, gm = case
    sv = ranks.classifier("vectorized", mode, grad_mode=gm)
    sl = ranks.classifier("loop", mode, grad_mode=gm)
    params = ranks.cls_params(sv, 1)
    xs, y = ranks.cls_batch(8, 0)
    masks = sv.masks(B, 0) if masked else None
    tv, pv, gv = ranks.cls_loss_grads(sv, params, xs, y, masks)
    with torch.no_grad():
        tl, pl = sl.loss_fn(params, xs, y, masks)
    rt, rp = _ref_loss(mode, gm, params, xs, y, masks)
    res = _results(spawned)
    for r in res:
        total, per, grads, sharded = r["cls"][case]
        assert sharded                      # two groups of 4 over 4 ranks
        np.testing.assert_array_equal(total, tv.numpy())
        np.testing.assert_array_equal(per, pv.numpy())
        np.testing.assert_array_equal(per, pl.numpy())
        np.testing.assert_allclose(per, rp, rtol=5e-7)
    _grads_close(res[0]["cls"][case][2], checkpoint.params_to_numpy(gv))


def test_classifier_sharded_forward_and_assisted(spawned):
    sv = ranks.classifier("vectorized")
    params = ranks.cls_params(sv, 2)
    xs, y = ranks.cls_batch(8, 3)
    with torch.no_grad():
        E_all = sv.local_embeds(params, xs)
    ga, La = sv.assisted_grads(params, xs, y, None)
    for r in _results(spawned):
        E, L, _ = r["assisted"]
        np.testing.assert_array_equal(E, E_all.numpy())
        np.testing.assert_array_equal(L, La.numpy())
    _grads_close(_results(spawned)[0]["assisted"][2],
                 checkpoint.params_to_numpy(ga))


def test_classifier_sharded_train_step(spawned):
    sv = ranks.classifier("vectorized")
    params = ranks.cls_params(sv, 4)
    xs, y = ranks.cls_batch(8, 5)
    init, step = sv.make_train_step("adam", 1e-3)
    params, _, total, per = step(params, init(params), xs, y, sv.masks(B, 0))
    for r in _results(spawned):
        np.testing.assert_array_equal(r["train"][0], total.numpy())
        np.testing.assert_array_equal(r["train"][1], per.numpy())
    # adam's first step is lr * g / |g|: updated params as the gradients
    _grads_close(_results(spawned)[0]["train"][2],
                 checkpoint.params_to_numpy(params))


def test_classifier_uneven_group_runs_replicated(spawned):
    """C = 6: two groups of 3 do not divide over 4 ranks, so each rank
    runs (and holds) every party, with the same results."""
    sv = ranks.classifier("vectorized", C=6)
    params = ranks.cls_params(sv, 6)
    xs, y = ranks.cls_batch(6, 7)
    with torch.no_grad():
        total, per = sv.loss_fn(params, xs, y, sv.masks(B, 1))
    for r in _results(spawned):
        t, p, sharded, held = r["uneven"]
        assert not sharded and held == list(range(6))
        np.testing.assert_array_equal(t, total.numpy())
        np.testing.assert_array_equal(p, per.numpy())


@pytest.mark.parametrize("mode", ["float", "int32"])
def test_mask_engine_rank_rows_bitexact(spawned, mode):
    """Each rank makes its own rows only, bit for bit those rows of the
    full tensor; K = 5 does not divide over 4 ranks: every row."""
    for r in _results(spawned):
        for K in (8, 5):
            full_eng = blinding.cached_mask_engine(K, 7)
            for rnd in ranks.MASK_ROUNDS:
                rows, got = r["masks"][(K, mode, rnd)]
                want = full_eng.masks((B, D), rnd, mode, device="cpu")
                assert rows == (list(range(r["rank"] * K // 4,
                                           (r["rank"] + 1) * K // 4))
                                if K == 8 else list(range(K)))
                np.testing.assert_array_equal(got, want[rows].numpy())


def test_uplink_payload_is_blinded(spawned):
    """By value: the uplink equals E_raw + r for every passive party and
    is exactly 0 for the active party; on every rank the embedding-shaped
    collectives are that uplink's gathers (each payload this rank's rows
    of it) and the one broadcast of the global embedding."""
    sv = ranks.classifier("vectorized")
    params = ranks.cls_params(sv, 10)
    xs, y = ranks.cls_batch(8, 11)
    masks = sv.masks(B, 2)
    with torch.no_grad():
        E_raw = sv.local_embeds(params, xs).numpy()
        E = sv.global_embed(torch.from_numpy(E_raw), masks).numpy()
        total, _ = sv.loss_fn(params, xs, y, masks)
    full = np.concatenate([np.zeros((1, B, D), np.float32), masks.numpy()])
    for r in _results(spawned):
        calls, up, own, t = r["audit"]
        np.testing.assert_array_equal(t, total.numpy())
        assert np.all(up[0] == 0.0), "the active party sends nothing"
        np.testing.assert_array_equal(up[1:], E_raw[1:] + full[1:])
        for k in range(1, 8):
            assert np.abs(up[k] - E_raw[k]).max() > 0.5
        embed_sized = [(op, x) for op, x in calls if x.shape[-2:] == (B, D)]
        gathers = [x for op, x in embed_sized if op == "all_gather"]
        assert [op for op, x in embed_sized if op != "all_gather"] == \
            ["broadcast"]
        assert len(gathers) == len(own)
        for rows, x in zip(own, gathers):
            want = np.stack([up[k] for k in rows])
            np.testing.assert_array_equal(x, want)
        np.testing.assert_array_equal(
            next(x for op, x in embed_sized if op == "broadcast"), E)
        # the rest: predictions (B, n_classes) and nothing else
        rest = [(op, x.shape) for op, x in calls
                if x.shape[-2:] != (B, D)]
        assert rest == [("all_gather", (1, B, N_CLS))] * len(own)


# ---------------------------------------------------------------------------
# the LM
# ---------------------------------------------------------------------------


def _lm_vectorized():
    sv = ranks.lm("vectorized")
    return sv, sv.init_params(torch.Generator().manual_seed(12))


def _jlm():
    """The reference EasterLM of ``ranks.lm``'s configuration."""
    return JLM(jcfg.smoke_variant(jcfg.get_config("qwen2.5-3b")),
               jcfg.EasterConfig(num_passive=4, d_embed=64,
                                 decision_layers=1))


@functools.lru_cache(maxsize=None)
def _ref_lm():
    """The reference's vectorized engine on the sharded LM's weights
    (drawn by the port, seed 12), each step jitted once: loss_fn at round
    0, masked and raw, and ``ranks.lm_serve``'s prefill and decode round,
    blinded and not."""
    _, params = _lm_vectorized()
    js = _jlm()
    jp = jax.tree.map(jnp.asarray, ranks.lm("loop").export_params(params))
    b = {k: jnp.asarray(v.numpy())
         for k, v in ranks.lm_batch(js.cfg.vocab_size).items()}
    out = {}
    seeds = js.mask_seeds()
    for tag, sd in (("masked", seeds), ("raw", None)):
        total, per = jax.jit(lambda p, bb: js.loss_fn(p, bb, jnp.int32(0),
                                                      sd))(jp, b)
        out[tag] = (np.asarray(total), np.asarray(per))
    toks = np.random.default_rng(15).integers(
        0, js.cfg.vocab_size, (2, 8)).astype(np.int32)
    for blinded in (True, False):
        sd = seeds if blinded else None
        E, c = jax.jit(lambda p, t, c0: js.prefill(
            p, t, c0, seeds=sd, round_idx=3))(jp, jnp.asarray(toks[:, :7]),
                                              js.init_caches(2, 8))
        lg, c = jax.jit(lambda p, t, c0: js.serve_step(p, t, c0, 7, sd))(
            jp, jnp.asarray(toks[:, 7:]), c)
        out[("serve", blinded)] = (np.asarray(E), np.asarray(lg),
                                   jax.tree.map(np.asarray, c))
    return out


def _lm_close(got, want):
    la, lb = tree_leaves(got), jax.tree.leaves(want)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   rtol=LM_RTOL, atol=LM_ATOL)


def test_lm_sharded_matches_reference(spawned):
    """The sharded LM on every rank against the reference's vectorized
    engine on the same weights, batch and seeds: the total and per-party
    losses, masked and raw, and the prefill E, decode logits and caches,
    blinded and not. (Its gradients are held against the port's
    vectorized engine below, which tests/test_torch_lm_train.py holds
    against the reference's.)"""
    ref = _ref_lm()
    res = _results(spawned)
    for tag in ("masked", "raw"):
        for r in res:
            _lm_close(r["lm"][tag], ref[tag])
    for blinded in (True, False):
        E, lg, caches = res[0]["lm"][("serve", blinded)]
        _lm_close((E, lg), ref[("serve", blinded)][:2])
        _lm_close(caches, ref[("serve", blinded)][2])


def test_lm_sharded_loss_bitexact(spawned):
    sv, params = _lm_vectorized()
    b = ranks.lm_batch(sv.cfg.vocab_size)
    res = _results(spawned)
    for tag, seeds in (("masked", sv.mask_seeds()), ("raw", None)):
        with torch.no_grad():
            total, per = sv.loss_fn(params, b, 0, seeds)
        for r in res:
            assert r["lm"]["shard_ok"]
            np.testing.assert_array_equal(r["lm"][tag][0], total.numpy())
            np.testing.assert_array_equal(r["lm"][tag][1], per.numpy())
    _, _, g = train_loop.loss_and_grads(sv, params, b, 0, sv.mask_seeds())
    _grads_close(res[0]["lm"]["grads"], checkpoint.params_to_numpy(g))


@pytest.mark.parametrize("blinded", [True, False])
def test_lm_serve_prefill_matches_loop_bitexact(spawned, blinded):
    """The sharded prefill and decode round reproduce the per-party loop
    oracle's (and the vectorized engine's) embeddings, logits and caches
    bit for bit; only the active party's rank gets E and the logits."""
    sl = ranks.lm("loop")
    sv, params = _lm_vectorized()
    lp = sl.load_params(sv.export_params(params))
    E_l, lg_l, c_l = ranks.lm_serve(sl, lp, blinded)
    E_v, lg_v, _ = ranks.lm_serve(sv, params, blinded)
    res = _results(spawned)
    E, lg, caches = res[0]["lm"][("serve", blinded)]
    for want in (E_l, E_v):
        np.testing.assert_array_equal(E, want.numpy())
    for want in (lg_l, lg_v):
        np.testing.assert_array_equal(lg, want.numpy())
    _equal_trees(caches, checkpoint.params_to_numpy(c_l))
    for r in res[1:]:
        assert r["lm"][("serve", blinded)][:2] == (None, None)


def test_lm_sharded_non_divisible_k_runs_replicated(spawned):
    """K = 3 does not divide over 4 ranks: every rank runs the vectorized
    engine on every party, with its loss."""
    sv = ranks.lm("vectorized", K=3)
    params = sv.init_params(torch.Generator().manual_seed(16))
    with torch.no_grad():
        total, _ = sv.loss_fn(params, ranks.lm_batch(sv.cfg.vocab_size), 0,
                              sv.mask_seeds())
    for r in _results(spawned):
        ok, t = r["lm3"]
        assert not ok
        np.testing.assert_array_equal(t, total.numpy())
