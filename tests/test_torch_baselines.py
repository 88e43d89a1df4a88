"""The port's baselines (Local, SplitVFL, C_VFL, AggVFL) and top-k uplink
compression in ``EasterClassifier``, held against the JAX reference.

Both packages get the same numpy inputs and weights in the reference's
tree layout, made from a seed (carried across by
``repro_torch.checkpoint``); the reference's steps run under ``jax.jit``. Runs on the CPU at small widths;
the kernels' plain versions stand in for the CUDA kernels here.

Tolerances, as in test_torch_protocol.py: float32 matmuls and reductions
run in another order in XLA than in torch, so after one adam step the
losses agree to rtol 1e-5 and the parameters to atol 5e-5 (adam's first
step is lr * g/|g|). ``_topk_sparsify`` and every ``bytes_per_round`` are
exact: the selection compares magnitudes, and the byte counts are integer
work done in the reference's order.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EasterConfig as JEasterConfig
from repro.core import baselines as jb
from repro.core import party_models as jpm
from repro.core.protocol import EasterClassifier as JClassifier
from repro_torch import checkpoint as tck
from repro_torch.configs.base import EasterConfig as TEasterConfig
from repro_torch.core import baselines as tb
from repro_torch.core import party_models as tpm
from repro_torch.core.protocol import EasterClassifier as TClassifier
from repro_torch.data import batch_iterator, make_dataset, vertical_partition

_C, _B, _D, _NCLS = 4, 16, 12, 5
_NF = [7, 6, 6, 5]
_WIDTHS = [(16, 8), (12,), (20, 10), (8,)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: one thread beats a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jarches():
    return [jpm.PartyArch("mlp", w, (w[-1],), _D, _NCLS) for w in _WIDTHS]


def _tarches():
    return [tpm.PartyArch(**vars(a)) for a in _jarches()]


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


def _numpy_params(init, seed):
    """Weights in the reference's tree layout, made by numpy from a seed:
    ``init`` is traced for its shapes only (no JAX RNG op is compiled)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape) / np.sqrt(s.shape[0])
                   ).astype(np.float32), jax.eval_shape(init))


def _batch(seed=0, nf=_NF):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(_B, f)).astype(np.float32) for f in nf]
    return xs, rng.integers(0, _NCLS, _B).astype(np.int32)


# ---------------------------------------------------------------------------
# top-k sparsification
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep", [0.25, 0.5, 0.01])
def test_topk_sparsify_matches(keep):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    # tied magnitudes at and around the threshold: every tie is kept
    x[0, 0] = [2, -2, 2, -2, 2, 1, -1, 1, 0.5, 0, 0, 0, -0.5, 1, 2, -1]
    x[1, 2] = 1.0
    x[2, 4, ::2] = -3.0
    w = rng.normal(size=x.shape).astype(np.float32)
    jx = jnp.asarray(x)
    want = np.asarray(jb._topk_sparsify(jx, keep))
    jgrad = jax.grad(lambda v: jnp.sum(jnp.asarray(w)
                                       * jb._topk_sparsify(v, keep)))(jx)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tb._topk_sparsify(tx, keep)
    (tgrad,) = torch.autograd.grad(torch.sum(torch.from_numpy(w) * got), tx)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    np.testing.assert_array_equal(tgrad.numpy(), np.asarray(jgrad))
    np.testing.assert_array_equal(tgrad.numpy(), w)       # straight through
    k = max(1, int(16 * keep))
    assert ((want != 0).sum(-1) >= k).all()
    # six magnitudes of 2 then five of 1: k = 1 or 4 keeps the six, 8 keeps
    # all eleven
    assert (want[0, 0] != 0).sum() == {1: 6, 4: 6, 8: 11}[k]


# ---------------------------------------------------------------------------
# bytes per round: integer work, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["float32", "int32", "int8"])
@pytest.mark.parametrize("frac", [0.0, 0.25])
def test_baseline_bytes_per_round_match(wire, frac):
    ja, ta = _jarches(), _tarches()
    pairs = [
        (jb.SplitVFL(ja, _NF, _NCLS, compress_frac=frac, wire_dtype=wire),
         tb.SplitVFL(ta, _NF, _NCLS, compress_frac=frac, wire_dtype=wire,
                     device="cpu")),
        (jb.AggVFL(ja, _NF, wire_dtype=wire),
         tb.AggVFL(ta, _NF, wire_dtype=wire, device="cpu")),
        (jb.LocalOnly(ja, _NF), tb.LocalOnly(ta, _NF, device="cpu")),
    ]
    for j, t in pairs:
        for batch in (1, 33, 128, 4096):
            assert t.bytes_per_round(batch) == j.bytes_per_round(batch), \
                (type(t).__name__, batch)


@pytest.mark.parametrize("mode", ["float", "int32", "int8"])
def test_compressed_classifier_bytes_and_ring_rejection(mode):
    ja, ta = _jarches(), _tarches()
    for frac in (0.0, 0.25, 0.1):
        jcfg = JEasterConfig(num_passive=_C - 1, d_embed=_D, mask_mode=mode)
        tcfg = TEasterConfig(num_passive=_C - 1, d_embed=_D, mask_mode=mode)
        if frac > 0 and mode != "float":
            with pytest.raises(AssertionError, match="no wire benefit"):
                JClassifier(jcfg, ja, _NF, compress_frac=frac)
            with pytest.raises(ValueError, match="no wire benefit"):
                TClassifier(tcfg, ta, _NF, compress_frac=frac, device="cpu")
            continue
        j = JClassifier(jcfg, ja, _NF, compress_frac=frac)
        t = TClassifier(tcfg, ta, _NF, compress_frac=frac, device="cpu")
        for batch in (1, 33, 128):
            assert t.bytes_per_round(batch) == j.bytes_per_round(batch)


# ---------------------------------------------------------------------------
# one train step of each method from the reference's weights
# ---------------------------------------------------------------------------

_METHODS = ["local", "split", "cvfl", "agg"]


def _methods(name):
    ja, ta = _jarches(), _tarches()
    if name == "local":
        return jb.LocalOnly(ja, _NF), tb.LocalOnly(ta, _NF, device="cpu")
    if name in ("split", "cvfl"):
        frac = 0.25 if name == "cvfl" else 0.0
        return (jb.SplitVFL(ja, _NF, _NCLS, top_hidden=24,
                            compress_frac=frac),
                tb.SplitVFL(ta, _NF, _NCLS, top_hidden=24,
                            compress_frac=frac, device="cpu"))
    return jb.AggVFL(ja, _NF), tb.AggVFL(ta, _NF, device="cpu")


def _step_both(jm, tm, seed=0):
    """One adam step of each package from the same weights; the
    reference's and the port's (params, total, per)."""
    npp = _numpy_params(lambda: jm.init_params(jax.random.PRNGKey(0)), seed)
    xs, y = _batch(seed)
    jinit, jstep = jb.make_train_step(jm, "adam", 1e-3)
    jp = jax.tree.map(jnp.asarray, npp)
    jp, _, jtot, jper = jstep(jp, jinit(jp), [jnp.asarray(x) for x in xs],
                              jnp.asarray(y), None)
    tinit, tstep = tb.make_train_step(tm, "adam", 1e-3)
    tp = tck.params_from_numpy(npp, "cpu")
    tp, _, ttot, tper = tstep(tp, tinit(tp), [torch.from_numpy(x)
                                               for x in xs],
                              torch.from_numpy(y), None)
    return (jp, jtot, jper), (tp, ttot, tper)


def _assert_step_close(j, t):
    (jp, jtot, jper), (tp, ttot, tper) = j, t
    np.testing.assert_allclose(float(ttot), float(jtot), rtol=1e-5)
    np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-5)
    jl, tl = _flat(jp), _flat(tck.params_to_numpy(tp))
    assert [a.shape for a in jl] == [a.shape for a in tl]
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(b, a, atol=5e-5)


@pytest.mark.parametrize("name", _METHODS)
def test_baseline_train_step_matches(name):
    jm, tm = _methods(name)
    _assert_step_close(*_step_both(jm, tm))
    # the port's own draw has the reference's tree layout
    own = tm.init_params(torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0)))
    assert [a.shape for a in jax.tree.leaves(ref)] == \
        [a.shape for a in _flat(tck.params_to_numpy(own))]


@pytest.mark.parametrize("name", _METHODS)
def test_baseline_accuracy_matches(name):
    jm, tm = _methods(name)
    npp = _numpy_params(lambda: jm.init_params(jax.random.PRNGKey(0)), 4)
    xs, y = _batch(7)
    ja = jm.accuracy(jax.tree.map(jnp.asarray, npp),
                     [jnp.asarray(x) for x in xs], jnp.asarray(y))
    ta = tm.accuracy(tck.params_from_numpy(npp, "cpu"),
                     [torch.from_numpy(x) for x in xs], torch.from_numpy(y))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    if name == "agg":
        args = (jax.tree.map(jnp.asarray, npp),
                [jnp.asarray(x) for x in xs], jnp.asarray(y))
        assert float(tm.aggregate_accuracy(
            tck.params_from_numpy(npp, "cpu"),
            [torch.from_numpy(x) for x in xs], torch.from_numpy(y))) == \
            float(jm.aggregate_accuracy(*args))


# ---------------------------------------------------------------------------
# EasterClassifier(compress_frac=0.25) against the reference
# ---------------------------------------------------------------------------

_EASTER_CASES = [("loop", False, "easter"), ("vectorized", False, "easter"),
                 ("vectorized", True, "easter"), ("loop", False, "joint")]


@pytest.mark.parametrize("engine,fused,grad_mode", _EASTER_CASES)
def test_compressed_easter_step_matches(engine, fused, grad_mode):
    ja, ta = _jarches(), _tarches()
    js = JClassifier(JEasterConfig(num_passive=_C - 1, d_embed=_D), ja, _NF,
                     engine=engine, fused_masks=fused, grad_mode=grad_mode,
                     compress_frac=0.25)
    ts = TClassifier(TEasterConfig(num_passive=_C - 1, d_embed=_D), ta, _NF,
                     engine=engine, fused_masks=fused, grad_mode=grad_mode,
                     compress_frac=0.25, device="cpu")
    npp = _numpy_params(lambda: js.init_params(jax.random.PRNGKey(0)), 2)
    xs, y = _batch(3)
    # float masks: the port's, handed to the reference; fused: each
    # package makes its own (they agree to ~1e-6 and cancel either way)
    tm = ts.masks(_B, 1)
    jm = js.masks(_B, 1) if fused else jnp.asarray(tm.numpy())
    jinit, jstep = js.make_train_step("adam", 1e-3)
    tinit, tstep = ts.make_train_step("adam", 1e-3)
    jp = jax.tree.map(jnp.asarray, npp)
    jp, _, jtot, jper = jstep(jp, jinit(jp), [jnp.asarray(x) for x in xs],
                              jnp.asarray(y), jm)
    tp = tck.params_from_numpy(npp, "cpu")
    tp, _, ttot, tper = tstep(tp, tinit(tp), [torch.from_numpy(x)
                                               for x in xs],
                              torch.from_numpy(y), tm)
    _assert_step_close((jp, jtot, jper), (tp, ttot, tper))
    # the passive uplink is sparse: 3 of the 12 columns of each row kept
    E_all = ts.local_embeds(tck.params_from_numpy(npp, "cpu"),
                            [torch.from_numpy(x) for x in xs])
    assert ((E_all[1:] != 0).sum(-1) == 3).all()
    assert ((E_all[0] != 0).sum(-1) == _D).all()


# ---------------------------------------------------------------------------
# the reference's system tests of the baselines, on the port
# (tests/test_system.py: data sizes, step counts and thresholds unchanged)
# ---------------------------------------------------------------------------


def _train(method, params, ds, C, steps=80, lr=1e-3, batch=64,
           masks_fn=None):
    init_opt, step = tb.make_train_step(method, "adam", lr)
    opt_state = init_opt(params)
    it = batch_iterator(ds.x_train, ds.y_train, batch, seed=0)
    for i in range(steps):
        xb, yb = next(it)
        xs = [torch.from_numpy(v)
              for v in vertical_partition(xb, C, ds.image_hw)]
        m = masks_fn(batch, i) if masks_fn else None
        params, opt_state, _, _ = step(params, opt_state, xs,
                                       torch.from_numpy(yb), m)
    xs_te = [torch.from_numpy(v)
             for v in vertical_partition(ds.x_test, C, ds.image_hw)]
    return params, method.accuracy(params, xs_te,
                                   torch.from_numpy(ds.y_test)).numpy()


@functools.lru_cache(maxsize=None)
def _ds():
    return make_dataset("mnist_like", n_train=2048, n_test=512, seed=0)


def _mlp_arches(C, n_cls, d_embed=64):
    widths = [(128, 64), (256, 128), (64, 32), (96, 64)]
    return [tpm.PartyArch("mlp", widths[k % 4], (64,), d_embed, n_cls)
            for k in range(C)]


def _nf(ds, C):
    return [v.shape[-1]
            for v in vertical_partition(ds.x_train[:1], C, ds.image_hw)]


def _easter(arches, nf, C, **kw):
    return TClassifier(TEasterConfig(num_passive=C - 1, d_embed=64), arches,
                       nf, device="cpu", **kw)


def test_baselines_rank_order():
    """Table II's qualitative orderings on the synthetic stand-in: EASTER's
    per-party models see the global embedding and break the alias of each
    party's slice; AggVFL's per-party models stay capped."""
    ds, C = _ds(), 4
    nf, arches = _nf(ds, C), _mlp_arches(C, ds.n_classes)
    res = {}
    easter = _easter(arches, nf, C)
    p = easter.init_params(torch.Generator().manual_seed(3))
    res["easter"] = _train(easter, p, ds, C,
                           masks_fn=easter.masks)[1].mean()
    agg = tb.AggVFL(arches, nf, device="cpu")
    p_agg = None
    for name, m in [("split", tb.SplitVFL(arches, nf, ds.n_classes,
                                          device="cpu")),
                    ("agg", agg),
                    ("local", tb.LocalOnly(arches, nf, device="cpu"))]:
        p = m.init_params(torch.Generator().manual_seed(3))
        p_tr, acc = _train(m, p, ds, C)
        res[name] = acc.mean()
        if name == "agg":
            p_agg = p_tr
    assert res["easter"] > res["local"]
    assert res["split"] > res["local"]
    # EASTER per-party models beat AggVFL per-party models (the +7.22% claim)
    assert res["easter"] > res["agg"] + 0.05, res
    # ...although AggVFL's *aggregated* prediction is collaborative and fine
    xs_te = [torch.from_numpy(v)
             for v in vertical_partition(ds.x_test, C, ds.image_hw)]
    agg_acc = float(agg.aggregate_accuracy(p_agg, xs_te,
                                           torch.from_numpy(ds.y_test)))
    assert agg_acc > res["local"]


def test_cvfl_compression_reduces_bytes():
    arches = _mlp_arches(4, 10)
    nf = [8, 8, 8, 8]
    full = tb.SplitVFL(arches, nf, 10, device="cpu")
    comp = tb.SplitVFL(arches, nf, 10, compress_frac=0.25, device="cpu")
    assert comp.bytes_per_round(128) < full.bytes_per_round(128)


def test_compressed_easter_ablation():
    """Beyond-paper: C_VFL-style top-k compression of EASTER's uplink
    embeddings: wire bytes drop ~2x at 25% keep, at a modest accuracy
    cost."""
    ds, C = _ds(), 4
    nf, arches = _nf(ds, C), _mlp_arches(C, ds.n_classes)
    full = _easter(arches, nf, C)
    comp = _easter(arches, nf, C, compress_frac=0.25)
    assert comp.bytes_per_round(128) < full.bytes_per_round(128)
    p = comp.init_params(torch.Generator().manual_seed(5))
    _, acc = _train(comp, p, ds, C, masks_fn=comp.masks)
    assert acc.mean() > 0.8  # compression costs little on this task
