"""The port's vectorized party engine against its loop engine and against
the JAX reference's vectorized engine.

Two configurations: the paper's Table II zoo at C = 4 (the heterogeneous
MLPs ``chip_smoke.py`` drives, narrowed to d_embed 16) and the many-party
benchmark's ``mlp_zoo`` at C = 16 (``benchmarks/many_party_scaling.py``,
64 features split over the parties). Both packages get numpy weights,
features, labels and masks made from one seed; the reference's functions
run under one ``jax.jit`` per configuration.

Tolerances: the port's vectorized engine runs each group as one batched
matmul where the loop engine runs one matmul per party; on this CPU the
two agree bit for bit, and are held to rtol 1e-6. Against the reference
(XLA's float32 matmuls and reductions run in another order): losses and
logits rtol 1e-5, gradients rtol 1e-4 + atol 1e-6, parameters after adam
atol 5e-5 (adam's first step is lr * g/|g|), as in test_torch_protocol.py.
"""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs.base import EasterConfig as JEasterConfig
from repro.core import party_engine as jpe
from repro.core import party_models as jpm
from repro.core.protocol import EasterClassifier as JClassifier
from repro_torch import checkpoint as tck
from repro_torch import optim as toptim
from repro_torch.configs.base import EasterConfig as TEasterConfig
from repro_torch.core import blinding as tb
from repro_torch.core import party_engine as tpe
from repro_torch.core import party_models as tpm
from repro_torch.core.protocol import EasterClassifier as TClassifier
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

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_B, _NCLS = 8, 5


def _import(name, where):
    saved = list(sys.path)
    sys.path[:0] = [where, _ROOT]
    try:
        return __import__(name)
    finally:
        sys.path[:] = saved


def _config(zoo):
    if zoo == "table2":
        arches = _import("chip_smoke", _ROOT).table2_arches(4, _NCLS, 16)
        nf = [196] * 4
    else:
        mps = _import("many_party_scaling", os.path.join(_ROOT, "benchmarks"))
        arches = mps.mlp_zoo(16, _NCLS, 16)
        # chip_smoke.py drives its own copy of the benchmark's zoo
        own = _import("chip_smoke", _ROOT).mlp_zoo(16, _NCLS, 16)
        assert [tuple(vars(a).values()) for a in own] == \
            [tuple(vars(a).values()) for a in arches]
        nf = [v.shape[-1] for v in mps.split_features(jnp.zeros((1, 64)),
                                                      16)]
    return [tpm.PartyArch(**vars(a)) for a in arches], nf


@functools.lru_cache(maxsize=None)
def _setup(zoo):
    """(port vectorized, port loop, numpy weights, features, labels,
    masks, reference outputs). The masks are the port's MaskEngine masks,
    handed to both packages. The reference's forward, losses, gradients,
    one adam step and assisted gradients come from one jitted function."""
    tarches, nf = _config(zoo)
    C = len(tarches)
    jarches = [jpm.PartyArch(**vars(a)) for a in tarches]
    js = JClassifier(JEasterConfig(num_passive=C - 1, d_embed=16), jarches,
                     nf)
    cfg = TEasterConfig(num_passive=C - 1, d_embed=16)
    tv = TClassifier(cfg, tarches, nf, device="cpu")
    tl = TClassifier(cfg, tarches, nf, engine="loop", device="cpu")
    rng = np.random.default_rng(C)
    shapes = jax.eval_shape(lambda: js.init_params(jax.random.PRNGKey(0)))
    npp = jax.tree.map(lambda s: (rng.normal(size=s.shape) / np.sqrt(
        s.shape[0])).astype(np.float32), shapes)
    xs = [rng.normal(size=(_B, f)).astype(np.float32) for f in nf]
    y = rng.integers(0, _NCLS, _B).astype(np.int32)
    masks = tv.masks(_B, 1).numpy()
    jinit, _ = js.make_train_step("adam", 1e-3)
    opts = joptim.resolve_party_optimizers({}, C, default=("adam", 1e-3,
                                                           None))

    def reference(p, xs, y, m):
        E, R = js.forward(p, xs, m)
        (tot, per), g = jax.value_and_grad(js.loss_fn, has_aux=True)(
            p, xs, y, m)
        # the body of the reference's vectorized train step
        stepped, _ = js._eng.update_groups(opts, g, jinit(p), p)
        return E, R, tot, per, g, stepped, js.assisted_grads(p, xs, y, m)

    out = jax.jit(reference)(*_jax_in(npp, xs, y, masks))
    return tv, tl, npp, xs, y, masks, out


def _torch_in(npp, xs, y, masks):
    return (tck.params_from_numpy(npp, "cpu"),
            [torch.from_numpy(x) for x in xs], torch.from_numpy(y),
            torch.from_numpy(masks))


def _jax_in(npp, xs, y, masks):
    return (jax.tree.map(jnp.asarray, npp), [jnp.asarray(x) for x in xs],
            jnp.asarray(y), jnp.asarray(masks))


def _close(got, want, rtol, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


ZOOS = ["table2", "mlp_zoo16"]


@pytest.mark.parametrize("zoo", ZOOS)
def test_groups_match_reference(zoo):
    tarches, nf = _config(zoo)
    je = jpe.PartyEngine([jpm.PartyArch(**vars(a)) for a in tarches], nf)
    te = tpe.PartyEngine(tarches, nf)
    assert [idx for _, idx in te.groups] == [idx for _, idx in je.groups]
    assert te.n_groups == je.n_groups
    assert te._perm.tolist() == np.asarray(je._perm).tolist()
    assert tpe.group_by("abacb") == jpe.group_by("abacb")
    trees = [{"a": torch.full((2,), float(i)), "b": [torch.ones(3) * i]}
             for i in range(3)]
    back = tpe.unstack_tree(tpe.stack_trees(trees), 3)
    for t, u in zip(trees, back):
        for a, b in zip(tree_leaves(t), tree_leaves(u)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("zoo", ZOOS)
def test_forward_and_losses_match(zoo):
    tv, tl, npp, xs, y, masks, (jE, jR, jtot, jper, *_) = _setup(zoo)
    tp, txs, ty, tm = _torch_in(npp, xs, y, masks)
    E_v, R_v = tv.forward(tp, txs, tm)
    E_l, R_l = tl.forward(tp, txs, tm)
    _close(E_v, E_l.detach(), 1e-6)
    _close(E_v, jE, 1e-5, 1e-6)
    for a, b, c in zip(R_v, R_l, jR):
        _close(a, b.detach(), 1e-6)
        _close(a, c, 1e-5, 1e-6)
    tot, per = tv.loss_fn(tp, txs, ty, tm)
    _close(per, tl.loss_fn(tp, txs, ty, tm)[1].detach(), 1e-6)
    _close(per, jper, 1e-5)
    _close(tot, jtot, 1e-5)


@pytest.mark.parametrize("zoo", ZOOS)
def test_grads_and_adam_step_match(zoo):
    """Gradients of the summed loss, then one adam step: the port's
    vectorized step (update_groups) against its loop step and against the
    reference's vectorized step body (value_and_grad, update_groups)."""
    tv, tl, npp, xs, y, masks, (_, _, _, jper, jg, jp2, _) = _setup(zoo)
    tp, txs, ty, tm = _torch_in(npp, xs, y, masks)
    tg = torch.autograd.grad(tv.loss_fn(tp, txs, ty, tm)[0], tree_leaves(tp))
    lg = torch.autograd.grad(tl.loss_fn(tp, txs, ty, tm)[0], tree_leaves(tp))
    for a, b, c in zip(tg, lg, jax.tree.leaves(jg)):
        _close(a, b, 1e-6)
        _close(a, c, 1e-4, 1e-6)
    after = []
    for sys_ in (tv, tl):
        tp, txs, ty, tm = _torch_in(npp, xs, y, masks)
        init, step = sys_.make_train_step("adam", 1e-3)
        tp, _, _, per = step(tp, init(tp), txs, ty, tm)
        _close(per, jper, 1e-5)
        after.append(tck.params_to_numpy(tp))
    for v, l, j in zip(jax.tree.leaves(after[0]), jax.tree.leaves(after[1]),
                       jax.tree.leaves(jp2)):
        _close(v, l, 1e-6)
        _close(v, j, 0, 5e-5)


@pytest.mark.parametrize("zoo", ZOOS)
def test_assisted_grads_match(zoo):
    tv, tl, npp, xs, y, masks, (*_, (jg, jl)) = _setup(zoo)
    tp, txs, ty, tm = _torch_in(npp, xs, y, masks)
    gv, lv = tv.assisted_grads(tp, txs, ty, tm)
    gl, ll = tl.assisted_grads(tp, txs, ty, tm)
    _close(lv, ll, 1e-6)
    _close(lv, jl, 1e-5)
    for a, b, c in zip(tree_leaves(gv), tree_leaves(gl), jax.tree.leaves(jg)):
        _close(a, b, 1e-6)
        _close(a, c, 1e-4, 1e-6)
    # the message-passing round equals autograd through the surrogate
    total, _ = tv.loss_fn(tp, txs, ty, tm)
    for a, b in zip(torch.autograd.grad(total, tree_leaves(tp)),
                    tree_leaves(gv)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_update_groups_two_optimizers_in_one_group():
    """One execution group (identical arches and slices) under two
    optimizers: the engine splits it into two stacked updates. Each party
    clips by its own global norm (grad_clip 0.05 bites for some parties
    and not others). Equal to the per-party loop and to the reference's
    update_groups."""
    C = 6
    arches = [tpm.PartyArch("mlp", (12,), (8,), 6, 3)] * C
    nf = [5] * C
    te = tpe.PartyEngine(arches, nf)
    je = jpe.PartyEngine([jpm.PartyArch(**vars(a)) for a in arches], nf)
    assert te.n_groups == 1
    specs = {1: ("momentum", 0.05, {"grad_clip": 0.05}),
             4: ("momentum", 0.05, {"grad_clip": 0.05})}
    default = ("adam", 1e-2, {"grad_clip": 0.05})
    topts = toptim.resolve_party_optimizers(specs, C, default=default)
    jopts = joptim.resolve_party_optimizers(specs, C, default=default)
    rng = np.random.default_rng(11)
    shapes = jax.eval_shape(lambda: [jpm.init_party(
        jax.random.PRNGKey(0), jpm.PartyArch(**vars(a)), f)
        for a, f in zip(arches, nf)])
    npp = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                       shapes)
    ngs = [jax.tree.map(lambda s, k=k: (rng.normal(size=s.shape)
                                        * (0.01 if k % 2 else 1.0)
                                        ).astype(np.float32), shapes[k])
           for k in range(C)]
    # reference: two rounds of update_groups
    jp = jax.tree.map(jnp.asarray, npp)
    js = [o.init(p) for o, p in zip(jopts, jp)]
    jupdate = jax.jit(lambda g, s, p: je.update_groups(jopts, g, s, p))
    for _ in range(2):
        jp, js = jupdate([jax.tree.map(jnp.asarray, g) for g in ngs], js, jp)
    # port: the engine, and the per-party loop
    out = []
    for grouped in (True, False):
        tp = tck.params_from_numpy(npp, "cpu")
        ts = [o.init(p) for o, p in zip(topts, tp)]
        tg = [tck.params_from_numpy(g, "cpu", requires_grad=False)
              for g in ngs]
        for _ in range(2):
            if grouped:
                te.update_groups(topts, tg, ts, tp)
            else:
                for k in range(C):
                    topts[k].update(tg[k], ts[k], tp[k])
        out.append((tp, ts))
    for a, b, c in zip(tree_leaves(out[0][0]), tree_leaves(out[1][0]),
                       jax.tree.leaves(jp)):
        _close(a, b.detach(), 1e-6)
        _close(a, c, 1e-5, 1e-6)
    for a, b in zip(tree_leaves(out[0][1]), tree_leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


def test_irregular_groups_match_loop():
    """Groups whose members are not evenly spaced (gathered by an index
    tensor), evenly spaced (a strided view), a group of one party (its own
    net, no vmap) and a one-party optimizer subgroup (updated in place):
    forward, losses and one train step equal the port's loop engine
    within rtol 1e-5 + atol 1e-6 (at these widths the batched matmul of a
    group and the per-party matmuls round differently, by 8e-8 here)."""
    a = tpm.PartyArch("mlp", (12,), (8,), 6, 3)
    b = tpm.PartyArch("mlp", (10, 6), (6,), 6, 3)
    c = tpm.PartyArch("mlp", (7,), (5,), 6, 3)
    arches, nf = [a, b, a, a, b, c], [4] * 6
    cfg = TEasterConfig(num_passive=5, d_embed=6)
    tv = TClassifier(cfg, arches, nf, device="cpu")
    tl = TClassifier(cfg, arches, nf, engine="loop", device="cpu")
    assert [idx for _, idx in tv._eng.groups] == [(0, 2, 3), (1, 4), (5,)]
    assert not tv._eng._in_order
    assert isinstance(tv._eng._sel[0], torch.Tensor)
    assert tv._eng._sel[1] == slice(1, 5, 3)
    rng = np.random.default_rng(5)
    npp = tck.params_to_numpy(tv.init_params(torch.Generator().manual_seed(5)))
    xs = [torch.from_numpy(rng.normal(size=(_B, 4)).astype(np.float32))
          for _ in nf]
    y = torch.from_numpy(rng.integers(0, 3, _B))
    m = tv.masks(_B, 2)
    tp = tck.params_from_numpy(npp, "cpu")
    E_v, R_v = tv.forward(tp, xs, m)
    E_l, R_l = tl.forward(tp, xs, m)
    _close(E_v, E_l.detach(), 1e-5, 1e-6)
    for r_v, r_l in zip(R_v, R_l):
        _close(r_v, r_l.detach(), 1e-5, 1e-6)
    after = []
    for sys_ in (tv, tl):
        tp = tck.params_from_numpy(npp, "cpu")
        init, step = sys_.make_train_step(
            "adam", 1e-2, party_optimizers={2: ("sgd", 0.1, {})})
        tp, _, _, per = step(tp, init(tp), xs, y, m)
        after.append((tp, per))
    _close(after[0][1], after[1][1], 1e-5, 1e-6)
    for v, l in zip(tree_leaves(after[0][0]), tree_leaves(after[1][0])):
        _close(v, l.detach(), 1e-5, 1e-6)


def test_vectorized_is_the_default_engine():
    arches = [tpm.PartyArch("mlp", (8,), (8,), 4, 3)] * 3
    ts = TClassifier(TEasterConfig(num_passive=2, d_embed=4), arches,
                     [2, 2, 2], device="cpu")
    assert ts.engine == "vectorized" == JClassifier.engine
    assert isinstance(ts.mask_engine, tb.MaskEngine)
    assert ts._eng.n_groups == 1
