"""The PyTorch port's training round held against the JAX reference.

Both packages get the same inputs: numpy arrays made from a seed, weights
in the reference's tree layout (carried across by
``repro_torch.checkpoint``) and the reference's masks. Runs on the CPU at small widths; the kernels'
plain versions stand in for the CUDA kernels here.

Tolerances: float32 matmuls, convolutions and reductions run in another
order in XLA than in torch (different blocking), so single forward values
agree to ~1e-6 relative. Over three adam rounds the loss agrees to rtol
1e-5 and the parameters to atol 5e-5 (adam's first steps are lr * g/|g|,
which carries a gradient's relative error straight into the update).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EasterConfig as JEasterConfig
from repro.core import party_models as jpm
from repro.core import losses as jlosses
from repro.core.protocol import EasterClassifier as JClassifier
from repro import data as jdata
from repro.data import pipeline as jpipeline
from repro import optim as joptim

from repro_torch import checkpoint as tck
from repro_torch import data as tdata
from repro_torch import optim as toptim
from repro_torch.configs.base import EasterConfig as TEasterConfig
from repro_torch.core import losses as tlosses
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


def _numpy_params(init, seed):
    """Weights in the reference's tree layout, made by numpy from a seed:
    ``init`` is traced for its shapes only (no JAX RNG op is compiled)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init)
    return jax.tree.map(
        lambda s: (rng.normal(size=s.shape)
                   / np.sqrt(s.shape[0] if len(s.shape) == 2 else 9)
                   ).astype(np.float32), shapes)


def _flat(tree):
    return [np.asarray(a) for a in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# data: byte-identical copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["mnist_like", "criteo_like"])
def test_data_byte_identical(name):
    a = jdata.make_dataset(name, n_train=64, n_test=16, seed=3)
    b = tdata.make_dataset(name, n_train=64, n_test=16, seed=3)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.n_classes, a.image_hw) == (b.n_classes, b.image_hw)
    C = 4
    for u, v in zip(jpipeline.vertical_partition(a.x_train, C, a.image_hw),
                    tdata.vertical_partition(b.x_train, C, b.image_hw)):
        assert u.tobytes() == v.tobytes()
    if a.image_hw[0]:
        assert (jpipeline.slice_hw(a.image_hw, C)
                == tdata.slice_hw(b.image_hw, C) == [(28, 7)] * 4)
    ja = jpipeline.batch_iterator(a.x_train, a.y_train, 16, seed=5)
    tb = tdata.batch_iterator(b.x_train, b.y_train, 16, seed=5)
    for _ in range(6):                      # crosses an epoch boundary
        (x1, y1), (x2, y2) = next(ja), next(tb)
        assert x1.tobytes() == x2.tobytes() and y1.tobytes() == y2.tobytes()


def test_table2_arches_match_benchmark_harness():
    """chip_smoke.py drives the Table II parties the accuracy benchmarks
    build."""
    saved = list(sys.path)
    sys.path[:0] = [os.path.join(_ROOT, "benchmarks"), _ROOT]
    try:
        import chip_smoke
        import harness
    finally:
        sys.path[:] = saved
    for C in (2, 4, 5):
        ja = harness.hetero_arches(C, 10, 128)
        ta = chip_smoke.table2_arches(C, 10, 128)
        assert [tuple(vars(a).values()) for a in ja] == \
            [tuple(vars(a).values()) for a in ta]


# ---------------------------------------------------------------------------
# party models and losses from the same weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,hw", [("mlp", (0, 0)), ("cnn", (8, 3)),
                                     ("lenet", (28, 7)), ("cnn", (7, 5))])
def test_party_models_match(kind, hw):
    """Odd heights and widths exercise the SAME max-pool's -inf edge."""
    arch = jpm.PartyArch(kind, (6, 8) if kind != "mlp" else (20, 12),
                         (16,), 12, 5, hw)
    tarch = tpm.PartyArch(**vars(arch))
    nf = hw[0] * hw[1] if kind != "mlp" else 17
    npp = _numpy_params(
        lambda: jpm.init_party(jax.random.PRNGKey(1), arch, nf), 1)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = tck.params_from_numpy(npp, "cpu")
    x = np.random.default_rng(0).normal(size=(5, nf)).astype(np.float32)
    je = jax.jit(jpm.embed_fn, static_argnums=1)(jp, arch, jnp.asarray(x))
    te = tpm.embed_fn(tp, tarch, torch.from_numpy(x))
    np.testing.assert_allclose(te.detach().numpy(), np.asarray(je),
                               rtol=1e-5, atol=1e-5)
    jd = jax.jit(jpm.decide_fn, static_argnums=1)(jp, arch, je)
    td = tpm.decide_fn(tp, tarch, torch.from_numpy(np.asarray(je)))
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd),
                               rtol=1e-5, atol=1e-5)
    # the port's own init gives the reference's shapes
    own = tpm.init_party(torch.Generator().manual_seed(0), tarch, nf)
    assert [a.shape for a in _flat(npp)] == \
        [a.shape for a in _flat(tck.params_to_numpy(own))]


def test_losses_match():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(6, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 6).astype(np.int32)
    probs = rng.uniform(size=6).astype(np.float32)
    blab = rng.integers(0, 2, 6).astype(np.int32)
    for name, a, b in (("ce", logits, labels), ("bce", probs, blab),
                       ("mse", logits, logits[::-1].copy())):
        want = float(jlosses.LOSSES[name](jnp.asarray(a), jnp.asarray(b)))
        got = float(tlosses.LOSSES[name](torch.from_numpy(a),
                                         torch.from_numpy(b)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), name


# ---------------------------------------------------------------------------
# optimizers: one update from identical grads and states
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 0.1}), ("momentum", {}),
    ("adagrad", {"grad_clip": 0.5}), ("adam", {}),
    ("adam", {"weight_decay": 0.01, "grad_clip": 1.0}),
])
def test_optimizer_update_matches(name, kw):
    rng = np.random.default_rng(4)
    p = {"a": rng.normal(size=(4, 3)).astype(np.float32),
         "b": [rng.normal(size=(3,)).astype(np.float32)]}
    g = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), p)
    jo = joptim.make_optimizer(name, 0.05, **kw)
    to = toptim.make_optimizer(name, 0.05, **kw)
    jp, js = jax.tree.map(jnp.asarray, p), None
    js = jo.init(jp)
    tp = tck.params_from_numpy(p, "cpu")
    ts = to.init(tp)
    for _ in range(2):
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(tck.params_from_numpy(g, "cpu",
                                                 requires_grad=False), ts, tp)
    for a, b in zip(_flat(jp), _flat(tck.params_to_numpy(tp))):
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7)


def test_party_optimizer_spec():
    spec = "0=sgd:0.01,2=momentum:0.01:momentum=0.8"
    assert toptim.parse_party_spec(spec) == joptim.parse_party_spec(spec)
    opts = toptim.resolve_party_optimizers(toptim.parse_party_spec(spec), 4)
    assert [o.name for o in opts] == ["sgd", "adam", "momentum", "adam"]
    assert opts[1] is opts[3]
    po = toptim.make_party_optimizers({1: ("sgd", 0.5)}, 2)
    params = [{"w": torch.ones(2)}, {"w": torch.ones(2)}]
    state = po.init(params)
    po.update([{"w": torch.ones(2)}, {"w": torch.ones(2)}], state, params)
    assert torch.allclose(params[1]["w"], torch.full((2,), 0.5))


# ---------------------------------------------------------------------------
# the slice: EasterClassifier rounds, JAX weights and masks carried across
# ---------------------------------------------------------------------------

_C, _B, _D, _NCLS = 4, 16, 12, 5
_NF = [7, 6, 6, 5]
_WIDTHS = [(16, 8), (12,), (20, 10), (8,)]


def _pair(grad_mode, use_kernel):
    """The reference with its Pallas kernel (interpret mode) on or off, and
    the port, whose aggregation always goes through its kernel dispatcher
    (the plain version, for these CPU tensors)."""
    arches = [jpm.PartyArch("mlp", w, (w[-1],), _D, _NCLS) for w in _WIDTHS]
    jcfg = JEasterConfig(num_passive=_C - 1, d_embed=_D)
    js = JClassifier(jcfg, arches, _NF, grad_mode=grad_mode, engine="loop",
                     use_kernel=use_kernel)
    ts = TClassifier(TEasterConfig(num_passive=_C - 1, d_embed=_D),
                     [tpm.PartyArch(**vars(a)) for a in arches], _NF,
                     grad_mode=grad_mode, engine="loop", device="cpu")
    return js, ts


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        xs = [rng.normal(size=(_B, f)).astype(np.float32) for f in _NF]
        yield xs, rng.integers(0, _NCLS, _B).astype(np.int32)


@pytest.mark.parametrize("grad_mode", ["easter", "joint"])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_slice_three_rounds_match(grad_mode, use_kernel):
    js, ts = _pair(grad_mode, use_kernel)
    npp = _numpy_params(lambda: js.init_params(jax.random.PRNGKey(0)), 0)
    jparams = jax.tree.map(jnp.asarray, npp)
    tparams = tck.params_from_numpy(npp, "cpu")
    jmasks = jax.jit(lambda r: js.masks(_B, r))
    jinit, jstep = js.make_train_step("adam", 1e-3)
    tinit, tstep = ts.make_train_step("adam", 1e-3)
    jstate, tstate = jinit(jparams), tinit(tparams)
    for i, (xs, y) in enumerate(_batches(3)):
        jm = jmasks(i)
        tm = torch.from_numpy(np.asarray(jm))
        jparams, jstate, _, jper = jstep(
            jparams, jstate, [jnp.asarray(x) for x in xs], jnp.asarray(y), jm)
        tparams, tstate, _, tper = tstep(
            tparams, tstate, [torch.from_numpy(x) for x in xs],
            torch.from_numpy(y), tm)
        np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-5)
    for a, b in zip(_flat(jparams), _flat(tck.params_to_numpy(tparams))):
        np.testing.assert_allclose(b, a, atol=5e-5)


def test_assisted_grads_equal_autograd():
    _, ts = _pair("easter", False)
    params = ts.init_params(torch.Generator().manual_seed(3))
    xs, y = next(_batches(1, seed=2))
    xs = [torch.from_numpy(x) for x in xs]
    y = torch.from_numpy(y)
    masks = ts.masks(_B, 0)
    total, per = ts.loss_fn(params, xs, y, masks)
    auto = torch.autograd.grad(total, tree_leaves(params))
    assisted, per_a = ts.assisted_grads(params, xs, y, masks)
    torch.testing.assert_close(per_a, per.detach(), rtol=1e-6, atol=1e-6)
    for a, b in zip(auto, tree_leaves(assisted)):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_accuracy_matches():
    js, ts = _pair("easter", True)
    npp = _numpy_params(lambda: js.init_params(jax.random.PRNGKey(1)), 1)
    jparams = jax.tree.map(jnp.asarray, npp)
    tparams = tck.params_from_numpy(npp, "cpu")
    xs, y = next(_batches(1, seed=9))
    ja = js.accuracy(jparams, [jnp.asarray(x) for x in xs], jnp.asarray(y))
    ta = ts.accuracy(tparams, [torch.from_numpy(x) for x in xs],
                     torch.from_numpy(y))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


def test_bytes_per_round_float():
    arches = [tpm.PartyArch("mlp", (32,), (16,), 64, 10)] * 4
    ts = TClassifier(TEasterConfig(num_passive=3, d_embed=64), arches,
                     [196] * 4, device="cpu")
    assert ts.bytes_per_round(32) == 56_832
    js = JClassifier(JEasterConfig(num_passive=3, d_embed=64),
                     [jpm.PartyArch(**vars(a)) for a in arches], [196] * 4,
                     engine="loop")
    assert js.bytes_per_round(32) == ts.bytes_per_round(32)


def test_entry_points_default_to_the_card():
    arches = [tpm.PartyArch("mlp", (8,), (8,), 4, 3)] * 3
    cfg = TEasterConfig(num_passive=2, d_embed=4)
    if torch.cuda.is_available():
        assert TClassifier(cfg, arches, [2, 2, 2]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TClassifier(cfg, arches, [2, 2, 2])
    # the sharded engine needs the ranks' party group
    with pytest.raises(RuntimeError, match="torchrun"):
        TClassifier(cfg, arches, [2, 2, 2], device="cpu", engine="sharded")
    # the vectorized engine (the default), in-kernel masks, the ring wires
    # and top-k compression are ported; fused masks keep the reference's
    # two conditions
    assert TClassifier(cfg, arches, [2, 2, 2], compress_frac=0.25,
                       device="cpu").compress_frac == 0.25
    assert TClassifier(cfg, arches, [2, 2, 2], fused_masks=True,
                       device="cpu").engine == "vectorized"
    int8 = TEasterConfig(num_passive=2, d_embed=4, mask_mode="int8")
    assert TClassifier(int8, arches, [2, 2, 2], device="cpu").masks(
        3, 0).dtype == torch.int8
    with pytest.raises(ValueError, match="float-mode only"):
        TClassifier(int8, arches, [2, 2, 2], fused_masks=True, device="cpu")
    with pytest.raises(ValueError, match="vectorized engine"):
        TClassifier(cfg, arches, [2, 2, 2], fused_masks=True, engine="loop",
                    device="cpu")


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys; import repro_torch.core.protocol, "
            "repro_torch.checkpoint, repro_torch.data, repro_torch.kernels.ops, "
            "repro_torch.core.easter_lm, repro_torch.core.serving, "
            "repro_torch.launch.serve, repro_torch.models.build, "
            "repro_torch.models.griffin, repro_torch.kernels.rg_lru, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.launch.train, repro_torch.core.baselines, "
            "repro_torch.core.wire, repro_torch.launch.mesh, "
            "repro_torch.core.party_group, "
            "repro_torch.launch.steps, repro_torch.launch.dryrun, "
            "repro_torch.sharding, "
            "repro_torch.data.pipeline; "
            "from repro_torch.configs.base import list_archs; list_archs(); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
