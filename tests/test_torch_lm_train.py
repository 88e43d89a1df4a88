"""The port's EasterLM training (``loss_fn``, ``core/train_loop.py``,
``Trainer``, ``checkpoint.save``/``restore``, ``launch/train.py``) against
the JAX reference, on the CPU.

The weights are the port's ``init_params`` from a seeded torch generator,
handed to the reference as numpy arrays; the batches come from
``lm_batch_iterator`` (byte-identical in both packages). Both archs' smoke
variants (dense qwen2-1.5b and hybrid recurrentgemma-9b), the float and
int8 wires and both port engines are held against one jitted reference
run per (arch, wire); ``grad_mode="joint"`` once per wire.

Tolerances: losses, gradients and the parameters after an sgd step rtol
1e-4 / atol 1e-5 (float32; the two frameworks sum in other orders, and
the reference's associative RG-LRU scan is within ~3e-7 relative of the
port's sequential one). The first update of adam and of adagrad is
lr * g / (|g| + eps), about lr * sign(g), so where |g| is under the
gradients' tolerance its sign, and the update, may differ by up to 2 lr
between the packages: the updated params are held at rtol 1e-4 / atol
1e-5 where the reference's |g| is at least 1e-4 (ten times that
tolerance) and within 2 lr + 1e-5 elsewhere; after 3 adam steps within
3 x 2 x 1.0036 lr + 1e-5 (|m_hat| / sqrt(v_hat) <= 1.0036 for t <= 3 at
b1 0.9, b2 0.999), and the losses of those steps at rtol 1e-4 / atol
1e-5. Within the port, a chunk equals the step loop bit
for bit, remat ("full" and "dots") equals no remat bit for bit, and a
resumed run equals an unbroken one bit for bit; remat="dots" also
against the reference's at the tolerance above.
"""
import dataclasses
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.func import vmap

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import base as jcfg
from repro.core import api as japi
from repro.core import train_loop as jtl
from repro.core.easter_lm import EasterLM as JLM
from repro.core.losses import chunked_lm_head_xent as j_xent
from repro.data.synthetic import lm_batch_iterator as j_batches
from repro_torch import checkpoint, optim
from repro_torch.configs import base as tcfg
from repro_torch.core import api, train_loop
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.core.losses import chunked_lm_head_xent
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.launch import train as train_cli
from repro_torch.models import layers as TL
from repro_torch.tree import tree_leaves

ARCHS = ("qwen2-1.5b", "recurrentgemma-9b")
B, S, STEP = 2, 8, 3
RTOL, ATOL = 1e-4, 1e-5
PARTY_SPEC = "0=sgd:0.01,1=adagrad:0.005"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many small eager torch ops, which finish far sooner
    on one thread than on a thread pool contended by the other test
    workers on the same CPU."""
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
        _close(a, b, rtol, atol)


def _trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """The port's weights (drawn once, reference layout, numpy) and three
    batches of (B, S) tokens."""
    tc = tcfg.smoke_variant(tcfg.get_config(arch))
    ts = TLM(tc, tcfg.EasterConfig(), engine="loop", device="cpu")
    tree = ts.export_params(ts.init_params(torch.Generator().manual_seed(0)))
    batches = list(itertools.islice(
        lm_batch_iterator(tc.vocab_size, B, S, seed=0), 3))
    return tree, batches


def _jsys(arch, wire="float", grad_mode="easter", **cfg_kw):
    jc = dataclasses.replace(jcfg.smoke_variant(jcfg.get_config(arch)),
                             **cfg_kw)
    return JLM(jc, jcfg.EasterConfig(mask_mode=wire), grad_mode=grad_mode)


def _tsys(arch, engine, wire="float", grad_mode="easter", **cfg_kw):
    tc = dataclasses.replace(tcfg.smoke_variant(tcfg.get_config(arch)),
                             **cfg_kw)
    return TLM(tc, tcfg.EasterConfig(mask_mode=wire), grad_mode=grad_mode,
               engine=engine, device="cpu")


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


@functools.lru_cache(maxsize=None)
def _ref_grads(arch, wire, grad_mode="easter", remat="none"):
    """The reference's jitted value_and_grad of loss_fn at round STEP."""
    js = _jsys(arch, wire, grad_mode, remat=remat)
    tree, batches = _setup(arch)
    seeds = js.mask_seeds()
    fn = jax.jit(lambda p, b, s: jax.value_and_grad(
        js.loss_fn, has_aux=True)(p, b, s, seeds))
    (total, per), g = fn(_jtree(tree), batches[0], jnp.int32(STEP))
    return np.asarray(total), np.asarray(per), jax.tree.map(np.asarray, g)


def _port_grads(ts, arch):
    tree, batches = _setup(arch)
    params = ts.load_params(tree)
    return train_loop.loss_and_grads(ts, params, batches[0], STEP,
                                     ts.mask_seeds())


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def test_port_weights_have_the_reference_layout():
    for arch in ARCHS:
        tree = _setup(arch)[0]
        want = jax.eval_shape(_jsys(arch).init_params, jax.random.PRNGKey(0))
        assert jax.tree.structure(want) == jax.tree.structure(tree)
        assert jax.tree.map(lambda s: (s.shape, s.dtype), want) == \
            jax.tree.map(lambda a: (a.shape, a.dtype), tree)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("wire", ["float", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, wire, engine):
    j_total, j_per, j_g = _ref_grads(arch, wire)
    total, per, g = _port_grads(_tsys(arch, engine, wire), arch)
    _close(per, j_per)
    _close(total, j_total)
    _trees_close(g, j_g)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("wire", ["float", "int8"])
def test_joint_grads_match_reference(wire, engine):
    """grad_mode="joint": every party's loss reaches every backbone
    through the aggregate (blind_agg's backward on the float wire); the
    int8 ring's round carries no gradient, so there the backbones get
    exactly zero in both packages."""
    arch = ARCHS[0]
    j_total, j_per, j_g = _ref_grads(arch, wire, "joint")
    _, per, g = _port_grads(_tsys(arch, engine, wire, "joint"), arch)
    _close(per, j_per)
    _trees_close(g, j_g)
    backbones = [leaf for p in g["parties"]
                 for leaf in tree_leaves(p["backbone"])]
    zero = all(not bool(t.any()) for t in backbones)
    j_zero = all(not a.any() for p in j_g["parties"]
                 for a in jax.tree.leaves(p["backbone"]))
    assert zero == j_zero == (wire == "int8")


@pytest.mark.parametrize("S_", [16, 12])
def test_chunked_lm_head_xent_matches_reference(S_):
    """The chunked branch (chunk 4 divides S = 16) and the plain one (12
    is not a multiple of 8), value and gradients."""
    chunk = 4 if S_ == 16 else 8
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, S_, 16)).astype(np.float32)
    w = rng.normal(size=(16, 40)).astype(np.float32)
    y = rng.integers(0, 40, size=(2, S_)).astype(np.int32)
    jv, (jgh, jgw) = jax.value_and_grad(
        lambda h, w: j_xent(h, w, jnp.asarray(y), chunk), argnums=(0, 1))(
            jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tv = chunked_lm_head_xent(th, tw, torch.from_numpy(y), chunk)
    tgh, tgw = torch.autograd.grad(tv, [th, tw])
    _close(tv, jv)
    _close(tgh, jgh)
    _close(tgw, jgw)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_remat_full_equals_none(engine):
    """remat="full" (a checkpoint around each layer repeat, around the
    vmap on the vectorized engine) and remat="dots" (the same checkpoint
    saving its matrix products' outputs and recomputing the rest) give
    the same loss and gradients as no remat, bit for bit."""
    outs = [_port_grads(_tsys(ARCHS[1], engine, remat=r), ARCHS[1])
            for r in ("none", "full", "dots")]
    for out in outs[1:]:
        assert torch.equal(outs[0][1], out[1])
        assert _trees_equal(outs[0][2], out[2])


def test_remat_dots_matches_reference(monkeypatch):
    """remat="dots" against the reference's (``jax.checkpoint`` with
    ``dots_saveable``) at the loss and gradients' tolerance, on the
    vectorized engine; the checkpoint's policy saves the forward's matrix
    products (mm / addmm / bmm / baddbmm) and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    from repro_torch.models import transformer
    seen = []
    policy = transformer._dots_policy

    def counted(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute:
            seen.append((op, out))
        return out

    monkeypatch.setattr(transformer, "_dots_policy", counted)
    j_total, j_per, j_g = _ref_grads(ARCHS[0], "float", remat="dots")
    total, per, g = _port_grads(_tsys(ARCHS[0], "vectorized",
                                      remat="dots"), ARCHS[0])
    _close(per, j_per)
    _close(total, j_total)
    _trees_close(g, j_g)
    saved = {op for op, out in seen if out == CheckpointPolicy.MUST_SAVE}
    assert saved and saved <= set(transformer._DOTS)
    assert any(out == CheckpointPolicy.PREFER_RECOMPUTE for _, out in seen)


# ---------------------------------------------------------------------------
# optimizer steps, chunks, the round schedule
# ---------------------------------------------------------------------------


def _sign_step_close(got, want, lr, g_ref=None, steps=1):
    """The derived bound for adam and adagrad (module docstring); with the
    reference's gradient of a single step, the tight tolerance where its
    sign is sure."""
    got, want = _np(got), _np(want)
    if g_ref is not None:
        sure = np.abs(_np(g_ref)) >= 1e-4
        np.testing.assert_allclose(got[sure], want[sure], rtol=RTOL,
                                   atol=ATOL)
    bound = steps * 2 * 1.0036 * lr + ATOL
    assert np.max(np.abs(got - want), initial=0.0) <= bound


def _run_port(ts, arch, tcfg_, n_steps, step0=STEP):
    tree, batches = _setup(arch)
    trainer = api.build_trainer(ts, tcfg_)
    state = dataclasses.replace(trainer.init(ts.load_params(tree)),
                                step=step0)
    return trainer.run(state, batches[:n_steps])


@pytest.mark.parametrize("opt", ["sgd", "adam", "party"])
def test_one_step_update_matches_reference(opt):
    """One Trainer step on the vectorized engine against the reference's
    optimizer applied to the reference's gradients: sgd, adam, and the
    heterogeneous party optimizers (sgd, adagrad, then adam for the
    unlisted parties)."""
    arch = ARCHS[0]
    kw = (dict(party_optimizers=optim.parse_party_spec(PARTY_SPEC))
          if opt == "party" else dict(optimizer=opt, lr=0.01 if opt == "sgd"
                                      else 1e-3))
    jkw = (dict(party_optimizers=joptim.parse_party_spec(PARTY_SPEC))
           if opt == "party" else kw)
    jtrainer = japi.Trainer(_jsys(arch), japi.TrainConfig(**jkw))
    tree = _jtree(_setup(arch)[0])
    _, j_per, j_g = _ref_grads(arch, "float")
    j_new, _ = jax.jit(jtrainer.opt.update)(
        _jtree(j_g), jtrainer.opt.init(tree), tree)
    state, m = _run_port(_tsys(arch, "vectorized"), arch,
                         api.TrainConfig(**kw), 1)
    _close(m["per_party"][0], j_per)
    names = ([o.name for o in jtrainer.opt.opts] if opt == "party"
             else [opt] * 4)
    for k, name in enumerate(names):
        got = tree_leaves(state.params["parties"][k])
        want = jax.tree.leaves(j_new["parties"][k])
        gk = jax.tree.leaves(j_g["parties"][k])
        for a, b, gr in zip(got, want, gk):
            if name in ("adam", "adagrad"):
                lr = 0.005 if name == "adagrad" else 1e-3
                _sign_step_close(a, b, lr, gr)
            else:
                _close(a, b)


def test_train_chunk_matches_reference_and_step_loop():
    """Two sgd steps: one port chunk equals the port's step loop bit for
    bit, and the reference's build_train_chunk at the tolerances."""
    arch = ARCHS[0]
    tree, batches = _setup(arch)
    js = _jsys(arch)
    jopt = joptim.make_optimizer("sgd", 0.01, grad_clip=1.0)
    jp = _jtree(tree)
    fn = jtl.build_train_chunk(js, jopt, donate=False)
    j_p, _, j_step, j_m = fn(jp, jopt.init(jp),
                             jtl.stack_batches(batches[:2]), STEP)
    ts = _tsys(arch, "vectorized")
    topt = optim.make_optimizer("sgd", 0.01, grad_clip=1.0)
    p1 = ts.load_params(tree)
    chunk = train_loop.build_train_chunk(ts, topt)
    p1, _, step, m = chunk(p1, topt.init({"parties": p1["parties"]}),
                           train_loop.stack_batches(batches[:2], "cpu"),
                           STEP)
    p2 = ts.load_params(tree)
    s2 = topt.init({"parties": p2["parties"]})
    step_fn = train_loop.make_train_step(ts, topt)
    losses = []
    for i, b in enumerate(batches[:2]):
        p2, s2, mi = step_fn(p2, s2, b, STEP + i)
        losses.append(mi["loss"])
    assert step == int(j_step) == STEP + 2
    assert torch.equal(m["loss"], torch.stack(losses))
    assert _trees_equal(p1, p2)
    _close(m["loss"], j_m["loss"])
    _close(m["per_party"], j_m["per_party"])
    _trees_close({"parties": p1["parties"]}, j_p)


def test_trainer_runs_in_chunks_of_its_config():
    """Trainer.run over 3 batches at chunk 2 (a run of 2 steps, then one
    of 1) equals one run at chunk 8, bit for bit, and so does the state
    it hands on: the chunk splits the device staging, not the steps."""
    arch = ARCHS[0]
    outs = [_run_port(_tsys(arch, "vectorized"), arch,
                      api.TrainConfig(optimizer="sgd", lr=0.01, chunk=c), 3)
            for c in (2, 8)]
    (s2, m2), (s8, m8) = outs
    assert s2.step == s8.step == STEP + 3
    assert m2["loss"].shape == (3,) and m2["per_party"].shape == (3, 4)
    assert torch.equal(m2["loss"], m8["loss"])
    assert torch.equal(m2["per_party"], m8["per_party"])
    assert _trees_equal(s2.params, s8.params)


def test_adam_losses_of_three_steps():
    arch = ARCHS[0]
    tree, batches = _setup(arch)
    js = _jsys(arch)
    jopt = joptim.make_optimizer("adam", 1e-3, grad_clip=1.0)
    step = jax.jit(jtl.make_train_step(js, jopt))
    jp = _jtree(tree)
    js_state = jopt.init(jp)
    j_losses = []
    for i in range(3):
        jp, js_state, m = step(jp, js_state, batches[i], jnp.int32(STEP + i))
        j_losses.append(np.asarray(m["per_party"]))
    state, m = _run_port(_tsys(arch, "vectorized"), arch,
                         api.TrainConfig(optimizer="adam", lr=1e-3), 3)
    _close(m["per_party"], np.stack(j_losses))
    for a, b in zip(tree_leaves(state.params["parties"]),
                    jax.tree.leaves(jp["parties"])):
        _sign_step_close(a, b, 1e-3, steps=3)


def test_train_round_schedule():
    """The TRAIN-domain rounds: the reference's schedule, and the rounds
    a port chunk hands loss_fn."""
    want = np.asarray(jtl.train_round_schedule(STEP, 4))
    got = train_loop.train_round_schedule(STEP, 4)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    ts = _tsys(ARCHS[0], "vectorized")
    seen = []
    loss_fn = ts.loss_fn
    ts.loss_fn = lambda p, b, r, s: seen.append(r) or loss_fn(p, b, r, s)
    _run_port(ts, ARCHS[0], api.TrainConfig(optimizer="sgd"), 3)
    assert seen == [STEP, STEP + 1, STEP + 2]


# ---------------------------------------------------------------------------
# the passive embedding gather
# ---------------------------------------------------------------------------


def test_offset_gather_equals_vmap_and_copies_no_table():
    """layers.embed_grouped equals F.embedding under vmap over the stacked
    tables bit for bit; under the profiler the vmapped gather allocates a
    table-sized copy and the offset gather allocates nothing that big."""
    from torch.profiler import ProfilerActivity, profile
    K, V, d = 3, 20000, 64
    g = torch.Generator().manual_seed(0)
    table = torch.randn((K, V, d), generator=g)
    tokens = torch.randint(0, V, (2, 5), generator=g, dtype=torch.int32)
    want = vmap(lambda t: F.embedding(tokens.long(), t))(table)
    got = TL.embed_grouped(table, tokens)
    assert torch.equal(got, want)
    nbytes = table.numel() * table.element_size()

    def biggest_alloc(fn):
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True,
                     profile_memory=True) as prof:
            fn()
        return max(e.cpu_memory_usage for e in prof.events())

    assert biggest_alloc(lambda: vmap(
        lambda t: F.embedding(tokens.long(), t))(table)) >= nbytes
    assert biggest_alloc(lambda: TL.embed_grouped(table, tokens)) < \
        nbytes // 100


# ---------------------------------------------------------------------------
# data, checkpoints, resumption, the launcher
# ---------------------------------------------------------------------------


def test_lm_batch_iterator_byte_identical():
    for ours, theirs in zip(itertools.islice(lm_batch_iterator(151936, 2, 33,
                                                               seed=4), 3),
                            j_batches(151936, 2, 33, seed=4)):
        assert sorted(ours) == sorted(theirs) == ["labels", "tokens"]
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            assert ours[k].tobytes() == theirs[k].tobytes()


def test_checkpoint_crosses_packages(tmp_path):
    """A reference checkpoint of {params (bfloat16), adam state} restores
    into the port bit for bit, and the port's file into the reference."""
    arch = ARCHS[0]
    jtree = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                         _jtree(_setup(arch)[0]))
    jopt = joptim.make_optimizer("adam", 1e-3)
    jstate = jopt.init(jtree)
    jstate = dict(jstate, m=jax.tree.map(lambda a: a + 0.25, jstate["m"]),
                  t=jnp.int32(7))
    jckpt.save(str(tmp_path / "ref.npz"), {"params": jtree, "opt": jstate},
               step=11)
    ts = TLM(dataclasses.replace(tcfg.smoke_variant(tcfg.get_config(arch)),
                                 dtype="bfloat16"), tcfg.EasterConfig(),
             device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(1))
    topt = optim.make_optimizer("adam", 1e-3)
    like = {"params": {"parties": params["parties"]},
            "opt": topt.init({"parties": params["parties"]})}
    got, step = checkpoint.restore(str(tmp_path / "ref.npz"), like)
    assert step == 11
    bits = lambda t: t.view(torch.int16).numpy() \
        if t.dtype == torch.bfloat16 else t.numpy()
    jbits = lambda a: np.asarray(a).view(np.int16) \
        if a.dtype == jnp.bfloat16 else np.asarray(a)
    want = {"params": jtree, "opt": jstate}
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == (torch.bfloat16 if b.dtype == jnp.bfloat16
                           else getattr(torch, str(b.dtype)))
        np.testing.assert_array_equal(bits(a), jbits(b))
    checkpoint.save(str(tmp_path / "port.npz"), got, step=12)
    back, step = jckpt.restore(str(tmp_path / "port.npz"), want)
    assert step == 12
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(jbits(a), jbits(b))


def test_resumed_run_equals_unbroken(tmp_path):
    """Four steps with the party optimizers, straight through or broken
    after two by a checkpoint restored into a fresh system: the same
    params and optimizer states, bit for bit."""
    arch = ARCHS[0]
    tree, batches = _setup(arch)
    batches = batches + batches[:1]
    tc = api.TrainConfig(party_optimizers=optim.parse_party_spec(PARTY_SPEC))

    def fresh():
        ts = _tsys(arch, "vectorized")
        trainer = api.build_trainer(ts, tc)
        return ts, trainer, trainer.init(ts.load_params(tree))

    _, trainer, whole = fresh()
    whole, _ = trainer.run(whole, batches)
    _, trainer, state = fresh()
    state, _ = trainer.run(state, batches[:2])
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, {"params": {"parties": state.params["parties"]},
                           "opt": state.opt_state}, step=state.step)
    ts, trainer, state = fresh()
    restored, step = checkpoint.restore(
        path, {"params": {"parties": state.params["parties"]},
               "opt": state.opt_state})
    state = api.TrainState(ts.group_params(restored["params"]),
                           restored["opt"], step)
    state, _ = trainer.run(state, batches[2:])
    assert state.step == whole.step == 4
    assert _trees_equal(state.params["parties"], whole.params["parties"])
    assert _trees_equal(state.opt_state, whole.opt_state)


def test_train_cli_runs_and_resumes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ck = str(tmp_path / "ck" / "c.npz")
    base = ["--smoke", "--chunk", "2", "--device", "cpu", "--ckpt", ck,
            "--log-every", "1", "--batch", "2", "--seq", "8"]
    out = train_cli.main(base + ["--steps", "4"])
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    out = train_cli.main(base + ["--steps", "2", "--resume"])
    assert [h["step"] for h in out["history"]] == [4, 5]
    with np.load(ck) as f:
        assert int(f["__step__"]) == 6
    assert len(list((tmp_path / "experiments" / "train").iterdir())) == 1
    # the sharded engine runs under torchrun (one process per rank)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_cli.main(base + ["--steps", "1", "--engine", "sharded"])
    with pytest.raises(ValueError, match="--engine sharded"):
        train_cli.main(base + ["--steps", "1", "--party-devices", "2"])
