"""The port's architecture registry and the dense configs it gained
(gemma3-4b's local:global layers, command-r-plus-104b, the paper's
``easter_paper`` configs) against the JAX reference, the weight draw's
layout, and the launchers on every family, on the CPU.

Tolerances: configs, parameter counts and the registry exactly; the
transformer and EasterLM in float32 at rtol 1e-4 / atol 1e-5, as the
other families' tests (integers bit for bit); the draw bit for bit
against stacking whole drawn trees, the construction it replaced.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jcfg
from repro.configs import easter_paper as jpaper
from repro.core.easter_lm import EasterLM as JLM
from repro.models import transformer as JT
from repro_torch import checkpoint
from repro_torch.configs import base as tcfg
from repro_torch.configs import easter_paper as tpaper
from repro_torch.core.easter_lm import EasterLM as TLM
from repro_torch.core.party_engine import stack_trees
from repro_torch.data.synthetic import lm_batch_iterator
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import transformer as TT
from repro_torch.tree import tree_leaves

RTOL, ATOL = 1e-4, 1e-5
PORTED = sorted(jcfg.list_archs())


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


def _trees_close(got, want):
    g, w = tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        if np.issubdtype(np.asarray(b).dtype, np.integer):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            _close(a, b)


def _tree(x):
    return checkpoint.params_from_numpy(jax.tree.map(np.asarray, x), "cpu",
                                        False)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_holds_every_arch_but_the_frontend_families():
    """Every one of the reference's 11 archs, the two frontend families
    (encoder-decoder, vision) among them."""
    assert tcfg.list_archs() == PORTED and len(PORTED) == 11
    assert {tcfg.get_config(a).family for a in PORTED} == {
        "dense", "moe", "ssm", "hybrid", "encdec", "vlm"}


@pytest.mark.parametrize("arch", PORTED)
def test_config_copy_matches_reference(arch):
    """Field for field at full size, the parameter count, and the smoke
    variant; the port builds the stack plan the reference builds."""
    j, t = jcfg.get_config(arch), tcfg.get_config(arch)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()
    js, ts = jcfg.smoke_variant(j), tcfg.smoke_variant(t)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert TT.stack_plan(t) == JT.stack_plan(j)
    assert TT.stack_plan(ts) == JT.stack_plan(js)
    TT._check_family(t)


def test_easter_paper_configs_match_reference():
    assert dataclasses.asdict(tpaper.paper_easter_config()) == \
        dataclasses.asdict(jpaper.paper_easter_config())
    assert dataclasses.asdict(tpaper.paper_easter_config(5)) == \
        dataclasses.asdict(jpaper.paper_easter_config(5))
    assert dataclasses.asdict(tpaper.paper_train_config()) == \
        dataclasses.asdict(jpaper.paper_train_config())


def test_gemma3_stack_plan_and_windows():
    """34 layers: 5 x (local x5, global) + (local x4); local layers keep a
    ring of 1024 slots, global layers the whole length."""
    cfg = tcfg.get_config("gemma3-4b")
    assert TT.stack_plan(cfg) == [(("local",) * 5 + ("global",), 5),
                                  (("local",) * 4, 1)]
    caches = TT.init_cache(dataclasses.replace(cfg, n_layers=7,
                                               vocab_size=8), 1, 2048,
                           device="meta")
    assert tuple(caches[0]["p0"]["k"].shape) == (1, 1, 1024, 4, 256)
    assert tuple(caches[0]["p5"]["k"].shape) == (1, 1, 2048, 4, 256)


def test_unported_families_raise():
    """The frontend families are ported: _check_family accepts them and
    the port builds their stack plans (the reference's); a family outside
    the six still raises."""
    for arch, family in (("whisper-small", "encdec"),
                         ("qwen2-vl-7b", "vlm")):
        cfg = tcfg.get_config(arch)
        assert cfg.family == family
        TT._check_family(cfg)
        assert TT.stack_plan(cfg) == JT.stack_plan(jcfg.get_config(arch))
        assert TT.stack_plan(cfg) == [(("attn",), cfg.n_layers)]
    with pytest.raises(ValueError, match="family 'rnn'"):
        TT._check_family(dataclasses.replace(cfg, family="rnn"))


# ---------------------------------------------------------------------------
# the weight draw
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_layers", [
    ("qwen2-moe-a2.7b", None), ("mamba2-2.7b", None), ("gemma3-4b", 7),
    ("recurrentgemma-9b", 5)])
def test_draw_is_the_stacked_draw_bit_for_bit(arch, n_layers, monkeypatch):
    """init_lm fills the (reps, ...) leaves block by block and init_params
    draws each passive party into its row of the stack; both give the
    bits of the construction they replaced (every block, and every party,
    drawn whole, then stacked) from the same generator seed."""
    cfg = tcfg.smoke_variant(tcfg.get_config(arch))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    ts = TLM(cfg, tcfg.EasterConfig(), device="cpu")
    new = ts.init_params(torch.Generator().manual_seed(3))
    monkeypatch.setattr(TT, "stack_drawn", lambda draw, n: stack_trees(
        [draw(i) for i in range(n)]))
    gen = torch.Generator().manual_seed(3)
    parties = [ts.init_party(gen, c) for c in ts.party_cfgs]
    old = {"parties": parties, "passive_stacked": stack_trees(parties[1:])}
    for key in ("parties", "passive_stacked"):
        a, b = tree_leaves(new[key]), tree_leaves(old[key])
        assert len(a) == len(b)
        assert all(x.dtype == y.dtype and torch.equal(x, y)
                   for x, y in zip(a, b))
    # the group's segment leaves lie reps-major: each layer repeat of the
    # group is one contiguous block
    for a in tree_leaves(new["passive_stacked"]["backbone"]["segments"]):
        assert all(a[:, r].is_contiguous() for r in range(a.shape[1]))
    assert all(a.is_contiguous() for a in tree_leaves(
        new["passive_stacked"]["backbone"]["embed"]))


# ---------------------------------------------------------------------------
# the dense configs against the reference
# ---------------------------------------------------------------------------

PREFILL, STEPS, MAX_LEN = 48, 3, 56


@pytest.mark.parametrize("n_layers", [2, 7], ids=["smoke", "period"])
def test_gemma3_prefill_past_the_window_and_decode(n_layers):
    """gemma3-4b's smoke variant (window 32; two local layers) and a
    7-layer cut (a (local x5, global) period and a local remainder): the
    full forward, a 48-token prefill, which wraps the local layers' ring
    of 32 slots, and 3 decode steps, hidden states and caches against
    the reference's after each."""
    jc = dataclasses.replace(jcfg.smoke_variant(jcfg.get_config(
        "gemma3-4b")), n_layers=n_layers)
    tc = dataclasses.replace(tcfg.smoke_variant(tcfg.get_config(
        "gemma3-4b")), n_layers=n_layers)
    assert tc.window == 32 and TT.stack_plan(tc) == JT.stack_plan(jc)
    jp = jax.jit(lambda k: JT.init_lm(k, jc))(jax.random.PRNGKey(1))
    tp = _tree(jp)
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


def test_command_r_plus_prefill():
    jc = jcfg.smoke_variant(jcfg.get_config("command-r-plus-104b"))
    tc = tcfg.smoke_variant(tcfg.get_config("command-r-plus-104b"))
    jp = jax.jit(lambda k: JT.init_lm(k, jc))(jax.random.PRNGKey(2))
    tok = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 20))
    tok = tok.astype(np.int32)
    jh, jcache, _ = jax.jit(lambda p, t, c: JT.apply_lm(
        p, t, jc, caches=c, return_hidden=True))(
        jp, jnp.asarray(tok), JT.init_cache(jc, 2, 24))
    with torch.no_grad():
        th, tcache, _ = TT.apply_lm(_tree(jp), torch.from_numpy(tok), tc,
                                    caches=TT.init_cache(tc, 2, 24),
                                    return_hidden=True)
    _close(th, jh)
    _trees_close(tcache, jcache)


@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_easter_mlp_paper_loss_matches_reference(engine):
    """easter-mlp parties under paper_easter_config(): one EasterLM loss
    (float wire, d_embed 128, 2 decision layers) on the port's weights."""
    tc, jc = tcfg.get_config("easter-mlp"), jcfg.get_config("easter-mlp")
    ts = TLM(tc, tpaper.paper_easter_config(), engine=engine, device="cpu")
    js = JLM(jc, jpaper.paper_easter_config())
    tree = ts.export_params(ts.init_params(torch.Generator().manual_seed(0)))
    batch = next(lm_batch_iterator(tc.vocab_size, 2, 8, seed=0))
    seeds = js.mask_seeds()
    j_total, j_per = jax.jit(lambda p, b: js.loss_fn(p, b, jnp.int32(2),
                                                     seeds))(
        jax.tree.map(jnp.asarray, tree), batch)
    with torch.no_grad():
        total, per = ts.loss_fn(ts.load_params(tree), batch, 2,
                                ts.mask_seeds())
    _close(per, j_per)
    _close(total, j_total)


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [None, "qwen2-moe-a2.7b", "mamba2-2.7b"],
                         ids=["default_gemma3", "moe", "ssm"])
def test_launch_serve_smoke_on_the_cpu(arch, capsys):
    """The default arch is the reference's, gemma3-4b."""
    argv = ["--smoke", "--requests", "3", "--prompt-len", "6", "--gen", "3",
            "--device", "cpu"]
    serve_cli.main(argv + ([] if arch is None else ["--arch", arch]))
    out = capsys.readouterr().out
    assert (arch or "gemma3-4b") in out and "served 3 requests" in out


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b"])
def test_launch_train_smoke_on_the_cpu(arch, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = train_cli.main(["--arch", arch, "--smoke", "--steps", "2",
                          "--chunk", "2", "--batch", "2", "--seq", "8",
                          "--log-every", "1", "--device", "cpu"])
    assert out["arch"] == arch
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
