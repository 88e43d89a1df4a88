"""The FSDP plan's rules (``repro_torch.sharding``) against the reference's
(``repro.sharding``), spec for spec, with no group: ``tuple(port spec) ==
tuple(reference PartitionSpec)`` for every leaf.

For each of the 11 archs' smoke variants (both packages' ``smoke_variant``
and ``default_easter``), on an abstract 2 x 2, 16 x 16 and 2 x 16 x 16
mesh: ``param_specs`` (layouts "tp" and "zero3", FSDP on and off),
``cache_specs`` (batch 1 and 4), ``batch_specs`` (both layouts, a batch
that divides over the 16 x 16 mesh's data axis and one that does not) and
``opt_state_specs`` (ZeRO-1 on and off, adam and momentum, FSDP on and
off, both layouts); the same at full size for qwen2.5-3b,
qwen3-moe-235b-a22b and recurrentgemma-9b, the port's trees on the meta
device against ``jax.eval_shape`` of the reference's. The port's stacked
passive group (``passive_stacked``) is held against the reference's party
1 specs with None in front. The reference's trees are traced once per
module (``jax.eval_shape``: shapes only).
"""
import functools
import itertools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro import sharding as jshard
from repro.configs import base as jcfg
from repro.launch import mesh as jmesh
from repro.launch import steps as jsteps
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import sharding
from repro_torch.configs import base as tcfg
from repro_torch.launch import mesh, steps
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves

ARCHS = [a for a in tcfg.list_archs() if not a.startswith("easter")]
FULL = ("qwen2.5-3b", "qwen3-moe-235b-a22b", "recurrentgemma-9b")
MESHES = (((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
CACHE_LEN, SEQ = 32, 8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, smoke):
    jc, tc = jcfg.get_config(arch), tcfg.get_config(arch)
    if smoke:
        jc, tc = jcfg.smoke_variant(jc), tcfg.smoke_variant(tc)
    return jc, tc


@functools.lru_cache(maxsize=None)
def _trees(arch, smoke=True):
    """(reference trees, port trees) of one arch: params, caches at batch 1
    and 4, adam and momentum states; shapes only."""
    jc, tc = _cfgs(arch, smoke)
    js = jsteps.make_system(jc, jsteps.default_easter(jc))
    ts = steps.make_system(tc, steps.default_easter(tc), device="meta")
    jp = jax.eval_shape(js.init_params, jax.random.PRNGKey(0))
    tp = steps.abstract_params(ts)
    ref = {"params": jp, "opt": {}, "caches": {}}
    port = {"params": tp, "opt": {}, "caches": {}}
    for B in (1, 4):
        ref["caches"][B] = jax.eval_shape(lambda: js.init_caches(B,
                                                                 CACHE_LEN))
        port["caches"][B] = ts.init_caches(B, CACHE_LEN)
    for name in ("adam", "momentum"):
        ref["opt"][name] = jax.eval_shape(jmake_optimizer(name, 1e-3).init,
                                          jp)
        port["opt"][name] = make_optimizer(name, 1e-3).init(
            {"parties": tp["parties"]})
    return ref, port


def _same(port_specs, ref_specs):
    want = [tuple(s) for s in jax.tree.leaves(
        ref_specs, is_leaf=lambda x: isinstance(x, JP))]
    got = [tuple(s) for s in sharding.spec_leaves(port_specs)]
    assert got == want


def _meshes(shape, names):
    return mesh.abstract_mesh(shape, names), jmesh.abstract_mesh(shape, names)


def _check_arch(arch, smoke):
    ref, port = _trees(arch, smoke)
    jp, tp = ref["params"], port["params"]
    for shape, names in MESHES:
        tm, jm = _meshes(shape, names)
        for layout, fsdp in itertools.product(("tp", "zero3"), (False, True)):
            ps = sharding.param_specs(tp, tm, fsdp, layout)
            want = jshard.param_specs(jp, jm, fsdp, layout)
            _same({"parties": ps["parties"]}, want)
            # the stacked group: party 1's specs with None in front
            assert [tuple(s) for s in sharding.spec_leaves(
                ps["passive_stacked"])] == [(None,) + tuple(s) for s in
                                            jax.tree.leaves(
                    want["parties"][1],
                    is_leaf=lambda x: isinstance(x, JP))]
            for opt, zero1 in itertools.product(("adam", "momentum"),
                                                (False, True)):
                _same(sharding.opt_state_specs(port["opt"][opt], tp, tm,
                                               zero1, fsdp, layout),
                      jshard.opt_state_specs(ref["opt"][opt], jp, jm, zero1,
                                             fsdp, layout))
        for B in (1, 4):
            _same(sharding.cache_specs(port["caches"][B], tm, B),
                  jshard.cache_specs(ref["caches"][B], jm, B))
        for layout, B in itertools.product(("tp", "zero3"), (4, 32)):
            batch = {"tokens": torch.empty((B, SEQ), dtype=torch.int32,
                                           device="meta")}
            jbatch = {"tokens": jax.ShapeDtypeStruct((B, SEQ), "int32")}
            _same(sharding.batch_specs(batch, tm, layout),
                  jshard.batch_specs(jbatch, jm, layout))


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference_at_smoke_size(arch):
    _check_arch(arch, smoke=True)


@pytest.mark.parametrize("arch", FULL)
def test_specs_match_reference_at_full_size(arch):
    _check_arch(arch, smoke=False)


def test_spec_spelling_and_blocks():
    """``P`` spells entries as jax does; a block's shape divides each dim
    by the size of the axes it lies over; ``shard_tree`` cuts rank 0's
    blocks and keeps the passive parties views of the stacked block."""
    for entries in ((("data",), None), (("data", "model"),), ((),), ()):
        assert tuple(sharding.P(*entries)) == tuple(JP(*entries))
    m = mesh.abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.local_shape((64, 48, 7), sharding.P(
        ("pod", "data"), "model"), m) == (2, 3, 7)
    cfg = tcfg.smoke_variant(tcfg.get_config("qwen2.5-3b"))
    ts = steps.make_system(cfg, steps.default_easter(cfg), device="cpu")
    params = ts.init_params(torch.Generator().manual_seed(0))
    tm = mesh.abstract_mesh((2, 2), ("data", "model"))
    spec = sharding.param_specs(params, tm)
    local = sharding.shard_tree(params, spec, tm)
    for x, full, s in zip(tree_leaves(local), tree_leaves(params),
                          sharding.spec_leaves(spec)):
        assert tuple(x.shape) == sharding.local_shape(full.shape, s, tm)
        idx = tuple(slice(0, n) for n in x.shape)
        assert torch.equal(x, full[idx])
    table = local["passive_stacked"]["backbone"]["embed"]["table"]
    assert local["parties"][2]["backbone"]["embed"]["table"] \
        .untyped_storage().data_ptr() == table.untyped_storage().data_ptr()
