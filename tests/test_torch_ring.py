"""The port's ring wire modes (int32, int8) held against the JAX reference.

Everything here is integer or exact, so the comparisons are bit for bit:
int32 masks against ``jax.random.randint`` itself, quantization, the
wrapped ring sums, the global embeddings given equal embeddings and
masks, the int8 word packing and ``bytes_per_round``. The classifier's
rounds on the ring wires go through float models, so their losses and
parameters are allclose (tolerances as in tests/test_torch_protocol.py).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import EasterConfig as JEasterConfig
from repro.core import aggregation as jagg
from repro.core import blinding as jb
from repro.core import party_models as jpm
from repro.core.protocol import EasterClassifier as JClassifier
from repro_torch import checkpoint as tck
from repro_torch.configs.base import EasterConfig as TEasterConfig
from repro_torch.core import aggregation as tagg
from repro_torch.core import blinding as tb
from repro_torch.core import party_models as tpm
from repro_torch.core.protocol import EasterClassifier as TClassifier


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: they finish sooner on one thread than
    on a thread pool contended by the other test workers on the same
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SEEDS = [0, 12345678901234567, (1 << 63) - 1]
ROUNDS = [0, 1, jb.SERVE_DOMAIN + 5]


@pytest.mark.parametrize("seed", SEEDS)
def test_int32_masks_bit_exact_with_randint(seed):
    hi, lo = jb.seed_words(seed)
    for r in ROUNDS:
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(hi), lo), r)
        for shape in [(1,), (7, 13), (5, 3, 3)]:
            want = jax.random.randint(key, shape, jnp.iinfo(jnp.int32).min,
                                      jnp.iinfo(jnp.int32).max, jnp.int32)
            got = tb._mask_from_words(hi, lo, r, shape, "int32", "cpu")
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("K", [2, 3, 5])
def test_int32_party_masks_bit_exact_and_cancel(K):
    _, seeds = jb.cached_passive_setup(K, 7)
    for r in (0, 3):
        want = np.asarray(jb.all_party_masks(K, seeds, (6, 5), r, "int32"))
        loop = tb.all_party_masks(K, seeds, (6, 5), r, "int32", device="cpu")
        eng = tb.cached_mask_engine(K, 7).masks((6, 5), r, "int32",
                                                device="cpu")
        np.testing.assert_array_equal(loop.numpy(), want)
        np.testing.assert_array_equal(eng.numpy(), want)
        # ring cancellation: the wrapped int32 sum is zero
        assert not torch.sum(eng, dim=0).to(torch.int32).any()


def test_quantizers_and_scale_bit_exact():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 9)) * 3).astype(np.float32)
    tx = torch.from_numpy(x)
    np.testing.assert_array_equal(tb.quantize(tx).numpy(),
                                  np.asarray(jb.quantize(jnp.asarray(x))))
    for C in (2, 4, 64, 200):
        amax = np.float32(np.abs(x).max())
        js = jb.ring_scale(amax, C, "int8")
        ts = tb.ring_scale(torch.tensor(amax), C, "int8")
        assert ts.dtype == torch.float32
        assert np.float32(ts) == np.float32(js), C
        np.testing.assert_array_equal(
            tb.quantize_ring(tx, "int8", ts).numpy(),
            np.asarray(jb.quantize_ring(jnp.asarray(x), "int8", js)))
        np.testing.assert_array_equal(
            tb.dequantize(tb.quantize_ring(tx, "int8", ts), ts).numpy(),
            np.asarray(jb.dequantize(jb.quantize_ring(jnp.asarray(x), "int8",
                                                      js), js)))
    assert float(tb.ring_scale(torch.tensor(1.0), 4, "int32")) == 2.0 ** 16
    with pytest.raises(ValueError, match="headroom"):
        tb.ring_scale(torch.tensor(1.0), 300, "int8")
    # the int8 ring wraps: 200 -> -56, never clamps to 127
    big = torch.tensor([200.0, -200.0, 127.0])
    np.testing.assert_array_equal(tb.quantize_ring(big, "int8", 1.0).numpy(),
                                  [-56, 56, 127])


@pytest.mark.parametrize("mode", ["int32", "int8"])
@pytest.mark.parametrize("C", [3, 4, 17])
def test_ring_global_embedding_bit_exact(mode, C):
    """Equal embeddings and masks give the reference's global embedding bit
    for bit, through the uplink, the wrapped sum and the dequantization."""
    rng = np.random.default_rng(C)
    E = (rng.normal(size=(C, 6, 8)) * 2).astype(np.float32)
    K = C - 1
    _, seeds = jb.cached_passive_setup(K, 7)
    jm = jb.all_party_masks(K, seeds, (6, 8), 1, mode)
    tm = torch.from_numpy(np.asarray(jm))
    want = jagg.aggregate_ring(jnp.asarray(E), jm, mode)
    got = tagg.aggregate_ring(torch.from_numpy(E), tm, mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the uplink is blinded: the masked words are not the quantized ones
    scale = (None if mode == "int32" else
             tb.ring_scale(torch.from_numpy(E).abs().max(), C, mode))
    up = tb.blind_uplink(torch.from_numpy(E[1:]), tm, mode, scale)
    q = tb.quantize_ring(torch.from_numpy(E[1:]), mode, scale)
    assert up.dtype == tb.mask_dtype(mode)
    assert (up != q).float().mean() > 0.9
    # from an already-blinded stack: the same words, the same embedding
    stack = torch.cat([tb.quantize_ring(torch.from_numpy(E[0]), mode,
                                        scale)[None], up])
    np.testing.assert_array_equal(
        tagg.aggregate_ring_blinded(stack, mode, scale).numpy(),
        np.asarray(want))
    # masks cancel: the ring aggregate equals the unmasked one
    np.testing.assert_array_equal(
        tagg.aggregate_ring(torch.from_numpy(E), torch.zeros_like(tm),
                            mode).numpy(), got.numpy())


def test_int8_word_packing_round_trip():
    rng = np.random.default_rng(3)
    for n in (1, 4, 7, 64):
        x = rng.integers(-128, 128, n).astype(np.int8)
        w = tb.pack_int8_words(torch.from_numpy(x))
        np.testing.assert_array_equal(w, jb.pack_int8_words(x))
        assert w.dtype == np.dtype("<i4")
        np.testing.assert_array_equal(tb.unpack_int8_words(w, (n,)), x)
    x = rng.integers(-128, 128, (3, 5)).astype(np.int8)
    np.testing.assert_array_equal(
        tb.unpack_int8_words(jb.pack_int8_words(x), (3, 5)), x)


@pytest.mark.parametrize("C,mode,want", [(4, "float", 56_832),
                                         (4, "int32", 56_832),
                                         (4, "int8", 14_256),
                                         (64, "int8", 299_376)])
def test_bytes_per_round(C, mode, want):
    """Batch 32, d_embed 64. At C = 64 the accounting is called on the
    attributes it reads, without building the classifiers: their DH
    ceremony for 63 passive parties takes seconds of host time and is not
    what this test checks."""
    arches = [tpm.PartyArch("mlp", (8,), (8,), 64, 10)] * C
    tcfg = TEasterConfig(num_passive=C - 1, d_embed=64, mask_mode=mode)
    jcfg = JEasterConfig(num_passive=C - 1, d_embed=64, mask_mode=mode)
    jarches = [jpm.PartyArch(**vars(a)) for a in arches]
    if C <= 4:
        ts = TClassifier(tcfg, arches, [4] * C, device="cpu")
        js = JClassifier(jcfg, jarches, [4] * C, engine="loop")
    else:
        ts = SimpleNamespace(easter=tcfg, arches=arches, K=C - 1,
                             compress_frac=0.0)
        js = SimpleNamespace(easter=jcfg, arches=jarches, K=C - 1,
                             compress_frac=0.0)
    assert TClassifier.bytes_per_round(ts, 32) == want
    assert JClassifier.bytes_per_round(js, 32) == want


_C, _B, _D, _NCLS = 4, 16, 12, 5
_NF = [7, 6, 6, 5]
_WIDTHS = [(16, 8), (12,), (20, 10), (8,)]


@pytest.mark.parametrize("mode", ["int32", "int8"])
def test_classifier_three_ring_rounds_match(mode):
    """Three adam rounds on a ring wire, the reference's loop engine (its
    own oracle, bit-exact with its vectorized engine in its own tests, and
    quicker to compile) against the port's default vectorized engine,
    each drawing its own masks: the int32 and int8 masks are bit-exact, so
    both sides blind with the same words."""
    arches = [jpm.PartyArch("mlp", w, (w[-1],), _D, _NCLS) for w in _WIDTHS]
    js = JClassifier(JEasterConfig(num_passive=_C - 1, d_embed=_D,
                                   mask_mode=mode), arches, _NF,
                     engine="loop")
    ts = TClassifier(TEasterConfig(num_passive=_C - 1, d_embed=_D,
                                   mask_mode=mode),
                     [tpm.PartyArch(**vars(a)) for a in arches], _NF,
                     device="cpu")
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(lambda: js.init_params(jax.random.PRNGKey(0)))
    npp = jax.tree.map(lambda s: (rng.normal(size=s.shape) / np.sqrt(
        s.shape[0])).astype(np.float32), shapes)
    jp = jax.tree.map(jnp.asarray, npp)
    tp = tck.params_from_numpy(npp, "cpu")
    jinit, jstep = js.make_train_step("adam", 1e-3)
    tinit, tstep = ts.make_train_step("adam", 1e-3)
    jst, tst = jinit(jp), tinit(tp)
    for i in range(3):
        xs = [rng.normal(size=(_B, f)).astype(np.float32) for f in _NF]
        y = rng.integers(0, _NCLS, _B).astype(np.int32)
        jm, tm = js.masks(_B, i), ts.masks(_B, i)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        jp, jst, _, jper = jstep(jp, jst, [jnp.asarray(x) for x in xs],
                                 jnp.asarray(y), jm)
        tp, tst, _, tper = tstep(tp, tst, [torch.from_numpy(x) for x in xs],
                                 torch.from_numpy(y), tm)
        np.testing.assert_allclose(tper.numpy(), np.asarray(jper), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(tck.params_to_numpy(tp))):
        np.testing.assert_allclose(b, np.asarray(a), atol=5e-5)
