"""The port's blinding (DH ceremony, threefry PRF, masks) held against the
JAX reference, which runs with ``jax_threefry_partitionable=True``.

Integer outputs (pair seeds, PRF bits, int8 masks, byte counts) must be
identical. Float masks go through erfinv: the port evaluates the same
float32 polynomial as XLA but with torch's log1p, so they agree to one
float32 ulp of values up to ~5 (atol 1e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blinding as jb
from repro_torch.core import blinding as tb


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: they finish sooner on one thread than
    on a thread pool contended by the other test workers on the same
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SEEDS = [0, 1, 12345678901234567, (1 << 63) - 1]
ROUNDS = [0, 1, 7, jb.SERVE_DOMAIN + 5, jb.PREFILL_DOMAIN + 3]


@functools.lru_cache(maxsize=None)
def _jprf(shape):
    """One compiled reference PRF per shape: (key words, uint32 bits, int8
    mask, float mask) of the pair seed words (hi, lo) at round r."""

    def f(hi, lo, r):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(hi), lo), r)
        return (jax.random.key_data(key),
                jax.random.bits(key, shape, jnp.uint32),
                jb._mask_from_words(hi, lo, r, shape, "int8"),
                jb._mask_from_words(hi, lo, r, shape, "float"))

    return jax.jit(f)


def test_reference_prng_is_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("K", [2, 3, 5])
def test_pair_seeds_identical(K):
    jkeys, jseeds = jb.setup_passive_parties(K, deterministic_seed=7)
    tkeys, tseeds = tb.setup_passive_parties(K, deterministic_seed=7)
    assert [(k.sk, k.pk) for k in jkeys] == [(k.sk, k.pk) for k in tkeys]
    assert jseeds == tseeds
    assert tb.cached_passive_setup(K, 7)[1] == jb.cached_passive_setup(K, 7)[1]
    je, te = jb.cached_mask_engine(K, 7), tb.cached_mask_engine(K, 7)
    for f in ("seed_hi", "seed_lo", "signs"):
        np.testing.assert_array_equal(getattr(je, f), getattr(te, f))


@pytest.mark.parametrize("seed", SEEDS)
def test_prf_bits_bit_exact(seed):
    hi, lo = jb.seed_words(seed)
    for r in ROUNDS:
        for shape in [(1,), (3,), (7, 13), (5, 3, 3), (64, 40)]:
            key, want, want8, _ = _jprf(shape)(hi, lo, r)
            assert tb.fold_in(tb.fold_in(tb.prng_key(hi), lo), r) == tuple(
                int(w) for w in key)
            got = tb.random_bits(tb._pair_key(hi, lo, r),
                                 int(np.prod(shape)), "cpu").numpy()
            np.testing.assert_array_equal(got.reshape(shape),
                                          np.asarray(want).astype(np.int64))
            np.testing.assert_array_equal(
                tb._mask_from_words(hi, lo, r, shape, "int8", "cpu").numpy(),
                np.asarray(want8))


@pytest.mark.parametrize("seed", SEEDS)
def test_float_pair_mask_matches(seed):
    for r in (0, 3, jb.SERVE_DOMAIN):
        for shape in [(7, 13), (32, 24)]:
            want = np.asarray(_jprf(shape)(*jb.seed_words(seed), r)[3])
            got = tb.pair_mask(seed, shape, r, device="cpu").numpy()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("K", [2, 4])
def test_all_party_masks_and_engine_match(K):
    _, seeds = jb.cached_passive_setup(K, 7)
    shape = (9, 16)
    for r in (0, 2):
        want = np.asarray(jb.all_party_masks(K, seeds, shape, r))
        loop = tb.all_party_masks(K, seeds, shape, r, device="cpu")
        eng = tb.cached_mask_engine(K, 7).masks(shape, r, device="cpu")
        np.testing.assert_allclose(loop.numpy(), want, rtol=0, atol=1e-6)
        # the engine replays the loop's addition order: bit-exact
        torch.testing.assert_close(eng, loop, rtol=0, atol=0)
        ref_eng = np.asarray(jb.cached_mask_engine(K, 7).masks(shape, r))
        np.testing.assert_allclose(eng.numpy(), ref_eng, rtol=0, atol=1e-6)
        # masks cancel: exactly for K = 2, to float32 rounding beyond
        tot = loop.sum(0)
        assert float(tot.abs().max()) <= (0.0 if K == 2 else 1e-5)


def test_int8_engine_masks_bit_exact_and_cancel():
    _, seeds = jb.cached_passive_setup(4, 7)
    want = np.asarray(jb.all_party_masks(4, seeds, (5, 6), 1, "int8"))
    got = tb.cached_mask_engine(4, 7).masks((5, 6), 1, "int8", device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    assert not (got.to(torch.int32).sum(0) % 256).any()


def test_serve_rounds_and_wire_bytes():
    assert tb.serve_round(3, 17) == int(jb.serve_round(3, 17))
    lanes = tb.serve_round(torch.tensor([0, 1, 2]), torch.tensor([5, 5, 9]))
    np.testing.assert_array_equal(
        lanes.numpy(), np.asarray(jb.serve_round(jnp.array([0, 1, 2]),
                                                 jnp.array([5, 5, 9]))))
    for mode in ("float", "int32", "int8"):
        assert tb.wire_elt_bytes(mode) == jb.wire_elt_bytes(mode)
        for n in (1, 3, 4, 4097, 32 * 64):
            assert tb.wire_leg_bytes(n, mode) == jb.wire_leg_bytes(n, mode)


def test_blind_uplink_float_and_ring_todo():
    """The float wire ships E + r in E's dtype and raw without masks; the
    ring wires (once a to-do, now ported) ship the quantized words plus
    the masks, wrapping, as the reference's blind_uplink does."""
    E = torch.arange(6.0).reshape(2, 3)
    m = torch.ones(2, 3, dtype=torch.float64)
    out = tb.blind_uplink(E, m, "float")
    assert out.dtype == torch.float32 and torch.equal(out, E + 1)
    assert tb.blind_uplink(E, None, "float") is E
    m32 = torch.tensor([[2 ** 31 - 1] * 3, [-5] * 3], dtype=torch.int32)
    want = jb.blind_uplink(jnp.asarray(E.numpy()), jnp.asarray(m32.numpy()),
                           "int32")
    np.testing.assert_array_equal(tb.blind_uplink(E, m32, "int32").numpy(),
                                  np.asarray(want))
    m8 = torch.tensor([[127] * 3, [-128] * 3], dtype=torch.int8)
    want = jb.blind_uplink(jnp.asarray(E.numpy()), jnp.asarray(m8.numpy()),
                           "int8", 10.0)
    got = tb.blind_uplink(E, m8, "int8", 10.0)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
