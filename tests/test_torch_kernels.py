"""The port's blind+aggregate against the JAX reference kernel.

On the CPU ``ops.blind_agg`` runs the kernel's plain version; it is held
against ``repro.kernels.blind_agg.blind_agg`` in Pallas interpret mode and
against ``ref.reference_blind_agg``, values and gradients. ``ops.blind_agg_prng``
(in-kernel masks) runs its plain version, MaskEngine masks through
``reference_blind_agg``, held against ``repro.kernels.ops.blind_agg_prng``,
which off the TPU is the reference's MaskEngine path. The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py).

Tolerances: float32 within 1e-5 (the reference kernel multiplies by 1/C
and sums K in tiles, the plain version divides by C after one sum: a few
ulps apart). bfloat16 outputs within one bfloat16 ulp of the float32
accumulation (both round the same float32 sum, which may differ by an
ulp before rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import blinding as jb
from repro.kernels import blind_agg as jba
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import blinding as tb
from repro_torch.kernels import blind_agg as tba
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small eager torch ops: they finish sooner on one thread than
    on a thread pool contended by the other test workers on the same
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(K, lead, d, dtype, seed, mask_dtype=None):
    rng = np.random.default_rng(seed)
    ea = rng.normal(size=lead + (d,)).astype(np.float32)
    ep = rng.normal(size=(K,) + lead + (d,)).astype(np.float32)
    mk = rng.normal(size=(K,) + lead + (d,)).astype(np.float32)
    md = mask_dtype or dtype
    j = (jnp.asarray(ea, _JDT[dtype]), jnp.asarray(ep, _JDT[dtype]),
         jnp.asarray(mk, _JDT[md]))
    t = (torch.from_numpy(ea).to(_TDT[dtype]),
         torch.from_numpy(ep).to(_TDT[dtype]),
         torch.from_numpy(mk).to(_TDT[md]))
    return j, t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _assert_close(got, want, dtype, exact):
    """float32 within 1e-5; bfloat16 within one bfloat16 ulp (2^-7
    relative, per element) of the float32-accumulated value ``exact``."""
    got, want = _f32(got), _f32(want)
    tol = 2.0 ** -7 * np.abs(exact) * 1.0001 if dtype == "bfloat16" else 1e-5
    err = np.abs(got - want)
    assert (err <= tol).all(), f"max abs err {err.max()} ({dtype})"


@pytest.mark.parametrize("K,lead,d,dtype", [
    (1, (16,), 24, "float32"), (3, (7,), 13, "float32"),
    (8, (100,), 40, "float32"), (63, (33,), 20, "float32"),
    (3, (100,), 24, "bfloat16"), (8, (2, 9), 24, "float32"),
    (3, (2, 9), 16, "bfloat16"),
])
def test_plain_blind_agg_matches_reference_kernel(K, lead, d, dtype):
    (jea, jep, jmk), (tea, tep, tmk) = _inputs(K, lead, d, dtype, K + d)
    want = jba.blind_agg(jea, jep, jmk, interpret=True)
    oracle = jref.reference_blind_agg(jea, jep, jmk)
    got = ops.blind_agg(tea, tep, tmk)
    assert tuple(got.shape) == want.shape and got.dtype == _TDT[dtype]
    exact = _f32(ref.reference_blind_agg(tea.float(), tep.float(),
                                         tmk.float()))
    _assert_close(got, want, dtype, exact)
    _assert_close(got, oracle, dtype, exact)


def test_plain_blind_agg_mixed_mask_dtype():
    (jea, jep, jmk), (tea, tep, tmk) = _inputs(3, (12,), 40, "bfloat16", 5,
                                               mask_dtype="float32")
    want = jba.blind_agg(jea, jep, jmk, interpret=True)
    got = ops.blind_agg(tea, tep, tmk)
    assert got.dtype == torch.bfloat16
    exact = _f32(ref.reference_blind_agg(tea.float(), tep.float(), tmk))
    _assert_close(got, want, "bfloat16", exact)


@pytest.mark.parametrize("K", [3, 16, 64])
def test_plain_blind_agg_grads_match_custom_vjp(K):
    """Autograd through the plain version equals jax.grad through the
    reference kernel's custom VJP, for E_a, every E_k and every mask."""
    (jea, jep, jmk), (tea, tep, tmk) = _inputs(K, (12,), 40, "float32", K)

    def f_kernel(ea, ep, m):
        return jnp.sum(jnp.sin(jba.blind_agg(ea, ep, m, block_k=8,
                                             interpret=True)))

    gj = jax.grad(f_kernel, argnums=(0, 1, 2))(jea, jep, jmk)
    ts = [t.clone().requires_grad_(True) for t in (tea, tep, tmk)]
    torch.sin(ops.blind_agg(*ts)).sum().backward()
    for a, b in zip(gj, ts):
        assert tuple(b.grad.shape) == a.shape
        np.testing.assert_allclose(_f32(b.grad), _f32(a), rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_aggregation_matches_reference(use_kernel):
    """The port's aggregation, which always goes through the dispatcher,
    against the reference's with its kernel route on and off."""
    from repro.core import aggregation as jagg
    from repro_torch.core import aggregation as tagg
    (jea, jep, jmk), (tea, tep, tmk) = _inputs(3, (10,), 24, "float32", 11)
    jall = jnp.concatenate([jea[None], jep])
    tall = torch.cat([tea[None], tep])
    for got, want in (
            (tagg.blind_and_aggregate(tall, tmk),
             jagg.blind_and_aggregate(jall, jmk, use_kernel=use_kernel)),
            (tagg.aggregate(tea, tagg.blind(tep, tmk)),
             jagg.aggregate(jea, jagg.blind(jep, jmk), use_kernel=use_kernel)),
            (tagg.blind_and_aggregate(tall, None),
             jagg.blind_and_aggregate(jall, None))):
        _assert_close(got, want, "float32", None)
    dea, dep, dmk = ref.reference_blind_agg_bwd(tea, 3, torch.float32,
                                                torch.bfloat16, need_mk=False)
    assert dmk is None and dep.shape == (3, 10, 24)
    torch.testing.assert_close(dep[2], dea, rtol=0, atol=0)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """For a CPU tensor the kernel wrappers raise (the plain version is the
    dispatcher's choice, never the wrapper's fallback) and count nothing."""
    tba.reset_launches()
    ea, ep = torch.zeros(4, 8), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tba.blind_agg(ea, ep, ep)
    with pytest.raises(ValueError, match="CUDA"):
        tba.blind_agg_bwd(ea, 2, torch.float32, torch.float32)
    eng = tb.cached_mask_engine(2, 7)
    with pytest.raises(ValueError, match="CUDA"):
        tba.prng_blind_agg(ea, ep, eng, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tba.blind_agg_prng_fwd(ea, ep, *tba.device_tables(eng, "cpu"), 0)
    ops.blind_agg(ea, ep, ep)
    ops.blind_agg_prng(ea, ep, eng, 0)
    assert tba.LAUNCHES == {"blind_agg_fwd": 0, "blind_agg_bwd": 0,
                            "blind_agg_prng_fwd": 0}
    assert tba.FWD_GROUPS == {}


@pytest.mark.parametrize("nd,K,G", [
    (128 * 128, 3, 1),        # Table II
    (128 * 64, 63, 16),       # the many-party benchmark's unfused rounds
    (2048 * 128, 3, 1),       # a serving admission of 2048 tokens
    (4 * 128, 3, 1),          # a serving decode round at 4 lanes
    (128 * 64, 8, 2), (128 * 64, 16, 4),
    (2048 * 128, 63, 1)])     # 256 CTAs of the walk already cover the SMs
def test_fwd_party_groups_at_the_timed_shapes(nd, K, G):
    assert tba.fwd_party_groups(nd, K) == G


def test_fwd_party_groups_stays_within_the_kernel():
    """1 <= G <= min(max(K, 1), 16), a power of two (it divides the CTA's
    128 threads), every group at least 4 parties once G > 1, and G = 1
    where the kernel runs its scalar path (N*d not a multiple of 8)."""
    for nd in (8, 64, 100, 512, 8192, 8200, 16384, 262144, 1 << 24):
        for K in (0, 1, 2, 3, 5, 8, 9, 31, 33, 63, 64, 127, 255, 1000):
            G = tba.fwd_party_groups(nd, K)
            assert 1 <= G <= min(max(K, 1), tba.FWD_MAX_GROUPS)
            assert G & (G - 1) == 0
            assert tba.FWD_THREADS % G == 0
            assert tba.fwd_vectors(G) * G == tba.FWD_THREADS
            if G > 1:
                assert -(-K // G) >= tba.FWD_MIN_PARTIES
            if nd % 8:
                assert G == 1


# ---------------------------------------------------------------------------
# in-kernel masks: the plain version against the reference's off-TPU path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,lead", [(2, (8,)), (3, (2, 3)), (7, (8,))])
def test_plain_blind_agg_prng_matches_reference(K, lead, dtype):
    """Values at rounds 0, 1 and SERVE_DOMAIN + 5 with mask_scale 1 and 4;
    the gradients of E_a and every E_k at the last of them. (One shape
    per party count: the reference compiles its MaskEngine scan anew for
    every party count and shape, seconds each.)

    Tolerance, per element, from S = |E_a| + sum_k (|E_k| + |r_k|): the
    reference rounds E_k + r_k, the sum and the division in E's dtype, the
    port accumulates in float32 and rounds once, and the float masks
    differ by up to 1e-6 a pair mask (torch's log1p), which may move a
    bfloat16 mask by one ulp. So (4K + 3) * u * S / C, with u the unit
    roundoff of the dtype, plus one ulp of the output. Gradients (g / C in
    E's dtype on both sides) within one ulp."""
    d = 16
    jeng, teng = jb.cached_mask_engine(K, 7), tb.cached_mask_engine(K, 7)
    (jea, jep, _), (tea, tep, _) = _inputs(K, lead, d, dtype, K + len(lead))
    u = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -24
    for r in (0, 1, jb.SERVE_DOMAIN + 5):
        for scale in (1.0, 4.0):
            want = jops.blind_agg_prng(jea, jep, jeng, r, mask_scale=scale)
            got = ops.blind_agg_prng(tea, tep, teng, r, mask_scale=scale)
            assert got.dtype == _TDT[dtype] and tuple(got.shape) == want.shape
            masks = teng.masks(lead + (d,), r, "float", scale=scale,
                               device="cpu")
            S = tea.float().abs() + (tep.float().abs() + masks.abs()).sum(0)
            ulp = np.spacing(np.abs(_f32(want)).astype(np.float32)) * (
                2.0 ** 16 if dtype == "bfloat16" else 1.0)
            tol = (4 * K + 3) * u * _f32(S) / (K + 1) + ulp
            err = np.abs(_f32(got) - _f32(want))
            assert (err <= tol).all(), (r, scale, err.max())
    g = np.random.default_rng(K).normal(size=lead + (d,)).astype(np.float32)
    jga, jgp = jax.grad(
        lambda ea, ep: jnp.sum(jops.blind_agg_prng(
            ea, ep, jeng, r, mask_scale=scale).astype(jnp.float32) * g),
        argnums=(0, 1))(jea, jep)
    ts = [t.clone().requires_grad_(True) for t in (tea, tep)]
    out = ops.blind_agg_prng(*ts, teng, r, mask_scale=scale)
    (out.float() * torch.from_numpy(g)).sum().backward()
    for a, b in zip((jga, jgp), ts):
        assert b.grad.dtype == _TDT[dtype]
        np.testing.assert_allclose(_f32(b.grad), _f32(a), rtol=2 * u,
                                   atol=1e-7)


def test_plain_blind_agg_prng_is_the_mask_engine_path():
    """On the CPU the dispatcher's result is MaskEngine masks (cast to E's
    dtype) through reference_blind_agg, bit for bit, and the masks cancel:
    the result is the unmasked mean to within the masks' rounding."""
    K = 5
    eng = tb.cached_mask_engine(K, 7)
    _, (tea, tep, _) = _inputs(K, (6,), 24, "float32", 1)
    got = ops.blind_agg_prng(tea, tep, eng, 3, mask_scale=2.0)
    masks = eng.masks((6, 24), 3, "float", scale=2.0, device="cpu")
    want = ref.reference_blind_agg(tea, tep, masks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    mean = (tea + tep.sum(0)) / (K + 1)
    assert float((got - mean).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="mask engine"):
        tba.prng_blind_agg(tea, tep[:3], eng, 0)
