"""The port's blind+aggregate against the JAX reference kernel.

On the CPU ``ops.blind_agg`` runs the kernel's plain version; it is held
against ``repro.kernels.blind_agg.blind_agg`` in Pallas interpret mode and
against ``ref.reference_blind_agg``, values and gradients. The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py).

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

from repro.kernels import blind_agg as jba
from repro.kernels import ref as jref
from repro_torch.kernels import blind_agg as tba
from repro_torch.kernels import ops, ref

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
    ops.blind_agg(ea, ep, ep)
    assert tba.LAUNCHES == {"blind_agg_fwd": 0, "blind_agg_bwd": 0}
    with pytest.raises(NotImplementedError, match="queue 2 item 3"):
        ops.blind_agg_prng(ea, ep, None, 0)
