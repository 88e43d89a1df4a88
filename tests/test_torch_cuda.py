"""The port's CUDA kernels on the card, against their plain versions.

Marked ``requires_cuda``: they skip where torch sees no GPU (the kernels
have no CPU mode). This file imports no JAX, so it also runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: float32 within 1e-5 (the kernel multiplies by 1/C, the plain
version divides by C); bfloat16 within one bfloat16 ulp (2^-7 relative) of
the float32 accumulation both round. The in-kernel-mask forward against
its plain version (MaskEngine masks on the card through
``reference_blind_agg``): the masks agree bit for bit on the card (both
evaluate the same float32 steps with the same CUDA log1pf and sqrtf), so
only the order of the float32 sum over parties differs: within
(K + 2) * 2^-24 * S / C, S = |E_a| + sum_k (|E_k| + |r_k|), plus one ulp
of the output in its dtype.
"""
import numpy as np
import pytest
import torch

from repro_torch import checkpoint
from repro_torch.configs.base import EasterConfig
from repro_torch.core import blinding
from repro_torch.core.party_models import PartyArch
from repro_torch.core.protocol import EasterClassifier
from repro_torch.kernels import blind_agg as tba
from repro_torch.kernels import ref
from repro_torch.tree import tree_leaves

_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _f32(x):
    return x.detach().float().cpu().numpy()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,lead,d", [(3, (128,), 128), (63, (128,), 64),
                                      (3, (7,), 13), (2, (2, 64), 100)])
def test_cuda_kernels_match_plain(cuda, dtype, K, lead, d):
    gen = torch.Generator().manual_seed(K + d)
    ea, ep, mk = (torch.randn(s, generator=gen).to(_TDT[dtype])
                  for s in (lead + (d,), (K,) + lead + (d,),
                            (K,) + lead + (d,)))
    ts = [t.to(cuda).requires_grad_(True) for t in (ea, ep, mk)]
    ps = [t.detach().clone().requires_grad_(True) for t in ts]
    before = dict(tba.LAUNCHES)
    out = tba.blind_agg(*ts)
    want = ref.reference_blind_agg(*ps)
    g = torch.randn(want.shape, generator=gen).to(want.dtype).to(cuda)
    out.backward(g)
    want.backward(g)
    torch.cuda.synchronize()
    exact = _f32(ref.reference_blind_agg(ea.float(), ep.float(), mk.float()))
    tol = 2.0 ** -7 * np.abs(exact) if dtype == "bfloat16" else 1e-5
    assert (np.abs(_f32(out) - _f32(want)) <= tol).all()
    for a, b in zip(ts, ps):
        assert a.grad.dtype == b.grad.dtype
        np.testing.assert_allclose(_f32(a.grad), _f32(b.grad),
                                   rtol=2.0 ** -7, atol=1e-6)
    assert tba.LAUNCHES["blind_agg_fwd"] == before["blind_agg_fwd"] + 1
    assert tba.LAUNCHES["blind_agg_bwd"] == before["blind_agg_bwd"] + 1


@pytest.mark.requires_cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    ea = torch.zeros(4, 8, device=cuda)
    ep = torch.zeros(2, 4, 8, device=cuda)
    with pytest.raises(TypeError, match="dtype"):
        tba.blind_agg_fwd(ea.double(), ep.double(), ep.double())
    with pytest.raises(ValueError, match="shape"):
        tba.blind_agg_fwd(ea, ep, ep[:, :3])
    with pytest.raises(ValueError, match="contiguous"):
        tba.blind_agg_fwd(ea, ep.transpose(1, 2).contiguous().transpose(1, 2),
                          ep)
    with pytest.raises(ValueError, match="CUDA"):
        tba.blind_agg_fwd(ea, ep.cpu(), ep)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("grad_mode", ["easter", "joint"])
def test_cuda_round_goes_through_the_kernels(cuda, grad_mode):
    arches = [PartyArch("mlp", (16,), (8,), 12, 5)] * 4
    sys = EasterClassifier(EasterConfig(num_passive=3, d_embed=12), arches,
                           [6] * 4, grad_mode=grad_mode)
    assert sys.device.type == "cuda"
    params = sys.init_params(torch.Generator().manual_seed(0))
    init_opt, step = sys.make_train_step("adam", 1e-3)
    opt = init_opt(params)
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn(8, 6, generator=gen).to(cuda) for _ in range(4)]
    y = torch.randint(0, 5, (8,), generator=gen).to(cuda)
    tba.reset_launches()
    _, _, total, per = step(params, opt, xs, y, sys.masks(8, 0))
    assert torch.isfinite(per).all()
    assert tba.LAUNCHES["blind_agg_fwd"] == 1
    assert tba.LAUNCHES["blind_agg_bwd"] == (1 if grad_mode == "joint" else 0)


def _prng_tol(ea, ep, masks, want):
    K = ep.shape[0]
    S = ea.float().abs() + (ep.float().abs() + masks.float().abs()).sum(0)
    w = want.float().abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - (
        8 if want.dtype == torch.bfloat16 else 24))
    return (K + 2) * 2.0 ** -24 * S / (K + 1) + ulp


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,lead,d,r,scale", [
    (2, (128,), 64, 0, 1.0), (3, (100,), 100, 7, 4.0),
    (63, (128,), 64, blinding.SERVE_DOMAIN + 3, 1.0),
    (7, (2, 64), 128, 1, 4.0)])
def test_cuda_prng_kernel_matches_plain(cuda, dtype, K, lead, d, r, scale):
    eng = blinding.cached_mask_engine(K, 7)
    gen = torch.Generator().manual_seed(K + d)
    ea, ep = (torch.randn(s, generator=gen).to(_TDT[dtype]).to(cuda)
              for s in (lead + (d,), (K,) + lead + (d,)))
    ts = [t.clone().requires_grad_(True) for t in (ea, ep)]
    ps = [t.clone().requires_grad_(True) for t in (ea, ep)]
    before = dict(tba.LAUNCHES)
    out = tba.prng_blind_agg(*ts, eng, r, scale)
    want = ref.reference_blind_agg_prng(*ps, eng, r, mask_scale=scale)
    g = torch.randn(want.shape, generator=gen).to(want.dtype).to(cuda)
    out.backward(g)
    want.backward(g)
    torch.cuda.synchronize()
    masks = eng.masks(lead + (d,), r, "float", scale=scale, device=cuda)
    tol = _prng_tol(ea, ep, masks.to(ep.dtype), want)
    assert ((out.float() - want.float()).abs() <= tol).all()
    for a, b in zip(ts, ps):
        assert a.grad.dtype == b.grad.dtype
        np.testing.assert_allclose(_f32(a.grad), _f32(b.grad),
                                   rtol=2.0 ** -7, atol=1e-6)
    assert (tba.LAUNCHES["blind_agg_prng_fwd"]
            == before["blind_agg_prng_fwd"] + 1)
    assert tba.LAUNCHES["blind_agg_bwd"] == before["blind_agg_bwd"] + 1
    assert tba.LAUNCHES["blind_agg_fwd"] == before["blind_agg_fwd"]


@pytest.mark.requires_cuda
def test_cuda_prng_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    eng = blinding.cached_mask_engine(3, 7)
    tabs = tba.device_tables(eng, cuda)
    ea = torch.zeros(4, 8, device=cuda)
    ep = torch.zeros(3, 4, 8, device=cuda)
    with pytest.raises(TypeError, match="int32"):
        tba.blind_agg_prng_fwd(ea, ep, tabs[0].float(), *tabs[1:], 0)
    with pytest.raises(ValueError, match="shape"):
        tba.blind_agg_prng_fwd(ea, ep[:2], *tabs, 0)
    with pytest.raises(ValueError, match="uint32"):
        tba.blind_agg_prng_fwd(ea, ep, *tabs, -1)
    with pytest.raises(ValueError, match="CUDA"):
        tba.blind_agg_prng_fwd(ea, ep.cpu(), *tabs, 0)


@pytest.mark.requires_cuda
def test_cuda_fused_mask_step_matches_cpu(cuda):
    """One vectorized fused-mask adam step on the card against the same
    step on the CPU port (which materializes MaskEngine masks): per-party
    losses within rtol 1e-4 and parameters within 1e-5 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    C = 8
    arches = [PartyArch("mlp", w, (w[-1],), 16, 5)
              for w in [(16, 8), (8,), (24, 12), (12,)] * 2]
    cfg = EasterConfig(num_passive=C - 1, d_embed=16)
    card = EasterClassifier(cfg, arches, [6] * C, fused_masks=True)
    cpu = EasterClassifier(cfg, arches, [6] * C, fused_masks=True,
                           device="cpu")
    params0 = checkpoint.params_to_numpy(
        cpu.init_params(torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    xs = [torch.randn(32, 6, generator=gen) for _ in range(C)]
    y = torch.randint(0, 5, (32,), generator=gen)
    out = []
    for sys_, dev in ((card, cuda), (cpu, "cpu")):
        params = checkpoint.params_from_numpy(params0, dev)
        init_opt, step = sys_.make_train_step("adam", 1e-3)
        tba.reset_launches()
        _, _, _, per = step(params, init_opt(params), [x.to(dev) for x in xs],
                            y.to(dev), sys_.masks(32, 3))
        out.append((per.cpu(), [t.detach().cpu() for t in
                                tree_leaves(params)], dict(tba.LAUNCHES)))
    assert out[0][2]["blind_agg_prng_fwd"] == 1
    assert out[0][2]["blind_agg_fwd"] == 0
    assert out[1][2]["blind_agg_prng_fwd"] == 0
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
