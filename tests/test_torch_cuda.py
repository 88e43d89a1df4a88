"""The port's CUDA kernels on the card, against their plain versions.

Marked ``requires_cuda``: they skip where torch sees no GPU (the kernels
have no CPU mode). This file imports no JAX, so it also runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: float32 within 1e-5 (the kernel multiplies by 1/C, the plain
version divides by C); bfloat16 within one bfloat16 ulp (2^-7 relative) of
the float32 accumulation both round.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import EasterConfig
from repro_torch.core.party_models import PartyArch
from repro_torch.core.protocol import EasterClassifier
from repro_torch.kernels import blind_agg as tba
from repro_torch.kernels import ref

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
