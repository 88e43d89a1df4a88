"""The port's CUDA kernels on the card, against their plain versions.

Marked ``requires_cuda``: they skip where torch sees no GPU (the kernels
have no CPU mode). This file imports no JAX, so it also runs on a GPU
machine without it:

    PYTHONPATH=src python -m pytest -q -m requires_cuda tests/test_torch_cuda.py

Tolerances: float32 within 1e-5 (the kernel multiplies by 1/C, the plain
version divides by C); bfloat16 within one bfloat16 ulp (2^-7 relative) of
the float32 accumulation both round (at the LM training shape's million
outputs, plus the sum-order bound below: some sums there cancel to near
zero, where one ulp is below the float32 rounding). The in-kernel-mask forward against
its plain version (MaskEngine masks on the card through
``reference_blind_agg``): the masks agree bit for bit on the card (both
evaluate the same float32 steps with the same CUDA log1pf and sqrtf), so
only the order of the float32 sum over parties differs: within
(K + 2) * 2^-24 * S / C, S = |E_a| + sum_k (|E_k| + |r_k|), plus one ulp
of the output in its dtype. Flash attention against its plain version:
the reference sweep's tolerance, atol 3e-5 (float32) or 3e-2 (bfloat16)
and rtol 1e-2; bfloat16 (whose kernel rounds P to bfloat16 for the PV
product) also within |out - exact| <= ulp_bf16(exact) + 2^-8 A(q, k, |v|)
+ 1e-5 of float32 attention on the same inputs, A being attention with
|v| in place of v (see ``_bf16_bound_used``). The RG-LRU
recurrence against its plain version: within rtol 1e-6 / atol 1e-6 (both
round a multiply, then an add, in float32: bit for bit is expected).
EasterLM training steps against the CPU port: losses, gradients and
updated params within rtol 1e-4 / atol 1e-5 (float32, TF32 off). The MoE
and SSM parties (plain torch ops, no kernel of their own): the MoE layer
at qwen2-moe-a2.7b's width run twice gives the same bits; the SSD mixer at
mamba2-2.7b's width over a 2047-token prompt against the CPU within rtol
1e-4 / atol 1e-5 x max|out| (float32, TF32 off: matmuls of 2,560 and
5,120 terms summed in another order); the smoke variants' EasterLM
prefill and decode round within rtol 1e-4 / atol 1e-5, as Griffin's;
the frontend families' (whisper-small, qwen2-vl-7b) smoke variants the
same, whisper's cross K/V included.
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
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as trg
from repro_torch.tree import tree_leaves, tree_map

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


# each K at every party-group count G the forward's rule can return (the
# powers of two up to 16) that K takes (G <= K)
_FWD_K = (1, 2, 3, 7, 8, 9, 31, 32, 33, 63, 64, 127, 255)
_FWD_KG = [(K, G) for K in _FWD_K for G in (1, 2, 4, 8, 16) if G <= K]


def _agg_inputs(K, N, d, dtype, mdtype, seed):
    gen = torch.Generator().manual_seed(seed)
    ea, ep = (torch.randn(s, generator=gen).to(dtype)
              for s in ((N, d), (K, N, d)))
    mk = torch.randn((K, N, d), generator=gen).to(mdtype)
    return ea, ep, mk


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K,G", _FWD_KG)
def test_cuda_fwd_at_every_party_group(cuda, K, G):
    """float32 at N*d = 101 * 64: 808 output vectors, not a multiple of a
    CTA's V = 128 / G vectors for G < 16. Within 1e-5 of the plain
    version, each launch recorded under G, and the same bits on a second
    call."""
    ea, ep, mk = (t.to(cuda) for t in _agg_inputs(K, 101, 64, torch.float32,
                                                   torch.float32, K * 7 + G))
    tba.reset_launches()
    out = tba.blind_agg_fwd(ea, ep, mk, groups=G)
    again = tba.blind_agg_fwd(ea, ep, mk, groups=G)
    torch.cuda.synchronize()
    assert tba.FWD_GROUPS == {G: 2}
    assert torch.equal(out, again)
    want = ref.reference_blind_agg(ea, ep, mk)
    assert ((out - want).abs() <= 1e-5).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", _FWD_K)
def test_cuda_fwd_takes_the_rules_party_groups(cuda, K):
    """Without ``groups`` the wrapper launches fwd_party_groups(N*d, K)."""
    ea, ep, mk = (t.to(cuda) for t in _agg_inputs(K, 128, 64, torch.float32,
                                                   torch.float32, K))
    tba.reset_launches()
    out = tba.blind_agg_fwd(ea, ep, mk)
    torch.cuda.synchronize()
    assert tba.FWD_GROUPS == {tba.fwd_party_groups(128 * 64, K): 1}
    assert ((out - ref.reference_blind_agg(ea, ep, mk)).abs() <= 1e-5).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("N", [4, 512, 2048])
def test_cuda_fwd_at_serving_shapes(cuda, N):
    """The serving rounds: K = 3, d 128, bfloat16 embeddings and float32
    masks, N the prompt at admission or the 4 lanes of a decode round;
    within one bfloat16 ulp (2^-7 relative) of the float32 sum, the G the
    rule gives, the same bits twice."""
    ea, ep, mk = _agg_inputs(3, N, 128, torch.bfloat16, torch.float32, N)
    exact = ref.reference_blind_agg(ea.float(), ep.float(), mk)
    ea, ep, mk = ea.to(cuda), ep.to(cuda), mk.to(cuda)
    tba.reset_launches()
    out = tba.blind_agg_fwd(ea, ep, mk)
    again = tba.blind_agg_fwd(ea, ep, mk)
    torch.cuda.synchronize()
    assert tba.FWD_GROUPS == {tba.fwd_party_groups(N * 128, 3): 2}
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    want = ref.reference_blind_agg(ea, ep, mk)
    tol = 2.0 ** -7 * np.abs(_f32(exact))
    assert (np.abs(_f32(out) - _f32(want)) <= tol).all()
    assert (np.abs(_f32(out) - _f32(exact)) <= tol).all()


@pytest.mark.requires_cuda
def test_cuda_blind_agg_at_the_training_shape(cuda):
    """The LM training step's aggregation through autograd: K = 3, N =
    4 x 2048 tokens, d 128, bfloat16 embeddings, float32 masks that take
    no gradient. The forward, the G the rule gives and the same bits
    twice, within one bfloat16 ulp of the plain version and of the exact
    float32 sum plus the float32 rounding the order of the sum over
    parties moves (``_prng_tol``): among a million outputs some sums
    cancel to near zero, where one ulp is below that rounding (these
    inputs hold such sums). C = 4 is a power of two, so the backward's
    g / C equals the plain version's bit for bit; one launch of each
    kernel."""
    ea, ep, mk = _agg_inputs(3, 8192, 128, torch.bfloat16, torch.float32,
                             8192)
    exact = ref.reference_blind_agg(ea.float(), ep.float(), mk)
    g = torch.randn((8192, 128), generator=torch.Generator().manual_seed(19)
                    ).to(torch.bfloat16)
    ts = [t.to(cuda).requires_grad_(True) for t in (ea, ep)]
    ps = [t.detach().clone().requires_grad_(True) for t in ts]
    mk, g = mk.to(cuda), g.to(cuda)
    tba.reset_launches()
    out = tba.blind_agg(*ts, mk)
    want = ref.reference_blind_agg(*ps, mk)
    out.backward(g)
    want.backward(g)
    again = tba.blind_agg_fwd(*(t.detach() for t in ts), mk)
    torch.cuda.synchronize()
    assert tba.LAUNCHES["blind_agg_fwd"] == 2
    assert tba.LAUNCHES["blind_agg_bwd"] == 1
    assert tba.FWD_GROUPS == {tba.fwd_party_groups(8192 * 128, 3): 2}
    assert out.dtype == torch.bfloat16 and torch.equal(out, again)
    ea, ep = ts[0].detach(), ts[1].detach()
    assert ((out - want).float().abs()
            <= _prng_tol(ea, ep, mk, want)).all()
    assert ((out.float() - exact.to(cuda)).abs()
            <= _prng_tol(ea, ep, mk, exact.to(cuda, torch.bfloat16))).all()
    for a, b in zip(ts, ps):
        assert a.grad.dtype == b.grad.dtype
        assert torch.equal(a.grad.view(torch.uint8), b.grad.view(torch.uint8))


@pytest.mark.requires_cuda
def test_cuda_fwd_rejects_party_groups_it_cannot_take(cuda):
    """G outside [1, min(K, 16)], or G > 1 where the scalar path runs,
    fails at launch; a misaligned view takes the scalar path with G = 1."""
    ea, ep, mk = (t.to(cuda) for t in _agg_inputs(40, 16, 8, torch.float32,
                                                   torch.float32, 3))
    for G in (0, 17):
        with pytest.raises(RuntimeError, match="launch failed"):
            tba.blind_agg_fwd(ea, ep, mk, groups=G)
    with pytest.raises(RuntimeError, match="launch failed"):
        tba.blind_agg_fwd(ea, ep[:5], mk[:5], groups=8)           # G > K
    odd = [t[..., :7, :7].contiguous() for t in (ea, ep, mk)]  # N*d = 49
    with pytest.raises(RuntimeError, match="launch failed"):
        tba.blind_agg_fwd(*odd, groups=2)
    buf = torch.empty(ea.numel() + 1, device=cuda)
    shifted = buf[1:].view(ea.shape)
    shifted.copy_(ea)
    assert shifted.data_ptr() % 16 == 4
    tba.reset_launches()
    out = tba.blind_agg_fwd(shifted, ep, mk)
    assert tba.FWD_GROUPS == {1: 1}
    assert ((out - ref.reference_blind_agg(ea, ep, mk)).abs() <= 1e-5).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("K", [1, 3, 63, 127])
@pytest.mark.parametrize("need", [(a, b, c) for a in (True, False)
                                  for b in (True, False)
                                  for c in (True, False) if a or b or c])
@pytest.mark.parametrize("dtypes", [("float32", "float32", "float32"),
                                    ("bfloat16", "bfloat16", "float32")])
def test_cuda_bwd_is_the_plain_version_bit_for_bit(cuda, K, need, dtypes):
    """C = K + 1 is a power of two, so g * (1/C) is g / C exactly: every
    cotangent asked for equals reference_blind_agg_bwd's bit for bit, in
    its own dtype; one not asked for is None."""
    gt, pt, mt = (_TDT[t] for t in dtypes)
    gen = torch.Generator().manual_seed(K)
    g = torch.randn((100, 64), generator=gen).to(gt).to(cuda)
    need_ea, need_ep, need_mk = need
    before = tba.LAUNCHES["blind_agg_bwd"]
    got = tba.blind_agg_bwd(g, K, pt, mt, need_ea=need_ea, need_ep=need_ep,
                            need_mk=need_mk)
    torch.cuda.synchronize()
    assert tba.LAUNCHES["blind_agg_bwd"] == before + 1
    want = ref.reference_blind_agg_bwd(g, K, pt, mt, need_mk=True)
    for asked, a, b in zip(need, got, want):
        if not asked:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,lead,d", [(127, (7,), 13), (63, (3,), 7),
                                      (15, (5,), 13)])
def test_cuda_prng_last_tile_is_ragged(cuda, dtype, K, lead, d):
    """N*d not a multiple of the kernel's tile of outputs (2 at K = 127, 8
    at K = 63, 64 at K = 15): the last CTA draws past N*d and writes only
    its own outputs."""
    eng = blinding.cached_mask_engine(K, 7)
    gen = torch.Generator().manual_seed(K + d)
    ea, ep = (torch.randn(s, generator=gen).to(_TDT[dtype]).to(cuda)
              for s in (lead + (d,), (K,) + lead + (d,)))
    out = tba.prng_blind_agg(ea, ep, eng, 5, 4.0)
    want = ref.reference_blind_agg_prng(ea, ep, eng, 5, mask_scale=4.0)
    torch.cuda.synchronize()
    masks = eng.masks(lead + (d,), 5, "float", scale=4.0, device=cuda)
    tol = _prng_tol(ea, ep, masks.to(ep.dtype), want)
    assert out.shape == want.shape and out.dtype == want.dtype
    assert ((out.float() - want.float()).abs() <= tol).all()


@pytest.mark.requires_cuda
def test_cuda_prng_rejects_more_parties_than_a_tile_holds(cuda):
    """240 passive parties at most: two outputs' pair normals (4 K (K + 1)
    bytes with the partial sums) must fit in a CTA's shared memory."""
    K = 241
    tabs = [torch.zeros((K, K - 1), dtype=torch.int32, device=cuda)] * 3
    ea = torch.zeros(2, 4, device=cuda)
    ep = torch.zeros(K, 2, 4, device=cuda)
    before = tba.LAUNCHES["blind_agg_prng_fwd"]
    with pytest.raises(ValueError, match="at most 240"):
        tba.blind_agg_prng_fwd(ea, ep, *tabs, 0)
    assert tba.LAUNCHES["blind_agg_prng_fwd"] == before


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


# ---------------------------------------------------------------------------
# flash attention and the LM serving slice
# ---------------------------------------------------------------------------

_FLASH_HEADS = [(4, 4, 64), (4, 2, 64), (8, 1, 64), (4, 2, 128), (2, 2, 32),
                (16, 1, 256)]
_FLASH_MASKS = [(True, 0), (False, 0), (True, 32)]


def _flash_inputs(B, S, T, Hq, Hkv, hd, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dtype).to(device)
            for s in ((B, S, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd))]


def _flash_close(out, want, dtype):
    """The reference sweep's tolerance: atol 3e-5 (float32) or 3e-2
    (bfloat16), rtol 1e-2."""
    atol = 3e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float().cpu(), want.float().cpu(),
                               atol=atol, rtol=1e-2)


def _bf16_bound_used(out, q, k, v, causal=True, window=0):
    """The largest share of the bfloat16 kernel's error bound that ``out``
    uses: |out - exact| <= ulp_bf16(exact) + 2^-8 A(q, k, |v|) + 1e-5, with
    exact float32 attention on the same (bfloat16) inputs and A(q, k, |v|)
    float32 attention with |v| in place of v. Rounding P to bfloat16 for
    the PV product moves each term p_j v_j by at most 2^-9 relative, so the
    output by at most 2^-9 A; the output's own rounding is within one ulp;
    2^-8 leaves a factor of two for the float32 score product and exp2. At
    the prefill shapes 2^-8 A is ~0.003, well under the 0.006-0.013 by which
    a dropped 64-key tile moves a late row, so a dropped tile still fails.
    Rows with nothing unmasked are held to the plain version too: its
    softmax over all -1e30 gives the mean of v there, as the kernel does."""
    qf, kf, vf = q.float(), k.float(), v.float()
    exact = ref.reference_attention(qf, kf, vf, causal=causal, window=window)
    mag = ref.reference_attention(qf, kf, vf.abs(), causal=causal,
                                  window=window)
    _, e = torch.frexp(exact.abs().clamp_min(torch.finfo(torch.float32).tiny))
    ulp = torch.ldexp(torch.ones_like(exact), e - 8)
    return float(((out.float() - exact).abs()
                  / (ulp + 2.0 ** -8 * mag + 1e-5)).max())


def _flash_bf16_check(q, k, v, causal=True, window=0):
    """One bfloat16 launch held to the sweep's tolerance (where every row
    sees a key) and to the kernel's error bound."""
    before = tfa.LAUNCHES["flash_attention_fwd"]
    out = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _bf16_bound_used(out, q, k, v, causal, window) <= 1
    return out


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", _FLASH_MASKS)
@pytest.mark.parametrize("Hq,Hkv,hd", _FLASH_HEADS)
@pytest.mark.parametrize("S", [64, 128, 256, 7, 100, 1023])
def test_cuda_flash_matches_plain(cuda, S, Hq, Hkv, hd, causal, window,
                                  dtype):
    """The reference sweep (S 64-256) plus ragged lengths (T = S), which
    the kernel takes as they are: tail rows unwritten, tail columns
    masked."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(2, S, S, Hq, Hkv, hd, dt, cuda, S + hd)
    before = tfa.LAUNCHES["flash_attention_fwd"]
    out = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_fwd"] == before + 1
    assert out.dtype == dt and out.shape == q.shape
    _flash_close(out, ref.reference_attention(q, k, v, causal=causal,
                                              window=window), dt)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 511), (1, 1023), (1, 2047), (3, 511),
                                 (3, 1023), (3, 2047)])
def test_cuda_flash_matches_plain_at_prefill_shapes(cuda, B, S, dtype):
    """The serving path's prefill shapes at qwen2.5-3b's heads (16/2/128,
    causal): the active party's (B = 1) and the passive group's folded
    into the batch axis (B = 3). bfloat16 is also held to the kernel's
    error bound against float32 attention on the same inputs
    (``_bf16_bound_used``): the sweep's atol 3e-2 is near a row's size at
    these lengths (~0.05 at S = 1023) and would pass a dropped 64-key
    tile, which moves a late row's elements by ~0.006-0.013."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(B, S, S, 16, 2, 128, dt, cuda, B * S)
    out = tfa.flash_attention_fwd(q, k, v, causal=True)
    _flash_close(out, ref.reference_attention(q, k, v), dt)
    if dt == torch.bfloat16:
        assert _bf16_bound_used(out, q, k, v) <= 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S", [(1, 511), (1, 2047), (3, 1023)])
def test_cuda_flash_matches_plain_at_recurrentgemma_prefill_shapes(cuda, B, S,
                                                                   dtype):
    """recurrentgemma-9b's local attention (16/1/256, causal, window
    2048) at its prefill shapes, with the tolerances of the qwen2.5-3b
    prefill shapes above."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(B, S, S, 16, 1, 256, dt, cuda, B * S + 1)
    out = tfa.flash_attention_fwd(q, k, v, causal=True, window=2048)
    _flash_close(out, ref.reference_attention(q, k, v, window=2048), dt)
    if dt == torch.bfloat16:
        assert _bf16_bound_used(out, q, k, v, window=2048) <= 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal,window", _FLASH_MASKS + [(False, 32)])
def test_cuda_flash_s_differs_from_t(cuda, causal, window):
    q, k, v = _flash_inputs(1, 50, 130, 4, 2, 64, torch.float32, cuda, 1)
    _flash_close(tfa.flash_attention_fwd(q, k, v, causal=causal,
                                         window=window),
                 ref.reference_attention(q, k, v, causal=causal,
                                         window=window), torch.float32)


@pytest.mark.requires_cuda
def test_cuda_flash_under_vmap_folds_the_party_axis(cuda):
    from torch.func import vmap
    q, k, v = _flash_inputs(3, 37, 37, 16, 2, 128, torch.bfloat16, cuda, 2)
    before = tfa.LAUNCHES["flash_attention_fwd"]
    with torch.no_grad():
        out = vmap(lambda a, b, c: ops.flash_attention(a[None], b[None],
                                                       c[None])[0])(q, k, v)
    assert tfa.LAUNCHES["flash_attention_fwd"] == before + 1
    _flash_close(out, ref.reference_attention(q, k, v), torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("Hq,Hkv,hd", [(4, 2, 32), (4, 2, 64), (16, 2, 128),
                                       (16, 1, 256)])
@pytest.mark.parametrize("S", [1, 63, 65, 127, 129, 2047])
def test_cuda_flash_bf16_tile_edges(cuda, S, Hq, Hkv, hd):
    """The bfloat16 kernel's tiles (128 query rows a CTA, 64 a warpgroup;
    128 kv rows a stage, 64 at hd 256) at lengths one short of, one past
    and inside them, at every head dim."""
    q, k, v = _flash_inputs(1, S, S, Hq, Hkv, hd, torch.bfloat16, cuda,
                            S + hd)
    out = _flash_bf16_check(q, k, v)
    _flash_close(out, ref.reference_attention(q, k, v), torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 100),
                                           (False, 100)])
@pytest.mark.parametrize("S,T", [(50, 130), (130, 50), (200, 129),
                                 (129, 300)])
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_flash_bf16_s_differs_from_t(cuda, hd, S, T, causal, window):
    """S != T: rows past S unwritten by TMA's clipped store, columns past T
    zero-filled by TMA and masked (no row here is left without a key)."""
    q, k, v = _flash_inputs(1, S, T, 16 if hd > 64 else 4, 2, hd,
                            torch.bfloat16, cuda, S * T + hd)
    out = _flash_bf16_check(q, k, v, causal, window)
    _flash_close(out, ref.reference_attention(q, k, v, causal=causal,
                                              window=window), torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [37, 100, 200])
@pytest.mark.parametrize("Hq,Hkv,hd", [(16, 2, 128), (16, 1, 256)])
def test_cuda_flash_bf16_window_cuts_mid_tile(cuda, Hq, Hkv, hd, window,
                                              causal):
    """Windows whose edge falls inside a kv tile, so that the per-element
    mask runs on tiles left of the diagonal as well."""
    q, k, v = _flash_inputs(1, 700, 700, Hq, Hkv, hd, torch.bfloat16, cuda,
                            window + hd)
    out = _flash_bf16_check(q, k, v, causal, window)
    _flash_close(out, ref.reference_attention(q, k, v, causal=causal,
                                              window=window), torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("Hq,Hkv,hd", [(16, 2, 128), (16, 1, 128),
                                       (16, 2, 256), (16, 1, 256)])
def test_cuda_flash_bf16_batch_and_groups(cuda, Hq, Hkv, hd):
    """B = 3 (the folded passive group) with 8 and 16 query heads per kv
    head: each (batch, head) CTA reads its own kv head's tiles."""
    q, k, v = _flash_inputs(3, 300, 300, Hq, Hkv, hd, torch.bfloat16, cuda,
                            Hq // Hkv + hd)
    out = _flash_bf16_check(q, k, v)
    _flash_close(out, ref.reference_attention(q, k, v), torch.bfloat16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_rows_with_nothing_unmasked_are_the_mean_of_v(cuda,
                                                                 dtype):
    """S = 130 > T = 50 with a window of 32: rows 81-129 see no key. Both
    kernels write them as the mean of v over the T keys, as the plain
    version's softmax over all -1e30 gives; every row agrees with it."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(1, 130, 50, 4, 2, 64, dt, cuda, 11)
    mean = v.float().mean(1).repeat_interleave(2, dim=1)   # (1, Hq, hd)
    for causal in (True, False):
        out = tfa.flash_attention_fwd(q, k, v, causal=causal, window=32)
        want = ref.reference_attention(q, k, v, causal=causal, window=32)
        _flash_close(out, want, dt)
        _flash_close(out[:, 81:], mean.to(dt).expand(1, 49, 4, 64), dt)
        if dt == torch.bfloat16:
            assert _bf16_bound_used(out, q, k, v, causal, 32) <= 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,T,window", [(400, 129, 100), (300, 64, 1),
                                        (200, 130, 70)])
@pytest.mark.parametrize("hd", [64, 256])
def test_cuda_flash_rows_that_see_no_key_across_tiles(cuda, hd, S, T, window,
                                                      causal, dtype):
    """The first row that sees no key (T + window - 1) inside a query tile
    and at a tile's edge, T past a kv tile's edge and inside one (TMA
    zero-fills the rest, which must not enter the mean), at two head
    dims."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(1, S, T, 16, 2, hd, dt, cuda, S + T + hd)
    out = tfa.flash_attention_fwd(q, k, v, causal=causal, window=window)
    _flash_close(out, ref.reference_attention(q, k, v, causal=causal,
                                              window=window), dt)
    if dt == torch.bfloat16:
        assert _bf16_bound_used(out, q, k, v, causal, window) <= 1


@pytest.mark.requires_cuda
def test_cuda_flash_bf16_rejects_a_misaligned_pointer(cuda):
    """The bfloat16 kernel's TMA tensor maps need 16-byte aligned data: a
    view 2 bytes into a buffer raises, and nothing falls back."""
    q, k, v = _flash_inputs(1, 8, 8, 4, 2, 64, torch.bfloat16, cuda, 4)
    buf = torch.empty(q.numel() + 8, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:q.numel() + 1].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    before = tfa.LAUNCHES["flash_attention_fwd"]
    with pytest.raises(ValueError, match="16-byte"):
        tfa.flash_attention_fwd(shifted, k, v)
    assert tfa.LAUNCHES["flash_attention_fwd"] == before


@pytest.mark.requires_cuda
def test_cuda_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 8, 8, 4, 2, 64, torch.float32, cuda, 3)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_fwd(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.flash_attention_fwd(q[..., :48].contiguous(),
                                k[..., :48].contiguous(),
                                v[..., :48].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2))
    with pytest.raises(ValueError, match="group"):
        tfa.flash_attention_fwd(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention_fwd(q, k.cpu(), v)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention_fwd(q.half(), k.half(), v.half())
    # the attention modes choose among CPU paths: on the card they raise
    from repro_torch.models import layers
    with pytest.raises(ValueError, match="CPU path"):
        layers._attend(q, k, v, True, 0, "chunked", 8)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_cuda_easter_lm_prefill_and_serve_step_match_cpu(cuda, engine):
    """The smoke variant of qwen2.5-3b: prefill of a ragged 11-token
    prompt and one decode round with per-lane nonces and a frozen lane,
    on the card against the CPU port (float32, TF32 off): embeddings and
    logits within rtol 1e-4 / atol 1e-5. On the card every prefill layer
    runs flash_attention_fwd (the vectorized engine folds the passive
    group into one launch a layer) and every round one blind_agg_fwd."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.easter_lm import EasterLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    card = EasterLM(cfg, EasterConfig(), engine=engine)
    cpu = EasterLM(cfg, EasterConfig(), engine=engine, device="cpu")
    params0 = cpu.export_params(
        cpu.init_params(torch.Generator().manual_seed(0)))
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(1))
    out = []
    for sys_ in (card, cpu):
        params = sys_.load_params(params0)
        seeds = sys_.mask_seeds()
        tba.reset_launches()
        tfa.reset_launches()
        t = tok.to(sys_.device)
        E, caches = sys_.prefill(params, t[:, :-1],
                                 sys_.init_caches(2, 16, per_lane=True),
                                 seeds=seeds, round_idx=3)
        logits, _ = sys_.serve_step(
            params, t[:, -1:], caches, torch.tensor([11, 11]), seeds,
            lane_mask=torch.tensor([True, False], device=sys_.device),
            nonces=torch.tensor([1, 2]))
        out.append((E.cpu(), logits.cpu(),
                    tfa.LAUNCHES["flash_attention_fwd"],
                    tba.LAUNCHES["blind_agg_fwd"]))
    La, Lp = card.party_cfgs[0].n_layers, card.party_cfgs[1].n_layers
    K = card.easter.num_passive
    assert out[0][2] == La + (Lp if engine == "vectorized" else K * Lp)
    assert out[0][3] == 2 and out[1][2:] == (0, 0)
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the RG-LRU recurrence and the recurrentgemma serving slice
# ---------------------------------------------------------------------------


def _rglru_inputs(B, L, W, dtype, device, seed, decay=False):
    gen = torch.Generator().manual_seed(seed)
    if decay:
        a = torch.full((B, L, W), 0.99)
        b = torch.full((B, L, W), 0.01)
        h0 = torch.zeros((B, W))
    else:
        a = torch.sigmoid(torch.randn((B, L, W), generator=gen))
        b = torch.randn((B, L, W), generator=gen) * 0.1
        h0 = torch.randn((B, W), generator=gen)
    return a.to(dtype).to(device), b.to(dtype).to(device), h0.to(device)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,W,decay", [
    (2, 64, 128, False), (1, 128, 256, False), (4, 32, 64, False),
    (3, 96, 128, False), (1, 512, 64, True), (2, 7, 100, False),
    (1, 1000, 4000, False), (3, 33, 1, False), (1, 2047, 4096, False)])
def test_cuda_rglru_matches_plain(cuda, B, L, W, decay, dtype):
    """The reference sweep, the 512-step decay case, ragged L and W, and
    recurrentgemma's width, from a non-zero h0 (zero for the decay)."""
    a, b, h0 = _rglru_inputs(B, L, W, _TDT[dtype], cuda, B * L + W, decay)
    before = trg.LAUNCHES["rglru_scan_fwd"]
    h, last = trg.rglru_scan_fwd(a, b, h0)
    torch.cuda.synchronize()
    assert trg.LAUNCHES["rglru_scan_fwd"] == before + 1
    assert h.dtype == last.dtype == torch.float32
    assert h.shape == (B, L, W) and last.shape == (B, W)
    want_h, want_last = ref.reference_rglru(a, b, h0)
    torch.testing.assert_close(h, want_h, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(last, want_last, rtol=1e-6, atol=1e-6)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("L", [1, 31, 33, 257, 1000])
@pytest.mark.parametrize("dtype,W,path", [
    ("float32", 4096, "tma"), ("float32", 100, "tma"),
    ("float32", 102, "per_column"), ("float32", 1, "per_column"),
    ("bfloat16", 4096, "tma"), ("bfloat16", 104, "tma"),
    ("bfloat16", 100, "per_column"), ("bfloat16", 36, "per_column")])
def test_cuda_rglru_path_by_shape(cuda, dtype, W, path, L):
    """The TMA ring where a row of a and b is a multiple of 16 bytes (W % 4
    == 0 in float32, W % 8 == 0 in bfloat16), one thread per column
    elsewhere; both bit for bit the plain version, at L that are not a
    multiple of the ring's 32-step stage or of its 8 stages, and B = 3 at
    recurrentgemma's width. Each launch counts under its own path."""
    B = 3 if W == 4096 else 2
    a, b, h0 = _rglru_inputs(B, L, W, _TDT[dtype], cuda, L + W)
    assert trg.kernel_path(a, b) == path
    before = dict(trg.PATH_LAUNCHES)
    h, last = trg.rglru_scan_fwd(a, b, h0)
    torch.cuda.synchronize()
    assert {p: n - before[p] for p, n in trg.PATH_LAUNCHES.items()} == {
        p: int(p == path) for p in before}
    want_h, want_last = ref.reference_rglru(a, b, h0)
    assert torch.equal(h, want_h) and torch.equal(last, want_last)


@pytest.mark.requires_cuda
def test_cuda_rglru_misaligned_input_runs_per_column(cuda):
    """A contiguous view 4 bytes into a buffer is not 16-byte aligned, so
    TMA cannot read it: the shape dispatch takes the per-column kernel,
    bit for bit the plain version."""
    a, b, h0 = _rglru_inputs(1, 40, 64, torch.float32, cuda, 6)
    buf = torch.empty(a.numel() + 4, device=cuda)
    shifted = buf[1:a.numel() + 1].view(a.shape)
    shifted.copy_(a)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    assert trg.kernel_path(shifted, b) == "per_column"
    h, last = trg.rglru_scan_fwd(shifted, b, h0)
    want_h, want_last = ref.reference_rglru(a, b, h0)
    assert torch.equal(h, want_h) and torch.equal(last, want_last)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_rglru_empty_sequence(cuda, dtype):
    """L = 0: no step, h_last is h0 (the per-column kernel; TMA takes no
    empty box)."""
    a, b, h0 = _rglru_inputs(2, 0, 64, _TDT[dtype], cuda, 7)
    assert trg.kernel_path(a, b) == "per_column"
    h, last = trg.rglru_scan_fwd(a, b, h0)
    assert h.shape == (2, 0, 64) and torch.equal(last, h0)


@pytest.mark.requires_cuda
def test_cuda_rglru_under_vmap_folds_the_party_axis(cuda):
    from torch.func import vmap
    a, b, h0 = _rglru_inputs(3, 50, 96, torch.float32, cuda, 4)
    a, b = a.reshape(3, 1, 50, 96), b.reshape(3, 1, 50, 96)
    before = trg.LAUNCHES["rglru_scan_fwd"]
    with torch.no_grad():
        h, last = vmap(lambda x, y: ops.rglru_scan(x, y, h0[:1]))(a, b)
    assert trg.LAUNCHES["rglru_scan_fwd"] == before + 1
    for i in range(3):
        wh, wl = ref.reference_rglru(a[i], b[i], h0[:1])
        torch.testing.assert_close(h[i], wh, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(last[i], wl, rtol=1e-6, atol=1e-6)


@pytest.mark.requires_cuda
def test_cuda_rglru_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    a, b, h0 = _rglru_inputs(2, 8, 16, torch.float32, cuda, 5)
    with pytest.raises(TypeError, match="dtypes"):
        trg.rglru_scan_fwd(a, b.bfloat16(), h0)
    with pytest.raises(TypeError, match="h0"):
        trg.rglru_scan_fwd(a, b, h0.bfloat16())
    with pytest.raises(ValueError, match="shape"):
        trg.rglru_scan_fwd(a, b, h0[:1])
    with pytest.raises(ValueError, match="contiguous"):
        trg.rglru_scan_fwd(a.transpose(1, 2), b.transpose(1, 2),
                           h0[:, :8])
    with pytest.raises(ValueError, match="CUDA"):
        trg.rglru_scan_fwd(a, b.cpu(), h0)
    with pytest.raises(ValueError, match="one device type"):
        ops.rglru_scan(a, b.cpu(), h0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["vectorized", "loop"])
def test_cuda_griffin_easter_lm_matches_cpu(cuda, engine):
    """The smoke variant of recurrentgemma-9b: prefill of a 40-token
    prompt (past the window of 32) and one decode round, on the card
    against the CPU port (float32, TF32 off): embeddings and logits within
    rtol 1e-4 / atol 1e-5. Every prefill's RG-LRU layer runs
    rglru_scan_fwd and every attention layer flash_attention_fwd (the
    vectorized engine folds the passive group into one launch a layer)."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.easter_lm import EasterLM
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config("recurrentgemma-9b"))
    card = EasterLM(cfg, EasterConfig(), engine=engine)
    cpu = EasterLM(cfg, EasterConfig(), engine=engine, device="cpu")
    params0 = cpu.export_params(
        cpu.init_params(torch.Generator().manual_seed(0)))
    tok = torch.randint(0, cfg.vocab_size, (2, 41),
                        generator=torch.Generator().manual_seed(1))
    out = []
    for sys_ in (card, cpu):
        params = sys_.load_params(params0)
        seeds = sys_.mask_seeds()
        trg.reset_launches()
        tfa.reset_launches()
        t = tok.to(sys_.device)
        E, caches = sys_.prefill(params, t[:, :-1],
                                 sys_.init_caches(2, 48, per_lane=True),
                                 seeds=seeds, round_idx=3)
        logits, _ = sys_.serve_step(
            params, t[:, -1:], caches, torch.tensor([40, 40]), seeds,
            lane_mask=torch.tensor([True, False], device=sys_.device),
            nonces=torch.tensor([1, 2]))
        out.append((E.cpu(), logits.cpu(), trg.LAUNCHES["rglru_scan_fwd"],
                    tfa.LAUNCHES["flash_attention_fwd"]))
    K = card.easter.num_passive
    per = 1 if engine == "vectorized" else K
    assert out[0][2:] == (2 + 2 * per, 1 + per)
    assert out[1][2:] == (0, 0)
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("arch,n_layers", [
    ("qwen2-moe-a2.7b", None), ("mamba2-2.7b", None), ("gemma3-4b", 7)])
def test_cuda_moe_ssm_gemma3_easter_lm_match_cpu(cuda, arch, n_layers,
                                                 engine):
    """The smoke variants of the MoE and SSM families and a 7-layer
    gemma3-4b cut (a (local x5, global) period): prefill of a 40-token
    prompt (past gemma3's window of 32; the SSD's padded chunk) and one
    decode round, card against the CPU port (float32, TF32 off), within
    rtol 1e-4 / atol 1e-5. Every attention layer's prefill launches
    flash_attention_fwd (once for the passive group on the vectorized
    engine); the SSM stack launches none."""
    import dataclasses
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    card = EasterLM(cfg, EasterConfig(), engine=engine)
    cpu = EasterLM(cfg, EasterConfig(), engine=engine, device="cpu")
    params0 = cpu.export_params(
        cpu.init_params(torch.Generator().manual_seed(0)))
    tok = torch.randint(0, cfg.vocab_size, (2, 41),
                        generator=torch.Generator().manual_seed(1))
    out = []
    for sys_ in (card, cpu):
        params = sys_.load_params(params0)
        seeds = sys_.mask_seeds()
        tfa.reset_launches()
        t = tok.to(sys_.device)
        E, caches = sys_.prefill(params, t[:, :-1],
                                 sys_.init_caches(2, 48, per_lane=True),
                                 seeds=seeds, round_idx=3)
        logits, _ = sys_.serve_step(
            params, t[:, -1:], caches, torch.tensor([40, 40]), seeds,
            lane_mask=torch.tensor([True, False], device=sys_.device),
            nonces=torch.tensor([1, 2]))
        out.append((E.cpu(), logits.cpu(),
                    tfa.LAUNCHES["flash_attention_fwd"]))
    attn = lambda c: sum(k != "ssm" for ks, r in transformer.stack_plan(c)
                         for k in ks * r)
    K = card.easter.num_passive
    per = 1 if engine == "vectorized" else K
    assert out[0][2] == attn(card.party_cfgs[0]) + per * attn(
        card.party_cfgs[1])
    assert out[1][2] == 0
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,T,heads,causal", [
    (1, 1500, 1500, (12, 12, 64), False), (4, 1500, 1500, (12, 12, 64), False),
    (4, 3, 1500, (12, 12, 64), False), (12, 1, 1500, (12, 12, 64), False),
    (4, 1, 1500, (12, 12, 64), False), (1, 1279, 1279, (28, 4, 128), True),
    (4, 2047, 2047, (28, 4, 128), True)])
def test_cuda_flash_matches_plain_at_frontend_shapes(cuda, B, S, T, heads,
                                                     causal, dtype):
    """The frontend families' shapes: whisper-small's non-causal encoder
    over 1500 frames (12/12/64) and its cross-attention (S = 3 at the
    prefill, S = 1 in a decode round, against T = 1500, B = 4 lanes or the
    passive group's 12), qwen2-vl-7b's causal 28/4/128 prefills (a GQA
    group of 7: query head h reads kv head h // 7), with the tolerances
    of the prefill shapes above."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(B, S, T, *heads, dt, cuda, B * S + T)
    out = tfa.flash_attention_fwd(q, k, v, causal=causal)
    _flash_close(out, ref.reference_attention(q, k, v, causal=causal), dt)
    if dt == torch.bfloat16:
        assert _bf16_bound_used(out, q, k, v, causal) <= 1


@pytest.mark.requires_cuda
@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("arch", ["whisper-small", "qwen2-vl-7b"])
def test_cuda_frontend_easter_lm_match_cpu(cuda, arch, engine):
    """The frontend families' smoke variants served on the card against
    the CPU port (float32, TF32 off, rtol 1e-4 / atol 1e-5): whisper's
    encoder_kv, a prefill and a decode round given the cross K/V;
    qwen2-vl's prefill of 20 tokens with its 8 patch embeddings and a
    decode round. Launches: one flash_attention_fwd per encoder layer and
    per self- and cross-attention layer (once for the passive group on
    the vectorized engine), the decode round's cross-attention included."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.models.build import frontend_inputs
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    card = EasterLM(cfg, EasterConfig(), engine=engine)
    cpu = EasterLM(cfg, EasterConfig(), engine=engine, device="cpu")
    params0 = cpu.export_params(
        cpu.init_params(torch.Generator().manual_seed(0)))
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 21), generator=gen)
    fe = frontend_inputs(cfg, 2, gen)
    out = []
    for sys_ in (card, cpu):
        params = sys_.load_params(params0)
        seeds = sys_.mask_seeds()
        tfa.reset_launches()
        if "audio_embed" in fe:
            fe_list = sys_.encoder_kv(params,
                                      fe["audio_embed"].to(sys_.device))
            kv = [f["enc_kv"][0].cpu() for f in fe_list]
        else:
            fe_list = [{"vision_embed": fe["vision_embed"].to(
                sys_.device)}] * sys_.C
            kv = []
        t = tok.to(sys_.device)
        E, caches = sys_.prefill(params, t[:, :-1], sys_.init_caches(2, 24),
                                 fe_list=fe_list, seeds=seeds, round_idx=3)
        logits, _ = sys_.serve_step(params, t[:, -1:], caches, 20, seeds,
                                    fe_list=fe_list)
        out.append((E.cpu(), logits.cpu(), kv,
                    tfa.LAUNCHES["flash_attention_fwd"]))
    c0, c1 = card.party_cfgs[:2]
    per = 1 if engine == "vectorized" else card.easter.num_passive
    if cfg.family == "encdec":
        want = (c0.n_encoder_layers + per * c1.n_encoder_layers
                + 3 * (c0.n_layers + per * c1.n_layers))
    else:
        want = c0.n_layers + per * c1.n_layers
    assert out[0][3] == want and out[1][3] == 0
    for a, b in zip(out[0][2], out[1][2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][0], out[1][0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
def test_cuda_moe_layer_gives_the_same_bits_twice(cuda):
    """qwen2-moe-a2.7b's MoE layer at full width (60 experts top-4, 4
    shared, d 2048, bfloat16) over a 2047-token prefill, a 4-lane decode
    round and a vmap over 3 parties: two calls, the same bits (the
    dispatch writes each slot once and the combine adds in k order)."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.party_engine import stack_trees
    from repro_torch.models import moe
    cfg = get_config("qwen2-moe-a2.7b")
    gen = torch.Generator(device="cuda").manual_seed(4)
    p = moe.init_moe(gen, cfg.d_model, cfg.moe, cfg.act, torch.bfloat16)
    group = [moe.init_moe(gen, cfg.d_model, cfg.moe, cfg.act,
                          torch.bfloat16) for _ in range(3)]
    stacked = stack_trees(group)
    run = lambda p, x: moe.moe_ffn(p, x, cfg.moe, cfg.act)
    for shape in ((1, 2047), (4, 1)):
        x = torch.randn(shape + (cfg.d_model,), generator=gen,
                        device="cuda").to(torch.bfloat16)
        a, b = run(p, x), run(p, x)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert bool(torch.isfinite(a[0]).all())
    x = torch.randn((3, 1, 511, cfg.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        a = torch.func.vmap(run)(stacked, x)
        b = torch.func.vmap(run)(stacked, x)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.requires_cuda
def test_cuda_ssd_prefill_of_2047_tokens_matches_cpu(cuda):
    """mamba2-2.7b's mixer (d_model 2560, 80 heads of 64, d_state 128,
    chunk 256) over a 2047-token prompt in float32 (TF32 off), padded to
    8 chunks of 256: outputs, conv cache and state against the CPU."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import ssm
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-2.7b")
    gen = torch.Generator().manual_seed(6)
    p = ssm.init_ssm(gen, cfg.d_model, cfg.ssm, torch.float32)
    x = torch.randn((1, 2047, cfg.d_model), generator=gen)
    out = []
    for dev in ("cuda", "cpu"):
        pp = {k: ({n: t.to(dev) for n, t in v.items()}
                  if isinstance(v, dict) else v.to(dev))
              for k, v in p.items()}
        with torch.no_grad():
            y, c = ssm.ssm_block(pp, x.to(dev), cfg.ssm)
        out.append([t.cpu() for t in (y, c["conv"], c["state"])])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))


# ---------------------------------------------------------------------------
# EasterLM training
# ---------------------------------------------------------------------------


def _train_step(sys_, params0, batch, opt_name="sgd"):
    """One training step from ``params0`` (numpy, reference layout) with
    the launch counters set to 0 just before it: (per-party losses, grads,
    updated params, launches), all on the host."""
    from repro_torch.core import train_loop
    from repro_torch.optim import make_optimizer
    params = sys_.load_params(params0)
    tba.reset_launches()
    tfa.reset_launches()
    trg.reset_launches()
    _, per, grads = train_loop.loss_and_grads(sys_, params, batch, 3,
                                              sys_.mask_seeds())
    opt = make_optimizer(opt_name, 0.01, grad_clip=1.0)
    tree = {"parties": params["parties"]}
    opt.update(grads, opt.init(tree), tree)
    if sys_.device.type == "cuda":
        torch.cuda.synchronize()
    launches = {**tba.LAUNCHES, **tfa.LAUNCHES, **trg.LAUNCHES}
    host = lambda t: [x.detach().cpu() for x in tree_leaves(t)]
    return per.cpu(), host(grads), host(tree), launches


@pytest.mark.requires_cuda
@pytest.mark.parametrize("grad_mode", ["easter", "joint"])
@pytest.mark.parametrize("engine", ["vectorized", "loop"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "recurrentgemma-9b"])
def test_cuda_easter_lm_train_step_matches_cpu(cuda, arch, engine,
                                               grad_mode):
    """One sgd step of the smoke variant in float32 (TF32 off), card
    against the CPU port: per-party losses, gradients and updated params
    within rtol 1e-4 / atol 1e-5. The step launches one blind_agg_fwd,
    blind_agg_bwd only in joint mode, and neither flash_attention_fwd nor
    rglru_scan_fwd: the training forward takes the plain paths, since
    those kernels have no backward."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.core.easter_lm import EasterLM
    from repro_torch.data.synthetic import lm_batch_iterator
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = smoke_variant(get_config(arch))
    card = EasterLM(cfg, EasterConfig(), grad_mode=grad_mode, engine=engine)
    cpu = EasterLM(cfg, EasterConfig(), grad_mode=grad_mode, engine=engine,
                   device="cpu")
    params0 = cpu.export_params(
        cpu.init_params(torch.Generator().manual_seed(0)))
    batch = next(lm_batch_iterator(cfg.vocab_size, 2, 40, seed=1))
    got = _train_step(card, params0, batch)
    want = _train_step(cpu, params0, batch)
    assert got[3]["blind_agg_fwd"] == 1
    assert got[3]["blind_agg_bwd"] == (grad_mode == "joint")
    assert got[3]["flash_attention_fwd"] == got[3]["rglru_scan_fwd"] == 0
    assert not any(want[3].values())
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5)
    for i in (1, 2):
        for a, b in zip(got[i], want[i]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


@pytest.mark.requires_cuda
def test_cuda_chunked_lm_head_xent_matches_cpu(cuda):
    """The chunked cross-entropy (checkpointed chunks) on the card against
    the CPU: value and gradients within rtol 1e-4 / atol 1e-5 (TF32
    off)."""
    from repro_torch.core.losses import chunked_lm_head_xent
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(2)
    h = torch.randn((2, 64, 32), generator=gen)
    w = torch.randn((32, 1000), generator=gen) * 0.1
    y = torch.randint(0, 1000, (2, 64), generator=gen, dtype=torch.int32)
    out = []
    for dev in ("cuda", "cpu"):
        hh = h.to(dev).requires_grad_(True)
        ww = w.to(dev).requires_grad_(True)
        v = chunked_lm_head_xent(hh, ww, y.to(dev), chunk=16)
        out.append([t.cpu() for t in (v, *torch.autograd.grad(v, [hh, ww]))])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# the sharded engine: two ranks on one card over gloo (on a machine with
# two cards or more, a card each over NCCL: launch/mesh.py's rule)
# ---------------------------------------------------------------------------

SHARDED_CASES = tuple((C, mode) for C in (4, 8) for mode in ("float", "int8"))


def _sharded_rounds_on_card():
    """Rank side of the card tests: one masked round of each
    SHARDED_CASES classifier over the party group; {case: (loss,
    per-party losses, this rank's blind_agg launches)} and the rank."""
    from repro_torch.launch import mesh
    grp = mesh.make_party_group(device="cuda")
    out = {}
    for C, mode in SHARDED_CASES:
        cls = _sharded_cls("sharded", C, mode, grp)
        params = cls.init_params(torch.Generator().manual_seed(0))
        xs, y = _sharded_batch(C)
        tba.reset_launches()
        with torch.no_grad():
            total, per = cls.loss_fn(params, xs, y, cls.masks(8, 0))
        torch.cuda.synchronize()
        out[(C, mode)] = (total.cpu().numpy(), per.cpu().numpy(),
                          dict(tba.LAUNCHES))
    return grp.rank, out


def _sharded_cls(engine, C, mode, group=None):
    arches = [PartyArch("mlp", (32, 16) if k % 2 == 0 else (48,), (16,), 24,
                        5) for k in range(C)]
    return EasterClassifier(EasterConfig(num_passive=C - 1, d_embed=24,
                                         mask_mode=mode), arches, [10] * C,
                            engine=engine, device="cuda", group=group)


def _sharded_batch(C):
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.normal(size=(8, 10)).astype(np.float32)
                           ).cuda() for _ in range(C)]
    return xs, torch.from_numpy(rng.integers(0, 5, 8)).cuda()


@pytest.fixture(scope="module")
def sharded_ranks(tmp_path_factory):
    """Both ranks' results of one spawn of 2 ranks sharing the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh
    return mesh.spawn_ranks(_sharded_rounds_on_card, 2,
                            store_dir=str(tmp_path_factory.mktemp("pg")),
                            device="cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", SHARDED_CASES,
                         ids=lambda c: f"C{c[0]}-{c[1]}")
def test_cuda_sharded_classifier_round_on_one_card(cuda, sharded_ranks,
                                                   case):
    """Two ranks share the card over gloo. The active party's rank alone
    aggregates: one blind_agg_fwd on the float wire, none on the int8
    ring. At C = 8 each rank runs two rows of each group, batched GEMMs
    as the group's: the loss equals the vectorized engine's bit for bit.
    At C = 4 each rank runs one row, and cuBLAS's single-matrix float32
    GEMM rounds differently from the batched one (ROADMAP.md queue 3):
    bit for bit the loop engine's, whose parties run as single matrices
    too, and within rtol 2e-7 of the vectorized engine's (7.3e-8 measured
    on the H100)."""
    C, mode = case
    sv = _sharded_cls("vectorized", C, mode)
    params = sv.init_params(torch.Generator().manual_seed(0))
    xs, y = _sharded_batch(C)
    with torch.no_grad():
        total, per = sv.loss_fn(params, xs, y, sv.masks(8, 0))
        # the loop engine runs each party as a single matrix, as a rank
        # with one row of a group does
        _, per_loop = _sharded_cls("loop", C, mode).loss_fn(
            params, xs, y, sv.masks(8, 0))
    for rank, out in sharded_ranks:
        t, p, launches = out[case]
        if C == 8:
            np.testing.assert_array_equal(t, total.cpu().numpy())
            np.testing.assert_array_equal(p, per.cpu().numpy())
        else:
            np.testing.assert_array_equal(p, per_loop.cpu().numpy())
            np.testing.assert_allclose(p, per.cpu().numpy(), rtol=2e-7,
                                       atol=0)
        want = 1 if rank == 0 and mode == "float" else 0
        assert launches["blind_agg_fwd"] == want, (rank, launches)


@pytest.mark.requires_cuda
def test_cuda_decode_attention_rounds_by_party_batch(cuda):
    """The witness of a standing difference (ROADMAP.md queue 3): decode
    attention's float32 probs x V einsum (``layers._gqa_out``) at
    qwen2.5-3b's decode shape (4 lanes, 16/2 heads, hd 128, a 2064-slot
    cache), for K = 3 passive parties. A rank of the sharded engine with
    one party runs it under a vmap of one row: bit for bit the loop
    engine's, one party at a time (a bmm of batch 4 x 2 = 8). The
    vectorized engine's vmap over all three is one bmm of batch 24, which
    cuBLAS rounds otherwise in some elements, by a few float32 ulps: so
    the sharded decode is held bit for bit against the loop engine on the
    card, and against the vectorized engine only within that size. Should
    this test fail because the batch-24 bits equal the batch-8 ones, the
    standing difference is gone."""
    from torch.func import vmap
    from repro_torch.models.layers import _gqa_out
    K, B, Hkv, G, T, hd = 3, 4, 2, 8, 2064, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((K, B, Hkv, G, 1, T), generator=gen, device="cuda")
    probs = torch.softmax(4 * logits, dim=-1)
    v = torch.randn((K, B, T, Hkv, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    loop = torch.stack([_gqa_out(probs[k], v[k]) for k in range(K)])
    rank = torch.cat([vmap(_gqa_out)(probs[k:k + 1], v[k:k + 1])
                      for k in range(K)])
    vec = vmap(_gqa_out)(probs, v)
    assert torch.equal(rank, loop)
    assert not torch.equal(vec, loop)
    rel = float((vec - loop).abs().max() / loop.abs().max())
    assert rel < 2 ** -20, rel


# ---------------------------------------------------------------------------
# the FSDP plan's materialize: two ranks on one card over gloo (or a card
# each over NCCL, as above)
# ---------------------------------------------------------------------------

# (whole shape, spec, stack index): a leaf over "data", one replicated,
# and a layer of a stack whose layer axis lies over "data"
MATERIALIZE_CASES = (((6, 8), ("data", None), None),
                     ((6, 8), (None, None), None),
                     ((4, 6, 8), ("data", None, None), 3))


def _materialize_inputs(shape, index):
    """The whole leaf, and each rank's cotangent of the materialised
    tensor (the ranks' batch rows differ, so their cotangents do)."""
    g = torch.Generator().manual_seed(7)
    w = torch.randn(shape, generator=g)
    out = shape[1:] if index is not None else shape
    return w, [torch.randn(out, generator=g) for _ in range(2)]


def _materialize_on_card():
    """Rank side: each MATERIALIZE_CASES leaf cut to this rank's block on
    the card, materialised under a plan whose rows lie over "data", and
    differentiated with this rank's cotangent; (rank, [(tensor, gradient
    of the block)])."""
    from repro_torch import sharding
    from repro_torch.launch import mesh
    m = mesh.make_debug_mesh(2, 1, device="cuda")
    out = []
    with sharding.ambient_mesh(m, "tp", {"split": True}):
        for shape, spec, index in MATERIALIZE_CASES:
            w, gs = _materialize_inputs(shape, index)
            local = sharding.shard_tree(w.cuda(), sharding.P(*spec), m)
            local.requires_grad_(True)
            full = sharding.materialize(local, spec, m, index)
            (grad,) = torch.autograd.grad(full, local, gs[m.rank].cuda())
            out.append((full.detach().cpu(), grad.cpu()))
    return m.rank, out


@pytest.fixture(scope="module")
def materialize_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh
    return mesh.spawn_ranks(_materialize_on_card, 2,
                            store_dir=str(tmp_path_factory.mktemp("mesh")),
                            device="cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("i", range(len(MATERIALIZE_CASES)))
def test_cuda_materialize_over_two_ranks(cuda, materialize_ranks, i):
    """``sharding.materialize`` over a 2-rank gloo group on cuda:0, bit for
    bit against one process: the forward is the whole leaf (or its layer
    ``index``, broadcast from the rank holding it), and each rank's
    gradient is its block of the sum of both ranks' cotangents (the rows
    differ between the ranks), zero outside the layer's slot."""
    shape, spec, index = MATERIALIZE_CASES[i]
    w, gs = _materialize_inputs(shape, index)
    want_full = w if index is None else w[index]
    total = gs[0] + gs[1]
    for rank, out in materialize_ranks:
        full, grad = out[i]
        assert torch.equal(full, want_full)
        want = total if index is None else torch.zeros(shape).index_copy_(
            0, torch.tensor([index]), total[None])
        if spec[0] == "data":
            n = shape[0] // 2
            want = want[rank * n:(rank + 1) * n]
        assert torch.equal(grad, want), (rank, i)


# ---------------------------------------------------------------------------
# the tensor-parallel compute over "model"
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [2, 6])
def test_cuda_flash_on_a_model_ranks_heads(cuda, B, dtype):
    """A 512-token prefill on one model rank's heads of qwen2.5-3b at m =
    2 (8 q heads over 1 kv head of 128): 2 lanes of the active party, 6
    of the passive group folded into the batch axis; the sweep's tolerance
    and, in bfloat16, the kernel's bound."""
    dt = _TDT[dtype]
    q, k, v = _flash_inputs(B, 512, 512, 8, 1, 128, dt, cuda, B)
    before = tfa.LAUNCHES["flash_attention_fwd"]
    out = tfa.flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert tfa.LAUNCHES["flash_attention_fwd"] == before + 1
    _flash_close(out, ref.reference_attention(q, k, v), dt)
    if dt == torch.bfloat16:
        assert _bf16_bound_used(out, q, k, v) <= 1


# (lanes, T, q heads, kv heads, hd, each lane's position)
T_SPLIT_CASE = (3, 1024, 16, 1, 128, (700, 1023, 5))


def _t_split_inputs():
    """q (B, 1, Hq, hd), the whole cache k / v (B, T, Hkv, hd) and its
    slots' mask (B, T): each lane sees positions up to its own."""
    B, T, Hq, Hkv, hd, pos = T_SPLIT_CASE
    g = torch.Generator().manual_seed(11)
    q, k, v = (torch.randn(s, generator=g) for s in (
        (B, 1, Hq, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    mask = torch.arange(T)[None] <= torch.tensor(pos)[:, None]
    return q, k, v, mask


def _t_split_on_card():
    """Rank side: this model rank's T block of the cache and its q heads,
    merged over a 2-rank gloo group on cuda:0 (``layers._t_split_decode``);
    (rank, this rank's heads of the output)."""
    from repro_torch import sharding
    from repro_torch.launch import mesh
    from repro_torch.models import layers
    m = mesh.make_debug_mesh(1, 2, device="cuda")
    tp = sharding.TP(m, attn="kv", kv_t=True)
    q, k, v, mask = (t.cuda() for t in _t_split_inputs())
    hq, Tl = q.shape[2] // 2, k.shape[1] // 2
    c = m.coord(("model",))
    blk = lambda t, d, n: t.narrow(d, c * n, n)
    out = layers._t_split_decode(blk(q, 2, hq), blk(k, 1, Tl), blk(v, 1, Tl),
                                 blk(mask, 1, Tl), q.shape[-1], tp)
    return m.rank, out.cpu()


@pytest.fixture(scope="module")
def t_split_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh
    return mesh.spawn_ranks(_t_split_on_card, 2,
                            store_dir=str(tmp_path_factory.mktemp("mesh")),
                            device="cuda")


@pytest.mark.requires_cuda
def test_cuda_t_split_decode_matches_a_whole_cache(cuda, t_split_ranks):
    """One decode step over a cache whose T lies over 2 model ranks on the
    card (each rank's partial softmax over its T block, merged by a max
    and a sum all-reduce) against the whole cache's softmax attention on
    the card, float32 (TF32 off): within rtol 1e-5 / atol 1e-6. A lane at
    position 5 sees no slot of rank 1's block."""
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, mask = (t.cuda() for t in _t_split_inputs())
    logits = layers._masked_logits(q, k, mask, q.shape[-1])
    want = layers._gqa_out(torch.softmax(logits, dim=-1), v).cpu()
    got = torch.cat([out for _, out in sorted(t_split_ranks)], dim=2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# a whole attention's decode step over a T-split cache: (lanes, T, q
# heads, kv heads, hd, d_model, each lane's position); 3 q heads do not
# divide 2 model ranks, so the layer runs whole on every rank and only its
# cache is split
WHOLE_T_SPLIT_CASE = (3, 1024, 3, 1, 64, 256, (700, 1023, 5))


def _whole_t_split_inputs():
    """Whole attention weights (qkv biases), the stream x (B, 1, d) and a
    per-lane cache (B, T, Hkv, hd) whose slots up to each lane's position
    are filled, float32."""
    from repro_torch.models import layers
    B, T, Hq, Hkv, hd, d, pos = WHOLE_T_SPLIT_CASE
    g = torch.Generator().manual_seed(12)
    p = layers.init_attention(g, d, Hq, Hkv, hd, True, torch.float32)
    p = tree_map(lambda a: a + 0.1 * torch.randn(a.shape, generator=g), p)
    x = torch.randn((B, 1, d), generator=g)
    k, v = (torch.randn((B, T, Hkv, hd), generator=g) for _ in range(2))
    cache = {"k": k, "v": v,
             "idx": torch.tensor(pos, dtype=torch.int32)}
    return p, x, cache


def _whole_t_split_step(p, x, cache, tp=None):
    from repro_torch.models import layers
    _, _, Hq, Hkv, hd, _, _ = WHOLE_T_SPLIT_CASE
    return layers.self_attention(p, x, n_heads=Hq, n_kv_heads=Hkv,
                                 head_dim=hd, cache=cache, tp=tp)


# a split cross-attention: (lanes, queries, encoder frames); whisper-small's
# smoke widths (d 256, 4 heads of 64, qkv biases, layer norm), 2 heads a
# rank over 2 model ranks
XATTN_CASE = (2, 16, 150)


def _xattn_inputs():
    """The smoke whisper config, one layer's cross-attention leaves
    (``lnx``, ``attn``), the stream x (B, S, d) and the encoder's k / v
    (B, F, Hkv, hd), float32."""
    from repro_torch.configs.base import get_config, smoke_variant
    from repro_torch.models import layers
    cfg = smoke_variant(get_config("whisper-small"))
    B, S, F = XATTN_CASE
    g = torch.Generator().manual_seed(13)
    hd = cfg.resolved_head_dim
    xp = {"lnx": {"scale": 1 + 0.1 * torch.randn(cfg.d_model, generator=g),
                  "bias": 0.1 * torch.randn(cfg.d_model, generator=g)},
          "attn": layers.init_attention(g, cfg.d_model, cfg.n_heads,
                                        cfg.n_kv_heads, hd, True,
                                        torch.float32)}
    x = torch.randn((B, S, cfg.d_model), generator=g)
    ek, ev = (torch.randn((B, F, cfg.n_kv_heads, hd), generator=g)
              for _ in range(2))
    return cfg, xp, x, ek, ev


def _tp_attention_on_card():
    """Rank side, 2 model ranks over gloo on cuda:0: (rank, the whole
    attention's decode output and this rank's T block of its new cache
    (``self_attention`` under a "whole" TP with ``kv_t``), the split
    cross-attention's output (``transformer._apply_xattn`` on this rank's
    heads: its columns of wq, its rows of wo, its heads of k / v) and
    its flash_attention_fwd launches)."""
    from repro_torch import sharding
    from repro_torch.launch import mesh
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    m = mesh.make_debug_mesh(1, 2, device="cuda")
    c = m.coord(("model",))
    on = lambda tree: tree_map(lambda a: a.cuda(), tree)
    blk = lambda t, d: t.narrow(d, c * t.shape[d] // 2, t.shape[d] // 2)
    p, x, cache = on(_whole_t_split_inputs())
    cache = {n: (t if n == "idx" else blk(t, 1).contiguous())
             for n, t in cache.items()}
    tp = sharding.TP(m, attn="whole", kv_t=True)
    out, new = _whole_t_split_step(p, x, cache, tp)
    cfg, *rest = _xattn_inputs()
    xp, xs, ek, ev = on(tuple(rest))
    a = xp["attn"]
    xp_r = {"lnx": xp["lnx"],
            "attn": {"wq": {"w": blk(a["wq"]["w"], 1), "b": blk(a["wq"]["b"],
                                                               0)},
                     "wo": {"w": blk(a["wo"]["w"], 0)}}}
    before = tfa.LAUNCHES["flash_attention_fwd"]
    with torch.no_grad():
        xo = transformer._apply_xattn(
            (xp_r, blk(ek, 2).contiguous(), blk(ev, 2).contiguous()), xs,
            cfg, False, sharding.TP(m, attn="heads"))
    torch.cuda.synchronize()
    return (m.rank, out.cpu(), {n: t.cpu() for n, t in new.items()},
            xo.cpu(), tfa.LAUNCHES["flash_attention_fwd"] - before)


@pytest.fixture(scope="module")
def tp_attention_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh
    return sorted(mesh.spawn_ranks(
        _tp_attention_on_card, 2,
        store_dir=str(tmp_path_factory.mktemp("mesh")), device="cuda"),
        key=lambda r: r[0])


@pytest.mark.requires_cuda
def test_cuda_whole_attention_t_split_decode(cuda, tp_attention_ranks):
    """A decode step of an attention whose 3 q heads do not divide 2 model
    ranks, run whole on each rank over its T block of the cache (the new
    K/V written where the slot lies, every head's partial softmax merged
    over the ranks, wo whole, no exit) against the whole layer over the
    whole cache on the card, float32 (TF32 off): the output the same on
    both ranks and within rtol 1e-5 / atol 1e-6, each rank's block of the
    new cache the whole step's bit for bit. A lane at position 5 sees no
    slot of rank 1's block."""
    torch.backends.cuda.matmul.allow_tf32 = False
    p, x, cache = tree_map(lambda a: a.cuda(), _whole_t_split_inputs())
    want, new = _whole_t_split_step(p, x, cache)
    want = want.cpu()
    for rank, out, got_cache, _, _ in tp_attention_ranks:
        torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-6)
        for n in ("k", "v"):
            Tl = got_cache[n].shape[1]
            assert torch.equal(got_cache[n],
                               new[n].cpu()[:, rank * Tl:(rank + 1) * Tl])
        assert torch.equal(got_cache["idx"], new["idx"].cpu())


@pytest.mark.requires_cuda
def test_cuda_split_cross_attention_matches_the_whole_one(
        cuda, tp_attention_ranks):
    """The cross-attention on each of 2 model ranks' heads (2 of 4: q by
    its columns of wq, flash_attention_fwd non-causal against its heads of
    the encoder's k / v, its rows of wo summed over the ranks) against the
    whole cross-attention on the card, float32 (TF32 off): one launch a
    rank, the same output on both, within rtol 1e-5 / atol 1e-6."""
    from repro_torch.models import transformer
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, *rest = _xattn_inputs()
    xp, x, ek, ev = tree_map(lambda a: a.cuda(), tuple(rest))
    with torch.no_grad():
        want = transformer._apply_xattn((xp, ek, ev), x, cfg).cpu()
    for _, _, _, got, launches in tp_attention_ranks:
        assert launches == 1
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the split MoE and RG-LRU blocks over "model"
# ---------------------------------------------------------------------------


@pytest.mark.requires_cuda
@pytest.mark.parametrize("m", [2, 4])
def test_cuda_rglru_on_a_model_ranks_width(cuda, m):
    """recurrentgemma-9b's scan on a model rank's width block (512 steps,
    4096 / m wide) of the active party's 4 lanes and of the passive
    group's 12 (3 parties x 4 lanes, folded into the batch), each rank's a
    and b their contiguous block of the whole gates (as the split RG-LRU
    mixer computes them): the TMA path, bit for bit the plain version, and
    the blocks side by side the whole width's scan."""
    L, W = 512, 4096
    w = W // m
    for B in (4, 12):
        a, b, h0 = _rglru_inputs(B, L, W, torch.float32, cuda, 17)
        whole, whole_last = ref.reference_rglru(a, b, h0)
        for c in range(m):
            blk = lambda t: t.narrow(-1, c * w, w).contiguous()
            ab, bb, hb = blk(a), blk(b), blk(h0)
            assert trg.kernel_path(ab, bb) == "tma"
            before = dict(trg.PATH_LAUNCHES)
            h, last = trg.rglru_scan_fwd(ab, bb, hb)
            torch.cuda.synchronize()
            assert trg.PATH_LAUNCHES["tma"] == before["tma"] + 1
            want_h, want_last = ref.reference_rglru(ab, bb, hb)
            assert torch.equal(h, want_h) and torch.equal(last, want_last)
            assert torch.equal(h, blk(whole)) and torch.equal(
                last, blk(whole_last))


# an MoE layer with a shared expert: 8 experts top-2 over 2 model ranks
MOE_TP_CASE = dict(B=2, S=16, d=256, E=8, K=2, ff=128)


def _moe_tp_inputs():
    """(config, the whole layer's parameters, x), float32 on the CPU."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe
    c = MOE_TP_CASE
    cfg = MoEConfig(n_experts=c["E"], top_k=c["K"], n_shared_experts=1,
                    d_expert_ff=c["ff"])
    g = torch.Generator().manual_seed(19)
    p = moe.init_moe(g, c["d"], cfg, "silu", torch.float32)
    x = torch.randn((c["B"], c["S"], c["d"]), generator=g)
    return cfg, p, x


def _moe_block(p, mode, c, m):
    """Model rank ``c``'s block of the layer's leaves, as the rule stores
    them: "experts" (the experts' rows) or "ff" (every expert's ff
    columns, w_down's rows); the shared expert's columns and rows either
    way; the router and the shared gate whole."""
    cut = lambda t, d: t.narrow(d, c * (t.shape[d] // m), t.shape[d] // m)
    e = 0 if mode == "experts" else None
    out = {"router": p["router"], "shared_gate": p["shared_gate"],
           "w_gate": cut(p["w_gate"], e if e is not None else 2),
           "w_up": cut(p["w_up"], e if e is not None else 2),
           "w_down": cut(p["w_down"], e if e is not None else 1),
           "shared": {"gate": {"w": cut(p["shared"]["gate"]["w"], 1)},
                      "up": {"w": cut(p["shared"]["up"]["w"], 1)},
                      "down": {"w": cut(p["shared"]["down"]["w"], 0)}}}
    return tree_map(lambda t: t.contiguous(), out)


def _moe_tp_on_card():
    """Rank side: the layer split over a 2-rank gloo group on cuda:0, by
    expert and by ff column, on a whole stream and on this rank's S
    block; (rank, {(mode, seq): (this rank's output as numpy, aux)}):
    numpy, which pickles by value (a tensor crosses the pipe as a shared
    file descriptor, gone once the rank exits)."""
    from repro_torch import sharding
    from repro_torch.launch import mesh
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    m = mesh.make_debug_mesh(1, 2, device="cuda")
    cfg, p, x = _moe_tp_inputs()
    c, S = m.coord(("model",)), x.shape[1]
    out = {}
    for mode in ("experts", "ff"):
        pl = tree_map(lambda t: t.cuda(), _moe_block(p, mode, c, 2))
        for seq in (False, True):
            tp = sharding.TP(m, moe=mode, seq=seq)
            xin = x.narrow(1, c * S // 2, S // 2) if seq else x
            y, aux = moe.moe_ffn(pl, xin.cuda(), cfg, "silu", tp=tp)
            out[(mode, seq)] = (y.cpu().numpy(), float(aux))
    return m.rank, out


@pytest.fixture(scope="module")
def moe_tp_ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.launch import mesh
    return mesh.spawn_ranks(_moe_tp_on_card, 2,
                            store_dir=str(tmp_path_factory.mktemp("mesh")),
                            device="cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("mode", ["experts", "ff"])
def test_cuda_split_moe_matches_the_whole_layer(cuda, moe_tp_ranks, mode,
                                                seq):
    """The MoE layer split over 2 model ranks on the card ("experts": 4 of
    the 8 experts a rank; "ff": every expert's half of the ff columns;
    the shared expert's columns either way), routed on the stream as it
    lies, its partial outputs summed over the ranks (an all-reduce on a
    whole stream, a reduce-scatter onto each rank's S block), against the
    whole layer on the card, float32 (TF32 off): within rtol 1e-5 / atol
    1e-6 x max|out| (the experts drawn at the reference's fan-in scale,
    1/sqrt(E), put outputs of ~250 into the layer, and the partial sums'
    other order moves them by up to 3.1 float32 ulps of that largest
    output on the CPU), the load-balance loss within rtol 1e-5."""
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _moe_tp_inputs()
    want, want_aux = moe.moe_ffn(tree_map(lambda t: t.cuda(), p), x.cuda(),
                                 cfg, "silu")
    want = want.cpu()
    outs = [(torch.from_numpy(y), aux)
            for y, aux in (out[(mode, seq)] for _, out in sorted(moe_tp_ranks))]
    got = torch.cat([y for y, _ in outs], dim=1) if seq else outs[0][0]
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    for y, aux in outs:
        if not seq:
            assert torch.equal(y, outs[0][0])
        np.testing.assert_allclose(aux, float(want_aux), rtol=1e-5)


# ---------------------------------------------------------------------------
# the NCCL group: one card a rank
# ---------------------------------------------------------------------------

NCCL_DTYPES = ("float32", "bfloat16")


def _nccl_operands(rank, dtype, n=2):
    """Rank ``rank``'s operand (n * 4, 6), the same bits on every device."""
    g = torch.Generator().manual_seed(100 + rank)
    return torch.randn((n * 4, 6), generator=g).to(_TDT[dtype])


def _collectives_on_cards():
    """Rank side: MeshGroup's four collectives over its 2-rank "model"
    axis and PartyGroup's, each on this rank's card (NCCL) and on the
    host (the NCCL group's gloo half) on the same operands; (rank,
    backend, device, {(dtype, call, where): float32 numpy}, the gathered
    host objects)."""
    from repro_torch.launch import mesh
    m = mesh.make_debug_mesh(1, 2, device="cuda")
    grp = mesh.make_party_group(device="cuda")
    out = {}
    for dtype in NCCL_DTYPES:
        x = _nccl_operands(m.rank, dtype)
        for where in ("cuda", "cpu"):
            xw = x.to(m.device if where == "cuda" else "cpu")
            calls = {
                "mesh all_gather": m.all_gather(xw, "model", dim=1),
                "mesh reduce_scatter": m.reduce_scatter(xw, "model"),
                "mesh all_reduce sum": m.all_reduce(xw, "model"),
                "mesh all_reduce max": m.all_reduce(xw, "model", "max"),
                "mesh broadcast": m.broadcast(xw.clone(), "model", 1),
                "party all_gather": grp.all_gather(xw),
                "party all_reduce sum": grp.all_reduce(xw.clone()),
                "party broadcast": grp.broadcast(xw.clone(), 1)}
            for call, y in calls.items():
                assert y.device == xw.device, (call, y.device)
                out[(dtype, call, where)] = y.float().cpu().numpy()
    objs = grp.gather_object({"rank": grp.rank, "rows": list(grp.rows(4)),
                              "a": np.arange(grp.rank + 3)})
    return m.rank, m.backend, str(m.device), grp.backend, out, objs


@pytest.fixture(scope="module")
def nccl_ranks(tmp_path_factory):
    """Both ranks' results of one spawn of 2 ranks, one card each."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices (an NCCL rank a card)")
    from repro_torch.launch import mesh
    return mesh.spawn_ranks(_collectives_on_cards, 2,
                            store_dir=str(tmp_path_factory.mktemp("nccl")),
                            device="cuda", timeout_s=180)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", NCCL_DTYPES)
def test_cuda_nccl_collectives_match_gloo(nccl_ranks, dtype):
    """Two ranks on two cards take NCCL (the rule: at least as many cards
    as ranks), each on cuda:<rank>. MeshGroup's and PartyGroup's
    collectives on the cards (NCCL) against the same calls on host
    tensors (the group's gloo half) and against the operands: gathers
    and broadcasts bit for bit, max bit for bit, sums within the order
    bound of n - 1 additions, one ulp of the dtype (2^-23 float32, 2^-7
    bfloat16) times the sum of |operands| each; gather_object's host
    pickles reach rank 0."""
    eps = {"float32": 2.0 ** -23, "bfloat16": 2.0 ** -7}[dtype]
    xs = [_nccl_operands(r, dtype).float().numpy() for r in range(2)]
    bound = eps * (np.abs(xs[0]) + np.abs(xs[1]))
    want = {"mesh all_gather": np.concatenate(xs, 1),
            "mesh reduce_scatter": None, "mesh all_reduce sum": None,
            "mesh all_reduce max": np.maximum(*xs),
            "mesh broadcast": xs[1], "party all_gather": np.concatenate(xs),
            "party all_reduce sum": None, "party broadcast": xs[1]}
    for rank, backend, device, pbackend, out, objs in nccl_ranks:
        assert (backend, pbackend, device) == ("nccl", "nccl",
                                               f"cuda:{rank}")
        for call, w in want.items():
            got, host = out[(dtype, call, "cuda")], out[(dtype, call, "cpu")]
            if "sum" in call or "scatter" in call:
                b = bound if "scatter" not in call else np.split(
                    bound, 2)[rank]
                exact = xs[0] + xs[1]
                if "scatter" in call:
                    exact = np.split(exact, 2)[rank]
                assert np.all(np.abs(got - host) <= b), call
                assert np.all(np.abs(got - exact) <= b), call
            else:
                np.testing.assert_array_equal(got, host, err_msg=call)
                np.testing.assert_array_equal(got, w, err_msg=call)
        if rank == 0:
            assert [o["rank"] for o in objs] == [0, 1]
            assert [o["rows"] for o in objs] == [[0, 1], [2, 3]]
            assert all(np.array_equal(o["a"], np.arange(r + 3))
                       for r, o in enumerate(objs))
        else:
            assert objs is None
