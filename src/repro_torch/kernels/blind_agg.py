"""Fused blind + aggregate (the paper's Eq. 6 + Eq. 7) as CUDA kernels.

Counterpart of ``repro.kernels.blind_agg``'s ``_fwd_kernel``,
``_bwd_kernel`` and ``_prng_fwd_kernel``; the sources and their design
notes are ``csrc/blind_agg.cu`` and ``csrc/blind_agg_prng.cu``. This
module binds them:

  * ``blind_agg_fwd(ea (N, d), ep (K, N, d), mk (K, N, d))`` -> (N, d) in
    ea's dtype, (ea + sum_k (ep_k + mk_k)) / (K + 1) with a float32
    accumulator, the parties split into ``fwd_party_groups(N * d, K)``
    groups a CTA;
  * ``blind_agg_bwd(g (N, d), K, ...)`` -> (dea, dep, dmk), every one
    g / (K + 1) in its own dtype, each written only if asked for;
  * ``blind_agg``, the public differentiable function: any rank, flattened
    to (N, d) and (K, N, d) as the reference does, through a
    ``torch.autograd.Function`` whose forward and backward are the two
    kernels;
  * ``blind_agg_prng_fwd(ea, ep, seed_hi, seed_lo, signs, round,
    mask_scale)`` -> (N, d): the forward with every pair mask made inside
    the kernel from a MaskEngine's seed tables (no (K, N, d) mask tensor;
    each pair's normal drawn once, so the tables must hold pair (k, p)'s
    seed words in row k and in row p, as a MaskEngine's do; K at most
    240, for one tile's pair normals in shared memory);
  * ``prng_blind_agg``, its differentiable public function, whose
    backward is ``blind_agg_bwd`` without the mask cotangent.

Every wrapper takes CUDA tensors only (float32, bfloat16 or float16,
contiguous, matching shapes) and raises on anything else; the plain
version for CPU tensors is ``ref.reference_blind_agg`` (and
``ref.reference_blind_agg_prng``), chosen by ``ops``. Each wrapper call
that launches its kernel adds one to ``LAUNCHES[<wrapper name>]``, and
each ``blind_agg_fwd`` launch also to ``FWD_GROUPS[G]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# launches of each kernel in this process; reset with reset_launches()
LAUNCHES: Dict[str, int] = {"blind_agg_fwd": 0, "blind_agg_bwd": 0,
                            "blind_agg_prng_fwd": 0}
# blind_agg_fwd's launches by party groups G; reset with reset_launches()
FWD_GROUPS: Dict[int, int] = {}

# the split forward's CTA (csrc/blind_agg.cu fwd_split): V output vectors
# of 8 elements x G party groups in at most 128 threads, G <= 16; a group
# walks at least FWD_MIN_PARTIES parties
FWD_THREADS, FWD_MAX_GROUPS, FWD_MIN_PARTIES, SMS = 128, 16, 4, 132


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    FWD_GROUPS.clear()


def fwd_vectors(G: int) -> int:
    """Output vectors of 8 elements in a split-forward CTA of G groups."""
    return FWD_THREADS // G // 8 * 8


def fwd_party_groups(nd: int, K: int) -> int:
    """The party groups G of a blind_agg_fwd CTA for N*d = ``nd`` outputs
    and K passive parties.

    With G = 1 one thread per 8 outputs walks all K parties; at K = 63 and
    N*d = 8,192 that is 1,024 threads on 8 SMs, each making 63 trips. So G
    doubles from 1 while the grid, ceil(N*d / 8 / V(G)) CTAs, is below one
    CTA on each of the card's 132 SMs, as long as each group still walks
    at least 4 parties (ceil(K / G) >= 4): below that the partials' round
    trip through shared memory and the barrier cost what the shorter walk
    saves (``chip_smoke.py --phase agg`` times every G at the shapes the
    counted paths launch; at K = 3 no G > 1 beat the walk by more than the
    timing's spread). G stays within the CTA (16 groups of 8 vectors), a
    power of two that divides its 128 threads. Where the scalar path runs
    (N*d not a multiple of 8) G is 1."""
    if nd % 8:
        return 1
    nvec = nd // 8
    G = 1
    while (2 * G <= FWD_MAX_GROUPS and -(-K // (2 * G)) >= FWD_MIN_PARTIES
           and -(-nvec // fwd_vectors(G)) < SMS):
        G *= 2
    return G


def _lib() -> ctypes.CDLL:
    lib = build.load("blind_agg")
    if not getattr(lib, "_argtypes_set", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.blind_agg_fwd.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                      i32, vp]
        lib.blind_agg_fwd.restype = i32
        lib.blind_agg_bwd.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                      vp]
        lib.blind_agg_bwd.restype = i32
        lib.blind_agg_error_string.argtypes = [i32]
        lib.blind_agg_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _prng_lib() -> ctypes.CDLL:
    lib = build.load("blind_agg_prng")
    if not getattr(lib, "_argtypes_set", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.blind_agg_prng_fwd.argtypes = [vp, vp, vp, vp, vp, i32, vp, vp,
                                           i64, i32, ctypes.c_uint32,
                                           ctypes.c_float, i32, i32, vp]
        lib.blind_agg_prng_fwd.restype = i32
        lib.blind_agg_prng_error_string.argtypes = [i32]
        lib.blind_agg_prng_error_string.restype = ctypes.c_char_p
        lib.blind_agg_prng_max_parties.argtypes = []
        lib.blind_agg_prng_max_parties.restype = i32
        lib._argtypes_set = True
    return lib


def _check(name: str, t: torch.Tensor, shape: Tuple[int, ...],
           device: torch.device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor (the plain version "
                         f"for CPU tensors is ref.reference_blind_agg), got "
                         f"{t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (float32, "
                        f"bfloat16, float16)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(error_string, name: str, code: int) -> None:
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def blind_agg_fwd(ea: torch.Tensor, ep: torch.Tensor, mk: torch.Tensor, *,
                  groups: Optional[int] = None) -> torch.Tensor:
    """ea (N, d); ep/mk (K, N, d) -> (N, d) in ea's dtype (CUDA kernel).
    ``groups`` overrides the party groups a CTA (``fwd_party_groups``; 1
    where a pointer is not 16-byte aligned, which the kernel's scalar path
    takes); the kernel raises on a G it cannot take."""
    if ea.dim() != 2 or ep.dim() != 3:
        raise ValueError(f"blind_agg_fwd takes ea (N, d) and ep/mk (K, N, d), "
                         f"got {tuple(ea.shape)} and {tuple(ep.shape)}")
    K = ep.shape[0]
    N, d = ea.shape
    _check("ea", ea, (N, d), ea.device)
    _check("ep", ep, (K, N, d), ea.device)
    _check("mk", mk, (K, N, d), ea.device)
    out = torch.empty_like(ea)
    G = groups
    if G is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (ea, ep, mk, out))
        G = fwd_party_groups(N * d, K) if aligned else 1
    lib = _lib()
    stream = torch.cuda.current_stream(ea.device).cuda_stream
    code = lib.blind_agg_fwd(ea.data_ptr(), ep.data_ptr(), mk.data_ptr(),
                             out.data_ptr(), N * d, K, G,
                             _DTYPE_CODES[ea.dtype], _DTYPE_CODES[ep.dtype],
                             _DTYPE_CODES[mk.dtype], stream)
    _raise_on(lib.blind_agg_error_string, "blind_agg_fwd", code)
    LAUNCHES["blind_agg_fwd"] += 1
    FWD_GROUPS[G] = FWD_GROUPS.get(G, 0) + 1
    return out


def blind_agg_bwd(g: torch.Tensor, K: int, ep_dtype: torch.dtype,
                  mk_dtype: torch.dtype, *, need_ea: bool = True,
                  need_ep: bool = True, need_mk: bool = True
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                             Optional[torch.Tensor]]:
    """g (N, d) -> (dea (N, d) in g's dtype, dep (K, N, d) in ep_dtype,
    dmk (K, N, d) in mk_dtype), each g / (K + 1); a cotangent not asked
    for is None and costs no bytes (CUDA kernel)."""
    if g.dim() != 2:
        raise ValueError(f"blind_agg_bwd takes g (N, d), got {tuple(g.shape)}")
    N, d = g.shape
    _check("g", g, (N, d), g.device)
    for name, dt in (("ep_dtype", ep_dtype), ("mk_dtype", mk_dtype)):
        if dt not in _DTYPE_CODES:
            raise TypeError(f"{name} {dt} not supported")
    dea = torch.empty_like(g) if need_ea else None
    dep = (torch.empty((K, N, d), dtype=ep_dtype, device=g.device)
           if need_ep else None)
    dmk = (torch.empty((K, N, d), dtype=mk_dtype, device=g.device)
           if need_mk else None)
    if dea is None and dep is None and dmk is None:
        return None, None, None
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    stream = torch.cuda.current_stream(g.device).cuda_stream
    code = lib.blind_agg_bwd(g.data_ptr(), ptr(dea), ptr(dep), ptr(dmk),
                             N * d, K, _DTYPE_CODES[g.dtype],
                             _DTYPE_CODES[ep_dtype], _DTYPE_CODES[mk_dtype],
                             stream)
    _raise_on(lib.blind_agg_error_string, "blind_agg_bwd", code)
    LAUNCHES["blind_agg_bwd"] += 1
    return dea, dep, dmk


class _BlindAgg(torch.autograd.Function):
    """Aggregation is linear with dE/dE_a = dE/dE_k = dE/dr_k = 1/C: the
    backward is one kernel writing every party's g/C pullback."""

    @staticmethod
    def forward(ctx, ea, ep, mk):
        ctx.K = ep.shape[0]
        ctx.dtypes = (ep.dtype, mk.dtype)
        return blind_agg_fwd(ea, ep, mk)

    @staticmethod
    def backward(ctx, g):
        need_ea, need_ep, need_mk = ctx.needs_input_grad
        return blind_agg_bwd(g.contiguous(), ctx.K, *ctx.dtypes,
                             need_ea=need_ea, need_ep=need_ep,
                             need_mk=need_mk)


def blind_agg(E_active: torch.Tensor, E_passive: torch.Tensor,
              masks: torch.Tensor) -> torch.Tensor:
    """E_active (..., d); E_passive/masks (K, ..., d) on the card. Returns
    (..., d) in E_active's dtype, differentiable."""
    K = E_passive.shape[0]
    orig_shape = E_active.shape
    d = orig_shape[-1]
    N = E_active.numel() // d
    ea = E_active.reshape(N, d).contiguous()
    ep = E_passive.reshape(K, N, d).contiguous()
    mk = masks.reshape(K, N, d).contiguous()
    return _BlindAgg.apply(ea, ep, mk).reshape(orig_shape)


# ---------------------------------------------------------------------------
# in-kernel mask synthesis
# ---------------------------------------------------------------------------

# the MaskEngine seed tables on each device, uploaded once: (id(engine),
# device) -> (engine, (seed_hi, seed_lo, signs) as int32 tensors); the
# engine is held so that its id stays its own
_TABLES: Dict[Tuple[int, str], Tuple[object, Tuple[torch.Tensor, ...]]] = {}


def device_tables(engine, device) -> Tuple[torch.Tensor, ...]:
    """(seed_hi, seed_lo, signs) of a MaskEngine as contiguous int32
    tensors on ``device`` (uint32 words reinterpreted), cached."""
    device = torch.device(device)
    key = (id(engine), str(device))
    hit = _TABLES.get(key)
    if hit is None or hit[0] is not engine:
        tabs = tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                                      .copy()).to(device)
                     for a in (engine.seed_hi, engine.seed_lo, engine.signs))
        hit = _TABLES[key] = (engine, tabs)
    return hit[1]


def blind_agg_prng_fwd(ea: torch.Tensor, ep: torch.Tensor,
                       seed_hi: torch.Tensor, seed_lo: torch.Tensor,
                       signs: torch.Tensor, round_idx: int,
                       mask_scale: float = 1.0) -> torch.Tensor:
    """ea (N, d); ep (K, N, d); seed tables (K, W >= K-1) int32 on the
    card -> (N, d) in ea's dtype: (ea + sum_k (ep_k + r_k)) / (K + 1) with
    r_k made in the kernel for ``round_idx`` (CUDA kernel)."""
    if ea.dim() != 2 or ep.dim() != 3:
        raise ValueError(f"blind_agg_prng_fwd takes ea (N, d) and ep "
                         f"(K, N, d), got {tuple(ea.shape)} and "
                         f"{tuple(ep.shape)}")
    K = ep.shape[0]
    N, d = ea.shape
    _check("ea", ea, (N, d), ea.device)
    _check("ep", ep, (K, N, d), ea.device)
    width = seed_hi.shape[-1] if seed_hi.dim() == 2 else -1
    for name, t in (("seed_hi", seed_hi), ("seed_lo", seed_lo),
                    ("signs", signs)):
        if t.device != ea.device:
            raise ValueError(f"{name} is on {t.device}, expected {ea.device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: dtype {t.dtype}, expected int32")
        if tuple(t.shape) != (K, width) or width < max(K - 1, 1):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"({K}, >= {max(K - 1, 1)})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    round_idx = int(round_idx)
    if not 0 <= round_idx < 1 << 32:
        raise ValueError(f"round {round_idx} is not a uint32")
    lib = _prng_lib()
    limit = lib.blind_agg_prng_max_parties()
    if K > limit:
        raise ValueError(f"blind_agg_prng_fwd takes at most {limit} passive "
                         f"parties (one tile's pair normals in shared "
                         f"memory), got {K}")
    out = torch.empty_like(ea)
    keys = torch.empty((max(K * (K - 1), 2),), dtype=torch.int32,
                       device=ea.device)
    stream = torch.cuda.current_stream(ea.device).cuda_stream
    code = lib.blind_agg_prng_fwd(
        ea.data_ptr(), ep.data_ptr(), seed_hi.data_ptr(), seed_lo.data_ptr(),
        signs.data_ptr(), width, keys.data_ptr(), out.data_ptr(), N * d, K,
        round_idx, float(mask_scale), _DTYPE_CODES[ea.dtype],
        _DTYPE_CODES[ep.dtype], stream)
    _raise_on(lib.blind_agg_prng_error_string, "blind_agg_prng_fwd",
              code)
    LAUNCHES["blind_agg_prng_fwd"] += 1
    return out


class _PrngBlindAgg(torch.autograd.Function):
    """The masks are constants of the seeds and the round, so the backward
    is ``blind_agg_bwd`` without the mask cotangent; the round and the
    tables get no gradient."""

    @staticmethod
    def forward(ctx, ea, ep, seed_hi, seed_lo, signs, round_idx, mask_scale):
        ctx.K = ep.shape[0]
        ctx.ep_dtype = ep.dtype
        return blind_agg_prng_fwd(ea, ep, seed_hi, seed_lo, signs, round_idx,
                                  mask_scale)

    @staticmethod
    def backward(ctx, g):
        need_ea, need_ep = ctx.needs_input_grad[:2]
        dea, dep, _ = blind_agg_bwd(g.contiguous(), ctx.K, ctx.ep_dtype,
                                    ctx.ep_dtype, need_ea=need_ea,
                                    need_ep=need_ep, need_mk=False)
        return dea, dep, None, None, None, None, None


def prng_blind_agg(E_active: torch.Tensor, E_passive: torch.Tensor, engine,
                   round_idx, mask_scale: float = 1.0) -> torch.Tensor:
    """E_active (..., d); E_passive (K, ..., d) on the card; ``engine`` a
    MaskEngine of K passive parties. Returns (..., d) in E_active's dtype,
    differentiable in both embeddings."""
    K = E_passive.shape[0]
    if engine.n_passive != K:
        raise ValueError(f"mask engine of {engine.n_passive} passive parties "
                         f"for {K} passive embeddings")
    orig_shape = E_active.shape
    d = orig_shape[-1]
    N = E_active.numel() // d
    ea = E_active.reshape(N, d).contiguous()
    ep = E_passive.reshape(K, N, d).contiguous()
    if isinstance(round_idx, torch.Tensor):
        round_idx = round_idx.item()
    tabs = device_tables(engine, ea.device)
    return _PrngBlindAgg.apply(ea, ep, *tabs, int(round_idx),
                               float(mask_scale)).reshape(orig_shape)
