"""Fused blind + aggregate (the paper's Eq. 6 + Eq. 7) as CUDA kernels.

Counterpart of ``repro.kernels.blind_agg``'s ``_fwd_kernel`` and
``_bwd_kernel``; the sources and the design note are in
``csrc/blind_agg.cu``. This module binds them:

  * ``blind_agg_fwd(ea (N, d), ep (K, N, d), mk (K, N, d))`` -> (N, d) in
    ea's dtype, (ea + sum_k (ep_k + mk_k)) / (K + 1) with a float32
    accumulator;
  * ``blind_agg_bwd(g (N, d), K, ...)`` -> (dea, dep, dmk), every one
    g / (K + 1) in its own dtype, each written only if asked for;
  * ``blind_agg``, the public differentiable function: any rank, flattened
    to (N, d) and (K, N, d) as the reference does, through a
    ``torch.autograd.Function`` whose forward and backward are the two
    kernels.

Every wrapper takes CUDA tensors only (float32, bfloat16 or float16,
contiguous, matching shapes) and raises on anything else; the plain
version for CPU tensors is ``ref.reference_blind_agg``, chosen by
``ops.blind_agg``. Each launch adds one to ``LAUNCHES[<wrapper name>]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

# launches of each kernel in this process; reset with reset_launches()
LAUNCHES: Dict[str, int] = {"blind_agg_fwd": 0, "blind_agg_bwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("blind_agg")
    if not getattr(lib, "_argtypes_set", False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.blind_agg_fwd.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                      vp]
        lib.blind_agg_fwd.restype = i32
        lib.blind_agg_bwd.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32, i32,
                                      vp]
        lib.blind_agg_bwd.restype = i32
        lib.blind_agg_error_string.argtypes = [i32]
        lib.blind_agg_error_string.restype = ctypes.c_char_p
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


def _raise_on(lib: ctypes.CDLL, name: str, code: int) -> None:
    if code != 0:
        msg = lib.blind_agg_error_string(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({code})")


def blind_agg_fwd(ea: torch.Tensor, ep: torch.Tensor,
                  mk: torch.Tensor) -> torch.Tensor:
    """ea (N, d); ep/mk (K, N, d) -> (N, d) in ea's dtype (CUDA kernel)."""
    if ea.dim() != 2 or ep.dim() != 3:
        raise ValueError(f"blind_agg_fwd takes ea (N, d) and ep/mk (K, N, d), "
                         f"got {tuple(ea.shape)} and {tuple(ep.shape)}")
    K = ep.shape[0]
    N, d = ea.shape
    _check("ea", ea, (N, d), ea.device)
    _check("ep", ep, (K, N, d), ea.device)
    _check("mk", mk, (K, N, d), ea.device)
    out = torch.empty_like(ea)
    lib = _lib()
    stream = torch.cuda.current_stream(ea.device).cuda_stream
    code = lib.blind_agg_fwd(ea.data_ptr(), ep.data_ptr(), mk.data_ptr(),
                             out.data_ptr(), N * d, K, _DTYPE_CODES[ea.dtype],
                             _DTYPE_CODES[ep.dtype], _DTYPE_CODES[mk.dtype],
                             stream)
    _raise_on(lib, "blind_agg_fwd", code)
    LAUNCHES["blind_agg_fwd"] += 1
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
    _raise_on(lib, "blind_agg_bwd", code)
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
