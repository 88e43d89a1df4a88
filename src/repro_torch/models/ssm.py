"""Mamba-2 SSD (state-space duality) block (counterpart of
``repro.models.ssm``) [arXiv:2405.21060], and the causal depthwise
convolution it shares with the RG-LRU block.

Prefill and training use the chunked dual form: quadratic attention-like
compute inside chunks of length Q, a linear recurrence across chunks (a
Python loop over the chunks where the reference runs ``lax.scan``).
Decode is the O(1) recurrent step on the state (B, H, P, N): no token
cache.

One standing difference from the reference (ROADMAP.md queue 3): where
the prompt length L is not a multiple of the chunk Q = min(cfg.chunk, L),
the reference runs the chunked form at gcd(L, Q), which is 1 for every
odd L (a serving prefill runs on ``prompt[:-1]``: 511, 1023, 2047
tokens): L chunks of one token, each with its own (h, p, n) state. The
port pads L up to a multiple of Q with dt = 0 (set after the softplus)
and slices y back: a pad step decays the state by exp(0) = 1 and adds
dt·B·x = 0, so the final state and the first L outputs are the same in
exact arithmetic, and float32 differs by rounding only.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.configs.base import SSMConfig
from repro_torch.models.layers import _dense_init, apply_norm, init_norm

N_GROUPS = 1  # B/C projection groups


def ssm_dims(d_model: int, cfg: SSMConfig):
    d_inner = cfg.expand * d_model
    n_heads = d_inner // cfg.head_dim
    conv_dim = d_inner + 2 * N_GROUPS * cfg.d_state
    return d_inner, n_heads, conv_dim


def init_ssm(gen: torch.Generator, d_model: int, cfg: SSMConfig,
             dtype) -> dict:
    d_inner, H, conv_dim = ssm_dims(d_model, cfg)
    zxbcdt = 2 * d_inner + 2 * N_GROUPS * cfg.d_state + H
    dev = gen.device
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": _dense_init(gen, (d_model, zxbcdt), dtype),
        "conv_w": _dense_init(gen, (cfg.d_conv, conv_dim), dtype, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.zeros((H,), **f32),              # A = -exp(A_log)
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.full((H,), -2.0, **f32),       # softplus ~ 0.12
        "norm": init_norm("rms", d_inner, dtype, dev),
        "out_proj": _dense_init(gen, (d_inner, d_model), dtype),
    }


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., q) -> (..., q, q) lower-triangular segment sums:
    out[i, j] = sum(x[j+1 .. i]), -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD dual-form scan.

    x (b,l,h,p) f32, dt (b,l,h) f32 (already softplus'ed), A (h,) f32
    (< 0), B/C (b,l,g,n) f32, l a multiple of ``chunk``. Returns
    (y (b,l,h,p), final_state (b,h,p,n))."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of the chunk {chunk}")
    nc = l // chunk
    r = lambda t: t.reshape(b, nc, chunk, *t.shape[2:])
    xc, dtc, Bc, Cc = r(x), r(dt), r(B), r(C)

    dA = dtc * A                                   # (b,nc,q,h)
    dA_cs = torch.cumsum(dA, dim=2)

    # intra-chunk (diagonal blocks)
    Lm = torch.exp(_segsum(torch.movedim(dA, -1, 2)))     # (b,nc,h,q,q)
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)       # (b,nc,g,q,k)
    CB = torch.repeat_interleave(CB, h // g, dim=2)       # groups -> heads
    scores = CB * Lm
    y_diag = torch.einsum("bchqk,bckh,bckhp->bcqhp", scores, dtc, xc)

    # chunk-final states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # (b,nc,q,h)
    states = torch.einsum("bcqgn,bcqh,bcqhp->bchpn",
                          Bc, decay_states * dtc, xc)     # (b,nc,h,p,n)

    # inter-chunk recurrence: the state carried into each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # (b,nc,h)
    s = (x.new_zeros((b, h, p, n)) if init_state is None
         else init_state.to(x.dtype))
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                 # (b,nc,h,p,n)

    # contribution of the carried-in state
    state_decay = torch.exp(dA_cs)                         # (b,nc,q,h)
    y_off = torch.einsum("bcqgn,bchpn,bcqh->bcqhp",
                         Cc, prev_states, state_decay)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, s


def ssd_decode_step(state, x, dt, A, B, C):
    """One-token recurrence. state (b,h,p,n); x (b,h,p); dt (b,h); B/C
    (b,g,n). Returns (y (b,h,p), new_state)."""
    dA = torch.exp(dt * A)                                 # (b,h)
    Bx = torch.einsum("bgn,bh,bhp->bhpn", B, dt, x)
    new_state = state * dA[:, :, None, None] + Bx
    y = torch.einsum("bgn,bhpn->bhp", C, new_state)
    return y, new_state


def ssd_padded(x, dt, A, B, C, chunk: int,
               init_state: Optional[torch.Tensor] = None):
    """``ssd_chunked`` at ``chunk`` for any length: the sequence is padded
    to a multiple of the chunk with dt = 0 (a pad step keeps the state and
    adds nothing) and y sliced back to its length."""
    L = x.shape[1]
    pad = -L % chunk
    if pad:
        grow = lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
        x, dt, B, C = grow(x), grow(dt), grow(B), grow(C)
    y, state = ssd_chunked(x, dt, A, B, C, chunk, init_state)
    return y[:, :L], state


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    cache: Optional[torch.Tensor] = None):
    """Causal depthwise conv. x (B,L,D), w (W,D), b (D,). cache (B,W-1,D)
    or None (zeros). Returns (y (B,L,D), new_cache (B,W-1,D)). The taps
    are summed in the reference's order: a Python ``sum`` over the W taps
    (from 0), then ``+ b``."""
    W = w.shape[0]
    if cache is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                       # (B, L+W-1, D)
    L = x.shape[1]
    y = sum(xp[:, i:i + L] * w[i] for i in range(W)) + b
    new_cache = xp[:, -(W - 1):]
    return y, new_cache


def ssm_block(p: dict, x: torch.Tensor, cfg: SSMConfig,
              cache: Optional[dict] = None, rms_eps: float = 1e-6, tp=None):
    """The Mamba-2 mixer. x (B, L, d_model); ``cache`` {"conv", "state"}
    continues from a prefix (one token: the recurrent step). Returns
    (out, new_cache).

    Under ``tp`` (a ``sharding.TP`` with ``ssd``) x is the stream as it
    lies and so is the output: the packed ``in_proj``, the conv and the
    SiLU run whole on every model rank (they are replicated, their
    cotangents summed over "model" by ``tp.partial``), the SSD, the ``D``
    skip and the ``z`` gate on the rank's heads (``A_log`` / ``D`` /
    ``dt_bias`` its blocks), the gated norm's mean square over the whole
    ``d_inner`` (a sum over "model"), ``out_proj`` by rows into
    ``tp.exit``; the cache's state holds the rank's heads, its conv the
    whole channels."""
    tp = tp if tp is not None else sharding.WHOLE
    x = tp.enter(x)
    Bsz, L, d_model = x.shape
    d_inner, H, conv_dim = ssm_dims(d_model, cfg)
    g, n, P = N_GROUPS, cfg.d_state, cfg.head_dim
    in_proj, conv_w, conv_b, scale = tp.partial(
        (p["in_proj"], p["conv_w"], p["conv_b"], p["norm"]["scale"]))

    zxbcdt = x @ in_proj
    z, xbc, dt_raw = torch.split(zxbcdt, [d_inner, conv_dim, H], dim=-1)
    z, dt_raw = tp.block(z), tp.block(dt_raw)              # rank's heads
    H_here, d_here = H // tp.m, d_inner // tp.m
    # jax.nn.softplus: log(1 + exp(v)) with no threshold
    v = dt_raw.float() + p["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))           # (B,L,H)
    A = -torch.exp(p["A_log"])                             # (H,)

    conv_cache = cache["conv"] if cache is not None else None
    xbc, new_conv = _depthwise_conv(xbc, conv_w, conv_b, conv_cache)
    xbc = F.silu(xbc)
    xs, Bmat, Cmat = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xh = tp.block(xs).reshape(Bsz, L, H_here, P).float()
    Bm = Bmat.reshape(Bsz, L, g, n).float()
    Cm = Cmat.reshape(Bsz, L, g, n).float()

    if cache is not None and L == 1:
        y, new_state = ssd_decode_step(
            cache["state"], xh[:, 0], dt[:, 0], A, Bm[:, 0], Cm[:, 0])
        y = y[:, None]                                     # (B,1,H,P)
    else:
        init_state = cache["state"] if cache is not None else None
        y, new_state = ssd_padded(xh, dt, A, Bm, Cm, min(cfg.chunk, L),
                                  init_state)

    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(Bsz, L, d_here).to(x.dtype)
    y = y * F.silu(z)
    if tp.mesh is None:
        y = apply_norm({"scale": scale}, y, rms_eps)
    else:   # the RMS over the whole d_inner, of every rank's heads
        yf = y.float()
        ss = sharding.model_sum(torch.sum(yf * yf, dim=-1, keepdim=True),
                                tp.mesh)
        y = (yf * torch.rsqrt(ss / d_inner + rms_eps)
             * tp.block(scale).float()).to(y.dtype)
    out = tp.exit(y @ p["out_proj"])
    new_cache = {"conv": new_conv.to(x.dtype), "state": new_state}
    return out, new_cache


def init_ssm_cache(batch: int, d_model: int, cfg: SSMConfig, dtype,
                   device=None) -> dict:
    d_inner, H, conv_dim = ssm_dims(d_model, cfg)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, H, cfg.head_dim, cfg.d_state),
                             dtype=torch.float32, device=device),
    }
