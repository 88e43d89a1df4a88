"""RG-LRU recurrent block (RecurrentGemma / Griffin), counterpart of
``repro.models.griffin``. [arXiv:2402.19427]

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
    a_t = exp(-c * softplus(Lambda) * r_t)

The gates are computed as the reference computes them, in float32. The
prompt's recurrence goes through ``kernels.ops.rglru_scan``: the
``rglru_scan_fwd`` kernel for CUDA tensors, the sequential plain version
for CPU tensors (the reference's default path is an associative scan,
which rounds differently; the tests state the tolerance). A training
forward (``training=True``) takes the sequential plain version on every
device, since the kernel has no backward. A carried state
enters the scan as its ``h0``, where the reference folds it into the
first step's b with a zero state: both compute a_0 * s + b_0, each
product and sum rounded. Decode is the reference's single-step update as
torch ops (``rglru_step``). ``lam`` stays float32 in a bfloat16 tree.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import _dense_init, init_linear, linear
from repro_torch.models.ssm import _depthwise_conv

RG_LRU_C = 8.0
CONV_W = 4


def init_rglru(gen: torch.Generator, d_model: int, width: int, dtype) -> dict:
    dev = gen.device
    return {
        "in_x": init_linear(gen, d_model, width, False, dtype),
        "in_gate": init_linear(gen, d_model, width, False, dtype),
        "conv_w": _dense_init(gen, (CONV_W, width), dtype, scale=0.5),
        "conv_b": torch.zeros((width,), dtype=dtype, device=dev),
        "w_r": init_linear(gen, width, width, True, dtype),
        "w_i": init_linear(gen, width, width, True, dtype),
        # Lambda init so that a ~ U[0.9, 0.999]^c (Griffin appendix)
        "lam": torch.linspace(0.2, 2.0, width, dtype=torch.float32,
                              device=dev),
        "out": init_linear(gen, width, d_model, False, dtype),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) (``F.softplus`` switches to x
    above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _gates(p: dict, x: torch.Tensor, xg: Optional[torch.Tensor] = None):
    """a and b from the conv output x; ``xg``: the whole width of x, which
    the (W, W) gate products read where x is this rank's block of it."""
    xg = x if xg is None else xg
    r = torch.sigmoid(linear(p["w_r"], xg).float())
    i = torch.sigmoid(linear(p["w_i"], xg).float())
    log_a = -RG_LRU_C * _softplus(p["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * x.float()
    return a, b


def rglru_scan(p: dict, x: torch.Tensor,
               init_state: Optional[torch.Tensor] = None,
               training: bool = False, xg: Optional[torch.Tensor] = None):
    """x (B, L, W) -> (h (B,L,W) float32, final state (B,W) float32)."""
    a, b = _gates(p, x, xg)
    h0 = (init_state.float() if init_state is not None
          else a.new_zeros((a.shape[0], a.shape[2])))
    if training:
        return ref.reference_rglru(a, b, h0)
    return ops.rglru_scan(a, b, h0)


def rglru_step(p: dict, x: torch.Tensor, state: torch.Tensor,
               xg: Optional[torch.Tensor] = None):
    """x (B, 1, W), state (B, W) -> (h (B,1,W), new_state)."""
    a, b = _gates(p, x, xg)
    h = a[:, 0] * state + b[:, 0]
    return h[:, None], h


def recurrent_block(p: dict, x: torch.Tensor, cache: Optional[dict] = None,
                    training: bool = False, tp=None):
    """Griffin recurrent block: gated conv + RG-LRU. x (B,L,d_model).
    cache {"conv": (B, CONV_W-1, W), "state": (B, W)}. Returns (out,
    cache).

    Under ``tp`` (a ``sharding.TP`` with ``lru``) x is the stream as it
    lies and so is the output; the block runs at this rank's width W / m:
    ``in_x`` / ``in_gate`` by columns, the conv on the rank's channels
    (its block of the replicated taps, whose cotangents ``tp.partial``
    sums), the conv output all-gathered over "model" for ``w_r`` /
    ``w_i`` (by columns), ``lam``, the scan and the cache at the rank's
    width, ``out`` by rows into ``tp.exit``."""
    tp = tp if tp is not None else sharding.WHOLE
    x = tp.enter(x)
    gate = F.gelu(linear(p["in_gate"], x), approximate="tanh")
    xb = linear(p["in_x"], x)
    conv_w, conv_b = tp.partial((p["conv_w"], p["conv_b"]))
    conv_w, conv_b = tp.block(conv_w), tp.block(conv_b)
    conv_cache = cache["conv"] if cache is not None else None
    xb, new_conv = _depthwise_conv(xb, conv_w, conv_b, conv_cache)
    xg = None if tp.mesh is None else sharding.gather_cols(xb, tp.mesh)
    if cache is not None and x.shape[1] == 1:
        h, new_state = rglru_step(p, xb, cache["state"], xg)
    else:
        init_state = cache["state"] if cache is not None else None
        h, new_state = rglru_scan(p, xb, init_state, training, xg)
    y = h.to(x.dtype) * gate
    out = tp.exit(linear(p["out"], y))
    new_cache = {"conv": new_conv.to(x.dtype), "state": new_state}
    return out, new_cache


def init_rglru_cache(batch: int, width: int, dtype, device=None) -> dict:
    return {"conv": torch.zeros((batch, CONV_W - 1, width), dtype=dtype,
                                device=device),
            "state": torch.zeros((batch, width), dtype=torch.float32,
                                 device=device)}
