"""The causal depthwise convolution of the SSM and RG-LRU blocks
(counterpart of ``repro.models.ssm._depthwise_conv``). The Mamba-2 mixer
itself is ROADMAP.md queue 1 item 13."""
from __future__ import annotations

from typing import Optional

import torch


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
