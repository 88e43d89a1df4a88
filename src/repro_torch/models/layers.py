"""Dense layers for the paper-scale party models (plain tensors in dicts,
in the reference's ``repro.models.layers`` layout: ``w`` is (d_in, d_out)).

Only ``_dense_init``, ``init_linear`` and ``linear`` are ported; the LLM
layers (norms, rope, attention) wait for the LM slice."""
from __future__ import annotations

import math
from typing import Optional

import torch


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen`` (on the CPU, so one
    generator gives the same weights whatever device they land on)."""
    fan_in = shape[0]
    s = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return (w * s).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool,
                dtype) -> dict:
    p = {"w": _dense_init(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
