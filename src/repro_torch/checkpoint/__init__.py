"""Weight conversion between the reference's parameter pytrees and the
port's tensor trees, through numpy.

``EasterClassifier.init_params`` and ``EasterLM.init_params`` return, in
both packages, trees with the same nested keys and the same leaf layouts
(dense ``w`` is (d_in, d_out), conv weights are HWIO, a transformer
segment's leaves are stacked over its (reps, ...) axis). So a tree of
numpy arrays taken from either side carries across leaf for leaf; tests
use this to hand identical weights to both packages.

bfloat16 leaves: JAX hands them over as numpy arrays of ``ml_dtypes``'
bfloat16, which ``torch.from_numpy`` rejects. The dtype is recognized by
its name and the bits cross as uint16 (no ``ml_dtypes`` import: the GPU
machine has no JAX). Back to numpy, a bfloat16 tensor becomes an array of
numpy's ``bfloat16`` dtype, which exists once ``ml_dtypes`` is loaded in
the process (as it is wherever JAX is).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_numpy(trees, device=None, requires_grad: bool = True):
    """Tree of numpy arrays (or anything ``np.asarray`` takes, bfloat16
    included) -> tree of tensors on ``device`` (None = the card), floating
    leaves requiring grad if asked."""
    device = resolve_device(device)

    def conv(a):
        t = _to_tensor(a).to(device)
        return t.requires_grad_(requires_grad) if t.is_floating_point() else t

    return tree_map(conv, trees)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError("numpy has no bfloat16 dtype in this process "
                            "(import ml_dtypes first)") from e
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_to_numpy(params):
    """Tree of tensors -> tree of numpy arrays (on the host)."""
    return tree_map(_to_numpy, params)
