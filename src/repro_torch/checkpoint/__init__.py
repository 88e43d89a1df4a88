"""Weight conversion between the reference's parameter pytrees and the
port's tensor trees, through numpy.

``EasterClassifier.init_params`` returns, in both packages, a list of
per-party ``{"embed": ..., "decide": ...}`` trees with the same nested
keys and the same leaf layouts (dense ``w`` is (d_in, d_out), conv weights
are HWIO). So a tree of numpy arrays taken from either side carries across
leaf for leaf; tests use this to hand identical weights to both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_map


def params_from_numpy(trees, device=None, requires_grad: bool = True):
    """Tree of numpy arrays (or anything ``np.asarray`` takes) -> tree of
    tensors on ``device`` (None = the card), leaves requiring grad."""
    device = resolve_device(device)

    def conv(a):
        t = torch.from_numpy(np.array(a, copy=True)).to(device)
        return t.requires_grad_(requires_grad) if t.is_floating_point() else t

    return tree_map(conv, trees)


def params_to_numpy(params):
    """Tree of tensors -> tree of numpy arrays (on the host)."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)
