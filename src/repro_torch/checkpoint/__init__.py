"""Flat-path ``.npz`` checkpoints (``save`` / ``restore``, the format of
``repro.checkpoint``) and weight conversion between the reference's
parameter pytrees and the port's tensor trees, through numpy.

A checkpoint holds one array per leaf under its path, dict keys and list
indices joined by ``||`` (``params||parties||0||head||w``); a bfloat16
leaf is stored as float32 under its path plus ``@bf16``; ``__step__``
holds the step when one is given. Either package restores the other's
file.

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

import os
from typing import Any, Dict

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


_SEP = "||"


def _walk(tree, path=()):
    """(path, leaf) pairs, dict keys and list indices as in the
    reference's key paths."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _walk(t, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _flatten(tree) -> Dict[str, np.ndarray]:
    out = {}
    for key, leaf in _walk(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                out[key + "@bf16"] = t.float().numpy()
            else:
                out[key] = t.numpy()
        else:
            out[key] = np.asarray(leaf)
    return out


def save(path: str, tree: Any, step: int | None = None) -> str:
    """Write ``tree`` (tensors or arrays at the leaves) to ``path``
    atomically (a temporary file, then a rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def restore(path: str, like: Any):
    """Restore into the structure of ``like`` (a tree of tensors): new
    tensors of each leaf's dtype on its device. Returns (tree, step),
    step None when the file holds none."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__")) if "__step__" in flat else None

    def load(key, leaf):
        if key in flat:
            t = torch.from_numpy(np.array(flat[key]))
        elif key + "@bf16" in flat:
            t = torch.from_numpy(np.array(flat[key + "@bf16"]))
        else:
            raise KeyError(f"checkpoint missing {key}")
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, "
                             f"expected {tuple(leaf.shape)}")
        return t.to(dtype=leaf.dtype, device=leaf.device)

    def build(tree, path=()):
        if isinstance(tree, dict):
            return {k: build(v, path + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(t, path + (str(i),))
                              for i, t in enumerate(tree))
        return load(_SEP.join(path), tree)

    return build(like), step
