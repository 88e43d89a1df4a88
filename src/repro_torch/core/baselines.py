"""Baseline VFL methods the paper compares against (§V-A3), in PyTorch.

Counterpart of ``repro.core.baselines``:

  * Local       — models trained on the active party's feature slice only.
  * SplitVFL    — Pyvertical [27]: per-party bottom nets, concatenated into a
                  trainable top model at the active party.
  * C_VFL       — [10]: SplitVFL + top-k sparsification of the uploaded
                  activations (communication compression), straight-through
                  gradients.
  * AggVFL      — [28]: every party holds a full local model on its own
                  features; the active party averages the *predictions*
                  (non-trainable aggregate).

Each method runs on the card unless ``device`` says otherwise (``None``
resolves to CUDA and raises without a GPU), as ``EasterClassifier`` does.
``init_params`` draws from a CPU ``torch.Generator``; the trees have the
reference's layout, so ``repro_torch.checkpoint`` carries weights across.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch

from repro_torch.core import blinding, losses
from repro_torch.core.party_models import (PartyArch, decide_fn, embed_fn,
                                           init_party)
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_linear, linear
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# wire framing of a baseline's comm legs: bytes/element derives from the
# wire dtype (int8 ships packed ring words + a per-leg fp32 scale —
# blinding.wire_leg_bytes, the accounting the EASTER protocol uses)
_WIRE_MODE = {"float32": "float", "int32": "int32", "int8": "int8"}


def _leg_bytes(n_elts: int, wire_dtype: str) -> int:
    return blinding.wire_leg_bytes(n_elts, _WIRE_MODE[wire_dtype])


def _topk_sparsify(x: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """Keep the top-``keep_frac`` magnitudes of each row (ties at the
    threshold kept); straight-through backward. The forward value is the
    sparse tensor bit for bit: x + (0 - x) is +0 and x + 0 is x."""
    k = max(1, int(x.shape[-1] * keep_frac))
    thresh = torch.topk(x.abs(), k, dim=-1).values[..., -1:]  # kth largest
    sparse = torch.where(x.abs() >= thresh, x, 0.0)
    return x + (sparse - x).detach()


def _with_grad(params):
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


@dataclass
class SplitVFL:
    """Pyvertical-style SplitVFL; ``compress_frac`` > 0 makes it C_VFL."""
    arches: List[PartyArch]
    n_features: List[int]
    n_classes: int = 10
    top_hidden: int = 128
    compress_frac: float = 0.0
    loss: str = "ce"
    wire_dtype: str = "float32"
    device: Any = None                  # None = the card

    def __post_init__(self):
        self.C = len(self.arches)
        self.device = resolve_device(self.device)

    def init_params(self, gen: torch.Generator):
        bottoms = [init_party(gen, self.arches[k], self.n_features[k])
                   for k in range(self.C)]
        d_cat = sum(a.d_embed for a in self.arches)
        top = {"l1": init_linear(gen, d_cat, self.top_hidden, True,
                                 torch.float32),
               "l2": init_linear(gen, self.top_hidden, self.n_classes,
                                 True, torch.float32)}
        return _with_grad(tree_map(lambda t: t.to(self.device),
                                   {"bottoms": bottoms, "top": top}))

    def logits(self, params, xs):
        hs = []
        for k in range(self.C):
            h = embed_fn(params["bottoms"][k], self.arches[k], xs[k])
            if self.compress_frac > 0:
                h = _topk_sparsify(h, self.compress_frac)
            hs.append(h)
        h = torch.relu(linear(params["top"]["l1"], torch.cat(hs, dim=-1)))
        return linear(params["top"]["l2"], h)

    def loss_fn(self, params, xs, y, masks=None):
        l = losses.LOSSES[self.loss](self.logits(params, xs), y)
        return l, l.expand(self.C)

    @torch.no_grad()
    def accuracy(self, params, xs, y):
        acc = torch.mean((torch.argmax(self.logits(params, xs), -1)
                          == y).float())
        return acc.expand(self.C)

    def bytes_per_round(self, batch: int) -> int:
        """Uplink activations + downlink grads per round, framed in
        ``wire_dtype``; top-k compression (values + indices) supersedes
        dtype narrowing when enabled."""
        if self.compress_frac > 0:
            d_cat = sum(a.d_embed for a in self.arches[1:])
            per = int(d_cat * batch * 4 * self.compress_frac * 2)
            return 2 * per                           # values + indices
        per = sum(_leg_bytes(a.d_embed * batch, self.wire_dtype)
                  for a in self.arches[1:])
        return 2 * per                               # up + down


@dataclass
class AggVFL:
    """Prediction-averaging aggVFL (Agg_VFL [28])."""
    arches: List[PartyArch]
    n_features: List[int]
    loss: str = "ce"
    wire_dtype: str = "float32"
    device: Any = None                  # None = the card

    def __post_init__(self):
        self.C = len(self.arches)
        self.device = resolve_device(self.device)

    def init_params(self, gen: torch.Generator):
        return _with_grad([init_party(gen, self.arches[k], self.n_features[k],
                                      self.device) for k in range(self.C)])

    def party_logits(self, params, xs):
        return [decide_fn(params[k], self.arches[k],
                          embed_fn(params[k], self.arches[k], xs[k]))
                for k in range(self.C)]

    def loss_fn(self, params, xs, y, masks=None):
        agg = torch.mean(torch.stack(self.party_logits(params, xs)), dim=0)
        l = losses.LOSSES[self.loss](agg, y)       # non-trainable aggregate
        return l, l.expand(self.C)

    @torch.no_grad()
    def accuracy(self, params, xs, y):
        R = self.party_logits(params, xs)
        return torch.stack([torch.mean((torch.argmax(r, -1) == y).float())
                            for r in R])

    @torch.no_grad()
    def aggregate_accuracy(self, params, xs, y):
        """Accuracy of the (non-trainable) averaged prediction."""
        agg = torch.mean(torch.stack(self.party_logits(params, xs)), dim=0)
        return torch.mean((torch.argmax(agg, -1) == y).float())

    def bytes_per_round(self, batch: int) -> int:
        n_cls = self.arches[0].n_classes
        return 2 * (self.C - 1) * _leg_bytes(batch * n_cls,
                                             self.wire_dtype)


@dataclass
class LocalOnly:
    """Models trained on the active party's features alone (paper 'Local')."""
    arches: List[PartyArch]
    n_features: List[int]
    loss: str = "ce"
    device: Any = None                  # None = the card

    def __post_init__(self):
        self.C = len(self.arches)
        self.device = resolve_device(self.device)

    def init_params(self, gen: torch.Generator):
        # every theta_k trains on party-0's slice (paper §V-B1)
        return _with_grad([init_party(gen, self.arches[k], self.n_features[0],
                                      self.device) for k in range(self.C)])

    def _logits(self, params, xs):
        x0 = xs[0]
        return [decide_fn(params[k], self.arches[k],
                          embed_fn(params[k], self.arches[k], x0))
                for k in range(self.C)]

    def loss_fn(self, params, xs, y, masks=None):
        per = torch.stack([losses.LOSSES[self.loss](r, y)
                           for r in self._logits(params, xs)])
        return torch.sum(per), per

    @torch.no_grad()
    def accuracy(self, params, xs, y):
        return torch.stack([torch.mean((torch.argmax(r, -1) == y).float())
                            for r in self._logits(params, xs)])

    def bytes_per_round(self, batch: int) -> int:
        return 0


def make_train_step(method, optimizer_name: str, lr: float, **opt_kw):
    """(init_opt, step) for any method exposing ``loss_fn``: one optimizer
    over the whole tree. ``step`` updates params and optimizer state in
    place and returns ``(params, opt_state, total, per)`` with the losses
    detached; a leaf no loss reaches (SplitVFL's unused bottom ``decide``
    nets) gets a zero gradient, as ``jax.grad`` gives it."""
    opt = make_optimizer(optimizer_name, lr, **opt_kw)

    def step(params, opt_state, xs, y, masks):
        total, per = method.loss_fn(params, xs, y, masks)
        grads = tree_unflatten(params, torch.autograd.grad(
            total, tree_leaves(params), allow_unused=True,
            materialize_grads=True))
        opt.update(grads, opt_state, params)
        return params, opt_state, total.detach(), per.detach()

    return opt.init, step
