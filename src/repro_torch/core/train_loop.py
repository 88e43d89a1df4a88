"""Chunked training: N EASTER optimizer steps behind one call.

Counterpart of ``repro.core.train_loop``. The reference fuses a chunk into
one ``lax.scan`` (one trace, one dispatch) and donates the params and
optimizer state so XLA updates them in place. The port runs eagerly: a
chunk is a Python loop over the one train step, and the step updates the
parameter and optimizer-state tensors in place (``repro_torch.optim``),
so nothing is copied between steps and there is nothing to donate. One
dispatch per chunk (CUDA-graph capture) is ROADMAP.md queue 1 item B.

The step is the single train-step definition (``make_train_step``):
``loss_fn``, one backward over the leaves ``sys.train_leaves`` names,
``opt.update`` in place on the reference-shaped ``{"parties": [...]}``
tree, and the gradients dropped. So engines, wire modes and optimizers
(``optim.make_party_optimizers`` included) ride along unchanged, and a
chunk equals the step loop bit for bit.

Step i of a chunk started at ``step0`` blinds under the TRAIN-domain
round ``step0 + i`` (``train_round_schedule``), the round the step loop
passes as its step index.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def train_round_schedule(step0, n_steps: int) -> torch.Tensor:
    """PRF round indices a train chunk visits: ``step0 + i`` (int32).
    Training rounds are the TRAIN PRF domain, raw indices below
    ``blinding.SERVE_DOMAIN``, so no training pad coincides with a decode
    or prefill pad of the same shape."""
    return int(step0) + torch.arange(n_steps, dtype=torch.int32)


def loss_and_grads(sys, params, batch, step_idx, seeds):
    """(total, per-party losses, grads) of one round, grads shaped like
    the reference's ``{"parties": [...]}`` tree (passive entries row
    views of the stacked gradients on the vectorized engine). A leaf no
    loss reaches (the backbones in joint mode on a ring wire, whose
    quantized aggregate carries no gradient) gets a zero gradient, as
    ``jax.grad`` gives it."""
    trainable = sys.train_leaves(params)
    leaves = tree_leaves(trainable)
    for t in leaves:
        t.requires_grad_(True)
    total, per = sys.loss_fn(params, batch, step_idx, seeds)
    grads = tree_unflatten(trainable, torch.autograd.grad(
        total, leaves, allow_unused=True, materialize_grads=True))
    return total.detach(), per.detach(), {"parties":
                                          sys.party_grads(grads)}


def make_train_step(sys, opt):
    """One EASTER training step for ``EasterLM``: loss, gradients, update.

    ``step(params, opt_state, batch, step_idx) -> (params, opt_state,
    metrics)``; the parameters and ``opt_state`` are updated in place and
    returned, and the gradients are dropped. The DH ceremony is resolved
    once, here."""
    seeds = sys.mask_seeds()

    def train_step(params, opt_state, batch, step_idx):
        total, per, grads = loss_and_grads(sys, params, batch,
                                           int(step_idx), seeds)
        opt.update(grads, opt_state, {"parties": params["parties"]})
        del grads
        return params, opt_state, {"loss": total, "per_party": per}

    return train_step


def stack_batches(batches: Sequence[Dict[str, Any]], device=None):
    """A list of per-step batch dicts -> one dict of (N, ...) tensors on
    ``device`` (None = the card), moved to the device once here."""
    device = resolve_device(device)
    return {k: torch.as_tensor(np.stack([np.asarray(b[k]) for b in batches]),
                               device=device)
            for k in batches[0]}


def train_chunk(step_fn, params, opt_state, batches, step0):
    """N optimizer steps, N the leading axis of the stacked ``batches``
    (``stack_batches``). ``step0``: the global step of the first batch,
    the base of the TRAIN-domain round schedule. Returns ``(params,
    opt_state, step0 + N, metrics)``, metrics ``{"loss": (N,),
    "per_party": (N, C)}``."""
    step0 = int(step0)
    n = len(next(iter(batches.values())))
    losses: List[torch.Tensor] = []
    pers: List[torch.Tensor] = []
    for i in range(n):
        batch = tree_map(lambda x, i=i: x[i], batches)
        params, opt_state, m = step_fn(params, opt_state, batch, step0 + i)
        losses.append(m["loss"])
        pers.append(m["per_party"])
    return params, opt_state, step0 + n, {"loss": torch.stack(losses),
                                          "per_party": torch.stack(pers)}


def build_train_chunk(sys, opt, *, donate: bool = True):
    """``fn(params, opt_state, batches, step0)``: ``train_chunk`` over
    ``make_train_step(sys, opt)``. ``donate`` is accepted for the
    reference's signature and does nothing: the step already updates the
    params and optimizer state in place."""
    del donate
    step_fn = make_train_step(sys, opt)

    def run(params, opt_state, batches, step0):
        return train_chunk(step_fn, params, opt_state, batches, step0)

    return run
