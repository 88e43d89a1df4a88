"""Vectorized many-party execution engine.

PyTorch counterpart of ``repro.core.party_engine`` without the mesh.
Parties are grouped by execution signature ``(PartyArch, n_features)``
(parties of one signature have parameter trees of one shape); each
group's parameters are stacked along a leading axis inside the call and
the group runs as one ``torch.func.vmap`` of ``embed_fn`` / ``decide_fn``.
With C near-equal vertical slices there are at most
``2 x len(distinct arches)`` groups, so a round issues O(#groups)
batched ops instead of O(C).

Parameters stay a plain per-party list at every entry point (the
federation's trust boundary, and what ``checkpoint.params_from_numpy``
hands over). Stacking happens inside each call, so autograd carries the
gradients back to every party's own leaves. A group of one party has
nothing to batch: it calls the party's own net and updates the party's
own tensors, with no stacking and no copy back. Outputs come back in
party order through a precomputed permutation, skipped where the groups
already lie in party order.

The mesh-sharded engine (``embed_blind_uplink*``, ``aggregate_via_active``,
``decide_from``) is ROADMAP.md queue 1 item 14 and is not here.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.func import vmap

from repro_torch.core.party_models import PartyArch, decide_fn, embed_fn
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def group_by(keys: Sequence[Any]) -> List[Tuple[Any, Tuple[int, ...]]]:
    """Stable grouping: (key, member indices) in first-seen key order."""
    groups: Dict[Any, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    return [(k, tuple(v)) for k, v in groups.items()]


def stack_trees(trees: Sequence[Any]):
    """Stack identically-shaped trees along a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _stack_view(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(xs)`` as a view where the tensors are rows of one
    tensor: equally spaced in one storage with one shape and strides (the
    rows of an unstacked tensor, or one tensor repeated, whose rows then
    have a stride of 0). A copy otherwise, and wherever autograd would
    have to follow the rows."""
    x0 = xs[0]
    step = xs[1].storage_offset() - x0.storage_offset() if len(xs) > 1 else 0
    rows = all(
        x.dtype == x0.dtype and x.device == x0.device
        and x.shape == x0.shape and x.stride() == x0.stride()
        and x.untyped_storage().data_ptr()
        == x0.untyped_storage().data_ptr()
        and x.storage_offset() == x0.storage_offset() + i * step
        for i, x in enumerate(xs))
    if not rows or (torch.is_grad_enabled()
                    and any(x.requires_grad for x in xs)):
        return torch.stack(xs)
    return x0.as_strided((len(xs),) + tuple(x0.shape),
                         (step,) + tuple(x0.stride()), x0.storage_offset())


def stack_views(trees: Sequence[Any]):
    """``stack_trees`` that reads rows of one tensor in place
    (``_stack_view``): an input every party shares, or per-party views
    into one stacked tensor, cost no copy."""
    return tree_map(lambda *xs: _stack_view(xs), *trees)


def unstack_tree(tree, n: int) -> List[Any]:
    """Inverse of stack_trees: split the leading axis back into a list."""
    return [tree_map(lambda x, i=i: x[i], tree) for i in range(n)]


def _selector(idx: Tuple[int, ...]):
    """How to take a group's rows out of a (C, ...) tensor: a slice (a
    view, no copy) where the members are evenly spaced, as a group of a
    cycled zoo is, else an index tensor."""
    step = idx[1] - idx[0] if len(idx) > 1 else 1
    if all(b - a == step for a, b in zip(idx, idx[1:])):
        return slice(idx[0], idx[-1] + 1, step)
    return torch.tensor(idx, dtype=torch.long)


class PartyEngine:
    """Grouped-vmap executor for C heterogeneous paper-scale parties."""

    def __init__(self, arches: Sequence[PartyArch],
                 n_features: Sequence[int]):
        if len(arches) != len(n_features):
            raise ValueError(f"{len(arches)} arches, {len(n_features)} "
                             f"feature slices")
        if len({a.d_embed for a in arches}) != 1:
            raise ValueError("d_embed must be shared")
        if len({a.n_classes for a in arches}) != 1:
            raise ValueError("labels are shared: one n_classes")
        self.C = len(arches)
        self.arches = list(arches)
        self.n_features = list(n_features)
        self.groups = group_by(list(zip(self.arches, self.n_features)))
        order = [i for _, idx in self.groups for i in idx]
        inv = [0] * self.C
        for pos, i in enumerate(order):
            inv[i] = pos
        # concat-of-groups row of party i
        self._perm = torch.tensor(inv, dtype=torch.long)
        self._in_order = inv == list(range(self.C))
        self._sel = [_selector(idx) for _, idx in self.groups]
        self._on_device: Dict[Tuple[str, int], torch.Tensor] = {}

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    # -- helpers -----------------------------------------------------------
    def _index(self, key: int, t: torch.Tensor, device) -> torch.Tensor:
        """Index tensor ``t`` on ``device``, copied there once."""
        hit = self._on_device.get((str(device), key))
        if hit is None:
            hit = self._on_device[(str(device), key)] = t.to(device)
        return hit

    def _scatter(self, group_outs: List[torch.Tensor]) -> torch.Tensor:
        """Per-group (G_i, B, ...) results -> (C, B, ...) in party order."""
        cat = torch.cat(group_outs, dim=0)
        if self._in_order:
            return cat
        return cat[self._index(-1, self._perm, cat.device)]

    def _gather(self, x_per_party: torch.Tensor, g: int) -> torch.Tensor:
        """(C, B, ...) -> group g's (G, B, ...) slab."""
        sel = self._sel[g]
        if isinstance(sel, torch.Tensor):
            sel = self._index(g, sel, x_per_party.device)
        return x_per_party[sel]

    def _group_outs(self, fn, part: str, params: Sequence[dict],
                    inputs: Sequence[Any]) -> List[torch.Tensor]:
        """``fn`` (embed_fn or decide_fn) over each group's ``part`` of the
        parameters: ``inputs[g]`` holds group g's inputs, a list or a
        (G, B, ...) tensor. Returns per-group (G, B, ...) outputs."""
        outs = []
        for ((arch, _), idx), x in zip(self.groups, inputs):
            if len(idx) == 1:
                outs.append(fn({part: params[idx[0]][part]}, arch, x[0])[None])
                continue
            sp = stack_trees([params[i][part] for i in idx])
            sx = x if isinstance(x, torch.Tensor) else torch.stack(x)
            outs.append(vmap(lambda p, e, a=arch: fn({part: p}, a, e))(
                sp, sx))
        return outs

    def _embed_groups(self, params, xs) -> List[torch.Tensor]:
        return self._group_outs(embed_fn, "embed", params,
                                [[xs[i] for i in idx] for _, idx in self.groups])

    # -- forward -----------------------------------------------------------
    def embed_all(self, params: Sequence[dict],
                  xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """E_k = h(theta_k, D_k) for all parties -> (C, B, d_embed)."""
        return self._scatter(self._embed_groups(params, xs))

    def decide_all(self, params: Sequence[dict],
                   E_per_party: torch.Tensor) -> torch.Tensor:
        """R_k = p(theta_k, E_for_k): (C, B, d) -> (C, B, n_classes)."""
        return self._scatter(self._group_outs(
            decide_fn, "decide", params,
            [self._gather(E_per_party, g) for g in range(self.n_groups)]))

    # -- grouping-aware optimizer updates ----------------------------------
    @torch.no_grad()
    def update_groups(self, opts: Sequence[Any], grads: Sequence[Any],
                      opt_state: Sequence[Any], params: Sequence[Any]
                      ) -> Tuple[List[Any], List[Any]]:
        """Per-party optimizer updates, one vmapped ``Optimizer.update``
        per (execution group, optimizer) subgroup.

        ``opts`` is per party; ``resolve_party_optimizers`` dedupes equal
        specs to one instance, so subgroups are by identity. The subgroup's
        parameter, gradient and state trees are stacked, updated by one
        ``vmap(opt.update)`` (which maps the leading axis, so each party
        still clips by its own global norm), and written back into every
        party's own tensors with one ``torch._foreach_copy_``: the updates
        stay in place, as the port's optimizers are. A subgroup of one
        party is updated in its own tensors directly. Returns
        ``(params, opt_state)``, the same per-party objects."""
        for _, idx in self.groups:
            for _, pos in group_by([id(opts[i]) for i in idx]):
                sub = [idx[j] for j in pos]
                opt = opts[sub[0]]
                if len(sub) == 1:
                    opt.update(grads[sub[0]], opt_state[sub[0]],
                               params[sub[0]])
                    continue
                trees = [[params[i] for i in sub], [opt_state[i] for i in sub]]
                sp, ss = (stack_trees(t) for t in trees)
                sg = stack_trees([grads[i] for i in sub])
                vmap(opt.update)(sg, ss, sp)
                for stacked, per_party in ((sp, trees[0]), (ss, trees[1])):
                    dst = [leaf for tree in per_party
                           for leaf in tree_leaves(tree)]
                    src = [leaf[j] for j in range(len(sub))
                           for leaf in tree_leaves(stacked)]
                    if dst:
                        torch._foreach_copy_(dst, src)
        return list(params), list(opt_state)

    # -- explicit-vjp protocol path (message-passing reference) ------------
    def embed_vjp(self, params: Sequence[dict], xs: Sequence[torch.Tensor]):
        """(E_all, pullback): pullback maps gE_all (C, B, d) -> per-party
        embedding-net gradient trees (list, party order)."""
        outs = self._embed_groups(params, xs)
        E_all = self._scatter(outs)

        def pull(gE_all: torch.Tensor) -> List[dict]:
            grads: List[Any] = [None] * self.C
            for g, ((_, idx), Eg) in enumerate(zip(self.groups, outs)):
                leaves = [leaf for i in idx
                          for leaf in tree_leaves(params[i]["embed"])]
                gl = torch.autograd.grad(Eg, leaves,
                                         grad_outputs=self._gather(gE_all, g),
                                         retain_graph=True)
                n = len(gl) // len(idx)
                for j, i in enumerate(idx):
                    grads[i] = tree_unflatten(params[i]["embed"],
                                          gl[j * n:(j + 1) * n])
            return grads

        return E_all.detach(), pull

    def decide_vjp(self, params: Sequence[dict], E_per_party: torch.Tensor):
        """(R_all, pullback): pullback maps gR_all (C, B, n_cls) ->
        (per-party decision-net gradient trees, gE_all (C, B, d))."""
        ins = [self._gather(E_per_party, g).detach().requires_grad_(True)
               for g in range(self.n_groups)]
        outs = self._group_outs(decide_fn, "decide", params, ins)

        def pull(gR_all: torch.Tensor):
            grads: List[Any] = [None] * self.C
            gEs = []
            for g, ((_, idx), Rg, se) in enumerate(zip(self.groups, outs,
                                                       ins)):
                leaves = [leaf for i in idx
                          for leaf in tree_leaves(params[i]["decide"])]
                *gl, gse = torch.autograd.grad(
                    Rg, leaves + [se], grad_outputs=self._gather(gR_all, g),
                    retain_graph=True)
                gEs.append(gse)
                n = len(gl) // len(idx)
                for j, i in enumerate(idx):
                    grads[i] = tree_unflatten(params[i]["decide"],
                                          gl[j * n:(j + 1) * n])
            return grads, self._scatter(gEs)

        return self._scatter(outs).detach(), pull
