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

Party-group mode (``group=``, a ``party_group.PartyGroup``): the
counterpart of the reference's mesh mode. Each rank runs only its own
rows of every execution group whose size divides over the group
(``PartyGroup.rows``; a group of another size runs replicated on every
rank, the reference's ``party_shardable`` rule, which ``_sharded``
reports), and holds only those parties' parameters: a party held on
another rank is an empty tree ``{}`` in the per-party lists. Two families
of steps, as in the reference:

  * raw steps (``embed_all``, ``decide_all``, ``embed_vjp``,
    ``decide_vjp``): own rows computed, then gathered to every rank
    (``party_group.gather_rows``), so their outputs are the single-process
    engine's;
  * the blinded round (``embed_blind_uplink`` /
    ``embed_blind_uplink_scaled``, ``aggregate_via_active``,
    ``decide_from``): a rank blinds its own rows in place, zeroes the
    active party's row, and the gather of that uplink is the only
    collective that carries embeddings; the active party's rank
    aggregates and broadcasts the global embedding (paper Alg. 1 line 6);
    each rank decides its own rows against its own raw embeddings, and
    only the predictions are gathered.

The int8 wire's round scale takes one ``all_reduce(MAX)`` of the ranks'
max |E| (a float max is exact, so it equals the single-process scale).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from repro_torch.core import blinding
from repro_torch.core import party_group as pg
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
                 n_features: Sequence[int],
                 group: Optional[pg.PartyGroup] = None):
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
        self.group = group
        # each execution group's members this rank runs: all of them on
        # one process or where the group runs replicated
        self._own = [tuple(idx[i] for i in self._rows(len(idx)))
                     for _, idx in self.groups]
        self._sel = [_selector(idx) for idx in self._own]
        self._on_device: Dict[Tuple[str, int], torch.Tensor] = {}

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def _sharded(self, n_group: int) -> bool:
        """True when a group of ``n_group`` parties lies over the party
        group (else it runs replicated)."""
        return pg.party_shardable(self.group, n_group)

    def _rows(self, n_group: int) -> range:
        return range(n_group) if self.group is None else \
            self.group.rows(n_group)

    def held(self) -> List[int]:
        """The parties whose parameters this rank holds, in party order."""
        return sorted(i for own in self._own for i in own)

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
        """(C, B, ...) -> this rank's rows of group g, (G_own, B, ...)."""
        sel = self._sel[g]
        if isinstance(sel, torch.Tensor):
            sel = self._index(g, sel, x_per_party.device)
        return x_per_party[sel]

    def _scatter_own(self, outs: List[torch.Tensor]) -> torch.Tensor:
        """Per-group own-row results -> (C, ...) in party order, zero in
        the rows that other ranks hold."""
        if all(len(o) == len(idx) for o, (_, idx) in zip(outs, self.groups)):
            return self._scatter(outs)
        full = outs[0].new_zeros((self.C,) + tuple(outs[0].shape[1:]))
        for o, idx in zip(outs, self._own):
            full[list(idx)] = o
        return full

    def _shared(self, outs: List[torch.Tensor]) -> List[torch.Tensor]:
        """Per-group own-row outputs -> every row, on every rank: the
        sharded groups' rows gathered over the party group."""
        return [pg.gather_rows(o, self.group)
                if self._sharded(len(idx)) else o
                for o, (_, idx) in zip(outs, self.groups)]

    def _entered(self, E: torch.Tensor, g: int) -> torch.Tensor:
        """A replicated input of group g's own-row work: where the group
        is sharded and E carries a gradient, the ranks' partial
        cotangents are summed in the backward (``pg.enter_shard``)."""
        if self._sharded(len(self.groups[g][1])) and E.requires_grad:
            return pg.enter_shard(E, self.group)
        return E

    def _group_outs(self, fn, part: str, params: Sequence[dict],
                    inputs: Sequence[Any]) -> List[torch.Tensor]:
        """``fn`` (embed_fn or decide_fn) over each group's ``part`` of the
        parameters, this rank's rows: ``inputs[g]`` holds those rows'
        inputs, a list or a (G_own, B, ...) tensor. Returns per-group
        (G_own, B, ...) outputs."""
        outs = []
        for ((arch, _), every), idx, x in zip(self.groups, self._own, inputs):
            # a sharded group's rows run as one vmap even where this rank
            # has one of them, as every rank's share does
            if len(idx) == 1 and not self._sharded(len(every)):
                outs.append(fn({part: params[idx[0]][part]}, arch, x[0])[None])
                continue
            sp = stack_trees([params[i][part] for i in idx])
            sx = x if isinstance(x, torch.Tensor) else torch.stack(x)
            outs.append(vmap(lambda p, e, a=arch: fn({part: p}, a, e))(
                sp, sx))
        return outs

    def _embed_groups(self, params, xs) -> List[torch.Tensor]:
        return self._group_outs(embed_fn, "embed", params,
                                [[xs[i] for i in idx] for idx in self._own])

    # -- forward -----------------------------------------------------------
    def embed_all(self, params: Sequence[dict],
                  xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """E_k = h(theta_k, D_k) for all parties -> (C, B, d_embed)."""
        return self._scatter(self._shared(self._embed_groups(params, xs)))

    def decide_all(self, params: Sequence[dict],
                   E_per_party: torch.Tensor) -> torch.Tensor:
        """R_k = p(theta_k, E_for_k): (C, B, d) -> (C, B, n_classes)."""
        return self._scatter(self._shared(self._group_outs(
            decide_fn, "decide", params,
            [self._gather(self._entered(E_per_party, g), g)
             for g in range(self.n_groups)])))

    # -- blinded round (party-group mode) ------------------------------------
    def _own_masks(self, g: int, masks: Optional[torch.Tensor]):
        """Group g's own rows of the masks, party order, a zero row for the
        active party (it sends nothing). ``masks`` holds this rank's
        passive parties' rows in ``passive_held`` order."""
        if masks is None:
            return None
        pos = {k: i for i, k in enumerate(self.passive_held())}
        zero = torch.zeros(masks.shape[1:], dtype=masks.dtype,
                           device=masks.device)
        return torch.stack([masks[pos[k]] if k else zero
                            for k in self._own[g]])

    def passive_held(self) -> List[int]:
        """The passive parties this rank runs, in party order: the row
        order of the masks the blinded round takes (``MaskEngine.masks
        (rows=[k - 1 for k in passive_held()])``)."""
        return [k for k in self.held() if k]

    def _uplink(self, g: int, up: torch.Tensor) -> torch.Tensor:
        """Group g's own-row uplink with the active party's row zeroed (it
        is the receiver and sends nothing)."""
        own = self._own[g]
        if 0 in own:
            keep = torch.tensor([k != 0 for k in own], device=up.device)
            up = torch.where(keep.reshape((-1,) + (1,) * (up.dim() - 1)),
                             up, torch.zeros((), dtype=up.dtype,
                                             device=up.device))
        return up

    def embed_blind_uplink(self, params: Sequence[dict],
                           xs: Sequence[torch.Tensor],
                           masks: Optional[torch.Tensor],
                           mask_mode: str = "float"):
        """Stage 1 of the blinded round: embed and blind this rank's rows.

        ``masks``: this rank's passive rows (``passive_held`` order), or
        None (unblinded: the uplink is the raw embedding, the caller's
        explicit choice, with the active row kept). Returns ``(E_parts,
        uplink)``: per-group own-row embeddings, which stay on this rank,
        and the (C, B, d) party-order stack of what crossed the party
        group: [E_k] = E_k + r_k (float), quantize(E_k) + r_k (int32), and
        a zero row for the active party."""
        E_parts = self._embed_groups(params, xs)
        ups = []
        for g, E in enumerate(E_parts):
            m = self._own_masks(g, masks)
            up = blinding.blind_uplink(E, m, mask_mode)
            ups.append(up if m is None else self._uplink(g, up))
        return E_parts, self._scatter(self._shared(ups))

    def embed_blind_uplink_scaled(self, params: Sequence[dict],
                                  xs: Sequence[torch.Tensor],
                                  masks: torch.Tensor,
                                  mask_mode: str = "int8"):
        """The int8 twin of ``embed_blind_uplink``: the round's scale needs
        max |E| over every party, so the ranks first agree on it with one
        ``all_reduce(MAX)`` of their own rows' max (a scalar), then blind
        under it. Returns ``(E_parts, uplink, scale)``."""
        if masks is None or mask_mode != "int8":
            raise ValueError("the scaled uplink is the masked int8 wire")
        E_parts = self._embed_groups(params, xs)
        amax = torch.max(torch.stack([torch.max(torch.abs(E.detach()))
                                      for E in E_parts]))
        if self.group is not None:
            amax = self.group.all_reduce(amax.float().contiguous(), "max")
        scale = blinding.ring_scale(amax, self.C, mask_mode)
        ups = [self._uplink(g, blinding.blind_uplink(
                   E, self._own_masks(g, masks), mask_mode, scale))
               for g, E in enumerate(E_parts)]
        return E_parts, self._scatter(self._shared(ups)), scale

    def aggregate_via_active(self, E_parts: List[torch.Tensor],
                             uplink: torch.Tensor, agg_fn: Callable,
                             dtype=torch.float32) -> torch.Tensor:
        """Paper Alg. 1 line 6: the active party aggregates, ``agg_fn(
        uplink, E_a)`` (``dtype`` the result's), on its rank alone and
        broadcasts the global embedding E, wire every party receives. Party
        0 is the first member of the first group, so it is row 0 of rank
        0's rows; its raw embedding never leaves that rank. A replicated
        first group aggregates on every rank, with no collective."""
        if not self._sharded(len(self.groups[0][1])):
            return agg_fn(uplink, E_parts[0][0])
        own = (E_parts[0][0],) if self.group.rank == 0 else ()
        return pg.reduce_on_rank(agg_fn, self.group, 0, uplink.shape[1:],
                                   dtype, uplink, *own)

    def decide_from(self, params: Sequence[dict],
                    E_parts: List[torch.Tensor], E_global: torch.Tensor,
                    view_fn: Callable) -> torch.Tensor:
        """Stage 2: each rank decides its own rows on the party view
        ``view_fn(E_global, E_loc)`` (the caller's stop-gradient
        surrogate), so a party's raw embedding is read only where it was
        made; the predictions are gathered. Returns (C, B, n_classes) on
        every rank, party order."""
        views = [view_fn(self._entered(E_global, g), E)
                 for g, E in enumerate(E_parts)]
        return self._scatter(self._shared(self._group_outs(
            decide_fn, "decide", params, views)))

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
        for idx in self._own:
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
        E_all = self._scatter(self._shared(outs))

        def pull(gE_all: torch.Tensor) -> List[dict]:
            grads: List[Any] = [{}] * self.C
            for g, (idx, Eg) in enumerate(zip(self._own, outs)):
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
            grads: List[Any] = [{}] * self.C
            gEs = []
            for g, (idx, Rg, se) in enumerate(zip(self._own, outs, ins)):
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
            return grads, self._scatter_own(gEs)

        return self._scatter(self._shared(outs)).detach(), pull
