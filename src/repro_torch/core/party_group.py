"""The party group as the engines see it: the port's counterpart of the
reference's 1-D ``"party"`` mesh axis (``repro.launch.mesh``) and of
``repro.sharding``'s ``party_axis_size`` / ``party_shardable``.

The reference lays the EASTER party dimension over a mesh axis and runs
the sharded engine under ``shard_map``. The port runs one process per
rank of a ``torch.distributed`` group instead: each rank holds its own
rows of every party group (``PartyGroup.rows``), and the collectives
below carry what the reference's ``all_gather`` / ``psum`` / ``pmax``
carry. ``launch/mesh.py`` starts the group and makes a ``PartyGroup``.

Every byte that crosses ranks goes through ``PartyGroup.all_gather``,
``all_reduce``, ``broadcast`` or ``gather_object`` (a test can wrap them
to record the payloads). The differentiable forms keep one invariant:
every rank runs the same replicated program around its own rows, so the
cotangent of a replicated tensor is whole on every rank. With
``group=None`` (one process holding every row) each is the identity, so
an engine runs one code path with or without a group.

  * ``gather_rows``: own rows -> the tiled stack on every rank; backward
    returns the rank's own rows of the cotangent (no traffic).
  * ``enter_shard``: a replicated tensor read by rank-local work (each
    rank's own decisions); backward sums the ranks' partial cotangents.
  * ``from_rank``: a value only rank ``src`` holds -> every rank; backward
    gives ``src`` the whole cotangent (no traffic).
  * ``reduce_on_rank``: ``fn(shared, *own)`` evaluated on rank ``src``
    only (the active party's aggregation), the result broadcast; backward
    differentiates ``fn`` on ``src`` and broadcasts the cotangent of the
    replicated ``shared`` input.

The two whose backward moves data (``enter_shard``, ``reduce_on_rank``)
sit in every rank's graph at the same place, so every rank runs their
backward collectives in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist


@dataclass
class PartyGroup:
    """This rank's view of the party group: its rank and the group's size,
    the ``torch.distributed`` group (None = the default group), this
    rank's device and the backend."""
    rank: int
    size: int
    pg: Any
    device: torch.device
    backend: str

    def rows(self, n: int) -> range:
        """This rank's rows of a party-stacked axis of ``n``: a contiguous
        n / size block where ``party_shardable``, else all n (the group
        runs replicated)."""
        if not party_shardable(self, n):
            return range(n)
        m = n // self.size
        return range(self.rank * m, (self.rank + 1) * m)

    # -- the wire: every cross-rank byte goes through these ----------------
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (same shape), concatenated along dim 0 in rank
        order (the reference's tiled ``all_gather``)."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.pg)
        return torch.cat(parts, dim=0)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``x`` reduced over the ranks ("sum" or "max"), in place."""
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
        dist.all_reduce(x, op=ops[op], group=self.pg)
        return x

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, in place."""
        dist.broadcast(x, src, group=self.pg)
        return x

    def warm(self) -> None:
        """One small all-reduce over the group, by every rank of it: an
        NCCL communicator is built at its group's first collective."""
        self.all_reduce(torch.zeros(1, device=self.device))

    def gather_object(self, obj, dst: int = 0) -> Optional[List[Any]]:
        """Every rank's picklable ``obj`` on rank ``dst`` (None elsewhere):
        pickles, on the host, so over gloo (``launch/mesh.py``'s NCCL
        group carries host operands over gloo)."""
        out = [None] * self.size if self.rank == dst else None
        dist.gather_object(obj, out, dst=dst, group=self.pg)
        return out


def party_axis_size(group: Optional[PartyGroup]) -> int:
    return 1 if group is None else group.size


def party_shardable(group: Optional[PartyGroup], n: int) -> bool:
    """True when a party-stacked leading dim of ``n`` can lie over the
    group (more than one rank and n divides evenly); a group of another
    size runs replicated on every rank, the reference's rule."""
    size = party_axis_size(group)
    return size > 1 and n >= size and n % size == 0


# ---------------------------------------------------------------------------
# the differentiable collectives (the identity without a group)
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.n = group, x.shape[0]
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g[r * n:(r + 1) * n], None


def gather_rows(x: torch.Tensor, group: Optional[PartyGroup]) -> torch.Tensor:
    """This rank's rows ``x`` (n, ...) -> every rank's (size * n, ...), on
    every rank. Its consumers must run on every rank alike."""
    return x if group is None else _GatherRows.apply(x, group)


class _EnterShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone(), "sum"), None


def enter_shard(x: torch.Tensor, group: Optional[PartyGroup]) -> torch.Tensor:
    """``x`` (replicated) as read by rank-local work: the identity, whose
    backward sums the ranks' cotangents. Every rank must call it."""
    return x if group is None else _EnterShard.apply(x, group)


class _FromRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src, shape, dtype):
        ctx.src = group.rank == src
        buf = (x.detach().contiguous().clone() if ctx.src else
               torch.empty(shape, dtype=dtype, device=group.device))
        return group.broadcast(buf, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.src else None), None, None, None, None


def from_rank(x: Optional[torch.Tensor], group: Optional[PartyGroup],
              src: int, shape, dtype) -> torch.Tensor:
    """Rank ``src``'s ``x`` (other ranks pass None) on every rank."""
    if group is None:
        return x
    return _FromRank.apply(x, group, src, tuple(shape), dtype)


class _ReduceOnRank(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, src, fn, shape, dtype, shared, *own):
        ctx.group, ctx.src, ctx.shared_shape = group, src, shared.shape
        ctx.n_own = len(own)
        if group.rank == src:
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(t.requires_grad)
                       for t in (shared,) + own]
                out = fn(*ins)
            ctx.graph = (out, ins)
            buf = out.detach().contiguous().clone()
        else:
            buf = torch.empty(shape, dtype=dtype, device=group.device)
        return group.broadcast(buf, src)

    @staticmethod
    def backward(ctx, g):
        group, src = ctx.group, ctx.src
        grads = [None] * (1 + ctx.n_own)
        if group.rank == src:
            out, ins = ctx.graph
            want = [i for i, t in enumerate(ins) if t.requires_grad]
            got = torch.autograd.grad(out, [ins[i] for i in want], g,
                                      allow_unused=True,
                                      materialize_grads=True)
            for i, gi in zip(want, got):
                grads[i] = gi
            del ctx.graph
        if ctx.needs_input_grad[5]:
            gs = grads[0]
            if gs is None:
                gs = torch.empty(ctx.shared_shape, dtype=g.dtype,
                                 device=group.device)
            grads[0] = group.broadcast(gs.contiguous(), src)
        return (None, None, None, None, None) + tuple(grads)


def reduce_on_rank(fn: Callable, group: Optional[PartyGroup], src: int,
                   shape, dtype, shared: torch.Tensor,
                   *own: torch.Tensor) -> torch.Tensor:
    """``fn(shared, *own)`` (shape ``shape``, ``dtype``) computed on rank
    ``src`` alone and broadcast. ``shared`` is replicated (every rank
    passes it); ``own`` are tensors only ``src`` holds (other ranks pass
    nothing). The result carries a gradient where ``shared`` does, which
    is the same on every rank; ``own`` then gets its gradient through
    ``fn`` too."""
    if group is None:
        return fn(shared, *own)
    if not shared.requires_grad:
        own = tuple(t.detach() for t in own)
    return _ReduceOnRank.apply(group, src, fn, tuple(shape), dtype, shared,
                               *own)


# ---------------------------------------------------------------------------
# rank-held trees
# ---------------------------------------------------------------------------


def gather_tree(group: Optional[PartyGroup], tree):
    """A tree whose parts this rank does not hold are ``{}`` (the sharded
    engine's parties, their caches and optimizer state) -> the whole tree
    on rank 0, None on the others: every ``{}`` filled from the first rank
    that holds that part; a leaf every rank holds is taken from rank 0.
    Tensors come back as numpy arrays (``checkpoint``'s format); numpy
    leaves pass as they are."""
    from repro_torch import checkpoint
    from repro_torch.tree import tree_map
    tree = tree_map(lambda t: checkpoint.params_to_numpy(t)
                    if isinstance(t, torch.Tensor) else t, tree)
    if group is None:
        return tree
    got = group.gather_object(tree, 0)
    return None if got is None else _merge(got)


def _merge(trees):
    held = [t for t in trees if not (isinstance(t, dict) and not t)]
    if not held:
        return {}
    first = held[0]
    if isinstance(first, dict):
        return {k: _merge([t[k] for t in held]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_merge([t[i] for t in held])
                           for i in range(len(first)))
    return first
