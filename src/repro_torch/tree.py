"""Minimal pytree helpers for the port's parameter trees: nested dicts,
lists and tuples with tensors (or arrays) at the leaves, in the same
layout as the reference's JAX pytrees."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_leaves(tree) -> List[Any]:
    """Leaves in the reference's order: dict keys sorted, sequences in
    order (``jax.tree.leaves`` sorts dict keys the same way)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def empty_stack(tree, n: int):
    """Uninitialized (n, ...) leaves shaped like ``tree``'s."""
    return tree_map(lambda a: a.new_empty((n,) + tuple(a.shape)), tree)


def stack_drawn(draw: Callable[[int], Any], n: int,
                empty: Callable[[Any, int], Any] = empty_stack):
    """The trees ``draw(0), ..., draw(n - 1)``, drawn in that order,
    stacked along a new leading axis: each is copied into its row of
    preallocated leaves (``empty(first tree, n)``, (n, ...) each) and
    dropped before the next is drawn, so at most one drawn tree lives
    beside the stack (``torch.stack`` over a list of them holds every
    tree and the stack at once)."""
    out = None
    for i in range(n):
        tree = draw(i)
        if out is None:
            out = empty(tree, n)
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
        del tree
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` from ``leaves`` in ``tree_leaves``
    order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(like)
