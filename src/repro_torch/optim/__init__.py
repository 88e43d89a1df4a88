"""Optimizers over parameter trees (paper §IV-E: SGD, momentum, Adagrad,
Adam), the PyTorch counterpart of ``repro.optim``.

Two layers:

  * ``make_optimizer(name, lr, ...)`` — ONE optimizer over a whole tree
    (global-norm clipping spans the full tree).
  * ``make_party_optimizers({party: (name, lr, hparams)}, C)`` — the
    paper's heterogeneous-optimization setting: party k's subtree is
    updated by party k's own optimizer (per-party clipping by
    construction).

Arithmetic and dtype casts follow the reference step for step. Unlike the
reference's pure functions, ``update(grads, state, params)`` updates the
parameter and state tensors IN PLACE (under ``torch.no_grad()``), leaf by
leaf, and returns the same trees, so a training step allocates no second
copy of the model or of the optimizer state (at most one leaf's worth).

Under a sharding plan (``repro_torch.sharding.ambient_mesh`` with the
step's parameter and optimizer-state specs) ``update`` runs on this rank's
blocks (``_sharded_update``, ZeRO-1): where a state block is finer than
its parameter's (a parameter replicated over the data axes, its state
sharded over them, ``opt_state_specs(zero1=True)``) the rank updates its
slice of the parameter and then all-gathers it over those axes; the
clipping norm counts every element once (a leaf replicated over an axis
only from that axis' coordinate 0) and sums over every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]                    # params -> state
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]  # (g, state, p) -> (p, state), in place
    name: str


def _tree_zeros(params, dtype=None):
    return tree_map(lambda p: torch.zeros_like(p, dtype=dtype or p.dtype,
                                               requires_grad=False), params)


def global_norm(tree, norm_reduce=None, weights=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf. ``norm_reduce`` sums the
    squares over the ranks that hold the rest of the tree (the sharded
    engine's parties); ``weights`` (one 0/1 a leaf) drops the leaves this
    rank does not count."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    if weights is not None:
        leaves = [x * w for x, w in zip(leaves, weights)]
    sq = torch.sum(torch.stack(leaves))
    if norm_reduce is not None:
        sq = norm_reduce(sq)
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float, norm_reduce=None,
                        weights=None):
    n = global_norm(grads, norm_reduce, weights)
    scale = torch.clamp(max_norm / (n + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), n


def _assign(fn, dst_tree, *trees) -> None:
    """dst <- fn(*leaves), leaf by leaf, in place."""
    for d, *xs in zip(tree_leaves(dst_tree), *map(tree_leaves, trees)):
        d.copy_(fn(*xs))


def make_optimizer(name: str, lr: float, *, momentum: float = 0.9,
                   b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                   weight_decay: float = 0.0,
                   grad_clip: float = 0.0,
                   state_dtype=torch.float32, norm_reduce=None) -> Optimizer:
    """``norm_reduce``: for a tree whose leaves lie over ranks, the sum of
    the clipping norm's squares over the ranks (``global_norm``)."""
    name = name.lower()

    def maybe_clip(grads):
        if grad_clip > 0:
            grads, _ = clip_by_global_norm(grads, grad_clip, norm_reduce)
        return grads

    def apply_wd(g, p):
        if weight_decay:
            return g + weight_decay * p.to(g.dtype)
        return g

    if name == "sgd":
        def init(params):
            return {}

        def step(grads, state, params):
            _assign(lambda p, g: (p.float() - lr * apply_wd(g.float(), p)
                                  ).to(p.dtype), params, params, grads)

    elif name in ("momentum", "sgdm"):
        def init(params):
            return {"m": _tree_zeros(params, state_dtype)}

        def step(grads, state, params):
            _assign(lambda m, g: momentum * m + g.to(state_dtype),
                    state["m"], state["m"], grads)
            _assign(lambda p, mm: (p.float() - lr * apply_wd(mm, p)
                                   ).to(p.dtype), params, params, state["m"])

    elif name == "adagrad":
        def init(params):
            return {"s": _tree_zeros(params, state_dtype)}

        def step(grads, state, params):
            _assign(lambda s, g: s + torch.square(g.to(state_dtype)),
                    state["s"], state["s"], grads)
            _assign(lambda p, g, ss: (p.float() - lr * apply_wd(g.float(), p)
                                      / (torch.sqrt(ss) + eps)).to(p.dtype),
                    params, params, grads, state["s"])

    elif name == "adam":
        def init(params):
            device = tree_leaves(params)[0].device
            return {"m": _tree_zeros(params, state_dtype),
                    "v": _tree_zeros(params, state_dtype),
                    "t": torch.zeros((), dtype=torch.int32, device=device)}

        def step(grads, state, params):
            state["t"] += 1
            t = state["t"].float()
            _assign(lambda m, g: b1 * m + (1 - b1) * g.to(state_dtype),
                    state["m"], state["m"], grads)
            _assign(lambda v, g: b2 * v + (1 - b2) * torch.square(
                g.to(state_dtype)), state["v"], state["v"], grads)
            bc1 = 1 - torch.pow(b1, t)
            bc2 = 1 - torch.pow(b2, t)

            def upd(p, mm, vv):
                delta = lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps)
                if weight_decay:
                    delta = delta + lr * weight_decay * p.to(state_dtype)
                return (p.float() - delta).to(p.dtype)

            _assign(upd, params, params, state["m"], state["v"])

    else:
        raise ValueError(f"unknown optimizer {name!r}")

    @torch.no_grad()
    def update(grads, state, params):
        from repro_torch import sharding
        plan = sharding.current()
        if plan is not None and plan.params is not None:
            _sharded_update(step, grad_clip, plan, grads, state, params)
            return params, state
        step(maybe_clip(grads), state, params)
        return params, state

    return Optimizer(init=init, update=update, name=name)


def _sharded_update(step, grad_clip: float, plan, grads, state, params):
    """ZeRO-1: ``step`` on this rank's blocks (module docstring). The
    gradients arrive reduced over the batch axes (``sharding.materialize``'s
    backward), in their parameters' blocks."""
    from repro_torch import sharding
    mesh = plan.mesh
    pspecs = sharding.spec_leaves({"parties": plan.params["parties"]})
    sspecs = pspecs
    for k in ("m", "v", "s"):
        if plan.opt and k in plan.opt:
            sspecs = sharding.spec_leaves(plan.opt[k])
            break
    gs, ps = tree_leaves(grads), tree_leaves(params)
    g_views, p_views, weights, widen = [], [], [], []
    for g, p, psp, ssp in zip(gs, ps, pspecs, sspecs):
        pe = sharding._entries(psp, p.dim())
        se = sharding._entries(ssp, p.dim())
        for i, (a, b) in enumerate(zip(pe, se)):
            if a == b:
                continue
            if a is not None:
                raise ValueError(f"a state block ({ssp}) coarser than its "
                                 f"parameter's ({psp})")
            g = sharding._block(g, b, i, mesh)
            narrowed = sharding._block(p, b, i, mesh)
            widen.append((p, narrowed, b, i))
            p = narrowed
        used = {a for e in se for a in sharding._axes(e)}
        weights.append(float(all(mesh.coords[a] == 0
                                 for a in mesh.axis_names if a not in used)))
        g_views.append(g)
        p_views.append(p)
    if grad_clip > 0:
        g_views, _ = clip_by_global_norm(
            g_views, grad_clip,
            lambda sq: mesh.all_reduce(sq.reshape(1), mesh.axis_names)[0],
            weights)
    step(tree_unflatten(grads, g_views), state,
         tree_unflatten(params, p_views))
    for p, narrowed, b, i in widen:
        p.copy_(mesh.all_gather(narrowed, sharding._axes(b), i))


# ---------------------------------------------------------------------------
# heterogeneous per-party optimization (paper §IV-E)
# ---------------------------------------------------------------------------

OPTIMIZER_NAMES = ("sgd", "momentum", "adagrad", "adam")

# party k's optimizer spec: a prebuilt Optimizer, "name", (name, lr) or
# (name, lr, {hparam: value})
PartySpec = Union[Optimizer, str, Tuple]


class PartyOptimizer(NamedTuple):
    """Partitioned optimizer: party k's param subtree gets ``opts[k]``.
    Duck-type compatible with ``Optimizer``; the state is one tree shaped
    like the param container."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    name: str
    opts: Tuple[Optimizer, ...]          # per-party, instances deduped


def split_parties(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(per-party subtrees, rebuild) for the two param containers:
    ``{"parties": [...]}`` and ``EasterClassifier``'s per-party list."""
    if isinstance(tree, dict) and "parties" in tree:
        return list(tree["parties"]), lambda lst: dict(tree, parties=lst)
    if isinstance(tree, (list, tuple)):
        t = type(tree)
        return list(tree), lambda lst: t(lst)
    raise TypeError(
        f"params must be {{'parties': [...]}} or a per-party list, got "
        f"{type(tree).__name__}")


def parse_party_spec(text: str) -> Dict[int, Tuple[str, float, Dict]]:
    """CLI spec -> ``{party: (name, lr, hparams)}``.

    Format: ``k=name:lr[:hparam=value...]`` items, comma-separated, e.g.
    ``0=sgd:0.01,1=adagrad:0.005,2=momentum:0.01:momentum=0.8``.
    """
    out: Dict[int, Tuple[str, float, Dict]] = {}
    for item in text.split(","):
        item = item.strip()
        if not item:
            continue
        party, sep, rest = item.partition("=")
        if not sep or not party.strip().lstrip("-").isdigit():
            raise ValueError(f"bad party-optimizer item {item!r} "
                             f"(want k=name:lr[:h=v...])")
        parts = rest.split(":")
        name = parts[0].strip().lower()
        if name not in OPTIMIZER_NAMES:
            raise ValueError(f"unknown optimizer {name!r} in {item!r} "
                             f"(one of {OPTIMIZER_NAMES})")
        if len(parts) < 2:
            # the caller's default lr applies only to UNLISTED parties
            raise ValueError(f"missing lr in {item!r} "
                             f"(want k=name:lr[:h=v...])")
        lr = float(parts[1])
        hp: Dict[str, float] = {}
        for frag in parts[2:]:
            hk, hsep, hv = frag.partition("=")
            if not hsep:
                raise ValueError(f"bad hparam {frag!r} in {item!r}")
            hp[hk.strip()] = float(hv)
        k = int(party)
        if k in out:
            raise ValueError(f"party {k} specified twice")
        out[k] = (name, lr, hp)
    return out


def resolve_party_optimizers(specs, C: int, *,
                             default: Tuple = ("adam", 1e-3, None)
                             ) -> List[Optimizer]:
    """Normalize ``specs`` to C ``Optimizer``s, one per party.

    ``specs``: ``{party: PartySpec}`` (missing parties get ``default``)
    or a length-C sequence (None entries get ``default``). Identical
    ``(name, lr, hparams)`` specs resolve to the SAME instance.
    """
    if isinstance(specs, dict):
        bad = [k for k in specs if not 0 <= int(k) < C]
        if bad:
            raise ValueError(f"party indices {bad} out of range [0, {C})")
        table = {int(k): v for k, v in specs.items()}
    else:
        if len(specs) != C:
            raise ValueError(f"need {C} specs, got {len(specs)}")
        table = dict(enumerate(specs))
    cache: Dict[Tuple, Optimizer] = {}

    def build(spec) -> Optimizer:
        if spec is None:
            spec = default
        if callable(getattr(spec, "update", None)):
            return spec
        if isinstance(spec, str):
            spec = (spec, default[1], None)
        name, lr = spec[0], float(spec[1])
        hp = dict(spec[2]) if len(spec) > 2 and spec[2] else {}
        key = (name.lower(), lr, tuple(sorted(hp.items())))
        if key not in cache:
            cache[key] = make_optimizer(name, lr, **hp)
        return cache[key]

    return [build(table.get(k)) for k in range(C)]


def make_party_optimizers(specs, C: int, *,
                          default: Tuple = ("adam", 1e-3, None)
                          ) -> PartyOptimizer:
    """Heterogeneous per-party optimization as ONE ``Optimizer``-shaped
    object: ``init`` maps party k's subtree through ``opts[k].init`` and
    keeps the container; ``update`` applies each party's own optimizer to
    its own gradient subtree, in place."""
    opts = tuple(resolve_party_optimizers(specs, C, default=default))

    def init(params):
        parties, rebuild = split_parties(params)
        if len(parties) != C:
            raise ValueError(f"params hold {len(parties)} parties, "
                             f"optimizer built for {C}")
        # a party another rank holds (the sharded engine's {}) has no state
        return rebuild([opts[k].init(p) if tree_leaves(p) else {}
                        for k, p in enumerate(parties)])

    def update(grads, state, params):
        gs, _ = split_parties(grads)
        ss, _ = split_parties(state)
        ps, rebuild = split_parties(params)
        new_p, new_s = [], []
        for k in range(C):
            if not tree_leaves(ps[k]):
                new_p.append(ps[k])
                new_s.append(ss[k])
                continue
            p, s = opts[k].update(gs[k], ss[k], ps[k])
            new_p.append(p)
            new_s.append(s)
        return rebuild(new_p), rebuild(new_s)

    name = "party(" + ",".join(o.name for o in opts) + ")"
    return PartyOptimizer(init=init, update=update, name=name, opts=opts)
