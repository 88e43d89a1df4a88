"""The FSDP plan over the ranks of a ``torch.distributed`` group: the
port's counterpart of ``repro.sharding``.

Two halves.

**The rules** (``param_specs``, ``cache_specs``, ``batch_specs``,
``opt_state_specs`` with ZeRO-1) are the reference's, line for line: each
leaf of a tree gets a spec, a ``P`` with one entry per leading dim (None,
an axis name, or a tuple of names), decided from its path's trailing
names and its shape. ``tuple(P)`` equals ``tuple(PartitionSpec)`` of the
reference for the same leaf (a tuple of one name is that name, as jax
writes it). A mesh, for the rules, is only ``axis_names`` and ``shape``
(a dict name -> size), so they run alike against an abstract 16 x 16
mesh (``launch.mesh.abstract_mesh``) and a live 2 x 2 group
(``launch.mesh.make_debug_mesh``). The port's EasterLM tree also holds
``passive_stacked``, the K passive parties stacked (K, ...): its spec is
party 1's spec with None in front for the party axis, never ``_add_fsdp``
applied to the stacked shape (which could pick the party axis), so a
stacked block's rows are the parties' own blocks.

**The executor.** The reference declares the layout and lets GSPMD choose
the compute. The port chooses both:

  * every leaf (parameters, optimizer state, caches, batch rows) is stored
    as its spec says: each rank holds its block only (``shard_tree``);
  * a layer's leaves are materialised just before the layer runs
    (``materialize``, an ``autograd.Function``): all-gathered over the
    axes of each sharded dim, or, where the layer axis itself is sharded,
    broadcast from the rank that holds the layer. Its backward sums the
    cotangents over the axes the batch is split on (``batch_axes``; a
    reduce-scatter, or an all-reduce where the leaf is replicated there)
    and, over every other axis, returns the rank's own block of the
    cotangent with no traffic, because compute is replicated there (or,
    for a leaf kept as its "model" block, computed on that block alone):
    the invariant of ``core/party_group.gather_rows`` / ``enter_shard``;
  * compute splits over the batch axes, and under ``layout="tp"`` also
    over "model" where the block allows (``stack_tp``; a mesh whose model
    axis has one rank computes as before). Under ``layout="zero3"`` the
    batch axes are all the axes: pure FSDP, nothing computed twice.

Tensor-parallel compute under ``"tp"`` (Megatron's, with its
sequence-parallel stream; the operators ``copy_to_model``,
``reduce_from_model``, ``gather_seq``, ``scatter_seq``, ``split_seq``,
``join_seq``, ``gather_cols`` and ``model_sum`` are ``_ModelComm``, legal
under ``torch.func.vmap``):

  * the dense attention (``models/layers.self_attention``): q/k/v by
    columns on the rank's heads, wo by rows. Where the heads divide the
    model axis each rank takes its q and kv heads; where ``Hkv < m`` and
    ``m % Hkv == 0`` it takes its q heads and computes every kv head
    (its columns of ``wk`` / ``wv``, the products all-gathered: the
    cache holds them all) but attends with the one its heads read;
    otherwise the column split would cut inside a head, and the layer
    runs whole on every rank from its gathered leaves (``Plan.tp_blocks``
    counts each choice). A K/V cache block always keeps its "model"
    entry: heads, or T where the heads do not divide, whose decode
    merges each rank's partial softmax over its T block (a max and a
    sum all-reduce; every head's where the attention runs whole), so no
    cache is gathered;
  * an encoder-decoder's encoder (``models/transformer.encode``) is a
    stack of its own over the F frames (``stack_tp(cfg, F)``: its stream
    sequence-parallel where F divides the axis, its attention and MLP
    split as the decoder's); where the attention splits by heads
    (``cross_tp``) the cross K/V (``_encoder_kv``: each layer's from the
    rank's columns of ``wk`` / ``wv``) and the cross-attention
    (``_apply_xattn``: q by ``wq``'s columns, ``wo`` by rows) are the
    rank's heads, and a step's ``enc_kv`` holds them (``EasterLM
    .encoder_kv``; a whole one is cut by ``EasterLM._local_fe``);
  * the dense MLP (``layers.mlp``) and EASTER's decision MLPs: up / gate
    by columns, down by rows;
  * the MoE FFN (``models/moe.moe_ffn``, ``TP.moe``): by expert where the
    experts divide the model axis ("experts"), else every expert on the
    rank's ff columns with ``w_down`` by rows ("ff"); the shared experts
    as a split MLP. Each rank routes the stream as it lies (the router
    replicated), the gates and expert indices made whole as the stream
    is, dispatches the tokens of its data rows into its own experts'
    slots only, and adds its partial output; one ``exit`` sums the
    ranks'. No all-to-all: the dense MLP's operators, whose sizes do not
    depend on the routing, so the passive proxies' ``vmap`` holds;
  * the Mamba-2 mixer (``models/ssm.ssm_block``, ``TP.ssd``): the packed
    ``in_proj``, the conv and the SiLU replicated, the SSD, its ``D``
    skip and ``z`` gate on the rank's heads, the gated norm's mean square
    summed over "model" (``model_sum``), ``out_proj`` by rows;
  * the RG-LRU mixer (``models/griffin.recurrent_block``, ``TP.lru``):
    ``in_x`` / ``in_gate`` by columns, the conv on the rank's channels,
    its output all-gathered (``gather_cols``) for the (W, W) gate
    products, ``w_r`` / ``w_i`` by columns, ``lam`` and the scan at the
    rank's width, ``out`` by rows;
  * a replicated leaf that feeds a rank's block (the router and
    ``shared_gate`` on an S block, ``in_proj``, the convs' taps, the
    gated norm's scale) passes ``copy_to_model`` (``TP.rep`` /
    ``TP.partial``), so that its cotangent is summed over "model" once;
  * a cache block keeps the "model" entry of what the rank computes on
    (``TP.keeps_cache``): the K/V heads (or T), the SSD ``state`` by
    heads, the LRU ``conv`` and ``state`` by width. The SSD ``conv``
    cache is stored over its packed ``[x | B | C]`` channels, which do
    not align with a rank's heads: ``cache_in`` gathers it (every rank
    computes the whole conv) and ``cache_out`` keeps the rank's block;
  * the residual stream between a party's layers is this rank's S block
    where S divides the model axis (norms on the block, ``gather_seq``
    before the column products, ``scatter_seq`` after the row products),
    else whole (``copy_to_model`` / ``reduce_from_model``); whole at the
    stack's ends;
  * the token tables by vocabulary (``embed_rows``, always under TP), or,
    where the vocabulary does not divide the axis and the rule splits the
    width, each rank's columns of the step's rows gathered (where they
    are fewer than the vocabulary's); the head by vocabulary columns: the
    cross-entropy's log-sum-exp and label logit are reduced over "model"
    (``core/losses.py``), the served logits all-gathered.

Gathered and run whole on every model rank (in a sequence-parallel
stream: ``join_seq``, the block, ``split_seq``): only a block whose split
widths do not divide the model axis (an attention whose split would cut
a head, keeping its cache's T block; an MLP, MoE, SSD or RG-LRU mixer of
such widths; a cross-attention whose heads do not divide).

Model code reaches the plan through ``ambient_mesh`` (the reference's, with
the step's spec trees): ``stack_tp`` / ``block_tp`` (a party stack's
tensor-parallel compute, ``TP``), ``layer_taker`` (a layer's leaves),
``cache_in`` / ``cache_out`` (a layer's cache block: gathered to the
compute layout, and this rank's block of the new cache written back),
``step_view`` (the leaves outside the layer stacks, materialised once a
step), ``embed_rows`` (token rows looked up where a vocabulary-split
table's rows lie: always under TP, else where that moves less than
gathering the table), ``decision_tp`` / ``head_tp``, and the batch
statistics
``batch_sum`` / ``batch_max`` / ``batch_prefix`` / ``batch_gather``. Outside ``ambient_mesh`` each is the identity (or the
plain slice), so every path without a plan runs as before, just as the
reference's ``constrain`` is a no-op without a mesh.

The reference's ``constrain`` hints steer GSPMD; the port places tensors
explicitly instead, at each of them:

  * ``models/moe.py:84,94`` (the dispatch buffer over ("model", "batch")
    and the combine over "batch"): each rank dispatches its own rows'
    tokens into its own buffer, at the global slots (``batch_prefix``)
    under the global capacity, and under TP into its own experts only;
  * ``models/transformer.py:283`` (the residual stream over "batch"): the
    stream is this rank's rows; nothing moves;
  * ``core/easter_lm.py:243-260`` (the parties' embeddings and the
    aggregate over "batch"): aggregation is row-wise, so each rank
    aggregates its own rows, with the masks' rows of the global step and
    the int8 scale from ``batch_max``.

``shard_map_compat`` and ``use_mesh`` have no counterpart: the ranks are
processes, and every step runs under ``ambient_mesh``.
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import torch

from repro_torch.core.party_group import (party_axis_size,  # noqa: F401
                                          party_shardable)
from repro_torch.tree import tree_map


class P(tuple):
    """A partition spec: one entry per leading dim, None (replicated), an
    axis name or a tuple of names (the dim over their product, the first
    name slowest). Like jax's, a tuple of one name is the name and an
    empty tuple is None."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else (e[0] if len(e) == 1 else e)
            return e
        return tuple.__new__(cls, tuple(canon(e) for e in entries))

    def __repr__(self):
        return "P" + tuple.__repr__(self)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _entries(spec, nd: int) -> list:
    return list(spec) + [None] * (nd - len(spec))


def _prod(xs) -> int:
    return int(math.prod(xs))


def _msize(mesh) -> int:
    return mesh.shape["model"]


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_axes(mesh, layout: str = "tp") -> Tuple[str, ...]:
    """Axes the batch dim shards over. layout="zero3" absorbs the model
    axis into the batch (pure data parallelism + fully-sharded params)."""
    if layout == "zero3":
        return tuple(mesh.axis_names)
    return data_axes(mesh)


def model_axis(mesh) -> str:
    return "model"


# ---------------------------------------------------------------------------
# trees with their paths; spec trees (a P is a leaf, not a sequence)
# ---------------------------------------------------------------------------


def _map_with_path(fn, tree, names=()):
    """``fn(path names, leaf)`` over a tree (or a spec tree, whose ``P``s
    are leaves): dict keys by name, sequence items as ``i<idx>`` (the
    reference's ``_path_names``)."""
    if isinstance(tree, P):
        return fn(names, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, names + (f"i{i}",))
                          for i, v in enumerate(tree))
    return fn(names, tree)


def zip_specs(fn, tree, specs):
    """``fn(leaf, spec)`` over ``tree`` and the spec tree that mirrors it."""
    return _zip_path(lambda _, a, s: fn(a, s), tree, specs)


def _zip_path(fn, tree, specs, names=()):
    """``fn(path names, leaf, spec)`` over ``tree`` and its spec tree."""
    if isinstance(tree, dict):
        return {k: _zip_path(fn, v, specs[k], names + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_path(fn, v, specs[i], names + (f"i{i}",))
                          for i, v in enumerate(tree))
    return fn(names, tree, specs)


def spec_leaves(specs) -> List[P]:
    """A spec tree's specs in ``tree.tree_leaves`` order."""
    if isinstance(specs, P):
        return [specs]
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, (list, tuple)):
        return [s for t in specs for s in spec_leaves(t)]
    return [specs]


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _param_rule(path: Tuple[str, ...], leaf, mesh,
                seq_axis: Optional[str] = None) -> P:
    """Decide the spec for one param leaf from its path names."""
    names = [p for p in path]
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    m = "model"
    msize = _msize(mesh)

    def fits(dim: int) -> bool:
        return dim >= msize and dim % msize == 0

    shape = leaf.shape
    nd = leaf.ndim

    def pad(rule: Tuple) -> P:
        extra = nd - len(rule)
        return P(*([None] * extra + list(rule)))

    # --- embeddings / heads ---
    if name == "table":
        # vocab-sharded embedding (replicate vocab when it doesn't divide,
        # e.g. whisper's 51865, and shard d_model instead if possible)
        if fits(shape[-2]):
            return pad((m, None))
        return pad((None, m)) if fits(shape[-1]) else pad((None, None))
    if parent == "head" and name == "w":
        return pad((None, m)) if fits(shape[-1]) else pad((None, None))

    # --- MoE ---
    if name in ("w_gate", "w_up", "w_down"):
        E = shape[-3]
        if fits(E):
            return pad((m, None, None))            # expert parallel
        # tensor-parallel experts: shard the ff dim
        return pad((None, None, m)) if name != "w_down" else pad((None, m, None))
    if name == "router":
        return pad((None, None))

    # --- attention ---
    if parent in ("wq", "wk", "wv") and name == "w":
        return pad((None, m)) if fits(shape[-1]) else pad((None, None))
    if parent in ("wq", "wk", "wv") and name == "b":
        return pad((m,)) if fits(shape[-1]) else pad((None,))
    if parent == "wo" and name == "w":
        return pad((m, None)) if fits(shape[-2]) else pad((None, None))

    # --- dense MLP ---
    if parent in ("up", "gate") and name == "w":
        return pad((None, m)) if fits(shape[-1]) else pad((None, None))
    if parent == "down" and name == "w":
        return pad((m, None)) if fits(shape[-2]) else pad((None, None))
    if parent in ("up", "gate") and name == "b":
        return pad((m,)) if fits(shape[-1]) else pad((None,))

    # --- SSD (mamba2) ---
    if name == "in_proj":                          # packed zxbcdt: replicate
        return pad((None, None))
    if name == "out_proj":
        return pad((m, None)) if fits(shape[-2]) else pad((None, None))
    if name in ("A_log", "D", "dt_bias"):
        return pad((m,)) if fits(shape[-1]) else pad((None,))
    if name in ("conv_w", "conv_b"):
        return pad((None,) * nd)

    # --- RG-LRU ---
    if parent in ("in_x", "in_gate") and name == "w":
        return pad((None, m)) if fits(shape[-1]) else pad((None, None))
    if parent in ("w_r", "w_i") and name == "w":
        return pad((None, m)) if fits(shape[-1]) else pad((None, None))
    if parent in ("w_r", "w_i") and name == "b":
        return pad((m,)) if fits(shape[-1]) else pad((None,))
    if name == "lam":
        return pad((m,)) if fits(shape[-1]) else pad((None,))
    if parent == "out" and name == "w":
        return pad((m, None)) if fits(shape[-2]) else pad((None, None))

    # --- EASTER proj / decision head ---
    if parent == "proj" and name == "w":
        return pad((None, None))

    # norms, scalars, everything else: replicate
    return pad((None,) * nd)


def _add_fsdp(spec: P, leaf, mesh, dax: Optional[Tuple] = None) -> P:
    """FSDP overlay: shard one remaining replicated dim over the data axes.

    Preference order: the scan-stack (layer) axis, then the largest
    divisible dim. Only applied to leaves of at least 2^20 elements:
    biases and norms stay replicated.
    """
    if leaf.numel() < 2 ** 20:
        return spec
    dax = dax or data_axes(mesh)
    dsz = _prod(mesh.shape[a] for a in dax)
    entries = _entries(spec, leaf.ndim)
    order = list(range(leaf.ndim))
    # try dims largest-first, but prefer the leading stack axis if divisible
    order.sort(key=lambda i: -leaf.shape[i])
    if entries[0] is None and leaf.shape[0] % dsz == 0 and leaf.ndim > 2:
        order = [0] + [i for i in order if i != 0]
    for i in order:
        if entries[i] is None and leaf.shape[i] % dsz == 0 \
                and leaf.shape[i] >= dsz:
            entries[i] = dax
            return P(*entries)
    return spec


def param_specs(params, mesh, fsdp: bool = False, layout: str = "tp"):
    """Spec tree matching ``params``.

    layout="tp" (default): the reference's 1D tensor-parallel layout over
    "model" (+ optional FSDP overlay over "data"); the port stores it so
    and computes the dense blocks, the decision MLPs, the embedding, head
    and loss on each rank's "model" block (module docstring). layout="zero3":
    params fully sharded over ALL mesh axes (ZeRO-3 / pure FSDP), gathered
    per layer at use. ``passive_stacked`` (the port's stacked passive
    group) gets party 1's specs with None in front."""
    def rule(path, leaf):
        if layout == "zero3":
            spec = P(*([None] * leaf.ndim))
            return _add_fsdp(spec, leaf, mesh, dax=tuple(mesh.axis_names))
        spec = _param_rule(path, leaf, mesh)
        if fsdp:
            spec = _add_fsdp(spec, leaf, mesh)
        return spec

    if isinstance(params, dict) and "passive_stacked" in params:
        rest = {k: v for k, v in params.items() if k != "passive_stacked"}
        out = _map_with_path(rule, rest)
        out["passive_stacked"] = zip_specs(
            lambda _, s: P(None, *s), params["passive_stacked"],
            out["parties"][1])
        return out
    return _map_with_path(rule, params)


# ---------------------------------------------------------------------------
# cache rules
# ---------------------------------------------------------------------------

def _cache_rule(path: Tuple[str, ...], leaf, mesh, shard_seq: bool) -> P:
    name = path[-1] if path else ""
    nd = leaf.ndim
    dax = data_axes(mesh)
    dsz = _prod(mesh.shape[a] for a in dax)

    def pad(rule):
        return P(*([None] * (nd - len(rule)) + list(rule)))

    if name in ("k", "v", "k_scale", "v_scale"):
        # (B, T, Hkv, hd|1): batch over data if divisible (else seq over
        # data), AND kv-heads over model if divisible (else seq over model)
        B, T, H = leaf.shape[-4], leaf.shape[-3], leaf.shape[-2]
        msz = _msize(mesh)
        rule = [None, None, None, None]
        if not shard_seq and B % dsz == 0 and B >= dsz:
            rule[0] = dax
        elif T % dsz == 0 and T >= dsz:
            rule[1] = dax
        if H % msz == 0 and H >= msz:
            rule[2] = "model"
        elif rule[1] is None and T % msz == 0 and T >= msz:
            rule[1] = "model"
        return pad(tuple(rule))
    if name == "state" and nd >= 3:
        # ssm state (B,H,P,N) / lru state (B,W): shard H / W over model
        dim = leaf.shape[-3] if nd >= 4 else leaf.shape[-1]
        if dim % _msize(mesh) == 0 and dim >= _msize(mesh):
            return pad(("model", None, None)) if nd >= 4 else pad(("model",))
        return pad((None,) * nd)
    if name == "conv":
        D = leaf.shape[-1]
        if D % _msize(mesh) == 0:
            return pad((None, "model"))
        return pad((None,) * nd)
    return pad((None,) * nd)


def cache_specs(caches, mesh, batch: int):
    dsz = _prod(mesh.shape[a] for a in data_axes(mesh))
    shard_seq = batch < dsz
    return _map_with_path(
        lambda path, leaf: _cache_rule(path, leaf, mesh, shard_seq), caches)


# ---------------------------------------------------------------------------
# input / batch rules
# ---------------------------------------------------------------------------

def batch_specs(batch_tree, mesh, layout: str = "tp"):
    dax = batch_axes(mesh, layout)
    dsz = _prod(mesh.shape[a] for a in dax)

    def rule(leaf):
        B = leaf.shape[0]
        if B % dsz == 0 and B >= dsz:
            return P(dax, *([None] * (leaf.ndim - 1)))
        return P(*([None] * leaf.ndim))

    return tree_map(rule, batch_tree)


# ---------------------------------------------------------------------------
# optimizer-state rules (ZeRO-1 option)
# ---------------------------------------------------------------------------

def opt_state_specs(opt_state, params, mesh, zero1: bool = False,
                    fsdp: bool = False, layout: str = "tp"):
    """Specs of the optimizer state: m / v / s mirror the parameters'
    (``{"parties": [...]}``, as ``opt.init`` builds them), with ZeRO-1
    each further sharded over the data axes on its first divisible dim
    where the parameter is not data-sharded already; scalars (adam's t)
    replicated."""
    if isinstance(params, dict) and "passive_stacked" in params:
        params = {"parties": params["parties"]}
    pspecs = param_specs(params, mesh, fsdp, layout)

    def maybe_zero1(state_branch):
        if not zero1:
            return pspecs
        dax = data_axes(mesh)
        dsz = _prod(mesh.shape[a] for a in dax)

        def z(leaf, sp: P):
            specs = _entries(sp, leaf.ndim)
            used = set()
            for s in specs:
                used |= set(_axes(s))
            if used & set(dax):
                return P(*specs)     # already data-sharded (fsdp overlay)
            for i, (dim, s) in enumerate(zip(leaf.shape, specs)):
                if s is None and dim % dsz == 0 and dim >= dsz:
                    specs[i] = dax
                    break
            return P(*specs)

        return zip_specs(z, state_branch, pspecs)

    out = {}
    if isinstance(opt_state, dict):
        for k, v in opt_state.items():
            if k in ("m", "v", "s"):
                out[k] = maybe_zero1(v)
            else:
                out[k] = tree_map(lambda l: P(), v) if v is not None else v
        return out
    return tree_map(lambda l: P(), opt_state)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's block shape under ``spec``: each dim divided by the size
    of the axes it lies over."""
    return tuple(n // mesh.axis_size(_axes(e))
                 for n, e in zip(shape, _entries(spec, len(shape))))


def _block(x: torch.Tensor, entry, dim: int, mesh) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over ``entry``'s axes (a
    view)."""
    axes = _axes(entry)
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    m = x.shape[dim] // n
    return x.narrow(dim, mesh.coord(axes) * m, m)


def _relayout(x: torch.Tensor, src, dst, mesh) -> torch.Tensor:
    """``x`` stored as ``src`` -> the same tensor stored as ``dst``: dims
    leaving an axis all-gathered over it, dims entering one sliced; the
    dims that only enter an axis are sliced first, so that the gathers
    along the others move the smaller block."""
    s, d = _entries(src, x.dim()), _entries(dst, x.dim())
    for i in range(x.dim()):
        if s[i] is None and d[i] is not None:
            x = _block(x, d[i], i, mesh)
    for i in range(x.dim()):
        if s[i] == d[i] or s[i] is None:
            continue
        x = mesh.all_gather(x, _axes(s[i]), i)
        if d[i] is not None:
            x = _block(x, d[i], i, mesh)
    return x


def relayout_tree(tree, src_specs, dst_specs, mesh):
    """``_relayout`` leaf by leaf (no gradient); a leaf whose layout does
    not change is returned as it is."""
    def one(x, s, d):
        if not isinstance(x, torch.Tensor):
            return x
        return _relayout(x, s, d, mesh)
    return _zip3(one, tree, src_specs, dst_specs)


def _zip3(fn, tree, a, b):
    if isinstance(tree, dict):
        return {k: _zip3(fn, v, a[k], b[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip3(fn, v, a[i], b[i])
                          for i, v in enumerate(tree))
    return fn(tree, a, b)


def local_block(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole leaf ``x`` under ``spec`` (a view)."""
    return _relayout(x, (), spec, mesh)


def shard_tree(tree, specs, mesh):
    """This rank's blocks of a whole tree (the counterpart of
    ``to_shardings`` + ``jit(in_shardings=)``): each leaf cut to its block
    and copied, so the whole tensor can be freed. EasterLM's tree keeps
    ``parties[1:]`` as row views of the ``passive_stacked`` block, so that
    an update of one is an update of the other."""
    def cut(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        return local_block(x, s, mesh).clone()
    if isinstance(tree, dict) and "passive_stacked" in tree:
        from repro_torch.core.party_engine import unstack_tree
        out = {k: (zip_specs(cut, v, specs[k]) if k != "parties" else None)
               for k, v in tree.items()}
        stacked = out["passive_stacked"]
        K = len(tree["parties"]) - 1
        out["parties"] = [zip_specs(cut, tree["parties"][0],
                                    specs["parties"][0])] \
            + unstack_tree(stacked, K)
        return out
    return zip_specs(cut, tree, specs)


def init_opt_state(opt, params, pspecs, ospecs, mesh):
    """``opt``'s state for this rank's parameter blocks ``params`` (an
    EasterLM tree), as ``ospecs`` lays it out (ZeRO-1 cuts a state leaf
    finer than its parameter's block): made from the blocks, never from
    the whole parameters."""
    state = opt.init({"parties": params["parties"]})
    like = {"parties": pspecs["parties"]}
    src = {k: (like if k in ("m", "v", "s") else
               tree_map(lambda _: P(), v)) for k, v in state.items()}
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, relayout_tree(state, src, ospecs, mesh))


def gather_tree(tree, specs, mesh):
    """The whole tree as numpy on rank 0 (None on the other ranks): leaf by
    leaf all-gathered (every rank must call this) and, on rank 0, copied
    to the host before the next, for checks and ``checkpoint.save``."""
    from repro_torch import checkpoint

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        full = _relayout(x, s, (), mesh)
        return checkpoint.params_to_numpy(full) if mesh.rank == 0 else None
    out = zip_specs(one, tree, specs)
    return out if mesh.rank == 0 else None


# ---------------------------------------------------------------------------
# the ambient plan
# ---------------------------------------------------------------------------


@dataclass
class Plan:
    """The step ``ambient_mesh`` runs: the mesh, the layout, the spec trees
    of its parameters (``params``), optimizer state (``opt``) and caches
    (``caches``, one per party), and whether the batch rows are split
    over the batch axes (``split``; a batch too small to divide runs whole
    on every rank, as the reference's ``batch_specs`` replicates it);
    ``fresh``: the step's caches are new (``fresh_caches``), held in the
    compute layout, so a prefill gathers no zeros; ``tp_blocks``: how
    the layers computed over "model" (``stack_tp``)."""
    mesh: Any
    layout: str = "tp"
    params: Any = None
    opt: Any = None
    caches: Any = None
    split: bool = True
    fresh: bool = False
    scopes: list = field(default_factory=list)
    row_tables: dict = field(default_factory=dict)
    # sub-blocks of the layers taken under tensor-parallel compute, by
    # their split ("attn heads", "attn kv", "attn whole", "mlp split",
    # "moe experts", "moe ff", "ssm heads", "rec width", or "... whole";
    # an encoder-decoder's "enc heads" / "enc whole" encoder blocks and
    # "xattn heads" / "xattn whole" cross-attentions), "kv T" the blocks
    # whose K/V cache lies over "model" by T; a recompute's takes counted
    # again
    tp_blocks: dict = field(default_factory=dict)

    @property
    def row_axes(self) -> Tuple[str, ...]:
        """The axes compute is split on: the batch axes when the rows are
        split, else none."""
        return batch_axes(self.mesh, self.layout) if self.split else ()

    def rows(self) -> int:
        return self.mesh.axis_size(self.row_axes)


_PLANS: List[Plan] = []


@contextmanager
def ambient_mesh(mesh, layout: str = "tp", specs: Optional[dict] = None):
    """Run model code under the plan of ``mesh``: ``specs`` holds the
    step's spec trees ("params", "opt", "caches") and "split" (the batch
    rows lie over the batch axes)."""
    specs = dict(specs or {})
    _PLANS.append(Plan(mesh, layout, specs.get("params"), specs.get("opt"),
                       specs.get("caches"), specs.get("split", True)))
    try:
        yield mesh
    finally:
        _PLANS.pop()


def current() -> Optional[Plan]:
    return _PLANS[-1] if _PLANS else None


def rows_split() -> bool:
    """True where this rank's batch rows are a block of the step's."""
    plan = current()
    return plan is not None and plan.rows() > 1


def global_rows(n: int) -> int:
    """The step's batch rows from this rank's ``n``."""
    plan = current()
    return n if plan is None else n * plan.rows()


def local_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This rank's rows (along ``dim``) of a tensor over the step's rows."""
    plan = current()
    if plan is None or not rows_split():
        return x
    return _block(x, plan.row_axes, dim, plan.mesh)


@contextmanager
def _scope(entry):
    plan = current()
    plan.scopes.append(entry)
    try:
        yield
    finally:
        plan.scopes.pop()


def party_scope(k: int, stacked: bool = False):
    """Model code inside runs party ``k``'s backbone (``stacked``: the
    passive group's (K, ...) leaves); ``layer_taker`` and ``cache_in`` read its
    specs. No-op without a plan."""
    plan = current()
    if plan is None:
        return nullcontext()
    tree = (plan.params["passive_stacked"] if stacked
            else plan.params["parties"][k])
    caches = None if plan.caches is None else plan.caches[k]
    return _scope((tree["backbone"], caches))


def _scoped(what: str):
    plan = current()
    if not plan.scopes:
        raise RuntimeError(f"{what} under a sharding plan outside "
                           f"party_scope: which party's specs is unknown")
    return plan, plan.scopes[-1]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def layer_taker(path: Tuple, group: bool = False, tp: "Optional[TP]" = None,
                label: Optional[str] = None):
    """``take(stack, index)``: layer ``index`` of the layer stack at
    ``path`` in the backbone (leaves (n, ...), or (K, n, ...) with
    ``group``): the plain slice without a plan, else each leaf
    materialised (``materialize``); with ``tp`` (``stack_tp``) the leaves
    the layer computes on as their "model" blocks (``TP.consumes``) are
    materialised over every other axis only. The scope's specs and the
    plan are bound here, so a checkpointed layer's recompute in the
    backward pass, outside the scope, takes its layer alike. ``label``
    (a stack of one block kind: "enc", the encoder's blocks, "xattn", the
    cross-attentions) counts each take in ``Plan.tp_blocks`` by the
    attention's split, "<label> heads" or "<label> whole"; without it a
    segment's takes count each block's sub-blocks (``TP.splits``)."""
    axis = 1 if group else 0
    plan = current()
    if plan is None:
        return lambda tree, index: tree_map(
            lambda a: a.select(axis, index), tree)
    plan, (specs, _) = _scoped("a layer")
    specs, mesh, bax = _at(specs, path), plan.mesh, plan.row_axes
    keeps = _map_with_path(lambda names, s: (s, MODEL if tp is not None
                                             and tp.consumes(names) else ()),
                           specs)

    def take(tree, index):
        if label is not None:
            keys = [f"{label} {'whole' if tp is None else tp.attn}"]
        elif tp is not None:    # a segment's repeat: one layer a key
            keys = [key for blk in tree.values() for key in tp.splits(blk)]
        else:
            keys = []
        for key in keys:
            plan.tp_blocks[key] = plan.tp_blocks.get(key, 0) + 1
        return zip_specs(lambda a, sk: _Materialize.apply(
            a, mesh, P(*sk[0]), index, axis, bax, sk[1]), tree, keeps)
    return take


def count_tp(key: str, n: int = 1) -> None:
    """Add ``n`` to the plan's ``tp_blocks[key]`` (no-op without a
    plan)."""
    plan = current()
    if plan is not None and n:
        plan.tp_blocks[key] = plan.tp_blocks.get(key, 0) + n


_KV = ("k", "v", "k_scale", "v_scale")


def _compute_spec(nd: int, plan: Plan, stored=None) -> P:
    """A cache block's compute layout: its rows (dim 0) this rank's where
    the batch is split, every other dim whole; with ``stored`` (the
    stored entries of a leaf the tensor-parallel compute reads as its
    block: ``TP.keeps_cache``) its "model" entry kept (K/V heads or T,
    an SSD state's heads, an LRU state's or conv's width:
    ``_cache_rule``)."""
    out = [None] * nd
    if nd and plan.split:
        out[0] = plan.row_axes or None
    if stored is not None:
        for i in range(1, nd):
            if stored[i] == "model":
                out[i] = "model"
    return P(*out)


def _kv_spec(names, s, nd, plan, tp: "Optional[TP]"):
    """The compute spec of a cache leaf stored as ``s`` (with its stack
    dim, ``nd`` dims without): ``_compute_spec``, keeping the "model"
    entry of a leaf that ``tp`` computes on as its block."""
    stored = _entries(s, nd + 1)[1:]
    keep = tp is not None and bool(names) and tp.keeps_cache(names[-1])
    return _compute_spec(nd, plan, stored if keep else None)


def cache_in(tree, si: int, index: int, tp: "Optional[TP]" = None):
    """Segment ``si``'s cache block for repeat ``index`` in the compute
    layout (the plain slice without a plan); under tensor-parallel
    compute a block the rank computes on keeps its "model" entry
    (``TP.keeps_cache``)."""
    plan = current()
    if plan is None:
        return tree_map(lambda a: a[index], tree)
    plan, (_, cspecs) = _scoped("a cache")

    def one(names, a, s):
        x = a[index]
        dst = _kv_spec(names, s, x.dim(), plan, tp)
        src = dst if plan.fresh else P(*_entries(s, a.dim())[1:])
        return _Relayout.apply(x, plan.mesh, src, dst)
    return _zip_path(one, tree, cspecs[si])


def fresh_caches(full, batch: int, device, cfgs=None):
    """New (zero) caches under the plan from their whole-step shapes
    ``full`` (meta tensors for ``batch`` rows, one tree a party): their
    specs (``cache_specs``) join the plan, and they are made in the
    compute layout (this rank's rows, every other dim whole, the "model"
    entry kept of a block that a party of ``cfgs`` computes on over
    "model"), which ``cache_in`` reads as it is; ``cache_out`` writes
    this rank's blocks of the specs."""
    plan = current()
    plan.caches = cache_specs(full, plan.mesh, batch)
    plan.fresh = True

    def party(tree, specs, cfg):
        tp = None if cfg is None else stack_tp(cfg, 1)

        def zeros(names, a, s):
            spec = P(None, *_kv_spec(names, s, a.dim() - 1, plan, tp))
            return torch.zeros(local_shape(a.shape, spec, plan.mesh),
                               dtype=a.dtype, device=device)
        return _zip_path(zeros, tree, specs)
    cfgs = cfgs or [None] * len(full)
    return [party(t, s, c) for t, s, c in zip(full, plan.caches, cfgs)]


def cache_out(tree, si: int, tp: "Optional[TP]" = None):
    """A repeat's new cache from the compute layout back to this rank's
    block of segment ``si``'s spec (identity without a plan)."""
    plan = current()
    if plan is None:
        return tree
    plan, (_, cspecs) = _scoped("a cache")

    def one(names, x, s):
        return _Relayout.apply(x, plan.mesh,
                               _kv_spec(names, s, x.dim(), plan, tp),
                               P(*_entries(s, x.dim() + 1)[1:]))
    return _zip_path(one, tree, cspecs[si])


def cache_split_t(si: int, key: str) -> bool:
    """True where segment ``si``'s block ``key`` stores its K/V cache's T
    over "model" (``_cache_rule``: the kv heads do not divide)."""
    plan = current()
    if plan is None or plan.caches is None:
        return False
    _, (_, cspecs) = _scoped("a cache")
    k = cspecs[si].get(key, {}).get("k")
    return k is not None and _entries(k, 5)[2] == "model"


# the backbone's layer stacks, materialised a layer at a time; every other
# leaf of a party is materialised once a step (``step_view``)
_LAYER_KEYS = ("segments", "xattn")


def _once(tree, specs, mesh, keep=()):
    return zip_specs(lambda a, s: materialize(a, s, mesh, keep=keep), tree,
                     specs)


def _party_view(party, specs, plan, n_tokens):
    mesh = plan.mesh
    tp = _tp_plan() is not None
    out = {}
    for k, v in party.items():
        if k != "backbone":
            # under TP the decision MLPs and the head compute on their
            # "model" blocks (``decision_tp``, ``head_tp``)
            out[k] = _once(v, specs[k], mesh,
                           MODEL if tp and k in ("decision", "head") else ())
            continue
        bb = {}
        for kk, vv in v.items():
            sp = specs[k][kk]
            if kk in _LAYER_KEYS:
                bb[kk] = vv
            elif kk == "embed" and tp and _entries(
                    sp["table"], vv["table"].dim())[-2] == "model":
                # the vocabulary-parallel embedding: the rows looked up
                # where they lie, whatever the step's token count; a data
                # overlay gathered first (whose backward then sums the
                # batch axes, so the lookup's must not)
                if _rows_cheaper(vv["table"], sp["table"], plan, 0):
                    bb[kk] = vv
                    plan.row_tables[id(vv["table"])] = plan.row_axes
                else:
                    bb[kk] = _once(vv, sp, mesh, MODEL)
                    plan.row_tables[id(bb[kk]["table"])] = ()
            elif kk == "embed" and (
                    _rows_cheaper(vv["table"], sp["table"], plan, n_tokens)
                    or tp and _cols_cheaper(vv["table"], sp["table"],
                                            n_tokens)):
                bb[kk] = vv
                plan.row_tables[id(vv["table"])] = plan.row_axes
            elif kk == "encoder":
                bb[kk] = {"blocks": vv["blocks"],
                          "norm": _once(vv["norm"], sp["norm"], mesh)}
            else:
                bb[kk] = _once(vv, sp, mesh)
        out[k] = bb
    return out


def step_view(params, n_tokens: int):
    """EasterLM's parameters as a step over this rank's ``n_tokens`` tokens
    reads them: under a plan every leaf outside the layer stacks
    materialised (once a step; the gradients reach the blocks through
    ``materialize``), the layer stacks left as blocks for ``layer_taker``,
    and a token table split over its vocabulary alone (or, under TP, its
    width) left as its block for ``embed_rows`` where moving the step's
    token rows costs less than gathering the table (``_rows_cheaper``,
    ``_cols_cheaper``); ``parties[1:]`` row views of
    the materialised ``passive_stacked``. Unchanged without a plan."""
    plan = current()
    if plan is None:
        return params
    specs = plan.params
    out = dict(params)
    parties = list(params["parties"])
    parties[0] = _party_view(parties[0], specs["parties"][0], plan,
                             n_tokens)
    if "passive_stacked" in params:
        from repro_torch.core.party_engine import unstack_tree
        out["passive_stacked"] = _party_view(
            params["passive_stacked"], specs["passive_stacked"], plan,
            n_tokens)
        parties[1:] = unstack_tree(out["passive_stacked"], len(parties) - 1)
    else:
        parties[1:] = [_party_view(p, specs["parties"][k + 1], plan,
                                   n_tokens)
                       for k, p in enumerate(parties[1:])]
    out["parties"] = parties
    return out


# ---------------------------------------------------------------------------
# the differentiable layout changes (legal under torch.func.vmap)
# ---------------------------------------------------------------------------


def _take(x, spec, index, axis, mesh):
    """Entry ``index`` of the stack axis ``axis``: a slice where the axis
    is whole, else a broadcast from the rank that holds it."""
    e, rest = spec[axis], spec[:axis] + spec[axis + 1:]
    if e is None:
        return x.select(axis, index), rest
    ax = _axes(e)
    b, off = divmod(index, x.shape[axis])
    if mesh.coord(ax) == b:
        buf = x.select(axis, off).clone()
    else:
        buf = x.new_empty(x.shape[:axis] + x.shape[axis + 1:])
    return mesh.broadcast(buf, ax, b), rest


class _Materialize(torch.autograd.Function):
    @staticmethod
    def forward(local, mesh, spec, index, axis, bax, keep):
        spec = _entries(spec, local.dim())
        x = local
        if index is not None:
            x, spec = _take(x, spec, index, axis, mesh)
        x = _relayout(x, spec, [e if _kept(e, keep) else None
                                for e in spec], mesh)
        return x.view_as(x) if x is local else x

    @staticmethod
    def setup_context(ctx, inputs, output):
        (local, ctx.mesh, ctx.spec, ctx.index, ctx.axis, ctx.bax,
         ctx.keep) = inputs
        ctx.shape, ctx.dtype = local.shape, local.dtype
        ctx.device = local.device

    @staticmethod
    def backward(ctx, g):
        mesh, bax = ctx.mesh, set(ctx.bax)
        full = _entries(ctx.spec, len(ctx.shape))
        spec = list(full)
        if ctx.index is not None:
            del spec[ctx.axis]
        used = set()
        for i, e in enumerate(spec):
            if e is None or _kept(e, ctx.keep):
                continue
            ax = _axes(e)
            used |= set(ax)
            if set(ax) <= bax:
                g = mesh.reduce_scatter(g, ax, i)
            elif not set(ax) & bax:
                g = _block(g, e, i, mesh)
            else:
                raise NotImplementedError(f"a dim over {ax}, partly batch "
                                          f"axes {sorted(bax)}")
        rest = tuple(a for a in mesh.axis_names if a in bax and a not in used)
        if rest:
            g = mesh.all_reduce(g, rest)
        if ctx.index is not None:
            out = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
            e = full[ctx.axis]
            b, off = divmod(ctx.index, ctx.shape[ctx.axis])
            if e is None:
                out.select(ctx.axis, ctx.index).copy_(g)
            elif mesh.coord(_axes(e)) == b:
                out.select(ctx.axis, off).copy_(g)
            g = out
        return g, None, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, local, mesh, spec, index, axis, bax, keep):
        bd = in_dims[0]
        if bd is None:
            return _Materialize.apply(local, mesh, spec, index, axis,
                                      bax, keep), None
        x = local.movedim(bd, 0)
        spec = (None,) + tuple(_entries(spec, local.dim() - 1))
        return _Materialize.apply(x, mesh, spec, index, axis + 1, bax,
                                  keep), 0


def _kept(entry, keep) -> bool:
    """True for a dim over axes that are all in ``keep`` (left a block)."""
    return entry is not None and bool(keep) and set(_axes(entry)) <= set(keep)


def materialize(local: torch.Tensor, spec, mesh, index: Optional[int] = None,
                axis: int = 0, keep=()) -> torch.Tensor:
    """The whole tensor from this rank's block ``local`` of a leaf stored as
    ``spec`` (``index``: only entry ``index`` of the stack axis ``axis``;
    ``keep``: axes whose dims stay this rank's block, the tensor-parallel
    compute's "model"). Forward: all-gather each sharded dim; broadcast a
    stack entry from the rank that holds it. Backward: the cotangent
    summed over the current plan's batch axes (reduce-scatter or
    all-reduce), this rank's block over the other axes (module
    docstring)."""
    plan = current()
    bax = () if plan is None else plan.row_axes
    return _Materialize.apply(local, mesh, P(*spec), index, axis, bax,
                              tuple(keep))


class _Relayout(torch.autograd.Function):
    """A cache block's layout change (serving: no gradient)."""

    @staticmethod
    def forward(x, mesh, src, dst):
        y = _relayout(x, src, dst, mesh)
        return y.view_as(y) if y is x else y

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError("a cache's layout change has no gradient")

    @staticmethod
    def vmap(info, in_dims, x, mesh, src, dst):
        bd = in_dims[0]
        if bd is None:
            return _Relayout.apply(x, mesh, src, dst), None
        nd = x.dim() - 1
        return _Relayout.apply(x.movedim(bd, 0), mesh,
                               P(None, *_entries(src, nd)),
                               P(None, *_entries(dst, nd))), 0


# ---------------------------------------------------------------------------
# tensor-parallel compute over "model" (layout "tp")
# ---------------------------------------------------------------------------

MODEL = ("model",)


def _model_op(kind, x, mesh, dim: int):
    if kind == "id":
        return x
    if kind in ("sum", "max"):
        return mesh.all_reduce(x, MODEL, kind)
    if kind == "gather":
        return mesh.all_gather(x, MODEL, dim)
    if kind == "scatter":
        return mesh.reduce_scatter(x, MODEL, dim)
    if kind == "split":
        return _block(x, "model", dim, mesh).contiguous()
    raise ValueError(f"model-axis op {kind!r}")


class _ModelComm(torch.autograd.Function):
    """One collective over "model" (``fwd``) whose backward is another
    (``bwd``; None: no gradient): Megatron's operators below. ``dim`` is
    negative, so that the vmap rule, which folds the party axis in front,
    leaves it pointing at the same dim."""

    @staticmethod
    def forward(x, mesh, fwd, bwd, dim):
        y = _model_op(fwd, x, mesh, dim)
        return y.view_as(y) if y is x else y

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, ctx.mesh, _, ctx.bwd, ctx.dim = inputs

    @staticmethod
    def backward(ctx, g):
        if ctx.bwd is None:
            raise RuntimeError("a serving collective has no gradient")
        return _model_op(ctx.bwd, g, ctx.mesh, ctx.dim), None, None, None, \
            None

    @staticmethod
    def vmap(info, in_dims, x, mesh, fwd, bwd, dim):
        if in_dims[0] is None:
            return _ModelComm.apply(x, mesh, fwd, bwd, dim), None
        return _ModelComm.apply(x.movedim(in_dims[0], 0), mesh, fwd, bwd,
                                dim), 0


def copy_to_model(x, mesh):
    """Identity; the backward all-reduces over "model" (before a
    column-parallel product on a whole input)."""
    return _ModelComm.apply(x, mesh, "id", "sum", -1)


def reduce_from_model(x, mesh):
    """All-reduce over "model"; identity backward (after a row-parallel
    product)."""
    return _ModelComm.apply(x, mesh, "sum", "id", -1)


def gather_seq(x, mesh):
    """The S blocks (dim -2) all-gathered over "model"; reduce-scatter
    backward (before a column-parallel product on the sequence-parallel
    stream)."""
    return _ModelComm.apply(x, mesh, "gather", "scatter", -2)


def scatter_seq(x, mesh):
    """Reduce-scatter over "model" along S; all-gather backward (after a
    row-parallel product, into the sequence-parallel stream)."""
    return _ModelComm.apply(x, mesh, "scatter", "gather", -2)


def split_seq(x, mesh):
    """This rank's S block of a whole, replicated x; all-gather backward
    (into the sequence-parallel stream from replicated compute)."""
    return _ModelComm.apply(x, mesh, "split", "gather", -2)


def join_seq(x, mesh):
    """The S blocks all-gathered; the backward keeps this rank's block of
    the replicated cotangent (out of the stream into replicated
    compute)."""
    return _ModelComm.apply(x, mesh, "gather", "split", -2)


def gather_cols(x, mesh):
    """A column-parallel product's columns (dim -1) all-gathered over
    "model"; reduce-scatter backward (the kv heads that every rank's
    cache holds, from each rank's columns of wk / wv)."""
    return _ModelComm.apply(x, mesh, "gather", "scatter", -1)


def model_sum(x, mesh):
    """All-reduce over "model" with an all-reduce backward: a statistic
    that every rank's block reads (the gated norm's sum of squares over
    the width the ranks split), so each rank's cotangent of it is
    partial."""
    return _ModelComm.apply(x, mesh, "sum", "sum", -1)


def model_gather(x, mesh, dim: int):
    """Serving: the "model" blocks of ``x`` along ``dim`` (negative)
    all-gathered (no gradient)."""
    return _ModelComm.apply(x, mesh, "gather", None, dim)


def model_max(x, mesh):
    """Serving: ``x`` maxed over "model" (no gradient)."""
    return _ModelComm.apply(x, mesh, "max", None, -1)


@dataclass(frozen=True)
class TP:
    """How a party's layer stack computes over "model" (``stack_tp``):
    ``attn`` "heads" (each rank its q and kv heads), "kv" (its q heads
    and the one kv head they read; every kv head gathered from the ranks'
    columns for the cache) or "whole" (gathered); ``mlp``: the dense MLPs split (up / gate by
    columns, down by rows); ``seq``: the residual stream is this rank's S
    block; ``kv_t``: the block's K/V cache lies over "model" by T;
    ``moe``: the MoE FFN split "experts" (by expert) or "ff" (every
    expert's ff columns), or None (gathered); ``ssd``: the SSD mixer on
    the rank's heads; ``lru``: the RG-LRU mixer at the rank's width.
    ``TP(None)`` (``WHOLE``) is one rank holding every block: m = 1 and
    the operators the identity."""
    mesh: Any
    attn: str = "whole"
    mlp: bool = False
    seq: bool = False
    kv_t: bool = False
    moe: Optional[str] = None
    ssd: bool = False
    lru: bool = False

    @property
    def m(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["model"]

    @property
    def coord(self) -> int:
        return 0 if self.mesh is None else self.mesh.coord(MODEL)

    def consumes(self, names) -> bool:
        """True for a layer leaf (its path names) computed on as its
        "model" block."""
        if len(names) < 2:
            return False
        parent, name = names[-2], names[-1]
        grand = names[-3] if len(names) > 2 else ""
        if grand == "attn" and self.attn != "whole":
            return parent in ("wq", "wk", "wv", "wo")
        if grand == "mlp" and self.mlp:
            return parent in ("up", "gate", "down")
        if self.moe:
            if parent == "moe":
                return name in ("w_gate", "w_up", "w_down")
            if grand == "shared":
                return parent in ("up", "gate", "down")
        if self.ssd and parent == "ssm":
            return name in ("A_log", "D", "dt_bias", "out_proj")
        if self.lru:
            if parent == "rec":
                return name == "lam"
            if grand == "rec":
                return parent in ("in_x", "in_gate", "w_r", "w_i", "out")
        return False

    def keeps_cache(self, name: str) -> bool:
        """True for a cache leaf (by name) whose "model" block the split
        compute reads and writes as it is: K/V always (its heads under a
        "heads" attention; else its T block, where ``_cache_rule`` puts T
        over "model": the decode merges the ranks' partial softmax, the
        attention split or whole), the SSD state (heads), the LRU state
        and conv (width). The SSD conv cache, over its packed channels,
        is gathered."""
        if name in _KV:
            return True
        if name == "state":
            return self.ssd or self.lru
        return name == "conv" and self.lru

    def splits(self, blk) -> List[str]:
        """How one block's sub-blocks (a layer's leaves) compute, for
        ``Plan.tp_blocks``."""
        how = {"attn": self.attn,
               "mlp": "split" if self.mlp else "whole",
               "moe": self.moe or "whole",
               "ssm": "heads" if self.ssd else "whole",
               "rec": "width" if self.lru else "whole"}
        return [f"{k} {v}" for k, v in how.items() if k in blk]

    def partial(self, tree):
        """Replicated leaves whose products feed this rank's block of a
        split compute (the SSD's ``in_proj``, a conv's taps, a norm over a
        split width): every rank's cotangent is partial, so they pass
        ``copy_to_model`` (its backward sums them over "model") whatever
        the stream."""
        if self.mesh is None:
            return tree
        return tree_map(lambda a: copy_to_model(a, self.mesh), tree)

    def block(self, x, dim: int = -1):
        """This rank's block of ``x`` along ``dim`` (a view)."""
        if self.mesh is None:
            return x
        w = x.shape[dim] // self.m
        return x.narrow(dim, self.coord * w, w)

    def enter(self, x):
        """The stream before a column-parallel product."""
        if self.mesh is None:
            return x
        return (gather_seq if self.seq else copy_to_model)(x, self.mesh)

    def exit(self, y):
        """A row-parallel product's partial sums into the stream."""
        if self.mesh is None:
            return y
        return (scatter_seq if self.seq else reduce_from_model)(y, self.mesh)

    def rep(self, tree):
        """Replicated leaves (a norm, an unsplit bias) as they apply to the
        stream: on an S block their cotangents are partial sums, so they
        go through ``copy_to_model``."""
        if not self.seq:
            return tree
        return tree_map(lambda a: copy_to_model(a, self.mesh), tree)

    def whole(self, x, fn):
        """``fn(x) -> (x', *rest)`` for a block still gathered: on the
        whole sequence (``join_seq``), this rank's S block of x' kept
        (``split_seq``); compute and cotangents are replicated inside."""
        if not self.seq:
            return fn(x)
        y, *rest = fn(join_seq(x, self.mesh))
        return (split_seq(y, self.mesh), *rest)


# a layer computed whole on one rank: no split over "model", nothing moved
WHOLE = TP(None)


def _tp_plan() -> Optional[Plan]:
    """The current plan where it computes over "model": layout "tp", the
    parameters' specs known and a model axis of more than one rank."""
    plan = current()
    if plan is None or plan.layout != "tp" or plan.params is None:
        return None
    return plan if plan.mesh.shape.get("model", 1) > 1 else None


def attn_mode(n_heads: int, n_kv_heads: int, head_dim: int, m: int) -> str:
    """The attention's split over ``m`` model ranks (``TP.attn``): "kv"
    also needs the kv columns (Hkv * hd) to divide, as the rule splits
    them."""
    if n_heads % m == 0 and n_kv_heads % m == 0:
        return "heads"
    if n_heads % m == 0 and n_kv_heads < m and m % n_kv_heads == 0 \
            and n_kv_heads * head_dim % m == 0:
        return "kv"
    return "whole"


def _fits(n: int, m: int) -> bool:
    """``_param_rule``'s test: n splits over m ranks."""
    return n >= m and n % m == 0


def moe_mode(moe, m: int) -> Optional[str]:
    """The MoE FFN's split over ``m`` model ranks (``TP.moe``), as the rule
    stores it: "experts" where the experts divide, else "ff" where each
    expert's ff width does; the shared experts' width must divide too."""
    ff = moe.d_expert_ff
    if moe.n_shared_experts and not _fits(ff * moe.n_shared_experts, m):
        return None
    if _fits(moe.n_experts, m):
        return "experts"
    return "ff" if _fits(ff, m) else None


def stack_tp(cfg, S: int) -> Optional[TP]:
    """The tensor-parallel compute of ``cfg``'s layer stack over a stream
    of S positions under the current plan (an encoder-decoder's encoder
    too, over its F frames), or None (no plan, layout zero3, one model
    rank). The stream is sequence-parallel where S divides the model axis
    (the reference's ``constrain`` rule, S >= m and S % m == 0) and some
    block splits."""
    plan = _tp_plan()
    if plan is None:
        return None
    m = plan.mesh.shape["model"]
    attn = ("whole" if cfg.family == "ssm"
            else attn_mode(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                           m))
    mlp = (cfg.family not in ("moe", "ssm") and _fits(cfg.d_ff, m))
    moe = moe_mode(cfg.moe, m) if cfg.family == "moe" else None
    ssd = False
    if cfg.family == "ssm":
        d_inner = cfg.ssm.expand * cfg.d_model
        ssd = _fits(d_inner // cfg.ssm.head_dim, m)
    lru = (cfg.family == "hybrid"
           and _fits(cfg.hybrid.lru_width or cfg.d_model, m))
    # a stack with nothing split keeps its stream whole (a whole block in
    # a sequence-parallel stream costs a join and a split); its TP still
    # keeps a K/V cache's T block (``block_tp``)
    split = attn != "whole" or mlp or bool(moe) or ssd or lru
    return TP(plan.mesh, attn, mlp, seq=split and S >= m and S % m == 0,
              moe=moe, ssd=ssd, lru=lru)


def block_tp(tp: Optional[TP], si: int, key: str) -> Optional[TP]:
    """``tp`` for segment ``si``'s block ``key`` over this step's caches:
    ``kv_t`` where its K/V cache lies over "model" by T ("kv" or "whole"
    attention: the decode merges the ranks' partial softmax over their T
    blocks instead of gathering the cache)."""
    if tp is None or not cache_split_t(si, key):
        return tp
    return dataclasses.replace(tp, kv_t=True)


def cross_tp(tp: Optional[TP]) -> Optional[TP]:
    """An encoder-decoder's cross-attention split as ``tp``'s attention
    (the same widths): on the rank's heads (q by ``wq``'s columns, the
    K/V ``_encoder_kv`` made from ``wk`` / ``wv``'s, ``wo`` by rows)
    where it is "heads", else None (gathered and run whole)."""
    return tp if tp is not None and tp.attn == "heads" else None


def decision_tp() -> Optional[TP]:
    """The decision MLPs' split (``TP(mlp=True)``, whole stream) where the
    plan stores their up / gate / down by "model", else None."""
    plan = _tp_plan()
    if plan is None:
        return None
    dec = plan.params["parties"][0]["decision"]
    up = dec[0]["mlp"]["up"]["w"] if dec else ()
    return (TP(plan.mesh, mlp=True) if _entries(up, 2)[-1] == "model"
            else None)


def head_tp() -> Optional[TP]:
    """The vocabulary-parallel head (its columns this rank's block), or
    None."""
    plan = _tp_plan()
    if plan is None:
        return None
    spec = plan.params["parties"][0]["head"]["w"]
    return TP(plan.mesh) if _entries(spec, 2)[-1] == "model" else None


# ---------------------------------------------------------------------------
# token embeddings from a table split over its vocabulary
# ---------------------------------------------------------------------------


def _rows_cheaper(table, spec, plan, n_tokens: int) -> bool:
    """True when ``spec`` splits the table's vocabulary dim (-2) and no
    other, and the step's token rows that ``embed_rows`` moves (this
    rank's ``n_tokens`` times the ranks of the vocabulary's axes whose
    tokens differ) are fewer than the vocabulary's rows, which gathering
    the table moves. At 16 x 16 a train_4k step's million tokens outnumber
    any vocabulary, and the table is gathered."""
    e = _entries(spec, table.dim())
    if e[-2] is None or any(x is not None for i, x in enumerate(e)
                            if i != len(e) - 2):
        return False
    axes = _axes(e[-2])
    n_g = plan.mesh.axis_size(tuple(a for a in axes if a in plan.row_axes))
    return n_g * n_tokens < table.shape[-2] * plan.mesh.axis_size(axes)


def _cols_cheaper(table, spec, n_tokens: int) -> bool:
    """True when ``spec`` splits the table's width (-1) over "model" alone
    (the rule's choice where the vocabulary does not divide the axis:
    whisper-small's 51,865 rows) and this rank's ``n_tokens`` rows, which
    ``embed_rows`` gathers by their columns, are fewer than the
    vocabulary's, which gathering the table moves."""
    e = _entries(spec, table.dim())
    return (e[-1] == "model" and all(x is None for x in e[:-1])
            and n_tokens < table.shape[-2])


class _EmbedCols(torch.autograd.Function):
    """Rows of a table (K, V, d / m) split over "model" by its width for
    this rank's tokens (N,): each rank looks up its columns of the rows,
    and the columns are all-gathered over "model" (exact). The backward
    keeps this rank's columns of the (replicated) cotangent, adds each
    into its token's row of this rank's block, and sums the block over
    the batch axes ``bax`` the table is whole on."""

    @staticmethod
    def forward(table, tokens, mesh, bax):
        return mesh.all_gather(table[:, tokens.long()].contiguous(), MODEL,
                               -1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, tokens, ctx.mesh, ctx.bax = inputs
        ctx.shape = table.shape
        ctx.save_for_backward(tokens)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        w = ctx.shape[-1]
        g = g.narrow(-1, ctx.mesh.coord(MODEL) * w, w)
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        grad.index_add_(1, tokens.long(), g)
        if ctx.bax:
            grad = ctx.mesh.all_reduce(grad, ctx.bax)
        return grad, None, None, None


class _EmbedRows(torch.autograd.Function):
    """Rows of a table (K, V / n, d) split over the vocabulary's axes A for
    this rank's tokens (N,): the tokens of the ranks whose tokens differ
    (G, the batch axes in A) gathered, each rank's own rows looked up
    (zeros for another block's tokens), then summed over A (a
    reduce-scatter over G, an all-reduce over the rest): one nonzero term
    a row, so the rows are exact. The backward gathers the cotangents over
    G, adds each into its token's row of this rank's block, and sums the
    block over the batch axes the table is whole on."""

    @staticmethod
    def forward(table, tokens, mesh, axes, bax):
        G = tuple(a for a in axes if a in bax)
        R = tuple(a for a in axes if a not in bax)
        toks = mesh.all_gather(tokens, G, 0) if G else tokens
        n = table.shape[1]
        local = toks.long() - mesh.coord(axes) * n
        inside = (local >= 0) & (local < n)
        idx = torch.where(inside, local, 0)
        rows = torch.where(inside[None, :, None], table[:, idx], 0)
        if G:
            rows = mesh.reduce_scatter(rows, G, 1)
        if R:
            rows = mesh.all_reduce(rows, R)
        return rows

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, tokens, ctx.mesh, ctx.axes, ctx.bax = inputs
        ctx.shape = table.shape
        ctx.save_for_backward(tokens)

    @staticmethod
    def backward(ctx, g):
        (tokens,) = ctx.saved_tensors
        mesh, axes, bax = ctx.mesh, ctx.axes, ctx.bax
        G = tuple(a for a in axes if a in bax)
        toks = mesh.all_gather(tokens, G, 0) if G else tokens
        g = mesh.all_gather(g.contiguous(), G, 1) if G else g
        n = ctx.shape[1]
        local = toks.long() - mesh.coord(axes) * n
        inside = (local >= 0) & (local < n)
        # another block's token adds an exact zero to row 0 (no data-
        # dependent shapes: the dry run runs this on meta tensors)
        grad = torch.zeros(ctx.shape, dtype=g.dtype, device=g.device)
        grad.index_add_(1, torch.where(inside, local, 0),
                        torch.where(inside[None, :, None], g, 0))
        rest = tuple(a for a in mesh.axis_names if a in bax and a not in axes)
        if rest:
            grad = mesh.all_reduce(grad, rest)
        return grad, None, None, None, None


def embed_rows(table: torch.Tensor, tokens: torch.Tensor,
               group: bool = False) -> torch.Tensor:
    """Token embeddings (B, S, d), or (K, B, S, d) from K stacked tables
    with ``group`` (``layers.embed`` / ``layers.embed_grouped``). Under a
    plan whose ``step_view`` left the table a block of its vocabulary,
    the rows are looked up where they lie (``_EmbedRows``), and of a
    table split by its width over "model", each rank's columns of the
    rows, gathered (``_EmbedCols``), instead of gathering the table."""
    from repro_torch.models.layers import embed, embed_grouped
    plan = current()
    if plan is None or id(table) not in plan.row_tables:
        return (embed_grouped(table, tokens) if group
                else embed({"table": table}, tokens))
    plan, (specs, _) = _scoped("a token table")
    e = _entries(specs["embed"]["table"], table.dim())
    t = table if group else table[None]
    if e[-2] is None:
        rows = _EmbedCols.apply(t, tokens.reshape(-1), plan.mesh,
                                plan.row_tables[id(table)])
    else:
        rows = _EmbedRows.apply(t, tokens.reshape(-1), plan.mesh,
                                _axes(e[-2]), plan.row_tables[id(table)])
    rows = rows.reshape((rows.shape[0],) + tuple(tokens.shape)
                        + (rows.shape[-1],))
    return rows if group else rows[0]


# ---------------------------------------------------------------------------
# statistics over the batch axes
# ---------------------------------------------------------------------------


class _BatchSum(torch.autograd.Function):
    """Sum over the batch axes; the backward passes the (replicated)
    cotangent through, so each rank's share of a replicated loss reaches
    its own rows."""

    @staticmethod
    def forward(x, mesh, axes):
        return mesh.all_reduce(x, axes, "sum")

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return g, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes):
        return _BatchSum.apply(x, mesh, axes), in_dims[0]


class _BatchPrefix(torch.autograd.Function):
    """The sum of ``x`` over the ranks of lower batch index (exclusive
    prefix); no gradient."""

    @staticmethod
    def forward(x, mesh, axes):
        parts = mesh.all_gather(x[None], axes, 0)
        return torch.sum(parts[:mesh.coord(axes)], dim=0, dtype=x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return None, None, None

    @staticmethod
    def vmap(info, in_dims, x, mesh, axes):
        return _BatchPrefix.apply(x, mesh, axes), in_dims[0]


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks the step's rows lie over (identity
    without a plan); differentiable, legal under vmap."""
    plan = current()
    if plan is None or plan.rows() == 1:
        return x
    return _BatchSum.apply(x, plan.mesh, plan.row_axes)


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """``x`` (no gradient) maxed over the ranks the rows lie over."""
    plan = current()
    if plan is None or plan.rows() == 1:
        return x
    return plan.mesh.all_reduce(x.detach(), plan.row_axes, "max")


def batch_prefix(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks holding earlier rows (zeros without
    a plan); legal under vmap."""
    plan = current()
    if plan is None or plan.rows() == 1:
        return torch.zeros_like(x)
    return _BatchPrefix.apply(x, plan.mesh, plan.row_axes)


def batch_gather(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's rows (along ``dim``) in order: an output whose spec is
    replicated (identity without a plan; no gradient)."""
    plan = current()
    if plan is None or plan.rows() == 1:
        return x
    return plan.mesh.all_gather(x, plan.row_axes, dim)
