"""EASTER at LLM scale in PyTorch: training (``loss_fn``, ``train_chunk``)
and serving (prefill and the blinded decode round).

Counterpart of ``repro.core.easter_lm``. Parties:
  * party 0 (ACTIVE): the full architecture as its backbone;
  * parties 1..K (PASSIVE): reduced-depth proxies of the same family
    (depth x ``passive_depth_frac``, ``passive_cfg``).

Per-party local model = backbone hidden states -> linear projection into
the shared embedding space R^{d_embed} (the paper's embedding layer), then
an MLP decision stack and an LM head (the paper's decision layers). Every
round (prefill or decode) blinds the passive uplink with pairwise PRF
masks and aggregates through ``_aggregate``: the float wire goes through
``aggregation.blind_and_aggregate`` (the ``blind_agg_fwd`` kernel on the
card), the int32/int8 ring wires through ``aggregation.aggregate_ring``.

Parties are dense transformers (gemma3's local:global layers included),
MoE transformers, Mamba-2 SSD stacks, hybrid (RG-LRU + local attention,
recurrentgemma) stacks, vision (qwen2-vl) or encoder-decoder (whisper)
transformers (``models.transformer``); their caches hold K/V for
attention layers and the conv history and float32 state for RG-LRU and
SSD layers. An MoE party's load-balance losses reach ``loss_fn``'s total
on both engines; ``moe_dense_passive`` gives an MoE active dense passive
proxies, as in the reference.

Frontend inputs (the reference's per-party ``fe_list``: one dict of
``apply_lm`` keywords per party) reach ``prefill``, ``serve_step`` and,
as a batch's ``*_embed`` keys, ``loss_fn``. An encoder-decoder's serving
computes its cross K/V once per request (``encoder_kv``) and passes
``{"enc_kv": ...}`` in every round; the passive group's entries are
views into one tensor laid out layer-major, which the grouped round
reads without stacking it again (``party_engine.stack_views``).

Engines: ``engine="vectorized"`` (the default, as in the reference) runs
the K structurally identical passive proxies as one ``torch.func.vmap``
over their stacked parameters; on the card the prompt attention and the
RG-LRU recurrence inside it fold the party axis into the batch axis
around one kernel launch per layer. The passive group is stacked once, by ``init_params``,
``load_params`` or ``group_params``, into ``params["passive_stacked"]``;
the per-party trees are row views of it, and the per-step path reads it
as it is and copies no weight (the reference restacks on every step,
which costs nothing under jit and about 6 GB a round in eager torch at
qwen2.5-3b). The group's token embeddings are one offset gather from
the flat view of the stacked tables (``layers.embed_grouped``, through
``sharding.embed_rows``), outside
the vmap. ``engine="loop"`` is the per-party oracle.

``engine="sharded"`` lays the stacked passive group over a party group of
``torch.distributed`` ranks (``group``, a ``party_group.PartyGroup``;
None joins the launcher's, ``launch.mesh.make_party_group``). Where K
divides over the ranks (``_shard_ok``), each rank holds and runs its own
rows of the group (``passive_stacked`` holds those rows; a party another
rank holds is ``{}`` in ``params["parties"]`` and in the caches), makes
only its own rows' masks, and blinds them in place; the gather of that
uplink is the only collective that carries embeddings. The active
party's weights, caches and decision live on rank 0, which aggregates.
In training the global embedding is broadcast back and every rank's
losses arrive on every rank; in serving only rank 0 gets the embedding
and the logits, and the decode drivers broadcast the sampled tokens
(``share_tokens``). The labels reach every rank's decision losses, as
the reference's shards take them. With K not dividing over the ranks
every rank runs every party (replicated), the reference's rule. Both
stacked engines run one code path (``_loss_fn_grouped``,
``_serve_grouped``): the vectorized engine is the one-process case,
whose rows are all K and whose collectives are the identity; the two
differ only in ``_held_aggregate``, where one process hands its float
masks to the blind+aggregate kernel.

Training: ``loss_fn`` is the reference's, with its stop-gradient
surrogate, so one backward gives every party the gradient of its own
loss. The training forward takes the plain differentiable attention and
RG-LRU paths on every device (their kernels have no backward);
``blind_agg_fwd`` stays on it, and ``blind_agg_bwd`` runs in
``grad_mode="joint"``. On the vectorized engine the leaves that take
gradients are the active party's and the stacked passive group's
(``train_leaves``); the passive layers run outside the vmap, each repeat
one ``checkpoint(vmap(...))`` under ``remat="full"``
(``transformer.apply_hidden(group=True)``).

Serving entry points run under ``torch.no_grad()``; every entry point
runs on the system's device (None = the card).

Under a sharding plan (``repro_torch.sharding.ambient_mesh``, the FSDP
plan on the vectorized engine: ``launch.steps.shard_step``) the
parameters and caches are this rank's blocks and the batch this rank's
rows: ``sharding.step_view`` materialises the leaves outside the layer
stacks once a step, each party's backbone runs in its
``sharding.party_scope`` (its layers gathered one at a time), the masks
are the global step's rows for this rank's rows, the int8 scale is the
max over the ranks, every loss is the global mean (sums and counts
reduced over the batch axes), and the served embedding or logits are
gathered to every rank.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List

import torch
from torch.func import vmap

from repro_torch import checkpoint, sharding
from repro_torch.configs.base import EasterConfig, ModelConfig
from repro_torch.core import aggregation, blinding
from repro_torch.core import party_group as pg
from repro_torch.core.losses import chunked_lm_head_xent
from repro_torch.core.party_engine import (stack_trees, stack_views,
                                           unstack_tree)
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.layers import (apply_norm, init_linear, init_mlp,
                                       init_norm, linear, mlp)
from repro_torch.tree import empty_stack, stack_drawn, tree_map

# the EasterLM federation's fixed ceremony seed, as in the reference
CEREMONY_SEED = 1729


def passive_cfg(cfg: ModelConfig, easter: EasterConfig, k: int) -> ModelConfig:
    """Heterogeneous passive-party proxy: reduced depth, same family. An
    MoE active with ``moe_dense_passive`` gets dense proxies whose FFN
    width matches the MoE's active FLOPs."""
    frac = easter.passive_depth_frac
    n = max(2, int(round(cfg.n_layers * frac)))
    if cfg.family == "hybrid":
        n = max(len(cfg.hybrid.pattern), n - n % len(cfg.hybrid.pattern))
    kw = dict(n_layers=n, tie_embeddings=True,
              name=f"{cfg.name}-passive{k}")
    if cfg.family == "moe" and easter.moe_dense_passive:
        from repro_torch.configs.base import MoEConfig
        kw.update(family="dense",
                  d_ff=cfg.moe.d_expert_ff
                  * (cfg.moe.top_k + cfg.moe.n_shared_experts),
                  moe=MoEConfig())
    return dataclasses.replace(cfg, **kw)


def _empty_passive_stack(party, K: int):
    """Uninitialized (K, ...) leaves for the stacked passive group. A
    backbone leaf with a layer axis, (reps, ...) in one party (the
    segments, an encoder-decoder's encoder blocks and cross-attention),
    lies layer-major: (reps, K, ...) in memory, viewed as (K, reps, ...).
    One layer of the group, ``a[:, r]``, is then one contiguous (K, ...)
    block, which the grouped layers' batched matmuls read as it is;
    party-major, an MoE layer's (K, E, ...) expert weights would be copied
    to merge K and E into one batch axis, in every round."""
    def layer_major(tree):
        return tree_map(lambda a: a.new_empty(
            (a.shape[0], K) + tuple(a.shape[1:])).transpose(0, 1), tree)

    rest = {k: v for k, v in party.items() if k != "backbone"}
    bb = party["backbone"]
    out = empty_stack(rest, K)
    out["backbone"] = {k: (layer_major(v) if k in ("segments", "xattn")
                           else empty_stack(v, K)) for k, v in bb.items()}
    if "encoder" in bb:
        out["backbone"]["encoder"] = {
            "blocks": layer_major(bb["encoder"]["blocks"]),
            "norm": empty_stack(bb["encoder"]["norm"], K)}
    return out


@dataclass
class EasterLM:
    cfg: ModelConfig                 # active party's architecture
    easter: EasterConfig
    grad_mode: str = "easter"        # easter (paper) | joint (beyond-paper)
    # vectorized: the K passive proxies share one config, so they run as
    # one vmap over their stacked parameters; sharded: that stack over a
    # party group of ranks; loop: the per-party oracle
    engine: str = "vectorized"
    device: Any = None               # None = the card (the group's, sharded)
    # engine="sharded": the ranks' party group; None joins the launcher's
    group: Any = None

    def __post_init__(self):
        if self.engine not in ("vectorized", "sharded", "loop"):
            raise ValueError(f"engine {self.engine!r}")
        if self.engine == "sharded":
            if self.group is None:
                from repro_torch.launch.mesh import make_party_group
                self.group = make_party_group(device=self.device)
            if self.device is None:
                self.device = self.group.device
        if self.grad_mode not in ("easter", "joint"):
            raise ValueError(f"grad_mode {self.grad_mode!r}")
        if self.easter.mask_mode not in ("float",) + blinding.RING_MODES:
            raise ValueError(f"mask_mode {self.easter.mask_mode!r}")
        for pcfg in self.party_cfgs:
            transformer._check_family(pcfg)
        self.device = resolve_device(self.device)

    @functools.cached_property
    def party_cfgs(self) -> List[ModelConfig]:
        active = dataclasses.replace(self.cfg, tie_embeddings=True)
        return [active] + [passive_cfg(self.cfg, self.easter, k)
                           for k in range(1, self.easter.num_passive + 1)]

    @property
    def C(self) -> int:
        return self.easter.num_passive + 1

    # -- blinding setup (host-side DH ceremony) -----------------------------
    def mask_seeds(self):
        """Mask synthesis state: a MaskEngine (vectorized engine) or the
        raw pair-seed dict (loop oracle); None when fewer than two passive
        parties or blinding is off. Memoized, as the ceremony costs
        K(K-1)/2 2048-bit modexps."""
        if self.easter.num_passive < 2 or not self.easter.enabled:
            return None
        if self.engine != "loop":
            return blinding.cached_mask_engine(self.easter.num_passive,
                                               CEREMONY_SEED)
        return blinding.cached_passive_setup(self.easter.num_passive,
                                             CEREMONY_SEED)[1]

    # -- params --------------------------------------------------------------
    def init_party(self, gen: torch.Generator,
                   pcfg: ModelConfig) -> Dict[str, Any]:
        d_e = self.easter.d_embed
        dtype = transformer.torch_dtype(pcfg.dtype)
        backbone = transformer.init_lm(gen, pcfg)
        proj = init_linear(gen, pcfg.d_model, d_e, False, dtype)
        decision = [{"ln": init_norm(pcfg.norm, d_e, dtype, gen.device),
                     "mlp": init_mlp(gen, d_e, 4 * d_e, pcfg.act, dtype)}
                    for _ in range(self.easter.decision_layers)]
        return {
            "backbone": backbone,
            "proj": proj,
            "decision": decision,
            "final_norm": init_norm(pcfg.norm, d_e, dtype, gen.device),
            "head": init_linear(gen, d_e, pcfg.vocab_size, False, dtype),
        }

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> Dict[str, Any]:
        """{"parties": [active, passive 1..K]} drawn from ``gen`` on its
        own device (a CUDA generator draws a large model on the card), on
        ``self.device``, grouped as ``group_params`` groups them. On the
        vectorized engine each passive party is drawn straight into its
        row of ``passive_stacked`` and dropped, so the draw holds one copy
        of the weights (and one party's beside it), with the same bits as
        stacking the drawn parties. Weights drawn from a torch generator
        differ from the reference's jax.random ones; tests hand the
        reference's weights over with ``load_params``."""
        def draw(pcfg):
            return tree_map(lambda t: t.to(self.device),
                            self.init_party(gen, pcfg))

        active = draw(self.party_cfgs[0])
        if not self._passive_group_ok():
            return {"parties": [active] + [draw(c)
                                           for c in self.party_cfgs[1:]]}
        K = self.easter.num_passive
        if not self._shard_ok():
            stacked = stack_drawn(lambda k: draw(self.party_cfgs[1 + k]), K,
                                  _empty_passive_stack)
            return {"parties": [active] + unstack_tree(stacked, K),
                    "passive_stacked": stacked}
        # every rank draws every party in order (one process's bits) and
        # keeps its own: the active party on rank 0, its rows of the group
        rows = self._rows()
        if not self._holds_active():
            active = {}
        for k in range(rows[0]):
            draw(self.party_cfgs[1 + k])
        stacked = stack_drawn(lambda i: draw(self.party_cfgs[1 + rows[i]]),
                              len(rows), _empty_passive_stack)
        return self._held_tree(active, stacked)

    def _held_tree(self, active, stacked) -> Dict[str, Any]:
        """{"parties": [active or {}, own rows' views, {} elsewhere],
        "passive_stacked": own rows} of a rank of the sharded engine."""
        rows = self._rows()
        views = unstack_tree(stacked, len(rows))
        parties = [active] + [{}] * self.easter.num_passive
        for i, r in enumerate(rows):
            parties[1 + r] = views[i]
        return {"parties": parties, "passive_stacked": stacked}

    def load_params(self, trees) -> Dict[str, Any]:
        """The reference's ``init_params`` tree as numpy arrays (bfloat16
        included) -> this system's grouped tensors on ``self.device``."""
        return self.group_params(checkpoint.params_from_numpy(
            self.held_parties(trees), self.device, requires_grad=False))

    def held_parties(self, params):
        """``{"parties": [...]}`` with the parties this rank does not hold
        (the sharded engine) replaced by ``{}``; otherwise unchanged."""
        if not self._shard_ok():
            return params
        held = self._held()
        return {**params, "parties": [p if k in held else {} for k, p in
                                      enumerate(params["parties"])]}

    @staticmethod
    def export_params(params) -> Dict[str, Any]:
        """The inverse of ``load_params``: the reference's
        ``{"parties": [...]}`` tree as numpy arrays (the stacked passive
        group stays behind)."""
        return checkpoint.params_to_numpy({"parties": params["parties"]})

    @torch.no_grad()
    def group_params(self, params) -> Dict[str, Any]:
        """Stack the passive group once (vectorized engine) into
        ``params["passive_stacked"]`` (``_empty_passive_stack``'s layout),
        which the grouped steps read as it is; the returned passive
        parties are row views of it. Other engines: unchanged."""
        if not self._passive_group_ok():
            return params
        parties = params["parties"]
        rows = self._rows()
        stacked = stack_drawn(lambda i: parties[1 + rows[i]], len(rows),
                              _empty_passive_stack)
        return {**params, **self._held_tree(
            parties[0] if self._holds_active() else {}, stacked)}

    @staticmethod
    def _passive_stack(params):
        """The stacked passive tree of ``params`` (no copy)."""
        if "passive_stacked" not in params:
            raise ValueError(
                "the passive group is not stacked: build params with "
                "EasterLM.init_params, load_params or group_params (the "
                "vectorized engine reads the stacked weights as they are "
                "instead of copying every passive weight each round)")
        return params["passive_stacked"]

    def train_leaves(self, params):
        """The tensors a training step differentiates and updates: every
        party's tree, or on the vectorized engine the active party's and
        the stacked passive group's (the passive parties' trees are row
        views of it)."""
        if self._passive_group_ok():
            return {"active": params["parties"][0],
                    "stacked": self._passive_stack(params)}
        return {"parties": params["parties"]}

    def party_grads(self, grads) -> List[Any]:
        """``train_leaves``-shaped gradients -> the reference's per-party
        list (passive entries row views of the stacked gradients)."""
        if "stacked" in grads:
            return self._held_tree(grads["active"],
                                   grads["stacked"])["parties"]
        return list(grads["parties"])

    # -- protocol pieces -----------------------------------------------------
    def local_embed(self, pparams, pcfg: ModelConfig, tokens, *, caches=None,
                    pos_offset=0, window_override=-1, training=False, **fe):
        x = sharding.embed_rows(pparams["backbone"]["embed"]["table"], tokens)
        return self._embed_from(pparams, pcfg, x, caches=caches,
                                pos_offset=pos_offset,
                                window_override=window_override,
                                training=training, **fe)

    def _embed_from(self, pparams, pcfg: ModelConfig, x, *, caches=None,
                    pos_offset=0, window_override=-1, training=False, **fe):
        """``local_embed`` from the token embeddings x (B, S, d_model);
        ``fe``: the party's frontend inputs (``transformer.apply_hidden``'s
        keywords)."""
        h, new_caches, aux = transformer.apply_hidden(
            pparams["backbone"], x, pcfg, caches=caches,
            pos_offset=pos_offset, window_override=window_override,
            return_hidden=True, training=training, **fe)
        E = linear(pparams["proj"], h)                 # (B, S, d_embed)
        return E, new_caches, aux

    def masks_for(self, shape, round_idx, seeds, rows=None):
        """(K, *shape) masks for ``round_idx`` (a scalar or an (R,) tensor
        of per-lane rounds); ``fresh_masks=False`` collapses every round to
        0, the paper's single static pad (per lane when per-lane).
        ``rows``: only those passive rows (a MaskEngine)."""
        if seeds is None:
            return None
        n = shape[0] if shape else 0
        if sharding.rows_split():
            # this rank's rows of the global step's masks: the same bits
            shape = (sharding.global_rows(n),) + tuple(shape[1:])
        if self.easter.fresh_masks:
            r = round_idx
        elif isinstance(round_idx, torch.Tensor):
            r = torch.zeros_like(round_idx)
        else:
            r = 0
        if isinstance(seeds, blinding.MaskEngine):
            masks = seeds.masks(shape, r, self.easter.mask_mode,
                                device=self.device, rows=rows)
        else:
            masks = blinding.all_party_masks(self.easter.num_passive, seeds,
                                             shape, r, self.easter.mask_mode,
                                             device=self.device)
        return sharding.local_rows(masks, 1)

    def decide_hidden(self, pparams, pcfg: ModelConfig, E):
        """The decision stack (its MLPs over "model" under a plan's TP
        compute, ``sharding.decision_tp``) and the final norm."""
        tp = sharding.decision_tp()
        x = E
        for blk in pparams["decision"]:
            x = x + mlp(blk["mlp"], apply_norm(blk["ln"], x, pcfg.rms_eps),
                        pcfg.act, tp)
        return apply_norm(pparams["final_norm"], x, pcfg.rms_eps)

    def decide(self, pparams, pcfg: ModelConfig, E):
        """Serving logits (B, S, vocab): under a vocabulary-parallel head
        (``sharding.head_tp``) each rank's columns, all-gathered."""
        x = self.decide_hidden(pparams, pcfg, E)
        logits = linear(pparams["head"], x)            # (B, S, vocab)
        tp = sharding.head_tp()
        return logits if tp is None else sharding.model_gather(
            logits, tp.mesh, -1)

    def _passive_group_ok(self) -> bool:
        """True when parties 1..K are structurally identical (they are by
        construction of passive_cfg: only the name differs) and a stacked
        engine (vectorized or sharded) is selected."""
        if self.engine == "loop" or self.easter.num_passive < 1:
            return False
        anon = [dataclasses.replace(c, name="") for c in self.party_cfgs[1:]]
        return all(c == anon[0] for c in anon)

    def _shard_ok(self) -> bool:
        """True when the K-passive stack lies over the party group (the
        sharded engine, K dividing over its ranks)."""
        return (self.engine == "sharded" and self._passive_group_ok()
                and pg.party_shardable(self.group, self.easter.num_passive))

    def _grp(self):
        """The party group the passive rows lie over, or None: one process
        holds every row, and the collectives are the identity."""
        return self.group if self._shard_ok() else None

    def _rows(self) -> range:
        """This rank's rows of the passive group (all K off the sharded
        path)."""
        K = self.easter.num_passive
        return self.group.rows(K) if self._shard_ok() else range(K)

    def _holds_active(self) -> bool:
        """True where the active party runs: rank 0 of a sharded group,
        every process otherwise."""
        return not self._shard_ok() or self.group.rank == 0

    def _held(self) -> set:
        """The parties whose weights and caches this process holds."""
        held = {0} if self._holds_active() else set()
        return held | {1 + r for r in self._rows()}

    def sum_over_ranks(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the party group's ranks where the parties lie
        over them (an optimizer's clipping norm); unchanged otherwise."""
        if not self._shard_ok():
            return x
        return self.group.all_reduce(x.reshape(1).clone(), "sum")[0]

    def share_tokens(self, tok, shape):
        """The decode drivers' next tokens (int32, ``shape``): sampled on
        the active party's rank and broadcast to the others under the
        sharded engine (other ranks pass None); unchanged otherwise."""
        if not self._shard_ok():
            return tok
        buf = (tok.to(torch.int32).contiguous() if self._holds_active()
               else torch.empty(shape, dtype=torch.int32,
                                device=self.device))
        return self.group.broadcast(buf, 0)

    def _aggregate(self, E_all, round_idx, seeds, lane_mask=None):
        """Blind + aggregate (C, B, S, d) -> (E_all, global E).

        ``lane_mask`` (B,) bool: rows of finished request lanes are zeroed
        in both the embeddings and the masks before blinding, so a frozen
        lane's uplink is exactly 0 on the wire (int32 included) and it
        moves neither the int8 scale nor the wire bytes."""
        masks = self.masks_for(tuple(E_all.shape[1:]), round_idx, seeds)
        if lane_mask is not None:
            keep = lane_mask.reshape((1, -1) + (1,) * (E_all.dim() - 2))
            E_all = torch.where(keep, E_all, 0)
            if masks is not None:
                masks = torch.where(keep, masks, 0)
        if masks is not None and self.easter.mask_mode in blinding.RING_MODES:
            scale = None
            if self.easter.mask_mode == "int8" and sharding.rows_split():
                # max |E| over the global step's rows: every rank's rows
                scale = blinding.ring_scale(sharding.batch_max(
                    torch.max(torch.abs(E_all.detach()))), self.C, "int8")
            E = aggregation.aggregate_ring(E_all, masks,
                                           self.easter.mask_mode, scale)
        else:
            E = aggregation.blind_and_aggregate(E_all, masks)
        return E_all, E

    def _aggregate_grouped(self, E_a, up_p, blinded: bool, scale=None):
        """Aggregate the active embedding with an already-gathered passive
        uplink (blinded when ``blinded``: float E+r, ring quantize(E)+r;
        int8 needs the round's ``scale``), in ``_aggregate``'s op order."""
        if not blinded:
            return torch.mean(torch.cat([E_a[None], up_p], dim=0), dim=0)
        if self.easter.mask_mode == "int8":
            return aggregation.aggregate_int8_blinded(
                torch.cat([blinding.quantize_ring(E_a, "int8", scale)[None],
                           up_p], 0), scale)
        if self.easter.mask_mode == "int32":
            return aggregation.aggregate_int32_blinded(
                torch.cat([blinding.quantize(E_a)[None], up_p], 0))
        return aggregation.aggregate(E_a, up_p)

    # -- training forward/loss -----------------------------------------------
    def _per_party_E(self, E, E_all):
        """(C, B, S, d): party k's view of the global embedding. "easter"
        (the paper): the value of E with the gradient of E_all[k] / C, so
        each party's loss reaches only its own backbone; "joint": E."""
        if self.grad_mode == "easter":
            return (E.detach()[None] - E_all.detach() / self.C
                    + E_all / self.C)
        return E[None].expand(E_all.shape)

    def loss_fn(self, params, batch, round_idx, seeds):
        """(total, per-party losses (C,)) of one training round blinded
        under ``round_idx`` (the TRAIN domain: the global step).
        ``batch``: {"tokens", "labels"} (B, S) int tensors, and the
        frontend inputs every party takes (``audio_embed``,
        ``vision_embed``: the keys ending in ``_embed``; other keys are
        ignored, as in the reference)."""
        params = sharding.step_view(params, math.prod(batch["tokens"].shape))
        if self._passive_group_ok():
            return self._loss_fn_grouped(params, batch, round_idx, seeds)
        tokens, labels, fe = self._batch(batch)
        Es, auxes = [], []
        for k, pcfg in enumerate(self.party_cfgs):
            with sharding.party_scope(k):
                E_k, _, aux_k = self.local_embed(params["parties"][k], pcfg,
                                                 tokens, training=True, **fe)
            Es.append(E_k)
            auxes.append(aux_k)
        E_all, E = self._aggregate(torch.stack(Es), round_idx, seeds)
        E_for = self._per_party_E(E.to(E_all.dtype), E_all)
        per = []
        for k, pcfg in enumerate(self.party_cfgs):
            h_k = self.decide_hidden(params["parties"][k], pcfg, E_for[k])
            # fused head + CE: never materializes (B, S, V) logits
            per.append(self._xent(h_k, params["parties"][k]["head"]["w"],
                                  labels))
        per = torch.stack(per)
        return torch.sum(per) + torch.sum(torch.stack(auxes)), per

    @staticmethod
    def _xent(h, head_w, labels):
        """The fused head + cross-entropy's mean over the step's tokens:
        under a plan that splits the rows, the sum over this rank's tokens,
        summed over the ranks, over the global count (not a mean of the
        ranks' means); vocabulary-parallel under ``sharding.head_tp``."""
        tp = sharding.head_tp()
        if not sharding.rows_split():
            return chunked_lm_head_xent(h, head_w, labels, tp=tp)
        n = sharding.global_rows(labels.shape[0]) * labels.shape[1]
        return sharding.batch_sum(chunked_lm_head_xent(
            h, head_w, labels, reduction="sum", tp=tp)) / n

    def _batch(self, batch):
        """(tokens, labels, frontend inputs) of a batch on the device."""
        on = lambda v: torch.as_tensor(v, device=self.device)
        fe = {k: on(v) for k, v in batch.items() if k.endswith("_embed")}
        return on(batch["tokens"]), on(batch["labels"]), fe

    def _loss_fn_grouped(self, params, batch, round_idx, seeds):
        """The stacked engines' training round: the active party on its
        rank, this rank's passive rows at once (every row in one process):
        one offset gather of their token embeddings, their layers as
        ``checkpoint(vmap(...))`` per repeat
        (``transformer.apply_hidden(group=True)``), ``_held_aggregate``,
        their decision stacks as one vmap and their heads' cross-entropy
        party by party. The stop-gradient surrogate acts on each party's
        own rows, so one backward on every rank gives each party its own
        loss's gradient. Over a party group the per-party and aux losses
        are gathered and the active party's broadcast."""
        tokens, labels, fe = self._batch(batch)
        grp, C = self._grp(), self.C
        pcfg_a, pcfg_p = self.party_cfgs[0], self.party_cfgs[1]
        E_a = aux_a = None
        if self._holds_active():
            with sharding.party_scope(0):
                E_a, _, aux_a = self.local_embed(
                    params["parties"][0], pcfg_a, tokens, training=True, **fe)
        sp = self._passive_stack(params)
        with sharding.party_scope(1, stacked=True):
            x_p = sharding.embed_rows(sp["backbone"]["embed"]["table"],
                                      tokens, group=True)
            h_p, _, aux_p = transformer.apply_hidden(
                sp["backbone"], x_p, pcfg_p, return_hidden=True,
                training=True, group=True, **fe)
        E_p = vmap(linear)(sp["proj"], h_p)          # (K_own, B, S, d_e)
        E = self._held_aggregate(E_a, E_p, round_idx, seeds,
                                 share=True).to(E_p.dtype)
        if E.requires_grad:             # alike on every rank
            E = pg.enter_shard(E, grp)

        def view(e):
            if self.grad_mode == "easter":
                return E.detach() - e.detach() / C + e / C
            return E.expand(e.shape)

        hs = vmap(lambda p, e: self.decide_hidden(p, pcfg_p, e))(
            sp, view(E_p))
        per_p = pg.gather_rows(torch.stack(
            [self._xent(hs[i], sp["head"]["w"][i], labels)
             for i in range(len(hs))]), grp)
        aux_p = pg.gather_rows(aux_p.reshape(-1), grp)
        per_a = None
        if E_a is not None:
            h_a = self.decide_hidden(params["parties"][0], pcfg_a, view(E_a))
            per_a = self._xent(h_a, params["parties"][0]["head"]["w"],
                               labels)
        per_a = pg.from_rank(per_a, grp, 0, (), per_p.dtype)
        aux_a = pg.from_rank(aux_a, grp, 0, (), aux_p.dtype)
        per = torch.cat([per_a[None], per_p])
        return torch.sum(per) + aux_a + torch.sum(aux_p), per

    # -- the stacked engines' aggregation -------------------------------------
    def _blind_own(self, E_p, masks, scale):
        """This rank's uplink rows: the float wire ships E + r in the
        masks' float32 (the precision the blind+aggregate kernel adds
        them in, so a bfloat16 E's aggregate is the one process's), the
        ring wires quantize(E) + r."""
        if masks is not None and self.easter.mask_mode == "float":
            return blinding.blind_uplink(E_p.to(masks.dtype), masks, "float")
        return blinding.blind_uplink(E_p, masks, self.easter.mask_mode,
                                     scale)

    def _round_scale(self, E_p, E_a, masks):
        """The int8 wire's round scale from max |E| over every party: one
        ``all_reduce(MAX)`` of this rank's rows' max (and the active
        party's on rank 0); None on the other wires."""
        if masks is None or self.easter.mask_mode != "int8":
            return None
        amax = torch.max(torch.abs(E_p.detach())).float()
        if E_a is not None:
            amax = torch.maximum(amax, torch.max(torch.abs(
                E_a.detach())).float())
        amax = self.group.all_reduce(amax.reshape(1).contiguous(), "max")[0]
        return blinding.ring_scale(amax, self.C, "int8")

    def _held_aggregate(self, E_a, E_p, round_idx, seeds, lane_mask=None,
                        *, share: bool):
        """The global embedding from the active party's embedding (None off
        its rank) and this rank's passive rows E_p (K_own, B, S, d).

        In one process: ``_aggregate`` of the (C, ...) stack, where the
        float wire's masks enter the blind+aggregate kernel. Over a party
        group: each rank makes and adds only its own rows' masks
        (``_blind_own``), the gather of that uplink is the only collective
        that carries embeddings, and rank 0 aggregates
        (``_aggregate_grouped``, the same bits); with ``share`` it
        broadcasts E, differentiably (``reduce_on_rank``), else the other
        ranks get None. Finished lanes (``lane_mask``) ship exact-zero
        rows and leave the int8 scale alone, as in ``_aggregate``."""
        grp = self._grp()
        if grp is None:
            return self._aggregate(torch.cat([E_a[None], E_p], dim=0),
                                   round_idx, seeds, lane_mask)[1]
        masks = self.masks_for(tuple(E_p.shape[1:]), round_idx, seeds,
                               rows=self._rows())
        if lane_mask is not None:
            keep = lane_mask.reshape((1, -1) + (1,) * (E_p.dim() - 2))
            E_p = torch.where(keep, E_p, 0)
            if masks is not None:
                masks = torch.where(keep, masks, 0)
            if E_a is not None:
                E_a = torch.where(keep[0], E_a, 0)
        scale = self._round_scale(E_p, E_a, masks)
        blinded = masks is not None
        up = self._blind_own(E_p, masks, scale)

        def agg(u, e_a):
            return self._aggregate_grouped(e_a, u, blinded, scale)

        if not share:
            up = grp.all_gather(up)
            return None if E_a is None else agg(up, E_a)
        ring = blinded and self.easter.mask_mode in blinding.RING_MODES
        return pg.reduce_on_rank(
            agg, grp, 0, E_p.shape[1:],
            torch.float32 if ring else E_p.dtype, pg.gather_rows(up, grp),
            *(() if E_a is None else (E_a,)))

    def train_chunk(self, params, opt_state, batches, step0, opt):
        """``len(batches)`` optimizer steps of ``opt`` (any
        Optimizer-shaped object, ``optim.make_party_optimizers``
        included), step i blinded under the TRAIN round ``step0 + i``;
        ``batches`` stacked as by ``train_loop.stack_batches``. Returns
        (params, opt_state, step0 + N, metrics) with the parameters and
        optimizer state updated in place (``core/train_loop.py``)."""
        from repro_torch.core import train_loop
        return train_loop.train_chunk(
            train_loop.make_train_step(self, opt),
            params, opt_state, batches, step0)

    # -- serving -------------------------------------------------------------
    def init_caches(self, batch: int, cache_len: int,
                    window_override: int = -1, per_lane: bool = False):
        """KV caches for every party on ``self.device``. ``per_lane=True``
        gives each batch row its own position counter (continuous-batching
        decode slots, required whenever ``serve_step`` gets a vector
        pos). On the sharded engine a party another rank holds gets
        ``{}``. Under a sharding plan ``batch`` is this rank's rows: the
        step's caches as ``sharding.fresh_caches`` makes them."""
        plan = sharding.current()
        if plan is not None:
            n = sharding.global_rows(batch)
            return sharding.fresh_caches(
                [transformer.init_cache(pcfg, n, cache_len, window_override,
                                        per_lane, device="meta")
                 for pcfg in self.party_cfgs], n, self.device,
                self.party_cfgs)
        held = self._held()
        return [transformer.init_cache(pcfg, batch, cache_len,
                                       window_override, per_lane,
                                       device=self.device)
                if k in held else {}
                for k, pcfg in enumerate(self.party_cfgs)]

    @torch.no_grad()
    def serve_step(self, params, tokens, caches, pos, seeds,
                   window_override: int = -1, fe_list=None, *,
                   lane_mask=None, nonces=None):
        """One decode round: tokens (B, 1). Returns (active logits,
        caches).

        The decode uplink is blinded like every other round:
        SERVE_DOMAIN + ``pos`` is the round index, or, with per-lane
        ``nonces`` (B,), ``blinding.serve_round(nonce, pos)`` per lane so
        that concurrent lanes never share a pad. ``pos`` may be a (B,)
        tensor (each lane at its own position; caches must then be
        per-lane); ``lane_mask`` (B,) zeroes finished lanes' uplink rows
        (see ``_aggregate``). ``fe_list``: per-party frontend inputs (an
        encoder-decoder's ``{"enc_kv": ...}`` from ``encoder_kv``)."""
        params = sharding.step_view(params, math.prod(tokens.shape))
        fe_list = self._local_fe(fe_list or [{}] * self.C, tokens.shape[0])
        # an int position keeps the PRF round on the host (the dry run's
        # meta tensors hold no value to read it from)
        host_pos = pos if isinstance(pos, int) else None
        pos = torch.as_tensor(pos, dtype=torch.int32, device=self.device)
        if nonces is None:
            round_idx = blinding.SERVE_DOMAIN + (pos if host_pos is None
                                                 else host_pos)
        else:
            round_idx = blinding.serve_round(torch.as_tensor(
                nonces, dtype=torch.int32, device=self.device), pos)
        if lane_mask is not None:
            lane_mask = sharding.local_rows(
                torch.as_tensor(lane_mask, device=self.device))
        po = pos[:, None] if pos.dim() == 1 else pos
        if self._passive_group_ok():
            logits, new_caches = self._serve_grouped(
                params, tokens, caches, po, seeds, window_override,
                round_idx, lane_mask, fe_list)
            return self._gathered(logits), new_caches
        Es, new_caches = [], []
        for k, pcfg in enumerate(self.party_cfgs):
            with sharding.party_scope(k):
                E_k, nc, _ = self.local_embed(
                    params["parties"][k], pcfg, tokens, caches=caches[k],
                    pos_offset=po, window_override=window_override,
                    **fe_list[k])
            Es.append(E_k)
            new_caches.append(nc)
        E_all, E = self._aggregate(torch.stack(Es), round_idx, seeds,
                                   lane_mask)
        logits = self.decide(params["parties"][0], self.party_cfgs[0],
                             E.to(E_all.dtype))
        return self._gathered(logits), new_caches

    @staticmethod
    def _gathered(out):
        """A served embedding or logits, this rank's rows under a plan ->
        every rank's, on every rank (their spec is replicated)."""
        return None if out is None else sharding.batch_gather(out)

    def _local_fe(self, fe_list, rows: int):
        """A step's ``enc_kv`` given whole (its spec is replicated: the
        step's rows, every kv head) -> this rank's ``rows`` under a plan,
        and, where the party's cross-attention splits by heads
        (``sharding.cross_tp``), this rank's Hkv / m heads; an ``enc_kv``
        that ``encoder_kv`` made under the plan (this rank's rows and
        heads already) passes as it is."""
        n = sharding.global_rows(rows)

        def local(t, pcfg):
            if t.shape[1] == n and n != rows:
                t = sharding.local_rows(t, 1)
            tp = sharding.cross_tp(sharding.stack_tp(pcfg, 1))
            if tp is not None and t.shape[-2] == pcfg.n_kv_heads:
                t = tp.block(t, -2)
            return t

        return [{**fe, "enc_kv": tuple(local(t, pcfg)
                                       for t in fe["enc_kv"])}
                if "enc_kv" in fe else fe
                for fe, pcfg in zip(fe_list, self.party_cfgs)]

    def _passive_embed_grouped(self, params, tokens, caches, pos,
                               window_override, fe_list):
        """The K passive parties' embeddings (K, B, S, d) and stacked new
        caches: their token embeddings by one offset gather from the
        stacked tables, then one vmap over the group. Their frontend
        inputs are stacked by ``stack_views``: ``encoder_kv``'s cross K/V
        (views into one tensor) and an input every party shares are read
        in place, not copied."""
        pcfg_p = self.party_cfgs[1]
        sp = self._passive_stack(params)
        rows = self._rows()
        sc = stack_trees([caches[1 + r] for r in rows])
        sfe = stack_views([fe_list[1 + r] for r in rows])
        with sharding.party_scope(1, stacked=True):
            x = sharding.embed_rows(sp["backbone"]["embed"]["table"], tokens,
                                    group=True)

        def one(p, c, x, fe):
            E_k, nc, _ = self._embed_from(p, pcfg_p, x, caches=c,
                                          pos_offset=pos,
                                          window_override=window_override,
                                          **fe)
            return E_k, nc

        # inside the vmap a party's leaves are one party's: party 1's specs
        with sharding.party_scope(1):
            return vmap(one)(sp, sc, x, sfe)

    def _serve_grouped(self, params, tokens, caches, pos, seeds,
                       window_override, round_idx, lane_mask, fe_list, *,
                       decide=True):
        """One serving round (prefill or decode) of the stacked engines: the
        active party on its rank, this rank's passive rows as one vmap
        (``_passive_embed_grouped``), then ``_held_aggregate``. Returns
        (the active party's logits, or E with ``decide=False``, None off
        its rank; this rank's caches, ``{}`` for the parties it does not
        hold)."""
        E_a = nc_a = None
        pcfg_a = self.party_cfgs[0]
        if self._holds_active():
            with sharding.party_scope(0):
                E_a, nc_a, _ = self.local_embed(
                    params["parties"][0], pcfg_a, tokens, caches=caches[0],
                    pos_offset=pos, window_override=window_override,
                    **fe_list[0])
        E_p, nc_p = self._passive_embed_grouped(params, tokens, caches, pos,
                                                window_override, fe_list)
        out = self._held_aggregate(E_a, E_p, round_idx, seeds, lane_mask,
                                   share=False)
        if out is not None and decide:
            out = self.decide(params["parties"][0], pcfg_a, out.to(E_a.dtype))
        rows = self._rows()
        new_caches = [{} if nc_a is None else nc_a] \
            + [{}] * self.easter.num_passive
        for i, c in zip(rows, unstack_tree(nc_p, len(rows))):
            new_caches[1 + i] = c
        return out, new_caches

    @torch.no_grad()
    def prefill(self, params, tokens, caches, window_override: int = -1,
                fe_list=None, seeds=None, round_idx=0):
        """Cache-building forward over the prompt; returns (E, caches).

        The prompt-phase uplink is blinded like every other round under
        PREFILL_DOMAIN + ``round_idx``, a per-request nonce: two prefills
        under one round would reuse the pairwise pads. ``seeds=None`` is
        the unblinded oracle. ``fe_list``: per-party frontend inputs (the
        patch embeddings of a vision model, the cross K/V of an
        encoder-decoder from ``encoder_kv``)."""
        r = blinding.PREFILL_DOMAIN + round_idx
        params = sharding.step_view(params, math.prod(tokens.shape))
        fe_list = self._local_fe(fe_list or [{}] * self.C, tokens.shape[0])
        if self._passive_group_ok():
            E, new_caches = self._serve_grouped(
                params, tokens, caches, 0, seeds, window_override, r, None,
                fe_list, decide=False)
            return self._gathered(E), new_caches
        Es, new_caches = [], []
        for k, pcfg in enumerate(self.party_cfgs):
            with sharding.party_scope(k):
                E_k, nc, _ = self.local_embed(
                    params["parties"][k], pcfg, tokens, caches=caches[k],
                    window_override=window_override, **fe_list[k])
            Es.append(E_k)
            new_caches.append(nc)
        _, E = self._aggregate(torch.stack(Es), r, seeds)
        return self._gathered(E), new_caches

    @torch.no_grad()
    def encoder_kv(self, params, audio_embed):
        """An encoder-decoder's per-party cross-attention K/V for one
        request set's frame embeddings (B, F, d): the reference's
        ``fe_list``, ``[{"enc_kv": (k, v)}, ...]``, each (n_layers, B, F,
        Hkv, hd), computed once and passed to ``prefill`` and every
        ``serve_step``. On the vectorized engine the passive group's
        encoders run at once and its entries are views into one (K,
        n_layers, ...) tensor laid out layer-major
        (``transformer._encoder_kv(group=True)``). Under a plan
        ``audio_embed`` is this rank's rows, and so is each ``enc_kv``;
        where a party's cross-attention splits by heads over "model" its
        ``enc_kv`` holds this rank's Hkv / m heads (the encoder and the
        cross K/V computed split), and the steps take it as it is
        (``_local_fe``)."""
        audio_embed = torch.as_tensor(audio_embed, device=self.device)
        params = sharding.step_view(params, 0)

        def one_kv(bp, pcfg, k, group=False):
            with sharding.party_scope(k, stacked=group):
                enc = transformer.encode(bp, audio_embed, pcfg, group=group)
                return transformer._encoder_kv(bp, enc, pcfg, group=group)

        if not self._passive_group_ok():
            return [{"enc_kv": one_kv(params["parties"][k]["backbone"], pcfg,
                                      k)}
                    for k, pcfg in enumerate(self.party_cfgs)]
        active = ({"enc_kv": one_kv(params["parties"][0]["backbone"],
                                    self.party_cfgs[0], 0)}
                  if self._holds_active() else {})
        k_p, v_p = one_kv(self._passive_stack(params)["backbone"],
                          self.party_cfgs[1], 1, group=True)
        out = [active] + [{}] * self.easter.num_passive
        for i, r in enumerate(self._rows()):
            out[1 + r] = {"enc_kv": (k_p[i], v_p[i])}
        return out
