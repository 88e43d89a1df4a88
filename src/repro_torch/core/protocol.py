"""EASTER training protocol (paper Alg. 1), paper-scale, in PyTorch.

Counterpart of ``repro.core.protocol``. One round (C = K+1 parties,
party 0 = active):
  1. every party computes its local embedding E_k = h(theta_k, D_k);
     passive parties blind: [E_k] = E_k + r_k                      (lines 2-5)
  2. active aggregates the global embedding E = (1/C)(E_a + sum [E_k]) (l. 6)
  3. every party predicts R_k = p(theta_k, E)                      (lines 7-10)
  4. active computes L_k = LF(R_k, Y) and each party's loss signal (11-12)
  5. every party updates its own model with ITS OWN loss gradient  (13-15)

Gradient semantics (Alg. 1, line 14): party k's embedding net sees only
the global embedding's dependence on E_k. One backward pass gives every
party's paper gradient through the surrogate

    E_for_k = E.detach() - E_k.detach() / C + E_k / C      (value == E)

``grad_mode="joint"`` (beyond-paper) lets every loss reach every embedding
net, through the aggregation's own backward. ``assisted_grads`` is the
message-passing form of the same round (explicit per-party pullbacks).

Engines: ``engine="vectorized"`` (the default, as in the reference) groups
parties by (arch, slice width) and runs each step as one ``vmap`` per
group (``core/party_engine.py``), with MaskEngine masks; ``engine="loop"``
is the reference's per-party loop with the loop-oracle masks.
``engine="sharded"`` runs the vectorized groups over a party group of
``torch.distributed`` ranks (``group``, a ``party_group.PartyGroup``;
None joins the launcher's, ``mesh.make_party_group()``): each rank holds
and runs its own rows of every group that divides over the ranks, makes
only its own parties' masks, blinds them in place, and the gather of that
uplink is the only collective that carries embeddings; the active
party's rank aggregates and broadcasts E. Losses and predictions come
back on every rank. As in the reference it takes no ``compress_frac``
and no ``fused_masks``.

``compress_frac`` > 0 (beyond-paper, C_VFL style) top-k sparsifies the
passive parties' uplink embeddings after the embedding, with
straight-through gradients (``baselines._topk_sparsify``), on both
engines; the float wire then ships values + indices. A ring wire rejects
it: its masks are dense, so a sparse uplink saves no bytes.

Wires: ``mask_mode`` "float" aggregates through the blind+aggregate
kernel; ``fused_masks=True`` (float mode, vectorized engine) makes the
masks inside that kernel from the seed tables and the round, so no mask
tensor exists; "int32" and "int8" are the ring wires
(``aggregation.aggregate_ring``).

The classifier runs on the card unless ``device`` says otherwise:
``device=None`` resolves to CUDA and raises when no GPU is present. Its
masked float aggregation always runs the kernels there (the reference's
``use_kernel=True``); CPU tensors take the kernels' plain versions, so the
reference's switch has no counterpart.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List

import torch
from torch.func import vmap

from repro_torch.configs.base import EasterConfig
from repro_torch.core import aggregation, baselines, blinding, losses
from repro_torch.core.party_engine import PartyEngine
from repro_torch.core.party_models import (PartyArch, decide_fn, embed_fn,
                                           init_party)
from repro_torch.device import resolve_device
from repro_torch.optim import resolve_party_optimizers
from repro_torch.tree import tree_leaves, tree_unflatten


@dataclass
class EasterClassifier:
    """Paper-scale EASTER system over vertically-split features."""
    easter: EasterConfig
    arches: List[PartyArch]             # C entries; [0] = active party
    n_features: List[int]               # per-party vertical feature split
    loss: str = "ce"
    grad_mode: str = "easter"           # easter (paper) | joint (beyond)
    # vectorized (grouped vmap) | sharded (the groups over a party group
    # of ranks) | loop
    engine: str = "vectorized"
    # make the masks inside the blind+aggregate kernel (float mode,
    # vectorized engine); CPU tensors take MaskEngine masks
    fused_masks: bool = False
    compress_frac: float = 0.0          # top-k uplink keep fraction
    device: Any = None                  # None = the card
    # engine="sharded": the ranks' party group (party_group.PartyGroup);
    # None joins the launcher's group. Its device is the default device.
    group: Any = None

    def __post_init__(self):
        if len(self.arches) != len(self.n_features):
            raise ValueError(f"{len(self.arches)} arches but "
                             f"{len(self.n_features)} feature slices")
        if self.grad_mode not in ("easter", "joint"):
            raise ValueError(f"grad_mode {self.grad_mode!r}")
        if self.engine not in ("vectorized", "sharded", "loop"):
            raise ValueError(f"engine {self.engine!r}")
        if self.engine == "sharded":
            if self.compress_frac > 0:
                raise ValueError("top-k uplink compression needs the "
                                 "gathered raw stack: not available under "
                                 "the sharded engine")
            if self.fused_masks:
                raise ValueError("fused mask synthesis requires the "
                                 "vectorized engine")
            if self.group is None:
                from repro_torch.launch.mesh import make_party_group
                self.group = make_party_group(device=self.device)
            if self.device is None:
                self.device = self.group.device
        if self.easter.mask_mode not in ("float",) + blinding.RING_MODES:
            raise ValueError(f"mask_mode {self.easter.mask_mode!r}")
        if self.compress_frac > 0 and self.easter.mask_mode in \
                blinding.RING_MODES:
            raise ValueError("compress_frac has no wire benefit under ring "
                             "masking")
        if self.fused_masks and self.easter.mask_mode != "float":
            raise ValueError("fused (in-kernel) mask synthesis is float-mode "
                             "only")
        if self.fused_masks and self.engine != "vectorized":
            raise ValueError("fused mask synthesis requires the vectorized "
                             "engine")
        self.device = resolve_device(self.device)
        self.C = len(self.arches)
        self.K = self.C - 1
        self._eng = PartyEngine(
            self.arches, self.n_features,
            group=self.group if self.engine == "sharded" else None)
        if self.K > 1:
            # memoized DH ceremony, the same federation as the reference's
            self.keys, self.seeds = blinding.cached_passive_setup(self.K, 7)
            self.mask_engine = blinding.cached_mask_engine(self.K, 7)
        else:
            self.keys, self.seeds = [], {}
            self.mask_engine = None

    # -- params ------------------------------------------------------------
    def init_params(self, gen: torch.Generator) -> List[dict]:
        """Per-party {"embed": ..., "decide": ...} trees on ``self.device``,
        drawn from a CPU ``torch.Generator``; leaves require grad. On the
        sharded engine every rank draws every party, in order (the same
        bits as one process), and keeps its own (``held_params``)."""
        params = self.held_params(
            [init_party(gen, self.arches[k], self.n_features[k],
                        self.device) for k in range(self.C)])
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        return params

    def held_params(self, params: List[Any]) -> List[Any]:
        """A per-party list with the parties this rank does not hold (the
        sharded engine) replaced by ``{}``; other engines: unchanged."""
        if self.engine != "sharded":
            return list(params)
        held = set(self._eng.held())
        return [p if k in held else {} for k, p in enumerate(params)]

    # -- protocol steps ----------------------------------------------------
    def masks(self, batch: int, round_idx: int = 0):
        """Per-round masks: a (K, B, d) tensor (MaskEngine on the
        vectorized engine, the loop oracle on the loop engine), or a
        FusedMasks marker when the kernel makes them."""
        if self.K < 2 or not self.easter.enabled:
            return None
        r = round_idx if self.easter.fresh_masks else 0
        if self.fused_masks:
            return blinding.FusedMasks(int(r))
        shape = (batch, self.easter.d_embed)
        if self.engine == "vectorized":
            return self.mask_engine.masks(shape, r, self.easter.mask_mode,
                                          device=self.device)
        if self.engine == "sharded":
            # this rank's passive parties' rows only
            return self.mask_engine.masks(
                shape, r, self.easter.mask_mode, device=self.device,
                rows=[k - 1 for k in self._eng.passive_held()])
        return blinding.all_party_masks(self.K, self.seeds, shape, r,
                                        self.easter.mask_mode,
                                        device=self.device)

    def local_embeds(self, params, xs) -> torch.Tensor:
        """(C, B, d_embed) local embeddings, party order; the passive rows
        top-k sparsified when ``compress_frac`` > 0."""
        if self.engine != "loop":
            E_all = self._eng.embed_all(params, xs)
        else:
            E_all = torch.stack([embed_fn(params[k], self.arches[k], xs[k])
                                 for k in range(self.C)])
        if self.compress_frac > 0:
            # passive parties compress their uplink (active stays local)
            E_all = torch.cat([E_all[:1], baselines._topk_sparsify(
                E_all[1:], self.compress_frac)], dim=0)
        return E_all

    def global_embed(self, E_all: torch.Tensor, masks) -> torch.Tensor:
        """Masked aggregation: in-kernel masks for a FusedMasks marker, the
        ring sum on the int32/int8 wires, else the blind+aggregate kernel
        (the plain versions for CPU tensors); the plain mean without
        masks."""
        if isinstance(masks, blinding.FusedMasks):
            return aggregation.blind_and_aggregate_fused(
                E_all, self.mask_engine, masks.round_idx)
        if masks is not None and self.easter.mask_mode in blinding.RING_MODES:
            return aggregation.aggregate_ring(E_all, masks,
                                              self.easter.mask_mode)
        return aggregation.blind_and_aggregate(E_all, masks)

    def _per_party_E(self, E: torch.Tensor, E_all) -> torch.Tensor:
        """(C, B, d): the per-party view E_for_k of the global embedding."""
        if self.grad_mode == "easter" and E_all is not None:
            return (E.detach()[None] - E_all.detach() / self.C
                    + E_all / self.C)
        return E[None].expand((self.C,) + tuple(E.shape))

    def _predictions_stacked(self, params, E, E_all=None) -> torch.Tensor:
        """(C, B, n_classes) logits, party order."""
        E_for = self._per_party_E(E, E_all)
        if self.engine != "loop":
            return self._eng.decide_all(params, E_for)
        return torch.stack([decide_fn(params[k], self.arches[k], E_for[k])
                            for k in range(self.C)])

    def predictions(self, params, E: torch.Tensor, E_all=None) -> List:
        """R_k = p(theta_k, E_for_k) for every party (paper grad masking)."""
        R = self._predictions_stacked(params, E, E_all)
        return [R[k] for k in range(self.C)]

    def forward(self, params, xs, masks=None):
        E_all = self.local_embeds(params, xs)
        E = self.global_embed(E_all, masks)
        R = self.predictions(params, E, E_all)
        return E, R

    def loss_fn(self, params, xs, y, masks=None):
        """Total (sum over parties) + per-party losses."""
        if self.engine == "sharded":
            return self._loss_fn_sharded(params, xs, y, masks)
        E_all = self.local_embeds(params, xs)
        E = self.global_embed(E_all, masks)
        R_all = self._predictions_stacked(params, E, E_all)
        lf = losses.LOSSES[self.loss]
        if self.engine == "vectorized":
            per = vmap(lambda r: lf(r, y))(R_all)
        else:
            per = torch.stack([lf(R_all[k], y) for k in range(self.C)])
        return torch.sum(per), per

    def _loss_fn_sharded(self, params, xs, y, masks=None):
        """The training round over the party group. What crosses ranks:
        the gather of the blinded uplink (the active party's row zero),
        the broadcast of the global embedding the active party aggregated
        on its rank (paper line 6), the gathered predictions, and on the
        int8 wire one max |E| scalar. Raw embeddings stay on their rank:
        the stop-gradient surrogate is applied to each rank's own rows.
        ``masks``: this rank's rows (``masks``), or the full (K, B, d)
        tensor, whose own rows are taken. The aggregate replays
        ``global_embed``'s op order, so the forward equals the vectorized
        engine's bit for bit."""
        mode = self.easter.mask_mode
        if masks is not None and masks.shape[0] == self.K:
            masks = masks[[k - 1 for k in self._eng.passive_held()]]
        scale = None
        if masks is not None and mode == "int8":
            E_parts, up, scale = self._eng.embed_blind_uplink_scaled(
                params, xs, masks, "int8")
        else:
            E_parts, up = self._eng.embed_blind_uplink(params, xs, masks,
                                                       mode)
        if masks is None:
            E = torch.mean(up, dim=0)
        elif mode == "int8":
            E = self._eng.aggregate_via_active(
                E_parts, up, lambda u, e_a: aggregation.aggregate_int8_blinded(
                    torch.cat([blinding.quantize_ring(e_a, "int8",
                                                      scale)[None], u[1:]]),
                    scale))
        elif mode == "int32":
            E = self._eng.aggregate_via_active(
                E_parts, up, lambda u, e_a: aggregation.aggregate_int32_blinded(
                    torch.cat([blinding.quantize(e_a)[None], u[1:]])))
        else:
            E = self._eng.aggregate_via_active(
                E_parts, up, lambda u, e_a: aggregation.aggregate(e_a, u[1:]),
                dtype=E_parts[0].dtype)
        C = self.C
        if self.grad_mode == "easter":
            def view(e_glob, e_loc):
                return (e_glob.detach()[None] - e_loc.detach() / C
                        + e_loc / C)
        else:
            def view(e_glob, e_loc):
                return e_glob[None].expand(e_loc.shape)
        R_all = self._eng.decide_from(params, E_parts, E, view)
        lf = losses.LOSSES[self.loss]
        per = vmap(lambda r: lf(r, y))(R_all)
        return torch.sum(per), per

    # -- assisted-gradient reference path (message passing) ----------------
    def assisted_grads(self, params, xs, y, masks=None):
        """Paper's explicit protocol: per-party pullbacks with active-party
        loss assist. Returns (grads list, per-party losses); on the
        sharded engine a party another rank holds gets ``{}``."""
        if self.engine != "loop":
            return self._assisted_grads_vectorized(params, xs, y, masks)
        lf = losses.LOSSES[self.loss]
        # step 1: local embeddings, each party keeps its own graph
        Es = [embed_fn(params[k], self.arches[k], xs[k])
              for k in range(self.C)]
        # step 2: active party aggregates (masks cancel)
        with torch.no_grad():
            E = self.global_embed(torch.stack(Es), masks)
        grads, per_losses = [], []
        for k in range(self.C):
            # step 3: party k predicts from the global embedding
            E_in = E.detach().requires_grad_(True)
            R_k = decide_fn(params[k], self.arches[k], E_in)
            # step 4: ACTIVE party computes the loss signal dL_k/dR_k
            L_k = lf(R_k, y)
            (gR_k,) = torch.autograd.grad(L_k, R_k, retain_graph=True)
            # step 5: party k backprops its decision net; receives dL_k/dE
            dec_leaves = tree_leaves(params[k]["decide"])
            *g_dec, gE = torch.autograd.grad(R_k, dec_leaves + [E_in],
                                             grad_outputs=gR_k)
            # step 6: embedding-net grad via dE/dE_k = 1/C (mean aggregation)
            g_emb = torch.autograd.grad(Es[k], tree_leaves(params[k]["embed"]),
                                        grad_outputs=gE / self.C)
            grads.append({"embed": tree_unflatten(params[k]["embed"], g_emb),
                          "decide": tree_unflatten(params[k]["decide"], g_dec)})
            per_losses.append(L_k.detach())
        return grads, torch.stack(per_losses)

    def _assisted_grads_vectorized(self, params, xs, y, masks=None):
        """The same message passing, one pullback per party group."""
        lf = losses.LOSSES[self.loss]
        # step 1: local embeddings with group-level pullbacks
        E_all, pull_embed = self._eng.embed_vjp(params, xs)
        # step 2: active party aggregates (masks cancel)
        with torch.no_grad():
            E = self.global_embed(E_all, masks)
        # step 3: every party predicts from the global embedding
        E_b = E[None].expand((self.C,) + tuple(E.shape))
        R_all, pull_dec = self._eng.decide_vjp(params, E_b)
        # step 4: ACTIVE party computes every loss signal dL_k/dR_k at once
        R_in = R_all.requires_grad_(True)
        L_all = vmap(lambda r: lf(r, y))(R_in)
        (gR_all,) = torch.autograd.grad(L_all.sum(), R_in)
        # step 5: decision-net backprop; each party receives its dL_k/dE
        g_dec, gE_all = pull_dec(gR_all)
        # step 6: embedding-net grads via dE/dE_k = 1/C (mean aggregation)
        g_emb = pull_embed(gE_all / self.C)
        held = set(self._eng.held())
        grads = [{"embed": g_emb[k], "decide": g_dec[k]} if k in held
                 else {} for k in range(self.C)]
        return grads, L_all.detach()

    # -- training ----------------------------------------------------------
    def make_train_step(self, optimizer_name: str, lr: float, *,
                        party_optimizers=None, **opt_kw):
        """(init_opt, step) for one protocol round + update.

        ``party_optimizers`` (paper §IV-E): ``{party: (name, lr, hparams)}``;
        unlisted parties use ``(optimizer_name, lr, opt_kw)``. ``step``
        updates params and optimizer state in place and returns
        ``(params, opt_state, total, per)`` with the losses detached. The
        vectorized engine updates one stacked subgroup per (execution
        group, optimizer) (``PartyEngine.update_groups``); the loop engine
        loops over parties. A leaf no loss reaches (the embedding nets in
        joint mode on a ring wire, whose quantized aggregate carries no
        gradient) gets a zero gradient, as ``jax.grad`` gives it."""
        default = (optimizer_name, lr, opt_kw)
        opts = resolve_party_optimizers(party_optimizers or {}, self.C,
                                        default=default)

        def init_opt(params):
            # a party another rank holds ({}) has no state here
            return [opts[k].init(p) if tree_leaves(p) else {}
                    for k, p in enumerate(params)]

        def step(params, opt_state, xs, y, masks):
            total, per = self.loss_fn(params, xs, y, masks)
            flat = tree_leaves(params)
            grads = tree_unflatten(params, torch.autograd.grad(
                total, flat, allow_unused=True, materialize_grads=True))
            if self.engine != "loop":
                self._eng.update_groups(opts, grads, opt_state, params)
            else:
                for k in range(self.C):
                    opts[k].update(grads[k], opt_state[k], params[k])
            return params, opt_state, total.detach(), per.detach()

        return init_opt, step

    def bytes_per_round(self, batch: int) -> int:
        """Wire bytes per training round (paper Table V accounting):
        blinded embeddings up + global embedding down + predictions up +
        loss signal down. Bytes per element follow the wire
        (``blinding.wire_leg_bytes``): 4 on the float and int32 wires; the
        int8 wire packs 4 ring elements per int32 word plus one float32
        scale per leg, on all four legs. A compressed float uplink ships
        values + indices (ring masks are dense: no ring wire compresses)."""
        d_e = self.easter.d_embed
        n_cls = self.arches[0].n_classes
        mode = self.easter.mask_mode
        up_e = self.K * blinding.wire_leg_bytes(batch * d_e, mode)
        if self.compress_frac > 0 and mode not in blinding.RING_MODES:
            up_e = int(self.K * batch * d_e * 4 * self.compress_frac * 2)
        down_e = self.K * blinding.wire_leg_bytes(batch * d_e, mode)
        up_r = self.K * blinding.wire_leg_bytes(batch * n_cls, mode)
        down_l = self.K * blinding.wire_leg_bytes(batch * n_cls, mode)
        return up_e + down_e + up_r + down_l

    @torch.no_grad()
    def accuracy(self, params, xs, y) -> torch.Tensor:
        """Per-party test accuracy (the paper's theta_1..theta_C columns).
        Aggregates unblinded (plain mean), so it launches no kernel."""
        E_all = self.local_embeds(params, xs)
        E = self.global_embed(E_all, None)
        R_all = self._predictions_stacked(params, E, E_all)
        return torch.mean((torch.argmax(R_all, -1) == y[None]).float(),
                          dim=-1)


def split_features(x: torch.Tensor, C: int) -> List[torch.Tensor]:
    """Vertical split: feature dim into C near-equal slices (paper §V-A)."""
    F = x.shape[-1]
    sizes = [F // C + (1 if i < F % C else 0) for i in range(C)]
    out, off = [], 0
    for s in sizes:
        out.append(x[..., off:off + s])
        off += s
    return out
