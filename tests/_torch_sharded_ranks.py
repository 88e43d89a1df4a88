"""The rank side of tests/test_torch_sharded.py: every case of the sharded
engine, run inside one spawned 4-rank gloo group on the CPU. Imports no
JAX (the ranks are separate processes); each rank returns numpy."""
import numpy as np
import torch

from repro_torch.configs.base import (EasterConfig, get_config,
                                      smoke_variant)
from repro_torch.core import blinding, train_loop
from repro_torch.core.easter_lm import EasterLM
from repro_torch.core.party_models import PartyArch
from repro_torch.core.protocol import EasterClassifier
from repro_torch.core import party_group as pg
from repro_torch.launch import mesh
from repro_torch.tree import tree_leaves, tree_unflatten

D_EMBED, N_CLS, B = 24, 5, 6
# the classifier cases: (mask mode, masked, grad mode)
CLS_CASES = (("float", True, "easter"), ("float", False, "easter"),
             ("int32", True, "easter"), ("int32", False, "easter"),
             ("int8", True, "easter"), ("float", True, "joint"))
MASK_ROUNDS = (0, 3)


def classifier(engine, mask_mode="float", C=8, grad_mode="easter",
               group=None):
    """Two MLP signatures, alternating: two groups of C/2 parties (4 each
    at C = 8, one row a rank over 4 ranks; 3 each at C = 6, replicated)."""
    arches = [PartyArch("mlp", (32, 16) if k % 2 == 0 else (48,), (16,),
                        D_EMBED, N_CLS) for k in range(C)]
    e = EasterConfig(num_passive=C - 1, d_embed=D_EMBED, mask_mode=mask_mode)
    return EasterClassifier(e, arches, [10] * C, engine=engine,
                            grad_mode=grad_mode, device="cpu", group=group)


def cls_batch(C, seed):
    rng = np.random.default_rng(seed)
    xs = [torch.from_numpy(rng.normal(size=(B, 10)).astype(np.float32))
          for _ in range(C)]
    return xs, torch.from_numpy(rng.integers(0, N_CLS, B))


def cls_params(sys, seed):
    return sys.init_params(torch.Generator().manual_seed(seed))


def cls_loss_grads(sys, params, xs, y, masks):
    """(total, per, grads as a per-party tree) of one round."""
    leaves = tree_leaves(params)
    total, per = sys.loss_fn(params, xs, y, masks)
    g = torch.autograd.grad(total, leaves, allow_unused=True,
                            materialize_grads=True)
    return total.detach(), per.detach(), tree_unflatten(params, g)


def lm(engine, K=4, group=None):
    cfg = smoke_variant(get_config("qwen2.5-3b"))
    e = EasterConfig(num_passive=K, d_embed=64, decision_layers=1)
    return EasterLM(cfg=cfg, easter=e, engine=engine, device="cpu",
                    group=group)


def lm_batch(V):
    rng = np.random.default_rng(13)
    return {"tokens": torch.from_numpy(
                rng.integers(0, V, (2, 16)).astype(np.int32)),
            "labels": torch.from_numpy(rng.integers(0, V, (2, 16)))}


def lm_serve(sys, params, blinded):
    """A 7-token prefill (round 3) and one decode round: (E, logits,
    caches); E and logits None off the active party's rank."""
    B_, S = 2, 8
    toks = torch.from_numpy(np.random.default_rng(15).integers(
        0, sys.cfg.vocab_size, (B_, S)).astype(np.int32))
    seeds = sys.mask_seeds() if blinded else None
    c = sys.init_caches(B_, S)
    E, c = sys.prefill(params, toks[:, :S - 1], c, seeds=seeds, round_idx=3)
    lg, c = sys.serve_step(params, toks[:, S - 1:], c, S - 1, seeds)
    return E, lg, c


def _np(t):
    return None if t is None else t.detach().numpy()


class Recorder:
    """Wraps the group's collectives on this rank: (op, payload) for every
    call; the payload is read after the call: what this rank sent for a
    gather, what arrived for a broadcast or a reduction."""

    def __init__(self):
        self.calls = []
        self._orig = {}

    def __enter__(self):
        for name in ("all_gather", "all_reduce", "broadcast"):
            orig = getattr(pg.PartyGroup, name)
            self._orig[name] = orig

            def wrapped(grp, x, *a, _n=name, _o=orig, **k):
                out = _o(grp, x, *a, **k)
                self.calls.append((_n, x.detach().clone().numpy()))
                return out

            setattr(pg.PartyGroup, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(pg.PartyGroup, name, orig)


def run_cases():
    grp = mesh.make_party_group(device="cpu")
    out = {"rank": grp.rank, "cls": {}}
    for mode, masked, gm in CLS_CASES:
        ss = classifier("sharded", mode, grad_mode=gm, group=grp)
        params = cls_params(ss, 1)
        xs, y = cls_batch(8, 0)
        total, per, g = cls_loss_grads(ss, params, xs, y,
                                       ss.masks(B, 0) if masked else None)
        out["cls"][(mode, masked, gm)] = (
            _np(total), _np(per), pg.gather_tree(grp, g),
            ss._eng._sharded(4))

    # forward and assisted (raw steps)
    ss = classifier("sharded", group=grp)
    params = cls_params(ss, 2)
    xs, y = cls_batch(8, 3)
    with torch.no_grad():
        E_all = ss.local_embeds(params, xs)
    ga, La = ss.assisted_grads(params, xs, y, None)
    out["assisted"] = (_np(E_all), _np(La), pg.gather_tree(grp, ga))

    # one adam train step
    ss = classifier("sharded", group=grp)
    params = cls_params(ss, 4)
    xs, y = cls_batch(8, 5)
    init, step = ss.make_train_step("adam", 1e-3)
    params, _, total, per = step(params, init(params), xs, y, ss.masks(B, 0))
    out["train"] = (_np(total), _np(per), pg.gather_tree(grp, params))

    # C = 6: groups of 3 do not divide over 4 ranks, so they run replicated
    su = classifier("sharded", C=6, group=grp)
    params = cls_params(su, 6)
    xs, y = cls_batch(6, 7)
    with torch.no_grad():
        total, per = su.loss_fn(params, xs, y, su.masks(B, 1))
    out["uneven"] = (_np(total), _np(per), su._eng._sharded(3),
                     su._eng.held())

    # per-rank mask synthesis: this rank's rows only
    out["masks"] = {
        (K, mode, r): (list(grp.rows(K)), blinding.cached_mask_engine(
            K, 7).masks((B, D_EMBED), r, mode, device="cpu",
                        group=grp).numpy())
        for K in (8, 5) for mode in ("float", "int32") for r in MASK_ROUNDS}

    # the uplink audit: every collective of one masked float round
    ss = classifier("sharded", group=grp)
    params = cls_params(ss, 10)
    xs, y = cls_batch(8, 11)
    masks = ss.masks(B, 2)
    with Recorder() as rec, torch.no_grad():
        total, _ = ss.loss_fn(params, xs, y, masks)
    with torch.no_grad():
        _, up = ss._eng.embed_blind_uplink(params, xs, masks, "float")
    out["audit"] = (rec.calls, _np(up), ss._eng._own, _np(total))

    # the LM, K = 4 over 4 ranks
    s = lm("sharded", group=grp)
    params = s.init_params(torch.Generator().manual_seed(12))
    b = lm_batch(s.cfg.vocab_size)
    lm_out = {"shard_ok": s._shard_ok()}
    for tag, seeds in (("masked", s.mask_seeds()), ("raw", None)):
        with torch.no_grad():
            total, per = s.loss_fn(params, b, 0, seeds)
        lm_out[tag] = (_np(total), _np(per))
    _, _, g = train_loop.loss_and_grads(s, params, b, 0, s.mask_seeds())
    lm_out["grads"] = pg.gather_tree(grp, g)
    for blinded in (True, False):
        E, lg, c = lm_serve(s, params, blinded)
        lm_out[("serve", blinded)] = (_np(E), _np(lg),
                                      pg.gather_tree(grp, c))
    out["lm"] = lm_out

    # K = 3 over 4 ranks: replicated
    s3 = lm("sharded", K=3, group=grp)
    params = s3.init_params(torch.Generator().manual_seed(16))
    with torch.no_grad():
        total, _ = s3.loss_fn(params, lm_batch(s3.cfg.vocab_size), 0,
                              s3.mask_seeds())
    out["lm3"] = (s3._shard_ok(), _np(total))
    return out
