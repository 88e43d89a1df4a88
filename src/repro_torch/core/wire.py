"""Multi-process EASTER deployment: parties as separate OS processes.

Counterpart of ``repro.core.wire``. In an actual VFL deployment the
parties are separate *trust domains*: this module runs each passive party
in its own process, exchanging ONLY the protocol messages of Alg. 1 over
pipes (public keys, blinded embeddings, predictions, loss signals). The
active party never receives raw embeddings or features.

    from repro_torch.core.wire import WireEaster
    sys = WireEaster(arches, n_features, n_classes)
    sys.start(); sys.round(xs, y, 0); sys.stop()

With ``mask_mode="int8"`` every embedding-/logit-shaped leg ships as
packed Z_2^8 ring words (4 bytes of payload per int32 word + one fp32
scale): the blinded uplink is agreed under a per-round dynamic scale via
a two-phase exchange (each party reveals only the SCALAR max|E_k|, the
active party broadcasts the resulting scale, parties reply with
quantized+masked words), and the downlink / prediction / loss-grad legs
are plain dynamic-int8 codecs with a per-leg scale in the frame.

Only numpy arrays and Python scalars cross a pipe, never tensors (a
tensor would go through torch's own IPC, not the wire). Each party runs
on ``device`` (``None`` = the card; a child told ``"cpu"`` never touches
CUDA). Every receive of the orchestrator waits at most ``RECV_TIMEOUT_S``
and raises naming the party and the message; a child that fails sends
its traceback, which the orchestrator raises.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import traceback
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.core import aggregation, blinding
from repro_torch.core.losses import softmax_xent
from repro_torch.core.party_models import decide_fn, embed_fn, init_party
from repro_torch.device import resolve_device
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves, tree_unflatten

# longest wait for one reply; the first covers a child's start (torch
# import, CUDA context)
RECV_TIMEOUT_S = 120.0
EVAL_ROUND = 10 ** 6                   # the PRF round of ``evaluate``


def _encode_leg(x) -> Tuple[np.ndarray, tuple, float]:
    """Frame one unmasked wire leg as packed int8 ring words + scale.

    Single-sender legs (C=1 in the ring_scale headroom), so the round
    can never wrap; the clip is a guard, not a semantic."""
    x = np.asarray(x, np.float32)
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = float(blinding.ring_scale(amax, 1, "int8"))
    q = np.clip(np.round(x * scale), -127, 127).astype(np.int8)
    return blinding.pack_int8_words(q), x.shape, scale


def _decode_leg(words, shape, scale: float) -> np.ndarray:
    q = blinding.unpack_int8_words(np.asarray(words), shape)
    return q.astype(np.float32) / np.float32(scale)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _party_params(init, gen_seed: int, arch, n_features: int, device):
    """A party's tree on ``device``, leaves requiring grad: ``init`` (a
    numpy tree) when given, else drawn from ``torch.Generator`` seeded as
    the reference seeds its key."""
    if init is not None:
        return checkpoint.params_from_numpy(init, device)
    params = init_party(torch.Generator().manual_seed(gen_seed), arch,
                        n_features, device)
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    return params


def _passive_party_main(conn, party_idx: int, arch_bytes, n_features: int,
                        lr: float, seed: int, mask_mode: str = "float",
                        device: str = "cpu", init=None):
    """Subprocess entry: owns its features' model + secret key. Speaks only
    the wire protocol; raw data and parameters never leave this process.
    ``init`` (the party's initial numpy tree) comes with the spawn
    arguments, beside the seed and arch: the test's and the launcher's
    channel, not a message of the protocol."""
    try:
        _serve_passive(conn, party_idx, arch_bytes, n_features, lr, seed,
                       mask_mode, device, init)
    except Exception:                  # report, then end the process
        conn.send(("error", traceback.format_exc()))


def _serve_passive(conn, party_idx, arch_bytes, n_features, lr, seed,
                   mask_mode, device, init):
    arch = pickle.loads(arch_bytes)
    dev = torch.device(device)
    params = _party_params(init, seed, arch, n_features, dev)
    emb_leaves = tree_leaves(params["embed"])
    dec_leaves = tree_leaves(params["decide"])
    opt = make_optimizer("adam", lr)
    opt_state = opt.init(params)
    kp = blinding.keygen(_test_seed=seed * 977 + 13)
    pair_seeds: Dict[int, int] = {}
    my_idx = party_idx            # index among passive parties (0-based)
    C = None
    # the autograd graphs kept between messages (the reference's vjps)
    state = {"E": None, "R": None, "Eg": None, "round": 0}

    def embed(x_np):
        state["E"] = embed_fn(params, arch, torch.from_numpy(x_np).to(dev))
        return state["E"]

    while True:
        msg = conn.recv()
        cmd = msg[0]
        if cmd == "pubkey":
            conn.send(("pubkey", kp.pk))
        elif cmd == "setup":
            _, other_pks, C = msg
            for j, pk in other_pks.items():
                pair_seeds[j] = blinding.prf_seed(
                    blinding.shared_key(kp.sk, pk))
        elif cmd == "embed":
            _, x_np, round_idx = msg
            E = embed(x_np).detach()
            mask = torch.zeros_like(E)
            for j, seed_j in pair_seeds.items():
                # both ends of a pair derive the identical array, so the
                # masks cancel across trust domains
                m = blinding.pair_mask(seed_j, E.shape, round_idx,
                                       device=dev)
                mask = mask + (m if my_idx < j else -m)
            conn.send(("blinded_embed", _host(E + mask)))
        elif cmd == "embed_amax":
            # int8 phase 1: embed locally, reveal ONLY the scalar
            # max|E_k| so the active party can agree the round's scale
            _, x_np, round_idx = msg
            E = embed(x_np)
            state["round"] = round_idx
            conn.send(("amax", float(torch.max(torch.abs(E.detach())))))
        elif cmd == "embed_q":
            # int8 phase 2: quantize under the broadcast scale, add the
            # int8 ring masks, ship packed words (THE wire payload)
            _, scale = msg
            E = state["E"].detach()
            q = _host(blinding.quantize_ring(E, "int8", scale)).astype(
                np.int64)
            for j, seed_j in pair_seeds.items():
                m = _host(blinding.pair_mask(seed_j, E.shape, state["round"],
                                             "int8", device=dev)
                          ).astype(np.int64)
                q = q + (m if my_idx < j else -m)
            words = blinding.pack_int8_words(q.astype(np.int8))
            conn.send(("blinded_embed_q", words, tuple(E.shape)))
        elif cmd == "predict":
            if mask_mode == "int8":
                _, words, shape, scale = msg
                E_glob_np = _decode_leg(words, shape, scale)
            else:
                _, E_glob_np = msg
            Eg = torch.from_numpy(E_glob_np).to(dev).requires_grad_(True)
            R = decide_fn(params, arch, Eg)
            state["R"], state["Eg"] = R, Eg
            if mask_mode == "int8":
                conn.send(("prediction_q",) + _encode_leg(_host(R)))
            else:
                conn.send(("prediction", _host(R)))
        elif cmd == "grad":
            # active party's loss assist: dL_k/dR_k
            if mask_mode == "int8":
                _, words, shape, scale = msg
                gR_np = _decode_leg(words, shape, scale)
            else:
                _, gR_np = msg
            gR = torch.from_numpy(gR_np).to(dev)
            *g_dec, gE = torch.autograd.grad(
                state["R"], dec_leaves + [state["Eg"]], gR)
            g_emb = torch.autograd.grad(state["E"], emb_leaves, gE / C)
            # each leaf's gradient comes from the one pullback reaching it
            grads = {"embed": tree_unflatten(params["embed"], g_emb),
                     "decide": tree_unflatten(params["decide"], g_dec)}
            opt.update(grads, opt_state, params)
            state.update(E=None, R=None, Eg=None)
            conn.send(("updated", True))
        elif cmd == "eval":
            _, _, E_glob_np = msg
            with torch.no_grad():
                R = decide_fn(params, arch,
                              torch.from_numpy(E_glob_np).to(dev))
            conn.send(("logits", _host(R)))
        elif cmd == "stop":
            conn.send(("bye", None))
            return
        else:
            raise ValueError(f"unknown message {cmd!r}")


class WireEaster:
    """Active-party orchestrator for the multi-process protocol.

    ``init_params``: the C parties' initial trees as numpy, in party order;
    party k > 0 gets its own at spawn. Without it each party draws from a
    ``torch.Generator`` seeded ``seed + k``."""

    def __init__(self, arches, n_features: List[int], n_classes: int,
                 lr: float = 1e-3, seed: int = 0,
                 record_transcript: bool = False,
                 mask_mode: str = "float", device: Any = None,
                 init_params: Optional[List[Any]] = None):
        if mask_mode not in ("float", "int8"):
            raise ValueError(f"mask_mode {mask_mode!r}")
        self.mask_mode = mask_mode
        self.arches = arches
        self.C = len(arches)
        self.K = self.C - 1
        self.n_classes = n_classes
        self.device = resolve_device(device)
        self.init_params = init_params or [None] * self.C
        # active party's own model (index 0)
        self.params = _party_params(self.init_params[0], seed, arches[0],
                                    n_features[0], self.device)
        self.opt = make_optimizer("adam", lr)
        self.opt_state = self.opt.init(self.params)
        self.n_features = n_features
        self.lr = lr
        self.seed = seed
        self.conns = []
        self.procs = []
        # security audit hook: every payload the ACTIVE party observes on
        # the wire, as (direction, kind, round, party, np.ndarray). The
        # trust argument is that nothing here is a raw E_k
        # (tests/test_torch_wire.py checks it against out-of-band
        # recomputation).
        self.record_transcript = record_transcript
        self.transcript: List[Tuple[str, str, int, int, np.ndarray]] = []

    def _record(self, direction: str, kind: str, round_idx: int,
                party: int, payload):
        if self.record_transcript:
            self.transcript.append(
                (direction, kind, round_idx, party,
                 np.array(payload, copy=True)))

    def _recv(self, k: int, kind: str):
        """Passive party k+1's next message, which must be ``kind``."""
        c = self.conns[k]
        if not c.poll(RECV_TIMEOUT_S):
            raise TimeoutError(f"passive party {k + 1} sent no {kind!r} "
                               f"within {RECV_TIMEOUT_S:g} s (alive: "
                               f"{self.procs[k].is_alive()})")
        try:
            msg = c.recv()
        except EOFError:
            raise RuntimeError(f"passive party {k + 1} exited before "
                               f"sending {kind!r}") from None
        if msg[0] == "error":
            raise RuntimeError(f"passive party {k + 1} failed:\n{msg[1]}")
        if msg[0] != kind:
            raise RuntimeError(f"passive party {k + 1} sent {msg[0]!r}, "
                               f"expected {kind!r}")
        return msg

    def start(self):
        ctx = mp.get_context("spawn")
        for k in range(self.K):
            parent, child = ctx.Pipe()
            p = ctx.Process(
                target=_passive_party_main,
                args=(child, k, pickle.dumps(self.arches[k + 1]),
                      self.n_features[k + 1], self.lr, self.seed + k + 1,
                      self.mask_mode, str(self.device),
                      self.init_params[k + 1]),
                daemon=True)
            p.start()
            child.close()              # a dead child then reads as EOF
            self.conns.append(parent)
            self.procs.append(p)
        self._key_ceremony()

    def _key_ceremony(self):
        """Collect the passive parties' public keys, hand each the others'."""
        pks = {}
        for k, c in enumerate(self.conns):
            c.send(("pubkey",))
            pks[k] = self._recv(k, "pubkey")[1]
        for k, c in enumerate(self.conns):
            others = {j: pk for j, pk in pks.items() if j != k}
            c.send(("setup", others, self.C))

    def _finish_int8_uplink(self, E_a: torch.Tensor,
                            round_idx: int) -> np.ndarray:
        """int8 steps 1b-2: collect scalar amaxes, broadcast the agreed
        per-round scale, collect packed ring words, ring-aggregate.

        The transcript records the PACKED WORDS — the literal wire
        payload — plus the scalar amax each party reveals (the only
        non-masked statistic the narrow-ring mode leaks)."""
        E_a = E_a.detach()
        amaxes = [self._recv(k, "amax")[1] for k in range(self.K)]
        for k, a in enumerate(amaxes):
            self._record("passive->active", "embed_amax", round_idx,
                         k + 1, np.float32(a))
        amax = max([float(torch.max(torch.abs(E_a)))] + amaxes)
        scale = float(blinding.ring_scale(amax, self.C, "int8"))
        for c in self.conns:
            c.send(("embed_q", scale))
        q_rows = [blinding.quantize_ring(E_a, "int8", scale)]
        for k in range(self.K):
            _, words, shape = self._recv(k, "blinded_embed_q")
            self._record("passive->active", "blinded_embed", round_idx,
                         k + 1, words)
            q_rows.append(torch.from_numpy(blinding.unpack_int8_words(
                words, shape)).to(self.device))
        E = aggregation.aggregate_int8_blinded(torch.stack(q_rows), scale)
        return _host(E).astype(np.float32)

    def _global_embed(self, xs, round_idx: int, kind: Optional[str]):
        """Steps 1-2: passives embed (and blind) while the active party
        embeds; the global embedding as float32 numpy, and E_a. The
        float aggregation stays in numpy on the host."""
        cmd = "embed_amax" if self.mask_mode == "int8" else "embed"
        for k, c in enumerate(self.conns):
            c.send((cmd, np.asarray(xs[k + 1]), round_idx))
        E_a = embed_fn(self.params, self.arches[0],
                       torch.from_numpy(np.asarray(xs[0])).to(self.device))
        if self.mask_mode == "int8":
            return self._finish_int8_uplink(E_a, round_idx), E_a
        blinded = [self._recv(k, "blinded_embed")[1] for k in range(self.K)]
        if kind is not None:
            for k, b in enumerate(blinded):
                self._record("passive->active", kind, round_idx, k + 1, b)
        return (_host(E_a) + sum(blinded)) / self.C, E_a

    def round(self, xs: List[np.ndarray], y: np.ndarray, round_idx: int):
        """One Alg. 1 round. xs: per-party feature arrays (party 0 first)."""
        # steps 1-2: local embeddings, secure aggregation (masks cancel)
        E, E_a = self._global_embed(xs, round_idx, "blinded_embed")
        # step 3: parties predict from the global embedding
        if self.mask_mode == "int8":
            frame = _encode_leg(E)
            for c in self.conns:
                c.send(("predict",) + frame)
            self._record("active->passive", "global_embed", round_idx, 0,
                         frame[0])
        else:
            for c in self.conns:
                c.send(("predict", E))
            self._record("active->passive", "global_embed", round_idx, 0, E)
        Eg = torch.from_numpy(E).to(self.device).requires_grad_(True)
        R_a = decide_fn(self.params, self.arches[0], Eg)
        if self.mask_mode == "int8":
            R_passive = []
            for k in range(self.K):
                _, words, shape, scale = self._recv(k, "prediction_q")
                self._record("passive->active", "prediction", round_idx,
                             k + 1, words)
                R_passive.append(_decode_leg(words, shape, scale))
        else:
            R_passive = [self._recv(k, "prediction")[1]
                         for k in range(self.K)]
            for k, r in enumerate(R_passive):
                self._record("passive->active", "prediction", round_idx,
                             k + 1, r)
        # step 4: loss assist — active computes dL_k/dR_k for every party
        y_t = torch.from_numpy(np.asarray(y)).to(self.device)
        losses = []
        for k, (c, R_np) in enumerate(zip(self.conns, R_passive)):
            R_k = torch.from_numpy(R_np).to(self.device).requires_grad_(True)
            L_k = softmax_xent(R_k, y_t)
            (gR,) = torch.autograd.grad(L_k, R_k)
            losses.append(float(L_k.detach()))
            if self.mask_mode == "int8":
                frame = _encode_leg(_host(gR))
                c.send(("grad",) + frame)
                self._record("active->passive", "loss_grad", round_idx,
                             k + 1, frame[0])
            else:
                c.send(("grad", _host(gR)))
                self._record("active->passive", "loss_grad", round_idx,
                             k + 1, _host(gR))
        # step 5: active party's own update
        L_a = softmax_xent(R_a, y_t)
        (gR_a,) = torch.autograd.grad(L_a, R_a, retain_graph=True)
        dec_leaves = tree_leaves(self.params["decide"])
        *g_dec, gE = torch.autograd.grad(R_a, dec_leaves + [Eg], gR_a)
        g_emb = torch.autograd.grad(
            E_a, tree_leaves(self.params["embed"]), gE / self.C)
        grads = {"embed": tree_unflatten(self.params["embed"], g_emb),
                 "decide": tree_unflatten(self.params["decide"], g_dec)}
        self.opt.update(grads, self.opt_state, self.params)
        for k in range(self.K):
            self._recv(k, "updated")
        return [float(L_a.detach())] + losses

    def evaluate(self, xs, y) -> np.ndarray:
        with torch.no_grad():
            E, _ = self._global_embed(xs, EVAL_ROUND, None)
            R_a = decide_fn(self.params, self.arches[0],
                            torch.from_numpy(E).to(self.device))
        accs = [float((np.argmax(_host(R_a), -1) == y).mean())]
        for c in self.conns:
            c.send(("eval", None, E))
        for k in range(self.K):
            R_k = self._recv(k, "logits")[1]
            accs.append(float((np.argmax(R_k, -1) == y).mean()))
        return np.asarray(accs)

    def stop(self):
        """Ask every party to stop; join, and terminate what outlives
        the join."""
        for c in self.conns:
            try:
                c.send(("stop",))
                if c.poll(10):
                    c.recv()
            except (OSError, EOFError):
                pass                   # the party is already gone
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        for c in self.conns:
            c.close()
