"""Typed training and serving surfaces for the EASTER LM system
(counterpart of ``repro.core.api``).

``build_trainer(sys, TrainConfig) -> Trainer`` works on a ``TrainState``
(params, optimizer state, global step): ``Trainer.run(state, batches)``
takes one training step per batch (``core/train_loop.py``), the step
doubling as the TRAIN-domain PRF round, with per-party optimizers
(``optim.make_party_optimizers``) where configured. The optimizer sees
the reference-shaped ``{"parties": [...]}`` tree, so its state has the
reference's structure and ``{"params", "opt"}`` checkpoints cross
between the packages; on the vectorized engine the passive entries are
row views of the stacked group, which each party's optimizer updates in
place.

``build_decoder(sys, DecodeConfig) -> (prefill_fn, decode_fn)`` works on a
(``ServeRequest``, ``DecodeState``) pair: R concurrent request lanes,
per-lane PRF nonces, EOS early-exit (``decode.decode_chunk``). The
continuous-batching scheduler on top is ``core.serving.ServingEngine``.

Lane lifecycle: ``init_decode_state`` makes every lane idle (``done``; an
idle lane is indistinguishable from a finished one: zero uplink, pad
output, frozen cache). ``prefill_fn`` admits a request into a lane: a B=1
prefill of ``prompt[:-1]`` is spliced into the lane's cache row, the last
prompt token becomes the lane's next input, and the lane's position,
nonce, key and budget are armed. ``decode_fn`` then advances every live
lane one protocol round per token until the chunk ends or all lanes are
done.

The reference jit-compiles one prefill per prompt length and donates the
state; the port runs eagerly, and its steps return new tensors, so the
caller rebinds ``state`` to the result as it does there.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Tuple

import torch

from repro_torch.core import blinding
from repro_torch.core import decode as decode_mod
from repro_torch.core import train_loop
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class ServeRequest:
    """One generation request (immutable; host-side).

    ``tokens``: the full prompt (>= 2 ids: the last one is consumed as the
    first decode input). ``eos_id``: -1 disables EOS early-exit.
    ``temperature``: 0.0 = greedy; > 0 = per-lane categorical sampling.
    ``nonce``: per-request PRF nonce (<= ``blinding.MAX_SERVE_NONCE``);
    None = the scheduler assigns a unique one at admission.
    """
    tokens: Tuple[int, ...]
    max_new_tokens: int
    eos_id: int = -1
    temperature: float = 0.0
    nonce: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "tokens", tuple(int(t)
                                                 for t in self.tokens))
        if len(self.tokens) < 2:
            raise ValueError("ServeRequest needs >= 2 prompt tokens "
                             "(the last one is the first decode input)")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.nonce is not None and not (
                0 <= self.nonce <= blinding.MAX_SERVE_NONCE):
            raise ValueError(
                f"nonce {self.nonce} outside [0, "
                f"{blinding.MAX_SERVE_NONCE}], the serve PRF span")


@dataclass(frozen=True)
class DecodeConfig:
    """Shape of the decoder a ``build_decoder`` call builds.

    ``lanes``: R, the number of concurrent decode slots. ``max_len``:
    per-lane KV slot length (a request's budget is capped to it).
    ``chunk``: decode rounds per ``decode_fn`` call, the scheduling
    quantum. ``base_key``: per-request sampling keys are
    ``fold_in(PRNGKey(base_key), nonce)``.
    """
    lanes: int
    max_len: int
    chunk: int = 8
    pad_id: int = 0
    window_override: int = -1
    base_key: int = 0


@dataclass(frozen=True)
class DecodeState:
    """Per-lane decode state on the system's device (R = lanes).

    ``tok`` (R, 1) int32 next input token; ``caches`` per-party per-lane
    KV (``init_caches(per_lane=True)``); ``pos`` (R,) int32 positions;
    ``key`` (R, 2) int64 sampling keys (uint32 words); ``done`` (R,) bool
    lane frozen (idle or finished); ``remaining`` (R,) int32 budget left;
    ``nonce`` (R,) int32 PRF nonces; ``temp`` (R,) float32 temperatures;
    ``eos`` (R,) int32 EOS ids (-1 = none).
    """
    tok: Any
    caches: Any
    pos: Any
    key: Any
    done: Any
    remaining: Any
    nonce: Any
    temp: Any
    eos: Any


def init_decode_state(sys, cfg: DecodeConfig) -> DecodeState:
    """All-idle lane state (every lane done; admit via ``prefill_fn``)."""
    R, dev = cfg.lanes, sys.device
    return DecodeState(
        tok=torch.full((R, 1), cfg.pad_id, dtype=torch.int32, device=dev),
        caches=sys.init_caches(R, cfg.max_len, cfg.window_override,
                               per_lane=True),
        pos=torch.zeros((R,), dtype=torch.int32, device=dev),
        key=torch.zeros((R, 2), dtype=torch.int64, device=dev),
        done=torch.ones((R,), dtype=torch.bool, device=dev),
        remaining=torch.zeros((R,), dtype=torch.int32, device=dev),
        nonce=torch.zeros((R,), dtype=torch.int32, device=dev),
        temp=torch.zeros((R,), dtype=torch.float32, device=dev),
        eos=torch.full((R,), -1, dtype=torch.int32, device=dev))


def _set(t: torch.Tensor, lane: int, value) -> torch.Tensor:
    out = t.clone()
    out[lane] = torch.as_tensor(value, dtype=t.dtype)
    return out


def build_decoder(sys, cfg: DecodeConfig):
    """The typed serving surface: ``(prefill_fn, decode_fn)``.

    ``prefill_fn(params, state, request, lane, *, nonce=None) -> state``
      admits ``request`` into decode slot ``lane``: a B=1 prefill of
      ``prompt[:-1]`` spliced into the lane's cache row, lane metadata
      armed. ``nonce`` overrides ``request.nonce``; one of the two must be
      set and be unique per in-flight request.

    ``decode_fn(params, state) -> (tokens (R, chunk), state, steps_run)``
      one lane-batched chunk (``decode.decode_chunk``).
    """
    seeds = sys.mask_seeds()
    wo = cfg.window_override

    def prefill_fn(params, state: DecodeState, request: ServeRequest,
                   lane: int, *, nonce=None) -> DecodeState:
        nonce = request.nonce if nonce is None else nonce
        if nonce is None:
            raise ValueError("no nonce: set ServeRequest.nonce or pass "
                             "nonce= (the scheduler's assignment)")
        nonce, lane = int(nonce), int(lane)
        P = len(request.tokens)
        if P > cfg.max_len:
            raise ValueError(f"prompt ({P}) exceeds the lane KV slot "
                             f"({cfg.max_len})")
        prompt = torch.tensor(request.tokens, dtype=torch.int32,
                              device=sys.device)[None, :]
        # fresh per-lane B=1 prefill of prompt[:-1] at full slot length,
        # then splice the whole cache row over the lane (stacked cache
        # leaves all carry the lane axis at position 1)
        c1 = sys.init_caches(1, cfg.max_len, wo, per_lane=True)
        _, c1 = sys.prefill(params, prompt[:, :P - 1], c1,
                            window_override=wo, seeds=seeds, round_idx=nonce)

        def splice(big, one):
            out = big.clone()
            out[:, lane] = one[:, 0]
            return out

        key_r = blinding.fold_in(blinding.prng_key(cfg.base_key), nonce)
        # budget capped to the slot: the lane must not write past max_len
        budget = min(request.max_new_tokens, cfg.max_len - P + 1)
        return dataclasses.replace(
            state,
            tok=_set(state.tok, lane, request.tokens[-1]),
            caches=tree_map(splice, state.caches, c1),
            pos=_set(state.pos, lane, P - 1),
            key=_set(state.key, lane, list(key_r)),
            done=_set(state.done, lane, False),
            remaining=_set(state.remaining, lane, budget),
            nonce=_set(state.nonce, lane, nonce),
            temp=_set(state.temp, lane, request.temperature),
            eos=_set(state.eos, lane, request.eos_id))

    def decode_fn(params, state: DecodeState):
        return decode_mod.decode_chunk(sys, params, state, cfg.chunk, seeds,
                                       pad_id=cfg.pad_id)

    return prefill_fn, decode_fn


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TrainConfig:
    """Everything a launcher assembles around the train step.

    ``optimizer``: a name (homogeneous, global-norm clipped by
    ``grad_clip``) or a prebuilt ``Optimizer``-shaped object.
    ``party_optimizers``: ``optim.parse_party_spec`` output
    (``{party: (name, lr, hparams)}``), the paper's §IV-E heterogeneous
    per-party optimization; unlisted parties fall back to
    ``optimizer``/``lr``, listed parties clip per party (default clip
    ``grad_clip`` unless the spec overrides). ``chunk``: optimizer steps
    per ``train_chunk`` run inside ``Trainer.run``, each run's batches
    stacked and moved to the device at once (so at most ``chunk`` steps'
    batches are on the device); ``launch/train.py`` also draws batches
    ``chunk`` steps at a time. ``donate``: accepted for the reference's
    signature and ignored: the port's step updates the params and
    optimizer state in place, so there is nothing to donate.
    """
    optimizer: Any = "adam"
    lr: float = 1e-3
    grad_clip: float = 1.0
    chunk: int = 8
    party_optimizers: Optional[Mapping[int, Tuple]] = None
    donate: bool = True


@dataclass(frozen=True)
class TrainState:
    """(params, optimizer state, global step). ``params`` is the system's
    tree (with ``passive_stacked`` on the vectorized engine); ``opt_state``
    is shaped like ``{"parties": params["parties"]}``; ``step`` is an
    int."""
    params: Any
    opt_state: Any
    step: int


class Trainer:
    """Training behind one ``run`` call, no carry tuples.

    ``init(params) -> TrainState``; ``run(state, batches) ->
    (TrainState, metrics)`` takes ``len(batches)`` steps, in runs of
    ``cfg.chunk`` (``train_chunk``), with ``state.step`` as the
    TRAIN-domain PRF round base, updating the params and optimizer state
    in place (the returned state holds the same tensors). ``metrics``:
    ``{"loss": (N,), "per_party": (N, C)}``.
    """

    def __init__(self, sys, cfg: TrainConfig):
        from repro_torch import optim
        self.sys = sys
        self.cfg = cfg
        if cfg.party_optimizers:
            spec = {int(k): (v[0], v[1], dict(v[2]) if len(v) > 2 and v[2]
                             else {})
                    for k, v in cfg.party_optimizers.items()}
            for _, _, hp in spec.values():
                # listed parties clip like unlisted ones unless overridden
                hp.setdefault("grad_clip", cfg.grad_clip)
            base = (cfg.optimizer if isinstance(cfg.optimizer, str)
                    else "adam")
            self.opt = optim.make_party_optimizers(
                spec, sys.C,
                default=(base, cfg.lr, {"grad_clip": cfg.grad_clip}))
        elif callable(getattr(cfg.optimizer, "update", None)):
            self.opt = cfg.optimizer
        else:
            # one optimizer over every party: on the sharded engine its
            # clipping norm sums over the ranks
            self.opt = optim.make_optimizer(
                cfg.optimizer, cfg.lr, grad_clip=cfg.grad_clip,
                norm_reduce=getattr(sys, "sum_over_ranks", None))
        self.chunk = max(1, cfg.chunk)
        self._chunk_fn = train_loop.build_train_chunk(sys, self.opt,
                                                      donate=cfg.donate)

    def init(self, params) -> TrainState:
        return TrainState(params=params,
                          opt_state=self.opt.init(
                              {"parties": params["parties"]}),
                          step=0)

    def run(self, state: TrainState, batches):
        """``batches``: a list of per-step batch dicts (numpy or
        tensors), moved to the system's device ``cfg.chunk`` steps at a
        time."""
        params, opt_state, step = state.params, state.opt_state, state.step
        losses, pers = [], []
        for i in range(0, len(batches), self.chunk):
            stacked = train_loop.stack_batches(batches[i:i + self.chunk],
                                               self.sys.device)
            params, opt_state, step, m = self._chunk_fn(
                params, opt_state, stacked, step)
            losses.append(m["loss"])
            pers.append(m["per_party"])
        return TrainState(params, opt_state, step), {
            "loss": torch.cat(losses), "per_party": torch.cat(pers)}


def build_trainer(sys, cfg: TrainConfig) -> Trainer:
    """Mirror of ``build_decoder`` on the training side."""
    return Trainer(sys, cfg)
