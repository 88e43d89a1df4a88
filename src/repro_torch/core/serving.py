"""Continuous-batching scheduler over the lane-batched EASTER decoder
(host-side; counterpart of ``repro.core.serving``).

``ServingEngine`` owns R decode slots (``api.DecodeConfig.lanes``) and a
FIFO request queue. The loop is the textbook continuous-batching shape,
specialized to the VFL protocol:

  admit   — every free lane is refilled from the queue (prefill-into-slot:
            one B=1 per-lane prefill spliced into the lane's KV row,
            ``api.build_decoder``'s prefill_fn). Each admission burns a
            fresh monotone PRF nonce, so no two requests EVER share a
            pad round (``blinding.serve_round``; audited in tests).
  decode  — ONE fused chunk advances every live lane a token per
            protocol round (the whole federation's per-round cost —
            mask synthesis, blinded uplink, aggregation — amortized over
            all concurrent requests). Lanes that emit EOS or exhaust
            their budget freeze mid-chunk (zero uplink, pad output) and
            the dispatch cuts off early once all lanes are done.
  harvest — finished lanes hand back their generated ids + timing and
            free their slot for the next admit.

Admission happens at chunk boundaries — ``chunk`` is the scheduling
quantum (a freed lane waits at most one chunk before refill).

Open-loop driving (``run(..., arrivals=...)``): requests become
admissible at their arrival time (e.g. a Poisson process) — the engine
never blocks the decode loop on future arrivals.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core import api, blinding


@dataclass
class Completion:
    """One finished request: generated ids + latency accounting."""
    request: api.ServeRequest
    tokens: List[int]            # generated ids (includes EOS if emitted)
    lane: int
    nonce: int
    t_arrival: float             # seconds on the engine clock
    t_admit: float
    t_done: float

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_arrival

    @property
    def queue_s(self) -> float:
        return self.t_admit - self.t_arrival


@dataclass
class _Lane:
    request: api.ServeRequest
    nonce: int
    t_arrival: float
    t_admit: float
    tokens: List[int] = field(default_factory=list)


class ServingEngine:
    """R-slot continuous-batching serve tier for one ``EasterLM``.

    ``early_exit=False`` disables EOS/budget lane freezing ONLY in the
    sense a pre-batching server would: every admitted request is padded
    to the engine-wide ``no_exit_budget`` (default: its own budget) with
    EOS ignored — the A/B baseline benchmarks measure the early-exit
    win against.
    """

    def __init__(self, sys, params, *, lanes: int = 8, max_len: int = 64,
                 chunk: int = 8, pad_id: int = 0, base_key: int = 0,
                 window_override: int = -1, early_exit: bool = True,
                 no_exit_budget: Optional[int] = None):
        self.sys = sys
        self.params = params
        self.cfg = api.DecodeConfig(
            lanes=lanes, max_len=max_len, chunk=chunk, pad_id=pad_id,
            window_override=window_override, base_key=base_key)
        self._prefill, self._decode = api.build_decoder(sys, self.cfg)
        self.state = api.init_decode_state(sys, self.cfg)
        self.early_exit = early_exit
        self.no_exit_budget = no_exit_budget
        self._lanes: List[Optional[_Lane]] = [None] * lanes
        self._queue: deque = deque()           # (t_arrival, ServeRequest)
        self._next_nonce = 0
        self._t0 = time.perf_counter()
        self.completions: List[Completion] = []
        self.rounds_run = 0                    # protocol rounds dispatched
        self.chunks_run = 0

    # -- clock ---------------------------------------------------------------
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def reset(self):
        """Drop all queue/lane/completion state and restart the engine
        clock (the replay hook for timing repeated runs of one workload).
        Restarting the nonce counter reuses PRF rounds across runs, which
        is fine for timing but NOT for production traffic (see
        _issue_nonce)."""
        self.state = api.init_decode_state(self.sys, self.cfg)
        self._lanes = [None] * self.cfg.lanes
        self._queue.clear()
        self._next_nonce = 0
        self.completions = []
        self.rounds_run = 0
        self.chunks_run = 0
        self._t0 = time.perf_counter()

    # -- queue ---------------------------------------------------------------
    def submit(self, request: api.ServeRequest,
               arrival: Optional[float] = None):
        """Enqueue a request; ``arrival`` on the engine clock (None=now).
        Future arrivals stay invisible to admission until due."""
        if not self.early_exit:
            budget = self.no_exit_budget or request.max_new_tokens
            request = api.ServeRequest(
                tokens=request.tokens, max_new_tokens=budget,
                eos_id=-1, temperature=request.temperature,
                nonce=request.nonce)
        self._queue.append((self.now() if arrival is None else arrival,
                            request))

    def _issue_nonce(self) -> int:
        n = self._next_nonce
        if n > blinding.MAX_SERVE_NONCE:
            raise RuntimeError(
                f"serve nonce space exhausted ({n}): restart the engine "
                f"(a fresh PRF epoch) before admitting more requests")
        self._next_nonce += 1
        return n

    # -- scheduling ----------------------------------------------------------
    def _admit(self):
        """Fill every free lane with a due queued request."""
        now = self.now()
        for lane in range(self.cfg.lanes):
            if self._lanes[lane] is not None:
                continue
            if not self._queue:
                return
            t_arr, req = self._queue[0]
            if t_arr > now:
                return                        # open loop: not due yet
            self._queue.popleft()
            nonce = req.nonce if req.nonce is not None \
                else self._issue_nonce()
            self.state = self._prefill(self.params, self.state, req, lane,
                                       nonce=nonce)
            self._lanes[lane] = _Lane(request=req, nonce=nonce,
                                      t_arrival=t_arr, t_admit=self.now())

    def _harvest(self, buf: np.ndarray, rem_before: np.ndarray,
                 rem_after: np.ndarray, done: np.ndarray):
        """Collect per-lane chunk output; complete + free finished lanes.

        A lane's tokens this chunk are the FIRST ``rem_before - rem_after``
        columns of its buffer row (``done`` is monotone inside a chunk, so
        an active lane's emissions are a prefix)."""
        t = self.now()
        for lane, st in enumerate(self._lanes):
            if st is None:
                continue
            gen = int(rem_before[lane] - rem_after[lane])
            st.tokens.extend(int(x) for x in buf[lane, :gen])
            if done[lane]:
                self.completions.append(Completion(
                    request=st.request, tokens=st.tokens, lane=lane,
                    nonce=st.nonce, t_arrival=st.t_arrival,
                    t_admit=st.t_admit, t_done=t))
                self._lanes[lane] = None

    def step(self) -> int:
        """Admit + one decode chunk + harvest. Returns rounds run (0 if
        every lane idles)."""
        self._admit()
        if all(s is None for s in self._lanes):
            return 0
        rem_before = self.state.remaining.cpu().numpy()
        buf, self.state, steps = self._decode(self.params, self.state)
        self._harvest(buf.cpu().numpy(), rem_before,
                      self.state.remaining.cpu().numpy(),
                      self.state.done.cpu().numpy())
        self.rounds_run += steps
        self.chunks_run += 1
        return steps

    def run(self, requests: Optional[Sequence[api.ServeRequest]] = None,
            arrivals: Optional[Sequence[float]] = None
            ) -> List[Completion]:
        """Serve until queue + lanes drain. ``requests``/``arrivals``
        pre-populate the queue (open-loop: arrival times on the engine
        clock; omit for closed-loop everything-at-once)."""
        if requests is not None:
            for i, req in enumerate(requests):
                self.submit(req, arrival=(arrivals[i] if arrivals is not None
                                          else 0.0))
        while self._queue or any(s is not None for s in self._lanes):
            ran = self.step()
            if ran == 0 and self._queue:
                # all lanes idle, next arrival in the future: sleep to it
                wait = self._queue[0][0] - self.now()
                if wait > 0:
                    time.sleep(min(wait, 0.05))
        return self.completions
