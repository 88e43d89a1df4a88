"""Multi-token decode drivers over ``EasterLM.serve_step``.

Counterpart of ``repro.core.decode``. Where the reference fuses a whole
generation into one ``lax.scan`` (``serve_tokens``) or one
``lax.while_loop`` (``decode_chunk``), the port runs a Python loop whose
body is ``serve_step`` itself, so every engine and the per-step blinding
semantics carry over unchanged: step i of a generation started at
position p blinds under PRF round SERVE_DOMAIN + p + i
(``serve_round_schedule``), and batched lanes under
``blinding.serve_round(nonce, pos)``.

Sampling rebuilds ``jax.random`` on the port's threefry2x32
(partitionable, as the installed reference): ``split_key`` is
``jax.random.split(key)``, ``gumbel`` is ``jax.random.gumbel`` (its
default "low" mode) and ``sample_token`` draws ``jax.random.categorical``
by the Gumbel-max trick, so a sampled lane gets the reference's keys and
tokens. Keys are int64 tensors of shape (..., 2) holding the two uint32
words.

Under the sharded engine only the active party's rank gets logits; the
drivers sample there and ``EasterLM.share_tokens`` broadcasts the tokens
to the other ranks, whose lane state then moves in step.

``decode_chunk`` drives R request lanes through one protocol round per
generated token; a lane that emitted its EOS or spent its budget freezes
(caches, position and key untouched, zero uplink, pad output), and the
chunk ends as soon as every lane is done.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import blinding
from repro_torch.tree import tree_map

_M32 = 0xFFFFFFFF
# (bits, mantissa bits, the bit pattern of 1.0) of jax.random.uniform's
# mantissa trick for each float dtype
_UNIFORM = {torch.float32: (32, 23, 0x3F800000, torch.int32),
            torch.bfloat16: (16, 7, 0x3F80, torch.int16),
            torch.float16: (16, 10, 0x3C00, torch.int16)}


def serve_round_schedule(pos, n_steps: int) -> torch.Tensor:
    """PRF round indices a multi-token decode visits: SERVE_DOMAIN + pos
    + i for step i."""
    pos = torch.as_tensor(pos, dtype=torch.int32)
    return (blinding.SERVE_DOMAIN + pos
            + torch.arange(n_steps, dtype=torch.int32, device=pos.device))


# ---------------------------------------------------------------------------
# jax.random on threefry2x32
# ---------------------------------------------------------------------------


def key_tensor(key, device=None) -> torch.Tensor:
    """A (k1, k2) pair of uint32 words as a (2,) int64 tensor."""
    return torch.tensor([int(key[0]) & _M32, int(key[1]) & _M32],
                        dtype=torch.int64, device=device)


def split_key(key: torch.Tensor):
    """``jax.random.split(key)`` for keys (..., 2): the new key and the
    subkey, threefry of the counters (0, 0) and (0, 1)."""
    k1, k2 = key[..., 0], key[..., 1]
    zero = torch.zeros_like(k1)
    a = blinding.threefry2x32(k1, k2, zero, zero)
    b = blinding.threefry2x32(k1, k2, zero, zero + 1)
    return torch.stack(a, dim=-1), torch.stack(b, dim=-1)


def gumbel(key: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), dtype)`` for keys (..., 2) -> (..., n):
    bits of the flat counters 0..n-1, a uniform on [tiny, 1) by the
    mantissa trick, then -log(-log(u))."""
    if dtype not in _UNIFORM:
        raise TypeError(f"gumbel: dtype {dtype} not supported")
    nbits, nmant, one_bits, itype = _UNIFORM[dtype]
    counts = torch.arange(n, dtype=torch.int64, device=key.device)
    k1, k2 = key[..., 0:1], key[..., 1:2]
    b1, b2 = blinding.threefry2x32(k1, k2, counts >> 32, counts & _M32)
    # jax draws max(8, nbits if nmant >= 8) bits: the low ones of b1 ^ b2
    rng_bits = 8 if nmant < 8 else nbits
    bits = (b1 ^ b2) & ((1 << rng_bits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one_bits   # < 2^(nbits-1)
    floats = fbits.to(itype).view(dtype) - torch.ones((), dtype=dtype,
                                                      device=key.device)
    tiny = torch.tensor(torch.finfo(dtype).tiny, dtype=dtype,
                        device=key.device)
    one = torch.ones((), dtype=dtype, device=key.device)
    u = torch.maximum(tiny, floats * (one - tiny) + tiny)
    return -torch.log(-torch.log(u))


def sample_token(logits: torch.Tensor, key, temperature, *, done=None,
                 pad_id: int = 0) -> torch.Tensor:
    """One sampling decision: logits (B, V) -> tokens (B, 1) int32.

    ``temperature`` a Python float: <= 0 is greedy argmax, > 0 is
    ``jax.random.categorical(key, logits / temperature)`` under one key
    (2,). ``temperature`` a (B,) tensor: per-lane, ``key`` (B, 2); a lane
    samples under its own key where its temperature is > 0, else takes
    the argmax. ``done`` (B,) masks finished lanes' outputs to
    ``pad_id``."""
    B, V = logits.shape
    if isinstance(temperature, (int, float)):
        if temperature > 0:
            g = gumbel(key, B * V, logits.dtype).reshape(B, V)
            nxt = torch.argmax(g + logits / temperature, dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
    else:
        t = temperature.float()
        nxt = torch.argmax(logits, dim=-1)
        if bool((t > 0).any()):
            safe = torch.where(t > 0, t, 1.0).to(logits.dtype)
            g = gumbel(key, V, logits.dtype)                   # (B, V)
            sampled = torch.argmax(g + logits / safe[:, None], dim=-1)
            nxt = torch.where(t > 0, sampled, nxt)
    nxt = nxt[:, None].to(torch.int32)
    if done is not None:
        nxt = torch.where(done[:, None], pad_id, nxt).to(torch.int32)
    return nxt


# ---------------------------------------------------------------------------
# single-stream decode
# ---------------------------------------------------------------------------


def serve_tokens(sys, params, tokens, caches, pos, n_steps: int, seeds, *,
                 key=None, temperature: float = 0.0,
                 window_override: int = -1, fe_list=None,
                 return_logits: bool = False):
    """Generate ``n_steps`` tokens, one ``serve_step`` per token.

    ``caches`` hold the prefilled prompt (``EasterLM.prefill``); ``tokens``
    (B, 1) is the last prompt token at position ``pos``. ``fe_list``, the
    per-party frontend inputs (an encoder-decoder's ``EasterLM.encoder_kv``),
    goes to every ``serve_step``. ``key`` (2,)
    int64 (``key_tensor``) is needed when ``temperature > 0``. Returns
    ``(out_tokens (B, n_steps) int32, caches, pos, key)``, advanced past
    the generation, plus the per-step logits (B, n_steps, V) with
    ``return_logits``."""
    if temperature > 0 and key is None:
        raise ValueError("temperature > 0 sampling needs a PRNG key")
    device = tokens.device
    key = key_tensor(blinding.prng_key(0), device) if key is None else key
    pos = torch.as_tensor(pos, dtype=torch.int32, device=device)
    tok, toks, logs = tokens, [], []
    for _ in range(n_steps):
        logits, caches = sys.serve_step(params, tok, caches, pos, seeds,
                                        window_override=window_override,
                                        fe_list=fe_list)
        key, sub = split_key(key)
        tok = sys.share_tokens(
            None if logits is None
            else sample_token(logits[:, -1], sub, temperature),
            (tokens.shape[0], 1))
        toks.append(tok)
        if return_logits and logits is not None:
            logs.append(logits[:, -1])
        pos = pos + 1
    out = torch.cat(toks, dim=1)
    if return_logits:
        return (out, caches, pos, key,
                torch.stack(logs, dim=1) if logs else None)
    return out, caches, pos, key


# ---------------------------------------------------------------------------
# batched lane decode (continuous-batching engine)
# ---------------------------------------------------------------------------


def _freeze(new, old, active: torch.Tensor):
    """Per-lane cache freeze: a finished lane's cache leaves keep their
    pre-step values bit for bit. Every stacked cache leaf carries the lane
    axis at position 1 (reps, B, ...)."""
    def sel(n, o):
        keep = active.reshape((1, -1) + (1,) * (n.dim() - 2))
        return torch.where(keep, n, o)

    return tree_map(sel, new, old)


def decode_chunk(sys, params, state, n_steps: int, seeds, *,
                 pad_id: int = 0):
    """Up to ``n_steps`` lane-batched serve rounds, ending early once every
    lane is done.

    ``state`` is a ``core.api.DecodeState``. Each round is one protocol
    round shared by every active lane (per-lane PRF rounds from the
    lanes' nonces); finished lanes are frozen. Returns ``(tokens
    (R, n_steps) int32, state, steps_run)``; slots past a lane's
    completion (or past ``steps_run``) hold ``pad_id``."""
    R = state.tok.shape[0]
    buf = torch.full((R, n_steps), pad_id, dtype=torch.int32,
                     device=state.tok.device)
    i = 0
    while i < n_steps and not bool(state.done.all()):
        st = state
        active = ~st.done
        logits, cc = sys.serve_step(params, st.tok, st.caches, st.pos, seeds,
                                    lane_mask=active, nonces=st.nonce)
        k_next, k_sub = split_key(st.key)
        nxt = sys.share_tokens(
            None if logits is None
            else sample_token(logits[:, -1], k_sub, st.temp, done=st.done,
                              pad_id=pad_id), (R, 1))
        cc = _freeze(cc, st.caches, active)
        key = torch.where(active[:, None], k_next, st.key)
        step = active.to(torch.int32)
        rem = st.remaining - step
        hit_eos = active & (st.eos >= 0) & (nxt[:, 0] == st.eos)
        done = st.done | hit_eos | (rem <= 0)
        buf[:, i] = nxt[:, 0]
        tok = torch.where(active[:, None], nxt, st.tok)
        state = dataclasses.replace(st, tok=tok, caches=cc, pos=st.pos + step,
                                    key=key, done=done, remaining=rem)
        i += 1
    return buf, state, i
