"""Core layers of the party models (plain tensors in dicts, in the
reference's ``repro.models.layers`` layout: a dense ``w`` is (d_in, d_out),
attention tensors are (B, S, H, hd)).

The dtype casts follow the reference: norms, rope and the softmax run in
float32 and cast back; attention logits are float32 einsums; a linear
layer runs in its weights' dtype.

Prefill attention (``_attend``) on CUDA tensors runs the hand-written
flash kernel (``kernels.ops.flash_attention``); on CPU tensors, and on
any device in a training forward (``training=True``: the flash kernel
has no backward), it runs the reference's own choice, ``dot_attention``
or ``chunked_attention``.
Decode attention (one query against the KV cache, per-lane masks) is
plain torch on both, as it is plain jnp in the reference. Cross-attention
(``cross_attend``, the encoder-decoder's decoder over the encoder's K/V)
takes the flash kernel on the card at every query length, decode rounds
included.

Cache writes are out of place (``torch.where`` against a one-hot slot
mask), so a step returns new caches as the reference's functional update
does, and the same code runs under ``torch.func.vmap``.

Under a sharding plan's tensor-parallel compute (``tp``, a
``sharding.TP``) ``self_attention`` and ``mlp`` run on this rank's
"model" block of their leaves: column-parallel
q/k/v and up/gate, row-parallel wo and down, the stream entered and the
partial sums reduced by Megatron's operators; the decode over a cache
split by T merges each rank's partial softmax (``_t_split_decode``).
Without a plan they run the same code on one rank holding every block
(``sharding.WHOLE``: the operators are the identity).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding

# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------


class MetaGenerator:
    """Stands in for a ``torch.Generator`` where only the parameter tree's
    shapes and dtypes are wanted: every init function then builds its
    tensors on the meta device, drawing and allocating nothing (the dry
    run's abstract parameters)."""
    device = torch.device("meta")


def _dense_init(gen: torch.Generator, shape, dtype,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn from ``gen`` on the generator's
    own device (a CPU generator gives the same weights whatever device
    they land on; a CUDA generator draws large models on the card); a
    ``MetaGenerator`` gives a meta tensor."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    fan_in = shape[0]
    s = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * s).to(dtype)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, bias: bool,
                dtype) -> dict:
    p = {"w": _dense_init(gen, (d_in, d_out), dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype) -> dict:
    return {"table": _dense_init(gen, (vocab, d), dtype, scale=1.0)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def embed_grouped(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """K stacked tables (K, V, d), shared tokens (B, S) -> (K, B, S, d).

    Gathers from the flat (K*V, d) view of the stack with indices
    ``tokens + k*V``, so no table-sized tensor is written. ``embed`` under
    ``torch.func.vmap`` over the tables would be the same bits, but vmap's
    rule for ``F.embedding`` with a batched table and unbatched indices
    reshapes the stack to (V, K*d), which copies it."""
    K, V, d = table.shape
    off = (torch.arange(K, device=tokens.device) * V).view(K, 1, 1)
    return F.embedding(tokens.long()[None] + off, table.view(K * V, d))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(kind: str, d: int, dtype, device=None) -> dict:
    if kind == "rms":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if "bias" in p:  # layer norm
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rms norm
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    half = head_dim // 2
    e = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** e)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (..., S) -> cos/sin (..., S, head_dim/2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                  sections):
    """Qwen2-VL multimodal RoPE: positions (3, B, S) of temporal, height
    and width ids; ``sections`` splits head_dim/2 across the three.
    Returns cos/sin (B, S, head_dim/2), each section from its own ids."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim/2 = {head_dim // 2}")
    cos, sin = rope_cos_sin(positions, head_dim, theta)  # (3, B, S, hd/2)
    bounds = [0]
    for sec in sections:
        bounds.append(bounds[-1] + sec)
    pick = lambda t: torch.cat([t[i, ..., bounds[i]:bounds[i + 1]]
                                for i in range(3)], -1)
    return pick(cos), pick(sin)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: (B, S, H, hd); cos/sin: (B, S, hd/2) or (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() == 2:
        cos = cos[None]
        sin = sin[None]
    c = cos[:, :, None, :].float()
    s = sin[:, :, None, :].float()
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s],
                     -1).to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

NEG_INF = -2.0 ** 30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, bias: bool,
                   dtype) -> dict:
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim, bias, dtype),
        "wk": init_linear(gen, d_model, n_kv_heads * head_dim, bias, dtype),
        "wv": init_linear(gen, d_model, n_kv_heads * head_dim, bias, dtype),
        "wo": init_linear(gen, n_heads * head_dim, d_model, False, dtype),
    }


def _gqa_logits(q, k):
    """q (B,S,Hq,hd), k (B,T,Hkv,hd) -> logits (B,Hkv,G,S,T) in float32."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, hd)
    return torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())


def _gqa_out(probs, v):
    """probs (B,Hkv,G,S,T), v (B,T,Hkv,hd) -> (B,S,Hq,hd) in float32."""
    B, Hkv, G, S, T = probs.shape
    o = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return o.reshape(B, S, Hkv * G, -1)


def attention_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   causal: bool, window: int) -> torch.Tensor:
    """(S, T) boolean: True = attend. window > 0 -> sliding window."""
    dq = q_pos[:, None]
    dk = kv_pos[None, :]
    m = torch.ones((q_pos.shape[0], kv_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (dk <= dq)
    if window > 0:
        m = m & (dk > dq - window)
    return m


def dot_attention(q, k, v, *, causal: bool, window: int = 0,
                  q_offset=0, kv_valid: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Materialized attention. q (B,S,Hq,hd), k/v (B,T,Hkv,hd).

    q_offset: absolute position of q[0]. kv_valid: (T,) or (B,T) bool —
    which cache slots are filled. q is scaled in its own dtype before the
    float32 einsum, as in the reference."""
    B, S, Hq, hd = q.shape
    T = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    logits = _gqa_logits(q * scale, k)  # (B,Hkv,G,S,T) f32
    q_pos = torch.arange(S, device=q.device) + q_offset
    kv_pos = torch.arange(T, device=q.device)
    mask = attention_mask(q_pos, kv_pos, causal, window)  # (S,T)
    if kv_valid is not None:
        kvv = kv_valid if kv_valid.dim() == 2 else kv_valid[None]
        mask = mask[None] & kvv[:, None, :]              # (B,S,T)
        mask = mask[:, None, None]                       # (B,1,1,S,T)
    else:
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return _gqa_out(probs, v).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Chunked attention with an online softmax over kv chunks, float32
    accumulation: the reference's long-prompt CPU path (S > 2048)."""
    B, S, Hq, hd = q.shape
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"chunks must divide the lengths: S={S} "
                         f"q_chunk={q_chunk} T={T} kv_chunk={kv_chunk}")
    scale = 1.0 / math.sqrt(hd)
    Hkv = k.shape[2]
    G = Hq // Hkv
    outs = []
    for q0 in range(0, S, q_chunk):
        qc = q[:, q0:q0 + q_chunk] * scale
        q_pos = torch.arange(q_chunk, device=q.device) + q0
        m = torch.full((B, Hkv, G, q_chunk), -1e30, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Hkv, G, q_chunk), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, q_chunk, Hq, hd), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, T, kv_chunk):
            kc = k[:, k0:k0 + kv_chunk]
            vc = v[:, k0:k0 + kv_chunk]
            logits = _gqa_logits(qc, kc)
            kv_pos = torch.arange(kv_chunk, device=q.device) + k0
            mask = attention_mask(q_pos, kv_pos, causal, window)
            logits = torch.where(mask[None, None, None], logits, NEG_INF)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            o_tile = _gqa_out(p, vc)
            corr_o = corr.reshape(B, Hkv * G, q_chunk)
            acc = acc * torch.movedim(corr_o, 1, 2)[..., None] + o_tile
            m = m_new
        l_r = torch.movedim(l.reshape(B, Hq, q_chunk), 1, 2)
        out = acc / torch.clamp(l_r, min=1e-30)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)


def quantize_kv(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization. x (B,S,H,hd) ->
    (q int8, scale bf16 (B,S,H,1))."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def _write(buf: torch.Tensor, val: torch.Tensor, slot) -> torch.Tensor:
    """New cache ``buf`` (B, T, ...) with ``val`` (B, S, ...) written at
    rows slot .. slot+S-1 of the T axis; ``slot`` a scalar or, for
    per-lane writes of one row (S == 1), a (B,) tensor. The slot is in
    range by construction (the callers clamp or wrap it), as the
    reference's dynamic_update_slice would clamp it."""
    T = buf.shape[1]
    S = val.shape[1]
    rows = torch.arange(T, device=buf.device)
    if isinstance(slot, torch.Tensor) and slot.dim() == 1:   # per lane
        hit = rows[None, :] == slot[:, None]                  # (B, T)
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        return torch.where(hit, val.to(buf.dtype), buf)
    if S == 1:
        hit = (rows == slot).reshape((1, T) + (1,) * (buf.dim() - 2))
        return torch.where(hit, val.to(buf.dtype), buf)
    if not isinstance(slot, int) or slot != 0:
        raise ValueError("multi-row cache writes start at slot 0")
    return torch.cat([val.to(buf.dtype), buf[:, S:]], dim=1)


def _cache_positions(T: int, idx, window: int) -> torch.Tensor:
    """Absolute position stored in each cache slot (-1 = empty); ``idx``
    a 0-d tensor (the position just written) gives (T,), a (B,) tensor
    gives (B, T)."""
    slots = torch.arange(T, device=idx.device)
    cur = idx[..., None] if idx.dim() == 1 else idx
    if window > 0:
        # ring buffer: slot s holds the largest position p <= cur with
        # p % T == s
        p = cur - torch.remainder(cur - slots, T)
        return torch.where(p >= 0, p, -1)
    return torch.where(slots <= cur, slots, -1)


def _decode_write(cache, k, v, slot, dtype):
    """A decode step's new cache with k / v (B, 1, H, hd) written at
    ``slot`` (quantized where the cache is), and the K / V it attends
    over in ``dtype``."""
    idx = cache["idx"]
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        new_cache = {"k": _write(cache["k"], kq, slot),
                     "k_scale": _write(cache["k_scale"], ks, slot),
                     "v": _write(cache["v"], vq, slot),
                     "v_scale": _write(cache["v_scale"], vs, slot),
                     "idx": idx + 1}
        return (new_cache,
                dequantize_kv(new_cache["k"], new_cache["k_scale"], dtype),
                dequantize_kv(new_cache["v"], new_cache["v_scale"], dtype))
    ck = _write(cache["k"], k, slot)
    cv = _write(cache["v"], v, slot)
    return {"k": ck, "v": cv, "idx": idx + 1}, ck, cv


def _prefill_cache(cache, k, v, S: int, window: int):
    """A prefill's new cache: the (last T of the) prompt's K / V from slot
    0, a window's ring laid out so that slot s holds position p, p % T ==
    s."""
    T = cache["k"].shape[1]
    quant = "k_scale" in cache
    filled = torch.full_like(cache["idx"], S)
    if window > 0 and S >= T:
        kw = torch.roll(k[:, -T:], S % T, dims=1)
        vw = torch.roll(v[:, -T:], S % T, dims=1)
        if quant:
            kq, ks = quantize_kv(kw)
            vq, vs = quantize_kv(vw)
            return {"k": kq, "k_scale": ks, "v": vq, "v_scale": vs,
                    "idx": filled}
        return {"k": kw.to(cache["k"].dtype), "v": vw.to(cache["v"].dtype),
                "idx": filled}
    eff = min(T, S)
    if quant:
        kq, ks = quantize_kv(k[:, -eff:])
        vq, vs = quantize_kv(v[:, -eff:])
        return {"k": _write(cache["k"], kq, 0),
                "k_scale": _write(cache["k_scale"], ks, 0),
                "v": _write(cache["v"], vq, 0),
                "v_scale": _write(cache["v_scale"], vs, 0),
                "idx": filled}
    return {"k": _write(cache["k"], k[:, -eff:], 0),
            "v": _write(cache["v"], v[:, -eff:], 0), "idx": filled}


def _decode_slot(idx, T: int, window: int):
    if window > 0:
        return torch.remainder(idx, T).to(torch.int32)
    return torch.clamp(idx, max=T - 1).to(torch.int32)


def _decode_mask(T: int, idx, window: int):
    """(T,) or (B, T) bool: the cache slots a decode step at ``idx``
    attends to."""
    kv_pos_abs = _cache_positions(T, idx, window)  # (T,) | (B,T)
    iexp = idx[:, None] if idx.dim() == 1 else idx
    mask = (kv_pos_abs >= 0) & (kv_pos_abs <= iexp)
    if window > 0:
        mask = mask & (kv_pos_abs > iexp - window)
    return mask


def _masked_logits(q, ck, mask, head_dim: int):
    """Decode logits (B, Hkv, G, 1, T) in float32, masked slots NEG_INF."""
    logits = _gqa_logits(q * (1.0 / math.sqrt(head_dim)), ck)
    mb = (mask[:, None, None, None, :] if mask.dim() == 2
          else mask[None, None, None, None, :])
    return torch.where(mb, logits, NEG_INF)


def self_attention(params: dict, x: torch.Tensor, *, n_heads: int,
                   n_kv_heads: int, head_dim: int, causal: bool = True,
                   window: int = 0, cos=None, sin=None,
                   cache: Optional[dict] = None, mode: str = "auto",
                   q_chunk: int = 1024, training: bool = False, tp=None):
    """Self-attention layer (projections + rope + attend + out-proj).

    cache: {"k","v": (B, T_cache, Hkv, hd), "idx": 0-d or (B,) int32} —
    the decode step (S == 1) writes the new K/V at slot idx (idx mod T
    with a window); a (B,) ``idx`` gives every batch row its own slot and
    mask (continuous-batching lanes). Quantized caches carry int8 "k"/"v"
    and bf16 "k_scale"/"v_scale". Prefill (S > 1) writes the (last T of
    the) prompt's K/V from slot 0. ``mode`` ("auto" | "chunked") and
    ``q_chunk`` choose the CPU path of prompt attention (``_attend``);
    ``training`` takes that path on every device (the flash kernel has no
    backward).

    ``tp`` (``sharding.TP``; None: ``sharding.WHOLE``, one rank holding
    the whole layer) whose ``attn`` is "heads" or "kv" computes on this
    rank's "model" block (Megatron): x is the normed stream (this rank's
    S block when ``tp.seq``), entered whole (``tp.enter``); q by this
    rank's columns of wq, Hq / m heads; under "heads" its Hkv / m kv
    heads from its columns of wk / wv, under "kv" every kv head, its
    columns' products all-gathered (``gather_cols``: the cache holds them
    all), and attention with the one head this rank's q heads read. The
    output is this rank's rows of wo, reduced into the stream
    (``tp.exit``); a wo bias, unsplit, added once, after the reduction.
    Under "whole" the layer runs whole on the whole x (gathered leaves)
    and only ``tp.kv_t`` applies. A K/V cache block holds this rank's
    heads, or (``tp.kv_t``) its T block of every head: the prefill
    writes its block, a decode step writes the slot where it lies and
    merges the ranks' partial softmax over their T blocks
    (``_t_split_decode``; under "whole" every head's). Returns (out,
    new_cache)."""
    tp = tp if tp is not None else sharding.WHOLE
    split = tp.attn != "whole"
    if split:
        x = tp.enter(x)
    B, S, _ = x.shape
    m, c = tp.m, tp.coord
    mh = m if split else 1              # the heads' divisor
    hq = n_heads // mh
    q = linear(params["wq"], x).reshape(B, S, hq, head_dim)
    k, v = linear(params["wk"], x), linear(params["wv"], x)
    hk = n_kv_heads // mh
    if tp.attn == "kv":
        k, v = sharding.gather_cols(k, tp.mesh), sharding.gather_cols(
            v, tp.mesh)
        hk = n_kv_heads
    k = k.reshape(B, S, hk, head_dim)
    v = v.reshape(B, S, hk, head_dim)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    own = (slice(c * n_kv_heads // m, c * n_kv_heads // m + 1)
           if tp.attn == "kv" else slice(None))

    new_cache = None
    if cache is not None and S == 1:
        Tl = cache["k"].shape[1]
        T = Tl * m if tp.kv_t else Tl
        idx = cache["idx"]
        slot = _decode_slot(idx, T, window)
        lo = c * Tl if tp.kv_t else 0
        new_cache, ck, cv = _decode_write(cache, k, v, slot - lo, x.dtype)
        mask = _decode_mask(T, idx, window)
        if tp.kv_t:
            attn = _t_split_decode(q, ck, cv, mask.narrow(-1, lo, Tl),
                                   head_dim, tp, split)
        else:
            logits = _masked_logits(q, ck[:, :, own], mask, head_dim)
            attn = _gqa_out(torch.softmax(logits, dim=-1), cv[:, :, own])
        attn = attn.to(x.dtype)
    else:
        if cache is not None:
            if tp.kv_t:     # this rank's T block of every kv head
                Tl = cache["k"].shape[1]
                full = {n: (t if n == "idx" else t.new_zeros(
                    (t.shape[0], Tl * m) + tuple(t.shape[2:])))
                    for n, t in cache.items()}
                new_cache = {n: (t if n == "idx" else t.narrow(1, c * Tl, Tl))
                             for n, t in _prefill_cache(full, k, v, S,
                                                        window).items()}
            else:       # the (last T of the) prompt from slot 0
                new_cache = _prefill_cache(cache, k, v, S, window)
        attn = _attend(q, k[:, :, own], v[:, :, own], causal, window, mode,
                       q_chunk, training)
    out = attn.reshape(B, S, hq * head_dim) @ params["wo"]["w"]
    b = params["wo"].get("b")
    if split:
        out = tp.exit(out)
        b = None if b is None else tp.rep(b)
    return (out if b is None else out + b), new_cache


def _t_split_decode(q, ck, cv, mask, head_dim: int, tp, split: bool = True):
    """One decode step's attention over a cache whose T lies over "model":
    each rank's partial softmax over its T block (ck / cv (B, Tl, Hkv,
    hd), ``mask`` its slots), merged by log-sum-exp over the ranks (a max,
    then one sum of the unnormalised outputs and their weights), float32.
    ``split``: q (B, 1, Hq / m, hd) is this rank's heads, gathered to
    every head first, and this rank's heads of the result are returned;
    else q and the result hold every head (a whole attention)."""
    hq = q.shape[2]
    qa = sharding.model_gather(q, tp.mesh, -2) if split else q
    logits = _masked_logits(qa, ck, mask, head_dim)      # (B,Hkv,G,1,Tl)
    mx = sharding.model_max(torch.amax(logits, dim=-1, keepdim=True),
                            tp.mesh)
    p = torch.exp(logits - mx)
    o = _gqa_out(p, cv)                                  # (B, 1, Hq, hd)
    B, Hkv, G, S, _ = p.shape
    w = torch.sum(p, dim=-1).permute(0, 3, 1, 2).reshape(B, S, Hkv * G, 1)
    ow = sharding.reduce_from_model(torch.cat([o, w], dim=-1), tp.mesh)
    out = ow[..., :-1] / ow[..., -1:]
    return out[:, :, tp.coord * hq:(tp.coord + 1) * hq] if split else out


def _attend(q, k, v, causal, window, mode, q_chunk, training=False):
    """Prompt attention: the flash kernel for CUDA tensors; on the CPU, and
    on any device when ``training``, the reference's differentiable choice
    (chunked for long prompts that the chunk divides, else materialized).
    ``mode`` and ``q_chunk`` select among those plain paths only: on the
    card outside training any mode but "auto" raises."""
    if q.device.type == "cuda" and not training:
        if mode != "auto":
            raise ValueError(f"attention mode {mode!r} selects a CPU path; "
                             f"on the card prompt attention is the flash "
                             f"kernel (mode 'auto')")
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    S = q.shape[1]
    if mode == "chunked" or (mode == "auto" and S > 2048
                             and S % q_chunk == 0):
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=q_chunk)
    return dot_attention(q, k, v, causal=causal, window=window)


def cross_attend(q, k, v, training: bool = False) -> torch.Tensor:
    """Unmasked attention of q (B,S,Hq,hd) over k/v (B,T,Hkv,hd), any S
    and T (the encoder-decoder's cross-attention): the flash kernel
    (non-causal) for CUDA tensors outside training, the reference's
    ``dot_attention`` on the CPU and under ``training``."""
    if q.device.type == "cuda" and not training:
        from repro_torch.kernels import ops
        return ops.flash_attention(q, k, v, causal=False)
    return dot_attention(q, k, v, causal=False)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype) -> dict:
    p = {"up": init_linear(gen, d_model, d_ff, False, dtype),
         "down": init_linear(gen, d_ff, d_model, False, dtype)}
    if act == "silu":  # SwiGLU
        p["gate"] = init_linear(gen, d_model, d_ff, False, dtype)
    return p


def mlp(p: dict, x: torch.Tensor, act: str, tp=None) -> torch.Tensor:
    """The MLP on this rank's "model" block under ``tp`` (``sharding.TP``;
    None: ``sharding.WHOLE``, the whole MLP): up / gate by columns on the
    entered stream, down by rows reduced into it, an unsplit down bias
    added once, after the reduction."""
    tp = tp if tp is not None else sharding.WHOLE
    x = tp.enter(x)
    if act == "silu":
        h = F.silu(linear(p["gate"], x)) * linear(p["up"], x)
    else:
        h = F.gelu(linear(p["up"], x), approximate="tanh")
    out = tp.exit(h @ p["down"]["w"])
    return out + tp.rep(p["down"]["b"]) if "b" in p["down"] else out
