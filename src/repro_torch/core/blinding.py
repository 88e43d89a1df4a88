"""Diffie–Hellman key exchange + pairwise blinding factors (paper §IV-B).

PyTorch counterpart of ``repro.core.blinding``. The host ceremony (RFC 3526
group 14 DH, SHA-256 ``prf_seed``, ``pairwise_seeds``) is a plain copy, so
pair seeds are identical to the reference's. The in-graph PRF is
threefry2x32 written in torch, reproducing what the reference's
``jax.random`` does with ``jax_threefry_partitionable=True``:

  * ``PRNGKey(hi)`` is the key (0, hi);
  * ``fold_in(key, x)`` is threefry2x32(key, (0, x));
  * ``bits(key, shape, uint32)`` hashes the counters (i >> 32, i & 0xFFFFFFFF)
    for i = 0 .. prod(shape) - 1 and XORs the two output words;
  * ``normal(key, shape, float32)`` maps those bits to a uniform on
    (-1, 1) by the mantissa trick and returns sqrt(2) * erfinv(u).

Raw bits and the uniform match the reference bit for bit. ``normal`` goes
through erfinv, computed here by the same polynomial XLA uses; its
``log1p`` is torch's, not XLA's, so float masks match to one float32 ulp
of a value near 4 (7.2e-7 measured; the tests hold them to 1e-6).

uint32 arithmetic is carried in int64 tensors masked with ``& 0xFFFFFFFF``:
torch's uint32 support covers too few operators.

The ring wire modes follow the reference bit for bit: int32 masks are
``jax.random.randint(key, shape, int32.min, int32.max, int32)`` (see
``randint_int32``), int8 masks the low byte of ``bits``; embeddings are
quantized onto Z_2^32 at the static 2^16 scale or onto Z_2^8 at the
per-round dynamic scale, and every ring sum wraps, never clamps.
"""
from __future__ import annotations

import functools
import hashlib
import math
import secrets
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# RFC 3526, group 14 (2048-bit MODP). DLP assumed hard (paper §II-B).
P_HEX = (
    "FFFFFFFFFFFFFFFFC90FDAA22168C234C4C6628B80DC1CD129024E088A67CC74"
    "020BBEA63B139B22514A08798E3404DDEF9519B3CD3A431B302B0A6DF25F1437"
    "4FE1356D6D51C245E485B576625E7EC6F44C42E9A637ED6B0BFF5CB6F406B7ED"
    "EE386BFB5A899FA5AE9F24117C4B1FE649286651ECE45B3DC2007CB8A163BF05"
    "98DA48361C55D39A69163FA8FD24CF5F83655D23DCA3AD961C62F356208552BB"
    "9ED529077096966D670C354E4ABC9804F1746C08CA18217C32905E462E36CE3B"
    "E39E772C180E86039B2783A2EC07A28FB5C55DF06F4C52C9DE2BCBF695581718"
    "3995497CEA956AE515D2261898FA051015728E5A8AACAA68FFFFFFFFFFFFFFFF")
PRIME = int(P_HEX, 16)
GENERATOR = 2

@dataclass(frozen=True)
class KeyPair:
    sk: int
    pk: int


def keygen(rng: secrets.SystemRandom | None = None, *,
           _test_seed: int | None = None) -> KeyPair:
    """Generate (SK, PK = g^SK mod p). ``_test_seed`` for deterministic tests."""
    if _test_seed is not None:
        sk = int.from_bytes(hashlib.sha256(
            _test_seed.to_bytes(8, "big")).digest(), "big") % (PRIME - 2) + 1
    else:
        sk = (rng or secrets.SystemRandom()).randrange(2, PRIME - 1)
    return KeyPair(sk=sk, pk=pow(GENERATOR, sk, PRIME))


def shared_key(sk_k: int, pk_j: int) -> bytes:
    """CK_{k,j} = H((PK_j)^{SK_k}) — symmetric by construction (Eq. 4)."""
    s = pow(pk_j, sk_k, PRIME)
    return hashlib.sha256(s.to_bytes((s.bit_length() + 7) // 8 or 1,
                                     "big")).digest()


def prf_seed(ck: bytes) -> int:
    """H(CK) -> 63-bit PRF seed (the paper's H(CK_{k,j}) term of Eq. 5)."""
    return int.from_bytes(hashlib.sha256(ck + b"easter-mask").digest()[:8],
                          "big") >> 1


def pairwise_seeds(keys: Sequence[KeyPair]) -> Dict[Tuple[int, int], int]:
    """All passive-party pair seeds. seeds[(k, j)] == seeds[(j, k)].
    One 2048-bit modexp per unordered pair (CK is symmetric)."""
    K = len(keys)
    seeds = {}
    for k in range(K):
        for j in range(k + 1, K):
            s = prf_seed(shared_key(keys[k].sk, keys[j].pk))
            seeds[(k, j)] = seeds[(j, k)] = s
    return seeds


def seed_words(seed: int) -> Tuple[np.uint32, np.uint32]:
    """Split a 63-bit PRF seed into (hi, lo) 32-bit words, losslessly."""
    return np.uint32(seed >> 32), np.uint32(seed & 0xFFFFFFFF)


# PRF domain separation: decode rounds live at SERVE_DOMAIN + nonce * stride
# + pos and prompt-phase rounds at PREFILL_DOMAIN + nonce, so inference masks
# never coincide with training-round masks (see the reference module).
SERVE_DOMAIN = 1 << 30
PREFILL_DOMAIN = SERVE_DOMAIN | (1 << 29)
SERVE_NONCE_STRIDE = 1 << 15
MAX_SERVE_NONCE = (1 << 14) - 1


def serve_round(nonce, pos):
    """Per-lane decode-round PRF index for batched serving. Both args may
    be ints or (R,) integer tensors."""
    if isinstance(nonce, torch.Tensor) or isinstance(pos, torch.Tensor):
        nonce = torch.as_tensor(nonce, dtype=torch.int32)
        pos = torch.as_tensor(pos, dtype=torch.int32)
    return SERVE_DOMAIN + nonce * SERVE_NONCE_STRIDE + pos


RING_MODES = ("int32", "int8")


def mask_dtype(mode: str) -> torch.dtype:
    """Element dtype of a mask / blinded-uplink array for a wire mode."""
    if mode == "int32":
        return torch.int32
    if mode == "int8":
        return torch.int8
    return torch.float32


# ---------------------------------------------------------------------------
# threefry2x32 (the reference's jax.random PRF), uint32 words held in int64
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds. Keys and counters are Python ints or
    int64 tensors holding uint32 values; the result has the same form."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> Tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed."""
    return 0, int(seed) & _M32


def fold_in(key: Tuple[int, int], data: int) -> Tuple[int, int]:
    """``jax.random.fold_in`` for threefry keys (data taken as uint32)."""
    return threefry2x32(key[0], key[1], 0, int(data) & _M32)


def random_bits(keys, n: int, device) -> torch.Tensor:
    """uint32 bits (held in int64) of ``jax.random.bits(key, shape)`` for
    a shape of ``n`` elements, under partitionable threefry.

    ``keys`` is one (k1, k2) pair, giving shape (n,), or a sequence of P
    pairs, giving (P, n)."""
    single = isinstance(keys[0], (int, np.integer))
    kk = torch.tensor([keys] if single else list(keys), dtype=torch.int64,
                      device=device)
    k1, k2 = kk[:, :1], kk[:, 1:]
    counts = torch.arange(n, dtype=torch.int64, device=device)[None]
    b1, b2 = threefry2x32(k1, k2, counts >> 32, counts & _M32)
    bits = b1 ^ b2
    return bits[0] if single else bits


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

# Giles' single-precision erfinv ("Approximating the erfinv function", GPU
# Computing Gems, 2011), the polynomial XLA lowers ``lax.erf_inv`` to for
# float32. torch.erfinv is a different approximation and differs from XLA
# by up to 1.5e-5 in the tails; this one agrees to one float32 ulp.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by Giles' polynomial, for |x| < 1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _ERFINV_W_LT_5[0], _ERFINV_W_GE_5[0])
    for c_lt, c_ge in zip(_ERFINV_W_LT_5[1:], _ERFINV_W_GE_5[1:]):
        p = torch.where(small, c_lt, c_ge) + p * w
    return p * x


def bits_to_normal(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal`` (float32) from its uint32 bits: uniform on
    [nextafter(-1, 0), 1) by the mantissa trick, then sqrt(2) * erfinv."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    floats = f - 1.0
    lo = torch.tensor(_NORMAL_LO, dtype=torch.float32, device=bits.device)
    span = torch.tensor(1.0, dtype=torch.float32, device=bits.device) - lo
    u = torch.maximum(lo, floats * span + lo)
    return erfinv_f32(u) * torch.tensor(math.sqrt(2), dtype=torch.float32)


def bits_to_int8(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint8).astype(int8)``: the low byte,
    reinterpreted as two's complement."""
    return (((bits & 0xFF) ^ 0x80) - 0x80).to(torch.int8)


# int32.max - int32.min as uint32: the span of the reference's int32 masks
_I32_SPAN = 0xFFFFFFFF


def randint_int32(keys, n: int, device) -> torch.Tensor:
    """``jax.random.randint(key, (n,), int32.min, int32.max, int32)``
    under partitionable threefry, bit for bit (jax/_src/random.py
    ``_randint``). jax splits the key in two (``split`` is threefry of the
    counters (0, 0) and (0, 1)), draws 32 bits ``hi`` and ``lo`` from the
    halves and returns int32.min + ((hi % span) * m + lo % span) % span,
    with span = 2^32 - 1 and m = (2^16 % span)^2 % span taken in uint32:
    65536 * 65536 wraps to 0, so m = 0 and only ``lo`` enters. ``keys`` as
    for ``random_bits``."""
    single = isinstance(keys[0], (int, np.integer))
    pairs = [keys] if single else list(keys)
    k_lo = [threefry2x32(k1, k2, 0, 1) for k1, k2 in pairs]
    off = random_bits(k_lo, n, device) % _I32_SPAN
    out = (off - (1 << 31)).to(torch.int32)
    return out[0] if single else out


def _pair_key(hi, lo, round_idx: int) -> Tuple[int, int]:
    return fold_in(fold_in(prng_key(int(hi)), int(lo)), int(round_idx))


def _draw(keys, n: int, mode: str, device) -> torch.Tensor:
    """Masks of ``n`` elements for one key (n,) or a list of keys (P, n)."""
    if mode == "int32":
        return randint_int32(keys, n, device)
    bits = random_bits(keys, n, device)
    if mode == "int8":
        return bits_to_int8(bits)
    if mode == "float":
        return bits_to_normal(bits)
    raise ValueError(f"mask mode {mode!r}")


def _mask_from_words(hi, lo, round_idx, mshape, mode: str,
                     device=None) -> torch.Tensor:
    """The one PRF construction every mask path derives from: key by the
    63-bit pair seed as two 32-bit words, fold in the round, expand to
    ``mshape``. ``round_idx`` may be a sequence of per-lane rounds, in
    which case ``mshape`` leads with the lane axis."""
    device = resolve_device(device)
    mshape = tuple(mshape)
    if isinstance(round_idx, torch.Tensor):
        round_idx = round_idx.tolist()
    if isinstance(round_idx, (list, tuple)):
        if not mshape or mshape[0] != len(round_idx):
            raise ValueError(f"per-lane rounds ({len(round_idx)},) need a "
                             f"leading lane axis on mshape, got {mshape}")
        return torch.stack([_mask_from_words(hi, lo, r, mshape[1:], mode,
                                             device) for r in round_idx])
    n = math.prod(mshape)
    return _draw(_pair_key(hi, lo, round_idx), n, mode, device).reshape(mshape)


def pair_mask(seed: int, shape, round_idx=0, mode: str = "float",
              scalar: bool = False, device=None) -> torch.Tensor:
    """PRF(CK_{k,j}, round) expanded to one pair's mask."""
    hi, lo = seed_words(seed)
    return _mask_from_words(hi, lo, round_idx, () if scalar else shape,
                            mode, device)


def party_mask(k: int, n_passive: int, seeds: Dict[Tuple[int, int], int],
               shape, round_idx=0, mode: str = "float",
               scalar: bool = False, scale: float = 1.0,
               device=None) -> torch.Tensor:
    """r_{l_k} = sum_j (-1)^{k>j} PRF(CK_{k,j})  (Eq. 5, per-element form).
    Loop oracle, ascending j, same addition order as the reference."""
    device = resolve_device(device)
    shape = tuple(shape)
    total = torch.zeros(() if scalar else shape, dtype=mask_dtype(mode),
                        device=device)
    for j in range(n_passive):
        if j == k:
            continue
        m = pair_mask(seeds[(min(k, j), max(k, j))], shape, round_idx, mode,
                      scalar, device)
        total = total - m if k > j else total + m
    if scalar:
        total = total.expand(shape)
    if mode == "float" and scale != 1.0:
        total = total * scale
    return total


def all_party_masks(n_passive: int, seeds, shape, round_idx=0,
                    mode: str = "float", scalar: bool = False,
                    scale: float = 1.0, device=None) -> torch.Tensor:
    """(K, *shape) stacked masks, one per passive party (loop oracle)."""
    device = resolve_device(device)
    return torch.stack([
        party_mask(k, n_passive, seeds, shape, round_idx, mode, scalar,
                   scale, device)
        for k in range(n_passive)])


# ---------------------------------------------------------------------------
# batched mask engine
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MaskEngine:
    """Batched pairwise-mask synthesis.

    ``seed_hi``/``seed_lo`` (K, K-1) uint32: row k holds the pair seeds
    CK_{k,j} for j != k in ascending-j order, split into 32-bit words.
    ``signs`` (K, K-1) int32: the (-1)^{k>j} coefficient of Eq. 5.
    """
    n_passive: int
    seed_hi: np.ndarray
    seed_lo: np.ndarray
    signs: np.ndarray

    @classmethod
    def from_seeds(cls, n_passive: int,
                   seeds: Dict[Tuple[int, int], int]) -> "MaskEngine":
        K = n_passive
        hi = np.zeros((K, max(K - 1, 1)), np.uint32)
        lo = np.zeros((K, max(K - 1, 1)), np.uint32)
        sg = np.zeros((K, max(K - 1, 1)), np.int32)
        for k in range(K):
            col = 0
            for j in range(K):
                if j == k:
                    continue
                h, l = seed_words(seeds[(min(k, j), max(k, j))])
                hi[k, col], lo[k, col] = h, l
                sg[k, col] = 1 if k < j else -1
                col += 1
        return cls(n_passive=K, seed_hi=hi, seed_lo=lo, signs=sg)

    def masks(self, shape, round_idx=0, mode: str = "float",
              scalar: bool = False, scale: float = 1.0,
              device=None, *, group=None, rows=None) -> torch.Tensor:
        """(K, *shape) stacked masks, equal to ``all_party_masks``.

        Every distinct pair mask is drawn once, in one batched threefry
        call; the per-party sums are a left fold over the ascending-j pair
        axis, the loop oracle's addition order. ``round_idx`` may be an
        (R,) sequence or tensor of per-lane rounds (batched serving):
        ``shape`` then leads with the lane axis R and each lane's slice is
        drawn under its own round, as R scalar calls of ``shape[1:]``.

        ``group`` (a ``party_group.PartyGroup``, the sharded engine): only
        this rank's rows, ``group.rows(K)`` (all K where K does not divide
        over the group, as the reference's ``mesh=``). ``rows``: those
        party rows, in that order. Only the pairs of those rows are drawn,
        so no rank makes, and no collective carries, another rank's masks;
        each row equals its row of the full tensor bit for bit."""
        device = resolve_device(device)
        K = self.n_passive
        if group is not None:
            rows = group.rows(K)
        sel = list(range(K)) if rows is None else [int(k) for k in rows]
        shape = tuple(shape)
        mshape = () if scalar else shape
        if isinstance(round_idx, torch.Tensor):
            round_idx = round_idx.tolist()
        lanes = (list(round_idx) if isinstance(round_idx, (list, tuple))
                 else None)
        if lanes is not None and (not mshape or mshape[0] != len(lanes)):
            raise ValueError(f"per-lane rounds ({len(lanes)},) need a "
                             f"leading lane axis on the shape, got {mshape}")
        n = math.prod(mshape)
        words = sorted({(int(h), int(l)) for h, l in
                        zip(self.seed_hi[sel, :K - 1].ravel(),
                            self.seed_lo[sel, :K - 1].ravel())})
        row = {w: i for i, w in enumerate(words)}
        M = len(sel)
        total = torch.zeros((M,) + mshape, dtype=mask_dtype(mode),
                            device=device)
        if words:
            # one draw of n / R elements per (lane, pair) key, laid out as
            # the lanes' consecutive slices of each pair's mask (R = 1:
            # one scalar round)
            rounds = [round_idx] if lanes is None else lanes
            R, P = len(rounds), len(words)
            keys = [_pair_key(h, l, r) for r in rounds for h, l in words]
            pm = _draw(keys, n // R, mode, device)
            pm = pm.reshape(R, P, n // R).transpose(0, 1).reshape(P, n)
            idx = torch.tensor([[row[(int(h), int(l))] for h, l in
                                 zip(self.seed_hi[k, :K - 1],
                                     self.seed_lo[k, :K - 1])]
                                for k in sel], device=device)
            coeff = torch.as_tensor(self.signs[sel, :K - 1],
                                    device=device).to(total.dtype)
            terms = pm[idx] * coeff[..., None]        # (M, K-1, n)
            flat = total.reshape(M, n)
            for j in range(K - 1):
                flat = flat + terms[:, j]
            total = flat.reshape((M,) + mshape)
        if scalar:
            total = total.reshape((M,) + (1,) * len(shape))
        if mode == "float" and scale != 1.0:
            total = total * scale
        if scalar:
            total = total.expand((M,) + shape)
        return total


@dataclass(frozen=True)
class FusedMasks:
    """Marker standing in for a materialized (K, *shape) mask tensor: the
    masks are made inside the fused blind+aggregate kernel
    (``kernels.ops.blind_agg_prng``) from the round and the MaskEngine's
    seed tables."""
    round_idx: int


# ---------------------------------------------------------------------------
# fixed-point quantization for the ring wire modes
# ---------------------------------------------------------------------------

FIXED_POINT_SCALE = 2 ** 16
# int8 dynamic scale: keep |sum_C round(x_i * scale)| <= 127 so the true
# aggregate of C quantized embeddings fits one ring element (per-party
# rounding adds <= 0.5 each, hence the 0.5*C headroom taken off 127).
INT8_LIMIT = 127.0


def quantize(x: torch.Tensor, scale: int = FIXED_POINT_SCALE) -> torch.Tensor:
    """Fixed point on Z_2^32. Exact for |x| * scale < 2^31 (|x| < 32768 at
    the static scale): out-of-range float -> int32 conversion differs
    between the CPU and CUDA."""
    return torch.round(x.float() * scale).to(torch.int32)


def ring_scale(amax, C: int, mode: str) -> torch.Tensor:
    """Quantization scale of a ring mode: the static 2^16 for int32; for
    int8 the per-round (127 - 0.5*C) / (C * amax), amax = max |E| over
    every party, detached like the reference's ``stop_gradient``."""
    if mode == "int32":
        dev = amax.device if isinstance(amax, torch.Tensor) else None
        return torch.tensor(float(FIXED_POINT_SCALE), dtype=torch.float32,
                            device=dev)
    if mode != "int8":
        raise ValueError(f"ring mode {mode!r}")
    if not C < 2 * INT8_LIMIT:
        raise ValueError(f"C={C} leaves no int8 headroom")
    amax = torch.as_tensor(amax, dtype=torch.float32).detach()
    # a 0-d tensor numerator: torch evaluates python-scalar / tensor as
    # reciprocal * scalar, which rounds differently from XLA's divide
    num = torch.tensor(INT8_LIMIT - 0.5 * C, dtype=torch.float32,
                       device=amax.device)
    return num / (C * torch.clamp_min(amax, 1e-6))


def quantize_ring(x: torch.Tensor, mode: str, scale=None) -> torch.Tensor:
    """Quantize onto the mode's ring. int8 goes float -> int32 -> int8, so
    an out-of-range value wraps mod 256 (the int cast truncates bits)
    instead of clamping, which would break ring cancellation."""
    if mode == "int32":
        return quantize(x)
    if mode != "int8":
        raise ValueError(f"ring mode {mode!r}")
    if scale is None:
        raise ValueError("int8 quantization needs the per-round scale")
    return torch.round(x.float() * scale).to(torch.int32).to(torch.int8)


def dequantize(x: torch.Tensor, scale=FIXED_POINT_SCALE) -> torch.Tensor:
    """Inverse of ``quantize``/``quantize_ring`` (elementwise)."""
    return x.float() / scale


# ---------------------------------------------------------------------------
# the wire format + byte accounting + int8 word packing
# ---------------------------------------------------------------------------


def blind_uplink(E: torch.Tensor, masks, mask_mode: str,
                 scale=None) -> torch.Tensor:
    """The wire format of a passive party's uplink: float mode ships
    E + r, int32 mode quantize(E) + r in Z_2^32, int8 mode
    quantize_ring(E, scale) + r in Z_2^8 (torch's int32 and int8 adds
    wrap); masks=None ships raw (the caller's explicit unblinded
    oracle)."""
    if masks is None:
        return E
    if mask_mode in RING_MODES:
        return quantize_ring(E, mask_mode, scale) + masks
    return E + masks.to(E.dtype)


def wire_elt_bytes(mode: str) -> int:
    """Bytes per ring/float element on the wire (unpacked view)."""
    return 1 if mode == "int8" else 4


def wire_leg_bytes(n_elts: int, mode: str) -> int:
    """Bytes one leg (one party, one direction) ships for ``n_elts``
    payload elements: int8 packs 4 ring elements per int32 word (padded)
    plus the fp32 scale scalar; float/int32 ship 4-byte elements."""
    if mode == "int8":
        return 4 * ((n_elts + 3) // 4) + 4
    return 4 * n_elts


def pack_int8_words(x) -> np.ndarray:
    """Flatten int8 ring elements into little-endian int32 wire words
    (4 elements per word, zero-padded)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    flat = np.ascontiguousarray(np.asarray(x, np.int8).reshape(-1))
    pad = (-flat.size) % 4
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.int8)])
    return flat.view("<i4")


def unpack_int8_words(words, shape) -> np.ndarray:
    """Inverse of ``pack_int8_words`` for a known payload shape."""
    n = int(np.prod(shape)) if shape else 1
    flat = np.ascontiguousarray(np.asarray(words, "<i4")).view(np.int8)
    return flat[:n].reshape(shape)


# ---------------------------------------------------------------------------
# key ceremony
# ---------------------------------------------------------------------------


def setup_passive_parties(n_passive: int, *, deterministic_seed: int | None
                          = None) -> Tuple[List[KeyPair], Dict]:
    """Full key ceremony for K passive parties. Returns (keys, pair seeds)."""
    keys = [keygen(_test_seed=(None if deterministic_seed is None
                               else deterministic_seed * 131 + k))
            for k in range(n_passive)]
    return keys, pairwise_seeds(keys)


def setup_mask_engine(n_passive: int, *, deterministic_seed: int | None
                      = None) -> MaskEngine:
    """Key ceremony + packed seed layout in one call."""
    _, seeds = setup_passive_parties(n_passive,
                                     deterministic_seed=deterministic_seed)
    return MaskEngine.from_seeds(n_passive, seeds)


@functools.lru_cache(maxsize=None)
def cached_passive_setup(n_passive: int, deterministic_seed: int
                         ) -> Tuple[List[KeyPair], Dict]:
    """Memoized ``setup_passive_parties`` (deterministic seeds only: a
    production ceremony draws fresh secret keys and is never reused)."""
    assert deterministic_seed is not None, \
        "production ceremonies (deterministic_seed=None) must not be memoized"
    return setup_passive_parties(n_passive,
                                 deterministic_seed=deterministic_seed)


@functools.lru_cache(maxsize=None)
def cached_mask_engine(n_passive: int, deterministic_seed: int) -> MaskEngine:
    """Memoized ceremony + packed (K, K-1) seed-word layout."""
    _, seeds = cached_passive_setup(n_passive, deterministic_seed)
    return MaskEngine.from_seeds(n_passive, seeds)
