"""Flash attention (causal / sliding-window / GQA, forward only) as a CUDA
kernel.

Counterpart of ``repro.kernels.flash_attention``'s ``_flash_kernel``; the
source and its design note are ``csrc/flash_attention.cu``. This module
binds it:

  * ``flash_attention_fwd(q (B,S,Hq,hd), k/v (B,T,Hkv,hd))`` ->
    (B,S,Hq,hd) in q's dtype: softmax(q k^T / sqrt(hd) + mask) v with an
    online softmax over kv tiles and float32 m, l and acc. Query head h
    reads kv head h // (Hq / Hkv). Any S and T: tail rows are not written
    and tail columns are masked;
  * ``flash_attention``, the public function: a ``torch.autograd.Function``
    whose ``vmap`` rule folds the vmapped axis into the batch axis, so the
    grouped passive parties of ``EasterLM`` (one ``torch.func.vmap``) make
    one launch per layer. It has no backward, as the TPU kernel has none:
    it refuses inputs that require grad while grad mode is on (training
    keeps ``dot_attention`` under autograd).

The wrapper takes contiguous CUDA tensors of float32 or bfloat16 with hd
in {32, 64, 128, 256} and raises on anything else; bfloat16 runs the
wgmma + TMA kernel, whose tensor maps need each data pointer 16-byte
aligned (checked; a misaligned tensor raises, it never falls back), and
float32 the SIMT kernel. The plain version for CPU tensors is
``ref.reference_attention``, chosen by ``ops``. Each launch adds one to
``LAUNCHES["flash_attention_fwd"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)

# launches of the kernel in this process; reset with reset_launches()
LAUNCHES: Dict[str, int] = {"flash_attention_fwd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = [vp, vp, vp, vp, i32, i32, i32,
                                            i32, i32, i32, i32, i32,
                                            ctypes.c_float, i32, vp]
        lib.flash_attention_fwd.restype = i32
        lib.flash_attention_error_string.argtypes = [i32]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        ip = ctypes.POINTER(i32)
        lib.flash_attention_wgmma_info.argtypes = [i32, ip, ip, ip]
        lib.flash_attention_wgmma_info.restype = i32
        lib._argtypes_set = True
    return lib


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) contiguous on the card ->
    (B,S,Hq,hd) in q's dtype (CUDA kernel)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention_fwd takes q (B,S,Hq,hd) and k/v "
                         f"(B,T,Hkv,hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    for name, t, shape in (("q", q, (B, S, Hq, hd)), ("k", k, (B, T, Hkv, hd)),
                           ("v", v, (B, T, Hkv, hd))):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version for CPU tensors is "
                             f"ref.reference_attention), got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name}: dtype {t.dtype}; q, k and v must share "
                            f"float32 or bfloat16")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer {t.data_ptr():#x} is not "
                             f"16-byte aligned, as the bfloat16 kernel's TMA "
                             f"tensor maps need")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported (one of {HEAD_DIMS})")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"{Hq} query heads do not group over {Hkv} kv heads")
    if window < 0:
        raise ValueError(f"window {window} < 0")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T,
        Hq, Hkv, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
        _DTYPE_CODES[q.dtype], stream)
    if code != 0:
        msg = lib.flash_attention_error_string(code).decode()
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: {msg} "
                           f"({code})")
    LAUNCHES["flash_attention_fwd"] += 1
    return out


def wgmma_info(hd: int) -> Dict[str, int]:
    """The bfloat16 kernel at head dim ``hd`` as built: registers a thread,
    local memory a thread (spills) and shared memory a CTA."""
    vals = [ctypes.c_int() for _ in range(3)]
    code = _lib().flash_attention_wgmma_info(hd, *map(ctypes.byref, vals))
    if code != 0:
        raise RuntimeError(f"flash_attention_wgmma_info({hd}) failed "
                           f"({code})")
    return dict(zip(("registers", "local_bytes", "smem_bytes"),
                    (v.value for v in vals)))


class _FlashAttention(torch.autograd.Function):
    """The kernel as a function that ``torch.func.vmap`` can batch: the
    vmapped axis is folded into the batch axis ((n, B, ...) -> (n*B, ...),
    exact: every (batch, head) is independent) around one launch."""

    @staticmethod
    def forward(q, k, v, causal, window):
        return flash_attention_fwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal,
                                   window=window)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("flash_attention has no backward (as the TPU "
                           "kernel); use layers.dot_attention under autograd")

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window):
        n = info.batch_size

        def fold(x, d):
            x = x.expand((n,) + tuple(x.shape)) if d is None \
                else x.movedim(d, 0)
            return x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))

        qf, kf, vf = (fold(x, d) for x, d in zip((q, k, v), in_dims[:3]))
        out = _FlashAttention.apply(qf, kf, vf, causal, window)
        B = qf.shape[0] // n
        return out.reshape((n, B) + tuple(out.shape[1:])), 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,S,Hq,hd), k/v (B,T,Hkv,hd) on the card -> (B,S,Hq,hd) in q's
    dtype; batchable by ``torch.func.vmap``; no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward (as the TPU "
                           "kernel); call it under torch.no_grad(), or use "
                           "layers.dot_attention under autograd")
    return _FlashAttention.apply(q, k, v, bool(causal), int(window))
