"""The RG-LRU diagonal linear recurrence (forward only) as a CUDA kernel.

Counterpart of ``repro.kernels.rg_lru``'s ``_rglru_kernel``; the source
and its design note are ``csrc/rg_lru.cu``. This module binds it:

  * ``rglru_scan_fwd(a, b (B,L,W), h0 (B,W))`` -> (h (B,L,W), h_last
    (B,W)), both float32: h_t = a_t * h_{t-1} + b_t from h_{-1} = h0, with
    a and b float32 or bfloat16 (one dtype) and h0 float32. Any B, L, W.
    It chooses the kernel by shape (``kernel_path``): the TMA ring when
    L > 0, B <= 65535, a row of a and b is a multiple of 16 bytes (W % 4
    == 0 in float32, W % 8 == 0 in bfloat16) and a and b start 16-byte
    aligned;
    otherwise the kernel of one thread per column. Both are bit for bit
    the plain version; the choice is made before the launch, never by
    retrying after a failure;
  * ``rglru_scan``, the public function: a ``torch.autograd.Function``
    whose ``vmap`` rule folds the vmapped axis into the batch axis
    ((n, B, L, W) -> (n*B, L, W) and h0 (n, B, W) -> (n*B, W), exact:
    every column is independent), so the grouped passive parties of
    ``EasterLM`` (one ``torch.func.vmap``) make one launch per layer. It
    has no backward, as the TPU kernel has none: it refuses inputs that
    require grad while grad mode is on.

The wrapper takes contiguous CUDA tensors and raises on anything else;
the plain version for CPU tensors is ``ref.reference_rglru``, chosen by
``ops``. Each launch adds one to ``LAUNCHES["rglru_scan_fwd"]`` and one to
``PATH_LAUNCHES`` under the path it took ("tma" or "per_column").
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# launches of the kernel in this process; reset with reset_launches()
LAUNCHES: Dict[str, int] = {"rglru_scan_fwd": 0}
# the same launches by the kernel path they took
PATH_LAUNCHES: Dict[str, int] = {"tma": 0, "per_column": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, PATH_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("rg_lru")
    if not getattr(lib, "_argtypes_set", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rglru_scan_fwd.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                       i32, vp]
        lib.rglru_scan_fwd.restype = i32
        ip = ctypes.POINTER(i32)
        lib.rglru_tma_info.argtypes = [i32, ip, ip, ip]
        lib.rglru_tma_info.restype = i32
        lib.rglru_error_string.argtypes = [i32]
        lib.rglru_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def kernel_path(a: torch.Tensor, b: torch.Tensor) -> str:
    """The kernel ``rglru_scan_fwd`` launches for a and b (B, L, W) of one
    dtype: "tma" where TMA takes their rows, else "per_column"."""
    B, L, W = a.shape
    if L > 0 and B <= 65535 and (W * a.element_size()) % 16 == 0 and \
            a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0:
        return "tma"
    return "per_column"


def tma_info(dtype: torch.dtype) -> Dict[str, int]:
    """The TMA kernel as built for a and b of ``dtype``: registers a
    thread, local memory a thread (spills) and shared memory a CTA."""
    lib = _lib()
    regs, local, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    code = lib.rglru_tma_info(_DTYPE_CODES[dtype], ctypes.byref(regs),
                              ctypes.byref(local), ctypes.byref(smem))
    if code != 0:
        raise RuntimeError(f"rglru_tma_info: "
                           f"{lib.rglru_error_string(code).decode()}")
    return {"registers": regs.value, "local_bytes": local.value,
            "smem_bytes": smem.value}


def rglru_scan_fwd(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a/b (B,L,W), h0 (B,W) float32, contiguous on the card -> (h (B,L,W)
    float32, h_last (B,W) float32) (CUDA kernel; the path by shape, see
    ``kernel_path``)."""
    if a.dim() != 3 or b.dim() != 3 or h0.dim() != 2:
        raise ValueError(f"rglru_scan_fwd takes a/b (B,L,W) and h0 (B,W), "
                         f"got {tuple(a.shape)}, {tuple(b.shape)}, "
                         f"{tuple(h0.shape)}")
    B, L, W = a.shape
    for name, t, shape in (("a", a, (B, L, W)), ("b", b, (B, L, W)),
                           ("h0", h0, (B, W))):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor (the plain "
                             f"version for CPU tensors is "
                             f"ref.reference_rglru), got {t.device}")
        if t.device != a.device:
            raise ValueError(f"{name} is on {t.device}, expected {a.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype != b.dtype or a.dtype not in _DTYPE_CODES:
        raise TypeError(f"a and b: dtypes {a.dtype}, {b.dtype}; they must "
                        f"share float32 or bfloat16")
    if h0.dtype != torch.float32:
        raise TypeError(f"h0: dtype {h0.dtype}, expected float32")
    h = torch.empty((B, L, W), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, W), dtype=torch.float32, device=a.device)
    if B * W == 0:
        return h, h_last
    path = kernel_path(a, b)
    lib = _lib()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.rglru_scan_fwd(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                              h.data_ptr(), h_last.data_ptr(), B, L, W,
                              _DTYPE_CODES[a.dtype], int(path == "tma"),
                              stream)
    if code != 0:
        msg = lib.rglru_error_string(code).decode()
        raise RuntimeError(f"rglru_scan_fwd kernel launch failed ({path} "
                           f"path): {msg} ({code})")
    LAUNCHES["rglru_scan_fwd"] += 1
    PATH_LAUNCHES[path] += 1
    return h, h_last


class _RGLRUScan(torch.autograd.Function):
    """The kernel as a function that ``torch.func.vmap`` can batch: the
    vmapped axis is folded into the batch axis around one launch."""

    @staticmethod
    def forward(a, b, h0):
        return rglru_scan_fwd(a.contiguous(), b.contiguous(),
                              h0.float().contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, gh, gl):
        raise RuntimeError("rglru_scan has no backward (as the TPU kernel)")

    @staticmethod
    def vmap(info, in_dims, a, b, h0):
        n = info.batch_size

        def fold(x, d):
            x = x.expand((n,) + tuple(x.shape)) if d is None \
                else x.movedim(d, 0)
            return x.reshape((n * x.shape[1],) + tuple(x.shape[2:]))

        af, bf, hf = (fold(x, d) for x, d in zip((a, b, h0), in_dims))
        h, h_last = _RGLRUScan.apply(af, bf, hf)
        B = af.shape[0] // n
        return ((h.reshape((n, B) + tuple(h.shape[1:])),
                 h_last.reshape((n, B) + tuple(h_last.shape[1:]))), (0, 0))


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a/b (B,L,W), h0 (B,W) on the card -> (h (B,L,W), h_last (B,W)) in
    float32; batchable by ``torch.func.vmap``; no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (a, b, h0)):
        raise RuntimeError("rglru_scan has no backward (as the TPU kernel); "
                           "call it under torch.no_grad()")
    return _RGLRUScan.apply(a, b, h0)
