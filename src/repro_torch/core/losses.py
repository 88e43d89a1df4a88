"""Loss functions (paper §IV-D: active party picks LF per task)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Multi-class cross-entropy. logits (..., n_cls), labels int (...)."""
    logz = F.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logz, -1, labels.long()[..., None])[..., 0]
    return -torch.mean(ll)


def binary_xent(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (8) (log base 2, as printed). probs/labels (...,)."""
    p = torch.clamp(probs.float(), 1e-7, 1 - 1e-7)
    y = labels.float()
    return -torch.mean(y * torch.log2(p) + (1 - y) * torch.log2(1 - p))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.float() - target.float()
    return torch.mean(d * d)


def lm_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Next-token LM loss. logits (B,S,V), labels (B,S)."""
    return softmax_xent(logits, labels)


def _chunk_xent_sum(hc: torch.Tensor, head_w: torch.Tensor,
                    yc: torch.Tensor) -> torch.Tensor:
    logits = (hc @ head_w).float()                        # (B, chunk, V)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, yc.long()[..., None])[..., 0]
    return torch.sum(logz - ll)


class _VocabParallelXent(torch.autograd.Function):
    """Per-token cross-entropy (...) from this rank's vocabulary block of
    the logits (..., V / m), float32, the labels global ids; ``tp``
    (``sharding.TP``) the model axis the vocabulary lies over: the
    log-sum-exp from a max all-reduce and a sum all-reduce, the label's
    logit from the rank whose block holds it (in the same sum). Backward:
    this block's softmax minus its one-hot, times the cotangent."""

    @staticmethod
    def forward(ctx, logits, labels, tp):
        mesh, n = tp.mesh, logits.shape[-1]
        mx = mesh.all_reduce(torch.amax(logits, dim=-1), ("model",), "max")
        e = torch.exp(logits - mx[..., None])
        local = labels.long() - tp.coord * n
        inside = (local >= 0) & (local < n)
        idx = torch.where(inside, local, 0)[..., None]
        ll = torch.where(inside, torch.gather(logits, -1, idx)[..., 0], 0)
        s_ll = mesh.all_reduce(torch.stack([torch.sum(e, dim=-1), ll]),
                               ("model",))
        ctx.save_for_backward(e / s_ll[0][..., None], idx, inside)
        return torch.log(s_ll[0]) + mx - s_ll[1]

    @staticmethod
    def backward(ctx, g):
        probs, idx, inside = ctx.saved_tensors
        grad = probs.scatter_add(-1, idx, -inside[..., None].to(probs.dtype))
        return grad * g[..., None], None, None


def _vocab_parallel_sum(h, head_w, y, tp) -> torch.Tensor:
    """The summed loss of h (..., d) against labels y through this rank's
    head columns ``head_w`` (d, V / m); h's cotangent summed over "model"
    (``copy_to_model``)."""
    from repro_torch.sharding import copy_to_model
    logits = (copy_to_model(h, tp.mesh) @ head_w).float()
    return torch.sum(_VocabParallelXent.apply(logits, y, tp))


def chunked_lm_head_xent(h: torch.Tensor, head_w: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512,
                         reduction: str = "mean", tp=None) -> torch.Tensor:
    """Fused LM head + cross-entropy over sequence chunks: h (B, S, d),
    head_w (d, V), labels (B, S).

    Never builds the (B, S, V) logits: each chunk's logits are reduced to
    its loss sum, and the chunk is recomputed in the backward pass
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so
    the live working set is one chunk's (B, chunk, V). The plain
    cross-entropy where the chunk does not divide S or S <= chunk, as in
    the reference. Not for use under ``torch.func.vmap`` (a checkpoint
    there fails in backward): a party group loops over its heads.
    ``reduction="sum"``: the sum over the tokens instead of the mean (a
    sharding plan's share of the global mean). ``tp`` (``sharding.TP``):
    head_w is this rank's vocabulary columns (d, V / m), and each chunk's
    (B, chunk, V / m) logits reduce over "model"
    (``_VocabParallelXent``); a chunk's recompute issues its all-reduces
    again, on every rank alike."""
    B, S, _ = h.shape
    if S % chunk or S <= chunk:
        if tp is not None:
            total = _vocab_parallel_sum(h, head_w, labels, tp)
            return total if reduction == "sum" else total / (B * S)
        if reduction == "sum":
            return softmax_xent(h @ head_w, labels) * (B * S)
        return softmax_xent(h @ head_w, labels)
    fn = (_chunk_xent_sum if tp is None else
          lambda hc, w, yc: _vocab_parallel_sum(hc, w, yc, tp))
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        total = total + checkpoint(
            fn, h[:, s0:s0 + chunk], head_w,
            labels[:, s0:s0 + chunk], use_reentrant=False,
            preserve_rng_state=False)
    return total if reduction == "sum" else total / (B * S)


LOSSES = {"ce": softmax_xent, "bce": binary_xent, "mse": mse, "lm": lm_xent}
