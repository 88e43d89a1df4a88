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


def chunked_lm_head_xent(h: torch.Tensor, head_w: torch.Tensor,
                         labels: torch.Tensor, chunk: int = 512,
                         reduction: str = "mean") -> torch.Tensor:
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
    sharding plan's share of the global mean)."""
    B, S, _ = h.shape
    if S % chunk or S <= chunk:
        if reduction == "sum":
            return softmax_xent(h @ head_w, labels) * (B * S)
        return softmax_xent(h @ head_w, labels)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for s0 in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_xent_sum, h[:, s0:s0 + chunk], head_w,
            labels[:, s0:s0 + chunk], use_reentrant=False,
            preserve_rng_state=False)
    return total if reduction == "sum" else total / (B * S)


LOSSES = {"ce": softmax_xent, "bce": binary_xent, "mse": mse, "lm": lm_xent}
