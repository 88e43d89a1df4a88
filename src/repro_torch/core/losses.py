"""Loss functions (paper §IV-D: active party picks LF per task). The LM
losses wait for the LM slice."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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


LOSSES = {"ce": softmax_xent, "bce": binary_xent, "mse": mse}
