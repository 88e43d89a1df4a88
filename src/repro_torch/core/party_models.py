"""Paper-scale heterogeneous party models (MLP / CNN / LeNet-style).

PyTorch counterpart of ``repro.core.party_models``. Every party model is
split into the paper's two halves:

  * ``embed``  — the embedding network h(theta_k, .):  features -> R^{d_embed}
  * ``decide`` — the decision network  p(theta_k, .):  R^{d_embed} -> logits

Parameters keep the reference's layout at the public functions: nested
dicts of tensors, NHWC images and HWIO conv weights. ``embed_fn`` converts
to ``conv2d``'s NCHW/OIHW inside. The convs are 3x3 SAME (symmetric
padding 1); the pools are XLA's SAME 2x2/2 max-pool, which pads the right
and bottom edge with -inf when a side is odd and so rounds the output up
(a 28x7 strip pools to 14x4, then 7x2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_linear, linear
from repro_torch.tree import tree_map


@dataclass(frozen=True)
class PartyArch:
    """One heterogeneous local model."""
    kind: str = "mlp"                   # mlp | cnn | lenet
    hidden: Tuple[int, ...] = (256, 128)  # EL widths (mlp) / channels (cnn)
    decision_hidden: Tuple[int, ...] = (128,)  # PL widths
    d_embed: int = 128
    n_classes: int = 10
    image_hw: Tuple[int, int] = (0, 0)  # (H, W_slice) for conv kinds; 0 = flat


# the paper's per-dataset zoos, reduced to CPU scale
ZOO = {
    "mlp_small": PartyArch("mlp", (128,), (64,)),
    "mlp": PartyArch("mlp", (256, 128), (128,)),
    "mlp_wide": PartyArch("mlp", (512, 256), (256,)),
    "cnn": PartyArch("cnn", (16, 32), (128,)),
    "lenet": PartyArch("lenet", (6, 16), (120, 84)),
}


def hetero_zoo(n_parties: int, d_embed: int, n_classes: int,
               image_hw=(0, 0)) -> List[PartyArch]:
    """Paper heterogeneous setting: each party picks a different model."""
    names = ["mlp", "cnn", "mlp_wide", "lenet", "mlp_small"]
    out = []
    for i in range(n_parties):
        a = ZOO[names[i % len(names)]]
        out.append(PartyArch(a.kind, a.hidden, a.decision_hidden, d_embed,
                             n_classes, image_hw))
    return out


def homo_zoo(n_parties: int, d_embed: int, n_classes: int,
             image_hw=(0, 0), kind: str = "mlp") -> List[PartyArch]:
    a = ZOO[kind]
    return [PartyArch(a.kind, a.hidden, a.decision_hidden, d_embed,
                      n_classes, image_hw) for _ in range(n_parties)]


# ---------------------------------------------------------------------------
# init / apply
# ---------------------------------------------------------------------------


def _conv_init(gen: torch.Generator, kh, kw, cin, cout) -> torch.Tensor:
    """HWIO conv weight, Normal(0, 1/fan_in)."""
    fan = kh * kw * cin
    return torch.randn((kh, kw, cin, cout), generator=gen,
                       dtype=torch.float32) / math.sqrt(fan)


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv on NCHW activations with an HWIO weight."""
    kh, kw = w_hwio.shape[:2]
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1),
                    padding=(kh // 2, kw // 2))


def _maxpool_same(x: torch.Tensor) -> torch.Tensor:
    """XLA SAME 2x2/2 max-pool on NCHW: -inf padding on the bottom/right
    edge of an odd side, output rounded up."""
    h, w = x.shape[-2:]
    x = F.pad(x, (0, w % 2, 0, h % 2), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


def pooled_hw(h: int, w: int) -> Tuple[int, int]:
    """Spatial size after the two SAME max-pools (ceil semantics)."""
    return -(-(-(-h // 2)) // 2), -(-(-(-w // 2)) // 2)


def init_party(gen: torch.Generator, arch: PartyArch, n_features: int,
               device=None) -> dict:
    """n_features: flat feature count of this party's vertical slice.
    Weights are drawn on the CPU from ``gen`` and moved to ``device``."""
    p: dict = {"embed": {}, "decide": {}}
    if arch.kind == "mlp":
        dims = [n_features, *arch.hidden, arch.d_embed]
        p["embed"]["layers"] = [
            init_linear(gen, dims[i], dims[i + 1], True, torch.float32)
            for i in range(len(dims) - 1)]
    else:  # cnn / lenet on an image strip (H, W_slice, C=1)
        h, w = arch.image_hw
        assert h * w == n_features, (arch.image_hw, n_features)
        c1, c2 = arch.hidden[:2]
        p["embed"]["conv1"] = _conv_init(gen, 3, 3, 1, c1)
        p["embed"]["conv2"] = _conv_init(gen, 3, 3, c1, c2)
        hh, ww = pooled_hw(h, w)
        p["embed"]["proj"] = init_linear(gen, hh * ww * c2, arch.d_embed,
                                         True, torch.float32)
    dims = [arch.d_embed, *arch.decision_hidden, arch.n_classes]
    p["decide"]["layers"] = [
        init_linear(gen, dims[i], dims[i + 1], True, torch.float32)
        for i in range(len(dims) - 1)]
    if device is not None:
        p = tree_map(lambda t: t.to(device), p)
    return p


def _mlp(layers: Sequence[dict], h: torch.Tensor) -> torch.Tensor:
    for i, lp in enumerate(layers):
        h = linear(lp, h)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def embed_fn(p: dict, arch: PartyArch, x: torch.Tensor) -> torch.Tensor:
    """h(theta_k, D_k): (B, n_features) -> (B, d_embed)."""
    if arch.kind == "mlp":
        return _mlp(p["embed"]["layers"], x)
    hgt, wid = arch.image_hw
    img = x.reshape(-1, 1, hgt, wid)                   # NCHW, one channel
    h = _maxpool_same(torch.relu(_conv_same(img, p["embed"]["conv1"])))
    h = _maxpool_same(torch.relu(_conv_same(h, p["embed"]["conv2"])))
    # flatten in the reference's NHWC order so ``proj`` keeps its layout
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return linear(p["embed"]["proj"], h)


def decide_fn(p: dict, arch: PartyArch, E: torch.Tensor) -> torch.Tensor:
    """p(theta_k, E): (B, d_embed) -> (B, n_classes) logits."""
    return _mlp(p["decide"]["layers"], E)
