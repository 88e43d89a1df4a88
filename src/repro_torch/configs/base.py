"""Protocol and training configuration (own copy of the reference's
``repro.configs.base.EasterConfig`` and ``TrainConfig``; the LLM
``ModelConfig`` registry is not ported yet)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EasterConfig:
    """EASTER protocol configuration (paper §IV)."""
    num_passive: int = 3            # K; C = K + 1 (paper uses C = 4)
    d_embed: int = 128              # shared embedding space (paper Fig. 6: 128)
    mask_mode: str = "float"        # float (paper) | int32 | int8 (ring wire)
    fresh_masks: bool = True        # per-round PRF fold-in (beyond-paper)
    decision_layers: int = 2        # PL depth; paper finds EL:PL = 1:1 best
    # passive parties run reduced "proxy" backbones (heterogeneous setting):
    passive_depth_frac: float = 0.25
    passive_width_frac: float = 1.0
    # passive parties of an MoE active use dense FFN proxies (LLM system)
    moe_dense_passive: bool = False
    enabled: bool = True


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"         # sgd | momentum | adagrad | adam
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    param_dtype: str = "float32"
    batch: int = 8
    seq: int = 128
    steps: int = 100
    seed: int = 0
