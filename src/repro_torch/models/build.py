"""Config -> model functions (counterpart of ``repro.models.build``), for
the dense and hybrid (RG-LRU) families."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init: Callable          # (gen) -> params
    apply: Callable         # (params, tokens, **kw) -> (logits, caches, aux)
    init_cache: Callable    # (batch, cache_len, window_override=-1) -> caches


def build(cfg: ModelConfig) -> ModelFns:
    transformer._check_family(cfg)

    def init(gen):
        return transformer.init_lm(gen, cfg)

    def apply(params, tokens, **kw):
        return transformer.apply_lm(params, tokens, cfg, **kw)

    def init_cache(batch, cache_len, window_override: int = -1, device=None):
        return transformer.init_cache(cfg, batch, cache_len, window_override,
                                      device=device)

    return ModelFns(cfg=cfg, init=init, apply=apply, init_cache=init_cache)
