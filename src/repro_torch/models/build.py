"""Config -> model functions (counterpart of ``repro.models.build``), and
the stubbed modality frontends' inputs."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch

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


def frontend_inputs(cfg: ModelConfig, batch: int, gen: torch.Generator,
                    device=None, dtype=None) -> Dict[str, torch.Tensor]:
    """Stubbed modality-frontend embeddings, unit normals from ``gen`` on
    its own device, moved to ``device`` (default: the generator's) in
    ``dtype`` (default: the config's): whisper's conv/mel output
    ``audio_embed`` (B, n_audio_frames, d_model), qwen2-vl's ViT patch
    embeddings ``vision_embed`` (B, n_vision_tokens, d_model); none for
    other families."""
    dtype = dtype or transformer.torch_dtype(cfg.dtype)
    device = gen.device if device is None else device
    n = {"encdec": ("audio_embed", cfg.n_audio_frames),
         "vlm": ("vision_embed", cfg.n_vision_tokens)}.get(cfg.family)
    if n is None or not n[1]:
        return {}
    x = torch.randn((batch, n[1], cfg.d_model), generator=gen,
                    device=gen.device)
    return {n[0]: x.to(device=device, dtype=dtype)}

