"""gemma3-4b [dense] — 5:1 local:global attention, 128k ctx. [hf:google/gemma-3-1b-pt]
(own copy of the reference's ``repro.configs.gemma3_4b``)"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-4b")
def gemma3_4b() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        family="dense",
        source="[hf:google/gemma-3-1b-pt]",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
        vocab_size=262144,
        qkv_bias=False,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        act="gelu",
        window=1024,
        swa_pattern=(5, 1),   # 5 local : 1 global, repeating
        # long_500k native: sliding-window layers bound the cache; global
        # layers keep the full cache but decode is linear in seq.
        remat="full",
    )
