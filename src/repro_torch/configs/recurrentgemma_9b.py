"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1 attn : 2 LRU
(own copy of the reference's ``repro.configs.recurrentgemma_9b``).
[arXiv:2402.19427]"""
from repro_torch.configs.base import HybridConfig, ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        source="[arXiv:2402.19427]",
        n_layers=38,
        d_model=4096,
        n_heads=16,
        n_kv_heads=1,           # MQA for the local-attention blocks
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        act="gelu",
        hybrid=HybridConfig(lru_width=4096, window=2048,
                            pattern=("lru", "lru", "attn")),
        # long_500k native: LRU state + bounded 2048-token local cache.
        remat="full",
    )
