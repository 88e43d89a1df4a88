"""qwen2.5-3b [dense] — GQA, QKV bias (own copy of the reference's
``repro.configs.qwen2_5_3b``)."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2.5-3b")
def qwen2_5_3b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        source="[hf:Qwen/Qwen2.5-0.5B]",
        n_layers=36,
        d_model=2048,
        n_heads=16,
        n_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        long_ctx_window=4096,   # long_500k runs only as explicit SWA variant
        remat="full",
    )
