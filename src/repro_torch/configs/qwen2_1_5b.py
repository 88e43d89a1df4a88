"""qwen2-1.5b [dense] — GQA, QKV bias (own copy of the reference's
``repro.configs.qwen2_1_5b``)."""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-1.5b")
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        source="[arXiv:2407.10671]",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        long_ctx_window=4096,
        remat="full",
    )
