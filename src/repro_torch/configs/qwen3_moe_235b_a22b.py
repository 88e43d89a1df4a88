"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B]
(own copy of the reference's ``repro.configs.qwen3_moe_235b_a22b``)"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def qwen3_moe_235b_a22b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        source="[hf:Qwen/Qwen3-30B-A3B]",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,           # per-expert FFN size (as assigned)
        vocab_size=151936,
        qkv_bias=False,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=128, top_k=8, n_shared_experts=0,
                      d_expert_ff=1536),
        long_ctx_window=4096,
        remat="full",
    )
