"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed experts top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B]
(own copy of the reference's ``repro.configs.qwen2_moe_a2_7b``)"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen2-moe-a2.7b")
def qwen2_moe_a2_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        source="[hf:Qwen/Qwen1.5-MoE-A2.7B]",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1408,             # per-expert FFN size (as assigned)
        vocab_size=151936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=60, top_k=4, n_shared_experts=4,
                      d_expert_ff=1408),
        long_ctx_window=4096,
        remat="full",
    )
