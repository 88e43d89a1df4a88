"""command-r-plus-104b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01]
(own copy of the reference's ``repro.configs.command_r_plus_104b``)"""
from repro_torch.configs.base import ModelConfig, register


@register("command-r-plus-104b")
def command_r_plus_104b() -> ModelConfig:
    return ModelConfig(
        name="command-r-plus-104b",
        family="dense",
        source="[hf:CohereForAI/c4ai-command-r-v01]",
        n_layers=64,
        d_model=12288,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=33792,
        vocab_size=256000,
        qkv_bias=False,
        rope_theta=75_000_000.0,
        tie_embeddings=True,
        act="silu",
        long_ctx_window=4096,
        remat="full",
    )
