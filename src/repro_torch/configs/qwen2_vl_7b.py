"""qwen2-vl-7b [vlm] — M-RoPE, vision tower stubbed (own copy of the
reference's ``repro.configs.qwen2_vl_7b``). [arXiv:2409.12191]

The ViT and its projector are a stub: callers supply precomputed patch
embeddings (B, 1024, d) (``models.build.frontend_inputs``); M-RoPE
position ids (3, B, S) are an explicit input of ``apply_lm``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-7b")
def qwen2_vl_7b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        source="[arXiv:2409.12191]",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        n_vision_tokens=1024,
        mrope_sections=(16, 24, 24),   # t/h/w sections of head_dim/2
        long_ctx_window=4096,
        remat="full",
    )
