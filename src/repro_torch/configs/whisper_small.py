"""whisper-small [audio] — encoder-decoder, conv frontend stubbed (own
copy of the reference's ``repro.configs.whisper_small``).
[arXiv:2212.04356]

The mel-spectrogram + conv feature extractor is a stub: callers supply
precomputed frame embeddings (B, 1500, d) (``models.build.frontend_inputs``).
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-small")
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="encdec",
        source="[arXiv:2212.04356]",
        n_layers=12,            # decoder layers
        n_encoder_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51865,
        qkv_bias=True,
        act="gelu",
        norm="layer",
        n_audio_frames=1500,
        rope_theta=0.0,         # learned positions in the original; fixed
                                # sinusoids here (the same shapes)
        remat="full",
    )
