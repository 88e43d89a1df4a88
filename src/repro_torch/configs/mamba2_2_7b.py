"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free. [arXiv:2405.21060]
(own copy of the reference's ``repro.configs.mamba2_2_7b``)"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-2.7b")
def mamba2_2_7b() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b",
        family="ssm",
        source="[arXiv:2405.21060]",
        n_layers=64,
        d_model=2560,
        n_heads=0,              # attention-free
        n_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        norm="rms",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
        # long_500k native: O(1) recurrent state, no token cache.
        remat="full",
    )
