"""The paper's own experimental configs (MLP/CNN-scale parties, d_embed=128).

These are the CPU-runnable configs used by the accuracy benchmarks
(Tables II/IV/V/VI, Fig. 6), mirroring the paper's §V-A setup: C = 4 parties,
batch 128, embedding size 128, EL:PL = 1:1.

Own copy of the reference's ``repro.configs.easter_paper``.
"""
from repro_torch.configs.base import EasterConfig, ModelConfig, TrainConfig, register


@register("easter-mlp")
def easter_mlp() -> ModelConfig:
    # stand-in for the paper's MNIST/FMNIST MLP party
    return ModelConfig(
        name="easter-mlp", family="dense", source="[EASTER §V-A]",
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=256, dtype="float32",
    )


def paper_easter_config(num_passive: int = 3) -> EasterConfig:
    return EasterConfig(num_passive=num_passive, d_embed=128,
                        mask_mode="float", decision_layers=2)


def paper_train_config() -> TrainConfig:
    return TrainConfig(optimizer="sgd", lr=0.01, batch=128, steps=300)
