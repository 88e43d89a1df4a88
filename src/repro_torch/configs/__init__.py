"""Architecture config registry of the port.

``ARCH_MODULES`` lists the module-per-architecture files, all 11 of the
reference's; importing them registers each config under its public
``--arch`` id.
"""

ARCH_MODULES = [
    "qwen2_5_3b",
    "qwen2_1_5b",
    "recurrentgemma_9b",
    "gemma3_4b",
    "command_r_plus_104b",
    "qwen2_moe_a2_7b",
    "qwen3_moe_235b_a22b",
    "mamba2_2_7b",
    "whisper_small",
    "qwen2_vl_7b",
    "easter_paper",
]
