"""Architecture config registry of the port.

``ARCH_MODULES`` lists the module-per-architecture files ported so far;
importing them registers each config under its public ``--arch`` id.
"""

ARCH_MODULES = [
    "qwen2_5_3b",
    "qwen2_1_5b",
    "recurrentgemma_9b",
]
