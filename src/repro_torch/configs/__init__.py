"""Architecture configs — importing this package registers every arch of
the reference (the paper's LSTM is not an arch of the registry)."""
from repro_torch.configs.base import (
    LM_SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    ShapeSpec,
    get_config,
    list_archs,
)
from repro_torch.configs import (  # noqa: F401  (registration)
    hubert_xlarge,
    internlm2_20b,
    jamba_1_5_large_398b,
    llava_next_mistral_7b,
    mamba2_370m,
    mixtral_8x7b,
    qwen3_1_7b,
    qwen3_32b,
    qwen3_moe_235b_a22b,
    yi_6b,
)

__all__ = [
    "LM_SHAPES",
    "SHAPES_BY_NAME",
    "ArchConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
]
