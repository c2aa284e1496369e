"""Architecture configs — importing this package registers the ported archs
(the dense qwen3-1.7b, yi-6b, internlm2-20b and qwen3-32b, and mamba2-370m
so far; see ``base.LATER_SLICES`` for the rest)."""
from repro_torch.configs.base import (
    LATER_SLICES,
    LM_SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    ShapeSpec,
    get_config,
    list_archs,
)
from repro_torch.configs import (  # noqa: F401  (registration)
    internlm2_20b,
    mamba2_370m,
    qwen3_1_7b,
    qwen3_32b,
    yi_6b,
)

__all__ = [
    "LATER_SLICES",
    "LM_SHAPES",
    "SHAPES_BY_NAME",
    "ArchConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
]
