"""Architecture configs — importing this package registers the ported archs
(qwen3-1.7b and mamba2-370m so far; see ``base.LATER_SLICES`` for the
rest)."""
from repro_torch.configs.base import (
    LATER_SLICES,
    LM_SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    ShapeSpec,
    get_config,
    list_archs,
)
from repro_torch.configs import mamba2_370m, qwen3_1_7b  # noqa: F401  (registration)

__all__ = [
    "LATER_SLICES",
    "LM_SHAPES",
    "SHAPES_BY_NAME",
    "ArchConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
]
