"""Architecture configs — importing this package registers the ported archs
(qwen3-1.7b only so far; see ``base.LATER_SLICES`` for the rest)."""
from repro_torch.configs.base import (
    LATER_SLICES,
    LM_SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    ShapeSpec,
    get_config,
    list_archs,
)
from repro_torch.configs import qwen3_1_7b  # noqa: F401  (registration)

__all__ = [
    "LATER_SLICES",
    "LM_SHAPES",
    "SHAPES_BY_NAME",
    "ArchConfig",
    "ShapeSpec",
    "get_config",
    "list_archs",
]
