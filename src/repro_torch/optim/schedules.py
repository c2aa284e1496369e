"""Learning-rate schedules, pure functions of the step counter (port of
``repro.optim.schedules``): each returns a 0-d float32 tensor, as the
reference returns a float32 array."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def cosine_with_warmup(
    step, base_lr: float, warmup_steps: int, total_steps: int, min_ratio: float = 0.1
) -> torch.Tensor:
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio · base_lr`` at ``total_steps`` (held after it)."""
    step = torch.as_tensor(step, dtype=_F32)
    warm = base_lr * step / max(warmup_steps, 1)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0
    )
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, base_lr: float) -> torch.Tensor:
    """``base_lr`` at every step."""
    return torch.full((), base_lr, dtype=_F32)
