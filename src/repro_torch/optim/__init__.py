"""Optimizers (port of ``repro.optim``): AdamW and the learning-rate
schedules.  Gradient compression comes with training (ROADMAP A13b)."""
from repro_torch.optim.adamw import AdamW, AdamWState, adamw, clip_by_global_norm, global_norm
from repro_torch.optim.schedules import constant, cosine_with_warmup

__all__ = [
    "AdamW", "AdamWState", "adamw", "clip_by_global_norm", "global_norm",
    "constant", "cosine_with_warmup",
]
