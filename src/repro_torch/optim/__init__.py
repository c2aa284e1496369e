"""Optimizers (port of ``repro.optim``): AdamW so far.  Gradient
compression and learning-rate schedules come with training (ROADMAP A10,
A13)."""
from repro_torch.optim.adamw import AdamW, AdamWState, adamw, clip_by_global_norm, global_norm

__all__ = ["AdamW", "AdamWState", "adamw", "clip_by_global_norm", "global_norm"]
