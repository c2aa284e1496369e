"""Optimizers (port of ``repro.optim``): AdamW, the learning-rate
schedules and int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import AdamW, AdamWState, adamw, clip_by_global_norm, global_norm
from repro_torch.optim.grad_compress import (
    CompressState, compress_psum, dequantize, error_feedback, init_error, quantize,
)
from repro_torch.optim.schedules import constant, cosine_with_warmup

__all__ = [
    "AdamW", "AdamWState", "adamw", "clip_by_global_norm", "global_norm",
    "CompressState", "compress_psum", "dequantize", "error_feedback", "init_error", "quantize",
    "constant", "cosine_with_warmup",
]
