"""Plain PyTorch blocked int8 quantize/dequantize (port of
``repro.kernels.dequant.ref``).

The checkpoint-compression analogue of the paper's bitstream compression:
weights are stored int8 with per-(row, column-group) fp32 scales;
dequantize-on-load trades extra compute for fewer bytes moved.
"""
from __future__ import annotations

import torch


def quantize_blocked(w: torch.Tensor, group: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """w (R, C) → (q int8 (R, C), scales fp32 (R, C/group))."""
    r, c = w.shape
    if c % group:
        raise ValueError(f"columns {c} are not a multiple of the group {group}")
    wf = w.float().reshape(r, c // group, group)
    scale = torch.clamp_min(torch.amax(torch.abs(wf), dim=-1), 1e-12) / 127.0
    q = torch.clamp(torch.round(wf / scale[..., None]), -127, 127).to(torch.int8)
    return q.reshape(r, c), scale


def dequantize_blocked_reference(
    q: torch.Tensor, scales: torch.Tensor, group: int = 128, dtype=torch.bfloat16
) -> torch.Tensor:
    """(q int8 (R, C), scales (R, C/group)) → w dtype (R, C): one fp32
    multiply, then a round-to-nearest-even cast."""
    r, c = q.shape
    wf = q.float().reshape(r, c // group, group) * scales[..., None]
    return wf.reshape(r, c).to(dtype)
