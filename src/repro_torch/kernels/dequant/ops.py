"""Public dequant op: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors (port of ``repro.kernels.dequant.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.dequant.ref import (
    dequantize_blocked_reference,
    quantize_blocked,
)

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0
launches = 0


def dequantize(
    q: torch.Tensor, scales: torch.Tensor, *, group: int = 128, dtype=torch.bfloat16
) -> torch.Tensor:
    """int8 q (R, C) · fp32 scales (R, C/group) → (R, C) in ``dtype``."""
    if q.device.type == "cpu":
        return dequantize_blocked_reference(q, scales, group=group, dtype=dtype)
    return dequantize_cuda(q, scales, group=group, dtype=dtype)


def dequantize_cuda(
    q: torch.Tensor, scales: torch.Tensor, *, group: int = 128, dtype=torch.bfloat16
) -> torch.Tensor:
    """Launch ``csrc/dequant.cu`` on the current stream; raises on any input
    the kernel does not take."""
    global launches
    if q.device.type != "cuda" or scales.device != q.device:
        raise ValueError(f"dequant kernel needs q and scales on one CUDA device, got {q.device} and {scales.device}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"dequant kernel takes int8 q and fp32 scales, got {q.dtype} and {scales.dtype}")
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"dequant kernel writes fp32 or bf16, not {dtype}")
    if q.dim() != 2:
        raise ValueError(f"q must be 2-D, got shape {tuple(q.shape)}")
    r, c = q.shape
    if group % 16 or c % group:
        raise ValueError(f"need group % 16 == 0 and C % group == 0, got C={c}, group={group}")
    if tuple(scales.shape) != (r, c // group):
        raise ValueError(f"scales shape {tuple(scales.shape)} != {(r, c // group)}")
    if not (q.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequant kernel needs contiguous q and scales")
    if q.data_ptr() % 16:
        raise ValueError("dequant kernel needs q 16-byte aligned")
    out = torch.empty((r, c), dtype=dtype, device=q.device)
    lib = _lib.library()
    err = lib.repro_dequant(
        q.data_ptr(), scales.data_ptr(), out.data_ptr(), r, c, group,
        _OUT_DTYPES[dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(err, "dequant")
    launches += 1
    return out


__all__ = ["dequantize", "dequantize_cuda", "quantize_blocked"]
