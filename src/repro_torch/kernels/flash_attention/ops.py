"""Public attention op: the flash kernel for CUDA tensors, the plain
version for CPU tensors (port of ``repro.kernels.flash_attention.ops``).

Decode over a ring-buffer cache (``kv_positions``) is not this op's job:
as in the reference, it goes through the plain version
(``models/attention.py::attention_decode``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import attention_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: kernel launches since the count was last set to 0
launches = 0


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Multi-head attention (GQA aware). Shapes:
    q (B,Sq,H,D), k/v (B,Sk,KVH,D) → (B,Sq,H,D) in q.dtype."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Launch ``csrc/flash_attention.cu`` on the current stream; raises on
    any input the kernel does not take."""
    global launches
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"flash kernel needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash kernel takes fp32 or bf16 q, k, v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,H,D) and k, v (B,Sk,KVH,D), got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    kb, sk, kvh, kd = k.shape
    if kb != b or kd != d:
        raise ValueError(f"batch or head dim of k {tuple(k.shape)} differs from q {tuple(q.shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} are not a multiple of kv heads {kvh}")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash kernel takes a head dim that is a multiple of 16 up to 128, got {d}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash kernel needs the head dim of q, k, v contiguous")
    if b > 65535 or h > 65535:
        raise ValueError(f"batch {b} or heads {h} exceed the grid's 65535")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
    )
    lib = _lib.library()
    err = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPES[q.dtype],
        b, sq, sk, h, kvh, d, strides, int(causal), int(window), int(q_offset),
        d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _lib.check(err, "flash_attention")
    launches += 1
    return out


__all__ = ["attention", "flash_attention_cuda"]
