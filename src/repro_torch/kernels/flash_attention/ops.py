"""Public attention op: the flash kernel for CUDA tensors, the plain
version for CPU tensors (port of ``repro.kernels.flash_attention.ops``).

When grad is enabled and an input requires it, the op on the card is a
``torch.autograd.Function``: its forward launches the kernel, so the values
the loss sees are the kernel's; its backward recomputes the plain version
(``ref.attention_reference``) from the saved q, k, v and returns
``torch.autograd.grad`` of it, with no launch.  That is the JAX package's
own gradient off the TPU (XLA's autodiff of its plain path; the Pallas
kernel has no ``custom_vjp``), written in PyTorch, as ``kernels/lstm/ops.py``
does for the LSTM.

Decode over a ring-buffer cache (``kv_positions``) is not this op's job:
as in the reference, it goes through the plain version
(``models/attention.py::attention_decode``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_attention.ref import attention_reference

#: kernel launches since the count was last set to 0
launches = 0
_STRIDES = ctypes.c_longlong * 9


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
    if q.is_cpu:
        return attention_reference(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return _card(q, k, v, causal, window, q_offset)


def _card(q, k, v, causal, window, q_offset):
    """The card's path: the autograd Function where a gradient is wanted,
    else the kernel alone."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _FlashFunction.apply(q, k, v, causal, window, q_offset)
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
    """Launch ``csrc/flash_attention.cu`` on the current stream: bf16 to the
    tensor-core (wgmma) kernel, fp32 to the CUDA-core kernel.  Raises on any
    input the kernel does not take.  The served prefill's attention takes a
    few µs on the card, so the checks read each tensor attribute once."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda) or not q.get_device() == k.get_device() == v.get_device():
        raise ValueError(f"flash kernel needs q, k, v on one CUDA device, got {q.device}, {k.device}, {v.device}")
    dtype = q.dtype
    if dtype not in (torch.bfloat16, torch.float32) or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash kernel takes fp32 or bf16 q, k, v of one dtype, got {dtype}, {k.dtype}, {v.dtype}")
    shape, kshape = q.shape, k.shape
    if len(shape) != 4 or len(kshape) != 4 or kshape != v.shape:
        raise ValueError(f"need q (B,Sq,H,D) and k, v (B,Sk,KVH,D), got {tuple(shape)}, {tuple(kshape)}, {tuple(v.shape)}")
    b, sq, h, d = shape
    kb, sk, kvh, kd = kshape
    if kb != b or kd != d:
        raise ValueError(f"batch or head dim of k {tuple(kshape)} differs from q {tuple(shape)}")
    if kvh == 0 or h % kvh:
        raise ValueError(f"query heads {h} are not a multiple of kv heads {kvh}")
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"flash kernel takes a head dim that is a multiple of 16 up to 128, got {d}")
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    if qs[3] != 1 or ks[3] != 1 or vs[3] != 1:
        raise ValueError("flash kernel needs the head dim of q, k, v contiguous")
    if b > 65535 or h > 65535 or -(-sq * (h // kvh) // 64) > 65535:
        raise ValueError(f"batch {b}, heads {h} or Sq·H/KVH/64 ({sq} queries) exceed the grid's 65535")
    strides = qs[:3] + ks[:3] + vs[:3]
    ptrs = q.data_ptr(), k.data_ptr(), v.data_ptr()
    bf16 = dtype is torch.bfloat16
    if bf16 and ((ptrs[0] | ptrs[1] | ptrs[2]) % 16 or any(s % 8 for s in strides)):
        raise ValueError(
            "bf16 flash kernel copies 16 bytes at a time: q, k, v must start on "
            f"16-byte boundaries and have strides that are multiples of 8, got "
            f"addresses mod 16 {tuple(p % 16 for p in ptrs)}, strides {strides}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if sq == 0 or h == 0 or b == 0:
        return out
    lib = _lib.library()
    args = (*ptrs, out.data_ptr(), b, sq, sk, h, kvh, d, _STRIDES(*strides),
            causal, window, q_offset, d ** -0.5)
    # the current stream's handle: torch.cuda.current_stream(...).cuda_stream
    # builds a Stream object, several µs of a call that takes about 20.  The
    # private binding (torch 2.11) is held equal to it by the card tests.
    stream = torch._C._cuda_getCurrentRawStream(q.get_device())
    if bf16:
        err = lib.repro_flash_attention_bf16(*args, stream)
    else:
        err = lib.repro_flash_attention_fp32(*args, stream)
    _lib.check(err, "flash_attention")
    launches += 1
    return out


class _FlashFunction(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version,
    recomputed from the saved inputs (no launch)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.mask = causal, window, q_offset
        return flash_attention_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)

    @staticmethod
    def backward(ctx, d_out):
        causal, window, q_offset = ctx.mask
        wanted = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(w) for t, w in zip(ctx.saved_tensors, wanted)]
            out = attention_reference(*inputs, causal=causal, window=window, q_offset=q_offset)
            found = iter(torch.autograd.grad(
                out, [t for t, w in zip(inputs, wanted) if w], d_out))
        return (*(next(found) if w else None for w in wanted), None, None, None)


__all__ = ["attention", "flash_attention_cuda"]
