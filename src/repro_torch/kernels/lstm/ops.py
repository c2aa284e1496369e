"""Public LSTM op: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors (port of ``repro.kernels.lstm.ops``).

On the card the op is a ``torch.autograd.Function``: its forward launches
``csrc/lstm.cu``, so the values the loss sees are the kernel's; its
backward recomputes the plain version (``ref.lstm_reference``) from the
saved inputs and returns ``torch.autograd.grad`` of it.  That is the JAX
package's own gradient, XLA's autodiff of its jnp reference (the Pallas
kernel has no ``custom_vjp``), written in PyTorch.  There is no backward
kernel, because the reference has none; the backward launches nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, meta_ops
from repro_torch.kernels.lstm.ref import lstm_reference

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SHARED_FLOATS = 48 * 1024 // 4   # 6 H + 2 I floats a row fit 48 KB (a warp's slice takes no more)

#: kernel launches since the count was last set to 0
launches = 0


def lstm(
    x: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b: torch.Tensor,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
):
    """(B,S,I) → (hs (B,S,H), (h,c)); differentiable on both devices."""
    if x.device.type == "cpu":
        return lstm_reference(x, w_ih, w_hh, b, h0, c0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w_ih, w_hh, b, h0, c0)):
        hs, h, c = _LstmFunction.apply(x, w_ih, w_hh, b, h0, c0)
    else:   # nothing to differentiate: the kernel alone (an inference call takes some 25 µs)
        hs, h, c = _kernel(x, w_ih, w_hh, b, h0, c0)
    return hs, (h, c)


def _kernel(x, w_ih, w_hh, b, h0, c0):
    """The kernel on CUDA tensors; its meta stand-in on ``meta`` tensors
    (``kernels/meta_ops.py``)."""
    if x.is_meta:
        return meta_ops.lstm(x, w_ih, w_hh, b, h0, c0)
    return lstm_cuda(x, w_ih, w_hh, b, h0, c0)


def lstm_cuda(
    x: torch.Tensor,
    w_ih: torch.Tensor,
    w_hh: torch.Tensor,
    b: torch.Tensor,
    h0: torch.Tensor | None = None,
    c0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``csrc/lstm.cu`` on the current stream → (hs, h_N, c_N) in
    ``x.dtype``; raises on any input the kernel does not take."""
    global launches
    named = {"x": x, "w_ih": w_ih, "w_hh": w_hh, "b": b, "h0": h0, "c0": c0}
    given = {k: t for k, t in named.items() if t is not None}
    if x.device.type != "cuda" or any(t.device != x.device for t in given.values()):
        raise ValueError(
            "lstm kernel needs every input on one CUDA device, got "
            + ", ".join(f"{k} on {t.device}" for k, t in given.items())
        )
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in given.values()):
        raise TypeError(
            "lstm kernel takes fp32 or bf16 inputs of one dtype, got "
            + ", ".join(f"{k} {t.dtype}" for k, t in given.items())
        )
    if x.dim() != 3:
        raise ValueError(f"x must be (B, S, I), got shape {tuple(x.shape)}")
    bsz, seq, in_dim = x.shape
    hidden = w_hh.shape[0]
    want = {"w_ih": (in_dim, 4 * hidden), "w_hh": (hidden, 4 * hidden), "b": (4 * hidden,),
            "h0": (bsz, hidden), "c0": (bsz, hidden)}
    for k, shape in want.items():
        t = given.get(k)
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{k} has shape {tuple(t.shape)}, want {shape}")
    if bsz < 1 or seq < 1 or hidden < 1:
        raise ValueError(f"need B, S and H >= 1, got {bsz}, {seq}, {hidden}")
    if 6 * hidden + 2 * in_dim > _SHARED_FLOATS:
        raise ValueError(f"H={hidden}, I={in_dim}: one row's state exceeds 48 KB of shared memory")
    if any(not given[k].is_contiguous() for k in given if k != "x"):
        raise ValueError("lstm kernel needs contiguous weights, bias, h0 and c0 (x may be strided)")
    hs = torch.empty((bsz, seq, hidden), dtype=x.dtype, device=x.device)
    h_n = torch.empty((bsz, hidden), dtype=x.dtype, device=x.device)
    c_n = torch.empty((bsz, hidden), dtype=x.dtype, device=x.device)
    lib = _lib.library()
    err = lib.repro_lstm(
        x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
        None if h0 is None else h0.data_ptr(), None if c0 is None else c0.data_ptr(),
        hs.data_ptr(), h_n.data_ptr(), c_n.data_ptr(), _DTYPES[x.dtype],
        bsz, seq, in_dim, hidden, *x.stride(),
        # the current stream's handle, without building a Stream object (the
        # private binding the flash wrapper uses; card tests hold it equal)
        torch._C._cuda_getCurrentRawStream(x.get_device()),
    )
    _lib.check(err, "lstm")
    launches += 1
    return hs, h_n, c_n


class _LstmFunction(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version,
    recomputed from the saved inputs (no launch)."""

    @staticmethod
    def forward(ctx, x, w_ih, w_hh, b, h0, c0):
        ctx.save_for_backward(x, w_ih, w_hh, b, h0, c0)
        return _kernel(x, w_ih, w_hh, b, h0, c0)

    @staticmethod
    def backward(ctx, d_hs, d_h, d_c):
        saved = ctx.saved_tensors
        wanted = [i for i, t in enumerate(saved) if t is not None and ctx.needs_input_grad[i]]
        grads = [None] * len(saved)
        if not wanted:
            return tuple(grads)
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(i in wanted) if t is not None else None
                      for i, t in enumerate(saved)]
            hs, (h, c) = lstm_reference(*inputs)
            found = torch.autograd.grad(
                (hs, h, c), [inputs[i] for i in wanted], (d_hs, d_h, d_c),
                allow_unused=True,
            )
        for i, g in zip(wanted, found):
            grads[i] = g
        return tuple(grads)


__all__ = ["lstm", "lstm_cuda"]
