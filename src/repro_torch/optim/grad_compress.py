"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Per-tensor symmetric int8 quantization with an error-feedback accumulator
(Seide et al. 2014 / 1-bit SGD lineage): the quantization residual is
carried into the next step, so compression error does not bias
convergence.  The reference applies it to the gradients it reduces over a
multi-pod mesh's "pod" axis (``compress_psum``); on one card there is no
such axis, and ``compress_psum`` raises until the multi-rank slice.
:func:`error_feedback` is its local half: quantize, dequantize, carry the
residual.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed.sharding import MULTI_RANK
from repro_torch.tree import paths, tree_map, unflatten_like


class CompressState(NamedTuple):
    error: Any   # tree of fp32 residuals, like grads


def init_error(grads_shape: Any) -> CompressState:
    """Zero fp32 residuals shaped like ``grads_shape``'s tensors."""
    return CompressState(
        error=tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                       grads_shape)
    )


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q int8, scale fp32 scalar)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback(grads: Any, err: CompressState) -> tuple[Any, CompressState]:
    """One step of error feedback on this rank's gradients: (g + e) is
    quantized and dequantized, and what the int8 value lost is the new
    residual.  Returns (dequantized fp32 grads, new error state), each a
    tree like ``grads``."""
    flat_e = paths(err.error)
    deq, new_e = [], []
    for k, g in paths(grads).items():
        gf = g.float() + flat_e[k]
        deq.append(dequantize(*quantize(gf)))
        new_e.append(gf - deq[-1])
    return unflatten_like(grads, deq), CompressState(error=unflatten_like(grads, new_e))


def compress_psum(grads: Any, err: CompressState, axis_name: str):
    """The reference's error-feedback int8 all-reduce over ``axis_name``:
    it needs the pod axis of a multi-rank mesh."""
    raise NotImplementedError(f"compress_psum over {axis_name!r}: {MULTI_RANK}")
