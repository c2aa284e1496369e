"""Int8 gradient compression with error feedback (port of
``repro.optim.grad_compress``).

Per-tensor symmetric int8 quantization with an error-feedback accumulator
(Seide et al. 2014 / 1-bit SGD lineage): the quantization residual is
carried into the next step, so compression error does not bias
convergence.  :func:`compress_psum` is the reference's reduction of the
gradients over a multi-pod mesh's "pod" axis: every rank of a mesh of
ranks (:mod:`repro_torch.distributed.ranks`) quantizes its own gradients
and the dequantized values are mean-reduced over the axis.
:func:`error_feedback` is its local half: quantize, dequantize, carry the
residual.  Its use inside the train step waits, with the train step on a
mesh, for the second half of ROADMAP A13a.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.distributed import ranks
from repro_torch.distributed.sharding import current_mesh
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
    # a tensor divisor: a CUDA tensor divided by a host scalar is a product
    # with its reciprocal, which the CPU and the reference do not compute
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / torch.full((), 127.0, device=xf.device)
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


def compress_psum(grads: Any, err: CompressState, axis_name: str, mesh=None) -> tuple[Any, CompressState]:
    """The reference's error-feedback int8 all-reduce over ``axis_name``:
    each rank's (g + e) is quantized and dequantized (:func:`error_feedback`)
    and the dequantized values are summed over the axis and divided by its
    size.  Called by every rank of ``mesh`` (default: the mesh installed by
    ``use_sharding``); returns (mean-reduced fp32 grads, new error state).
    On an axis of size 1 it is :func:`error_feedback`."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or axis_name not in mesh.axis_names:
        raise ValueError(
            f"compress_psum over {axis_name!r} needs a mesh with that axis: pass mesh= or "
            "install one with use_sharding (launch.mesh.make_rank_mesh)"
        )
    deq, new_err = error_feedback(grads, err)
    n = mesh.shape[axis_name]
    out = tree_map(lambda d: ranks.psum(d, axis_name, mesh) / torch.full((), float(n), device=d.device), deq)
    return out, new_err
