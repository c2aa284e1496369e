"""Shared model building blocks (port of ``repro.models.common``):
parameter specs, RMSNorm and RoPE.

Parameters are declared once as :class:`Spec` trees (nested dicts whose
leaves are specs), from which we derive initialized tensors
(:func:`init_from_specs`) and shape-only meta tensors
(:func:`shapes_from_specs`, the counterpart of ``ShapeDtypeStruct``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class Spec:
    """Declaration of one parameter tensor."""

    shape: tuple[int, ...]
    axes: tuple                      # logical axis names, len == ndim
    init: str = "normal"             # normal | zeros | ones
    scale: float | None = None       # init stddev; default 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def map_specs(fn: Callable[[Spec], Any], specs: Any) -> Any:
    """Apply ``fn`` to every spec of a nested-dict spec tree, in sorted key
    order (the order ``jax.tree`` flattens dicts in)."""
    if isinstance(specs, Spec):
        return fn(specs)
    return {k: map_specs(fn, specs[k]) for k in sorted(specs)}


def _leaf_init(spec: Spec, generator: torch.Generator, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    if spec.axes[0] != "layers":
        w = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
        return w.mul_(std).to(dtype)
    # a stacked leaf is drawn a matrix at a time (a layer's, or a layer's
    # expert's), so the fp32 draw never holds the whole stack (qwen3-32b's
    # stacked FFN leaf would take 33.5 GB, one layer of jamba's experts 38.7)
    out = torch.empty(spec.shape, dtype=dtype, device=device)
    for mat in out.view(-1, *spec.shape[-2:]) if out.dim() > 2 else out:
        w = torch.randn(mat.shape, generator=generator, dtype=torch.float32, device=device)
        mat.copy_(w.mul_(std))
    return out


def init_from_specs(
    specs: Any, generator: torch.Generator, dtype=torch.bfloat16
) -> Any:
    """Random parameters on ``generator.device``: fp32 normal, then a cast,
    a matrix at a time for stacked leaves.  The draws differ from
    ``jax.random``'s; carry the reference's weights
    with ``model_zoo.params_from_numpy`` where the two must agree."""
    return map_specs(
        lambda s: _leaf_init(s, generator, dtype, generator.device), specs
    )


def shapes_from_specs(specs: Any, dtype=torch.bfloat16) -> Any:
    """Shape-and-dtype stand-ins (meta tensors), e.g. a restore target."""
    return map_specs(
        lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs
    )


def stack_specs(specs: Any, n: int, axis_name="layers") -> Any:
    """Add a leading stacked-layer axis to every spec."""
    return map_specs(
        lambda s: Spec((n,) + s.shape, (axis_name,) + s.axes, s.init, s.scale),
        specs,
    )


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32, cast back to input dtype."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_angles(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for RoPE at given integer positions (fp32)."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions.float()[..., None] * freqs  # (..., half)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D/2) or broadcastable (..., S, D/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    # broadcast cos/sin over the heads axis
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    xf1, xf2 = x1.float(), x2.float()
    return torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1).to(x.dtype)
