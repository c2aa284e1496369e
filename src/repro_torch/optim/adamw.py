"""AdamW as plain functions on trees of tensors (port of
``repro.optim.adamw``).

A tree is a dict of tensors or a nested dict of them (a model's parameter
tree).  The moments mirror the parameters' tree; ``update`` walks every
tree as the checkpoint's path keys (``periods/pos0/attn/wq``, …;
``repro_torch.tree``) in the dicts' own order, so ``grads`` may be nested
like the parameters or a flat dict keyed by those paths.

This is the reference's optimizer, not ``torch.optim.AdamW``; they differ
in the defaults (``b2 = 0.95``), in ``eps`` being added after
``sqrt(v / bc2)``, in the global-norm clip's ``max(norm, 1e-12)`` and in
the moments being kept in ``moment_dtype``.

Unlike the reference, whose arrays are immutable, ``update`` writes the
new parameters and moments **in place** (under ``torch.no_grad``) and
returns the same dicts, so a training step allocates no second copy of
the parameters.

``lr`` is a Python float or a 0-d float64 tensor.  The reference computes
``p.astype(f32) - lr * delta``; under x64 a float64 ``lr`` array promotes
that subtraction to float64 (the fp32-rounded parameter minus a float64
step), while a Python-float ``lr`` keeps it in fp32.  Torch promotes a 0-d
tensor like a scalar, so the float64 case is written out:
``p.float().double() - lr * delta.double()``.  The optimizer's multi-start
descent and the policy trainer pass a float64 ``lr``; the quickstart's LSTM
training passes a Python float and stays in fp32.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.tree import paths, tree_map


class AdamWState(NamedTuple):
    step: int           # updates taken so far
    m: dict             # first moments, a tree like params
    v: dict             # second moments, a tree like params


class AdamW(NamedTuple):
    init: Callable
    update: Callable


def _sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root.  Torch's vectorized fp32 sqrt on
    the CPU is off by one ulp in a few inputs per thousand; the float64
    root rounded to fp32 is the IEEE result on every device."""
    return torch.sqrt(x.double()).float()


def global_norm(tree: dict, split_over: Optional[dict] = None, mesh=None) -> torch.Tensor:
    """fp32 L2 norm over every tensor of ``tree`` (a 0-d tensor).

    On a mesh of ranks, ``tree`` holds this rank's blocks and
    ``split_over`` maps each leaf's path to the mesh axes it is split
    across: the sums of squares of the leaves split alike are added, then
    summed over those axes (so a leaf replicated over an axis counts once),
    and the root is taken of the total.  The order of the sums differs from
    one device's, so the norm agrees to about 1e-7 relative."""
    flat = paths(tree)
    if split_over is None:
        return _sqrt32(torch.sum(torch.stack([torch.sum(torch.square(g.float())) for g in flat.values()])))
    from repro_torch.distributed import ranks

    groups: dict = {}
    for k, g in flat.items():
        groups.setdefault(tuple(split_over[k]), []).append(torch.sum(torch.square(g.float())))
    total = sum(ranks.psum(torch.sum(torch.stack(sq)), axes, mesh, tag="grad norm")
                for axes, sq in groups.items())
    return _sqrt32(total)


def clip_by_global_norm(tree: dict, max_norm: float, split_over: Optional[dict] = None,
                        mesh=None) -> tuple[dict, torch.Tensor]:
    """``tree`` scaled so its global norm is at most ``max_norm`` (new
    tensors, same structure), and the norm before clipping (of the blocks
    of a mesh of ranks with ``split_over``: :func:`global_norm`)."""
    norm = global_norm(tree, split_over, mesh)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def adamw(
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    moment_dtype=torch.float32,
    clip_norm: float | None = 1.0,
) -> AdamW:
    """Returns (init, update).  ``update(grads, state, params, lr)`` →
    ``(params, state, grad_norm)``, with params and moments updated in
    place.  On a mesh of ranks every tree holds this rank's blocks, and
    ``update(..., split_over=, mesh=)`` takes the global norm over them
    (:func:`global_norm`); the rest of the update is elementwise."""

    def init(params: dict) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return AdamWState(step=0, m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params: dict, lr, *, split_over=None, mesh=None):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm, split_over, mesh)
        else:
            gnorm = global_norm(grads, split_over, mesh)
        step = state.step + 1
        wide = isinstance(lr, torch.Tensor) and lr.dtype == torch.float64
        # the reference raises b1, b2 to the step in fp32
        bc1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** step)
        bc2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** step)
        # fp32 tensors on the parameters' device: a CUDA tensor divided by a
        # host scalar is a product with its reciprocal
        flat_p, flat_g = paths(params), paths(grads)
        flat_m, flat_v = paths(state.m), paths(state.v)
        dev = next(iter(flat_p.values())).device
        bc1_t = torch.full((), bc1, dtype=torch.float32, device=dev)
        bc2_t = torch.full((), bc2, dtype=torch.float32, device=dev)
        for k, p in flat_p.items():
            gf = flat_g[k].float()
            mf = b1 * flat_m[k].float() + (1 - b1) * gf
            vf = b2 * flat_v[k].float() + (1 - b2) * torch.square(gf)
            mhat = mf / bc1_t
            vhat = vf / bc2_t
            delta = mhat / (_sqrt32(vhat) + eps) + weight_decay * p.float()
            if wide:
                new = p.float().double() - lr.to(p.device) * delta.double()
            else:
                new = p.float() - lr * delta
            p.copy_(new.to(p.dtype))
            flat_m[k].copy_(mf)
            flat_v[k].copy_(vf)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm

    return AdamW(init=init, update=update)
