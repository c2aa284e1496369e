"""AdamW as plain functions on dicts of tensors (port of
``repro.optim.adamw``).

This is the reference's optimizer, not ``torch.optim.AdamW``; they differ
in the defaults (``b2 = 0.95``), in ``eps`` being added after
``sqrt(v / bc2)``, in the global-norm clip's ``max(norm, 1e-12)`` and in
the moments being kept in ``moment_dtype``.

Unlike the reference, whose arrays are immutable, ``update`` writes the
new parameters and moments **in place** (under ``torch.no_grad``) and
returns the same dicts, so a training step allocates no second copy of
the parameters.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int           # updates taken so far
    m: dict             # first moments, keyed like params
    v: dict             # second moments, keyed like params


class AdamW(NamedTuple):
    init: Callable
    update: Callable


def global_norm(tree: dict) -> torch.Tensor:
    """fp32 L2 norm over every tensor of ``tree`` (a 0-d tensor)."""
    leaves = [torch.sum(torch.square(g.float())) for g in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(tree: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
    """``tree`` scaled so its global norm is at most ``max_norm`` (new
    tensors), and the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


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
    place."""

    def init(params: dict) -> AdamWState:
        zeros = lambda p: torch.zeros(p.shape, dtype=moment_dtype, device=p.device)
        return AdamWState(
            step=0,
            m={k: zeros(p) for k, p in params.items()},
            v={k: zeros(p) for k, p in params.items()},
        )

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params: dict, lr: float):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = global_norm(grads)
        step = state.step + 1
        # the reference raises b1, b2 to the step in fp32
        bc1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** step)
        bc2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** step)
        for k, p in params.items():
            gf = grads[k].float()
            mf = b1 * state.m[k].float() + (1 - b1) * gf
            vf = b2 * state.v[k].float() + (1 - b2) * torch.square(gf)
            mhat = mf / bc1
            vhat = vf / bc2
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
            p.copy_((p.float() - lr * delta).to(p.dtype))
            state.m[k].copy_(mf)
            state.v[k].copy_(vf)
        return params, AdamWState(step=step, m=state.m, v=state.v), gnorm

    return AdamW(init=init, update=update)
