"""Train steps (port of ``repro.training.train_loop``):
microbatched gradient accumulation in fp32, AdamW, a ``TrainState``.

``make_train_step(cfg, perf, optimizer, mesh)`` returns ``init_state`` and
``train_step(state, batch, lr) → (state, metrics)``.  The reference's step
is a pure function that XLA compiles and donates; here the gradients come
from ``torch.autograd.grad`` and AdamW writes the parameters and moments in
place, so the returned state holds the same tensors.

On one device ``gather_weights_once`` has no FSDP axes to gather and
``grad_compress_pod`` no pod axis to reduce over: both do nothing.  A mesh
of more than one device (the reference's compressed cross-pod branch
among its uses) raises until the multi-rank slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed.sharding import MULTI_RANK
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamW, AdamWState, adamw
from repro_torch.tree import paths

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    compress_err: Optional[grad_compress.CompressState]


@dataclasses.dataclass(frozen=True)
class TrainStepFns:
    init_state: Callable[[Any], TrainState]
    train_step: Callable  # (state, batch, lr) -> (state, metrics)


def _microbatch_grads(loss_fn, params, batch, num_micro: int):
    """Loss and fp32 gradients (a tree like ``params``), accumulated over
    ``num_micro`` microbatches split along every batch leaf's leading axis
    and averaged, in the reference's order (sum, then × 1/n)."""
    flat = paths(params)
    leaves = list(flat.values())
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)

    def value_and_grad(micro):
        loss = loss_fn(params, micro)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), [g.float() for g in grads]

    if num_micro <= 1:
        loss, grads = value_and_grad(batch)
    else:
        for k, x in batch.items():
            if x.shape[0] % num_micro:
                raise ValueError(f"batch leaf {k!r} of {x.shape[0]} rows does not split into {num_micro}")
        loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
        for i in range(num_micro):
            micro = {k: x.reshape(num_micro, x.shape[0] // num_micro, *x.shape[1:])[i]
                     for k, x in batch.items()}
            l_i, g_i = value_and_grad(micro)
            loss = loss + l_i
            grads = [a + g for a, g in zip(grads, g_i)]
        inv = 1.0 / num_micro
        loss = loss * inv
        grads = [g * inv for g in grads]
    return loss, dict(zip(flat, grads))


def make_train_step(
    cfg: ArchConfig,
    perf: PerfConfig = BASELINE,
    optimizer: AdamW | None = None,
    mesh=None,
) -> TrainStepFns:
    if mesh is not None and mesh.size > 1:
        raise NotImplementedError(f"a train step on a {mesh.shape} mesh: {MULTI_RANK}")
    opt = optimizer or adamw(moment_dtype=_MOMENT_DTYPES[perf.optimizer_moment_dtype])
    loss_fn = lambda p, b: zoo.loss_fn(p, b, cfg, perf)

    def init_state(params) -> TrainState:
        return TrainState(params=params, opt=opt.init(params), compress_err=None)

    def train_step(state: TrainState, batch, lr):
        loss, grads = _microbatch_grads(loss_fn, state.params, batch, perf.num_microbatches)
        new_p, new_opt, gnorm = opt.update(grads, state.opt, state.params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_p, new_opt, None), metrics

    return TrainStepFns(init_state=init_state, train_step=train_step)
