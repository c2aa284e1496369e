"""Train steps (port of ``repro.training.train_loop``):
microbatched gradient accumulation in fp32, AdamW, a ``TrainState``.

``make_train_step(cfg, perf, optimizer, mesh)`` returns ``init_state`` and
``train_step(state, batch, lr) → (state, metrics)``.  The reference's step
is a pure function that XLA compiles and donates; here the gradients come
from ``torch.autograd.grad`` and AdamW writes the parameters and moments in
place, so the returned state holds the same tensors.

On one device ``gather_weights_once`` has no FSDP axes to gather and
``grad_compress_pod`` no pod axis to reduce over: both do nothing.

**On a mesh of ranks** (``launch.mesh.make_rank_mesh``, inside
``distributed.ranks.spawn``; every family) the step is the reference's
GSPMD program written out on local blocks, with the rule table installed
by ``use_sharding``.  ``init_state`` takes the whole parameters,
as on one device, and keeps this rank's block of each under
``model_zoo.param_pspecs`` (``TrainStepFns.param_pspecs``), with AdamW's
moments as blocks.  ``train_step`` takes this rank's rows of the batch
(``data.pipeline.shard_batch``) and returns blocks, with ``loss`` and
``grad_norm`` global.  The forward runs on local blocks
(a train ``sharding.Layout``, ``models/decoder.py``): weights gathered
over their FSDP axes where they are used (per microbatch and per remat
replay), or once a step with ``gather_weights_once``, the gradients
summed back into the blocks; attention, the MLP, Mamba-2's local heads and
the MoE's EP / f-TP bodies (at ``perf.moe_capacity_factor``) differentiated
through the autograd collectives of ``distributed/ranks.py``; the MoE's
aux loss each rank's share of the mean of its token blocks' aux, as the
reference's bodies ``pmean`` it; AdamW's global norm sums each leaf's
squares over the axes it is split across.  The compressed cross-pod branch (``grad_compress_pod``
with a ``pod`` axis, under ``launch.dryrun_lib.perf_rules``, which drop
``pod`` from the rules) is hierarchical ZeRO: parameters replicated across
pods and split over data × model inside one, the batch split over pods
too, the gradients mean-reduced over ``pod`` by ``compress_psum`` with
error feedback, the loss ``pmean``'d over ``pod``.  A rank outside a
smaller mesh holds no block: its ``init_state`` returns ``None``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed import ranks
from repro_torch.distributed.sharding import Layout, PartitionSpec, current_rules
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import grad_compress
from repro_torch.optim.adamw import AdamW, AdamWState, adamw
from repro_torch.tree import paths, unflatten_like

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    compress_err: Optional[grad_compress.CompressState]


@dataclasses.dataclass(frozen=True)
class TrainStepFns:
    init_state: Callable[[Any], TrainState]
    train_step: Callable  # (state, batch, lr) -> (state, metrics)
    #: (params, batch) -> (loss, {path: fp32 gradient}); blocks on a mesh
    loss_and_grads: Optional[Callable] = None
    #: (state, loss, grads, lr) -> (state, metrics): the rest of train_step
    apply_grads: Optional[Callable] = None
    #: every parameter's PartitionSpec on a mesh of ranks, else None
    param_pspecs: Any = None


def state_pspecs(state: TrainState, param_pspecs) -> TrainState:
    """The PartitionSpecs of a train state's leaves, a tree like ``state``
    (the step counter's is ``P()``)."""
    err = None
    if state.compress_err is not None:
        err = grad_compress.CompressState(error=param_pspecs)
    return TrainState(params=param_pspecs, opt=AdamWState(step=PartitionSpec(), m=param_pspecs, v=param_pspecs),
                      compress_err=err)


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
    opt = optimizer or adamw(moment_dtype=_MOMENT_DTYPES[perf.optimizer_moment_dtype])
    if mesh is not None and mesh.size > 1:
        return _mesh_train_step(cfg, perf, opt, mesh)
    loss_fn = lambda p, b: zoo.loss_fn(p, b, cfg, perf)

    def init_state(params) -> TrainState:
        return TrainState(params=params, opt=opt.init(params), compress_err=None)

    def loss_and_grads(params, batch):
        return _microbatch_grads(loss_fn, params, batch, perf.num_microbatches)

    def apply_grads(state: TrainState, loss, grads, lr):
        new_p, new_opt, gnorm = opt.update(grads, state.opt, state.params, lr)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return TrainState(new_p, new_opt, None), metrics

    def train_step(state: TrainState, batch, lr):
        return apply_grads(state, *loss_and_grads(state.params, batch), lr)

    return TrainStepFns(init_state=init_state, train_step=train_step, loss_and_grads=loss_and_grads,
                        apply_grads=apply_grads)


def _mesh_train_step(cfg: ArchConfig, perf: PerfConfig, opt: AdamW, mesh) -> TrainStepFns:
    """The step on a mesh of ranks (module docstring)."""
    compress = perf.grad_compress_pod and "pod" in mesh.axis_names
    pspecs = zoo.param_pspecs(cfg, mesh)
    flat_specs = paths(pspecs)
    if compress and any("pod" in ((e,) if isinstance(e, str) else tuple(e or ()))
                        for spec in flat_specs.values() for e in spec):
        raise ValueError("the compressed cross-pod step replicates parameters across pods: install "
                         "launch.dryrun_lib.perf_rules(perf) with use_sharding")
    layout = Layout(mesh, dict(current_rules()), flat_specs, gathered=perf.gather_weights_once, training=True)
    split_over = {k: layout.sharded_axes(k) for k in flat_specs}
    loss_fn = lambda p, b: zoo.loss_fn(p, b, cfg, perf, layout)

    def init_state(params) -> Optional[TrainState]:
        if not mesh.is_member:
            return None
        flat = paths(params)
        blocks = unflatten_like(params, [ranks.shard(t.detach(), flat_specs[k], mesh).clone(
            memory_format=torch.contiguous_format) for k, t in flat.items()])
        err = grad_compress.init_error(blocks) if compress else None
        return TrainState(params=blocks, opt=opt.init(blocks), compress_err=err)

    def loss_and_grads(params, batch):
        """The global loss of this step's batch (over the batch axes; one
        pod's under ``grad_compress_pod``) and this rank's gradient blocks."""
        if perf.gather_weights_once:
            loss, grads = _microbatch_grads(loss_fn, layout.gather_all(params), batch, perf.num_microbatches)
            grads = layout.reduce_all(grads)
        else:
            loss, grads = _microbatch_grads(loss_fn, params, batch, perf.num_microbatches)
        return ranks.psum(loss, layout.batch_axes, mesh, tag="loss"), grads

    def apply_grads(state: TrainState, loss, grads, lr):
        err = state.compress_err
        if compress:
            grads = unflatten_like(state.params, [grads[k] for k in paths(state.params)])
            grads, err = grad_compress.compress_psum(grads, err, "pod", mesh)
            loss = ranks.pmean(loss, "pod", mesh, tag="loss")
        new_p, new_opt, gnorm = opt.update(grads, state.opt, state.params, lr, split_over=split_over, mesh=mesh)
        return TrainState(new_p, new_opt, err), {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def train_step(state: TrainState, batch, lr):
        return apply_grads(state, *loss_and_grads(state.params, batch), lr)

    return TrainStepFns(init_state=init_state, train_step=train_step, loss_and_grads=loss_and_grads,
                        apply_grads=apply_grads, param_pspecs=pspecs)
