"""The dry run's sharding builders (port of part of
``repro.launch.dryrun_lib``): :func:`perf_rules`, the rule table a
``PerfConfig`` asks for, and :func:`batch_pspecs`, the input batch's
PartitionSpecs of one (arch × shape) cell.  Both are specs only and need
no devices.

The reference's cell lowering (``lower_cell``, ``run_cells``: abstract
parameters and batches through ``jit(...).lower(...).compile()``, memory
and cost analysis) and its decode-state placements wait for ROADMAP A13c
and the sharded prefill and decode slice; :func:`batch_pspecs` takes the
``train`` and ``prefill`` cells.
"""
from __future__ import annotations

from typing import Any

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.perf import PerfConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P


def _dp_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _dp_size(mesh) -> int:
    n = 1
    for a in _dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def _batch_dim_spec(b: int, mesh) -> Any:
    dp = _dp_axes(mesh)
    if not dp or b % _dp_size(mesh):
        return None
    return dp[0] if len(dp) == 1 else dp        # as ``P`` writes a one-axis entry


def _batch_ranks(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """Each input leaf's number of dimensions (``model_zoo.batch_spec`` of
    the reference, for a train or prefill cell)."""
    if shape.kind not in ("train", "prefill"):
        raise NotImplementedError(
            f"batch_pspecs of a {shape.kind} cell places the decode state, which waits for the "
            "sharded prefill and decode slice (ROADMAP)")
    if cfg.frontend == "vision":
        out = {"tokens": 2, "patch_embeds": 3}
    elif cfg.frontend == "audio":
        out = {"features": 3}
    else:
        out = {"tokens": 2}
    if shape.kind == "train":
        out["labels"] = 2
    return out


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh, perf: PerfConfig) -> dict:
    """PartitionSpecs for the input batch tree of one train or prefill
    cell: the leading (batch) dimension over (pod, data) where it divides."""
    bspec = _batch_dim_spec(shape.global_batch, mesh)
    return {k: P(bspec, *([None] * (ndim - 1))) for k, ndim in _batch_ranks(cfg, shape).items()}


def perf_rules(perf: PerfConfig) -> dict:
    rules = dict(shd.DEFAULT_RULES)
    if perf.grad_compress_pod:
        # hierarchical ZeRO: the compressed reduction handles the pod axis
        # itself — parameters replicate across pods and no logical rule may
        # name "pod"
        for k, v in list(rules.items()):
            if isinstance(v, tuple) and "pod" in v:
                slim = tuple(a for a in v if a != "pod")
                rules[k] = slim if slim else None
    if perf.shard_long_cache_over_model:
        rules["long_cache_seq"] = "model"
    if perf.shard_cache_seq_over_model:
        rules["cache_seq"] = "model"
    return rules
