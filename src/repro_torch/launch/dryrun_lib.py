"""Dry-run core (port of ``repro.launch.dryrun_lib``): count every (arch ×
shape × mesh) cell's step on one rank, with no data and no devices.

The reference lowers and compiles each cell on 512 abstract devices and
reads XLA's memory and cost analyses and the HLO.  Here one rank's step
runs on the ``meta`` device (:func:`lower_cell`): the parameters are the
blocks the rank at coordinate 0 of the production mesh would hold, the
batch and the decode state its rows, the collectives the dry mode of
``distributed/ranks.py``, and ``launch/roofline.py`` counts its FLOPs, HBM
bytes and collective bytes.  A cell the port cannot place yet fails as
data (status ``error``, its message naming the ROADMAP item), as the
reference records a failed lowering.

:func:`perf_rules` is the rule table a ``PerfConfig`` asks for, and
:func:`batch_pspecs` the input tree's PartitionSpecs of one cell; both are
specs only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import time
from typing import Any, Optional

import torch

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import chips, make_production_mesh
from repro_torch.models import attention as attn
from repro_torch.models import decoder
from repro_torch.models import model_zoo as zoo
from repro_torch.models.attention import KVCache
from repro_torch.models.mamba2 import SSMCache
from repro_torch.tree import paths

# ---------------------------------------------------------------------------
# Sharding builders
# ---------------------------------------------------------------------------
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


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh, perf: PerfConfig) -> dict:
    """PartitionSpecs for the input batch tree of one cell: the batch over
    (pod, data) where it divides; a decode cell's ``state`` as the
    reference's stacked decode state (``DecodeState(caches={position:
    cache spec})``, a layers entry first; each period's cache of the port
    takes its spec without that entry).  The two cache flags raise: a cache
    split over its sequence waits for a later slice (ROADMAP)."""
    bspec = _batch_dim_spec(shape.global_batch, mesh)

    def leaf_spec(path: str, t) -> P:
        if path == "token":
            return P(bspec)
        if t.dim() >= 2:
            return P(bspec, *([None] * (t.dim() - 1)))
        return P()

    out: dict[str, Any] = {}
    for k, v in zoo.batch_spec(cfg, shape).items():
        out[k] = _decode_state_pspecs(cfg, shape, mesh, perf, v) if k == "state" else leaf_spec(k, v)
    return out


def _decode_state_pspecs(cfg: ArchConfig, shape: ShapeSpec, mesh, perf: PerfConfig, state) -> Any:
    if perf.shard_cache_seq_over_model or perf.shard_long_cache_over_model:
        raise NotImplementedError(
            "a decode cell's cache split over its sequence (shard_cache_seq_over_model, "
            "shard_long_cache_over_model) needs the flash kernel's log-sum-exp combined across "
            "ranks, which waits for a later slice (ROADMAP Queue A)")
    bspec = _batch_dim_spec(shape.global_batch, mesh)
    long = shape.name.startswith("long")
    model_ok = "model" in mesh.axis_names
    tp = mesh.shape["model"] if model_ok else 1

    def cache_spec(c):
        if isinstance(c, KVCache):
            seq_len_c = c.k.shape[1]
            if long and bspec is None:
                seq = "data" if "data" in mesh.axis_names else None
                if cfg.sliding_window and seq_len_c <= cfg.sliding_window:
                    seq = None      # ring buffer: small, replicate
                kv = P(None, None, seq, None, None)
            else:
                kv = P(None, bspec, None, None, None)
            return KVCache(k=kv, v=kv, positions=P(), index=P())
        if isinstance(c, SSMCache):
            h = c.state.shape[1]
            hspec = "model" if (model_ok and h % tp == 0 and bspec is None) else None
            return SSMCache(state=P(None, bspec, hspec, None, None), conv=P(None, bspec, None, None))
        raise TypeError(type(c))

    return decoder.DecodeState(caches={pos: cache_spec(c) for pos, c in state.caches[0].items()})


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


# ---------------------------------------------------------------------------
# Cell counting
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    status: str                  # ok | skipped | error
    reason: str = ""
    compile_s: float = 0.0       # the meta step's seconds (the reference's lowering + compile)
    memory: Optional[dict] = None
    cost_analysis: Optional[dict] = None
    roofline: Optional[dict] = None
    collectives: Optional[dict] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def dry_mesh(mesh: shd.Mesh, coordinate: Optional[tuple] = None) -> shd.Mesh:
    """``mesh`` as one rank of it sees it on the ``meta`` device: its blocks
    at ``coordinate`` (the first rank's by default)."""
    coordinate = (0,) * len(mesh.axis_sizes) if coordinate is None else tuple(coordinate)
    return dataclasses.replace(mesh, device=torch.device("meta"), coordinate=coordinate)


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    perf: PerfConfig = BASELINE,
    mesh: Optional[shd.Mesh] = None,
    cfg: Optional[ArchConfig] = None,
    shape: Optional[ShapeSpec] = None,
) -> CellResult:
    """Count one cell on the production mesh (16×16, or 2×16×16 with
    ``multi_pod``), or on ``mesh`` (a descriptor, e.g. 1×1) with ``cfg`` /
    ``shape`` in place of the registered ones."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES_BY_NAME[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_name = "multi(2x16x16)" if multi_pod else "single(16x16)"
    else:
        mesh_name = "x".join(map(str, mesh.axis_sizes))
    ok, reason = cfg.shape_supported(shape)
    if not ok:
        return CellResult(arch, shape_name, mesh_name, "skipped", reason)
    mesh = dry_mesh(mesh)
    t0 = time.time()
    try:
        with shd.use_sharding(mesh, perf_rules(perf)):
            cost, memory, tokens, training, dtype = _lower(cfg, shape, mesh, perf)
        terms = rf.RooflineTerms(
            flops_per_device=cost.flops,
            bytes_per_device=cost.hbm_bytes,
            collective_bytes_per_device=cost.collective_bytes,
            chips=chips(mesh),
            model_flops=cfg.model_flops_per_token(training) * tokens,
            peak_flops=rf.peak_flops(dtype),
        )
        return CellResult(
            arch, shape_name, mesh_name, "ok",
            compile_s=time.time() - t0,
            memory=memory,
            cost_analysis={"flops": cost.flops, "bytes_accessed": cost.hbm_bytes},
            roofline=terms.to_dict(),
            collectives={
                "bytes_by_kind": cost.coll_bytes,
                "count_by_kind": {k: float(v) for k, v in cost.coll_count.items()},
                "staged_by_tag": cost.staged,
            },
        )
    except Exception as e:  # noqa: BLE001 — dry-run failures are data
        return CellResult(
            arch, shape_name, mesh_name, "error",
            reason=f"{type(e).__name__}: {e}", compile_s=time.time() - t0,
        )


def _rows(mesh, spec) -> int:
    """How many ways a leaf's leading dimension splits under ``spec``."""
    axes = shd._entry_axes(spec[0] if spec else None)
    return math.prod(mesh.shape[a] for a in axes)


def _gb(tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) / 1e9


def _lower(cfg: ArchConfig, shape: ShapeSpec, mesh, perf: PerfConfig):
    """(StepCost, memory, tokens, training, matmul dtype) of one rank's
    step of the cell."""
    dtype = torch.bfloat16
    params = zoo.param_shapes(cfg, dtype)
    bspecs = batch_pspecs(cfg, shape, mesh, perf)
    spread = mesh.size > 1
    long = shape.name.startswith("long")

    def placed():
        if spread and _batch_dim_spec(shape.global_batch, mesh) is None and _dp_size(mesh) > 1:
            raise NotImplementedError(
                f"a batch of {shape.global_batch} rows does not split over (pod, data); a batch "
                "replicated on a mesh waits for a later slice (ROADMAP Queue A)")

    if shape.kind == "train":
        from repro_torch.training.train_loop import make_train_step

        fns = make_train_step(cfg, perf, mesh=mesh)
        placed()
        state = fns.init_state(params)
        batch = {k: ranks.shard(v, bspecs[k], mesh) if spread else v
                 for k, v in zoo.batch_spec(cfg, shape).items()}
        _, cost = rf.count(fns.train_step, state, batch, 1e-4)
        args = [*paths(state.params).values(), *paths(state.opt.m).values(), *paths(state.opt.v).values(),
                *batch.values()]
        return cost, _memory(args, cost), shape.global_batch * shape.seq_len, True, dtype

    # raises for what a mesh cannot serve yet
    layout = zoo.serving_layout(cfg, perf, mesh, long) if spread else None
    placed()
    blocks = zoo.shard_params(params, cfg, mesh) if spread else params
    if shape.kind == "prefill":
        batch = {k: ranks.shard(v, bspecs[k], mesh) if spread else v
                 for k, v in zoo.batch_spec(cfg, shape).items()}
        with torch.no_grad():
            if not cfg.decode_supported:
                _, cost = rf.count(zoo.encode_fn, blocks, batch, cfg)
            else:
                _, cost = rf.count(zoo.prefill_fn, blocks, batch, cfg, shape.seq_len, perf=perf,
                                   mesh=mesh if spread else None)
        args = [*paths(blocks).values(), *batch.values()]
        return cost, _memory(args, cost), shape.global_batch * shape.seq_len, False, dtype

    if shape.kind == "decode":
        rows = shape.global_batch // _rows(mesh, bspecs["token"])
        kv_heads = attn.cache_heads(cfg, layout) if spread else None
        state = decoder.init_decode_state(cfg, rows, shape.seq_len, dtype, torch.device("meta"), kv_heads)
        token = torch.empty((rows,), dtype=torch.int32, device="meta")
        with torch.no_grad():
            _, cost = rf.count(zoo.decode_fn, blocks, state, token, cfg, perf=perf, long_context=long,
                               mesh=mesh if spread else None)
        args = [*paths(blocks).values(), *rf._tensors(state), token]
        return cost, _memory(args, cost), shape.global_batch, False, dtype

    raise ValueError(shape.kind)


def _memory(args, cost: rf.StepCost) -> dict:
    """A rank's bytes: its arguments (parameter blocks, optimizer state,
    batch, decode state) and, at their peak, the step's own tensors alive
    at once."""
    arg = _gb(args)
    temp = cost.temp_peak_bytes / 1e9
    return {"argument_gb": arg, "temp_gb": temp, "per_device_total_gb": arg + temp}


# ---------------------------------------------------------------------------
# Cache-driven runner
# ---------------------------------------------------------------------------
def run_cells(
    cells: list,
    out_path: Optional[str] = None,
    perf: PerfConfig = BASELINE,
    tag: str = "baseline",
) -> list:
    """Count ``cells`` ((arch, shape, multi_pod) each), one line to stderr a
    cell.  With ``out_path`` the results are kept there as JSON by
    ``arch|shape|single-or-multi|tag``, written after every cell, and a
    cell found there ``ok`` or ``skipped`` is not counted again."""
    results = {}
    if out_path and os.path.exists(out_path):
        with open(out_path) as f:
            results = {tuple(k.split("|")): v for k, v in json.load(f).items()}
    out = []
    for arch, shape_name, multi in cells:
        key = (arch, shape_name, "multi" if multi else "single", tag)
        if key in results and results[key].get("status") in ("ok", "skipped"):
            out.append(CellResult(**results[key]))
            continue
        res = lower_cell(arch, shape_name, multi_pod=multi, perf=perf)
        results[key] = res.to_json()
        if out_path:
            with open(out_path, "w") as f:
                json.dump({"|".join(k): v for k, v in results.items()}, f, indent=1)
        print(
            f"[{res.status:7s}] {arch} × {shape_name} × {res.mesh} "
            f"({res.compile_s:.1f}s) {res.reason[:120]}",
            file=sys.stderr, flush=True,
        )
        out.append(res)
    return out
