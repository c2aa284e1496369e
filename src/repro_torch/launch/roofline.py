"""Roofline analysis (port of ``repro.launch.roofline``).

Three lower bounds on a step's time on one card, from the counts of one
rank's step:

    compute    = FLOPs            / peak FLOP/s of the step's dtype
    memory     = HBM bytes        / HBM bandwidth
    collective = collective bytes / the collectives' rate

The reference parses the optimized HLO of a compiled step.  Eager torch has
no HLO: :func:`count` runs one rank's step on the ``meta`` device (shapes,
no data) under one dispatch mode that counts three things instead.

* **FLOPs** — ``torch.utils.flop_counter``'s formulas (the registry
  ``FlopCounterMode`` reads) applied to every dispatched op: each
  matmul-like op at 2·|out|·K (the reference's "every ``dot``"); the
  hand-written kernels are ``torch.library`` ops on ``meta`` with the
  FLOPs of ``costs/counts.py`` (``kernels/meta_ops.py``).  Unlike
  ``FlopCounterMode`` it does not decompose the ops it has no formula for
  (a third of a full-width cell's time; none of them holds a matmul here,
  ``tests/test_torch_roofline.py`` holds the two counts equal).
* **HBM bytes** — a dispatch mode over the aten ops: each op reads its
  operands and writes its output, views and allocations are free; the
  kernels' ops count the bytes of ``costs/counts.py``.  This is the
  reference's materialization-boundary model with one eager op as one
  boundary (an upper bound where the card's 50 MB L2 keeps a small
  operand).
* **Collective bytes** — the dry mode of ``distributed/ranks.py``: each
  staged collective on ``meta`` tensors returns a ``meta`` result and
  counts what a live run's ``ranks.stats`` would count under the same tag
  (:attr:`StepCost.staged`), and the reference's ring model over its
  group's size (:attr:`StepCost.coll_bytes`).  No process group is made.

The ceilings are the card's (below).  The collectives' rate on one card is
the host-staged gloo rate the mesh phase measures, not an NVLink or NCCL
figure, none of which has been measured here.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import ranks
from repro_torch.kernels import meta_ops

# --- NVIDIA H100 80GB HBM3 (SXM), NVIDIA's data sheet, dense rates at the
# card's 700 W limit; the bounds PERF.md's kernel table uses ---
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, bf16 on the tensor cores
PEAK_FLOPS_FP32 = 67e12       # FLOP/s, fp32 outside the tensor cores
HBM_BW = 3.35e12              # B/s
#: B/s: the rate of ``chip_smoke.py``'s mesh phase's host-staged gloo
#: collectives on one H100 (0.6–2 GB/s, PERF.md §5: bytes a rank staged over
#: the seconds they took); the top of that range, so the bound stays a lower
#: bound
GLOO_HOST_STAGED_BW = 2e9

_FREE_OPS = {
    torch.ops.aten.empty.memory_format,
    torch.ops.aten.empty_strided.default,
    torch.ops.aten.empty_like.default,
    torch.ops.aten.new_empty.default,
    torch.ops.aten.new_empty_strided.default,
    torch.ops.aten.lift_fresh.default,
    torch.ops.aten.detach.default,
    torch.ops.aten.alias.default,
}


def peak_flops(dtype: torch.dtype) -> float:
    """The card's peak FLOP/s for a step whose matmuls run in ``dtype``."""
    return PEAK_FLOPS_FP32 if dtype == torch.float32 else PEAK_FLOPS_BF16


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """FLOPs, HBM bytes by the materialization-boundary model, and the
    bytes of the tensors the step creates that are alive at once (their
    peak)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0.0
        self.live: dict = {}          # {storage: bytes} of the step's tensors alive now
        self.total = 0
        self.peak = 0

    def _free(self, key) -> None:
        self.total -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        outs = _tensors(out)
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if packet in meta_ops.BYTES:
            self.bytes += meta_ops.BYTES[packet](args, out)
        elif not (func.is_view or func in _FREE_OPS):
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in outs)
        if not func.is_view:
            for t in outs:
                key = t.untyped_storage()._cdata
                if key not in self.live:
                    self.live[key] = t.untyped_storage().nbytes()
                    self.total += self.live[key]
                    weakref.finalize(t, self._free, key)
            self.peak = max(self.peak, self.total)
        return out


@dataclasses.dataclass
class StepCost:
    """One rank's counts of one step (module docstring)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_bytes: dict = dataclasses.field(default_factory=dict)     # ring model, by kind
    coll_count: dict = dataclasses.field(default_factory=dict)
    staged: dict = dataclasses.field(default_factory=dict)         # ranks.stats: {tag: {calls, bytes}}
    temp_peak_bytes: int = 0       # the step's own tensors alive at once, at their peak

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def count(step: Callable, *args, **kwargs) -> tuple[Any, StepCost]:
    """``step(*args, **kwargs)`` under the counters → (its result, its
    :class:`StepCost`).  Run on ``meta`` tensors it computes nothing and
    counts every op (the kernels through their meta ops); on CUDA tensors
    the kernels launch as they always do and count no FLOPs or bytes."""
    saved = ranks.stats, ranks.traffic
    ranks.stats, ranks.traffic = {}, {}
    traffic = _Counter()
    try:
        with traffic:
            out = step(*args, **kwargs)
        cost = StepCost(
            flops=float(traffic.flops),
            hbm_bytes=traffic.bytes,
            coll_bytes={k: v["bytes"] for k, v in ranks.traffic.items()},
            coll_count={k: v["count"] for k, v in ranks.traffic.items()},
            staged={k: {"calls": v["calls"], "bytes": v["bytes"]} for k, v in ranks.stats.items()},
            temp_peak_bytes=traffic.peak,
        )
    finally:
        ranks.stats, ranks.traffic = saved
    return out, cost


@dataclasses.dataclass
class RooflineTerms:
    """The reference's terms on the card's ceilings: ``peak_flops`` is the
    step's dtype's (:func:`peak_flops`), ``collective_bw`` the collectives'
    rate (the host-staged gloo's by default)."""

    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops: float = 0.0            # 6·N·D (train) / 2·N·D (serve), global
    peak_flops: float = PEAK_FLOPS_BF16
    collective_bw: float = GLOO_HOST_STAGED_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.collective_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        counted = self.flops_per_device * self.chips
        return (self.model_flops / counted) if counted else 0.0

    @property
    def mfu_bound(self) -> float:
        t = self.step_time_lower_bound_s
        if not t:
            return 0.0
        return self.model_flops / (self.chips * self.peak_flops * t)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_lower_bound_s": self.step_time_lower_bound_s,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
        }
