"""Stacked per-device state and parameters for fleet-scale simulation
(port of ``repro.fleet.state``).

A *fleet* is N independent duty-cycled accelerators, each with its own
strategy (on-off / idle-waiting / adaptive), configuration-phase parameters,
idle-power method, energy budget, and request stream.  This module holds the
two frozen dataclasses of tensors (one device each) that the
:mod:`repro_torch.fleet.step` loops thread from tick to tick — the
reference's ``lax.scan`` pytrees:

* :class:`FleetParams` — per-device **constants**, shape ``(N,)`` each.  All
  per-item energies/latencies are computed by the *scalar* closed forms
  (:mod:`repro_torch.core.energy_model`, the same code path
  :class:`repro_torch.core.batch_eval.ItemArrays` wraps), so the vectorized
  kernels start from bit-identical inputs to the scalar oracle.
* :class:`FleetState` — per-device **carry** (energy spent, queue, requests
  served, ...), advanced one global time step per loop iteration.

Devices are described by :class:`DeviceSpec` (a fleet-friendly mirror of
:class:`repro.core.workload.ExperimentSpec`); :meth:`FleetParams.from_specs`
stacks any mix of them, and :func:`uniform_fleet` tiles one spec across N
devices without a per-device Python loop.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import AdaptiveStrategy, break_even_timeout_ms
from repro_torch.core.phases import WorkloadItem, paper_lstm_item
from repro_torch.core.strategies import (
    IdlePowerMethod,
    IdleWaitingStrategy,
    OnOffStrategy,
)
from repro_torch.core.workload import ExperimentSpec
from repro_torch.device import resolve_device

__all__ = [
    "STRATEGY_CODES",
    "MODE_OFF",
    "MODE_IDLE",
    "MODE_BUSY",
    "MODE_DEAD",
    "DeviceSpec",
    "FleetParams",
    "FleetState",
    "uniform_fleet",
]

#: Strategy names → integer codes carried in :attr:`FleetParams.strategy`.
STRATEGY_CODES = {"on_off": 0, "idle_waiting": 1, "adaptive": 2}

# Device modes reported by the routed kernel (derived, not carried).
MODE_OFF = 0      # released / powered down
MODE_IDLE = 1     # resident, waiting for the next request
MODE_BUSY = 2     # configuring or executing
MODE_DEAD = 3     # energy budget exhausted


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One fleet device: workload item + policy + budget + traffic period.

    ``strategy`` ∈ {"on_off", "idle_waiting", "adaptive"}.  The adaptive
    strategy resolves exactly like :class:`repro.core.adaptive.
    AdaptiveStrategy`: in periodic mode it picks the winning static arm at
    the device's request period (bit-identical results), and in routed mode
    it runs the ski-rental break-even timeout (the controller's hybrid
    regime).
    """

    item: WorkloadItem
    strategy: str = "idle_waiting"
    method: IdlePowerMethod = IdlePowerMethod.BASELINE
    request_period_ms: float = 40.0
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ
    powerup_overhead_mj: float = 0.0

    def __post_init__(self) -> None:
        if self.strategy not in STRATEGY_CODES:
            raise ValueError(
                f"unknown strategy {self.strategy!r}; choose from {sorted(STRATEGY_CODES)}"
            )
        if not (self.request_period_ms > 0):
            raise ValueError(f"request period must be positive, got {self.request_period_ms}")
        if not (self.e_budget_mj >= 0):
            raise ValueError(f"energy budget must be non-negative, got {self.e_budget_mj}")

    @staticmethod
    def from_experiment(spec: ExperimentSpec) -> "DeviceSpec":
        return DeviceSpec(
            item=spec.item,
            strategy=spec.strategy_kind,
            method=spec.method,
            request_period_ms=spec.workload.request_period_ms,
            e_budget_mj=spec.workload.energy_budget_mj,
            powerup_overhead_mj=spec.powerup_overhead_mj,
        )

    @staticmethod
    def from_model(model: str, **kwargs) -> "DeviceSpec":
        """A device serving one model from the cost zoo (`repro_torch.costs`).

        ``model`` is a registered architecture name (or the paper LSTM);
        the workload item is the model's roofline-calibrated request cost.
        Keyword arguments forward to :func:`repro_torch.costs.model_device_spec`
        (``strategy``, ``request_period_ms``, ``utilization``,
        ``e_budget_mj``, ``batch``, ``prefill_len``, ``decode_len``,
        ``profile``, ``efficiency``, ...).

        >>> spec = DeviceSpec.from_model("mixtral-8x7b", utilization=0.5)
        >>> spec.strategy
        'adaptive'
        >>> spec.request_period_ms >= spec.item.execution_time_ms
        True
        """
        from repro_torch.costs import model_device_spec  # deferred: costs imports fleet

        return model_device_spec(model, **kwargs)

    def with_budget(self, e_budget_mj: float) -> "DeviceSpec":
        """This spec under a different energy budget — convenience for
        materializing a planner allocation
        (:func:`repro_torch.optimize.planner.plan_budgets`) back into
        individual specs; the vectorized hand-off is
        :meth:`FleetParams.with_budgets`, which replaces only the budget
        column of an already-stacked fleet."""
        return dataclasses.replace(self, e_budget_mj=float(e_budget_mj))

    # ---- scalar-path resolution (the oracle's own code) ---------------------
    def idle_power_mw(self) -> float:
        return IdleWaitingStrategy(self.item, self.powerup_overhead_mj, method=self.method).idle_power_mw

    def resolved_strategy(self) -> str:
        """'on_off' | 'idle_waiting': the static arm the periodic kernel runs.

        Adaptive resolves through :meth:`AdaptiveStrategy.select` — the same
        crossover rule the scalar controller applies — so fleet adaptive
        devices are bit-identical to the winning static."""
        if self.strategy != "adaptive":
            return self.strategy
        winner = AdaptiveStrategy(
            self.item, self.powerup_overhead_mj, method=self.method
        ).select(self.request_period_ms)
        return "on_off" if isinstance(winner, OnOffStrategy) else "idle_waiting"

    def timeout_ms(self) -> float:
        """Routed-mode idle timeout: stay resident this long after each
        completion, then release (inf = never, 0 = immediately)."""
        # deliberately keyed on the *declared* strategy, not
        # resolved_strategy(): routed-mode adaptive devices run the
        # ski-rental break-even timeout, never a static 0/inf
        if self.strategy == "on_off":
            return 0.0
        if self.strategy == "idle_waiting":
            return float("inf")
        return break_even_timeout_ms(
            self.item, self.idle_power_mw(), self.powerup_overhead_mj
        )

    def scalar_columns(self) -> dict[str, float]:
        """Every per-device constant, computed through the scalar closed
        forms so the stacked arrays are bit-identical to the oracle's
        inputs."""
        item = self.item
        resolved = self.resolved_strategy()
        is_onoff = resolved == "on_off"
        p_idle = self.idle_power_mw()
        t_req = self.request_period_ms
        if is_onoff:
            feasible = t_req >= em.onoff_latency_ms(item)
            e_item = em.onoff_item_energy_mj(item, self.powerup_overhead_mj)
            e_init = 0.0
            e_idle = 0.0
        else:
            feasible = t_req >= em.idlewait_latency_ms(item)
            e_item = em.idlewait_item_energy_mj(item)
            e_init = em.idlewait_init_energy_mj(item, self.powerup_overhead_mj)
            e_idle = em.idle_energy_mj(item, t_req, p_idle) if feasible else 0.0
        return {
            "strategy": float(STRATEGY_CODES[self.strategy]),
            "is_onoff": float(is_onoff),
            "feasible": float(feasible),
            "period_ms": t_req,
            "e_budget_mj": self.e_budget_mj,
            "e_item_mj": e_item,
            "e_init_mj": e_init,
            "e_idle_mj": e_idle,
            # routed-mode constants (simulate_trace's own quantities)
            "e_exec_mj": item.execution_energy_mj,
            "t_exec_ms": item.execution_time_ms,
            "e_config_mj": item.config_energy_mj + self.powerup_overhead_mj,
            "t_config_ms": item.config_time_ms,
            "p_idle_mw": p_idle,
            "timeout_ms": self.timeout_ms(),
            # power-up ramp alone — lets the energy ledger report the
            # reconfiguration overhead separately from the configure phase
            "e_overhead_mj": self.powerup_overhead_mj,
        }


_FLOAT_FIELDS = (
    "period_ms", "e_budget_mj", "e_item_mj", "e_init_mj", "e_idle_mj",
    "e_exec_mj", "t_exec_ms", "e_config_mj", "t_config_ms", "p_idle_mw",
    "timeout_ms", "e_overhead_mj",
)




def _fields(obj) -> dict[str, torch.Tensor]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@dataclasses.dataclass(frozen=True)
class FleetParams:
    """Stacked per-device constants, each a tensor of shape ``(N,)`` on one
    device.

    Float columns are float64; ``strategy`` is int32
    (:data:`STRATEGY_CODES`), ``is_onoff``/``feasible`` are bool.
    ``is_onoff``/``e_item_mj``/``e_init_mj``/``e_idle_mj`` describe the
    *resolved* static arm (adaptive devices carry their winner's costs).
    """

    strategy: torch.Tensor
    is_onoff: torch.Tensor
    feasible: torch.Tensor
    period_ms: torch.Tensor
    e_budget_mj: torch.Tensor
    e_item_mj: torch.Tensor
    e_init_mj: torch.Tensor
    e_idle_mj: torch.Tensor
    e_exec_mj: torch.Tensor
    t_exec_ms: torch.Tensor
    e_config_mj: torch.Tensor
    t_config_ms: torch.Tensor
    p_idle_mw: torch.Tensor
    timeout_ms: torch.Tensor
    e_overhead_mj: torch.Tensor

    @property
    def n_devices(self) -> int:
        return int(self.period_ms.shape[0])

    @property
    def device(self) -> torch.device:
        return self.period_ms.device

    @staticmethod
    def from_specs(specs: Sequence[DeviceSpec], device="cuda") -> "FleetParams":
        """Stack heterogeneous device specs on ``device`` (one scalar-path
        evaluation per *distinct spec* — repeated specs, e.g. a tenant's
        replicas, are memoized — O(N) only in the final stack)."""
        specs = list(specs)
        if not specs:
            raise ValueError("FleetParams needs at least one device")
        cache: dict[DeviceSpec, dict[str, float]] = {}
        cols = []
        for s in specs:
            c = cache.get(s)
            if c is None:
                c = cache[s] = s.scalar_columns()
            cols.append(c)
        return FleetParams._from_columns(
            {k: np.asarray([c[k] for c in cols], dtype=np.float64) for k in cols[0]},
            device,
        )

    @staticmethod
    def _from_columns(cols: dict[str, np.ndarray], device="cuda") -> "FleetParams":
        device = resolve_device(device)

        def put(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        return FleetParams(
            strategy=put(cols["strategy"], torch.int32),
            is_onoff=put(cols["is_onoff"] != 0.0, torch.bool),
            feasible=put(cols["feasible"] != 0.0, torch.bool),
            **{f: put(cols[f], torch.float64) for f in _FLOAT_FIELDS},
        )

    def tile(self, n: int) -> "FleetParams":
        """Repeat this (small) fleet cyclically up to ``n`` devices — how a
        4096-device fleet is built from a handful of template specs without
        a 4096-iteration Python loop."""
        if n < self.n_devices:
            raise ValueError(f"cannot tile {self.n_devices} devices down to {n}")
        reps = -(-n // self.n_devices)
        return FleetParams(**{k: v.repeat(reps)[:n].contiguous() for k, v in _fields(self).items()})

    def with_budgets(self, e_budgets_mj) -> "FleetParams":
        """Replace only the per-device budget column, shape ``(N,)`` — the
        planner's hand-off: every other constant (and hence the admission
        closed forms) stays bit-identical."""
        budgets = torch.as_tensor(e_budgets_mj, dtype=torch.float64).to(self.device)
        if budgets.shape != self.e_budget_mj.shape:
            raise ValueError(
                f"budgets shape {tuple(budgets.shape)} != fleet shape {tuple(self.e_budget_mj.shape)}"
            )
        return dataclasses.replace(self, e_budget_mj=budgets)


def uniform_fleet(
    n_devices: int,
    item: WorkloadItem | None = None,
    strategies: Sequence[str] = ("idle_waiting",),
    method: IdlePowerMethod = IdlePowerMethod.BASELINE,
    request_period_ms: float = 40.0,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = 0.0,
    device="cuda",
) -> FleetParams:
    """N devices cycling through ``strategies``, otherwise identical."""
    item = item if item is not None else paper_lstm_item()
    template = FleetParams.from_specs(
        [
            DeviceSpec(
                item=item,
                strategy=s,
                method=method,
                request_period_ms=request_period_ms,
                e_budget_mj=e_budget_mj,
                powerup_overhead_mj=powerup_overhead_mj,
            )
            for s in strategies
        ],
        device,
    )
    return template.tile(n_devices)


@dataclasses.dataclass(frozen=True)
class FleetState:
    """Per-device carry of the routed kernel (shape ``(N,)`` unless noted).

    The FIFO ring buffer holds *arrival timestamps* (ms), shape ``(N, Q)``,
    so served requests report exact queueing latency; requests arriving to a
    full buffer are dropped (admission control) and counted in ``n_dropped``.
    """

    energy_mj: torch.Tensor        # f64 — energy spent so far
    idle_energy_mj: torch.Tensor   # f64 — the idle-waiting share of energy_mj
    n_served: torch.Tensor         # i64 — requests completed
    n_configs: torch.Tensor        # i64 — configurations paid (incl. initial)
    n_released: torch.Tensor       # i64 — mid-gap timeout releases
    n_dropped: torch.Tensor        # i64 — arrivals rejected (queue full)
    resident: torch.Tensor         # bool — configured (idling or busy)
    alive: torch.Tensor            # bool — budget not yet exhausted
    completion_ms: torch.Tensor    # f64 — completion time of last served item
    queue_ms: torch.Tensor         # f64 (N, Q) — FIFO of arrival timestamps
    q_head: torch.Tensor           # i32 — ring-buffer head index
    q_len: torch.Tensor            # i32 — queued requests
    rr_ptr: torch.Tensor           # i32 () — round-robin router pointer

    @staticmethod
    def init(n_devices: int, queue_capacity: int = 16, device="cuda") -> "FleetState":
        device = resolve_device(device)

        def full(v, dtype):
            return torch.full((n_devices,), v, dtype=dtype, device=device)

        return FleetState(
            energy_mj=full(0.0, torch.float64),
            idle_energy_mj=full(0.0, torch.float64),
            n_served=full(0, torch.int64),
            n_configs=full(0, torch.int64),
            n_released=full(0, torch.int64),
            n_dropped=full(0, torch.int64),
            resident=full(False, torch.bool),
            alive=full(True, torch.bool),
            completion_ms=full(0.0, torch.float64),
            queue_ms=torch.zeros((n_devices, queue_capacity), dtype=torch.float64, device=device),
            q_head=full(0, torch.int32),
            q_len=full(0, torch.int32),
            rr_ptr=torch.zeros((), dtype=torch.int32, device=device),
        )

    @property
    def queue_capacity(self) -> int:
        return int(self.queue_ms.shape[1])

    def leaves(self) -> tuple[torch.Tensor, ...]:
        """The carry's tensors in field order (what the tick loop threads)."""
        return tuple(_fields(self).values())

    @staticmethod
    def from_leaves(leaves) -> "FleetState":
        return FleetState(*leaves)
