"""Rack-granularity idle-vs-off autoscaling via the paper's crossover rule
(port of ``repro.control.autoscaler``; host Python over the rack's
constants, summed in numpy as the reference sums them).

The paper's decision is scale-free: "should this unit stay resident through
a gap of length g, or power off and pay a (re)configuration on the next
request?"  At device scale the reconfiguration is a bitstream load; at rack
scale it is the bring-up (``RackSpec.bringup_mj`` over ``bringup_ms``) and
the idle draw is the *sum* of the children's idle power.  The closed forms
transfer verbatim:

    rack T*_be   =  E_bringup / (P_idle^rack / 1000)          (break-even)
    rack T_cross =  rack T*_be + T_ready                      (crossover)

mirroring :func:`repro_torch.core.energy_model.crossover_period_ms` op-for-op, so
a rack whose constants are scaled copies of a device's reproduces the
device crossover × the scale factor exactly (the golden recursion pin in
``tests/test_paper_numbers.py`` of the reference).

Two controllers share the decide-from-gap-estimate protocol:

* :class:`CrossoverAutoscaler` — the static analytical rule: EWMA gap
  estimate against the rack crossover, with the same ±hysteresis hold band
  as :meth:`repro_torch.core.adaptive.AdaptiveStrategy.decide` so estimate noise
  near the threshold cannot flap racks on and off.
* :class:`PolicyAutoscaler` — wraps any PolicyController-protocol object
  (``observe_gap`` / ``idle_timeout_ms``), e.g. a trained
  :class:`repro_torch.policy.controller.LearnedTimeoutPolicy` fed the rack's
  pseudo workload item (:func:`rack_workload_item`).

Both expose ``idle_timeout_ms()`` — how long a rack may sit with an empty
queue before the simulator powers it off — and count ``power_transitions``.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np

from repro_torch.control.hierarchy import RackSpec
from repro_torch.core.phases import CONFIGURATION, INFERENCE, Phase, WorkloadItem
from repro_torch.fleet.step import _np

__all__ = [
    "CrossoverAutoscaler",
    "PolicyAutoscaler",
    "rack_break_even_ms",
    "rack_crossover_ms",
    "rack_idle_power_mw",
    "rack_reconfig_energy_mj",
    "rack_workload_item",
]


def rack_idle_power_mw(spec: RackSpec) -> float:
    """The rack's P_idle one level up: the sum of its children's draws."""
    return spec.idle_power_mw()


def rack_reconfig_energy_mj(spec: RackSpec) -> float:
    """Total energy a rack power-cycle costs on the next request wave: the
    rack-level bring-up plus every child's reconfiguration (powering a rack
    off marks all devices non-resident, so each pays ``e_config_mj`` on its
    next serve — rack On-Off *is* device On-Off plus the shared bring-up)."""
    return spec.bringup_mj + float(np.sum(_np(spec.params.e_config_mj)))


def rack_break_even_ms(bringup_mj: float, idle_power_mw: float) -> float:
    """Rack ski-rental break-even: idle exactly long enough that staying
    resident has cost one bring-up (cf.
    :func:`repro_torch.core.adaptive.break_even_timeout_ms`)."""
    if idle_power_mw <= 0:
        return math.inf
    if not bringup_mj > 0.0:
        return 0.0
    return bringup_mj / (idle_power_mw / 1000.0)


def rack_crossover_ms(
    bringup_mj: float, idle_power_mw: float, ready_ms: float = 0.0
) -> float:
    """Rack-level T_cross, op-for-op the device closed form
    ``(E_onoff − E_iw)/(P_idle/1000) + T_lat`` with the bring-up energy as
    the configuration delta and the bring-up-free serving latency as T_lat —
    below this gap, keeping the rack idle beats power-cycling it."""
    if idle_power_mw <= 0:
        return math.inf
    return bringup_mj / (idle_power_mw / 1000.0) + ready_ms


def rack_workload_item(
    spec: RackSpec, name: Optional[str] = None, exec_ms: float = 1.0
) -> WorkloadItem:
    """The rack as a pseudo :class:`~repro_torch.core.phases.WorkloadItem` one
    level up: configuration phase = the full rack power-cycle cost
    (:func:`rack_reconfig_energy_mj`) over ``bringup_ms``, idle power = the
    aggregated child draw.  This is the hand-off that lets *device*-scale
    controllers (:class:`repro_torch.core.adaptive.PolicyController`,
    :class:`repro_torch.policy.controller.LearnedTimeoutPolicy`) drive rack
    power states unchanged."""
    e_cfg = rack_reconfig_energy_mj(spec)
    t_cfg = spec.bringup_ms if spec.bringup_ms > 0 else 1.0
    exec_mw = 0.0  # rack serving energy is accounted by the child devices
    return WorkloadItem(
        name=name or f"rack:{spec.name}",
        phases=(
            Phase(CONFIGURATION, e_cfg * 1000.0 / t_cfg, t_cfg),
            Phase(INFERENCE, exec_mw, exec_ms),
        ),
        idle_power_mw=rack_idle_power_mw(spec),
    )


class CrossoverAutoscaler:
    """EWMA rack-gap estimate → idle timeout via the rack crossover rule.

    Decision semantics mirror
    :meth:`repro_torch.core.adaptive.AdaptiveStrategy.decide`: estimate ≤ T_cross
    → stay resident (Idle-Waiting at rack scale, timeout ∞); estimate >
    T_cross → power off when idle (On-Off, timeout 0); inside the
    ±``hysteresis`` band the previous decision holds, so ±band oscillation
    around the crossover causes at most the one initial transition.  During
    warmup (< ``min_observations`` gaps) the timeout is the rack break-even
    — the ski-rental hybrid, ≤2× optimal on any stream.
    """

    kind = "crossover"

    def __init__(
        self,
        bringup_mj: float,
        idle_power_mw: float,
        ready_ms: float = 0.0,
        hysteresis: float = 0.1,
        ewma_alpha: float = 0.3,
        min_observations: int = 3,
    ):
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.bringup_mj = bringup_mj
        self.idle_power_mw = idle_power_mw
        self.ready_ms = ready_ms
        self.hysteresis = hysteresis
        self.ewma_alpha = ewma_alpha
        self.min_observations = min_observations
        self._mean_ms: Optional[float] = None
        self.n_observed = 0
        self._decision: Optional[str] = None
        self.power_transitions = 0

    @classmethod
    def for_rack(cls, spec: RackSpec, **kwargs) -> "CrossoverAutoscaler":
        return cls(
            bringup_mj=rack_reconfig_energy_mj(spec),
            idle_power_mw=rack_idle_power_mw(spec),
            ready_ms=spec.bringup_ms,
            **kwargs,
        )

    def crossover_ms(self) -> float:
        return rack_crossover_ms(self.bringup_mj, self.idle_power_mw, self.ready_ms)

    def break_even_ms(self) -> float:
        return rack_break_even_ms(self.bringup_mj, self.idle_power_mw)

    def observe_gap(self, gap_ms: float) -> None:
        if gap_ms < 0:
            raise ValueError(f"negative gap {gap_ms}")
        self.n_observed += 1
        if self._mean_ms is None:
            self._mean_ms = gap_ms
        else:
            self._mean_ms += self.ewma_alpha * (gap_ms - self._mean_ms)

    @property
    def estimate_ms(self) -> Optional[float]:
        return self._mean_ms

    def decide(self) -> str:
        """'idle_waiting' | 'on_off' at rack scale, with the hysteresis
        hold — the AdaptiveStrategy.decide rule on the rack constants."""
        if self._mean_ms is None or self.n_observed < self.min_observations:
            return self._decision or "idle_waiting"
        cross = self.crossover_ms()
        if self._decision in ("idle_waiting", "on_off") and self.hysteresis > 0:
            lo = cross * (1.0 - self.hysteresis)
            hi = cross * (1.0 + self.hysteresis)
            if lo <= self._mean_ms <= hi:
                return self._decision
        return "idle_waiting" if self._mean_ms <= cross else "on_off"

    def idle_timeout_ms(self) -> float:
        """∞ = keep the rack resident, 0 = power off as soon as the queue
        drains, break-even during warmup."""
        if self._mean_ms is None or self.n_observed < self.min_observations:
            return self.break_even_ms()
        decision = self.decide()
        if decision != self._decision:
            if self._decision is not None:
                self.power_transitions += 1
            self._decision = decision
        return math.inf if decision == "idle_waiting" else 0.0

    def summary(self) -> dict:
        return {
            "kind": self.kind,
            "estimate_ms": self._mean_ms,
            "crossover_ms": self.crossover_ms(),
            "break_even_ms": self.break_even_ms(),
            "observations": self.n_observed,
            "power_transitions": self.power_transitions,
        }


class PolicyAutoscaler:
    """Drive rack power states from any PolicyController-protocol object.

    The wrapped controller (``observe_gap`` / ``idle_timeout_ms``) sees the
    rack's inter-arrival gaps; its timeout becomes the rack's idle-off
    timeout.  ``power_transitions`` counts flips between the resident
    (timeout = ∞) and releasing (finite timeout) stances — the quantity the
    no-flap regression bounds for a
    :class:`repro_torch.policy.controller.LearnedTimeoutPolicy` at rack scale.
    """

    kind = "policy"

    def __init__(self, controller):
        self.controller = controller
        self._stance: Optional[bool] = None  # True = resident (inf timeout)
        self.power_transitions = 0

    def observe_gap(self, gap_ms: float) -> None:
        self.controller.observe_gap(gap_ms)

    def idle_timeout_ms(self) -> float:
        t = self.controller.idle_timeout_ms()
        stance = math.isinf(t)
        if self._stance is not None and stance != self._stance:
            self.power_transitions += 1
        self._stance = stance
        return t

    def summary(self) -> dict:
        base = {"kind": self.kind, "power_transitions": self.power_transitions}
        if hasattr(self.controller, "summary"):
            base["controller"] = self.controller.summary()
        return base
