"""Runnable duty-cycle controller — the paper's strategies as mechanisms.
(A copy of ``repro.core.duty_cycle`` for the port.)

Wraps three callables of a real serving deployment:

    bring_up()  — load weights from checkpoint + (re)build the executable
                  (the *configuration phase*; returns the serving handle)
    infer(h, x) — run one inference request (the *workload item* execution)
    release(h)  — drop device buffers (the *power-off*)

Strategies:
    on_off        release after every request; bring_up on the next one
    idle_waiting  bring_up once; keep resident between requests
    auto          *configuration-aware*: measure the phases online and
                  idle-wait with a BREAK-EVEN TIMEOUT — release only after
                  idling for T* = E_config / P_idle (the point where idling
                  has cost as much as one reconfiguration).  This is the
                  ski-rental competitive policy: ≤2× the clairvoyant
                  optimum for ANY arrival process, which answers the
                  paper's stated future work (§7, irregular requests) —
                  a predict-then-commit policy (e.g. mean of recent
                  periods) is provably unbounded-worse on bursty traffic
                  (the reference's benchmarks/bench_irregular.py shows it
                  losing to BOTH static strategies).
    adaptive      `auto` plus regime learning
                  (:class:`repro_torch.core.adaptive.PolicyController`): the
                  observed inter-arrival estimate picks pure Idle-Waiting
                  below the measured crossover and pure On-Off above it,
                  falling back to the break-even timeout during warmup,
                  near the crossover (hysteresis band), or on bursty
                  traffic — so stationary workloads converge to the best
                  static strategy while irregular ones keep the ski-rental
                  bound.

``policy=`` accepts *any* object speaking the PolicyController duck-typed
protocol (``set_item`` / ``observe_gap`` / ``idle_timeout_ms`` /
``idle_power_mw`` / ``summary``), not just
:class:`~repro_torch.core.adaptive.PolicyController` itself — in particular
a learned timeout policy can drop in unchanged behind the same
``strategy="adaptive"`` plumbing.

The controller records wall-clock per phase and converts to energy via a
pluggable power model, so the simulator's predictions are checkable against
the runnable system (examples/duty_cycle_serving.py).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.core import adaptive, energy_model as em
from repro_torch.core.adaptive import PolicyController
from repro_torch.core.phases import CONFIGURATION, IDLE, INFERENCE, WorkloadItem


@dataclasses.dataclass
class PhaseRecord:
    name: str
    wall_s: float
    t_start: float


@dataclasses.dataclass
class PowerModel:
    """Average power (mW) per phase for energy accounting."""

    config_mw: float
    infer_mw: float
    idle_mw: float
    off_mw: float = 0.0

    def energy_mj(self, rec: PhaseRecord) -> float:
        p = {
            CONFIGURATION: self.config_mw,
            INFERENCE: self.infer_mw,
            IDLE: self.idle_mw,
            "off": self.off_mw,
        }[rec.name]
        return p * rec.wall_s  # 1 mW · 1 s = 1 mJ


class DutyCycleController:
    def __init__(
        self,
        bring_up: Callable[[], Any],
        infer: Callable[[Any, Any], Any],
        release: Callable[[Any], None],
        power: PowerModel,
        strategy: str = "auto",
        clock: Callable[[], float] = time.perf_counter,
        policy: Optional[PolicyController] = None,
    ):
        assert strategy in ("on_off", "idle_waiting", "auto", "adaptive")
        self.bring_up_fn = bring_up
        self.infer_fn = infer
        self.release_fn = release
        self.power = power
        self.strategy = strategy
        self.clock = clock
        self.handle: Any = None
        self.records: list[PhaseRecord] = []
        self._last_done: Optional[float] = None
        self._last_arrival: Optional[float] = None
        self._observed_periods: list[float] = []
        self._measured: dict[str, float] = {}   # phase → last wall_s
        if strategy == "adaptive" and policy is None:
            policy = PolicyController(idle_power_mw=power.idle_mw)
        self.policy = policy

    # ---- accounting ----
    def _record(self, name: str, t0: float, t1: float) -> None:
        self.records.append(PhaseRecord(name, t1 - t0, t0))
        self._measured[name] = t1 - t0

    def energy_mj(self) -> float:
        return sum(self.power.energy_mj(r) for r in self.records)

    def energy_by_phase_mj(self) -> dict:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + self.power.energy_mj(r)
        return out

    # ---- strategy decision (the configuration-aware part) ----
    def measured_item(self) -> Optional[WorkloadItem]:
        if CONFIGURATION not in self._measured or INFERENCE not in self._measured:
            return None
        return adaptive.measured_workload_item(
            "measured",
            self.power.config_mw, self._measured[CONFIGURATION],
            self.power.infer_mw, self._measured[INFERENCE],
            self.power.idle_mw,
        )

    def crossover_ms(self) -> Optional[float]:
        item = self.measured_item()
        if item is None:
            return None
        return em.crossover_period_ms(item)

    def timeout_s(self) -> Optional[float]:
        """Idle timeout before release: break-even T* = E_config / P_idle
        for `auto` (ski-rental); regime-dependent for `adaptive` (∞ in the
        Idle-Waiting regime, 0 in the On-Off regime, break-even otherwise).
        ``None`` = no release scheduled."""
        if CONFIGURATION not in self._measured:
            return None
        if self.strategy == "adaptive":
            item = self.measured_item()
            if item is None:
                return None
            return adaptive.controller_timeout_s(self.policy, item)
        e_config_mj = self.power.config_mw * self._measured[CONFIGURATION]
        if self.power.idle_mw <= 0:
            return None
        return e_config_mj / self.power.idle_mw

    def maybe_release(self, now: float) -> bool:
        """auto/adaptive policies: release if we have idled past the
        policy's timeout.  Returns True if a release happened.  Live
        schedulers call this during idle gaps (serving/scheduler.py); the
        energy ledger charges idle power up to the release instant."""
        if self.strategy not in ("auto", "adaptive") or self.handle is None:
            return False
        t = self.timeout_s()
        if t is None or self._last_done is None:
            return False
        if now - self._last_done < t:
            return False
        self._record(IDLE, self._last_done, self._last_done + t)
        self.release_fn(self.handle)
        self.handle = None
        self._last_done = self._last_done + t   # remainder accounted as off
        return True

    def _decide_release(self) -> bool:
        """Post-request release decision.  Static `on_off` always releases;
        `adaptive` releases here too once its regime says On-Off (timeout
        0) — `auto` and the other adaptive regimes release via the idle
        timeout instead."""
        if self.strategy == "on_off":
            return True
        return self.strategy == "adaptive" and self.timeout_s() == 0.0

    # ---- request path ----
    def submit(self, x: Any) -> Any:
        if self.strategy in ("auto", "adaptive"):
            # retroactive timeout for schedulers that never tick
            self.maybe_release(self.clock())
        now = self.clock()
        # the submit instant IS the arrival: observe inter-arrival times
        # directly, unbiased by releases/bring-ups in between (which shift
        # _last_done but not the arrival clock)
        if self._last_arrival is not None:
            period = now - self._last_arrival
            self._observed_periods.append(period)
            if self.strategy == "adaptive":
                self.policy.observe_gap(period * 1000.0)
        self._last_arrival = now
        if self._last_done is not None:
            self._record(IDLE if self.handle is not None else "off",
                         self._last_done, now)
        if self.handle is None:
            t0 = self.clock()
            self.handle = self.bring_up_fn()
            self._record(CONFIGURATION, t0, self.clock())
        t0 = self.clock()
        out = self.infer_fn(self.handle, x)
        self._record(INFERENCE, t0, self.clock())
        if self._decide_release():
            self.release_fn(self.handle)
            self.handle = None
        self._last_done = self.clock()
        return out

    def next_release_time(self) -> Optional[float]:
        """Absolute time the auto/adaptive policy will release, if resident."""
        if (
            self.strategy not in ("auto", "adaptive")
            or self.handle is None
            or self._last_done is None
        ):
            return None
        t = self.timeout_s()
        return None if t is None else self._last_done + t

    def summary(self) -> dict:
        out = {
            "strategy": self.strategy,
            "requests": sum(1 for r in self.records if r.name == INFERENCE),
            "configurations": sum(1 for r in self.records if r.name == CONFIGURATION),
            "energy_mj": self.energy_mj(),
            "energy_by_phase_mj": self.energy_by_phase_mj(),
            "crossover_ms": self.crossover_ms(),
            "timeout_s": self.timeout_s(),
        }
        if self.strategy == "adaptive" and self.policy.item is not None:
            out["policy"] = self.policy.summary()
        return out
