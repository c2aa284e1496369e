"""Multi-tenant duty-cycling: several models sharing one accelerator slice
(port of ``repro.serving.multi_tenant``).

The paper's related work [5] (Temporal Accelerators) time-multiplexes one
FPGA between bitstreams, paying a reconfiguration per switch.  The
accelerator analogue: several models share one card; a switch = release +
bring-up (the configuration phase).  This scheduler generalizes the
ski-rental policy to N tenants under a shared HBM budget:

* requests for a RESIDENT model are served directly;
* requests for a non-resident model trigger bring-up, evicting resident
  models (cheapest-to-restore first) only if the budget requires it;
* each resident model runs ITS OWN power policy (``Tenant.policy``):

      auto          break-even idle timeout T*_m = E_config(m) / P_idle(m)
                    — per-model ski-rental, so a hot model stays while a
                    cold one ages out (the default, as before)
      idle_waiting  never released by timeout (evictions still apply)
      on_off        released right after each request
      adaptive      a per-tenant :class:`repro_torch.core.adaptive.
                    PolicyController` learns the tenant's inter-arrival
                    pattern and picks idle-waiting / on-off / break-even
                    per the measured crossover — tenants with different
                    traffic shapes each converge to their own best policy
                    on the same slice.

``Tenant.controller`` accepts any object speaking the PolicyController
duck-typed protocol (``observe_gap``, ``idle_timeout_ms``, ``summary``), so
``Tenant(policy="adaptive", controller=...)`` swaps the analytical regime
rule for another timeout policy per tenant — no scheduler changes.

Energy accounting mirrors core.duty_cycle: per-phase wall time × power.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

from repro_torch.core import adaptive
from repro_torch.core.adaptive import PolicyController
from repro_torch.core.phases import CONFIGURATION, IDLE, INFERENCE, WorkloadItem


@dataclasses.dataclass
class Tenant:
    name: str
    bring_up: Callable[[], Any]
    infer: Callable[[Any, Any], Any]
    release: Callable[[Any], None]
    hbm_gb: float                      # resident footprint
    config_mw: float
    infer_mw: float
    idle_mw: float
    policy: str = "auto"               # auto | idle_waiting | on_off | adaptive
    # runtime state
    handle: Any = None
    last_used: float = 0.0
    last_arrival: Optional[float] = None
    measured_config_s: Optional[float] = None
    measured_infer_s: Optional[float] = None
    controller: Optional[PolicyController] = dataclasses.field(
        default=None, repr=False
    )

    def __post_init__(self):
        if self.policy not in ("auto", "idle_waiting", "on_off", "adaptive"):
            raise ValueError(f"tenant {self.name!r}: unknown policy {self.policy!r}")
        if self.policy == "adaptive" and self.controller is None:
            self.controller = PolicyController(idle_power_mw=self.idle_mw)

    def measured_item(self) -> Optional[WorkloadItem]:
        if self.measured_config_s is None or self.measured_infer_s is None:
            return None
        return adaptive.measured_workload_item(
            self.name,
            self.config_mw, self.measured_config_s,
            self.infer_mw, self.measured_infer_s,
            self.idle_mw,
        )

    def observe_gap(self, gap_s: float) -> None:
        if self.controller is not None and gap_s >= 0:
            self.controller.observe_gap(gap_s * 1000.0)

    def timeout_s(self) -> Optional[float]:
        if self.policy == "idle_waiting":
            return None
        if self.policy == "on_off":
            return 0.0
        if self.policy == "adaptive":
            item = self.measured_item()
            if item is None:
                return None
            return adaptive.controller_timeout_s(self.controller, item)
        if self.measured_config_s is None or self.idle_mw <= 0:
            return None
        return self.measured_config_s * self.config_mw / self.idle_mw


class MultiTenantScheduler:
    def __init__(
        self,
        tenants: list[Tenant],
        hbm_budget_gb: float,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.tenants = {t.name: t for t in tenants}
        self.budget = hbm_budget_gb
        self.clock = clock
        self.energy_mj = 0.0
        self.by_phase: dict[str, float] = {}
        self.configurations = 0
        self.evictions = 0
        self._last_account = clock()

    # ---- accounting -------------------------------------------------------
    def _account_idle(self, now: float) -> None:
        """Charge idle power of every resident tenant since the last event —
        but only up to each tenant's own release instant (``last_used +
        timeout``), mirroring core.duty_cycle: a timeout-released tenant is
        off for the remainder of the gap, not idling."""
        start = self._last_account
        if now > start:
            for t in self.tenants.values():
                if t.handle is None:
                    continue
                end = now
                tout = t.timeout_s()
                if tout is not None:
                    end = min(now, t.last_used + tout)
                dt = end - start
                if dt > 0:
                    mj = t.idle_mw * dt
                    self.energy_mj += mj
                    self.by_phase[IDLE] = self.by_phase.get(IDLE, 0.0) + mj
        self._last_account = now

    def _charge(self, phase: str, mw: float, dt: float) -> None:
        mj = mw * dt
        self.energy_mj += mj
        self.by_phase[phase] = self.by_phase.get(phase, 0.0) + mj

    # ---- residency management --------------------------------------------
    def resident_gb(self) -> float:
        return sum(t.hbm_gb for t in self.tenants.values() if t.handle is not None)

    def _expire_timeouts(self, now: float) -> None:
        for t in self.tenants.values():
            if t.handle is None:
                continue
            tout = t.timeout_s()
            if tout is not None and now - t.last_used >= tout:
                t.release(t.handle)
                t.handle = None

    def _evict_for(self, need_gb: float, requester: str) -> None:
        """Evict idle-longest resident tenants until need_gb fits."""
        while self.resident_gb() + need_gb > self.budget:
            candidates = [
                t for t in self.tenants.values()
                if t.handle is not None and t.name != requester
            ]
            if not candidates:
                raise MemoryError(
                    f"cannot fit {requester}: budget {self.budget} GB"
                )
            victim = min(candidates, key=lambda t: t.last_used)
            victim.release(victim.handle)
            victim.handle = None
            self.evictions += 1

    # ---- request path ------------------------------------------------------
    def submit(self, name: str, x: Any) -> Any:
        now = self.clock()
        self._account_idle(now)
        self._expire_timeouts(now)
        t = self.tenants[name]
        if t.last_arrival is not None:
            t.observe_gap(now - t.last_arrival)   # adaptive tenants learn
        t.last_arrival = now
        if t.handle is None:
            self._evict_for(t.hbm_gb, name)
            t0 = self.clock()
            t.handle = t.bring_up()
            t1 = self.clock()
            t.measured_config_s = t1 - t0
            self._charge(CONFIGURATION, t.config_mw, t1 - t0)
            self.configurations += 1
            self._last_account = t1
        t0 = self.clock()
        out = t.infer(t.handle, x)
        t1 = self.clock()
        t.measured_infer_s = t1 - t0
        self._charge(INFERENCE, t.infer_mw, t1 - t0)
        t.last_used = t1
        self._last_account = t1
        if t.timeout_s() == 0.0:
            # on_off policy (or adaptive in its On-Off regime): power down
            # immediately rather than idling until the next event
            t.release(t.handle)
            t.handle = None
        return out

    def summary(self) -> dict:
        return {
            "energy_mj": self.energy_mj,
            "by_phase_mj": dict(self.by_phase),
            "configurations": self.configurations,
            "evictions": self.evictions,
            "resident": [
                t.name for t in self.tenants.values() if t.handle is not None
            ],
            "policies": {t.name: t.policy for t in self.tenants.values()},
            "regimes": {
                t.name: t.controller.summary()["regime"]
                for t in self.tenants.values()
                if t.controller is not None and t.controller.item is not None
            },
        }
