"""Duty-cycle strategies + idle power-saving methods (paper §4.2, Exp. 2–3);
a copy of ``repro.core.strategies`` for the port.

Two strategies for the gap between periodic inference requests:

* :class:`OnOffStrategy` — power off after each workload item; every request
  pays the full configuration phase again.
* :class:`IdleWaitingStrategy` — configure once (initial overhead), then idle
  at ``P_idle`` between requests; items pay execution phases only.

Idle power-saving methods (Table 3), applied to Idle-Waiting:

    baseline    134.3 mW
    method1      34.2 mW  (deactivate clock reference + FPGA IOs;  −74.38%)
    method1+2    24.0 mW  (+ lower V_int/V_aux 1.0/1.8 → 0.75/1.5 V; −81.98%)

Method 2 requires dynamic voltage scaling the paper's hardware lacks; like
the paper, we treat it as a simulator-validated tier (hardware-verified
retention, simulator-estimated lifetime).

Examples
--------
Head-to-head at the paper's 40 ms / 4147 J point, with methods 1+2 and the
calibrated power-up overhead — the abstract's ≈**12.39×** lifetime
extension (calibrated model: 12.41×, within 0.5%):

>>> from repro_torch.core import energy_model as em
>>> from repro_torch.core.phases import paper_lstm_item
>>> from repro_torch.core.strategies import IdlePowerMethod, compare_strategies
>>> cmp_ = compare_strategies(paper_lstm_item(), 40.0,
...                           method=IdlePowerMethod.METHOD1_2,
...                           powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ)
>>> round(cmp_["lifetime_ratio"], 2)
12.41
>>> abs(cmp_["lifetime_ratio"] - 12.39) / 12.39 < 0.005
True

The decision boundary between the two strategies is the closed-form
crossover — **499.06 ms** under methods 1+2:

>>> from repro_torch.core.strategies import IdleWaitingStrategy
>>> iw = IdleWaitingStrategy(paper_lstm_item(),
...                          em.CALIBRATED_POWERUP_OVERHEAD_MJ,
...                          method=IdlePowerMethod.METHOD1_2)
>>> iw.idle_power_mw
24.0
>>> round(iw.crossover_vs_onoff_ms(), 2)
499.06
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable

from repro_torch.core import energy_model as em
from repro_torch.core.phases import WorkloadItem


class IdlePowerMethod(enum.Enum):
    """Idle power-saving methods of Experiment 3 (Table 3)."""

    BASELINE = "baseline"
    METHOD1 = "method1"          # deactivate clock reference + IOs
    METHOD1_2 = "method1+2"      # + retention-voltage scaling (simulated)


#: Hardware-measured idle powers (Table 3), mW.
IDLE_POWER_MW = {
    IdlePowerMethod.BASELINE: 134.3,
    IdlePowerMethod.METHOD1: 34.2,
    IdlePowerMethod.METHOD1_2: 24.0,
}

#: Constant flash-chip draw folded into every Table-3 figure (paper §5.4).
FLASH_POWER_MW = 15.2


def idle_power_saving_pct(method: IdlePowerMethod) -> float:
    """Percent idle power saved vs. baseline (paper: 74.38%, 81.98%)."""
    base = IDLE_POWER_MW[IdlePowerMethod.BASELINE]
    return 100.0 * (base - IDLE_POWER_MW[method]) / base


@dataclasses.dataclass(frozen=True)
class Strategy:
    """Common interface: evaluate n_max / lifetime at a request period."""

    item: WorkloadItem
    powerup_overhead_mj: float = 0.0

    name: str = "abstract"

    def evaluate(self, request_period_ms: float, e_budget_mj: float) -> em.StrategyResult:
        raise NotImplementedError

    def sweep(
        self, request_periods_ms: Iterable[float], e_budget_mj: float
    ) -> list[em.StrategyResult]:
        from repro_torch.core.config_phase import _validate_grid_axis

        periods = list(request_periods_ms)
        _validate_grid_axis("request_periods_ms", periods, caller=f"{self.name}.sweep")
        return [self.evaluate(t, e_budget_mj) for t in periods]

    def min_request_period_ms(self) -> float:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class OnOffStrategy(Strategy):
    name: str = "on_off"

    def evaluate(self, request_period_ms: float, e_budget_mj: float) -> em.StrategyResult:
        return em.evaluate_onoff(
            self.item, request_period_ms, e_budget_mj, self.powerup_overhead_mj
        )

    def min_request_period_ms(self) -> float:
        """Below the full (config-included) latency the FPGA cannot be ready
        for the next request (paper: no On-Off points below 36.15 ms)."""
        return em.onoff_latency_ms(self.item)


@dataclasses.dataclass(frozen=True)
class IdleWaitingStrategy(Strategy):
    method: IdlePowerMethod = IdlePowerMethod.BASELINE
    name: str = "idle_waiting"

    @property
    def idle_power_mw(self) -> float:
        if self.method is IdlePowerMethod.BASELINE:
            # Baseline uses the item's own measured idle power (Table 2).
            return self.item.idle_power_mw
        return IDLE_POWER_MW[self.method]

    def evaluate(self, request_period_ms: float, e_budget_mj: float) -> em.StrategyResult:
        r = em.evaluate_idlewait(
            self.item,
            request_period_ms,
            e_budget_mj,
            idle_power_mw=self.idle_power_mw,
            powerup_overhead_mj=self.powerup_overhead_mj,
        )
        return dataclasses.replace(r, strategy=f"idle_waiting[{self.method.value}]")

    def min_request_period_ms(self) -> float:
        return em.idlewait_latency_ms(self.item)

    def crossover_vs_onoff_ms(self) -> float:
        """Request period below which this strategy beats On-Off."""
        return em.crossover_period_ms(
            self.item, self.idle_power_mw, self.powerup_overhead_mj
        )


def compare_strategies(
    item: WorkloadItem,
    request_period_ms: float,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    method: IdlePowerMethod = IdlePowerMethod.BASELINE,
    powerup_overhead_mj: float = 0.0,
) -> dict:
    """Head-to-head at one request period: items, lifetimes, and ratios."""
    onoff = OnOffStrategy(item, powerup_overhead_mj).evaluate(request_period_ms, e_budget_mj)
    iw = IdleWaitingStrategy(item, powerup_overhead_mj, method=method).evaluate(
        request_period_ms, e_budget_mj
    )
    return {
        "request_period_ms": request_period_ms,
        "on_off": onoff,
        "idle_waiting": iw,
        "items_ratio": (iw.n_max / onoff.n_max) if onoff.n_max else float("inf"),
        "lifetime_ratio": (iw.lifetime_ms / onoff.lifetime_ms) if onoff.lifetime_ms else float("inf"),
    }
