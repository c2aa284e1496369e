"""Deployment planner: invert the analytical model (Eqs. 1–4); a copy of
``repro.core.planner`` for the port.

The paper answers "given a configuration, how long does the system live?".
Deployments ask the inverse questions; this module answers them from the
same closed forms:

* :func:`required_idle_power` — what idle power (→ which power-saving
  method / idle tier) achieves a target lifetime at a given request period?
* :func:`required_budget` — what energy budget (battery) sustains a target
  number of items?
* :func:`best_strategy` — which strategy maximizes items for a period?
* :func:`plan` — full report for a (workload, target) pair, including the
  paper's method tiers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core import energy_model as em
from repro_torch.core.phases import WorkloadItem
from repro_torch.core.strategies import IDLE_POWER_MW, IdlePowerMethod


def required_idle_power(
    item: WorkloadItem,
    request_period_ms: float,
    target_lifetime_h: float,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = 0.0,
) -> Optional[float]:
    """Max idle power (mW) that still reaches the target lifetime under
    Idle-Waiting; None if unreachable even at zero idle power."""
    n_target = math.ceil(target_lifetime_h * 3.6e6 / request_period_ms)
    e_init = em.idlewait_init_energy_mj(item, powerup_overhead_mj)
    e_item = em.idlewait_item_energy_mj(item)
    t_idle_ms = request_period_ms - em.idlewait_latency_ms(item)
    if t_idle_ms <= 0:
        return None
    # E_init + n·e_item + (n−1)·p·t_idle/1000 ≤ B
    num = e_budget_mj - e_init - n_target * e_item
    if num < 0:
        return None
    if n_target <= 1:
        return float("inf")
    return num / ((n_target - 1) * t_idle_ms / 1000.0)


def required_budget(
    item: WorkloadItem,
    request_period_ms: float,
    n_items: int,
    idle_power_mw: Optional[float] = None,
    powerup_overhead_mj: float = 0.0,
) -> float:
    """Energy budget (mJ) for n items under Idle-Waiting."""
    return em.idlewait_cumulative_energy_mj(
        item, n_items, request_period_ms, idle_power_mw, powerup_overhead_mj
    )


def best_strategy(
    item: WorkloadItem,
    request_period_ms: float,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    idle_power_mw: Optional[float] = None,
    powerup_overhead_mj: float = 0.0,
) -> str:
    onoff = em.evaluate_onoff(item, request_period_ms, e_budget_mj, powerup_overhead_mj)
    iw = em.evaluate_idlewait(
        item, request_period_ms, e_budget_mj, idle_power_mw, powerup_overhead_mj
    )
    if not onoff.feasible and not iw.feasible:
        return "infeasible"
    if not onoff.feasible:
        return "idle_waiting"
    if not iw.feasible:
        return "on_off"
    return "idle_waiting" if iw.n_max >= onoff.n_max else "on_off"


@dataclasses.dataclass
class Plan:
    strategy: str
    method: Optional[str]
    n_items: int
    lifetime_h: float
    required_idle_power_mw: Optional[float]
    notes: list


def plan(
    item: WorkloadItem,
    request_period_ms: float,
    target_lifetime_h: Optional[float] = None,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = 0.0,
) -> Plan:
    """Pick strategy + idle-power method for a workload/target pair."""
    notes = []
    strategy = best_strategy(
        item, request_period_ms, e_budget_mj,
        powerup_overhead_mj=powerup_overhead_mj,
    )
    if strategy != "idle_waiting":
        r = em.evaluate_onoff(item, request_period_ms, e_budget_mj, powerup_overhead_mj)
        return Plan(strategy, None, r.n_max, r.lifetime_hours, None, notes)

    req_p = None
    method = IdlePowerMethod.BASELINE
    if target_lifetime_h is not None:
        req_p = required_idle_power(
            item, request_period_ms, target_lifetime_h, e_budget_mj,
            powerup_overhead_mj,
        )
        if req_p is None:
            notes.append("target lifetime unreachable at any idle power")
        else:
            for m in (IdlePowerMethod.BASELINE, IdlePowerMethod.METHOD1,
                      IdlePowerMethod.METHOD1_2):
                if IDLE_POWER_MW[m] <= req_p:
                    method = m
                    break
            else:
                method = IdlePowerMethod.METHOD1_2
                notes.append(
                    f"even method1+2 ({IDLE_POWER_MW[method]} mW) exceeds the "
                    f"required {req_p:.1f} mW — target missed"
                )
    r = em.evaluate_idlewait(
        item, request_period_ms, e_budget_mj,
        idle_power_mw=IDLE_POWER_MW[method],
        powerup_overhead_mj=powerup_overhead_mj,
    )
    return Plan("idle_waiting", method.value, r.n_max, r.lifetime_hours, req_p, notes)
