"""Discrete-event duty-cycle simulator (paper §5.1); a copy of
``repro.core.simulator`` for the port.

Replays a strategy event-by-event against an energy budget, accumulating
per-phase energy, and reports the maximum number of executable workload
items plus the estimated system lifetime.  It is the *mechanistic*
counterpart to the closed-form analytical model
(:mod:`repro_torch.core.energy_model`); tests assert both agree exactly.

Two execution modes:

* ``step`` — strict event loop (one event per phase), O(n_items); used for
  validation and for traces.
* ``fast`` — exploits the affine structure of cumulative energy to jump
  whole item-periods at once, O(1) per run; bit-identical n_max (used for
  the paper-scale budgets where n_max is in the millions).

:func:`simulate_trace` generalizes the event loop to **arbitrary arrival
streams** (any non-decreasing list of times) and **timeout policies** (static
On-Off / Idle-Waiting, or the adaptive :class:`~repro_torch.core.adaptive.
PolicyController`): requests arrive at given times, the policy decides how
long to stay resident after each one, and energy is charged per phase until
the budget is exhausted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional, Sequence

from repro_torch.core import energy_model as em
from repro_torch.core.phases import CONFIGURATION, IDLE, WorkloadItem
from repro_torch.core.strategies import IdleWaitingStrategy, OnOffStrategy, Strategy
from repro_torch.core.workload import ExperimentSpec


@dataclasses.dataclass(frozen=True)
class SimEvent:
    """One simulated phase occurrence."""

    time_ms: float          # event start time
    phase: str
    power_mw: float
    duration_ms: float

    @property
    def energy_mj(self) -> float:
        return self.power_mw * self.duration_ms / 1000.0


@dataclasses.dataclass
class SimResult:
    strategy: str
    request_period_ms: float
    n_items: int
    lifetime_ms: float
    energy_used_mj: float
    energy_budget_mj: float
    energy_by_phase_mj: dict

    @property
    def lifetime_hours(self) -> float:
        return self.lifetime_ms / 3_600_000.0

    @property
    def ledger(self):
        """Phase-resolved :class:`repro_torch.obs.ledger.EnergyLedger` view of
        ``energy_by_phase_mj`` (axes sum to ``energy_used_mj`` ≤1e-9 rel)."""
        from repro_torch.obs.ledger import EnergyLedger

        return EnergyLedger.from_phase_dict(self.energy_by_phase_mj)


def _iter_events(
    strategy: Strategy, request_period_ms: float, max_items: int | None = None
) -> Iterator[SimEvent]:
    """Generate the event stream for a strategy (unbounded unless max_items)."""
    item = strategy.item
    is_onoff = isinstance(strategy, OnOffStrategy)
    t = 0.0
    i = 0
    # Idle-Waiting pays the one-time initial configuration (E_init).
    if not is_onoff:
        cfg = item.phase(CONFIGURATION) if item.has_phase(CONFIGURATION) else None
        if cfg is not None:
            yield SimEvent(t, "initial_" + CONFIGURATION, cfg.power_mw, cfg.time_ms)
        if strategy.powerup_overhead_mj:
            yield SimEvent(t, "initial_powerup", strategy.powerup_overhead_mj * 1000.0, 1.0)
    while max_items is None or i < max_items:
        start = t
        if is_onoff:
            if strategy.powerup_overhead_mj:
                # Calibrated power-up ramp; expressed as 1 ms at E mW for bookkeeping.
                yield SimEvent(t, "powerup", strategy.powerup_overhead_mj * 1000.0, 1.0)
            for p in item.phases:
                yield SimEvent(t, p.name, p.power_mw, p.time_ms)
                t += p.time_ms
            # off for the rest of the period: zero power, no event energy
            t = start + request_period_ms
        else:
            for p in item.phases:
                if p.name == CONFIGURATION:
                    continue
                yield SimEvent(t, p.name, p.power_mw, p.time_ms)
                t += p.time_ms
            idle_t = start + request_period_ms - t
            assert isinstance(strategy, IdleWaitingStrategy)
            yield SimEvent(t, IDLE, strategy.idle_power_mw, idle_t)
            t = start + request_period_ms
        i += 1


def simulate(
    spec: ExperimentSpec,
    mode: str = "fast",
    trace: bool = False,
) -> SimResult | tuple[SimResult, list[SimEvent]]:
    """Run the duty-cycle simulation for one experiment spec.

    Counts how many *complete* workload items fit in the budget.  The idle
    phase *between* item i and item i+1 is charged to item i+1's admission:
    i.e. item n is executable iff E_init + n·E_item + (n−1)·E_idle ≤ budget —
    matching Eq. 2/3.
    """
    strategy = spec.build_strategy()
    budget = spec.workload.energy_budget_mj
    t_req = spec.workload.request_period_ms

    # Fail loudly on nonsense inputs rather than silently reporting a wrong
    # zero/garbage lifetime (negative periods previously fell through the
    # infeasibility branch; NaN/inf propagated into the closed forms).
    if not math.isfinite(t_req) or t_req <= 0:
        raise ValueError(
            f"request_period_ms must be positive and finite, got {t_req}"
        )
    if not math.isfinite(budget) or budget < 0:
        raise ValueError(
            f"energy_budget_mj must be non-negative and finite, got {budget}"
        )

    if t_req < strategy.min_request_period_ms():
        res = SimResult(
            strategy=strategy.name,
            request_period_ms=t_req,
            n_items=0,
            lifetime_ms=0.0,
            energy_used_mj=0.0,
            energy_budget_mj=budget,
            energy_by_phase_mj={},
        )
        return (res, []) if trace else res

    if mode == "fast":
        result = _simulate_fast(spec, strategy, budget, t_req)
        return (result, []) if trace else result
    if mode != "step":
        raise ValueError(f"unknown mode {mode!r}")

    # ---- strict event loop ------------------------------------------------
    is_onoff = isinstance(strategy, OnOffStrategy)
    item = strategy.item
    e_item = (
        em.onoff_item_energy_mj(item, strategy.powerup_overhead_mj)
        if is_onoff
        else em.idlewait_item_energy_mj(item)
    )
    e_idle = (
        0.0
        if is_onoff
        else em.idle_energy_mj(item, t_req, strategy.idle_power_mw)  # type: ignore[attr-defined]
    )

    used = 0.0
    by_phase: dict[str, float] = {}
    events: list[SimEvent] = []
    n = 0
    e_init = 0.0
    # Admission control: admit item n+1 only if its item energy plus the
    # preceding idle gap fits the remaining budget.  The cumulative cost is
    # recomputed by multiplication each step (affine form) so the event loop
    # carries no accumulated floating-point drift over millions of items.
    if not is_onoff:
        e_init = em.idlewait_init_energy_mj(item, strategy.powerup_overhead_mj)
        if e_init > budget:
            res = SimResult(strategy.name, t_req, 0, 0.0, 0.0, budget, {})
            return (res, events) if trace else res
        used += e_init
        # the calibrated power-up ramp is reported on its own ledger row,
        # not folded into the configuration phase
        by_phase["initial_configuration"] = em.idlewait_init_energy_mj(item, 0.0)
        if strategy.powerup_overhead_mj:
            by_phase["initial_powerup"] = strategy.powerup_overhead_mj

    gen = _iter_events(strategy, t_req)
    if not is_onoff:
        # skip the initial events already accounted for
        ev = next(gen)
        while ev.phase.startswith("initial_"):
            if trace:
                events.append(ev)
            ev = next(gen)
        pending: SimEvent | None = ev
    else:
        pending = None

    per_period = e_item + e_idle
    # events per admitted item: On-Off = (powerup?) + all phases;
    # Idle-Waiting = execution phases, plus the preceding idle gap for n≥2.
    if is_onoff:
        events_per_item = len(item.phases) + (1 if strategy.powerup_overhead_mj else 0)
    else:
        events_per_item = sum(1 for p in item.phases if p.name != CONFIGURATION) + 1
    while True:
        next_n = n + 1
        # cumulative cost after admitting item next_n (exact affine form,
        # same epsilon convention as the closed-form n_max)
        if is_onoff:
            cum = next_n * e_item
        else:
            cum = e_init + next_n * e_item + (next_n - 1) * e_idle
        if cum > budget + 1e-9 * per_period:
            break
        used = cum
        n = next_n
        # drain this item's events into the per-phase ledger.  The idle event
        # trails each Idle-Waiting period; the (n)th item's admission charges
        # the (n−1)th gap, so for item 1 we drain one fewer event and leave
        # the trailing idle pending.
        count = events_per_item if (is_onoff or n >= 2) else events_per_item - 1
        for _ in range(count):
            ev = pending if pending is not None else next(gen)
            pending = None
            by_phase[ev.phase] = by_phase.get(ev.phase, 0.0) + ev.energy_mj
            if trace:
                events.append(ev)

    res = SimResult(
        strategy=strategy.name,
        request_period_ms=t_req,
        n_items=n,
        lifetime_ms=n * t_req,
        energy_used_mj=used,
        energy_budget_mj=budget,
        energy_by_phase_mj=by_phase,
    )
    return (res, events) if trace else res


def _simulate_fast(
    spec: ExperimentSpec, strategy: Strategy, budget: float, t_req: float
) -> SimResult:
    """O(1) jump using the affine cumulative-energy structure (same n_max)."""
    item = strategy.item
    if isinstance(strategy, OnOffStrategy):
        n = em.onoff_n_max(item, budget, strategy.powerup_overhead_mj)
        used = em.onoff_cumulative_energy_mj(item, n, strategy.powerup_overhead_mj)
        by_phase = {
            p.name: n * p.energy_mj for p in item.phases
        }
        if strategy.powerup_overhead_mj:
            by_phase["powerup"] = n * strategy.powerup_overhead_mj
    else:
        assert isinstance(strategy, IdleWaitingStrategy)
        n = em.idlewait_n_max(
            item, t_req, budget, strategy.idle_power_mw, strategy.powerup_overhead_mj
        )
        used = em.idlewait_cumulative_energy_mj(
            item, n, t_req, strategy.idle_power_mw, strategy.powerup_overhead_mj
        )
        by_phase = {
            p.name: n * p.energy_mj for p in item.phases if p.name != CONFIGURATION
        }
        # n = 0 uses no energy in the closed form (Eq. 2), so the init rows
        # only appear once something was actually admitted — keeps the
        # per-phase dict summing to energy_used_mj (the ledger contract)
        if n >= 1:
            by_phase["initial_configuration"] = em.idlewait_init_energy_mj(item, 0.0)
            if strategy.powerup_overhead_mj:
                by_phase["initial_powerup"] = strategy.powerup_overhead_mj
            by_phase[IDLE] = (n - 1) * em.idle_energy_mj(item, t_req, strategy.idle_power_mw)
    return SimResult(
        strategy=strategy.name,
        request_period_ms=t_req,
        n_items=n,
        lifetime_ms=n * t_req,
        energy_used_mj=used,
        energy_budget_mj=budget,
        energy_by_phase_mj=by_phase,
    )


# ---------------------------------------------------------------------------
# Trace-driven simulation: arbitrary arrivals × timeout policies
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TraceSimResult:
    """Outcome of replaying an arrival trace under a timeout policy."""

    policy: str
    n_items: int
    lifetime_ms: float            # completion time of the last served item
    energy_used_mj: float
    energy_budget_mj: float
    energy_by_phase_mj: dict
    configurations: int           # bring-ups paid (≥1 if anything served)
    releases: int                 # mid-gap releases the policy triggered
    exhausted: bool               # budget ran out before the trace ended

    @property
    def energy_per_item_mj(self) -> float:
        return self.energy_used_mj / self.n_items if self.n_items else math.inf

    @property
    def ledger(self):
        """Phase-resolved :class:`repro_torch.obs.ledger.EnergyLedger` view of
        ``energy_by_phase_mj`` (axes sum to ``energy_used_mj`` ≤1e-9 rel)."""
        from repro_torch.obs.ledger import EnergyLedger

        return EnergyLedger.from_phase_dict(self.energy_by_phase_mj)


def simulate_trace(
    item: WorkloadItem,
    arrival_times_ms: Sequence[float],
    policy,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    powerup_overhead_mj: float = 0.0,
    policy_name: Optional[str] = None,
    recorder=None,
) -> TraceSimResult:
    """Replay ``arrival_times_ms`` against an energy budget.

    ``policy`` implements the timeout-policy protocol
    (:class:`~repro_torch.core.adaptive.StaticPolicy`,
    :class:`~repro_torch.core.adaptive.PolicyController`):

    * ``idle_power_mw``        — accelerator power while idle-resident;
    * ``idle_timeout_ms()``    — queried after each completion: stay
      resident this long, then release (``inf`` = never, ``0`` = at once);
    * ``observe_gap(gap_ms)``  — fed each inter-arrival gap as it is
      observed (the adaptive controller learns from these).

    Semantics (consistent with Eq. 2/3's admission rule):

    * a request arriving while the accelerator is busy queues (service
      starts at the previous completion);
    * serving item *i* is charged its execution phases, the preceding idle
      span the policy chose, and a (re)configuration if the accelerator was
      powered off — the item is admitted only if all of that fits the
      remaining budget;
    * the first item always pays the initial configuration (E_init).

    The per-phase breakdown (``energy_by_phase_mj`` / ``.ledger``) reports
    the calibrated power-up overhead on its own ``powerup`` /
    ``initial_powerup`` rows, separate from the configuration phase.  A
    :class:`repro_torch.obs.trace.TraceRecorder` as ``recorder`` captures
    the state-transition timeline (arrivals, idle spans, timeout releases,
    reconfigurations, service spans), exportable as Chrome-trace JSON.
    """
    # Validate the trace up front: a negative or non-monotonic timestamp
    # would silently corrupt the idle-gap accounting (gaps are differences
    # of consecutive arrivals), producing wrong energy totals.  Timestamps
    # are coerced through float() so numpy/torch scalar elements are accepted.
    arrivals = []
    prev = None
    for i, a in enumerate(arrival_times_ms):
        try:
            if isinstance(a, (str, bytes)):
                raise TypeError
            a = float(a)
        except (TypeError, ValueError):
            raise ValueError(
                f"arrival_times_ms[{i}] = {a!r}: trace timestamps must be "
                "numbers (ms)"
            ) from None
        if not math.isfinite(a) or a < 0:
            raise ValueError(
                f"arrival_times_ms[{i}] = {a!r}: trace timestamps must be "
                "finite, non-negative numbers (ms)"
            )
        if prev is not None and a < prev:
            raise ValueError(
                f"arrival_times_ms[{i}] = {a} is earlier than its "
                f"predecessor {prev}: trace timestamps must be non-decreasing"
            )
        prev = a
        arrivals.append(a)
    name = policy_name or getattr(policy, "kind", type(policy).__name__)
    budget = e_budget_mj
    eps = 1e-9

    exec_phases = [p for p in item.phases if p.name != CONFIGURATION]
    e_exec = item.execution_energy_mj
    t_exec = item.execution_time_ms
    e_cfg_pure = item.config_energy_mj
    e_config = e_cfg_pure + powerup_overhead_mj
    t_config = item.config_time_ms
    p_idle = policy.idle_power_mw

    energy = 0.0
    by_phase: dict[str, float] = {}
    n = 0
    configurations = 0
    releases = 0
    resident = False
    completion = 0.0
    timeout_ms = math.inf
    prev_arrival: Optional[float] = None
    exhausted = False

    def charge(phase: str, mj: float) -> None:
        nonlocal energy
        energy += mj
        by_phase[phase] = by_phase.get(phase, 0.0) + mj

    for a in arrivals:
        start = max(a, completion)
        if recorder is not None:
            recorder.instant("arrival", a, track="requests")
        # ---- the gap the policy managed (previous completion → start) ----
        idle_t = 0.0
        released_here = False
        if n > 0 and resident:
            gap = start - completion
            idle_t = min(gap, timeout_ms)
            released_here = timeout_ms < gap
        idle_e = p_idle * idle_t / 1000.0
        reconfig = not resident or released_here
        cost = idle_e + (e_config if reconfig else 0.0) + e_exec
        if energy + cost > budget + eps * max(1.0, cost):
            exhausted = True
            if recorder is not None:
                recorder.instant("budget_exhausted", a, track="device")
            break
        if idle_e:
            charge(IDLE, idle_e)
            if recorder is not None:
                recorder.complete(IDLE, completion, idle_t, track="device")
        if released_here:
            releases += 1
            resident = False
            if recorder is not None:
                recorder.instant("timeout_release", completion + idle_t,
                                 track="device")
        if reconfig:
            # The initial bring-up is pre-staged at system start (Eq. 2's
            # E_init: energy charged, no time against the first period);
            # re-configurations happen inline and delay service.  The
            # power-up overhead books on its own ledger row.
            initial = configurations == 0
            charge("configuration" if configurations else "initial_configuration",
                   e_cfg_pure)
            if powerup_overhead_mj:
                charge("powerup" if configurations else "initial_powerup",
                       powerup_overhead_mj)
            if recorder is not None:
                if initial:
                    recorder.instant("initial_configuration", start,
                                     track="device")
                else:
                    recorder.complete("configure", start, t_config,
                                      track="device")
            if configurations:
                start += t_config
            configurations += 1
        for p in exec_phases:
            charge(p.name, p.energy_mj)
        if recorder is not None:
            recorder.complete("serve", start, t_exec, track="device",
                              request=n)
        completion = start + t_exec
        resident = True
        n += 1
        # ---- feed the observation, then fix the next gap's timeout -------
        if prev_arrival is not None:
            policy.observe_gap(a - prev_arrival)
        prev_arrival = a
        timeout_ms = policy.idle_timeout_ms()

    return TraceSimResult(
        policy=name,
        n_items=n,
        lifetime_ms=completion if n else 0.0,
        energy_used_mj=energy,
        energy_budget_mj=budget,
        energy_by_phase_mj=by_phase,
        configurations=configurations,
        releases=releases,
        exhausted=exhausted,
    )
