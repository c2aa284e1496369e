"""Duty-cycle batch scheduler: request streams → strategy-managed engine
(port of ``repro.serving.scheduler``; ``run_process_schedule`` comes with
``core/arrivals`` in a later slice).

Drives a :class:`~repro_torch.core.duty_cycle.DutyCycleController` with a request
stream and reports the strategy comparison — the runnable counterpart of
Experiment 2.  Two entry points:

* :func:`run_schedule` — the paper's duty-cycle mode: constant-period
  requests;
* :func:`run_arrival_schedule` — arbitrary arrival times, the runnable
  counterpart of the reference's ``simulate_trace``.

Both sleep out idle gaps like the MCU timer in the paper's system model,
waking early at the policy's release time so a live engine actually powers
down mid-gap (ski-rental / adaptive release).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Iterable, Optional

from repro_torch.core.duty_cycle import DutyCycleController


@dataclasses.dataclass
class ScheduleResult:
    strategy: str
    n_requests: int
    n_configurations: int
    energy_mj: float
    wall_s: float
    energy_by_phase_mj: dict
    crossover_ms: Optional[float]
    policy: Optional[dict] = None     # adaptive-regime summary, if any


def run_arrival_schedule(
    controller: DutyCycleController,
    requests: Iterable[Any],
    arrival_offsets_s: Iterable[float],
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.perf_counter,
) -> ScheduleResult:
    """Submit request *i* at ``t_start + arrival_offsets_s[i]`` (sleeping out
    the gaps, waking at the policy's release instant so a resident engine
    can power down mid-gap).  Both inputs are consumed lazily, so streaming
    request generators work; the schedule ends when either runs out."""
    t_start = clock()
    n = 0
    for x, offset in zip(requests, arrival_offsets_s):
        target = t_start + offset
        # sleep out the gap, waking at the policy's timeout so a live
        # engine actually releases mid-gap (ski-rental/adaptive release)
        while True:
            now = clock()
            if now >= target:
                break
            t_rel = controller.next_release_time()
            wake = min(target, t_rel) if (t_rel is not None and t_rel > now) else target
            sleep(wake - now)
            controller.maybe_release(clock())
        controller.submit(x)
        n += 1
    wall = clock() - t_start
    s = controller.summary()
    return ScheduleResult(
        strategy=s["strategy"],
        n_requests=n,
        n_configurations=s["configurations"],
        energy_mj=s["energy_mj"],
        wall_s=wall,
        energy_by_phase_mj=s["energy_by_phase_mj"],
        crossover_ms=s["crossover_ms"],
        policy=s.get("policy"),
    )


def run_schedule(
    controller: DutyCycleController,
    requests: Iterable[Any],
    period_s: float,
    sleep: Callable[[float], None] = time.sleep,
    clock: Callable[[], float] = time.perf_counter,
) -> ScheduleResult:
    """Constant-period requests (the paper's duty-cycle mode)."""
    offsets = (i * period_s for i in itertools.count())
    return run_arrival_schedule(controller, requests, offsets, sleep, clock)


def compare_live_strategies(
    make_controller: Callable[[str], DutyCycleController],
    requests_factory: Callable[[], Iterable[Any]],
    period_s: float,
) -> dict:
    """Run on_off vs idle_waiting back-to-back on the live engine and
    report the measured energy ratio (Fig. 8's runnable analogue)."""
    out = {}
    for strategy in ("on_off", "idle_waiting"):
        ctl = make_controller(strategy)
        out[strategy] = run_schedule(ctl, requests_factory(), period_s)
    oo, iw = out["on_off"], out["idle_waiting"]
    out["energy_ratio_onoff_over_iw"] = (
        oo.energy_mj / iw.energy_mj if iw.energy_mj else float("inf")
    )
    return out
