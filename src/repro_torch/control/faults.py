"""Failure injection for the hierarchical control plane (port of
``repro.control.faults``; host Python, the schedule drawn with numpy's
``default_rng`` as in the reference, so the two draw the same faults).

Wires the coordinator-side primitives of
:mod:`repro_torch.distributed.fault_tolerance` into the simulated hierarchy:

* a rack **crash** stops its heartbeats and drops its queued requests
  (counted — request conservation holds at every level);
* the :class:`~repro_torch.distributed.fault_tolerance.HeartbeatMonitor`, run on
  the *simulated* clock, detects the silence after its timeout;
* recovery goes through
  :func:`~repro_torch.distributed.fault_tolerance.plan_elastic_mesh`: devices
  lost for good shrink the rack to the largest (data × model)-factorable
  survivor mesh, surplus survivors are parked, and the elastic restart is
  charged as a rack **reconfiguration** (the bring-up energy again — the
  paper's configuration phase, at rack scale).

The schedule is declarative (:class:`FaultSchedule`), so property-based
tests can drive arbitrary crash/loss patterns through the real detection
machinery and assert the conservation contracts.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.control.hierarchy import TopologySpec
from repro_torch.distributed.fault_tolerance import HeartbeatMonitor, plan_elastic_mesh

__all__ = [
    "FaultInjector",
    "FaultSchedule",
    "RackFault",
    "SimClock",
    "random_schedule",
]


@dataclasses.dataclass(frozen=True)
class RackFault:
    """Rack ``rack`` crashes at global tick ``crash_tick``; ``lost_devices``
    of its devices never come back (the rest restore from checkpoint when
    the watchdog-triggered elastic restart completes)."""

    rack: str
    crash_tick: int
    lost_devices: int = 0

    def __post_init__(self):
        if self.crash_tick < 0:
            raise ValueError(f"crash_tick must be non-negative, got {self.crash_tick}")
        if self.lost_devices < 0:
            raise ValueError(f"lost_devices must be non-negative, got {self.lost_devices}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    faults: tuple[RackFault, ...] = ()

    def __iter__(self):
        return iter(self.faults)

    def for_span(self, lo_tick: int, hi_tick: int) -> list[RackFault]:
        """Faults firing in ``[lo_tick, hi_tick)`` — applied at the epoch
        boundary that opens the span."""
        return [f for f in self.faults if lo_tick <= f.crash_tick < hi_tick]


def random_schedule(
    topology: TopologySpec,
    n_ticks: int,
    n_faults: int,
    seed: int = 0,
    max_lost_frac: float = 0.5,
) -> FaultSchedule:
    """A seeded random crash schedule over the topology's racks — the CLI's
    fault source (tests drive :class:`FaultSchedule` directly)."""
    rng = np.random.default_rng(seed)
    racks = topology.racks()
    faults = []
    for _ in range(n_faults):
        spec = racks[int(rng.integers(len(racks)))]
        lost_cap = int(spec.n_devices * max_lost_frac)
        faults.append(
            RackFault(
                rack=spec.name,
                crash_tick=int(rng.integers(n_ticks)),
                lost_devices=int(rng.integers(lost_cap + 1)),
            )
        )
    return FaultSchedule(tuple(faults))


class SimClock:
    """Monotonic simulated-time source (seconds) for the heartbeat monitor
    and watchdogs — advanced by the simulator, never by wall time."""

    def __init__(self, t_s: float = 0.0):
        self.t_s = t_s

    def __call__(self) -> float:
        return self.t_s

    def advance(self, dt_s: float) -> None:
        if dt_s < 0:
            raise ValueError(f"cannot advance the clock backwards ({dt_s})")
        self.t_s += dt_s


class FaultInjector:
    """Per-run fault state machine over the real detection primitives.

    The simulator calls, per epoch: :meth:`crashes_for` to apply scheduled
    crashes, :meth:`beat_healthy` for the racks still serving, then
    :meth:`detected` — racks whose silence has outlived the heartbeat
    timeout on the simulated clock, i.e. the set the control plane may now
    restart.  :meth:`plan_recovery` sizes the survivor mesh.
    """

    def __init__(
        self,
        topology: TopologySpec,
        schedule: FaultSchedule,
        clock: SimClock,
        heartbeat_timeout_s: float = 1.0,
    ):
        self.topology = topology
        self.schedule = schedule
        self.clock = clock
        self.monitor = HeartbeatMonitor(
            [r.name for r in topology.racks()],
            timeout_s=heartbeat_timeout_s,
            clock=clock,
        )
        self.n_crashes = 0
        self.n_detected = 0

    def crashes_for(self, lo_tick: int, hi_tick: int) -> list[RackFault]:
        faults = self.schedule.for_span(lo_tick, hi_tick)
        self.n_crashes += len(faults)
        return faults

    def beat_healthy(self, healthy: Sequence[str]) -> None:
        for name in healthy:
            self.monitor.beat(name)

    def detected(self, crashed: Sequence[str]) -> list[str]:
        """The crashed racks whose heartbeat silence the monitor has now
        noticed (crash → detection latency = the heartbeat timeout)."""
        dead = set(self.monitor.dead_nodes())
        found = [name for name in crashed if name in dead]
        self.n_detected += len(found)
        return found

    def plan_recovery(self, rack_name: str, survivors: int) -> Optional[int]:
        """Usable device count after the elastic restart, or ``None`` if the
        survivors cannot host even one data replica of the model axis
        (the rack is then lost for good)."""
        spec = self.topology.rack(rack_name)
        plan = plan_elastic_mesh(survivors, spec.model_axis)
        return None if plan is None else plan.devices
