"""Fault tolerance: step watchdog, straggler detection, elastic restart
(port of ``repro.distributed.fault_tolerance``, pure Python as there).

On a 1000+-node fleet the failure model is: (a) hard node loss — detected
by missed heartbeats, handled by checkpoint-restart on a (possibly
resized) mesh; (b) stragglers — nodes that slow collectives fleet-wide,
detected by step-time outliers and handled by deadline re-dispatch /
eviction.  This module is the coordinator-side logic, runnable anywhere
(it reasons over timings, not devices); the restart path composes
CheckpointManager.restore and a copy of the restored tensors onto the
survivor mesh.
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


@dataclasses.dataclass
class Heartbeat:
    node: str
    last_seen: float


class HeartbeatMonitor:
    """Declare a node dead after ``timeout_s`` without a heartbeat."""

    def __init__(self, nodes: list[str], timeout_s: float = 30.0, clock=time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self._beats = {n: Heartbeat(n, now) for n in nodes}

    def beat(self, node: str) -> None:
        self._beats[node].last_seen = self._clock()

    def dead_nodes(self) -> list[str]:
        now = self._clock()
        return [n for n, b in self._beats.items() if now - b.last_seen > self.timeout_s]

    def alive_nodes(self) -> list[str]:
        dead = set(self.dead_nodes())
        return [n for n in self._beats if n not in dead]


class StragglerDetector:
    """Flag per-node step durations > ``k`` × fleet median over a window."""

    def __init__(self, window: int = 16, k: float = 2.0):
        self.window = window
        self.k = k
        self._durations: dict[str, list[float]] = {}

    def record(self, node: str, duration_s: float) -> None:
        d = self._durations.setdefault(node, [])
        d.append(duration_s)
        if len(d) > self.window:
            d.pop(0)

    def medians(self) -> dict[str, float]:
        return {
            n: statistics.median(d) for n, d in self._durations.items() if d
        }

    def stragglers(self) -> list[str]:
        meds = self.medians()
        if len(meds) < 2:
            return []
        fleet = statistics.median(meds.values())
        return [n for n, m in meds.items() if m > self.k * fleet]


@dataclasses.dataclass
class ElasticPlan:
    """Re-mesh decision after failures: largest (data, model)-factorable
    device count ≤ survivors, keeping the model axis intact (TP re-layouts
    are expensive; DP shrink is free with our mesh-agnostic checkpoints)."""

    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model


def plan_elastic_mesh(
    survivors: int, model_axis: int, min_data: int = 1
) -> Optional[ElasticPlan]:
    data = survivors // model_axis
    if data < min_data:
        return None
    return ElasticPlan(data=data, model=model_axis)


class StepWatchdog:
    """Deadline supervisor for a training step: retries (re-dispatch) on
    timeout, then escalates to the elastic-restart callback."""

    def __init__(
        self,
        deadline_s: float,
        max_retries: int = 1,
        on_failure: Optional[Callable[[], None]] = None,
        clock=time.monotonic,
    ):
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.on_failure = on_failure
        self._clock = clock
        self.timeouts = 0

    def run(self, step_fn: Callable[[], object]) -> object:
        for attempt in range(self.max_retries + 1):
            t0 = self._clock()
            result = step_fn()
            if self._clock() - t0 <= self.deadline_s:
                return result
            self.timeouts += 1
        if self.on_failure is not None:
            self.on_failure()
        return result
