"""Fleet-level metrics: lifetimes, latency percentiles, energy-per-request
(port of ``repro.fleet.metrics``).

Consumes :class:`~repro_torch.fleet.step.PeriodicFleetResult` /
:class:`~repro_torch.fleet.step.RoutedFleetResult` and reduces the stacked
per-device tensors (copied to the host once) into the questions the fleet
simulator exists to answer: how many devices survive the budget, where the
latency tail sits under a given router, and what each served request costs
in energy.

All functions return plain Python/NumPy values (JSON-friendly dicts), so
:mod:`repro_torch.launch.fleet` can emit them directly.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from repro_torch.fleet.step import PeriodicFleetResult, RoutedFleetResult, _np

__all__ = [
    "latency_percentiles",
    "devices_alive_curve",
    "periodic_summary",
    "routed_summary",
    "fleet_summary",
]


def _stats(a: np.ndarray) -> dict:
    if a.size == 0:
        return {"min": None, "median": None, "mean": None, "max": None}
    return {
        "min": float(np.min(a)),
        "median": float(np.median(a)),
        "mean": float(np.mean(a)),
        "max": float(np.max(a)),
    }


def _mode_counts(result: RoutedFleetResult) -> dict:
    from repro_torch.fleet.state import MODE_BUSY, MODE_DEAD, MODE_IDLE, MODE_OFF

    modes = result.final_modes()
    return {
        name: int(np.sum(modes == code))
        for name, code in (
            ("off", MODE_OFF), ("idle", MODE_IDLE),
            ("busy", MODE_BUSY), ("dead", MODE_DEAD),
        )
    }


def latency_percentiles(
    result: RoutedFleetResult, qs: tuple[float, ...] = (50.0, 99.0)
) -> Optional[dict]:
    """p50/p99 (ms) over every served request's arrival→completion latency.

    Exact per-request values from the FIFO timestamp buffer (arrival times
    quantized to the tick the request entered the system).  None if the run
    was launched with ``collect_latency=False``.
    """
    if result.latency_ms is None or result.served_mask is None:
        return None
    samples = _np(result.latency_ms)[_np(result.served_mask)]
    if samples.size == 0:
        return {f"p{q:g}": None for q in qs} | {"n_samples": 0}
    out = {f"p{q:g}": float(np.percentile(samples, q)) for q in qs}
    out["n_samples"] = int(samples.size)
    return out


def devices_alive_curve(
    alive_over_time: np.ndarray, dt_ms: float, max_points: int = 128
) -> dict:
    """Downsampled devices-alive-over-time curve (≤ ``max_points`` samples)."""
    alive_over_time = _np(alive_over_time)
    k = len(alive_over_time)
    if k == 0:
        return {"t_ms": [], "alive": []}
    stride = max(1, -(-k // max_points))
    idx = np.arange(0, k, stride)
    return {
        "t_ms": (idx.astype(np.float64) * dt_ms).tolist(),
        "alive": alive_over_time[idx].astype(int).tolist(),
    }


def _alive_over_steps(alive_over_time: np.ndarray, max_points: int = 128) -> dict:
    """Periodic-mode alive curve indexed by scan *step* (request number):
    device d's wall time at step k is ``k · period_ms[d]``."""
    curve = devices_alive_curve(alive_over_time, dt_ms=1.0, max_points=max_points)
    return {"step": [int(x) for x in curve["t_ms"]], "alive": curve["alive"]}


def _energy_per_request(energy: np.ndarray, served: np.ndarray) -> dict:
    total_e = float(np.sum(energy))
    total_n = int(np.sum(served))
    per = energy[served > 0] / served[served > 0]
    return {
        "total_energy_mj": total_e,
        "total_requests": total_n,
        "energy_per_request_mj": (total_e / total_n) if total_n else None,
        "per_device_energy_per_request_mj": _stats(per),
    }


def periodic_summary(result: PeriodicFleetResult) -> dict:
    """JSON-friendly reduction of a periodic-mode run."""
    p = result.params
    n = _np(result.n_items)
    alive = _np(result.alive)
    energy = _np(result.energy_mj)
    budget = _np(p.e_budget_mj)
    feasible = _np(p.feasible)
    return {
        "mode": "periodic",
        "n_devices": p.n_devices,
        "n_steps": result.n_steps,
        "devices_alive_at_end": int(np.sum(alive)),
        # an infeasible device (period below the strategy's latency) never
        # admits anything — that is not budget exhaustion
        "devices_exhausted": int(np.sum(~alive & feasible)),
        "devices_infeasible": int(np.sum(~feasible)),
        "items": {
            "total": int(np.sum(n)),
            "per_device": _stats(n.astype(np.float64)),
        },
        "lifetime_hours": _stats(_np(result.lifetime_ms) / 3.6e6),
        "budget_utilization": _stats(
            np.divide(energy, budget, out=np.zeros_like(energy), where=budget > 0)
        ),
        **_energy_per_request(energy, n),
        # phase-resolved energy breakdown (sums back to total_energy_mj)
        "ledger": result.ledger().aggregate().to_dict(),
        # steps, not wall time: in periodic mode step k happens at
        # k × the *device's own* period, so a heterogeneous-period fleet
        # has no single time axis
        "devices_alive_over_steps": _alive_over_steps(result.alive_over_time),
    }


def routed_summary(result: RoutedFleetResult) -> dict:
    """JSON-friendly reduction of a routed-mode run."""
    p = result.params
    s = result.state
    served = _np(s.n_served)
    energy = _np(s.energy_mj)
    completion = _np(s.completion_ms)
    return {
        "mode": "routed",
        "router": result.router or "direct",
        "n_devices": p.n_devices,
        "n_steps": result.n_steps,
        "dt_ms": result.dt_ms,
        "horizon_ms": result.dt_ms * result.n_steps,
        "devices_alive_at_end": int(np.sum(_np(s.alive))),
        "requests": {
            "served": int(np.sum(served)),
            "dropped": int(np.sum(_np(s.n_dropped))),
            "still_queued": int(np.sum(_np(s.q_len))),
            "per_device_served": _stats(served.astype(np.float64)),
        },
        "configurations": int(np.sum(_np(s.n_configs))),
        "releases": int(np.sum(_np(s.n_released))),
        "final_modes": _mode_counts(result),
        "lifetime_ms": _stats(completion[served > 0]) if served.any() else _stats(np.array([])),
        **_energy_per_request(energy, served),
        "ledger": result.ledger().aggregate().to_dict(),
        "latency_ms": latency_percentiles(result),
        "devices_alive_over_time": devices_alive_curve(
            result.alive_over_time, result.dt_ms
        ),
    }


def fleet_summary(result: Union[PeriodicFleetResult, RoutedFleetResult]) -> dict:
    if isinstance(result, PeriodicFleetResult):
        return periodic_summary(result)
    if isinstance(result, RoutedFleetResult):
        return routed_summary(result)
    raise TypeError(f"unknown fleet result type {type(result).__name__}")
