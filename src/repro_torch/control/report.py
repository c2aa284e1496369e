"""Roll-up reporting for hierarchy runs: per-level ledgers, SLO metrics,
and the energy/SLO Pareto frontier (port of ``repro.control.report``).

The report is the JSON section ``launch/control.py`` embeds in its
payload; :func:`verify_hierarchy` is the refuse-to-emit
gate — it re-checks every conservation contract (requests and energy, at
rack, region, and global level) before anything is written.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.control.simulate import HierarchyResult
from repro_torch.core.pareto import pareto_mask

__all__ = [
    "hierarchy_report",
    "pareto_section",
    "slo_metrics",
    "verify_hierarchy",
]


def slo_metrics(result: HierarchyResult) -> dict:
    """Serving-quality metrics: served fraction (of everything that
    arrived) and queueing-latency percentiles over served requests."""
    arrived = result.arrived
    served = result.served
    lat = result.latency_ms
    out = {
        "arrived": arrived,
        "served": served,
        "dropped": result.dropped,
        "in_flight": result.in_flight,
        "served_fraction": served / arrived if arrived else 1.0,
    }
    if lat is not None and lat.size:
        out["latency_p50_ms"] = float(np.percentile(lat, 50))
        out["latency_p99_ms"] = float(np.percentile(lat, 99))
        out["latency_max_ms"] = float(np.max(lat))
    else:
        out["latency_p50_ms"] = out["latency_p99_ms"] = out["latency_max_ms"] = None
    return out


def verify_hierarchy(result: HierarchyResult, rtol: float = 1e-9) -> dict:
    """Assert every per-level conservation contract and return the measured
    residuals (the CLI embeds them so the artifact is self-describing)."""
    c = result.assert_conserves(rtol=rtol)
    return {
        "request_residual_rack_max": int(
            max((abs(v) for v in c["rack_requests"].values()), default=0)
        ),
        "request_residual_region_max": int(
            max((abs(v) for v in c["region_requests"].values()), default=0)
        ),
        "request_residual_global": int(c["global_requests"]),
        "energy_error_rack_max": float(max(c["rack_energy"].values(), default=0.0)),
        "energy_error_total": float(c["total_energy"]),
        "rtol": rtol,
    }


def hierarchy_report(result: HierarchyResult) -> dict:
    """Full per-level roll-up: rack → region → global counters, ledgers,
    power events, and SLO metrics."""
    rack_rows = {}
    for name, r in result.racks.items():
        rack_rows[name] = {
            "region": r.region,
            "devices": r.spec.n_devices,
            "usable_devices": r.usable_devices,
            "lost_devices": r.lost_devices,
            "arrived": r.arrived,
            "served": r.served,
            "dropped": r.dropped,
            "in_flight": r.in_flight,
            "powered": bool(r.powered),
            "crashed": bool(r.crashed),
            "unrecoverable": bool(r.unrecoverable),
            "n_power_ons": r.n_power_ons,
            "n_power_offs": r.n_power_offs,
            "n_restarts": r.n_restarts,
            "bringup_energy_mj": r.bringup_energy_mj,
            "idle_tail_mj": r.idle_tail_mj,
            "energy_mj": r.total_energy_mj,
            "ledger": r.ledger().to_dict(),
        }
    region_rows = {}
    for region in result.topology.regions:
        members = result.region_racks(region.name)
        region_rows[region.name] = {
            "racks": [r.spec.name for r in members],
            "arrived": result.region_arrived[region.name],
            "routed": sum(r.arrived for r in members),
            "dropped_at_region": result.region_dropped[region.name],
            "served": sum(r.served for r in members),
            "energy_mj": sum(r.total_energy_mj for r in members),
            "ledger": result.region_ledger(region.name).to_dict(),
        }
    return {
        "levels": {
            "rack": rack_rows,
            "region": region_rows,
            "global": {
                "arrived": result.arrived,
                "dropped_at_global": result.global_dropped,
                "energy_mj": result.total_energy_mj,
                "ledger": result.total_ledger().to_dict(),
            },
        },
        "slo": slo_metrics(result),
        "power_events": {
            "power_ons": sum(r.n_power_ons for r in result.racks.values()),
            "power_offs": sum(r.n_power_offs for r in result.racks.values()),
            "restarts": sum(r.n_restarts for r in result.racks.values()),
            "crashes": (
                result.injector.n_crashes if result.injector is not None else 0
            ),
        },
    }


def pareto_section(
    points: Sequence[dict],
    energy_key: str = "energy_mj",
    slo_keys: tuple[str, ...] = ("latency_p99_ms", "drop_fraction"),
) -> dict:
    """The energy/SLO trade-off over a sweep of control configurations.

    Each point is a dict with an energy cost and SLO costs (all minimized;
    missing/None latency is treated as +inf so a config that served nothing
    cannot dominate).  Returns the points annotated with ``pareto`` flags
    plus the index list of the frontier, via
    :func:`repro_torch.core.pareto.pareto_mask`.  The handful of sweep
    points are host numbers, so their mask is taken on the CPU.
    """
    if not points:
        return {"points": [], "frontier": []}
    cols = (energy_key,) + tuple(slo_keys)
    costs = np.array(
        [
            [
                np.inf if p.get(k) is None else float(p[k])
                for k in cols
            ]
            for p in points
        ],
        dtype=np.float64,
    )
    # pareto_mask minimizes every column; replace inf with a huge finite
    # sentinel so the comparisons stay NaN/inf-free
    finite_max = np.nanmax(np.where(np.isfinite(costs), costs, np.nan))
    if not np.isfinite(finite_max):
        finite_max = 0.0
    costs = np.where(np.isfinite(costs), costs, finite_max * 2 + 1e9)
    mask = pareto_mask(costs, device="cpu").numpy()
    annotated = []
    for i, p in enumerate(points):
        q = dict(p)
        q["pareto"] = bool(mask[i])
        annotated.append(q)
    return {
        "objectives": list(cols),
        "points": annotated,
        "frontier": [int(i) for i in np.flatnonzero(mask)],
    }
