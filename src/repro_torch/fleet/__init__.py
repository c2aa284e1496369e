"""Fleet-scale vectorized simulation: thousands of duty-cycled accelerators,
routed traffic, and per-device power policies advanced tick by tick on one
device, or sharded over a mesh of ranks (port of ``repro.fleet``).

Layers:

* :mod:`repro_torch.fleet.state`   — stacked per-device parameter/state tensors;
* :mod:`repro_torch.fleet.step`    — periodic (oracle-exact) and routed kernels;
* :mod:`repro_torch.fleet.router`  — round-robin / least-loaded / power-aware;
* :mod:`repro_torch.fleet.shard`   — the periodic kernel and the ensemble
  sharded over a ``("fleet", "seed")`` mesh of ranks, bit-identical;
* :mod:`repro_torch.fleet.metrics` — lifetimes, p50/p99 latency, energy/request;
* :mod:`repro_torch.fleet.dtypes`  — the pinned carry dtypes.

Examples
--------
A two-device fleet — one Idle-Waiting, one On-Off, both at the paper's
40 ms period under a small 5 J budget.  Per-device item counts equal the
scalar Eq.-3 closed forms exactly, and their ratio is the abstract's
≈**12.39×** lifetime extension, here at 5 J scale:

>>> from repro_torch.core import energy_model as em
>>> from repro_torch.core.phases import paper_lstm_item
>>> from repro_torch.core.strategies import IdlePowerMethod
>>> from repro_torch.fleet import DeviceSpec, FleetParams, run_periodic
>>> item = paper_lstm_item()
>>> cal = em.CALIBRATED_POWERUP_OVERHEAD_MJ
>>> specs = [DeviceSpec(item=item, strategy=s, method=IdlePowerMethod.METHOD1_2,
...                     request_period_ms=40.0, e_budget_mj=5000.0,
...                     powerup_overhead_mj=cal)
...          for s in ("idle_waiting", "on_off")]
>>> fleet = run_periodic(FleetParams.from_specs(specs, device="cpu"), n_steps=6000)
>>> fleet.n_items.tolist()
[5167, 417]
>>> round(float(fleet.lifetime_ms[0] / fleet.lifetime_ms[1]), 1)
12.4
"""
from repro_torch.fleet.metrics import (
    devices_alive_curve,
    fleet_summary,
    latency_percentiles,
    periodic_summary,
    routed_summary,
)
from repro_torch.fleet.router import ROUTER_CODES, route_counts
from repro_torch.fleet.shard import (
    ShardedPeriodicResult,
    fleet_mesh,
    run_periodic_ensemble_sharded,
    run_periodic_sharded,
)
from repro_torch.fleet.state import (
    STRATEGY_CODES,
    DeviceSpec,
    FleetParams,
    FleetState,
    uniform_fleet,
)
from repro_torch.fleet.step import (
    INT32_STEP_LIMIT,
    PeriodicFleetResult,
    RoutedFleetResult,
    run_periodic,
    run_routed,
)

__all__ = [
    "INT32_STEP_LIMIT",
    "ROUTER_CODES",
    "STRATEGY_CODES",
    "DeviceSpec",
    "FleetParams",
    "FleetState",
    "PeriodicFleetResult",
    "RoutedFleetResult",
    "ShardedPeriodicResult",
    "devices_alive_curve",
    "fleet_mesh",
    "fleet_summary",
    "latency_percentiles",
    "periodic_summary",
    "routed_summary",
    "route_counts",
    "run_periodic",
    "run_periodic_ensemble_sharded",
    "run_periodic_sharded",
    "run_routed",
    "uniform_fleet",
]
