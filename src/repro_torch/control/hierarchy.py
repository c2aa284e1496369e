"""Topology of the hierarchical serving control plane (port of
``repro.control.hierarchy``).

A :class:`TopologySpec` is a tree — global → regions → racks — whose leaves
are ordinary routed fleets (:class:`repro_torch.fleet.state.FleetParams`).
The key modeling move is the paper's own: a rack is just a "device" one
level up, whose *configuration phase* is the rack bring-up (``bringup_mj`` /
``bringup_ms``: switch fabric, host boot, weight staging) and whose *idle
power* is the sum of its children's idle draws.  The idle-vs-off decision
rule is scale-free, so the same crossover arithmetic that governs a single
FPGA governs a rack (:mod:`repro_torch.control.autoscaler`).

Every spec is frozen and purely declarative; the simulator
(:mod:`repro_torch.control.simulate`) owns all mutable state.  A rack's
fleet lives on one torch device (:func:`uniform_topology` puts it on the
card unless given ``device="cpu"``); the rack-level sums are taken in numpy
on the host, in the reference's order.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.phases import WorkloadItem
from repro_torch.fleet.router import ROUTER_CODES
from repro_torch.fleet.state import FleetParams, uniform_fleet
from repro_torch.fleet.step import _np

__all__ = [
    "RackSpec",
    "RegionSpec",
    "TopologySpec",
    "concat_params",
    "uniform_topology",
]


@dataclasses.dataclass(frozen=True)
class RackSpec:
    """One rack: a routed fleet plus its level-up 'device' constants.

    ``bringup_mj``/``bringup_ms`` are the rack-level configuration phase a
    power-on (or an elastic restart after a crash) charges — *on top of* the
    per-device reconfigurations the devices themselves pay on their next
    serve (powering a rack off marks every device non-resident, exactly the
    On-Off strategy applied at rack granularity).  ``model_axis`` is the
    tensor-parallel axis width :func:`repro_torch.distributed.fault_tolerance.
    plan_elastic_mesh` must keep intact when a crash loses devices.
    """

    name: str
    params: FleetParams
    router: str = "round_robin"
    queue_capacity: int = 16
    bringup_ms: float = 0.0
    bringup_mj: float = 0.0
    model_axis: int = 1

    def __post_init__(self):
        if self.router not in ROUTER_CODES:
            raise ValueError(f"unknown router {self.router!r} for rack {self.name!r}")
        if self.queue_capacity < 1:
            raise ValueError(f"queue_capacity must be >= 1, got {self.queue_capacity}")
        if self.bringup_ms < 0 or self.bringup_mj < 0:
            raise ValueError(f"rack {self.name!r}: bring-up cost must be non-negative")
        if self.model_axis < 1 or self.params.n_devices % self.model_axis:
            raise ValueError(
                f"rack {self.name!r}: model_axis {self.model_axis} must divide "
                f"the device count {self.params.n_devices}"
            )

    @property
    def n_devices(self) -> int:
        return self.params.n_devices

    def idle_power_mw(self) -> float:
        """Aggregated child idle power — the rack's P_idle one level up."""
        return float(np.sum(_np(self.params.p_idle_mw)))


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    name: str
    racks: tuple[RackSpec, ...]

    def __post_init__(self):
        if not self.racks:
            raise ValueError(f"region {self.name!r} needs at least one rack")
        names = [r.name for r in self.racks]
        if len(set(names)) != len(names):
            raise ValueError(f"region {self.name!r}: duplicate rack names {names}")

    @property
    def n_devices(self) -> int:
        return sum(r.n_devices for r in self.racks)


@dataclasses.dataclass(frozen=True)
class TopologySpec:
    regions: tuple[RegionSpec, ...]

    def __post_init__(self):
        if not self.regions:
            raise ValueError("topology needs at least one region")
        names = [r.name for r in self.regions]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate region names {names}")
        rack_names = [k.name for r in self.regions for k in r.racks]
        if len(set(rack_names)) != len(rack_names):
            raise ValueError(f"rack names must be globally unique, got {rack_names}")

    @property
    def n_devices(self) -> int:
        return sum(r.n_devices for r in self.regions)

    @property
    def n_racks(self) -> int:
        return sum(len(r.racks) for r in self.regions)

    def racks(self) -> list[RackSpec]:
        return [k for r in self.regions for k in r.racks]

    def rack(self, name: str) -> RackSpec:
        for r in self.regions:
            for k in r.racks:
                if k.name == name:
                    return k
        raise KeyError(name)

    def region_of(self, rack_name: str) -> RegionSpec:
        for r in self.regions:
            if any(k.name == rack_name for k in r.racks):
                return r
        raise KeyError(rack_name)


def concat_params(params: Sequence[FleetParams]) -> FleetParams:
    """Stack several fleets into one flat fleet (column-wise concatenation)
    — the flat per-device reference the hierarchical ledger roll-up must
    equal (:mod:`repro_torch.control.report`): ``torch.cat`` of each
    ``(N,)`` column."""
    if not params:
        raise ValueError("concat_params needs at least one fleet")
    return FleetParams(**{
        f.name: torch.cat([getattr(p, f.name) for p in params])
        for f in dataclasses.fields(FleetParams)
    })


def uniform_topology(
    n_regions: int,
    racks_per_region: int,
    devices_per_rack: int,
    item: Optional[WorkloadItem] = None,
    strategies: Sequence[str] = ("adaptive",),
    request_period_ms: float = 40.0,
    e_budget_mj: Optional[float] = None,
    powerup_overhead_mj: float = 0.0,
    router: str = "round_robin",
    queue_capacity: int = 16,
    bringup_ms: float = 0.0,
    bringup_mj: float = 0.0,
    model_axis: int = 1,
    device="cuda",
) -> TopologySpec:
    """A homogeneous ``n_regions × racks_per_region × devices_per_rack``
    topology over :func:`repro_torch.fleet.state.uniform_fleet` racks, each
    on ``device`` (the card by default)."""
    kwargs = dict(
        item=item,
        strategies=tuple(strategies),
        request_period_ms=request_period_ms,
        powerup_overhead_mj=powerup_overhead_mj,
        device=device,
    )
    if e_budget_mj is not None:
        kwargs["e_budget_mj"] = e_budget_mj
    regions = []
    for i in range(n_regions):
        racks = tuple(
            RackSpec(
                name=f"r{i}k{j}",
                params=uniform_fleet(devices_per_rack, **kwargs),
                router=router,
                queue_capacity=queue_capacity,
                bringup_ms=bringup_ms,
                bringup_mj=bringup_mj,
                model_axis=model_axis,
            )
            for j in range(racks_per_region)
        )
        regions.append(RegionSpec(name=f"r{i}", racks=racks))
    return TopologySpec(regions=tuple(regions))
