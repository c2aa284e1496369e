"""The hierarchical serving simulator: global → regions → racks → devices
(port of ``repro.control.simulate``).

Time advances in ``dt_ms`` ticks, partitioned into control **epochs** of
``epoch_ticks``.  Each epoch the control plane runs, in order:

1. **Faults** scheduled into the epoch fire: the rack crashes, its queued
   requests are dropped (counted — conservation holds), its devices lose
   residency, and any permanently lost devices are removed.
2. **Detection/restart**: crashed racks whose heartbeat silence has
   outlived the monitor timeout (on the *simulated* clock) restart on the
   elastic survivor mesh (:func:`repro_torch.distributed.
   fault_tolerance.plan_elastic_mesh`); the restart is charged as a rack reconfiguration
   (``bringup_mj``) and the rack serves again once ``bringup_ms`` elapses.
3. **Autoscaling**: per region, racks whose queues are empty and whose
   idle time exceeds their autoscaler's timeout power off (devices lose
   residency — On-Off at rack scale); off racks power back on, paying the
   bring-up, while the serving capacity trails the previous epoch's demand
   plus backlog.  At least ``keep_min`` racks per region stay powered.
4. **Routing**: the global stream splits across regions, and each region's
   share across its serving racks, by exact integer proportional splitting
   (weights = usable device counts; remainders round-robin on a carried
   pointer, so totals are conserved tick-by-tick and a 1-target split is
   the identity).
5. **Serving**: every serving rack advances one
   :func:`repro_torch.fleet.step.run_routed` chunk, carrying its
   :class:`~repro_torch.fleet.state.FleetState` across epochs — by the chunked
   continuation contract this is *bit-identical* to one uninterrupted
   routed run, which is the hierarchy's differential spine: a
   1-region/1-rack topology with no autoscaler and no faults collapses
   onto ``run_routed`` exactly.

The fleet starts warm (all racks powered, no initial bring-up charge):
each device's first serve pays its initial configuration, exactly as the
flat routed kernel charges it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.control.faults import FaultInjector, FaultSchedule, SimClock
from repro_torch.control.hierarchy import RackSpec, TopologySpec
from repro_torch.fleet.state import FleetParams, FleetState
from repro_torch.fleet.step import PeriodicFleetResult, _np, routed_ledger, run_periodic, run_routed
from repro_torch.obs.ledger import EnergyLedger

__all__ = [
    "HierarchyResult",
    "RackResult",
    "pack_split",
    "proportional_split",
    "run_hierarchy",
    "run_rack_periodic",
]


def proportional_split(counts, weights, ptr: int = 0):
    """Split per-tick integer ``counts (T,)`` across ``J`` targets in
    proportion to non-negative integer ``weights (J,)``, exactly.

    Each tick assigns ``⌊c·w_j/Σw⌋`` to target *j*; the remainder (< the
    number of positive-weight targets) goes one-each to positive-weight
    targets in cyclic order starting at the carried pointer ``ptr``, so the
    split conserves every tick's count and stays fair across ticks.
    Returns ``(assigned (T, J) int64, dropped (T,) int64, new_ptr)`` —
    ``dropped`` is the whole count when all weights are zero (no target can
    take traffic).  With a single positive-weight target the split is the
    identity, which is what the hierarchy's collapse contract rides on.
    """
    counts = np.asarray(counts, dtype=np.int64)
    w = np.asarray(weights, dtype=np.int64)
    if counts.ndim != 1 or w.ndim != 1:
        raise ValueError(
            f"counts must be (T,), weights (J,); got {counts.shape}, {w.shape}"
        )
    if np.any(counts < 0) or np.any(w < 0):
        raise ValueError("counts and weights must be non-negative")
    T, J = counts.shape[0], w.shape[0]
    out = np.zeros((T, J), dtype=np.int64)
    wsum = int(w.sum())
    if wsum <= 0:
        return out, counts.copy(), ptr
    pos = np.flatnonzero(w > 0)
    n_pos = int(pos.size)
    ptr = int(ptr) % n_pos
    base = counts[:, None] * w[None, :] // wsum
    out += base
    rem = counts - base.sum(axis=1)
    tot = int(rem.sum())
    if tot:
        # flat enumeration of all remainder units: unit u lands on the
        # (ptr+u)-th positive target, cyclically — exactly the per-tick
        # "start where the previous tick stopped" round-robin
        tick_idx = np.repeat(np.arange(T), rem)
        target = pos[(ptr + np.arange(tot)) % n_pos]
        np.add.at(out, (tick_idx, target), 1)
    return out, np.zeros(T, dtype=np.int64), (ptr + tot) % n_pos


def pack_split(counts, caps, ptr: int = 0):
    """Consolidating split: fill targets *in order* up to their per-tick
    capacity ``caps (J,)`` before spilling to the next — the bin-packing
    scheduler shape that lets trailing racks actually go idle (a
    proportional split keeps every rack lukewarm forever, so nothing can
    ever power off).  Demand beyond the total capacity is split
    proportionally by capacity (queues absorb it).  Same exact-conservation
    and single-target-identity contracts as :func:`proportional_split`.
    """
    counts = np.asarray(counts, dtype=np.int64)
    caps = np.asarray(caps, dtype=np.int64)
    if np.any(caps < 0):
        raise ValueError("caps must be non-negative")
    total = int(caps.sum())
    if total <= 0:
        return (
            np.zeros((counts.shape[0], caps.shape[0]), dtype=np.int64),
            counts.copy(),
            ptr,
        )
    prefix = np.concatenate([[0], np.cumsum(caps)[:-1]])
    base = np.clip(counts[:, None] - prefix[None, :], 0, caps[None, :])
    leftover = counts - base.sum(axis=1)
    extra, dropped, ptr = proportional_split(leftover, caps, ptr)
    return base + extra, dropped, ptr


def _idle_tail_mj(params: FleetParams, state: FleetState, t_ms: float) -> float:
    """Close out the lazy idle accounting at time ``t_ms``: the routed
    kernel charges a device's idle span retroactively at its *next* serve
    (capped at the policy timeout), so a resident device whose stream ends
    — rack power-off, crash, or the horizon — has a pending span no serve
    will ever book.  This is exactly what ``simulate_trace`` would charge
    had the trace ended at ``t_ms``; without it an always-on rack's night
    looks free and every energy comparison against powering off inverts.

    The six columns come to the host and the sum is numpy's float64 one, in
    the reference's order, so the tail equals the reference's bit for bit."""
    completion = _np(state.completion_ms)
    resident = _np(state.resident)
    served = _np(state.n_served) > 0
    alive = _np(state.alive)
    gap = np.maximum(t_ms - completion, 0.0)
    span = np.minimum(gap, _np(params.timeout_ms))
    mask = resident & served & alive
    return float(
        np.sum(np.where(mask, span * _np(params.p_idle_mw) / 1000.0, 0.0))
    )


def run_rack_periodic(spec: RackSpec, n_steps: int, jit: bool = True) -> PeriodicFleetResult:
    """A rack in the paper's duty-cycle mode: every device sees its own
    constant request period.  Delegates to
    :func:`repro_torch.fleet.step.run_periodic`, so a 1-device rack reproduces
    the scalar ``simulate()`` oracle bit-for-bit — the bottom anchor of
    the differential spine."""
    return run_periodic(spec.params, n_steps, jit=jit)


@dataclasses.dataclass
class _RackRuntime:
    spec: RackSpec
    region: str
    state: FleetState
    autoscaler: Optional[object]
    powered: bool = True
    crashed: bool = False
    unrecoverable: bool = False
    ready_tick: int = 0
    last_active_tick: int = 0
    lost_devices: int = 0
    usable_devices: int = 0
    arrived: int = 0
    bringup_energy_mj: float = 0.0
    idle_tail_mj: float = 0.0
    n_power_ons: int = 0
    n_power_offs: int = 0
    n_restarts: int = 0
    device_ok: np.ndarray = None  # bool (N,): not lost, not parked

    def serving(self, tick: int) -> bool:
        return self.powered and not self.crashed and self.ready_tick <= tick

    def backlog(self) -> int:
        return int(self.state.q_len.sum())


@dataclasses.dataclass(frozen=True)
class RackResult:
    """Final per-rack telemetry: the carried fleet state plus the rack-level
    events (power cycles, restarts, bring-up energy) the device state does
    not know about."""

    spec: RackSpec
    region: str
    state: FleetState
    powered: bool
    crashed: bool
    unrecoverable: bool
    usable_devices: int
    lost_devices: int
    arrived: int
    bringup_energy_mj: float
    idle_tail_mj: float
    n_power_ons: int
    n_power_offs: int
    n_restarts: int
    autoscaler: Optional[object]

    @property
    def served(self) -> int:
        return int(self.state.n_served.sum())

    @property
    def dropped(self) -> int:
        return int(self.state.n_dropped.sum())

    @property
    def in_flight(self) -> int:
        return int(self.state.q_len.sum())

    @property
    def device_energy_mj(self) -> float:
        return float(np.sum(_np(self.state.energy_mj)))

    def device_ledger(self) -> EnergyLedger:
        """Per-device (N,) ledger from the carried routed state."""
        return routed_ledger(self.spec.params, self.state)

    def ledger(self) -> EnergyLedger:
        """Rack roll-up: device axes summed, plus the rack-level bring-up
        charges on the configure axis (power-ons and elastic restarts are
        reconfigurations one level up) and any closed-out idle tails on the
        idle axis."""
        return self.device_ledger().aggregate() + EnergyLedger.from_axes(
            configure=self.bringup_energy_mj, idle=self.idle_tail_mj
        )

    @property
    def total_energy_mj(self) -> float:
        return self.device_energy_mj + self.bringup_energy_mj + self.idle_tail_mj

    def conserves(self) -> bool:
        return self.arrived == self.served + self.dropped + self.in_flight


@dataclasses.dataclass(frozen=True)
class HierarchyResult:
    topology: TopologySpec
    dt_ms: float
    n_ticks: int
    epoch_ticks: int
    racks: dict[str, RackResult]
    arrived: int
    global_dropped: int
    region_arrived: dict[str, int]
    region_dropped: dict[str, int]
    latency_ms: Optional[np.ndarray]
    device_ticks: int
    injector: Optional[FaultInjector]

    # ---- per-level counters --------------------------------------------------
    @property
    def served(self) -> int:
        return sum(r.served for r in self.racks.values())

    @property
    def dropped(self) -> int:
        """Every dropped request, at whichever level it fell: device queue
        overflow / crash drops, region leftovers, global leftovers."""
        return (
            sum(r.dropped for r in self.racks.values())
            + sum(self.region_dropped.values())
            + self.global_dropped
        )

    @property
    def in_flight(self) -> int:
        return sum(r.in_flight for r in self.racks.values())

    def region_racks(self, region: str) -> list[RackResult]:
        return [r for r in self.racks.values() if r.region == region]

    # ---- ledgers -------------------------------------------------------------
    def region_ledger(self, region: str) -> EnergyLedger:
        led = EnergyLedger.zeros()
        for r in self.region_racks(region):
            led = led + r.ledger()
        return led

    def total_ledger(self) -> EnergyLedger:
        led = EnergyLedger.zeros()
        for region in self.topology.regions:
            led = led + self.region_ledger(region.name)
        return led

    @property
    def flat_device_energy_mj(self) -> float:
        """The flat per-device reference: summed raw scan energies."""
        return float(
            sum(r.device_energy_mj for r in self.racks.values())
        )

    @property
    def total_energy_mj(self) -> float:
        return self.flat_device_energy_mj + sum(
            r.bringup_energy_mj + r.idle_tail_mj for r in self.racks.values()
        )

    # ---- conservation contracts ---------------------------------------------
    def conservation(self) -> dict:
        """Request and energy conservation residuals at every level — the
        contracts :mod:`repro_torch.control.report` verifies before emitting."""
        rack_requests = {
            name: r.arrived - (r.served + r.dropped + r.in_flight)
            for name, r in self.racks.items()
        }
        region_requests = {}
        for region in self.topology.regions:
            routed = sum(r.arrived for r in self.region_racks(region.name))
            region_requests[region.name] = self.region_arrived[region.name] - (
                routed + self.region_dropped[region.name]
            )
        global_requests = self.arrived - (
            sum(self.region_arrived.values()) + self.global_dropped
        )
        rack_energy = {
            name: r.ledger().conservation_error(r.total_energy_mj)
            for name, r in self.racks.items()
        }
        return {
            "rack_requests": rack_requests,
            "region_requests": region_requests,
            "global_requests": global_requests,
            "rack_energy": rack_energy,
            "total_energy": self.total_ledger().conservation_error(
                self.total_energy_mj
            ),
        }

    def assert_conserves(self, rtol: float = 1e-9) -> dict:
        c = self.conservation()
        bad = []
        if any(v != 0 for v in c["rack_requests"].values()):
            bad.append(f"rack requests {c['rack_requests']}")
        if any(v != 0 for v in c["region_requests"].values()):
            bad.append(f"region requests {c['region_requests']}")
        if c["global_requests"] != 0:
            bad.append(f"global requests {c['global_requests']}")
        worst_rack = max(c["rack_energy"].values()) if c["rack_energy"] else 0.0
        if not worst_rack <= rtol or not math.isfinite(worst_rack):
            bad.append(f"rack energy {worst_rack:.3e}")
        if not c["total_energy"] <= rtol or not math.isfinite(c["total_energy"]):
            bad.append(f"total energy {c['total_energy']:.3e}")
        if bad:
            raise AssertionError(
                "hierarchy conservation violated: " + "; ".join(bad)
            )
        return c


def _drop_queues(state: FleetState) -> FleetState:
    """Crash semantics: queued requests are lost — counted as drops so the
    request ledger still balances — and every device loses residency.  The
    carry keeps its dtypes (``n_dropped`` int64, ``q_len`` int32), so the
    next routed chunk takes it unchanged."""
    return dataclasses.replace(
        state,
        n_dropped=state.n_dropped + state.q_len.to(torch.int64),
        q_len=torch.zeros_like(state.q_len),
        resident=torch.zeros_like(state.resident),
    )


def _derezident(state: FleetState) -> FleetState:
    """Rack power-off: devices lose residency (their next serve pays a
    reconfiguration — On-Off applied one level up); queues must already be
    empty (the caller checks)."""
    return dataclasses.replace(state, resident=torch.zeros_like(state.resident))


def _mask_devices(state: FleetState, ok: np.ndarray) -> FleetState:
    """Lost or parked devices stop serving: the host's ``ok`` mask goes to
    the state's device."""
    ok = torch.as_tensor(np.asarray(ok, dtype=bool)).to(state.alive.device)
    return dataclasses.replace(state, alive=state.alive & ok)


def run_hierarchy(
    topology: TopologySpec,
    counts,
    dt_ms: float,
    epoch_ticks: int = 64,
    autoscaler_factory: Optional[Callable[[RackSpec], object]] = None,
    faults: Optional[FaultSchedule] = None,
    heartbeat_timeout_s: float = 1.0,
    keep_min: int = 1,
    collect_latency: bool = True,
    jit: bool = True,
    rack_routing: str = "spread",
    charge_idle_tail: bool = False,
) -> HierarchyResult:
    """Simulate ``counts`` (a ``(K,)`` global per-tick request stream)
    through the full hierarchy.  See the module docstring for the epoch
    control loop; ``autoscaler_factory`` maps each :class:`RackSpec` to a
    controller with ``observe_gap``/``idle_timeout_ms`` (``None`` disables
    autoscaling entirely — racks stay powered, the collapse configuration).

    ``rack_routing`` picks the region→rack split: ``"spread"`` (exact
    proportional — the collapse default) or ``"pack"`` (fill racks in
    order, so trailing racks actually drain and can power off).
    ``charge_idle_tail`` closes out the routed kernel's lazy idle spans at
    power-off, crash, and the horizon (see :func:`_idle_tail_mj`); it is
    off by default so the 1-region/1-rack collapse stays bit-identical to
    ``run_routed``.

    Each rack's carry lives on the device of its fleet's params, and each
    epoch is one ``run_routed`` call there (``jit=True`` on a card: CUDA
    graphs of the tick body, captured in every call).  The control loop —
    splits, faults, autoscaling — is host Python over host integers; it
    reads each rack's backlog, and its idle tail when charged, from the
    device between calls.
    """
    if rack_routing not in ("spread", "pack"):
        raise ValueError(
            f"rack_routing must be 'spread' or 'pack', got {rack_routing!r}"
        )
    counts = np.asarray(counts, dtype=np.int64)
    if counts.ndim != 1:
        raise ValueError(f"counts must be (K,), got shape {counts.shape}")
    if np.any(counts < 0):
        raise ValueError("counts must be non-negative")
    if epoch_ticks < 1:
        raise ValueError(f"epoch_ticks must be >= 1, got {epoch_ticks}")
    n_ticks = int(counts.shape[0])
    epoch_ms = None  # per-epoch, the last epoch may be short

    clock = SimClock()
    injector = None
    if faults is not None and faults.faults:
        injector = FaultInjector(
            topology, faults, clock, heartbeat_timeout_s=heartbeat_timeout_s
        )

    racks: dict[str, _RackRuntime] = {}
    for region in topology.regions:
        for spec in region.racks:
            racks[spec.name] = _RackRuntime(
                spec=spec,
                region=region.name,
                state=FleetState.init(
                    spec.n_devices, spec.queue_capacity, device=spec.params.device
                ),
                autoscaler=(
                    autoscaler_factory(spec) if autoscaler_factory else None
                ),
                usable_devices=spec.n_devices,
                device_ok=np.ones(spec.n_devices, dtype=bool),
            )

    arrived = 0
    global_dropped = 0
    region_arrived = {r.name: 0 for r in topology.regions}
    region_dropped = {r.name: 0 for r in topology.regions}
    prev_region_demand = {r.name: 0 for r in topology.regions}
    global_ptr = 0
    region_ptr = {r.name: 0 for r in topology.regions}
    latencies: list[np.ndarray] = []
    device_ticks = 0
    bringup_ticks = {
        name: int(math.ceil(rk.spec.bringup_ms / dt_ms)) for name, rk in racks.items()
    }

    def power_on(rk: _RackRuntime, tick: int, restart: bool = False) -> None:
        rk.powered = True
        rk.crashed = False
        rk.ready_tick = tick + bringup_ticks[rk.spec.name]
        rk.bringup_energy_mj += rk.spec.bringup_mj
        if restart:
            rk.n_restarts += 1
        else:
            rk.n_power_ons += 1

    for e0 in range(0, n_ticks, epoch_ticks):
        e1 = min(e0 + epoch_ticks, n_ticks)
        chunk = counts[e0:e1]
        T = e1 - e0
        epoch_ms = T * dt_ms

        # 1. scheduled crashes fire at the boundary of their epoch
        if injector is not None:
            for fault in injector.crashes_for(e0, e1):
                rk = racks[fault.rack]
                if rk.unrecoverable:
                    continue
                if charge_idle_tail:
                    rk.idle_tail_mj += _idle_tail_mj(
                        rk.spec.params, rk.state, e0 * dt_ms
                    )
                rk.crashed = True
                rk.powered = False
                rk.state = _drop_queues(rk.state)
                if fault.lost_devices:
                    n = rk.spec.n_devices
                    rk.lost_devices = min(n, rk.lost_devices + fault.lost_devices)
                    rk.device_ok[n - rk.lost_devices:] = False
                    rk.state = _mask_devices(rk.state, rk.device_ok)

            # 2. detection + elastic restart for crashes old enough
            crashed_names = [n for n, rk in racks.items()
                             if rk.crashed and not rk.unrecoverable]
            for name in injector.detected(crashed_names):
                rk = racks[name]
                survivors = rk.spec.n_devices - rk.lost_devices
                usable = injector.plan_recovery(name, survivors)
                if usable is None:
                    rk.unrecoverable = True
                    rk.powered = False
                    rk.usable_devices = 0
                    continue
                rk.usable_devices = usable
                ok = np.zeros(rk.spec.n_devices, dtype=bool)
                ok[:usable] = True
                ok &= rk.device_ok
                rk.device_ok = ok
                rk.state = _mask_devices(rk.state, rk.device_ok)
                power_on(rk, e0, restart=True)

            injector.beat_healthy(
                [n for n, rk in racks.items() if not rk.crashed]
            )

        # 3. autoscaling decisions from last epoch's observations
        if autoscaler_factory is not None:
            for region in topology.regions:
                members = [racks[s.name] for s in region.racks]
                serving = [rk for rk in members if rk.serving(e0)]
                # scale down: idle past the autoscaler's timeout, queue empty
                for rk in serving:
                    if len([m for m in members if m.powered and not m.crashed]) <= keep_min:
                        break
                    timeout = rk.autoscaler.idle_timeout_ms()
                    idle_ms = (e0 - rk.last_active_tick) * dt_ms
                    if math.isfinite(timeout) and idle_ms > timeout and rk.backlog() == 0:
                        if charge_idle_tail:
                            rk.idle_tail_mj += _idle_tail_mj(
                                rk.spec.params, rk.state, e0 * dt_ms
                            )
                        rk.powered = False
                        rk.state = _derezident(rk.state)
                        rk.n_power_offs += 1
                # scale up: capacity must cover last epoch's demand + backlog
                pending = prev_region_demand[region.name] + sum(
                    rk.backlog() for rk in members
                )
                def capacity(active):
                    return sum(rk.usable_devices for rk in active) * T
                active = [rk for rk in members
                          if rk.powered and not rk.crashed and not rk.unrecoverable]
                for rk in members:
                    if capacity(active) >= max(pending, 1):
                        break
                    if rk.powered or rk.crashed or rk.unrecoverable:
                        continue
                    power_on(rk, e0)
                    active.append(rk)

        # 4. exact integer routing: global → regions → racks
        serving_sets = {
            region.name: [racks[s.name] for s in region.racks
                          if racks[s.name].serving(e0)]
            for region in topology.regions
        }
        region_w = np.array(
            [sum(rk.usable_devices for rk in serving_sets[r.name])
             for r in topology.regions],
            dtype=np.int64,
        )
        per_region, g_drop, global_ptr = proportional_split(
            chunk, region_w, global_ptr
        )
        arrived += int(chunk.sum())
        global_dropped += int(g_drop.sum())

        for j, region in enumerate(topology.regions):
            col = per_region[:, j]
            col_total = int(col.sum())
            region_arrived[region.name] += col_total
            prev_region_demand[region.name] = col_total
            serving = serving_sets[region.name]
            if not serving:
                continue  # weight 0 ⇒ col is all zeros
            rack_w = np.array(
                [rk.usable_devices for rk in serving], dtype=np.int64
            )
            split = pack_split if rack_routing == "pack" else proportional_split
            per_rack, r_drop, region_ptr[region.name] = split(
                col, rack_w, region_ptr[region.name]
            )
            region_dropped[region.name] += int(r_drop.sum())

            # 5. advance every serving rack one bit-exact routed chunk
            for i, rk in enumerate(serving):
                rack_counts = per_rack[:, i]
                rk.arrived += int(rack_counts.sum())
                res = run_routed(
                    rk.spec.params,
                    rack_counts,
                    dt_ms,
                    router=rk.spec.router,
                    collect_latency=collect_latency,
                    jit=jit,
                    state0=rk.state,
                    start_tick=e0,
                )
                rk.state = res.state
                device_ticks += T * rk.spec.n_devices
                if collect_latency and res.latency_ms is not None:
                    # one gather on the fleet's device, one copy to the host
                    lat = _np(res.latency_ms[res.served_mask])
                    if lat.size:
                        latencies.append(lat)
                if int(rack_counts.sum()) > 0:
                    rk.last_active_tick = e1
                if rk.autoscaler is not None:
                    a = int(rack_counts.sum())
                    gap = epoch_ms / a if a > 0 else epoch_ms
                    rk.autoscaler.observe_gap(gap)

        clock.advance(epoch_ms / 1000.0)

    if charge_idle_tail:
        # horizon close-out: racks still powered have pending lazy idle
        # spans no future serve will book (powered-off / crashed racks were
        # closed out at their transition, and derezidency zeroes the mask)
        for rk in racks.values():
            rk.idle_tail_mj += _idle_tail_mj(
                rk.spec.params, rk.state, n_ticks * dt_ms
            )

    rack_results = {
        name: RackResult(
            spec=rk.spec,
            region=rk.region,
            state=rk.state,
            powered=rk.powered,
            crashed=rk.crashed,
            unrecoverable=rk.unrecoverable,
            usable_devices=rk.usable_devices,
            lost_devices=rk.lost_devices,
            arrived=rk.arrived,
            bringup_energy_mj=rk.bringup_energy_mj,
            idle_tail_mj=rk.idle_tail_mj,
            n_power_ons=rk.n_power_ons,
            n_power_offs=rk.n_power_offs,
            n_restarts=rk.n_restarts,
            autoscaler=rk.autoscaler,
        )
        for name, rk in racks.items()
    }
    return HierarchyResult(
        topology=topology,
        dt_ms=float(dt_ms),
        n_ticks=n_ticks,
        epoch_ticks=epoch_ticks,
        racks=rack_results,
        arrived=arrived,
        global_dropped=global_dropped,
        region_arrived=region_arrived,
        region_dropped=region_dropped,
        latency_ms=(
            np.concatenate(latencies) if latencies
            else np.zeros(0, dtype=np.float32)
        ) if collect_latency else None,
        device_ticks=device_ticks,
        injector=injector,
    )
