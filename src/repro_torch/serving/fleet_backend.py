"""Fleet backend for multi-tenant serving: tenants × replicas in one tick
loop (port of ``repro.serving.fleet_backend``).

:class:`repro_torch.serving.multi_tenant.MultiTenantScheduler` steps one
slice at a time in Python — fine for a live engine, hopeless for planner
questions like "how many replicas of each tenant survive a shared
per-device budget under production traffic?".  This backend maps each
tenant onto a *block of fleet devices* (its replicas) and answers those
questions with the vectorized stepper
(:func:`repro_torch.fleet.step.run_routed`): every replica of every tenant
advances in the same loop, on one device.

Policy mapping (mirrors ``Tenant.timeout_s``):

    idle_waiting  never released            → fleet timeout ∞
    on_off        released after each item  → fleet timeout 0
    auto          break-even idle timeout   → fleet "adaptive" (ski-rental
    adaptive      learned / break-even        break-even timeout — the
                                              controller's hybrid regime)

Traffic: each tenant's request stream is Poisson at its mean period,
thinned uniformly across its replicas (exact for Poisson: R independent
streams at R× the period), sampled batch-wise by
:meth:`repro_torch.core.arrivals.ArrivalProcess.sample_batch` from a
``torch.Generator`` seeded with ``seed`` on the backend's device (the
reference splits a ``jax.random`` key per tenant; the streams differ, their
law does not).

:meth:`FleetBackend.plan_budgets` splits one shared budget across every
replica through the optimizer's planner
(:mod:`repro_torch.optimize.planner`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import measured_workload_item
from repro_torch.core.arrivals import PoissonArrivals, bin_arrival_counts
from repro_torch.device import resolve_device
from repro_torch.fleet import DeviceSpec, FleetParams, run_routed
from repro_torch.fleet.metrics import routed_summary
from repro_torch.fleet.step import _np

__all__ = ["FleetTenantSpec", "FleetBackend"]

_POLICY_TO_STRATEGY = {
    "idle_waiting": "idle_waiting",
    "on_off": "on_off",
    "auto": "adaptive",
    "adaptive": "adaptive",
}


@dataclasses.dataclass(frozen=True)
class FleetTenantSpec:
    """One tenant as the fleet sees it: measured phases + policy + traffic."""

    name: str
    config_mw: float
    config_s: float
    infer_mw: float
    infer_s: float
    idle_mw: float
    policy: str = "auto"              # auto | idle_waiting | on_off | adaptive
    replicas: int = 1
    mean_period_ms: float = 1000.0    # per-tenant mean request period
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ

    def __post_init__(self) -> None:
        if self.policy not in _POLICY_TO_STRATEGY:
            raise ValueError(
                f"tenant {self.name!r}: unknown policy {self.policy!r}"
            )
        if self.replicas < 1:
            raise ValueError(f"tenant {self.name!r}: replicas must be ≥ 1")

    @staticmethod
    def from_model(
        model: str,
        policy: str = "auto",
        replicas: int = 1,
        mean_period_ms: float | None = None,
        utilization: float = 0.25,
        e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
        **cost_kwargs,
    ) -> "FleetTenantSpec":
        """A tenant priced by the cost zoo (`repro_torch.costs`) instead of
        hand-measured phases.

        The model's roofline-calibrated request item is flattened into the
        tenant's (config, infer) phase pair — data load/offload fold into
        the inference leg, preserving total execution time and energy.
        ``mean_period_ms`` defaults to the same utilization rule as
        :func:`repro_torch.costs.model_device_spec`.
        """
        from repro_torch.costs import model_request_cost  # deferred: costs imports fleet

        cost = model_request_cost(model, **cost_kwargs)
        item = cost.item
        exec_ms = item.execution_time_ms
        exec_mw = (item.execution_energy_mj / (exec_ms / 1e3)) if exec_ms > 0 else 0.0
        if mean_period_ms is None:
            if not (0.0 < utilization <= 1.0):
                raise ValueError(f"utilization must be in (0, 1], got {utilization}")
            mean_period_ms = max(exec_ms / utilization, item.total_time_ms)
        config_s = item.config_time_ms / 1e3
        config_mw = (item.config_energy_mj / config_s) if config_s > 0 else 0.0
        return FleetTenantSpec(
            name=item.name,
            config_mw=config_mw,
            config_s=config_s,
            infer_mw=exec_mw,
            infer_s=exec_ms / 1e3,
            idle_mw=item.idle_power_mw,
            policy=policy,
            replicas=replicas,
            mean_period_ms=mean_period_ms,
            e_budget_mj=e_budget_mj,
        )

    def device_spec(self) -> DeviceSpec:
        item = measured_workload_item(
            self.name, self.config_mw, self.config_s,
            self.infer_mw, self.infer_s, self.idle_mw,
        )
        return DeviceSpec(
            item=item,
            strategy=_POLICY_TO_STRATEGY[self.policy],
            request_period_ms=self.mean_period_ms * self.replicas,
            e_budget_mj=self.e_budget_mj,
        )


class FleetBackend:
    """Vectorized multi-tenant planner: N tenants × their replicas, one
    loop on ``device`` (default the card)."""

    def __init__(self, tenants: Sequence[FleetTenantSpec], device="cuda"):
        tenants = list(tenants)
        if not tenants:
            raise ValueError("FleetBackend needs at least one tenant")
        self.device = resolve_device(device)
        self.tenants = tenants
        # device layout: tenant i owns the contiguous block
        # [offset[i], offset[i] + replicas_i)
        self.blocks: list[tuple[int, int]] = []
        specs: list[DeviceSpec] = []
        off = 0
        for t in tenants:
            self.blocks.append((off, off + t.replicas))
            specs.extend([t.device_spec()] * t.replicas)
            off += t.replicas
        self.n_devices = off
        self.params = FleetParams.from_specs(specs, self.device)

    # ---- planner-driven placement -------------------------------------------
    def plan_budgets(
        self,
        fleet_budget_mj: float,
        horizon_ms: float,
        objective: str = "min_lifetime",
    ):
        """Split one *shared* energy budget across every replica of every
        tenant (:func:`repro_torch.optimize.planner.plan_budgets`), instead
        of the per-tenant batteries the specs declare.

        The plan is computed on the periodic proxy — each replica serving
        its thinned mean period, capped at the requests ``horizon_ms``
        delivers — which is exactly the model the planner can replay
        bit-for-bit through ``run_periodic``; :meth:`run` on the planned
        backend then exercises the allocation under the real (Poisson,
        routed) traffic.

        Returns ``(allocation, per_tenant)`` where ``per_tenant`` maps
        tenant name → planned budget / requests / lifetime summary.
        """
        from repro_torch.optimize.planner import plan_budgets as _plan

        caps = np.maximum(
            np.floor(horizon_ms / _np(self.params.period_ms)), 0.0
        ).astype(np.int64)
        alloc = _plan(self.params, fleet_budget_mj, caps, objective=objective)
        per_tenant = {}
        for t, (a, b) in zip(self.tenants, self.blocks):
            per_tenant[t.name] = {
                "replicas": t.replicas,
                "budget_mj": float(alloc.budgets_mj[a:b].sum()),
                "planned_requests": int(alloc.n_items[a:b].sum()),
                "min_lifetime_ms": float(alloc.predicted_lifetime_ms[a:b].min()),
                "max_lifetime_ms": float(alloc.predicted_lifetime_ms[a:b].max()),
            }
        assert math.isfinite(alloc.leftover_mj)
        return alloc, per_tenant

    def with_allocation(self, allocation) -> "FleetBackend":
        """A new backend whose replicas carry the planner's per-device
        budgets (every other parameter bit-identical)."""
        clone = FleetBackend(self.tenants, self.device)
        clone.params = self.params.with_budgets(allocation.budgets_mj)
        return clone

    def _sample_counts(
        self,
        horizon_ms: float,
        dt_ms: float,
        seed: int,
        n_seeds: int = 1,
        jitter: float = 0.0,
        max_arrivals: int | None = None,
    ) -> torch.Tensor:
        """``(n_seeds, K, N)`` int32 binned per-replica arrival counts on the
        backend's device.

        ``jitter`` adds per-seed *global traffic-rate* noise: replication s
        scales every tenant's timeline by ``1 + jitter · ε_s`` (ε standard
        normal from numpy's ``default_rng(seed)``, clipped at 0.1).
        Streams are sampled on an extended horizon so fast-clock seeds
        (factor < 1) are not truncation-biased near the horizon edge.
        """
        if n_seeds < 1:
            raise ValueError(f"n_seeds must be ≥ 1, got {n_seeds}")
        if not (math.isfinite(jitter) and jitter >= 0):
            raise ValueError(f"jitter must be a finite, non-negative fraction, got {jitter!r}")
        n_steps = int(math.ceil(horizon_ms / dt_ms))
        rng = np.random.default_rng(seed)
        factors = np.maximum(1.0 + jitter * rng.standard_normal(n_seeds), 0.1)
        horizon_ext = horizon_ms / float(np.min(factors))
        scale = torch.as_tensor(factors, dtype=torch.float64, device=self.device)[:, None, None]
        generator = torch.Generator(self.device).manual_seed(seed)
        per_tenant = []
        for t in self.tenants:
            # R independent Poisson streams at R× the tenant period ≡ the
            # tenant's stream thinned uniformly across its replicas
            proc = PoissonArrivals(t.mean_period_ms * t.replicas)
            if max_arrivals is None:
                est = horizon_ext / proc.mean_period_ms()
                # wider headroom than sample_batch's default: hundreds of
                # replica streams make 4-sigma tail truncation likely
                cap = int(est + 8.0 * math.sqrt(est) + 16.0)
            else:
                cap = max_arrivals
            times = proc.sample_batch(
                generator, n_seeds * t.replicas, horizon_ext,
                max_arrivals=cap, include_origin=False,
            )
            times = times.reshape(n_seeds, t.replicas, -1) * scale
            counts = bin_arrival_counts(
                times.reshape(n_seeds * t.replicas, -1), horizon_ms, dt_ms
            )
            per_tenant.append(counts.reshape(n_steps, n_seeds, t.replicas).permute(1, 0, 2))
        return torch.cat(per_tenant, dim=2)

    def run(
        self,
        horizon_ms: float,
        dt_ms: float = 100.0,
        seed: int = 0,
        queue_capacity: int = 16,
        max_arrivals: int | None = None,
    ) -> dict:
        """Simulate every replica over ``horizon_ms``; per-tenant summary.

        ``max_arrivals`` bounds each replica's sampled stream (default: a
        mean-rate estimate with 8·sqrt headroom — raise it for very long
        horizons / heavy tails where tail truncation would bias the
        per-tenant counts low).
        """
        counts = self._sample_counts(
            horizon_ms, dt_ms, seed, n_seeds=1, jitter=0.0,
            max_arrivals=max_arrivals,
        )[0]
        result = run_routed(
            self.params, counts, dt_ms, router=None,
            queue_capacity=queue_capacity,
        )
        s = result.state
        served = _np(s.n_served)
        energy = _np(s.energy_mj)
        alive = _np(s.alive)
        configs = _np(s.n_configs)
        out = {
            "fleet": routed_summary(result),
            "tenants": {},
        }
        for t, (a, b) in zip(self.tenants, self.blocks):
            n = int(served[a:b].sum())
            e = float(energy[a:b].sum())
            out["tenants"][t.name] = {
                "policy": t.policy,
                "replicas": t.replicas,
                "served": n,
                "energy_mj": e,
                "energy_per_request_mj": (e / n) if n else None,
                "configurations": int(configs[a:b].sum()),
                "replicas_alive": int(alive[a:b].sum()),
            }
        return out

    def run_mc(
        self,
        horizon_ms: float,
        dt_ms: float = 100.0,
        n_seeds: int = 32,
        seed: int = 0,
        jitter: float = 0.0,
        queue_capacity: int = 16,
        max_arrivals: int | None = None,
        confidence: float = 0.95,
    ) -> dict:
        """Seed-replicated :meth:`run`: per-tenant **confidence bands**.

        Every replication redraws each tenant's Poisson streams (and, with
        ``jitter`` > 0, its global traffic rate — see
        :meth:`_sample_counts`), then all ``n_seeds`` × N-replica fleets
        advance through the Monte Carlo engine's one routed tick loop over
        an ``(S, N)`` carry (:func:`repro_torch.mc.ensemble.routed_ensemble`,
        the same tick body :meth:`run` uses).  Point estimates become 95%
        intervals: fleet served / energy-per-request / p99 latency, and
        per-tenant served / energy / replicas-alive.
        """
        import functools

        from repro_torch.mc.ensemble import routed_ensemble
        from repro_torch.mc.intervals import ci_dict

        counts = self._sample_counts(
            horizon_ms, dt_ms, seed, n_seeds=n_seeds, jitter=jitter,
            max_arrivals=max_arrivals,
        )
        ens = routed_ensemble(
            self.params, counts, dt_ms,
            queue_capacity=queue_capacity, keep_device_samples=True,
        )
        _ci = functools.partial(ci_dict, confidence=confidence)

        out = {
            "n_seeds": n_seeds,
            "jitter": jitter,
            "confidence": confidence,
            "horizon_ms": horizon_ms,
            "dt_ms": dt_ms,
            "fleet": {
                "served": _ci(ens.served),
                "energy_per_request_mj": _ci(ens.energy_per_request_mj),
                "p99_latency_ms": _ci(ens.p99_latency_ms),
                "devices_alive": _ci(ens.devices_alive),
            },
            "tenants": {},
        }
        served = ens.per_device_served          # (S, N)
        energy = ens.per_device_energy_mj       # (S, N)
        for t, (a, b) in zip(self.tenants, self.blocks):
            t_served = served[:, a:b].sum(axis=1)
            t_energy = energy[:, a:b].sum(axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                t_epr = np.where(t_served > 0, t_energy / np.maximum(t_served, 1), np.nan)
            out["tenants"][t.name] = {
                "policy": t.policy,
                "replicas": t.replicas,
                "served": _ci(t_served),
                "energy_mj": _ci(t_energy),
                "energy_per_request_mj": _ci(t_epr),
            }
        return out
