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

Not ported yet: :meth:`FleetTenantSpec.from_model` and
:meth:`FleetBackend.run_mc` (the cost zoo and Monte Carlo, ROADMAP A9), and
:meth:`FleetBackend.plan_budgets` (the optimizer, ROADMAP A10).
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
    def from_model(model: str, **kwargs) -> "FleetTenantSpec":
        """A tenant priced by the cost zoo: needs ``repro_torch.costs``,
        which is not ported yet (ROADMAP A9)."""
        raise NotImplementedError(
            "FleetTenantSpec.from_model needs the cost zoo (repro_torch.costs), "
            "which comes with the Monte Carlo and costs slice (ROADMAP A9)"
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
    def plan_budgets(self, fleet_budget_mj: float, horizon_ms: float,
                     objective: str = "min_lifetime"):
        """Split one shared energy budget across every replica: needs the
        optimizer's planner, which is not ported yet (ROADMAP A10)."""
        raise NotImplementedError(
            "FleetBackend.plan_budgets needs the optimizer's planner "
            "(repro_torch.optimize.planner), which comes with ROADMAP A10"
        )

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

    def run_mc(self, horizon_ms: float, dt_ms: float = 100.0, n_seeds: int = 32, **kwargs) -> dict:
        """Seed-replicated :meth:`run` with per-tenant confidence bands:
        needs the Monte Carlo engine (``repro_torch.mc``), which is not
        ported yet (ROADMAP A9)."""
        raise NotImplementedError(
            "FleetBackend.run_mc needs the Monte Carlo engine (repro_torch.mc), "
            "which comes with ROADMAP A9"
        )
