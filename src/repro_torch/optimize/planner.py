"""Fleet-wide energy-budget planner (port of ``repro.optimize.planner``;
host numpy, as in the reference — only the replay runs on the fleet's
device).

The paper provisions every device with the same 4147 J battery.  At fleet
scale the natural question inverts: given a *shared* energy budget (4147 J
× N, or whatever the deployment can afford), how should it be split across
heterogeneous devices — different workloads, strategies, idle powers,
request periods — to maximize what the fleet delivers?

Because both strategies' cumulative energies are **affine in the item
count** (Eqs. 1–2), the planner needs no search: for any target lifetime
the exact budget a device needs is a closed form, and the whole allocation
reduces to a continuous water-fill plus an integer top-up.  Two objectives:

* ``min_lifetime`` — max-min: raise the lifetime floor of the fleet as far
  as the shared budget allows (continuous solve for the common lifetime
  L*, floor to integer item counts, then greedily lift whichever device
  currently has the minimum lifetime while budget remains);
* ``total_requests`` — serve as many items fleet-wide as possible (greedy
  by next-item marginal cost with bulk take; optimal whenever per-device
  marginal costs are non-increasing, i.e. always except that a device's
  *first* item also pays its E_init — within one init cost of optimal
  otherwise).

**Exactness contract.**  Every allocated budget is the *exact* cumulative
energy of the planned item count, computed with the identical IEEE-754
float64 expression :func:`repro_torch.fleet.step.run_periodic` re-derives final
energies with (same association order).  Replaying an allocation therefore
reproduces the planner's predicted item counts, energies and lifetimes
**bit-for-bit** — :func:`replay_allocation` asserts exactly that, and the
admission margin is one full item energy (≫ any rounding noise), so the
guarantee is robust, not luck.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.fleet.state import FleetParams
from repro_torch.fleet.step import _np, run_periodic

__all__ = [
    "BudgetAllocation",
    "plan_budgets",
    "replay_allocation",
]

OBJECTIVES = ("min_lifetime", "total_requests")


@dataclasses.dataclass(frozen=True)
class BudgetAllocation:
    """A fleet budget split into per-device budgets, with predictions.

    ``budgets_mj[i]`` is exactly the cumulative energy of ``n_items[i]``
    items on device *i*; ``predicted_lifetime_ms`` is ``n_items ·
    period_ms`` computed in float64 exactly as the periodic kernel computes
    it.  ``leftover_mj`` is defined as ``fleet_budget_mj − Σ budgets_mj``
    (so conservation holds by construction) and is always ≥ −0.0.
    """

    objective: str
    fleet_budget_mj: float
    n_items: np.ndarray               # i64 (N,)
    budgets_mj: np.ndarray            # f64 (N,) — exact cum energy at n_items
    predicted_lifetime_ms: np.ndarray  # f64 (N,)
    n_cap: np.ndarray                 # i64 (N,) — horizon cap used
    leftover_mj: float

    @property
    def n_devices(self) -> int:
        return int(self.n_items.shape[0])

    @property
    def total_requests(self) -> int:
        return int(self.n_items.sum())

    @property
    def min_lifetime_ms(self) -> float:
        return float(self.predicted_lifetime_ms.min())

    def to_json_dict(self, limit: int | None = 64) -> dict:
        n = self.n_devices if limit is None else min(limit, self.n_devices)
        return {
            "objective": self.objective,
            "fleet_budget_mj": self.fleet_budget_mj,
            "devices": self.n_devices,
            "total_requests": self.total_requests,
            "min_lifetime_ms": self.min_lifetime_ms,
            "max_lifetime_ms": float(self.predicted_lifetime_ms.max()),
            "allocated_mj": float(self.budgets_mj.sum()),
            "leftover_mj": self.leftover_mj,
            "per_device": [
                {
                    "n_items": int(self.n_items[i]),
                    "budget_mj": float(self.budgets_mj[i]),
                    "lifetime_ms": float(self.predicted_lifetime_ms[i]),
                }
                for i in range(n)
            ],
        }


def _columns(params: FleetParams) -> dict[str, np.ndarray]:
    return {
        "is_onoff": _np(params.is_onoff),
        "feasible": _np(params.feasible),
        "period_ms": _np(params.period_ms).astype(np.float64),
        "e_item_mj": _np(params.e_item_mj).astype(np.float64),
        "e_init_mj": _np(params.e_init_mj).astype(np.float64),
        "e_idle_mj": _np(params.e_idle_mj).astype(np.float64),
    }


def _cum_energy(cols: dict[str, np.ndarray], n: np.ndarray) -> np.ndarray:
    """Cumulative energy of ``n`` items per device — the *identical* f64
    expression (association order included) the periodic kernel re-derives
    final energies with, so planner budgets and replayed energies are the
    same floats."""
    nf = n.astype(np.float64)
    return np.where(
        cols["is_onoff"],
        nf * cols["e_item_mj"],
        np.where(
            n > 0,
            cols["e_init_mj"] + nf * cols["e_item_mj"] + (nf - 1.0) * cols["e_idle_mj"],
            0.0,
        ),
    )


def plan_budgets(
    params: FleetParams,
    fleet_budget_mj: float,
    n_cap: int | np.ndarray,
    objective: str = "min_lifetime",
) -> BudgetAllocation:
    """Split ``fleet_budget_mj`` across the fleet's devices.

    ``n_cap`` caps each device's planned item count (scalar or per-device)
    — typically the traffic horizon, ``floor(horizon_ms / period_ms)``: a
    device cannot usefully be budgeted for more requests than its stream
    delivers.  See the module docstring for the two objectives and the
    bit-for-bit replay contract.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; choose from {OBJECTIVES}")
    if not (fleet_budget_mj >= 0):
        raise ValueError(f"fleet budget must be non-negative, got {fleet_budget_mj}")
    cols = _columns(params)
    n_dev = cols["period_ms"].shape[0]
    cap = np.broadcast_to(np.asarray(n_cap, dtype=np.int64), (n_dev,)).copy()
    if (cap < 0).any():
        raise ValueError("n_cap must be non-negative")
    cap[~cols["feasible"]] = 0   # the kernel never admits on infeasible devices

    n = np.zeros(n_dev, dtype=np.int64)
    budget = float(fleet_budget_mj)
    spent = 0.0

    if objective == "min_lifetime":
        # --- continuous water-fill: cum_i(n) = α_i + n·p_i for n ≥ 1, with
        # n_i = L / T_i at common lifetime L  →  Σ costs affine in L.
        per = cols["e_item_mj"] + np.where(cols["is_onoff"], 0.0, cols["e_idle_mj"])
        alpha = np.where(cols["is_onoff"], 0.0, cols["e_init_mj"] - cols["e_idle_mj"])
        active = cap > 0
        if active.any():
            slope = np.where(active, per / cols["period_ms"], 0.0).sum()
            fixed = np.where(active, alpha, 0.0).sum()
            if slope > 0:
                L0 = max((budget - fixed) / slope, 0.0)
                n = np.minimum(
                    np.floor(L0 / cols["period_ms"]).astype(np.int64), cap
                )
                n[~active] = 0
        spent = float(_cum_energy(cols, n).sum())
        # floors can only under-shoot; if α>0 devices below n=1 made the
        # estimate overspend anyway, shed items from the longest-lived
        while spent > budget:
            i = int(np.argmax(np.where(n > 0, n.astype(np.float64) * cols["period_ms"], -np.inf)))
            if n[i] <= 0:
                break
            n[i] -= 1
            spent = float(_cum_energy(cols, n).sum())
        # --- integer top-up: lift the current minimum lifetime while it fits
        first = np.where(
            cols["is_onoff"], cols["e_item_mj"], cols["e_init_mj"] + cols["e_item_mj"]
        )
        lifetimes = n.astype(np.float64) * cols["period_ms"]
        heap = [(lifetimes[i], i) for i in range(n_dev) if cap[i] > 0]
        heapq.heapify(heap)
        while heap:
            _, i = heapq.heappop(heap)
            if n[i] >= cap[i]:
                continue
            cost = float(first[i] if n[i] == 0 else per[i])
            if spent + cost > budget:
                # the min-lifetime device can no longer afford an item: the
                # floor is final (costs are per-device constants from here)
                break
            n[i] += 1
            spent += cost
            heapq.heappush(heap, (float(n[i]) * cols["period_ms"][i], i))

    else:  # total_requests
        per = cols["e_item_mj"] + np.where(cols["is_onoff"], 0.0, cols["e_idle_mj"])
        first = np.where(
            cols["is_onoff"], cols["e_item_mj"], cols["e_init_mj"] + cols["e_item_mj"]
        )
        # fill in ascending *marginal* cost: the cheapest-per-item device
        # takes bulk first (its E_init is a one-off; ordering by first-item
        # cost would let an expensive-marginal device absorb the budget)
        for i in np.argsort(per, kind="stable"):
            if cap[i] == 0 or spent + first[i] > budget:
                continue
            n[i] = 1
            spent += float(first[i])
            room = budget - spent
            p = float(per[i])
            extra = int(cap[i]) - 1
            if p > 0:
                extra = min(extra, int(room / p + 1e-12))
            if extra > 0:
                n[i] += extra
                spent += extra * p
        spent = float(_cum_energy(cols, n).sum())

    # --- exact hand-off: budgets are the exact cumulative energies --------
    budgets = _cum_energy(cols, n)
    lifetimes = n.astype(np.float64) * cols["period_ms"]
    leftover = budget - float(budgets.sum())
    return BudgetAllocation(
        objective=objective,
        fleet_budget_mj=budget,
        n_items=n,
        budgets_mj=budgets,
        predicted_lifetime_ms=lifetimes,
        n_cap=cap,
        leftover_mj=leftover,
    )


def replay_allocation(
    params: FleetParams,
    allocation: BudgetAllocation,
    n_steps: int | None = None,
    jit: bool = True,
) -> dict:
    """Replay an allocation through the vectorized periodic kernel and
    compare against the planner's predictions.

    Runs :func:`repro_torch.fleet.step.run_periodic` on
    ``params.with_budgets(allocation.budgets_mj)`` for ``n_steps`` (default:
    one period beyond the longest plan, so budget exhaustion — not the
    horizon — ends every device) on the fleet's device and reports exact
    agreement: planned vs simulated item counts (integer equality),
    energies and lifetimes (float equality; ``max_rel_err`` fields for the
    JSON artifact).  ``result`` is the run's
    :class:`~repro_torch.fleet.step.PeriodicFleetResult` (tensors on the
    fleet's device).
    """
    if n_steps is None:
        n_steps = int(allocation.n_items.max()) + 1
    result = run_periodic(params.with_budgets(allocation.budgets_mj), n_steps, jit=jit)
    n_ok = np.array_equal(_np(result.n_items), allocation.n_items)
    life_err = _max_rel_err(_np(result.lifetime_ms), allocation.predicted_lifetime_ms)
    energy_err = _max_rel_err(_np(result.energy_mj), allocation.budgets_mj)
    return {
        "n_steps": n_steps,
        "n_items_match": bool(n_ok),
        "lifetime_max_rel_err": life_err,
        "energy_max_rel_err": energy_err,
        "exact": bool(n_ok and life_err == 0.0 and energy_err == 0.0),
        "result": result,
    }


def _max_rel_err(a: np.ndarray, b: np.ndarray) -> float:
    denom = np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-30)
    return float(np.max(np.abs(a - b) / denom)) if a.size else 0.0
