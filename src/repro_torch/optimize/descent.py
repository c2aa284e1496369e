"""Batched multi-start gradient descent over the relaxed design space (port
of ``repro.optimize.descent``).

S independent Adam chains (:func:`repro_torch.optim.adamw.adamw`, the
repo's own optimizer) advance together on a relaxed objective from
:mod:`repro_torch.optimize.relax`: every parameter is one float64 tensor
with a leading (S,) axis, one ``backward`` of the summed losses gives every
start its own gradient (no operation mixes starts), and the batched AdamW
update is element-wise, so each chain follows exactly the path the
reference's ``vmap`` over starts gives it.  The reference runs the steps in
one jitted ``lax.scan``; here they are a Python loop of ``steps``
iterations on the run's device.

After descent every chain is **rounded to the legal grid** (nearest clock —
plus its grid neighbours, so a chain that converged between two legal
clocks nominates both — argmax choices) and every rounded candidate is
**re-validated through the exact oracle** (:mod:`repro_torch.core.
batch_eval`'s kernels, bit-identical to the scalar closed forms).  The
returned optimum is therefore always an *exact* grid value; the relaxation
only steers the search.

Why descend at all when the paper's grid has 66 points?  Because the grid
is a *measurement artifact*, not the design space: the closed-form model is
defined on the clock continuum, and once the grid is densified (finer clock
steps, more devices, more periods) exhaustive sweeping scales linearly
while descent's cost is constant in grid density —
``python -m repro_torch.launch.optimize`` reports both.

The entry points take the FPGA device first (as the reference does) and
``torch_device`` for where the tensors live (default ``"cuda"``, which
raises on a host without a card).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.batch_eval import SweepGrid, config_phase_grid, sweep_batch
from repro_torch.core.config_phase import FpgaDevice, SPI_BUSWIDTHS, SPI_CLOCKS_MHZ
from repro_torch.core.pareto import pareto_mask_torch, soft_pareto_weight
from repro_torch.core.phases import WorkloadItem, paper_lstm_item
from repro_torch.core.strategies import IDLE_POWER_MW, IdlePowerMethod
from repro_torch.optim.adamw import adamw
from repro_torch.optimize import relax

__all__ = [
    "DescentSettings",
    "OptimizeResult",
    "descend",
    "optimize_config",
    "optimize_lifetime",
    "trace_config_frontier",
]

_F64 = torch.float64


@dataclasses.dataclass(frozen=True)
class DescentSettings:
    """Knobs of the multi-start Adam loop.

    ``jit`` is kept for the reference's API and has no effect: the port's
    loop runs eagerly, one correctly rounded op at a time.
    """

    n_starts: int = 16
    steps: int = 250
    lr: float = 0.5    # Adam-normalized steps are ~lr in clock-MHz/logit
                       # units; 250 × 0.5 comfortably spans the 3–66 MHz axis
    seed: int = 0
    jit: bool = True

    def __post_init__(self) -> None:
        if self.n_starts < 1:
            raise ValueError(f"n_starts must be ≥ 1, got {self.n_starts}")
        if self.steps < 1:
            raise ValueError(f"steps must be ≥ 1, got {self.steps}")
        if not (self.lr > 0):
            raise ValueError(f"lr must be positive, got {self.lr}")


@dataclasses.dataclass(frozen=True)
class OptimizeResult:
    """Outcome of one descent + exact re-validation pass.

    ``best`` holds the winning legal configuration and its **exact** oracle
    objective value; ``candidates`` every distinct rounded candidate the
    starts nominated (with exact values — the re-validation audit trail);
    ``loss_curve`` the per-step minimum relaxed loss across starts.
    """

    objective: str
    best: dict
    candidates: list[dict]
    loss_curve: np.ndarray
    settings: DescentSettings
    grid_points_considered: int

    def to_json_dict(self) -> dict:
        return {
            "objective": self.objective,
            "best": self.best,
            "candidates": self.candidates,
            "final_relaxed_loss": float(self.loss_curve[-1]),
            "n_starts": self.settings.n_starts,
            "steps": self.settings.steps,
            "grid_points_considered": self.grid_points_considered,
        }


_OPT = adamw(weight_decay=0.0, clip_norm=None, moment_dtype=_F64)


def _run(loss_fn: Callable[[dict], torch.Tensor], params: dict, lr: float,
         steps: int) -> tuple[dict, np.ndarray]:
    """THE multi-start Adam loop every path uses: ``steps`` updates of all
    starts at once on ``loss_fn(params) → (S,)`` (or a scalar for a single
    chain).  ``params`` is updated in place; returns it with the per-step
    min-loss curve."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    state = _OPT.init(params)
    dev = next(iter(params.values())).device
    lr_t = torch.full((), float(lr), dtype=_F64, device=dev)
    curve = []
    for _ in range(steps):
        loss = loss_fn(params)
        grads = torch.autograd.grad(loss.sum(), list(params.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params.values(), grads)]
        curve.append(loss.detach().min())
        _, state, _ = _OPT.update(dict(zip(params, grads)), state, params, lr_t)
    final = {k: v.detach() for k, v in params.items()}
    return final, torch.stack(curve).cpu().numpy()


def _start_params(problem: relax.RelaxedProblem, settings: DescentSettings, init_params):
    if init_params is not None:
        return {k: torch.as_tensor(np.asarray(v), dtype=_F64, device=problem.torch_device)
                for k, v in init_params.items()}
    # drawn on the host, so a run on the card starts where the CPU's does
    g = torch.Generator("cpu").manual_seed(settings.seed)
    return relax.init_params(g, problem, settings.n_starts)


def _descend_core(
    core_name: str,
    problem: relax.RelaxedProblem,
    settings: DescentSettings,
    lam: float = 0.0,
    init_params: dict | None = None,
) -> tuple[dict, np.ndarray]:
    core = relax.LOSS_CORES[core_name]
    lv = relax.leaves(problem)
    n_w = len(problem.buswidths)
    lam_t = torch.full((), float(lam), dtype=_F64, device=problem.torch_device)
    return _run(lambda p: core(p, lv, n_w, lam_t),
                _start_params(problem, settings, init_params), settings.lr, settings.steps)


def descend(
    loss_fn: Callable[[dict], torch.Tensor],
    problem: relax.RelaxedProblem,
    settings: DescentSettings = DescentSettings(),
    init_params: dict | None = None,
) -> tuple[dict, np.ndarray]:
    """Run S Adam chains on an arbitrary ``loss_fn(params) → (S,)``, element-
    wise over the starts (the leading axis of every parameter).

    Returns (final params with leading axis S, per-step min-loss curve).
    Runs in float64 on the problem's device.  ``init_params`` replaces the
    random starts (same keys and shapes as :func:`relax.init_params`).
    """
    return _run(loss_fn, _start_params(problem, settings, init_params),
                settings.lr, settings.steps)


# ---------------------------------------------------------------------------
# Rounding + exact re-validation
# ---------------------------------------------------------------------------
def _candidate_set(
    params: dict, problem: relax.RelaxedProblem, neighbours: int = 1
) -> list[tuple[int, float, bool]]:
    """Distinct legal (buswidth, clock, compression) candidates from the
    final starts: each start nominates its snapped point plus ``neighbours``
    grid clocks on each side (a chain that converged between two legal
    clocks is agnostic between them — let the exact oracle decide)."""
    snapped = relax.snap(params, problem)
    clocks = np.asarray(problem.clocks_mhz)
    idx = relax.nearest_clock_index(
        np.atleast_1d(snapped["clock_mhz"]).astype(np.float64), clocks
    )
    out: dict[tuple[int, float, bool], None] = {}
    for s in range(len(np.atleast_1d(snapped["clock_mhz"]))):
        w = int(np.atleast_1d(snapped["buswidth"])[s])
        c = bool(np.atleast_1d(snapped["compression"])[s])
        fi = int(idx[s])
        for j in range(max(0, fi - neighbours), min(clocks.size, fi + neighbours + 1)):
            out[(w, float(clocks[j]), c)] = None
    return list(out)


def _exact_config_energy(
    device: FpgaDevice, candidates: Sequence[tuple[int, float, bool]], torch_device
) -> list[float]:
    """Exact oracle values for config-energy candidates."""
    vals = []
    for w, f, c in candidates:
        g = config_phase_grid(device, (w,), (f,), (c,), device=torch_device)
        vals.append(float(g["config_energy_mj"].reshape(())))
    return vals


def _exact_adaptive_lifetime(
    device: FpgaDevice,
    item: WorkloadItem,
    candidates: Sequence[tuple[int, float, bool]],
    request_period_ms: float,
    e_budget_mj: float,
    method: IdlePowerMethod,
    powerup_overhead_mj: float,
    torch_device,
) -> list[float]:
    """Exact adaptive lifetimes via :func:`sweep_batch` one point at a time
    (bit-identical to the scalar oracle)."""
    vals = []
    for w, f, c in candidates:
        grid = SweepGrid(
            devices=(device,),
            buswidths=(w,),
            clocks_mhz=(f,),
            compression=(c,),
            request_periods_ms=(request_period_ms,),
            idle_methods=(method,),
            e_budgets_mj=(e_budget_mj,),
            base_item=item,
            powerup_overhead_mj=powerup_overhead_mj,
        )
        vals.append(float(sweep_batch(grid, device=torch_device)["adaptive_lifetime_ms"].reshape(())))
    return vals


def _pick(
    objective: str,
    candidates: list[tuple[int, float, bool]],
    exact_vals: list[float],
    maximize: bool,
    curve: np.ndarray,
    settings: DescentSettings,
    value_key: str,
) -> OptimizeResult:
    order = np.argsort(exact_vals)
    best_i = int(order[-1] if maximize else order[0])
    recs = [
        {
            "buswidth": w,
            "clock_mhz": f,
            "compression": c,
            value_key: v,
        }
        for (w, f, c), v in zip(candidates, exact_vals)
    ]
    return OptimizeResult(
        objective=objective,
        best=recs[best_i],
        candidates=sorted(recs, key=lambda r: r[value_key], reverse=maximize),
        loss_curve=curve,
        settings=settings,
        grid_points_considered=len(candidates),
    )


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------
def optimize_config(
    device: FpgaDevice,
    buswidths: Sequence[int] = SPI_BUSWIDTHS,
    clocks_mhz: Sequence[float] = SPI_CLOCKS_MHZ,
    settings: DescentSettings = DescentSettings(),
    torch_device="cuda",
    init_params: dict | None = None,
) -> OptimizeResult:
    """Find the minimum-configuration-energy legal setting by descent
    (Experiment 1's argmin, without sweeping the grid).

    The result's ``best`` is exact-oracle-valued; on the paper's Table-1
    grid it recovers the 11.85 mJ (quad, 66 MHz, compressed) optimum — the
    40.12× reduction — exactly.  ``init_params`` replaces the random starts.
    """
    problem = relax.RelaxedProblem.from_device(
        device, buswidths=buswidths, clocks_mhz=clocks_mhz, torch_device=torch_device
    )
    params, curve = _descend_core("config_energy", problem, settings, init_params=init_params)
    cands = _candidate_set(params, problem)
    vals = _exact_config_energy(device, cands, problem.torch_device)
    return _pick("config_energy", cands, vals, False, curve, settings, "config_energy_mj")


def optimize_lifetime(
    device: FpgaDevice,
    item: WorkloadItem | None = None,
    request_period_ms: float = 40.0,
    e_budget_mj: float = em.PAPER_ENERGY_BUDGET_MJ,
    method: IdlePowerMethod = IdlePowerMethod.METHOD1_2,
    powerup_overhead_mj: float = 0.0,
    buswidths: Sequence[int] = SPI_BUSWIDTHS,
    clocks_mhz: Sequence[float] = SPI_CLOCKS_MHZ,
    settings: DescentSettings = DescentSettings(),
    torch_device="cuda",
    init_params: dict | None = None,
) -> OptimizeResult:
    """Find the configuration maximizing the *adaptive* lifetime (Eqs. 3–4
    with the crossover rule choosing the strategy arm) at one workload
    point — the per-workload tuning loop, closed through gradients."""
    item = item if item is not None else paper_lstm_item()
    problem = relax.RelaxedProblem.from_device(
        device,
        item=item,
        buswidths=buswidths,
        clocks_mhz=clocks_mhz,
        request_period_ms=request_period_ms,
        e_budget_mj=e_budget_mj,
        idle_power_mw=(
            item.idle_power_mw
            if method is IdlePowerMethod.BASELINE
            else IDLE_POWER_MW[method]
        ),
        powerup_overhead_mj=powerup_overhead_mj,
        torch_device=torch_device,
    )
    params, curve = _descend_core("adaptive_lifetime", problem, settings, init_params=init_params)
    cands = _candidate_set(params, problem)
    vals = _exact_adaptive_lifetime(
        device, item, cands, request_period_ms, e_budget_mj, method, powerup_overhead_mj,
        problem.torch_device,
    )
    return _pick("adaptive_lifetime", cands, vals, True, curve, settings, "lifetime_ms")


def trace_config_frontier(
    device: FpgaDevice,
    lambdas: Sequence[float] = tuple(np.linspace(0.02, 0.98, 13)),
    buswidths: Sequence[int] = SPI_BUSWIDTHS,
    clocks_mhz: Sequence[float] = SPI_CLOCKS_MHZ,
    settings: DescentSettings = DescentSettings(n_starts=4),
    temperature: float = 1e-3,
    torch_device="cuda",
) -> dict:
    """Trace the (config energy, config time) Pareto frontier by descending
    λ-scalarizations — one multi-start chain per λ — then keep the exact
    non-dominated subset (:func:`repro_torch.core.pareto.pareto_mask_torch`).

    Returns ``{"points": [...], "lambdas": [...]}`` where each point also
    carries its differentiable frontier weight
    (:func:`repro_torch.core.pareto.soft_pareto_weight` at ``temperature``)
    — 1.0 means no other traced point comes close to dominating it.
    """
    lams = [float(x) for x in lambdas]
    if not lams:
        raise ValueError("need at least one λ to trace a frontier")
    problem = relax.RelaxedProblem.from_device(
        device, buswidths=buswidths, clocks_mhz=clocks_mhz, torch_device=torch_device
    )
    on = problem.torch_device
    seen: dict[tuple[int, float, bool], None] = {}
    for k, lam in enumerate(lams):
        params, _ = _descend_core(
            "config_scalarized",
            problem,
            dataclasses.replace(settings, seed=settings.seed + k),
            lam=lam,
        )
        for cand in _candidate_set(params, problem):
            seen[cand] = None
    cands = list(seen)
    points = []
    for w, f, c in cands:
        g = config_phase_grid(device, (w,), (f,), (c,), device=on)
        points.append(
            {
                "buswidth": w,
                "clock_mhz": f,
                "compression": c,
                "config_energy_mj": float(g["config_energy_mj"].reshape(())),
                "config_time_ms": float(g["config_time_ms"].reshape(())),
            }
        )
    costs = torch.as_tensor(
        [[p["config_energy_mj"], p["config_time_ms"]] for p in points], dtype=_F64, device=on
    )
    mask = pareto_mask_torch(costs).cpu().numpy()
    weight = soft_pareto_weight(costs, temperature).cpu().numpy()
    front = [
        {**p, "soft_weight": float(weight[i])}
        for i, p in enumerate(points)
        if mask[i]
    ]
    return {
        "lambdas": lams,
        "traced_points": len(points),
        "points": sorted(front, key=lambda r: r["config_energy_mj"]),
    }
