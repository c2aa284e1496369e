"""Pareto-frontier extraction and crossover surfaces over batch-sweep grids
(port of ``repro.core.pareto``).

The paper picks *one* optimum per experiment (minimum-energy configuration,
best idle method, the 499.06 ms crossover).  Once the design space is a
dense grid (:mod:`repro_torch.core.batch_eval`), the interesting objects are
*sets* and *surfaces*:

* the **Pareto frontier** of (config energy, config time) over the
  Table-1 parameter space — which settings are worth considering at all;
* the **strategy frontier** of (energy/item, latency, −lifetime) across
  request periods and idle methods;
* the **crossover surface** T_cross(device, buswidth, clock, compression,
  P_idle) — how the Idle-Waiting/On-Off switching point moves as the
  configuration phase is optimized (the paper's 89.21 → 499.06 ms shift,
  as a function rather than two endpoints).

Dominance is one broadcast comparison of a chunk of candidates against
every point, on the device that holds the costs, so frontier extraction
over 10⁵+ points stays tensor-shaped end to end with a (chunk × N)
intermediate.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.batch_eval import (
    GridResult,
    _arr,
    _crossover,
    _div,
    _py_sum,
    config_phase_grid,
)
from repro_torch.core.config_phase import (
    COMPRESSION_OPTIONS,
    SPI_BUSWIDTHS,
    SPI_CLOCKS_MHZ,
    FpgaDevice,
)
from repro_torch.core.phases import CONFIGURATION, WorkloadItem
from repro_torch.device import resolve_device

__all__ = [
    "pareto_mask",
    "pareto_mask_torch",
    "soft_pareto_weight",
    "pareto_points",
    "config_pareto",
    "strategy_pareto",
    "crossover_surface",
]

_CHUNK = 2048


def _dominated(cands: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(c,) bool: candidate i is dominated iff some point is ≤ in every
    objective and < in at least one; one objective at a time keeps the
    intermediate at (c × N) booleans."""
    le = torch.ones((cands.shape[0], pts.shape[0]), dtype=torch.bool, device=pts.device)
    lt = torch.zeros_like(le)
    for k in range(pts.shape[1]):
        col, x = pts[:, k][None, :], cands[:, k][:, None]
        le &= col <= x
        lt |= col < x
    return (le & lt).any(dim=1)


def pareto_mask_torch(costs: torch.Tensor) -> torch.Tensor:
    """Non-dominated mask over an ``(N, K)`` cost tensor, minimizing every
    column, in one (N × N) comparison on the tensor's device — the core of
    :func:`pareto_mask` for callers that already hold a small tensor."""
    return ~_dominated(costs, costs)


def pareto_mask(costs, chunk: int = _CHUNK, device=None) -> torch.Tensor:
    """Non-dominated mask over ``costs`` of shape (N, K), minimizing every
    column (see :func:`pareto_mask_torch` for the dominance rule), as a bool
    tensor on the device it ran on: ``costs``' own device for a tensor,
    else ``device`` (default ``"cuda"``).

    Candidates go in chunks of ``chunk``, in lexicographic order of their
    costs, each compared with its own chunk and with the frontier found so
    far: a point that dominates another precedes it in that order, and a
    dominated point is dominated by some frontier point (dominance is a
    strict partial order), so the mask equals the all-pairs one while the
    work is O(N · (chunk + frontier)) and the intermediate at most
    (chunk × (chunk + frontier)) booleans.
    """
    if device is None:
        device = costs.device if isinstance(costs, torch.Tensor) else "cuda"
    c = _arr(costs, resolve_device(device))
    if c.ndim != 2:
        raise ValueError(f"costs must be (N, K), got shape {tuple(c.shape)}")
    n = c.shape[0]
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=c.device)
    order = torch.arange(n, device=c.device)
    for k in reversed(range(c.shape[1])):
        order = order[torch.sort(c[order, k], stable=True).indices]
    s = c[order]
    keep = torch.empty(n, dtype=torch.bool, device=c.device)
    front = s[:0]
    for i in range(0, n, chunk):
        cand = s[i : i + chunk]
        kept = ~_dominated(cand, torch.cat([front, cand]))
        keep[i : i + chunk] = kept
        front = torch.cat([front, cand[kept]])
    mask = torch.empty_like(keep)
    mask[order] = keep
    return mask


def soft_pareto_weight(costs: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Differentiable relaxation of Pareto-frontier membership, shape (N,).

    For each ordered pair (i, j), ``m_ij = max_k (c_jk − c_ik)`` is the
    margin by which *j* fails to dominate *i*.  The weight

        w_i = Π_{j≠i} σ(m_ij / τ)

    is 1 when no point comes close to dominating *i* and → 0 as some *j*
    dominates it; as ``τ → 0`` it approaches the hard
    :func:`pareto_mask_torch` (up to ties).  Autograd flows through the
    costs, so an optimizer can pull a design toward the frontier.
    """
    c = torch.as_tensor(costs)
    if c.ndim != 2:
        raise ValueError(f"costs must be (N, K), got shape {tuple(c.shape)}")
    margins = torch.amax(c[None, :, :] - c[:, None, :], dim=-1)   # (N, N): m_ij
    s = torch.sigmoid(margins / temperature)
    # a point never dominates itself: force the diagonal factor to 1
    s = torch.where(torch.eye(c.shape[0], dtype=torch.bool, device=c.device), 1.0, s)
    return torch.prod(s, dim=1)


def pareto_points(
    records: Sequence[dict],
    objectives: Sequence[str],
    maximize: Sequence[str] = (),
    device="cuda",
) -> list[dict]:
    """Filter a record list (e.g. :meth:`GridResult.to_records`) to its
    Pareto-optimal subset.  ``objectives`` are minimized except those also
    named in ``maximize``."""
    if not objectives:
        raise ValueError("need at least one objective")
    cols = []
    for key in objectives:
        sign = -1.0 if key in maximize else 1.0
        cols.append([sign * float(r[key]) for r in records])
    mask = pareto_mask(np.asarray(cols).T.reshape(len(records), len(objectives)),
                       device=device).cpu().numpy()
    return [r for r, keep in zip(records, mask) if keep]


# ---------------------------------------------------------------------------
# Frontiers of the paper's two design spaces
# ---------------------------------------------------------------------------
def config_pareto(
    devices: Sequence[FpgaDevice] | FpgaDevice,
    device="cuda",
    **grid_kwargs,
) -> list[dict]:
    """(config energy, config time) Pareto frontier of the Table-1 space.

    Returns records with the axis labels plus both objectives, sorted by
    energy.  The paper's best setting (quad/66 MHz/compressed) is always a
    member — it minimizes both objectives at once on the calibrated model.
    """
    if isinstance(devices, FpgaDevice):
        devices = (devices,)
    g = config_phase_grid(devices, device=device, **grid_kwargs)
    energy = g["config_energy_mj"].cpu().numpy()
    time_ms = g["config_time_ms"].cpu().numpy()
    axes = {
        "device": [d.name for d in devices],
        "buswidth": list(grid_kwargs.get("buswidths", SPI_BUSWIDTHS)),
        "clock_mhz": list(grid_kwargs.get("clocks_mhz", SPI_CLOCKS_MHZ)),
        "compression": [bool(c) for c in grid_kwargs.get("compression", COMPRESSION_OPTIONS)],
    }
    idx = np.indices(energy.shape).reshape(energy.ndim, -1).T
    records = []
    for ix in map(tuple, idx):
        rec = {name: vals[ix[i]] for i, (name, vals) in enumerate(axes.items())}
        rec["config_energy_mj"] = float(energy[ix])
        rec["config_time_ms"] = float(time_ms[ix])
        records.append(rec)
    front = pareto_points(records, ("config_energy_mj", "config_time_ms"), device=device)
    return sorted(front, key=lambda r: r["config_energy_mj"])


def strategy_pareto(result: GridResult, strategy: str = "iw") -> list[dict]:
    """(energy/item ↓, request period ↓, lifetime ↑) frontier of a sweep.

    ``strategy`` ∈ {'iw', 'onoff', 'adaptive'}.  Only feasible grid points
    compete.  The frontier is found on the device that holds the sweep;
    records are built for its members only.
    """
    if strategy not in ("iw", "onoff", "adaptive"):
        raise ValueError(f"unknown strategy {strategy!r}; use 'iw', 'onoff' or 'adaptive'")
    shape = result.grid.shape

    def flat(key):
        return result[key].expand(shape).reshape(-1)

    def arm(key):
        # adaptive inherits the winning static arm's quantities per point
        if strategy == "adaptive":
            return torch.where(flat("adaptive_picks_iw"), flat(f"iw_{key}"), flat(f"onoff_{key}"))
        return flat(f"{strategy}_{key}")

    feasible = arm("feasible")
    periods = _arr(result.grid.request_periods_ms, feasible.device)
    period = periods.reshape((1, 1, 1, 1, -1, 1, 1)).expand(shape).reshape(-1)
    keep = torch.nonzero(feasible).reshape(-1)
    if keep.numel() == 0:
        return []
    costs = torch.stack(
        [arm("energy_per_item_mj")[keep], period[keep], -arm("lifetime_ms")[keep]], dim=1
    )
    members = keep[pareto_mask(costs)].cpu().numpy()
    records = []
    for r in result.records_at(members):
        a = strategy if strategy != "adaptive" else ("iw" if r["adaptive_picks_iw"] else "onoff")
        r["energy_per_item_mj"] = r[f"{a}_energy_per_item_mj"]
        r["lifetime_ms"] = r[f"{a}_lifetime_ms"]
        r["n_max"] = r[f"{a}_n_max"]
        records.append(r)
    return sorted(records, key=lambda r: r["request_period_ms"])


def crossover_surface(
    item: WorkloadItem,
    devices: Sequence[FpgaDevice] | FpgaDevice,
    idle_powers_mw: Sequence[float],
    buswidths=None,
    clocks_mhz=None,
    compression=None,
    powerup_overhead_mj: float = 0.0,
    device="cuda",
) -> dict:
    """T_cross as a function of (device, buswidth, clock, compression,
    idle power): a tensor of shape ``(D, W, F, C, P)`` on ``device``.

    The configuration phase of ``item`` is replaced per grid point by the
    device model (same derivation — average-power round trip, left-fold
    phase sums — as :func:`~repro_torch.core.batch_eval.sweep_batch`, so
    the values are bit-identical to that engine's ``crossover_ms``);
    execution phases are held fixed.  This is the surface the paper samples
    at two points: 89.21 ms (baseline idle power) and 499.06 ms (methods
    1+2).
    """
    if isinstance(devices, FpgaDevice):
        devices = (devices,)
    buswidths = SPI_BUSWIDTHS if buswidths is None else tuple(buswidths)
    clocks_mhz = SPI_CLOCKS_MHZ if clocks_mhz is None else tuple(clocks_mhz)
    compression = COMPRESSION_OPTIONS if compression is None else tuple(compression)
    if len(idle_powers_mw) == 0:
        raise ValueError(
            "crossover_surface(): idle_powers_mw is empty — pass at least one "
            "idle power (e.g. the Table-3 methods 134.3/34.2/24.0 mW)"
        )
    device = resolve_device(device)

    # T_cross depends only on the per-point On-Off item energy and the idle
    # power — the config grid plus one broadcast axis, no strategy sweep.
    g = config_phase_grid(devices, buswidths, clocks_mhz, compression, device=device)
    t_config = g["config_time_ms"]                                       # (D,W,F,C)
    e_config = _div(g["config_power_mw"] * t_config, 1000.0)             # phase round trip
    e_total = _py_sum([e_config] + [_arr(ph.energy_mj, device).expand(e_config.shape)
                                    for ph in item.phases if ph.name != CONFIGURATION])
    e_onoff = e_total + _arr(powerup_overhead_mj, device)
    p_idle = _arr([float(p) for p in idle_powers_mw], device)            # (P,)
    cross = _crossover(
        e_onoff[..., None],
        _arr(item.execution_energy_mj, device),
        _arr(item.execution_time_ms, device),
        p_idle,
    )
    return {
        "axes": {
            "device": [d.name for d in devices],
            "buswidth": list(buswidths),
            "clock_mhz": list(clocks_mhz),
            "compression": [bool(c) for c in compression],
            "idle_power_mw": [float(p) for p in idle_powers_mw],
        },
        "crossover_ms": cross.expand(e_onoff.shape + (len(p_idle),)).contiguous(),
    }
