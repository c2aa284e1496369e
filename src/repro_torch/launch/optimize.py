"""Configuration-optimizer + fleet-budget-planner CLI (port of
``repro.launch.optimize``; the JSON has the reference's keys).

Closes the loop the sweep CLI leaves open: instead of *enumerating* the
design space it *searches* it (:mod:`repro_torch.optimize.descent`) and
*allocates* over it (:mod:`repro_torch.optimize.planner`), then verifies
both against the exact engines.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.optimize                 # all sections, JSON to stdout
    PYTHONPATH=src python -m repro_torch.launch.optimize --out build/optimize.json
    PYTHONPATH=src python -m repro_torch.launch.optimize --section config,planner
    PYTHONPATH=src python -m repro_torch.launch.optimize --smoke         # CI-sized

Runs on the card (``--device cuda``, the default; raises on a host without
one); ``--device cpu`` runs the same program on the host.  The JSON goes to
stdout unless ``--out`` is given; the one-line summaries go to stderr.

Sections (``--section`` comma list, default all):

    config    descent vs the exhaustive Exp.-1 argmin (66 points) — the
              EXACT-agreement row: the gradient-found configuration must
              equal the sweep's 11.85 mJ / 40.13× optimum bit-for-bit
    lifetime  descent vs the full >100k-point strategy sweep's per-slice
              argmax (adaptive lifetime at the paper's operating point)
    densify   elapsed time of exhaustive sweep vs descent as the clock
              axis densifies (descent is O(1) in grid density)
    frontier  the (energy, time) Pareto front traced by λ-scalarized
              descent, cross-checked against the exact frontier
    planner   a shared fleet budget (4147 J × N, scaled) water-filled
              across a mixed-strategy fleet, replayed bit-for-bit through
              run_periodic on the fleet's device
"""
from __future__ import annotations

import sys
import time

from repro_torch.launch._cli import (
    Timer,
    emit,
    finish_payload,
    make_parser,
    parse_axis,
    powerup_overhead_mj,
    resolve_devices,
)

_SECTIONS = ("config", "lifetime", "densify", "frontier", "planner")


def _settings(args):
    from repro_torch.optimize import DescentSettings

    return DescentSettings(
        n_starts=args.starts, steps=args.steps, seed=args.seed
    )



def _section_config(args, device) -> dict:
    """Descent vs exhaustive argmin on the Table-1 grid (Exp. 1)."""
    import numpy as np

    from repro_torch.core.batch_eval import config_phase_grid
    from repro_torch.core.config_phase import (
        COMPRESSION_OPTIONS,
        SPI_BUSWIDTHS,
        SPI_CLOCKS_MHZ,
    )
    from repro_torch.optimize import optimize_config

    with Timer() as t_sweep:
        g = config_phase_grid(device, device=args.device)
        e = g["config_energy_mj"].cpu().numpy()
        ix = np.unravel_index(np.argmin(e), e.shape)
    sweep_best = {
        "buswidth": SPI_BUSWIDTHS[ix[1]],
        "clock_mhz": float(SPI_CLOCKS_MHZ[ix[2]]),
        "compression": bool(COMPRESSION_OPTIONS[ix[3]]),
        "config_energy_mj": float(e[ix]),
    }
    with Timer() as t_opt:
        res = optimize_config(device, settings=_settings(args), torch_device=args.device)
    exact = all(res.best[k] == sweep_best[k] for k in sweep_best)
    return {
        "device": device.name,
        "grid_points": int(e.size),
        "sweep_argmin": sweep_best,
        "descent_argmin": res.best,
        "exact_match": exact,
        "energy_reduction_x": float(e.max() / e.min()),
        "sweep_elapsed_s": round(t_sweep.elapsed_s, 6),
        "descent_elapsed_s": round(t_opt.elapsed_s, 6),
        "descent": res.to_json_dict(),
    }


def _paper_sweep_grid(args, devices):
    """The >100k-point strategy grid (bench_config_sweep's throughput grid)."""
    import numpy as np

    from repro_torch.core import energy_model as em
    from repro_torch.core.batch_eval import SweepGrid
    from repro_torch.core.strategies import IdlePowerMethod

    periods = tuple(np.linspace(10.0, 900.0, 6 if args.smoke else 90))
    return SweepGrid(
        devices=tuple(devices),
        request_periods_ms=periods,
        idle_methods=(
            IdlePowerMethod.BASELINE,
            IdlePowerMethod.METHOD1,
            IdlePowerMethod.METHOD1_2,
        ),
        e_budgets_mj=(1.0e6, em.PAPER_ENERGY_BUDGET_MJ, 1.0e7),
        powerup_overhead_mj=powerup_overhead_mj(args),
    )


def _section_lifetime(args, devices) -> dict:
    """Descent vs the full strategy sweep's argmax at the paper's point."""
    import numpy as np

    from repro_torch.core import energy_model as em
    from repro_torch.core.batch_eval import sweep_batch
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.optimize import optimize_lifetime

    grid = _paper_sweep_grid(args, devices)
    with Timer() as t_sweep:
        res = sweep_batch(grid, device=args.device)
        lt = res["adaptive_lifetime_ms"].cpu().numpy()

    # the paper's operating point: XC7S15, 40 ms, methods 1+2, 4147 J.
    # 40 ms is on the period axis only in the full grid; in --smoke the
    # coarse axis makes the nearest period the operating point instead.
    d_i = 0
    t_i = int(np.argmin(np.abs(np.asarray(grid.request_periods_ms) - 40.0)))
    m_i = grid.idle_methods.index(IdlePowerMethod.METHOD1_2)
    b_i = grid.e_budgets_mj.index(em.PAPER_ENERGY_BUDGET_MJ)
    sl = lt[d_i, :, :, :, t_i, m_i, b_i]
    ix = np.unravel_index(np.argmax(sl), sl.shape)
    sweep_best = {
        "buswidth": grid.buswidths[ix[0]],
        "clock_mhz": float(grid.clocks_mhz[ix[1]]),
        "compression": bool(grid.compression[ix[2]]),
        "lifetime_ms": float(sl[ix]),
    }
    period = float(grid.request_periods_ms[t_i])
    with Timer() as t_opt:
        opt = optimize_lifetime(
            devices[0],
            request_period_ms=period,
            e_budget_mj=em.PAPER_ENERGY_BUDGET_MJ,
            method=IdlePowerMethod.METHOD1_2,
            powerup_overhead_mj=powerup_overhead_mj(args),
            settings=_settings(args),
            torch_device=args.device,
        )
    exact = all(opt.best[k] == sweep_best[k] for k in sweep_best)
    return {
        "device": devices[0].name,
        "grid_points": grid.size,
        "operating_point": {
            "request_period_ms": period,
            "idle_method": "method1+2",
            "e_budget_mj": em.PAPER_ENERGY_BUDGET_MJ,
        },
        "sweep_argmax": sweep_best,
        "descent_argmax": opt.best,
        "exact_match": exact,
        "sweep_elapsed_s": round(t_sweep.elapsed_s, 6),
        "descent_elapsed_s": round(t_opt.elapsed_s, 6),
        "descent": opt.to_json_dict(),
    }


def _section_densify(args, device) -> dict:
    """Sweep cost grows linearly with clock density; descent's is constant.

    Each row densifies the clock axis (endpoints pinned to the legal
    min/max, so the true optimum stays a grid point), times the exhaustive
    config-energy argmin against descent, and asserts both name the same
    configuration.
    """
    import numpy as np
    import torch

    from repro_torch.core.batch_eval import config_phase_grid
    from repro_torch.core.config_phase import COMPRESSION_OPTIONS, SPI_BUSWIDTHS, SPI_CLOCKS_MHZ
    from repro_torch.optimize import optimize_config

    lo, hi = min(SPI_CLOCKS_MHZ), max(SPI_CLOCKS_MHZ)
    rows = []
    for n_clocks in [int(x) for x in parse_axis(args.densify)]:
        clocks = tuple(np.linspace(lo, hi, n_clocks))

        def argmin_sweep():
            g = config_phase_grid(device, clocks_mhz=clocks, device=args.device)
            e = g["config_energy_mj"]
            ix = np.unravel_index(int(torch.argmin(e)), e.shape)
            return float(e[ix]), ix

        argmin_sweep()   # warm caches/compilation so rows are comparable
        with Timer() as t_sweep:
            e, ix = argmin_sweep()
        sweep_best = {
            "buswidth": SPI_BUSWIDTHS[ix[1]],
            "clock_mhz": float(clocks[ix[2]]),
            "compression": bool(COMPRESSION_OPTIONS[ix[3]]),
            "config_energy_mj": e,
        }
        with Timer() as t_opt:
            res = optimize_config(device, clocks_mhz=clocks, settings=_settings(args),
                                  torch_device=args.device)
        rows.append(
            {
                "grid_points": 2 * len(SPI_BUSWIDTHS) * n_clocks,
                "sweep_elapsed_s": round(t_sweep.elapsed_s, 6),
                "descent_elapsed_s": round(t_opt.elapsed_s, 6),
                "descent_speedup_x": round(t_sweep.elapsed_s / t_opt.elapsed_s, 3)
                if t_opt.elapsed_s > 0 else None,
                "agree": all(res.best[k] == sweep_best[k] for k in sweep_best),
                "best_config_energy_mj": sweep_best["config_energy_mj"],
            }
        )
    return {"device": device.name, "rows": rows}


def _section_frontier(args, device) -> dict:
    """λ-scalarized descent traces the exact (energy, time) Pareto front."""
    from repro_torch.core.pareto import config_pareto
    from repro_torch.optimize import trace_config_frontier

    traced = trace_config_frontier(device, settings=_settings(args), torch_device=args.device)
    exact = config_pareto(device, device=args.device)
    exact_keys = {(r["buswidth"], r["clock_mhz"], r["compression"]) for r in exact}
    traced_keys = {
        (r["buswidth"], r["clock_mhz"], r["compression"]) for r in traced["points"]
    }
    return {
        "device": device.name,
        "traced": traced,
        "exact_frontier_size": len(exact),
        "traced_on_exact_frontier": len(traced_keys & exact_keys),
        "covers_exact_frontier": exact_keys <= traced_keys,
    }


def _section_planner(args) -> dict:
    """Shared fleet budget → per-device budgets → bit-for-bit replay."""
    import numpy as np

    from repro_torch.core import energy_model as em
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.device import synchronize
    from repro_torch.fleet import DeviceSpec, FleetParams
    from repro_torch.optimize import plan_budgets, replay_allocation

    item = paper_lstm_item()
    powerup = powerup_overhead_mj(args)
    template = [
        ("idle_waiting", 40.0, IdlePowerMethod.METHOD1_2),
        ("on_off", 80.0, IdlePowerMethod.BASELINE),
        ("adaptive", 120.0, IdlePowerMethod.METHOD1),
        ("idle_waiting", 200.0, IdlePowerMethod.BASELINE),
        ("adaptive", 500.0, IdlePowerMethod.METHOD1_2),
    ]
    specs = [
        DeviceSpec(
            item=item,
            strategy=s,
            method=m,
            request_period_ms=p,
            powerup_overhead_mj=powerup,
        )
        for s, p, m in template
    ]
    n = args.fleet_devices
    params = FleetParams.from_specs(specs, args.device).tile(n)
    horizon_ms = args.fleet_horizon_s * 1000.0
    caps = np.maximum(
        np.floor(horizon_ms / params.period_ms.cpu().numpy()), 0.0
    ).astype(np.int64)
    fleet_budget = n * em.PAPER_ENERGY_BUDGET_MJ * args.budget_scale
    out = {
        "devices": n,
        "horizon_s": args.fleet_horizon_s,
        "fleet_budget_mj": fleet_budget,
        "budget_scale": args.budget_scale,
        "objectives": {},
    }
    for objective in ("min_lifetime", "total_requests"):
        with Timer() as t_plan:
            alloc = plan_budgets(params, fleet_budget, caps, objective=objective)
        with Timer() as t_replay:
            rep = replay_allocation(params, alloc)
            synchronize(args.device)
        summary = alloc.to_json_dict(limit=8)
        summary["plan_elapsed_s"] = round(t_plan.elapsed_s, 6)
        summary["replay"] = {
            "n_steps": rep["n_steps"],
            "n_items_match": rep["n_items_match"],
            "lifetime_max_rel_err": rep["lifetime_max_rel_err"],
            "energy_max_rel_err": rep["energy_max_rel_err"],
            "exact": rep["exact"],
            "elapsed_s": round(t_replay.elapsed_s, 6),
        }
        out["objectives"][objective] = summary
    return out


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.optimize",
        description="Gradient configuration optimizer + fleet budget planner.",
        calibrated_default=True,
    )
    ap.add_argument("--section", default="all",
                    help=f"comma list of {','.join(_SECTIONS)} (or 'all')")
    ap.add_argument("--devices", default="both",
                    help="device names for the sweep comparisons (or 'both'); "
                         "the descent sections optimize the first one")
    ap.add_argument("--starts", type=int, default=16, help="multi-start chains")
    ap.add_argument("--steps", type=int, default=250, help="Adam steps per chain")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--densify", default="11,101,10001,1000001",
                    help="clock-axis densities for --section densify")
    ap.add_argument("--fleet-devices", type=int, default=64)
    ap.add_argument("--fleet-horizon-s", type=float, default=3600.0,
                    help="planner traffic horizon (seconds)")
    ap.add_argument("--budget-scale", type=float, default=0.05,
                    help="fleet budget = N × 4147 J × scale (scarcity knob)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: fewer starts/steps, coarse grids")
    args = ap.parse_args(argv)

    if args.smoke:
        args.starts = min(args.starts, 6)
        args.steps = min(args.steps, 120)
        args.densify = "11,101,1001"
        args.fleet_devices = min(args.fleet_devices, 16)

    sections = _SECTIONS if args.section == "all" else tuple(args.section.split(","))
    unknown = set(sections) - set(_SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; choose from {_SECTIONS}")

    from repro_torch.device import resolve_device

    args.device = resolve_device(args.device)
    devices = resolve_devices(args.devices)
    payload: dict = {"kind": "optimize", "sections": list(sections)}
    t0 = time.perf_counter()
    for section in sections:
        if section == "config":
            payload["config"] = _section_config(args, devices[0])
        elif section == "lifetime":
            payload["lifetime"] = _section_lifetime(args, devices)
        elif section == "densify":
            payload["densify"] = _section_densify(args, devices[0])
        elif section == "frontier":
            payload["frontier"] = _section_frontier(args, devices[0])
        else:
            payload["planner"] = _section_planner(args)

    finish_payload(
        payload,
        time.perf_counter() - t0,
        calibrated=bool(args.calibrated),
        smoke=bool(args.smoke),
        device=str(args.device),
    )
    emit(payload, args.out, label="optimize report", device=args.device)

    for name in ("config", "lifetime"):
        if name in payload:
            s = payload[name]
            print(
                f"{name}: descent == {s['grid_points']}-point sweep argmin: "
                f"{s['exact_match']} ({s['descent_argmax' if name == 'lifetime' else 'descent_argmin']})",
                file=sys.stderr,
            )
    if "planner" in payload:
        for obj, s in payload["planner"]["objectives"].items():
            print(
                f"planner[{obj}]: {s['total_requests']} requests, "
                f"min lifetime {s['min_lifetime_ms']:.0f} ms, "
                f"replay exact: {s['replay']['exact']}",
                file=sys.stderr,
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
