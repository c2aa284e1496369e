"""Observability CLI — one run, every lens: ledger, metrics, trace, report
(port of ``repro.launch.obs``).

Runs a mixed-strategy fleet twice (periodic duty-cycle + routed traffic),
pulls the phase-resolved :class:`~repro_torch.obs.ledger.EnergyLedger` off
each path, self-checks conservation against the paths' own energy totals
*and* the N=1 scalar oracle, fills a
:class:`~repro_torch.obs.metrics.MetricsRegistry`
from the routed run, exports a Chrome-trace/Perfetto timeline, and emits a
JSON report (plus optional markdown) stamped with the run manifest.

It also times an observability-*disabled* periodic run in the
``BENCH_fleet.json`` layout (``throughput.periodic.fleet.devices_per_s``),
so a regression check can assert the ledger/trace plumbing did not tax the
hot path; the timed region ends in a device synchronize.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.obs --smoke \
        --out OBS_report.json --md-out OBS_report.md --trace-out OBS_trace.json

Runs on the card (``--device cuda``, the default; raises on a host without
one); ``--device cpu`` runs the same program on the host.
"""
from __future__ import annotations

import math
import sys
import time

from repro_torch.launch._cli import emit, make_parser, powerup_overhead_mj


def _scalar_check(args) -> dict:
    """Scalar-oracle conservation: ``simulate``'s per-phase dict vs its own
    total, for both paper strategies."""
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.core.workload import ExperimentSpec, WorkloadSpec

    out = {}
    for strat in ("on_off", "idle_waiting"):
        spec = ExperimentSpec(
            workload=WorkloadSpec(args.budget_j, args.period_ms),
            item=paper_lstm_item(),
            strategy_kind=strat,
            method=IdlePowerMethod(args.method),
            powerup_overhead_mj=powerup_overhead_mj(args),
        )
        res = simulate(spec)
        out[f"scalar[{strat}]"] = res.ledger.assert_conserves(res.energy_used_mj)
    return out


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.obs",
        description="Phase-resolved observability report for one fleet run.",
        calibrated_default=True,
        out_default="OBS_report.json",
    )
    ap.add_argument("--devices", type=int, default=256)
    ap.add_argument("--horizon", type=float, default=10.0, help="simulated seconds")
    ap.add_argument("--period-ms", type=float, default=40.0)
    ap.add_argument("--method", default="method1+2",
                    choices=["baseline", "method1", "method1+2"])
    ap.add_argument("--router", default="round_robin",
                    choices=["round_robin", "least_loaded", "power_aware"])
    ap.add_argument("--budget-j", type=float, default=4147.0)
    ap.add_argument("--queue-capacity", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the Chrome-trace JSON timeline here")
    ap.add_argument("--md-out", default=None, metavar="PATH",
                    help="write the markdown report here")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: 64 devices")
    args = ap.parse_args(argv)
    if args.smoke:
        args.devices = min(args.devices, 64)
    if args.devices <= 0:
        raise SystemExit("--devices must be positive")

    import numpy as np

    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.device import resolve_device, synchronize
    from repro_torch.fleet import run_periodic, run_routed, uniform_fleet
    from repro_torch.fleet.step import _np
    from repro_torch.obs import routed_metrics, routed_timeline, run_report, trace_summary
    from repro_torch.obs.report import write_report

    device = resolve_device(args.device)
    horizon_ms = args.horizon * 1000.0
    n_steps = max(1, int(math.ceil(horizon_ms / args.period_ms)))
    params = uniform_fleet(
        args.devices,
        strategies=("on_off", "idle_waiting", "adaptive"),
        method=IdlePowerMethod(args.method),
        request_period_ms=args.period_ms,
        e_budget_mj=args.budget_j * 1000.0,
        powerup_overhead_mj=powerup_overhead_mj(args),
        device=device,
    )
    config = {
        k: getattr(args, k)
        for k in ("devices", "horizon", "period_ms", "method", "router",
                  "budget_j", "queue_capacity", "seed", "calibrated", "smoke")
    }

    # ---- periodic path: ledger + conservation -----------------------------
    pres = run_periodic(params, n_steps)
    pledger = pres.ledger()
    conservation = _scalar_check(args)
    p_energy = _np(pres.energy_mj)
    conservation["fleet_periodic"] = pledger.assert_conserves(p_energy)

    # ---- routed path: events on, metrics + timeline -----------------------
    counts = np.full(n_steps, args.devices, dtype=np.int32)  # 1 req/device/tick
    rres = run_routed(
        params, counts, args.period_ms, router=args.router,
        queue_capacity=args.queue_capacity,
        collect_latency=True, collect_events=True,
    )
    rledger = rres.ledger()
    r_energy = _np(rres.state.energy_mj)
    conservation["fleet_routed"] = rledger.assert_conserves(r_energy)
    # Both ledgers must be aggregated to scalars *before* adding: summing an
    # (N,)-shaped ledger with a scalar-aggregated one would broadcast the
    # aggregate onto every device row and count it N times.
    combined = pledger.aggregate() + rledger.aggregate()
    conservation["combined"] = combined.assert_conserves(
        float(np.sum(p_energy)) + float(np.sum(r_energy))
    )
    registry = routed_metrics(rres)
    recorder = routed_timeline(rres)
    chrome = recorder.to_chrome()
    if args.trace_out:
        recorder.write(args.trace_out)
        print(f"wrote trace to {args.trace_out}", file=sys.stderr)

    # ---- observability-disabled throughput (perf-regression layout) -------
    run_periodic(params, n_steps)                     # warm-up: capture once
    synchronize(device)
    t0 = time.perf_counter()
    run_periodic(params, n_steps)
    synchronize(device)
    elapsed = time.perf_counter() - t0
    throughput = {
        "periodic": {
            "fleet": {
                "elapsed_s": round(elapsed, 6),
                "devices": args.devices,
                "devices_per_s": round(args.devices / elapsed, 1)
                if elapsed > 0 else float("inf"),
                "device_steps_per_s": round(args.devices * n_steps / elapsed, 1)
                if elapsed > 0 else None,
            }
        }
    }

    report = run_report(
        ledger=combined,
        metrics=registry,
        summary={
            "n_steps": n_steps,
            "periodic": {
                "devices_alive_at_end": int(np.sum(_np(pres.alive))),
                "items_total": int(np.sum(_np(pres.n_items))),
                "energy_total_mj": float(np.sum(p_energy)),
            },
            "routed": {
                "router": args.router,
                "requests_served": int(np.sum(_np(rres.state.n_served))),
                "requests_dropped": int(np.sum(_np(rres.state.n_dropped))),
                "energy_total_mj": float(np.sum(r_energy)),
            },
        },
        trace=trace_summary(chrome),
        conservation=conservation,
        throughput=throughput,
        config=config,
    )
    emit(report, args.out, label="observability report", device=device)
    if args.md_out:
        write_report(report, md_out=args.md_out)
        print(f"wrote markdown report to {args.md_out}", file=sys.stderr)

    worst = max(conservation.values())
    print(
        f"obs: {args.devices} devices x {n_steps} steps on {device} | "
        f"conservation worst {worst:.2e} rel | "
        f"{report['trace']['n_events']} trace events | "
        f"{throughput['periodic']['fleet']['devices_per_s']} devices/s disabled-path"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
