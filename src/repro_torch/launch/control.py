"""Day-sim CLI for the hierarchical serving control plane (port of
``repro.launch.control``).

Simulates a day of diurnal planet-scale traffic (a global
:class:`repro_torch.core.arrivals.DiurnalArrivals` stream with a
:class:`~repro_torch.core.arrivals.FlashCrowdArrivals` overlay) through the
device → rack → region hierarchy (:mod:`repro_torch.control`), with:

* rack-granularity idle-vs-off autoscaling by the paper's crossover rule,
* tenant admission via the budget planner (``--fleet-budget-mj``),
* failure injection through the heartbeat/elastic-restart machinery
  (``--faults``), and
* an energy/SLO Pareto sweep across control policies (always-on, the
  crossover rule, and fixed-timeout ski-rental variants).

Two self-checks gate the emit (the run exits with code 3 rather than
emitting a bad payload): a 1-region/1-rack hierarchy must reproduce
``run_routed`` bit-for-bit, and every level of the main run must conserve
requests exactly and energy within 1e-9.

    PYTHONPATH=src python -m repro_torch.launch.control --smoke             # JSON to stdout
    PYTHONPATH=src python -m repro_torch.launch.control --smoke --out build/control.json
    PYTHONPATH=src python -m repro_torch.launch.control --device cpu --smoke

Runs on the card (``--device cuda``, the default; raises on a host without
one); ``--device cpu`` runs the same program on the host.  The request
stream is drawn on the host from two ``torch.Generator``\\ s seeded from
``--seed`` through numpy's ``SeedSequence`` (the reference draws from a
split ``jax.random`` key), so the card and the CPU see one stream.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from repro_torch.launch._cli import Timer, emit, finish_payload, make_parser, powerup_overhead_mj

__all__ = ["main"]


def _global_counts(args, n_ticks: int, dt_ms: float, n_devices: int,
                   streams: int = 1) -> np.ndarray:
    """The global per-tick request stream: a diurnal carrier sized to
    ``--load`` of fleet capacity, plus a flash-crowd overlay.

    ``streams`` independent copies of each process, each at ``1/streams``
    of the rate, are drawn side by side and summed tick by tick (1, the
    CLI's own, is one stream of each): a stream is a loop over its gaps,
    so a planet-scale rate needs many of them.  The diurnal carrier is a
    Poisson process of a given rate curve, and a sum of such processes is
    one of the summed curve, so its distribution does not depend on
    ``streams``.  The flash crowds do: each stream's crowds are its own,
    so summed over many streams they are a flat uplift of the rate, not a
    crowd.  A crowd lasts ``flash_len`` arrivals at four times the
    carrier's rate, which at a fleet far wider than the CLI's is under a
    tick even in one stream.  The generators live on the host, so every
    device that runs the hierarchy sees the same counts."""
    import torch

    from repro_torch.core.arrivals import DiurnalArrivals, FlashCrowdArrivals, bin_arrival_counts
    from repro_torch.mc.ensemble import chunk_seed

    horizon_ms = n_ticks * dt_ms
    mean_ms = dt_ms / max(args.load * n_devices, 1e-9) * streams
    diurnal = DiurnalArrivals(
        mean_ms=mean_ms, day_ms=horizon_ms / args.days, amplitude=args.amplitude
    )
    # (seed, 0) the diurnal carrier, (seed, 1) the flash crowds
    g1 = torch.Generator().manual_seed(chunk_seed(args.seed, 0))
    g2 = torch.Generator().manual_seed(chunk_seed(args.seed, 1))
    times = diurnal.sample_batch(g1, streams, horizon_ms, include_origin=False)
    counts = bin_arrival_counts(times, horizon_ms, dt_ms).sum(dim=1, dtype=torch.int64)
    del times
    if args.flash_every > 0:
        flash = FlashCrowdArrivals(
            quiet_ms=mean_ms * 50.0,
            flash_gap_ms=mean_ms / 4.0,
            flash_len=args.flash_len,
            flash_every=args.flash_every,
        )
        times = flash.sample_batch(g2, streams, horizon_ms, include_origin=False)
        counts = counts + bin_arrival_counts(times, horizon_ms, dt_ms).sum(dim=1, dtype=torch.int64)
    return counts.numpy()


def _collapse_self_check(dt_ms: float, jit: bool, device="cuda") -> dict:
    """1-region/1-rack hierarchy vs the flat routed kernel, bit-for-bit —
    the differential spine, re-proven inside every payload."""
    import torch

    from repro_torch.control import run_hierarchy, uniform_topology
    from repro_torch.fleet.step import _np, run_routed

    topo = uniform_topology(1, 1, 8, request_period_ms=120.0, device=device)
    rack = topo.regions[0].racks[0]
    rng = np.random.default_rng(0)
    counts = rng.poisson(3.0, size=257).astype(np.int64)
    res = run_hierarchy(topo, counts, dt_ms=dt_ms, epoch_ticks=50, jit=jit)
    ref = run_routed(
        rack.params, counts, dt_ms=dt_ms, router=rack.router,
        queue_capacity=rack.queue_capacity, jit=jit,
    )
    state = res.racks[rack.name].state
    fields = (
        "energy_mj", "idle_energy_mj", "n_served", "n_configs",
        "n_released", "n_dropped", "completion_ms", "q_head", "q_len",
    )
    identical = all(
        torch.equal(getattr(ref.state, f), getattr(state, f)) for f in fields
    )
    lat_ok = np.array_equal(
        np.sort(_np(ref.latency_ms[ref.served_mask])), np.sort(res.latency_ms)
    )
    return {
        "bit_identical_to_run_routed": bool(identical),
        "latency_multiset_identical": bool(lat_ok),
        "served": int(ref.n_served.sum()),
    }


def _autoscaler_sweep(args):
    """The control-policy configurations the Pareto section compares."""
    from repro_torch.control import (
        CrossoverAutoscaler,
        PolicyAutoscaler,
        rack_break_even_ms,
        rack_idle_power_mw,
        rack_reconfig_energy_mj,
    )
    from repro_torch.core.adaptive import FixedTimeoutPolicy

    def fixed_factory(multiple):
        def factory(spec):
            t_be = rack_break_even_ms(
                rack_reconfig_energy_mj(spec), rack_idle_power_mw(spec)
            )
            return PolicyAutoscaler(
                FixedTimeoutPolicy(
                    timeout_ms=t_be * multiple,
                    idle_power_mw=rack_idle_power_mw(spec),
                )
            )
        return factory

    sweep = [("always_on", None), ("crossover", CrossoverAutoscaler.for_rack)]
    for m in (0.25, 1.0, 4.0):
        sweep.append((f"fixed_{m:g}x_break_even", fixed_factory(m)))
    return sweep


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.control",
        description="hierarchical control-plane day sim (JSON to stdout or --out)",
        calibrated_default=True,
    )
    ap.add_argument("--regions", type=int, default=2)
    ap.add_argument("--racks", type=int, default=2, help="racks per region")
    ap.add_argument("--devices", type=int, default=8, help="devices per rack")
    ap.add_argument("--ticks", type=int, default=86400, help="global clock ticks")
    ap.add_argument("--dt", type=float, default=100.0, help="tick length (ms)")
    ap.add_argument("--epoch-ticks", type=int, default=64,
                    help="control-plane decision interval (ticks)")
    ap.add_argument("--days", type=float, default=1.0,
                    help="diurnal cycles across the horizon")
    ap.add_argument("--load", type=float, default=0.5,
                    help="mean demand as a fraction of fleet serve capacity")
    ap.add_argument("--amplitude", type=float, default=0.8,
                    help="diurnal modulation depth (0..1)")
    ap.add_argument("--flash-every", type=float, default=64.0,
                    help="mean quiet arrivals between flash crowds (0 = none)")
    ap.add_argument("--flash-len", type=int, default=256,
                    help="arrivals per flash crowd")
    ap.add_argument("--period-ms", type=float, default=100.0,
                    help="declared per-device request period (device specs)")
    ap.add_argument("--bringup-ms", type=float, default=2000.0,
                    help="rack bring-up latency")
    ap.add_argument("--bringup-mj", type=float, default=200.0,
                    help="rack bring-up energy (the rack configuration phase)")
    ap.add_argument("--model-axis", type=int, default=2,
                    help="tensor-parallel width the elastic restart preserves")
    ap.add_argument("--faults", type=int, default=2,
                    help="random rack crashes to inject")
    ap.add_argument("--fleet-budget-mj", type=float, default=None,
                    help="tenant admission: planner-split fleet energy budget")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run (small topology, short horizon)")
    args = ap.parse_args(argv)

    if args.smoke:
        args.regions = min(args.regions, 2)
        args.racks = min(args.racks, 2)
        args.devices = min(args.devices, 4)
        args.ticks = min(args.ticks, 4096)
        args.epoch_ticks = min(args.epoch_ticks, 64)

    from repro_torch.control import (
        CrossoverAutoscaler,
        concat_params,
        hierarchy_report,
        pareto_section,
        random_schedule,
        run_hierarchy,
        slo_metrics,
        uniform_topology,
        verify_hierarchy,
    )

    jit = True
    overhead = powerup_overhead_mj(args)

    # idle_waiting devices: they never self-release, so the rack-level
    # idle-vs-off decision is the only one in play — the paper's trade-off
    # lifted one level up
    topo = uniform_topology(
        n_regions=args.regions,
        racks_per_region=args.racks,
        devices_per_rack=args.devices,
        strategies=("idle_waiting",),
        request_period_ms=args.period_ms,
        powerup_overhead_mj=overhead,
        bringup_ms=args.bringup_ms,
        bringup_mj=args.bringup_mj,
        model_axis=args.model_axis,
        device=args.device,
    )
    n_devices = topo.n_devices
    counts = _global_counts(args, args.ticks, args.dt, n_devices)

    planner_block = None
    if args.fleet_budget_mj is not None:
        from repro_torch.optimize.planner import plan_budgets

        flat = concat_params([r.params for r in topo.racks()])
        alloc = plan_budgets(
            flat, args.fleet_budget_mj, n_cap=args.ticks, objective="total_requests"
        )
        budgets = np.asarray(alloc.budgets_mj)
        offset = 0
        regions = []
        for region in topo.regions:
            racks = []
            for spec in region.racks:
                n = spec.n_devices
                racks.append(dataclasses.replace(
                    spec, params=spec.params.with_budgets(budgets[offset:offset + n])
                ))
                offset += n
            regions.append(dataclasses.replace(region, racks=tuple(racks)))
        topo = dataclasses.replace(topo, regions=tuple(regions))
        planner_block = {
            "objective": alloc.objective,
            "fleet_budget_mj": alloc.fleet_budget_mj,
            "admitted_devices": int(np.sum(np.asarray(alloc.n_items) > 0)),
            "planned_requests": int(np.sum(np.asarray(alloc.n_items))),
            "leftover_mj": float(alloc.leftover_mj),
        }

    faults = random_schedule(topo, args.ticks, args.faults, seed=args.seed)

    # ---- the main run: crossover autoscaler + faults -----------------------
    with Timer() as t_main:
        result = run_hierarchy(
            topo, counts, args.dt,
            epoch_ticks=args.epoch_ticks,
            autoscaler_factory=CrossoverAutoscaler.for_rack,
            faults=faults,
            heartbeat_timeout_s=max(2.0 * args.epoch_ticks * args.dt / 1000.0, 1e-3),
            jit=jit,
            rack_routing="pack",
            charge_idle_tail=True,
        )

    # ---- refuse-to-emit gates ----------------------------------------------
    collapse = _collapse_self_check(args.dt, jit, args.device)
    if not (collapse["bit_identical_to_run_routed"]
            and collapse["latency_multiset_identical"]):
        print("SELF-CHECK FAILED: hierarchy does not collapse onto run_routed "
              f"bit-for-bit: {collapse}", file=sys.stderr)
        raise SystemExit(3)
    try:
        conservation = verify_hierarchy(result)
    except AssertionError as e:
        print(f"SELF-CHECK FAILED: {e}", file=sys.stderr)
        raise SystemExit(3)

    # ---- energy/SLO Pareto sweep over control policies ---------------------
    points = []
    for name, factory in _autoscaler_sweep(args):
        sweep_res = run_hierarchy(
            topo, counts, args.dt,
            epoch_ticks=args.epoch_ticks,
            autoscaler_factory=factory,
            jit=jit,
            rack_routing="pack",
            charge_idle_tail=True,
        )
        sweep_res.assert_conserves()
        m = slo_metrics(sweep_res)
        points.append({
            "policy": name,
            "energy_mj": sweep_res.total_energy_mj,
            "latency_p99_ms": m["latency_p99_ms"],
            "drop_fraction": (
                sweep_res.dropped / sweep_res.arrived if sweep_res.arrived else 0.0
            ),
            "served_fraction": m["served_fraction"],
            "power_offs": sum(
                r.n_power_offs for r in sweep_res.racks.values()
            ),
        })
    pareto = pareto_section(points)

    device_ticks_per_s = (
        result.device_ticks / t_main.elapsed_s if t_main.elapsed_s > 0 else None
    )
    payload = {
        "kind": "control",
        "config": {
            "regions": args.regions,
            "racks_per_region": args.racks,
            "devices_per_rack": args.devices,
            "n_devices": n_devices,
            "ticks": args.ticks,
            "dt_ms": args.dt,
            "epoch_ticks": args.epoch_ticks,
            "load": args.load,
            "amplitude": args.amplitude,
            "days": args.days,
            "period_ms": args.period_ms,
            "bringup_ms": args.bringup_ms,
            "bringup_mj": args.bringup_mj,
            "model_axis": args.model_axis,
            "faults": args.faults,
            "fleet_budget_mj": args.fleet_budget_mj,
            "calibrated": args.calibrated,
            "seed": args.seed,
            "smoke": args.smoke,
        },
        "planner": planner_block,
        "report": hierarchy_report(result),
        "self_check": {
            "collapse": collapse,
            "conservation": conservation,
        },
        "pareto": pareto,
        "throughput": {
            "hierarchy": {
                "device_ticks": result.device_ticks,
                "elapsed_s": round(t_main.elapsed_s, 6),
                "device_ticks_per_s": (
                    round(device_ticks_per_s, 1) if device_ticks_per_s else None
                ),
            },
        },
    }
    finish_payload(payload, t_main.elapsed_s, device=args.device)
    emit(payload, args.out, "control payload", device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
