"""Fleet simulation CLI — thousands of devices advanced tick by tick on the
card (port of ``repro.launch.fleet``).

Runs a mixed-strategy fleet under routed traffic (or the paper's periodic
duty-cycle mode), reduces it with :mod:`repro_torch.fleet.metrics`, and
emits a ``BENCH_fleet.json`` artifact containing the summary plus a
throughput comparison against the *looped* scalar baseline (one Python
``simulate_trace`` per device over the identical arrival streams), and an
N=1 self-check against the scalar ``simulate()`` oracle.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.fleet --devices 4096 --horizon 10
    PYTHONPATH=src python -m repro_torch.launch.fleet --devices 64 --horizon 10 --smoke
    PYTHONPATH=src python -m repro_torch.launch.fleet --mode periodic \
        --devices 1024 --horizon 60 --budget-j 50
    PYTHONPATH=src python -m repro_torch.launch.fleet --router power_aware \
        --process poisson --load 0.5

Runs on the card (``--device cuda``, the default, with the tick loop in
CUDA graphs; raises on a host without one); ``--device cpu`` runs the same
program on the host.  ``--smoke`` shrinks the looped baseline and
self-check so the whole thing finishes in seconds.  ``--models`` runs a
heterogeneous fleet from the cost zoo (:mod:`repro_torch.costs`) and
``--n-seeds`` adds an ``uncertainty`` section from the Monte Carlo engine
(:mod:`repro_torch.mc`).

``--mesh F`` / ``FxS`` / ``auto`` runs the sharded periodic kernel
(:mod:`repro_torch.fleet.shard`) over a ``("fleet", "seed")`` mesh: the CLI
spawns its ``F·S`` ranks itself (:func:`repro_torch.distributed.ranks.spawn`;
gloo, host-staged collectives), every rank on the card — all of them on
``cuda:0`` of a one-card machine — or with ``--device cpu`` on the host;
rank 0 runs the unsharded sections and writes the payload, whose sharded
blocks carry the runtime (``ranks``, ``backend``, ``staged``,
``ranks_per_card``, ``spawn_s``).  ``--acceptance-devices N`` adds the
reference's full-budget lifetime scan at N devices, and the port also
replays it unsharded on rank 0 and records whether the two agree bit for
bit.  With several ranks on one card the rates measure the runtime, not
scale-out.

    PYTHONPATH=src python -m repro_torch.launch.fleet --device cpu --smoke \
        --mesh 2 --acceptance-devices 4096
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import torch

from repro_torch.launch._cli import emit, make_parser, powerup_overhead_mj


def _build_params(args, device):
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.fleet import uniform_fleet

    if args.models:
        # heterogeneous model fleet from the cost zoo; each device's request
        # period comes from its model's latency (see repro_torch.costs)
        from repro_torch.costs import model_mix_fleet
        from repro_torch.launch.costs import parse_models

        return model_mix_fleet(
            parse_models(args.models),
            n_devices=args.devices,
            device=device,
            strategy="adaptive" if args.strategy == "mix" else args.strategy,
            e_budget_mj=args.budget_j * 1000.0,
            powerup_overhead_mj=powerup_overhead_mj(args),
        )
    strategies = (
        ("on_off", "idle_waiting", "adaptive")
        if args.strategy == "mix"
        else (args.strategy,)
    )
    return uniform_fleet(
        args.devices,
        item=paper_lstm_item(),
        strategies=strategies,
        method=IdlePowerMethod(args.method),
        request_period_ms=args.period_ms,
        e_budget_mj=args.budget_j * 1000.0,
        powerup_overhead_mj=powerup_overhead_mj(args),
        device=device,
    )


def _global_stream(args, n_steps: int):
    """Per-tick global request counts at ``--load`` requests/device/period."""
    import numpy as np

    rate_per_tick = args.devices * args.load * args.dt_ms / args.period_ms
    if args.process == "poisson":
        rng = np.random.default_rng(args.seed)
        return rng.poisson(rate_per_tick, n_steps).astype(np.int32)
    if args.process == "mmpp":
        # global stream modulated 2-state: bursts at 16x the quiet rate,
        # normalized so the mixture mean equals the requested --load
        rng = np.random.default_rng(args.seed)
        burst = rng.random(n_steps) < 0.25
        lam = np.where(burst, 4.0, 0.25) * (rate_per_tick / 1.1875)
        return rng.poisson(lam).astype(np.int32)
    # deterministic: Bresenham on the cumulative count → exact totals
    cum = np.floor(rate_per_tick * np.arange(1, n_steps + 1) + 1e-9)
    return np.diff(cum, prepend=0.0).astype(np.int32)


def _baseline_loop(args, counts, n_baseline: int) -> tuple[float, int]:
    """Python loop: one scalar ``simulate_trace`` per device over the same
    routed streams.  Returns (elapsed_s, requests_served)."""
    import numpy as np

    from repro_torch.core.adaptive import StaticPolicy
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.simulator import simulate_trace
    from repro_torch.core.strategies import IdlePowerMethod

    item = paper_lstm_item()
    powerup = powerup_overhead_mj(args)
    strategies = (
        ("on_off", "idle_waiting", "adaptive")
        if args.strategy == "mix"
        else (args.strategy,)
    )
    method = IdlePowerMethod(args.method)
    # pre-split the global stream request-wise round-robin across the
    # baseline devices (outside the timed region: routing is the fleet
    # kernel's job) — with counts == n_baseline per tick this gives every
    # device exactly one request per period, the fleet devices' workload
    k = np.arange(len(counts), dtype=np.float64)
    tick_times = k * args.dt_ms
    req_times = np.repeat(tick_times, counts)
    dev_of_req = np.arange(req_times.size) % max(n_baseline, 1)

    from repro_torch.core.adaptive import FixedTimeoutPolicy, break_even_timeout_ms
    from repro_torch.core.strategies import IdleWaitingStrategy

    p_idle = IdleWaitingStrategy(item, powerup, method=method).idle_power_mw

    served = 0
    t0 = time.perf_counter()
    for d in range(n_baseline):
        strat = strategies[d % len(strategies)]
        if strat == "adaptive":
            policy = FixedTimeoutPolicy(
                break_even_timeout_ms(item, p_idle, powerup), p_idle
            )
        else:
            policy = StaticPolicy(strat, item, method=method)
        res = simulate_trace(
            item,
            req_times[dev_of_req == d],
            policy,
            e_budget_mj=args.budget_j * 1000.0,
            powerup_overhead_mj=powerup,
        )
        served += res.n_items
    return time.perf_counter() - t0, served


def _uncertainty_section(args, params, n_steps: int) -> dict:
    """CI-banded fleet metrics: ``--n-seeds`` periodic-mode replications
    through the Monte Carlo engine (:mod:`repro_torch.mc`), with the request
    stream matching ``--process`` (plus ``--jitter`` timing noise in the
    deterministic case — 0 keeps every band collapsed on the exact
    duty-cycle numbers)."""
    import numpy as np

    from repro_torch.core.arrivals import JitteredArrivals, MMPPArrivals, PoissonArrivals
    from repro_torch.fleet.step import _np
    from repro_torch.mc import ci_dict, run_periodic_ensemble, welford_interval

    # heterogeneous model fleets: the process carries the traffic *shape*
    # at the fleet-mean period; per-device rates come from rescaling
    t = float(_np(params.period_ms).mean()) if args.models else args.period_ms
    if args.process == "poisson":
        process = PoissonArrivals(t)
    elif args.process == "mmpp":
        # stationary mean pinned at the device period: (8·t/2 + 5t)/9 = t
        process = MMPPArrivals(burst_ms=t / 2.0, quiet_ms=5.0 * t)
    else:
        process = JitteredArrivals(t, args.jitter)
    ens = run_periodic_ensemble(
        params, process, n_steps, args.n_seeds, seed=args.seed,
        scale_to_device_periods=bool(args.models),
    )

    dev = welford_interval(ens.device_lifetime_ms)
    return {
        "process": process.name,
        "jitter": args.jitter if process.name == "jittered" else None,
        "n_seeds": ens.n_seeds,
        "n_steps": ens.n_steps,
        "lifetime_ms": ci_dict(ens.lifetime_ms),
        "energy_per_request_mj": ci_dict(ens.energy_per_request_mj),
        "total_items": ci_dict(ens.total_items),
        "per_device_lifetime_ms": {
            "mean_range": [float(np.min(dev["mean"])), float(np.max(dev["mean"]))],
            "std_range": [float(np.min(dev["std"])), float(np.max(dev["std"]))],
        },
    }


def _oracle_self_check(args, max_steps: int, device) -> dict:
    """N=1 periodic fleet vs the scalar ``simulate()`` oracle (artifact
    self-verification; cheap)."""
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.simulator import simulate
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.core.workload import ExperimentSpec, WorkloadSpec
    from repro_torch.fleet import DeviceSpec, FleetParams, run_periodic

    item = paper_lstm_item()
    powerup = powerup_overhead_mj(args)
    out = {}
    for strat in ("on_off", "idle_waiting"):
        spec = ExperimentSpec(
            workload=WorkloadSpec(args.budget_j, args.period_ms),
            item=item,
            strategy_kind=strat,
            method=IdlePowerMethod(args.method),
            powerup_overhead_mj=powerup,
        )
        oracle = simulate(spec)
        fleet = run_periodic(
            FleetParams.from_specs([DeviceSpec.from_experiment(spec)], device),
            n_steps=min(max(oracle.n_items + 1, 1), max_steps),
        )
        horizon_limited = fleet.n_steps <= oracle.n_items
        n_fleet, e_fleet = int(fleet.n_items[0]), float(fleet.energy_mj[0])
        out[strat] = {
            "n_oracle": oracle.n_items,
            "n_fleet": n_fleet,
            "energy_abs_diff_mj": (
                None if horizon_limited else abs(e_fleet - oracle.energy_used_mj)
            ),
            "agrees": horizon_limited or (
                n_fleet == oracle.n_items and e_fleet == oracle.energy_used_mj
            ),
        }
    return out


def _timed(fn, device):
    from repro_torch.device import synchronize

    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def _tp(elapsed_s, n_devices, steps):
    per_s = n_devices / elapsed_s if elapsed_s > 0 else float("inf")
    return {
        "elapsed_s": round(elapsed_s, 6),
        "devices": n_devices,
        "devices_per_s": round(per_s, 1),
        "device_steps_per_s": round(n_devices * steps / elapsed_s, 1)
        if elapsed_s > 0 else None,
    }


def _unsharded_sections(args, params, payload, device, n_steps, n_steps_p, n_baseline):
    """The fleet run, its summary and the throughput blocks against the
    looped baseline (rank 0 only); returns the unsharded periodic result
    the sharded kernel is held to."""
    import numpy as np

    from repro_torch.fleet import fleet_summary, run_periodic, run_routed

    timed = lambda fn: _timed(fn, device)  # noqa: E731

    if args.mode == "periodic":
        run = lambda: run_periodic(params, n_steps)  # noqa: E731
    else:
        counts = _global_stream(args, n_steps)
        run = lambda: run_routed(  # noqa: E731
            params, counts, args.dt_ms, router=args.router,
            queue_capacity=args.queue_capacity,
            collect_latency=args.collect_latency,
        )

    run()                                   # warm-up: capture and caches once
    result, fleet_elapsed = timed(run)

    payload["summary"] = fleet_summary(result)
    payload["n_steps"] = n_steps

    # ---- throughput: vectorized fleet vs looped scalar baseline ------------
    # The baseline loops one Python `simulate_trace` per device over that
    # device's *fair share* of traffic (the identical per-device workload a
    # fleet device sees), so devices/sec extrapolates honestly to the full
    # fleet.  The headline comparison runs the periodic kernel — the mode
    # whose per-device semantics equal the scalar oracle's — and, when the
    # routed mode was requested, its numbers are reported alongside.
    if args.mode == "periodic":
        periodic_elapsed = fleet_elapsed
        periodic_result = result
    else:
        run_periodic(params, n_steps_p)     # warm-up
        periodic_result, periodic_elapsed = timed(lambda: run_periodic(params, n_steps_p))

    fleet_tp = _tp(periodic_elapsed, args.devices, n_steps_p)
    if args.models:
        # no looped baseline: the scalar loop simulates the paper item, not
        # the model mix — a same-workload comparison doesn't exist here
        payload["throughput"] = {"periodic": {"fleet": fleet_tp}}
    else:
        saved_dt = args.dt_ms
        args.dt_ms = args.period_ms
        base_elapsed, base_served = _baseline_loop(
            args, np.full(n_steps_p, n_baseline, dtype=np.int32), n_baseline
        )
        args.dt_ms = saved_dt

        base_tp = _tp(base_elapsed, n_baseline, n_steps_p)
        base_tp["requests_served"] = base_served
        payload["throughput"] = {
            "periodic": {
                "fleet": fleet_tp,
                "looped_baseline": base_tp,
                "speedup_devices_per_s": round(
                    fleet_tp["devices_per_s"] / base_tp["devices_per_s"], 1
                ) if base_tp["devices_per_s"] else None,
            },
        }
    if args.mode == "routed" and not args.models:
        base_args = argparse.Namespace(**vars(args))
        base_args.devices = n_baseline
        rbase_elapsed, rbase_served = _baseline_loop(
            args, _global_stream(base_args, n_steps), n_baseline
        )
        rfleet_tp = _tp(fleet_elapsed, args.devices, n_steps)
        rbase_tp = _tp(rbase_elapsed, n_baseline, n_steps)
        rbase_tp["requests_served"] = rbase_served
        payload["throughput"]["routed"] = {
            "fleet": rfleet_tp,
            "looped_baseline": rbase_tp,
            "speedup_devices_per_s": round(
                rfleet_tp["devices_per_s"] / rbase_tp["devices_per_s"], 1
            ) if rbase_tp["devices_per_s"] else None,
        }
    return periodic_result


def _sharded_acceptance(args, mesh, device) -> dict:
    """Full-budget lifetime scan at ``--acceptance-devices`` scale (every
    rank; the block is rank 0's).

    Every device gets the small ``--acceptance-budget-j`` budget, the step
    cap is the per-device admission bound (rounded up to a whole number of
    4096-step chunks), and the chunked kernel's early exit stops as soon as
    the whole fleet is dead — so the scan runs each device to budget
    exhaustion, never to an arbitrary horizon.  Records throughput plus the
    per-device and aggregated ledger conservation errors; the port adds the
    same fleet and cap through the unsharded ``run_periodic`` on rank 0
    (its rate, and whether the two agree bit for bit) and the runtime."""
    import numpy as np

    from repro_torch.core import energy_model as em
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.distributed import ranks
    from repro_torch.fleet import run_periodic, run_periodic_sharded, uniform_fleet
    from repro_torch.fleet.step import _np
    from repro_torch.obs.ledger import AXES

    n_dev = args.acceptance_devices
    strategies = (
        ("on_off", "idle_waiting", "adaptive")
        if args.strategy == "mix"
        else (args.strategy,)
    )
    params = uniform_fleet(
        n_dev,
        item=paper_lstm_item(),
        strategies=strategies,
        method=IdlePowerMethod(args.method),
        request_period_ms=args.period_ms,
        e_budget_mj=args.acceptance_budget_j * 1000.0,
        powerup_overhead_mj=powerup_overhead_mj(args),
        device=device,
    )
    # per-device admission bound: on_off spends e_item per step, the others
    # e_item + e_idle past the first config — the max over devices (plus the
    # FLOOR_EPS slack run_periodic grants) caps the scan exactly
    e_item, e_idle = _np(params.e_item_mj), _np(params.e_idle_mj)
    limit = _np(params.e_budget_mj) + em.FLOOR_EPS * (e_item + e_idle)
    per = np.where(_np(params.is_onoff), e_item, e_item + e_idle)
    bound = int(np.ceil(np.max((limit + e_idle) / per))) + 2
    step_chunk = 4096
    n_cap = -(-bound // step_chunk) * step_chunk

    res, elapsed = _timed(lambda: run_periodic_sharded(params, n_cap, mesh=mesh, step_chunk=step_chunk), device)
    if ranks.rank() != 0:
        return {}
    ref, ref_elapsed = _timed(lambda: run_periodic(params, n_cap), device)
    same = all(torch.equal(getattr(ref, f), getattr(res, f))
               for f in ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time"))

    led = res.ledger()
    energy = _np(res.energy_mj)
    totals = sum(np.asarray(getattr(led, f"{ax}_mj")) for ax in AXES)
    denom = np.maximum(np.abs(energy), 1e-300)
    per_device_err = float(np.max(np.abs(totals - energy) / denom))
    agg = led.aggregate()
    agg_total = float(sum(getattr(agg, f"{ax}_mj") for ax in AXES))
    fleet_total = float(energy.sum())
    agg_err = abs(agg_total - fleet_total) / max(abs(fleet_total), 1e-300)

    block = {
        "devices": n_dev,
        "mesh": f"{res.mesh_shape[0]}x{res.mesh_shape[1]}",
        "n_shards": res.n_shards,
        "budget_j": args.acceptance_budget_j,
        "n_steps_cap": n_cap,
        "steps_executed": res.steps_executed,
        "all_budget_exhausted": bool(~res.alive.any()),
        "total_items": int(res.n_items.sum()),
        "elapsed_s": round(elapsed, 3),
        "devices_per_s": round(n_dev / elapsed, 1) if elapsed > 0 else None,
        "device_steps_per_s": round(n_dev * res.steps_executed / elapsed, 1)
        if elapsed > 0 else None,
        "ledger_conservation": {
            "per_device_max_rel_err": per_device_err,
            "aggregate_rel_err": agg_err,
            "within_1e-9": bool(per_device_err <= 1e-9 and agg_err <= 1e-9),
        },
        "unsharded": {
            "elapsed_s": round(ref_elapsed, 3),
            "device_steps_per_s": round(n_dev * n_cap / ref_elapsed, 1) if ref_elapsed > 0 else None,
            "bit_identical": bool(same),
        },
        "runtime": res.runtime,
    }
    if not same:
        raise SystemExit(
            f"the sharded acceptance scan diverged from run_periodic on mesh {block['mesh']} — "
            "refusing to emit the artifact"
        )
    return block


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.fleet",
        description="Fleet-scale vectorized duty-cycle simulation (one tick loop on the card).",
        calibrated_default=True,
        out_default="BENCH_fleet.json",
    )
    ap.add_argument("--devices", type=int, default=4096)
    ap.add_argument("--models", default=None,
                    help="heterogeneous fleet from the cost zoo: name[:replicas] "
                         "comma list (e.g. mixtral-8x7b,mamba2-370m:2); each "
                         "device runs at its own model's request period, and "
                         "the paper-item looped baseline is skipped")
    ap.add_argument("--horizon", type=float, default=10.0, help="simulated seconds")
    ap.add_argument("--mode", choices=["routed", "periodic"], default="routed")
    ap.add_argument("--router", default="round_robin",
                    choices=["round_robin", "least_loaded", "power_aware"])
    ap.add_argument("--strategy", default="mix",
                    choices=["mix", "on_off", "idle_waiting", "adaptive"])
    ap.add_argument("--method", default="method1+2",
                    choices=["baseline", "method1", "method1+2"])
    ap.add_argument("--process", default="deterministic",
                    choices=["deterministic", "poisson", "mmpp"],
                    help="shape of the global request stream (routed mode)")
    ap.add_argument("--period-ms", type=float, default=40.0,
                    help="per-device request period / mean-rate basis")
    ap.add_argument("--load", type=float, default=1.0,
                    help="offered load, requests per device per period")
    ap.add_argument("--dt-ms", type=float, default=None,
                    help="routed-mode tick (default: one tick per request "
                         "period; set smaller for finer queueing resolution)")
    ap.add_argument("--budget-j", type=float, default=4147.0,
                    help="per-device energy budget (J)")
    ap.add_argument("--queue-capacity", type=int, default=16)
    ap.add_argument("--no-latency", dest="collect_latency", action="store_false",
                    help="skip per-tick latency trajectories (saves K x N "
                         "memory on very long routed horizons)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-seeds", type=int, default=None,
                    help="Monte Carlo replications: add an 'uncertainty' "
                         "section with CI-banded fleet metrics (repro_torch.mc)")
    ap.add_argument("--jitter", type=float, default=0.0,
                    help="relative Gaussian request-timing jitter for the "
                         "uncertainty section (deterministic process only; "
                         "0 = exact duty-cycle limit)")
    ap.add_argument("--baseline-devices", type=int, default=None,
                    help="devices in the looped baseline (default min(N, 64))")
    ap.add_argument("--mesh", default="1",
                    help="mesh of ranks for the sharded periodic kernel: 'F', "
                         "'FxS', or 'auto' (one rank a card on the fleet axis); "
                         "the CLI spawns the F*S ranks itself (gloo, "
                         "host-staged collectives; all on one card where there "
                         "is one)")
    ap.add_argument("--acceptance-devices", type=int, default=None,
                    help="run the sharded full-budget lifetime acceptance "
                         "scan at this fleet size (e.g. 1048576) and record "
                         "it under 'sharded_acceptance'")
    ap.add_argument("--acceptance-budget-j", type=float, default=2.0,
                    help="per-device budget (J) for the acceptance scan — "
                         "small enough that every device dies within the "
                         "horizon (full-budget lifetime)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: tiny baseline + self-check caps")
    args = ap.parse_args(argv)

    if args.devices <= 0:
        raise SystemExit("--devices must be positive")
    if args.dt_ms is None:
        args.dt_ms = args.period_ms

    from repro_torch.device import resolve_device
    from repro_torch.distributed import ranks
    from repro_torch.fleet.shard import parse_mesh_spec

    mesh_f, mesh_s = parse_mesh_spec(args.mesh)
    if mesh_f < 1 or mesh_s < 1:
        raise ValueError(f"bad mesh spec {args.mesh!r}: both axes must be >= 1")
    device = resolve_device(args.device)
    if mesh_f * mesh_s == 1:
        return _program(args, (1, 1), device)
    ranks.spawn(mesh_f * mesh_s, _rank_program, args, (mesh_f, mesh_s), device=device)
    return 0


def _rank_program(args, mesh_shape) -> int:
    from repro_torch.distributed import ranks

    return _program(args, mesh_shape, ranks.device())


def _program(args, mesh_shape, device) -> int:
    """The CLI's run in one process or in every rank of a spawn: rank 0 runs
    the unsharded sections, every rank the sharded ones, and rank 0 writes
    the payload."""
    from repro_torch.distributed import ranks
    from repro_torch.fleet.shard import fleet_mesh, run_periodic_sharded

    lead = ranks.rank() == 0
    mesh = fleet_mesh(*mesh_shape)
    horizon_ms = args.horizon * 1000.0
    params = _build_params(args, device)
    payload: dict = {
        "kind": "fleet",
        "config": {
            k: getattr(args, k)
            for k in ("devices", "horizon", "mode", "router", "strategy", "method",
                      "process", "period_ms", "load", "dt_ms", "budget_j",
                      "queue_capacity", "collect_latency", "seed", "n_seeds",
                      "jitter", "calibrated", "smoke")
        },
    }

    timed = lambda fn: _timed(fn, device)  # noqa: E731

    n_steps_p = max(1, int(math.ceil(horizon_ms / args.period_ms)))
    n_baseline = args.baseline_devices or min(args.devices, 8 if args.smoke else 64)
    if args.mode == "periodic":
        n_steps = n_steps_p
    else:
        n_steps = max(1, int(math.ceil(horizon_ms / args.dt_ms)))
    if lead:
        periodic_result = _unsharded_sections(args, params, payload, device, n_steps, n_steps_p, n_baseline)

    # ---- sharded periodic kernel (always emitted; --mesh 1 collapses to the
    # unsharded semantics, so the bit-identity self-check is meaningful on a
    # single-device host too) --------------------------------------------------
    run_periodic_sharded(params, n_steps_p, mesh=mesh)   # warm-up: captures and caches
    sharded_result, sharded_elapsed = timed(lambda: run_periodic_sharded(params, n_steps_p, mesh=mesh))
    if lead:
        bit_identical = all(
            torch.equal(getattr(periodic_result, f), getattr(sharded_result, f))
            for f in ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time")
        )
        payload["throughput"]["sharded"] = {
            "mesh": f"{mesh_shape[0]}x{mesh_shape[1]}",
            "n_shards": sharded_result.n_shards,
            "n_padding": sharded_result.n_padding,
            "fleet": _tp(sharded_elapsed, args.devices, n_steps_p),
            "bit_identical_to_unsharded": bool(bit_identical),
            "runtime": sharded_result.runtime,
        }
        if not bit_identical:
            raise SystemExit(
                "sharded periodic kernel diverged from the unsharded reference "
                f"on mesh {mesh_shape[0]}x{mesh_shape[1]} — refusing to emit the artifact"
            )

    if args.acceptance_devices:
        acceptance = _sharded_acceptance(args, mesh, device)
        if lead:
            payload["sharded_acceptance"] = acceptance
    if not lead:
        return 0

    payload["oracle_self_check"] = _oracle_self_check(
        args, max_steps=2_000 if args.smoke else 6_000_000, device=device
    )

    if args.n_seeds:
        payload["uncertainty"] = _uncertainty_section(args, params, n_steps_p)

    emit(payload, args.out, label="fleet summary", device=device)
    tp = payload["throughput"]["periodic"]
    if "looped_baseline" in tp:
        print(
            f"fleet[{args.mode}] {args.devices} devices x {n_steps} steps on {device} | "
            f"periodic kernel: {tp['fleet']['devices_per_s']} devices/s vs looped "
            f"baseline ({n_baseline} devices) {tp['looped_baseline']['devices_per_s']} "
            f"devices/s -> speedup {tp['speedup_devices_per_s']}x"
        )
    else:
        print(
            f"fleet[{args.mode}] {args.devices} devices x {n_steps} steps on {device} "
            f"({args.models}) | periodic kernel: {tp['fleet']['devices_per_s']} devices/s"
        )
    if "routed" in payload["throughput"]:
        rt = payload["throughput"]["routed"]
        print(
            f"routed[{args.router}]: {rt['fleet']['devices_per_s']} devices/s "
            f"vs looped {rt['looped_baseline']['devices_per_s']} devices/s -> "
            f"speedup {rt['speedup_devices_per_s']}x"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
