"""Monte Carlo uncertainty CLI — error bars on everything, in the layout of
the reference's ``BENCH_mc.json`` (port of ``repro.launch.mc``).

Puts a 95% confidence band on every headline number the deterministic
launchers report as a point estimate, and self-verifies the two contracts
the uncertainty engine makes (:mod:`repro_torch.mc`):

* **zero-jitter exactness** — the deterministic limit of every band is the
  closed-form value bit-for-bit (499.06 ms crossover, the 12.39× lifetime
  ratio, 11.85 mJ / 40.13× configuration energies);
* **analytic/empirical agreement** — delta-method bands through the
  differentiable primitives match the Monte Carlo bands at small jitter.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.mc                    # all sections, JSON to stdout
    PYTHONPATH=src python -m repro_torch.launch.mc --out build/mc.json
    PYTHONPATH=src python -m repro_torch.launch.mc --jitter 0.05
    PYTHONPATH=src python -m repro_torch.launch.mc --section headline,throughput
    PYTHONPATH=src python -m repro_torch.launch.mc --smoke            # CI-sized

Sections (``--section`` comma list, default all):

    headline    CI-banded paper numbers: crossover period, lifetime ratio,
                energy-per-request, Exp.-1 configuration energies — normal +
                bootstrap + delta-method bands and their cross-validation
    ensemble    S-seed stochastic duty-cycle fleet (one tick loop over an
                (S, N) carry): lifetime / energy-per-request CIs +
                per-device Welford bands
    latency     S-seed routed-kernel replications: p50/p99 latency CIs
    throughput  seeds/sec of the ensemble loop vs a looped scalar
                ``simulate_trace`` baseline over identical streams

Runs on the card (``--device cuda``, the default; raises on a host without
one); ``--device cpu`` runs the same program on the host.  ``--mesh F`` /
``FxS`` / ``auto`` shards the ensemble section over a ``("fleet", "seed")``
mesh of ranks the CLI spawns itself (:mod:`repro_torch.distributed.ranks`:
gloo, host-staged collectives, every rank on the same card where there is
one); rank 0 runs the other sections and writes the payload, and the
ensemble section equals ``--mesh 1``'s bit for bit.
"""
from __future__ import annotations

import sys
import time

from repro_torch.launch._cli import Timer, emit, finish_payload, make_parser, powerup_overhead_mj

_SECTIONS = ("headline", "ensemble", "latency", "throughput")


def _make_process(args):
    from repro_torch.core.arrivals import JitteredArrivals, MMPPArrivals, PoissonArrivals

    t = args.period_ms
    if args.process == "jittered":
        return JitteredArrivals(t, args.jitter)
    if args.process == "poisson":
        return PoissonArrivals(t)
    # mmpp with the stationary mean pinned at the requested period:
    # (8·burst + 1·quiet) / 9 = t  with  burst = t/2  →  quiet = 5t
    return MMPPArrivals(burst_ms=t / 2.0, quiet_ms=5.0 * t)


def _build_params(args, n_devices, strategies=("idle_waiting", "on_off", "adaptive")):
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.fleet import uniform_fleet

    return uniform_fleet(
        n_devices,
        item=paper_lstm_item(),
        strategies=strategies[: max(1, n_devices)],
        method=IdlePowerMethod(args.method),
        request_period_ms=args.period_ms,
        e_budget_mj=args.budget_j * 1000.0,
        powerup_overhead_mj=powerup_overhead_mj(args),
        device=args.device,
    )


def _ci_block(samples, args, delta_std=None, boot_seed=1):
    """normal + bootstrap (+ delta cross-validation) bands for one metric."""
    import numpy as np

    from repro_torch.mc import bootstrap_interval, cross_validate, normal_interval, percentile_interval

    s = np.asarray(samples, dtype=np.float64).ravel()
    finite = s[np.isfinite(s)]
    if finite.size == 0:
        # every replication degenerate (e.g. nothing served): null bands
        # rather than an exception — the artifact must still be emitted
        null = {"mean": None, "lo": None, "hi": None, "n": 0}
        out = {"n_samples": int(s.size), "n_degenerate": int(s.size),
               "normal": null, "bootstrap": null, "distribution": null}
        if delta_std is not None:
            out["delta"] = {"mc_std": None, "delta_std": delta_std,
                            "rel_disagreement": None, "n": 0}
        return out
    out = {
        "n_samples": int(s.size),
        "n_degenerate": int(s.size - finite.size),
        "normal": normal_interval(finite, args.confidence).to_dict(),
        "bootstrap": bootstrap_interval(
            finite, args.confidence, n_boot=args.boot, seed=boot_seed
        ).to_dict(),
        "distribution": percentile_interval(finite, args.confidence).to_dict(),
    }
    if delta_std is not None:
        out["delta"] = cross_validate(finite, delta_std, args.confidence)
    return out


def _section_headline(args) -> dict:
    """CI-banded versions of the paper's headline constants."""
    import numpy as np

    from repro_torch.core import energy_model as em
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.mc import (
        config_energy_uncertainty,
        crossover_uncertainty,
        energy_per_request_uncertainty,
        lifetime_ratio_uncertainty,
    )

    item = paper_lstm_item()
    powerup = powerup_overhead_mj(args)
    S, j, dev = args.seeds, args.jitter, args.device

    # ---- deterministic reference: the zero-jitter limit, checked exactly ----
    z_cross = crossover_uncertainty(
        item, jitter=0.0, n_seeds=8, idle_power_mw=24.0, powerup_overhead_mj=powerup,
        device=dev,
    )
    z_ratio = lifetime_ratio_uncertainty(item, jitter=0.0, n_seeds=8,
                                         powerup_overhead_mj=powerup, device=dev)
    z_epr = energy_per_request_uncertainty(item, jitter=0.0, n_seeds=8,
                                           powerup_overhead_mj=powerup, device=dev)
    closed_cross = em.crossover_period_ms(item, idle_power_mw=24.0,
                                          powerup_overhead_mj=powerup)
    reference = {
        "crossover_ms": z_cross["nominal_ms"],
        "crossover_exact": bool(
            np.all(z_cross["samples"] == z_cross["nominal_ms"])
            and z_cross["nominal_ms"] == closed_cross
        ),
        "crossover_matches_paper": round(z_cross["nominal_ms"], 2) == 499.06,
        "lifetime_ratio": z_ratio["nominal"],
        "lifetime_ratio_exact": bool(np.all(z_ratio["samples"] == z_ratio["nominal"])),
        "lifetime_ratio_matches_paper": bool(
            abs(z_ratio["nominal"] - 12.39) / 12.39 < 0.005
        ),
        "energy_per_request_mj": z_epr["nominal_mj"],
        "energy_per_request_exact": bool(np.all(z_epr["samples"] == z_epr["nominal_mj"])),
    }

    # ---- CI bands at the requested jitter -----------------------------------
    cross = crossover_uncertainty(item, jitter=j, n_seeds=S, seed=args.seed,
                                  idle_power_mw=24.0, powerup_overhead_mj=powerup, device=dev)
    ratio = lifetime_ratio_uncertainty(item, jitter=j, n_seeds=S, seed=args.seed + 1,
                                       powerup_overhead_mj=powerup, device=dev)
    epr = energy_per_request_uncertainty(item, jitter=j, n_seeds=S, seed=args.seed + 2,
                                         powerup_overhead_mj=powerup, device=dev)
    cfg = config_energy_uncertainty(jitter=j, n_seeds=S, seed=args.seed + 3, torch_device=dev)
    return {
        "deterministic_reference": reference,
        "jitter": j,
        "crossover_ms": {
            "nominal": cross["nominal_ms"],
            **_ci_block(cross["samples"], args, cross["delta_std"], boot_seed=11),
        },
        "lifetime_ratio": {
            "nominal": ratio["nominal"],
            "nominal_smooth": ratio["nominal_smooth"],
            **_ci_block(ratio["samples"], args, ratio["delta_std"], boot_seed=12),
        },
        "energy_per_request_mj": {
            "nominal": epr["nominal_mj"],
            **_ci_block(epr["samples"], args, epr["delta_std"], boot_seed=13),
        },
        "config_energy_min_mj": {
            "nominal": cfg["min_energy"]["nominal_mj"],
            **_ci_block(cfg["min_energy"]["samples"], args,
                        cfg["min_energy"]["delta_std"], boot_seed=14),
        },
        "config_reduction_ratio": {
            "nominal": cfg["reduction_ratio"]["nominal"],
            **_ci_block(cfg["reduction_ratio"]["samples"], args,
                        cfg["reduction_ratio"]["delta_std"], boot_seed=15),
        },
    }


def _welford_summary(w) -> dict:
    import numpy as np

    return {
        "n": w.count,
        "mean": {"min": float(np.min(w.mean)), "median": float(np.median(w.mean)),
                 "max": float(np.max(w.mean))},
        "std": {"min": float(np.min(w.std)), "median": float(np.median(w.std)),
                "max": float(np.max(w.std))},
    }


def _section_ensemble(args) -> dict:
    """Stochastic duty-cycle fleet: S replications in one tick loop."""
    import numpy as np

    from repro_torch.fleet import run_periodic
    from repro_torch.distributed import ranks
    from repro_torch.fleet.shard import fleet_mesh, parse_mesh_spec
    from repro_torch.fleet.step import _np
    from repro_torch.mc import run_periodic_ensemble

    mesh = fleet_mesh(*parse_mesh_spec(args.mesh)) if args.mesh != "1" else None

    params = _build_params(args, args.devices)
    process = _make_process(args)
    ens = run_periodic_ensemble(params, process, args.steps, args.seeds, seed=args.seed, mesh=mesh)
    if ens is None or ranks.rank() != 0:
        return {}
    out = {
        "process": process.name,
        "mesh": args.mesh,
        "runtime": ranks.info() if mesh is not None else None,
        "jitter": args.jitter if args.process == "jittered" else None,
        "n_seeds": ens.n_seeds,
        "n_devices": ens.n_devices,
        "n_steps": ens.n_steps,
        "lifetime_ms": _ci_block(ens.lifetime_ms, args, boot_seed=21),
        "energy_per_request_mj": _ci_block(ens.energy_per_request_mj, args, boot_seed=22),
        "total_items": {
            "mean": float(np.mean(ens.total_items)),
            "std": float(np.std(ens.total_items, ddof=1)) if ens.n_seeds > 1 else 0.0,
        },
        "per_device": {
            "lifetime_ms": _welford_summary(ens.device_lifetime_ms),
            "energy_mj": _welford_summary(ens.device_energy_mj),
            "items": _welford_summary(ens.device_items),
        },
    }
    if args.process == "jittered" and args.jitter == 0.0:
        ref = run_periodic(params, args.steps)
        # counts are exact; lifetimes are accumulated gap sums in the
        # ensemble vs n·T products in the kernel, so a non-dyadic period
        # legitimately drifts by ~1 ulp per addition — compare to 1e-9
        out["deterministic_agrees_with_fleet_kernel"] = bool(
            np.all(ens.device_items.std == 0.0)
            and np.array_equal(ens.device_items.mean,
                               _np(ref.n_items).astype(np.float64))
            and np.allclose(ens.device_lifetime_ms.mean, _np(ref.lifetime_ms),
                            rtol=1e-9, atol=0.0)
        )
    return out


def _section_latency(args) -> dict:
    """Routed-kernel replications: CI bands on the latency tail."""
    import numpy as np

    from repro_torch.mc import run_routed_ensemble

    n_seeds = max(4, min(args.seeds, 16 if args.smoke else 64))
    params = _build_params(args, min(args.devices, 8))
    process = _make_process(args)
    horizon_ms = args.latency_horizon_s * 1000.0
    ens = run_routed_ensemble(
        params, process, horizon_ms, args.dt_ms, n_seeds, seed=args.seed
    )
    finite99 = ens.p99_latency_ms[np.isfinite(ens.p99_latency_ms)]
    finite50 = ens.p50_latency_ms[np.isfinite(ens.p50_latency_ms)]
    return {
        "process": process.name,
        "n_seeds": n_seeds,
        "n_devices": ens.n_devices,
        "horizon_ms": horizon_ms,
        "dt_ms": args.dt_ms,
        "p99_latency_ms": _ci_block(finite99, args, boot_seed=31),
        "p50_latency_ms": _ci_block(finite50, args, boot_seed=32),
        "served": _ci_block(ens.served, args, boot_seed=33),
        "energy_per_request_mj": _ci_block(ens.energy_per_request_mj, args, boot_seed=34),
    }


#: Devices per replication in the throughput comparison (the strategy mix).
_TP_STRATEGIES = ("idle_waiting", "on_off", "adaptive")


def _looped_baseline(args, traces, e_budget_mj: float) -> tuple[float, int]:
    """One scalar ``simulate_trace`` per device per seed over pre-built
    streams — the fair Python-loop counterpart of the vmapped ensemble
    (stream generation sits outside the timed region on both sides, the
    ``launch.fleet`` convention)."""
    from repro_torch.core.adaptive import StaticPolicy
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.simulator import simulate_trace
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.fleet import DeviceSpec

    item = paper_lstm_item()
    method = IdlePowerMethod(args.method)
    powerup = powerup_overhead_mj(args)
    # The periodic ensemble models adaptive as its *resolved* static arm
    # (the winner at the nominal period — FleetParams.scalar_columns); the
    # baseline must run the same policy or the two sides do different work
    # per identical stream and the seeds/sec row stops being comparable.
    resolved_adaptive = DeviceSpec(
        item=item, strategy="adaptive", method=method,
        request_period_ms=args.period_ms, powerup_overhead_mj=powerup,
    ).resolved_strategy()
    policies = {
        "idle_waiting": lambda: StaticPolicy("idle_waiting", item, method=method),
        "on_off": lambda: StaticPolicy("on_off", item, method=method),
        "adaptive": lambda: StaticPolicy(resolved_adaptive, item, method=method),
    }
    served = 0
    t0 = time.perf_counter()
    for per_device in traces:
        for strat, trace in zip(_TP_STRATEGIES, per_device):
            res = simulate_trace(
                item, trace, policies[strat](),
                e_budget_mj=e_budget_mj, powerup_overhead_mj=powerup,
            )
            served += res.n_items
    return time.perf_counter() - t0, served


def _section_throughput(args) -> dict:
    """Seeds/sec of the ensemble loop vs the looped scalar baseline.

    One *seed* is one whole fleet replication (len(_TP_STRATEGIES) devices,
    the strategy mix), so the baseline loops that many ``simulate_trace``
    calls per seed.  Streams are pre-sampled outside both timed regions;
    the ensemble's one-shot batched sampling cost is reported separately.
    The timed regions on the card end in a device synchronize.
    """
    import numpy as np
    import torch

    from repro_torch.device import synchronize
    from repro_torch.fleet.step import _np
    from repro_torch.mc import periodic_ensemble
    from repro_torch.mc.ensemble import chunk_seed

    n_dev = len(_TP_STRATEGIES)
    params = _build_params(args, n_dev, strategies=_TP_STRATEGIES)
    # Budget sized so no device exhausts inside the horizon: the Python
    # baseline early-exits dead trajectories (an escape the vectorized scan
    # never takes), so live workloads are the apples-to-apples comparison.
    per_period = _np(params.e_item_mj) + _np(params.e_idle_mj)
    tp_budget_mj = float(np.max(per_period)) * args.steps * 1.05
    params = params.with_budgets(np.full(n_dev, tp_budget_mj))
    process = _make_process(args)
    n_baseline = min(args.seeds, 8 if args.smoke else 32)

    device = params.device
    synchronize(device)
    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(chunk_seed(args.seed, 0))
    gaps = process.sample_gaps(gen, args.seeds * n_dev, args.steps)
    gaps = gaps.reshape(args.seeds, n_dev, args.steps).permute(0, 2, 1).contiguous()
    synchronize(device)
    sampling_s = time.perf_counter() - t0
    gaps_host = gaps[:n_baseline].cpu().numpy()
    # each baseline device replays the identical stream its fleet twin saw
    # (cumsum only over the baseline's slice — the other seeds never loop)
    arrivals = np.concatenate(
        [np.zeros((n_baseline, 1, n_dev)),
         np.cumsum(gaps_host[:, :-1, :], axis=1)],
        axis=1,
    )
    traces = [
        [arrivals[s, :, d] for d in range(n_dev)] for s in range(n_baseline)
    ]

    periodic_ensemble(params, gaps)         # warm-up: capture and caches once
    synchronize(device)
    t0 = time.perf_counter()
    ens = periodic_ensemble(params, gaps)
    synchronize(device)
    ens_elapsed = time.perf_counter() - t0

    base_elapsed, base_served = _looped_baseline(args, traces, tp_budget_mj)
    ens_rate = args.seeds / ens_elapsed if ens_elapsed > 0 else float("inf")
    base_rate = n_baseline / base_elapsed if base_elapsed > 0 else float("inf")
    return {
        "n_steps": args.steps,
        "devices_per_seed": n_dev,
        "budget_mj": round(tp_budget_mj, 3),
        "ensemble": {
            "seeds": args.seeds,
            "elapsed_s": round(ens_elapsed, 6),
            "sampling_s": round(sampling_s, 6),
            "seeds_per_s": round(ens_rate, 1),
            "requests_simulated": int(ens.total_items.sum()),
        },
        "looped_baseline": {
            "seeds": n_baseline,
            "elapsed_s": round(base_elapsed, 6),
            "seeds_per_s": round(base_rate, 1),
            "requests_simulated": base_served,
        },
        "speedup_seeds_per_s": round(ens_rate / base_rate, 1) if base_rate else None,
    }


def main(argv=None) -> int:
    ap = make_parser(
        prog="python -m repro_torch.launch.mc",
        description="Monte Carlo uncertainty engine: CIs on every headline number.",
        calibrated_default=True,
    )
    ap.add_argument("--section", default=",".join(_SECTIONS),
                    help=f"comma list of sections to run (default all: {','.join(_SECTIONS)})")
    ap.add_argument("--seeds", type=int, default=1024,
                    help="ensemble replications S (default 1024)")
    ap.add_argument("--jitter", type=float, default=0.02,
                    help="relative Gaussian jitter on parameters/gaps (default 0.02; "
                         "0 collapses every band onto the deterministic numbers)")
    ap.add_argument("--process", default="poisson",
                    choices=["jittered", "poisson", "mmpp"],
                    help="arrival process for the ensemble/latency/throughput "
                         "sections (jittered uses --jitter; --process jittered "
                         "--jitter 0 is the exact deterministic limit)")
    ap.add_argument("--devices", type=int, default=9,
                    help="fleet devices per replication (strategy mix cycles 3 ways)")
    ap.add_argument("--steps", type=int, default=2000,
                    help="requests per device per replication")
    ap.add_argument("--period-ms", type=float, default=40.0)
    ap.add_argument("--budget-j", type=float, default=1.5,
                    help="per-device energy budget (J); small enough that budgets "
                         "exhaust inside --steps, so lifetimes are distributions")
    ap.add_argument("--method", default="method1+2",
                    choices=["baseline", "method1", "method1+2"])
    ap.add_argument("--confidence", type=float, default=0.95)
    ap.add_argument("--boot", type=int, default=1000,
                    help="bootstrap resamples per interval")
    ap.add_argument("--dt-ms", type=float, default=10.0,
                    help="routed tick for the latency section")
    ap.add_argument("--latency-horizon-s", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="1",
                    help="('fleet', 'seed') mesh of ranks for the ensemble "
                         "section: 'F', 'FxS', or 'auto'; the CLI spawns the "
                         "F*S ranks itself (gloo, host-staged collectives), and "
                         "the results are bit-identical to --mesh 1")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: fewer seeds/steps/resamples")
    args = ap.parse_args(argv)

    if args.smoke:
        args.seeds = min(args.seeds, 128)
        args.steps = min(args.steps, 500)
        args.boot = min(args.boot, 200)
        args.latency_horizon_s = min(args.latency_horizon_s, 2.0)
    if args.seeds < 2:
        raise SystemExit("--seeds must be ≥ 2 (intervals need replication)")
    if not (0 <= args.jitter < 1):
        raise SystemExit("--jitter must be in [0, 1)")
    sections = [s.strip() for s in args.section.split(",") if s.strip()]
    unknown = set(sections) - set(_SECTIONS)
    if unknown:
        raise SystemExit(f"unknown sections {sorted(unknown)}; choose from {_SECTIONS}")

    from repro_torch.device import resolve_device
    from repro_torch.distributed import ranks
    from repro_torch.fleet.shard import parse_mesh_spec

    mesh_f, mesh_s = parse_mesh_spec(args.mesh)
    if mesh_f < 1 or mesh_s < 1:
        raise ValueError(f"bad mesh spec {args.mesh!r}: both axes must be >= 1")
    device = resolve_device(args.device)
    if mesh_f * mesh_s == 1:
        return _program(args, sections, device)
    ranks.spawn(mesh_f * mesh_s, _program, args, sections, device, device=device)
    return 0


def _program(args, sections, device) -> int:
    """The CLI's run in one process or in every rank of a spawn: every rank
    runs the (sharded) ensemble section, rank 0 everything else and the
    payload."""
    from repro_torch.distributed import ranks

    lead = ranks.rank() == 0
    payload: dict = {
        "kind": "mc",
        "config": {
            k: getattr(args, k)
            for k in ("seeds", "jitter", "process", "devices", "steps", "period_ms",
                      "budget_j", "method", "confidence", "boot", "dt_ms",
                      "latency_horizon_s", "seed", "calibrated", "smoke")
        },
    }
    runners = {
        "headline": _section_headline,
        "ensemble": _section_ensemble,
        "latency": _section_latency,
        "throughput": _section_throughput,
    }
    with Timer() as t:
        for name in _SECTIONS:
            if name in sections and (lead or name == "ensemble"):
                with Timer() as ts:
                    payload[name] = runners[name](args)
                payload[name]["elapsed_s"] = round(ts.elapsed_s, 3)
    if not lead:
        return 0
    finish_payload(payload, t.elapsed_s, sections=sections, seeds=args.seeds,
                   jitter=args.jitter)

    emit(payload, None if args.out == "-" else args.out, label="mc summary", device=device)
    if "headline" in payload:
        h = payload["headline"]
        ref = h["deterministic_reference"]
        c = h["crossover_ms"]
        print(
            f"mc[headline] crossover {c['nominal']:.2f} ms "
            f"[{c['normal']['lo']:.2f}, {c['normal']['hi']:.2f}] @95% "
            f"(jitter {args.jitter}) | zero-jitter exact: "
            f"{ref['crossover_exact'] and ref['lifetime_ratio_exact']} | "
            f"delta-vs-mc rel err {c['delta']['rel_disagreement']:.3f}"
        )
    if "throughput" in payload:
        tp = payload["throughput"]
        print(
            f"mc[throughput] ensemble loop on {device}: {tp['ensemble']['seeds_per_s']} seeds/s vs "
            f"looped {tp['looped_baseline']['seeds_per_s']} seeds/s -> "
            f"speedup {tp['speedup_seeds_per_s']}x at S={args.seeds}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
