"""Benchmark CLI for the learned timeout policy (port of
``repro.launch.policy``; the JSON has the reference's keys).

Four sections, self-verifying the tentpole claims end to end:

* ``train``        — both training phases (backprop through the smooth
  relaxation, then antithetic ES on the hard objective), loss curves and
  the improvement over the ski-rental starting point;
* ``stationary``   — the guard contract: on deterministic/Poisson arrivals
  the learned controller must make the SAME decision as the closed-form
  :class:`~repro_torch.core.adaptive.AdaptiveStrategy` and reproduce the winning
  static strategy's trace energy to 1e-9 (it lands at 0.0 — bit-for-bit);
* ``nonstationary``— the win: mean lifetime under a fixed budget on
  regime-switching workloads, learned vs the ski-rental hybrid
  (:class:`~repro_torch.core.adaptive.PolicyController`), the fixed break-even
  timeout, and both statics, with MC confidence bands
  (:func:`repro_torch.mc.intervals.normal_interval`) and the non-overlap
  win criterion (:meth:`~repro_torch.mc.intervals.ConfidenceInterval.
  separated_from`);
* ``throughput``   — policy-steps/s of the batched rollout loop on the run's
  device.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.policy --smoke          # CI-sized
    PYTHONPATH=src python -m repro_torch.launch.policy --out build/policy.json
    PYTHONPATH=src python -m repro_torch.launch.policy --policy-out build/trained.json   # keep the policy

Training and the throughput rollout run on the card (``--device cuda``, the
default; raises on a host without one); ``--device cpu`` runs the same
program on the host.  The stationary and nonstationary sections replay
traces through the host simulator, as the reference does.  The JSON goes
to stdout unless ``--out`` is given; progress lines go to stderr.
"""
from __future__ import annotations

import sys

from repro_torch.launch._cli import Timer, emit, finish_payload, make_parser, powerup_overhead_mj


def _ci_dict(samples) -> dict:
    from repro_torch.mc.intervals import normal_interval

    return normal_interval(samples).to_dict()


def _train_section(args, item, method):
    from repro_torch.policy import TrainSettings, train_policy

    if args.smoke:
        settings = TrainSettings.smoke()
    else:
        settings = TrainSettings()
    settings = type(settings)(**{**settings.__dict__, "seed": args.seed})
    with Timer() as t:
        trained = train_policy(
            item, method, powerup_overhead_mj=powerup_overhead_mj(args),
            settings=settings, device=args.device,
        )
    h = trained.history
    improvement = 1.0 - h["final_hard"] / h["baseline_hard"]
    section = {
        "settings": trained.meta,
        "baseline_hard_cost": h["baseline_hard"],
        "final_hard_cost": h["final_hard"],
        "improvement_frac": improvement,
        "bp_loss_first": float(h["bp_loss"][0]) if len(h["bp_loss"]) else None,
        "bp_loss_last": float(h["bp_loss"][-1]) if len(h["bp_loss"]) else None,
        "es_loss_first": float(h["es_loss"][0]) if len(h["es_loss"]) else None,
        "es_loss_last": float(h["es_loss"][-1]) if len(h["es_loss"]) else None,
        "train_s": round(t.elapsed_s, 3),
    }
    print(
        f"train: ski-rental cost {h['baseline_hard']:.4f} -> learned "
        f"{h['final_hard']:.4f}  ({improvement:+.1%}) in {t.elapsed_s:.1f}s",
        file=sys.stderr,
    )
    return trained, section


def _stationary_section(args, item, method, trained):
    import numpy as np

    from repro_torch.core.adaptive import AdaptiveStrategy, StaticPolicy
    from repro_torch.core.simulator import simulate_trace
    from repro_torch.core.arrivals import DeterministicArrivals, PoissonArrivals
    from repro_torch.policy import LearnedTimeoutPolicy

    powerup = powerup_overhead_mj(args)
    ref = AdaptiveStrategy(item=item, method=method, powerup_overhead_mj=powerup)
    n_fast, n_slow = (1200, 300) if args.smoke else (2600, 400)
    cases = [
        ("deterministic_40ms", DeterministicArrivals(40.0), 40.0, n_fast),
        ("deterministic_2000ms", DeterministicArrivals(2000.0), 2000.0, n_slow),
        ("poisson_40ms", PoissonArrivals(40.0), 40.0, n_fast),
        ("poisson_4000ms", PoissonArrivals(4000.0), 4000.0, n_slow),
    ]
    rows, all_exact = [], True
    for name, proc, period, n_arr in cases:
        arr = np.concatenate(
            [[0.0], np.cumsum(proc.inter_arrival_times(n_arr - 1, seed=args.seed))]
        )
        pol = LearnedTimeoutPolicy(
            trained, item=item, method=method, powerup_overhead_mj=powerup,
            prior_period_ms=period,
        )
        r_l = simulate_trace(item, arr, pol, e_budget_mj=args.budget,
                             powerup_overhead_mj=powerup)
        decision = ref.decide(period)
        r_a = simulate_trace(
            item, arr, StaticPolicy(decision, item, method, powerup),
            e_budget_mj=args.budget, powerup_overhead_mj=powerup,
        )
        d_e = abs(r_l.energy_used_mj - r_a.energy_used_mj)
        row = {
            "case": name,
            "period_ms": period,
            "n_arrivals": n_arr,
            "analytic_decision": decision,
            "learned_regime": pol.regime(),
            "choice_matches": pol.regime() == decision,
            "energy_learned_mj": r_l.energy_used_mj,
            "energy_analytic_mj": r_a.energy_used_mj,
            "energy_abs_diff_mj": d_e,
            "n_items_learned": r_l.n_items,
            "n_items_analytic": r_a.n_items,
            "exact": bool(
                pol.regime() == decision
                and d_e <= 1e-9
                and r_l.n_items == r_a.n_items
            ),
        }
        all_exact &= row["exact"]
        rows.append(row)
        print(
            f"stationary {name}: analytic={decision} learned={pol.regime()} "
            f"|dE|={d_e:.2e} mJ  exact={row['exact']}",
            file=sys.stderr,
        )
    return {"cases": rows, "all_exact": bool(all_exact), "budget_mj": args.budget}


def _nonstationary_section(args, item, method, trained):
    import numpy as np

    from repro_torch.core.adaptive import (
        FixedTimeoutPolicy,
        PolicyController,
        StaticPolicy,
        break_even_timeout_ms,
    )
    from repro_torch.core.simulator import simulate_trace
    from repro_torch.core.arrivals import FlashCrowdArrivals, MMPPArrivals
    from repro_torch.mc.intervals import normal_interval
    from repro_torch.policy import LearnedTimeoutPolicy
    from repro_torch.policy.rollout import idle_power_for

    powerup = powerup_overhead_mj(args)
    p_idle = idle_power_for(item, method)
    t_be = break_even_timeout_ms(item, p_idle, powerup)
    workloads = [
        (
            "flash_crowd",
            FlashCrowdArrivals(
                quiet_ms=3000.0, flash_gap_ms=10.0, flash_len=32, flash_every=4.0
            ),
        ),
        (
            "bursty_mmpp",
            MMPPArrivals(
                burst_ms=20.0, quiet_ms=4000.0,
                mean_burst_len=12.0, mean_quiet_len=3.0,
            ),
        ),
    ]
    policies = {
        "learned": lambda: LearnedTimeoutPolicy(
            trained, item=item, method=method, powerup_overhead_mj=powerup
        ),
        "hybrid_controller": lambda: PolicyController(
            item=item, method=method, powerup_overhead_mj=powerup
        ),
        "ski_rental_fixed": lambda: FixedTimeoutPolicy(
            timeout_ms=t_be, idle_power_mw=p_idle
        ),
        "idle_waiting": lambda: StaticPolicy("idle_waiting", item, method, powerup),
        "on_off": lambda: StaticPolicy("on_off", item, method, powerup),
    }
    rows, wins = [], 0
    for name, proc in workloads:
        per_policy = {}
        cis = {}
        for label, mk in policies.items():
            lifetimes, n_items = [], []
            for seed in range(args.seeds):
                gaps = proc.inter_arrival_times(args.arrivals - 1, seed=seed)
                arr = np.concatenate([[0.0], np.cumsum(gaps)])
                r = simulate_trace(
                    item, arr, mk(), e_budget_mj=args.budget,
                    powerup_overhead_mj=powerup,
                )
                lifetimes.append(r.lifetime_ms)
                n_items.append(r.n_items)
            ci = normal_interval(lifetimes)
            cis[label] = ci
            per_policy[label] = {
                "lifetime_ms_ci": ci.to_dict(),
                "mean_n_items": float(np.mean(n_items)),
            }
        learned, hybrid = cis["learned"], cis["hybrid_controller"]
        win = learned.separated_from(hybrid) and learned.mean > hybrid.mean
        wins += win
        gain = learned.mean / hybrid.mean
        rows.append({
            "workload": name,
            "process": {"name": proc.name, **{
                k: v for k, v in proc.__dict__.items() if isinstance(v, (int, float))
            }},
            "seeds": args.seeds,
            "n_arrivals": args.arrivals,
            "budget_mj": args.budget,
            "policies": per_policy,
            "win_vs_hybrid": bool(win),
            "lifetime_gain_vs_hybrid": gain,
        })
        print(
            f"nonstationary {name}: learned {learned.mean:,.0f} ms vs hybrid "
            f"{hybrid.mean:,.0f} ms ({gain:.2f}x)  CI-separated win={win}",
            file=sys.stderr,
        )
    return {
        "workloads": rows,
        "wins_vs_hybrid": wins,
        "acceptance_met": bool(wins >= 2),
    }


def _throughput_section(args, item, method, trained):
    import numpy as np
    import torch

    from repro_torch.core.arrivals import MMPPArrivals
    from repro_torch.device import synchronize
    from repro_torch.policy.net import to_tensors
    from repro_torch.policy.rollout import make_consts, rollout

    powerup = powerup_overhead_mj(args)
    consts = make_consts(item, method, powerup)
    n_streams, n_gaps = (64, 256) if args.smoke else (256, 512)
    proc = MMPPArrivals(burst_ms=20.0, quiet_ms=4000.0,
                        mean_burst_len=12.0, mean_quiet_len=3.0)
    gaps = proc.sample_gaps(torch.Generator(args.device).manual_seed(args.seed),
                            n_streams, n_gaps)
    params = to_tensors(trained.params, args.device)
    out = rollout(params, gaps, consts, smooth=False, device=args.device)  # warm-up
    synchronize(args.device)
    with Timer() as t:
        out = rollout(params, gaps, consts, smooth=False, device=args.device)
        synchronize(args.device)
    steps = n_streams * n_gaps
    steps_per_s = steps / max(t.elapsed_s, 1e-12)
    print(
        f"throughput: {steps:,} policy-steps in {t.elapsed_s*1e3:.1f} ms "
        f"-> {steps_per_s:,.0f} steps/s (batched rollout loop on {args.device})",
        file=sys.stderr,
    )
    return {
        "rollout": {
            "n_streams": n_streams,
            "n_gaps": n_gaps,
            "steps": steps,
            "elapsed_s": t.elapsed_s,
            "steps_per_s": steps_per_s,
            "mean_energy_mj": float(np.mean(out["energy_mj"].cpu().numpy())),
        }
    }


def main(argv=None) -> None:
    ap = make_parser(
        "python -m repro_torch.launch.policy",
        "Learned idle-timeout policy benchmark (JSON to stdout or --out)",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: tiny network, fewer seeds/steps")
    ap.add_argument("--seed", type=int, default=0, help="training/eval base seed")
    ap.add_argument("--seeds", type=int, default=None,
                    help="MC replications per nonstationary workload")
    ap.add_argument("--arrivals", type=int, default=None,
                    help="arrivals per nonstationary replication")
    ap.add_argument("--budget", type=float, default=None,
                    help="trace energy budget (mJ) for the lifetime metric")
    ap.add_argument("--policy-out", default=None, metavar="PATH",
                    help="also write the trained policy's JSON (TrainedPolicy."
                         "to_json_dict, the JAX package's format) here")
    args = ap.parse_args(argv)
    if args.seeds is None:
        args.seeds = 24 if args.smoke else 48
    if args.arrivals is None:
        args.arrivals = 1000 if args.smoke else 1400
    if args.budget is None:
        args.budget = 1500.0

    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.core.strategies import IdlePowerMethod
    from repro_torch.device import resolve_device

    args.device = resolve_device(args.device)
    item = paper_lstm_item()
    method = IdlePowerMethod.METHOD1_2

    with Timer() as total:
        trained, train_sec = _train_section(args, item, method)
        stationary = _stationary_section(args, item, method, trained)
        nonstationary = _nonstationary_section(args, item, method, trained)
        throughput = _throughput_section(args, item, method, trained)

    payload = {
        "kind": "policy",
        "config": {
            "item": item.name,
            "method": method.value,
            "calibrated": args.calibrated,
            "smoke": args.smoke,
            "seed": args.seed,
            "seeds": args.seeds,
            "arrivals": args.arrivals,
            "budget_mj": args.budget,
        },
        "train": train_sec,
        "stationary": stationary,
        "nonstationary": nonstationary,
        "throughput": throughput,
    }
    finish_payload(payload, total.elapsed_s, launcher="policy", device=str(args.device))
    if not stationary["all_exact"]:
        print("WARNING: stationary-limit equivalence violated", file=sys.stderr)
    if not nonstationary["acceptance_met"]:
        print("WARNING: learned policy did not beat the hybrid on >= 2 "
              "nonstationary workloads", file=sys.stderr)
    if args.policy_out:
        import json

        with open(args.policy_out, "w") as f:
            json.dump(trained.to_json_dict(), f)
        print(f"wrote the trained policy to {args.policy_out}", file=sys.stderr)
    emit(payload, args.out, label="policy report", device=args.device)


if __name__ == "__main__":
    main()
