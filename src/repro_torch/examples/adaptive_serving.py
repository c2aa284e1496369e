"""Adaptive power policy demo: one controller, three traffic shapes.

Replays the paper's Table-2 LSTM-accelerator workload item under three
arrival patterns — steady-fast (below the 499.06 ms crossover), steady-slow
(above it), and bursty — and shows the adaptive controller:

  * converging to Idle-Waiting on the fast stream (same items as the static
    winner),
  * converging to On-Off on the slow stream,
  * beating BOTH static strategies on the bursty stream via the
    hysteresis-guarded break-even hybrid.

Everything is the discrete-event simulator (pure Python, no card), and the
printed lines equal those of the JAX package's ``examples/adaptive_serving.py``.
For the live-engine version of the same policies, see
``python -m repro_torch.launch.serve --strategy adaptive``.

Run:  python -m repro_torch.examples.adaptive_serving
"""
from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import AdaptiveStrategy, PolicyController, StaticPolicy
from repro_torch.core.arrivals import DeterministicArrivals, MMPPArrivals
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.simulator import simulate_trace
from repro_torch.core.strategies import IdlePowerMethod

ITEM = paper_lstm_item()
METHOD = IdlePowerMethod.METHOD1_2
OVERHEAD = em.CALIBRATED_POWERUP_OVERHEAD_MJ
BUDGET_MJ = 20_000.0      # 20 J keeps the event loop instant; ratios scale
N = 200_000


def run(process, label):
    arrivals = process.arrival_times(N, seed=1)
    results = {}
    for kind in ("on_off", "idle_waiting"):
        pol = StaticPolicy(kind, ITEM, method=METHOD, powerup_overhead_mj=OVERHEAD)
        results[kind] = simulate_trace(ITEM, arrivals, pol, BUDGET_MJ, OVERHEAD)
    ctl = PolicyController(ITEM, method=METHOD, powerup_overhead_mj=OVERHEAD)
    results["adaptive"] = simulate_trace(
        ITEM, arrivals, ctl, BUDGET_MJ, OVERHEAD, policy_name="adaptive"
    )
    print(f"== {label} (mean period {process.mean_period_ms():.0f} ms) ==")
    for name, r in results.items():
        print(
            f"  {name:12s}: {r.n_items:6d} items, "
            f"{r.energy_per_item_mj:7.3f} mJ/item, "
            f"{r.configurations:5d} configurations"
        )
    print(f"  adaptive regime: {ctl.summary()['regime']}"
          f"  (estimate {ctl.estimate_ms:.0f} ms, CV {ctl.cv:.2f})")
    return results, ctl


def main() -> dict:
    """Print the crossover and the three traffic shapes' results, assert
    the adaptive controller's guarantees; returns the results by shape."""
    strategy = AdaptiveStrategy(ITEM, OVERHEAD, method=METHOD)
    print(f"analytical crossover: {strategy.crossover_ms():.2f} ms "
          f"(paper: 499.06 ms)\n")

    fast, _ = run(DeterministicArrivals(40.0), "steady-fast, 40 ms")
    assert fast["adaptive"].n_items == fast["idle_waiting"].n_items, \
        "adaptive must converge to Idle-Waiting below the crossover"
    print()

    slow, _ = run(DeterministicArrivals(2000.0), "steady-slow, 2 s")
    assert slow["adaptive"].n_items > slow["idle_waiting"].n_items, \
        "adaptive must leave Idle-Waiting above the crossover"
    print()

    bursty, _ = run(
        MMPPArrivals(burst_ms=50.0, quiet_ms=5000.0, mean_burst_len=8),
        "bursty (MMPP: 50 ms bursts / 5 s quiet)",
    )
    best_static = max(bursty["on_off"].n_items, bursty["idle_waiting"].n_items)
    assert bursty["adaptive"].n_items > best_static, \
        "adaptive must beat both statics on bursty traffic"
    print(f"\n  ✓ adaptive served {bursty['adaptive'].n_items / best_static:.2f}× "
          f"the best static strategy's items on the bursty stream")
    return {"crossover_ms": strategy.crossover_ms(), "fast": fast, "slow": slow,
            "bursty": bursty}


if __name__ == "__main__":
    main()
