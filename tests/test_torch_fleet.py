"""The port's fleet (``fleet/state.py``, ``router.py``, ``step.py``,
``dtypes.py``, ``metrics.py``, ``serving/fleet_backend.py``) against the JAX
package and against the port's own scalar simulators, on the CPU.

Per-device fields and per-tick trajectories equal the reference's bit for
bit: counts, energies, completion times, queues and latencies.  The
reference's compiled routed scan computes the idle energy as
``P · t · (1/1000)`` (XLA turns a constant divisor into a product with its
reciprocal), and the port multiplies by the same double; against
``simulate_trace``, which divides and charges phase by phase, the routed
energies agree within 1e-9, as in the reference's own tests."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import FixedTimeoutPolicy, StaticPolicy, break_even_timeout_ms
from repro_torch.core.arrivals import PoissonArrivals, bin_arrival_counts
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.simulator import simulate, simulate_trace
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.core.workload import ExperimentSpec, WorkloadSpec
from repro_torch.fleet import (
    INT32_STEP_LIMIT,
    ROUTER_CODES,
    DeviceSpec,
    FleetParams,
    FleetState,
    fleet_summary,
    route_counts,
    run_periodic,
    run_routed,
    uniform_fleet,
)
from repro_torch.fleet import dtypes
from repro_torch.fleet.step import _check_step_count
from test_torch_x64_shim import x64_shim

CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ
CPU = "cpu"
STRATEGIES = ("on_off", "idle_waiting", "adaptive")
STATE_FIELDS = [f.name for f in dataclasses.fields(FleetState)]
TRAJECTORIES = ("alive_over_time", "served_over_time", "queued_over_time", "latency_ms",
                "served_mask", "reconfig_mask", "released_mask", "queue_depth", "dropped_per_tick")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's fleet, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.fleet
        from repro.core import phases, strategies

    return dict(fleet=repro.fleet, phases=phases, st=strategies)


def _specs(n, budgets=(300.0, 3000.0), period=40.0, method="baseline"):
    return [dict(strategy=STRATEGIES[d % 3], request_period_ms=period,
                 e_budget_mj=budgets[d % len(budgets)], powerup_overhead_mj=CAL, method=method)
            for d in range(n)]


def _params(jref, specs):
    ours = FleetParams.from_specs(
        [DeviceSpec(paper_lstm_item(), **{**s, "method": IdlePowerMethod(s["method"])}) for s in specs],
        CPU,
    )
    jitem = jref["phases"].paper_lstm_item()
    ref = jref["fleet"].FleetParams.from_specs(
        [jref["fleet"].DeviceSpec(jitem, **{**s, "method": jref["st"].IdlePowerMethod(s["method"])})
         for s in specs]
    )
    return ours, ref


def _assert_same(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_routed_equal(ours, ref):
    for f in STATE_FIELDS:
        _assert_same(getattr(ours.state, f), getattr(ref.state, f), f)
    for f in TRAJECTORIES:
        if getattr(ref, f) is None:
            assert getattr(ours, f) is None, f
        else:
            _assert_same(getattr(ours, f), getattr(ref, f), f)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def test_params_equal_the_reference_column_by_column(jref):
    ours, ref = _params(jref, _specs(9, budgets=(300.0, 3000.0, 1e9), method="method1+2"))
    for f in dataclasses.fields(ours):
        _assert_same(getattr(ours, f.name), getattr(ref, f.name), f.name)
    tiled = uniform_fleet(3, strategies=STRATEGIES, device=CPU).tile(8)
    assert tiled.n_devices == 8 and tiled.strategy.tolist() == [0, 1, 2, 0, 1, 2, 0, 1]
    assert torch.equal(ours.with_budgets(np.ones(9)).e_budget_mj, torch.ones(9, dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        ours.with_budgets(np.ones(3))


def test_device_spec_validation_and_what_is_not_ported():
    item = paper_lstm_item()
    with pytest.raises(ValueError, match="unknown strategy"):
        DeviceSpec(item, strategy="mystery")
    with pytest.raises(ValueError, match="period"):
        DeviceSpec(item, request_period_ms=0.0)
    with pytest.raises(ValueError, match="budget"):
        DeviceSpec(item, e_budget_mj=-1.0)
    with pytest.raises(ValueError, match="at least one device"):
        FleetParams.from_specs([], CPU)
    # the cost zoo, ported with A9: a device priced by the model's request cost
    from repro_torch.costs import model_request_cost

    spec = DeviceSpec.from_model("mixtral-8x7b")
    assert spec.strategy == "adaptive" and spec.item == model_request_cost("mixtral-8x7b").item


# ---------------------------------------------------------------------------
# periodic: the reference and the scalar oracle
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_run_periodic_equals_the_reference(jref, n):
    ours_p, ref_p = _params(jref, _specs(n, budgets=(2000.0, 41470.0), method="method1+2"))
    steps = 40_000
    ours, ref = run_periodic(ours_p, steps), jref["fleet"].run_periodic(ref_p, steps)
    for f in ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time"):
        _assert_same(getattr(ours, f), getattr(ref, f), f)


@pytest.mark.parametrize("strategy", ["on_off", "idle_waiting"])
@pytest.mark.parametrize("period", [40.0, 89.0, 120.0])
@pytest.mark.parametrize("method", [IdlePowerMethod.BASELINE, IdlePowerMethod.METHOD1_2], ids=["baseline", "m12"])
def test_n1_periodic_equals_the_scalar_simulators_bit_for_bit(strategy, period, method):
    spec = ExperimentSpec(workload=WorkloadSpec(41.47, period), item=paper_lstm_item(),
                          strategy_kind=strategy, method=method, powerup_overhead_mj=CAL)
    fleet = run_periodic(FleetParams.from_specs([DeviceSpec.from_experiment(spec)], CPU),
                         n_steps=simulate(spec).n_items + 10)
    for mode in ("fast", "step"):
        oracle = simulate(spec, mode=mode)
        assert int(fleet.n_items[0]) == oracle.n_items
        assert float(fleet.energy_mj[0]) == oracle.energy_used_mj
        assert float(fleet.lifetime_ms[0]) == oracle.lifetime_ms
    assert not bool(fleet.alive[0])


@pytest.mark.parametrize("period", [40.0, 300.0, 600.0])
def test_adaptive_devices_equal_the_analytical_controller(period):
    from repro_torch.core.adaptive import AdaptiveStrategy

    item = paper_lstm_item()
    ref = AdaptiveStrategy(item, CAL, method=IdlePowerMethod.METHOD1_2).evaluate(period, 41470.0)
    spec = DeviceSpec(item, strategy="adaptive", method=IdlePowerMethod.METHOD1_2,
                      request_period_ms=period, e_budget_mj=41470.0, powerup_overhead_mj=CAL)
    fleet = run_periodic(FleetParams.from_specs([spec], CPU), n_steps=ref.n_max + 10)
    assert int(fleet.n_items[0]) == ref.n_max and float(fleet.lifetime_ms[0]) == ref.lifetime_ms


def test_horizon_truncation_and_infeasible_devices():
    item = paper_lstm_item()
    fleet = run_periodic(FleetParams.from_specs([DeviceSpec(item, request_period_ms=0.01),
                                                 DeviceSpec(item)], CPU), n_steps=100)
    assert fleet.n_items.tolist() == [0, 100] and fleet.alive.tolist() == [False, True]
    assert float(fleet.energy_mj[0]) == 0.0
    assert run_periodic(FleetParams.from_specs([DeviceSpec(item)], CPU), 0).alive_over_time.shape == (0,)


def test_fleet_reproduces_12_39x_per_device():
    """The paper's 4147 J budget at T = 40 ms: every Idle-Waiting (methods
    1+2) / On-Off pair shows the 12.39× lifetime ratio, counts equal to the
    closed forms (4.4 M steps a device)."""
    item = paper_lstm_item()
    params = uniform_fleet(8, item=item, strategies=("on_off", "idle_waiting"),
                           method=IdlePowerMethod.METHOD1_2, powerup_overhead_mj=CAL, device=CPU)
    res = run_periodic(params, n_steps=4_400_000)
    assert not res.alive.any()
    n = res.n_items.tolist()
    assert n[0::2] == [em.onoff_n_max(item, powerup_overhead_mj=CAL)] * 4
    assert n[1::2] == [em.idlewait_n_max(item, 40.0, idle_power_mw=24.0, powerup_overhead_mj=CAL)] * 4
    assert n[1] / n[0] == pytest.approx(12.39, rel=5e-3)


def test_alive_over_time_is_monotone_and_the_ledger_conserves():
    params = uniform_fleet(16, strategies=("on_off", "idle_waiting"), e_budget_mj=500.0,
                           powerup_overhead_mj=CAL, device=CPU)
    res = run_periodic(params, n_steps=2000)
    assert (res.alive_over_time[1:] <= res.alive_over_time[:-1]).all()
    assert int(res.alive_over_time[-1]) == int(res.alive.sum())
    res.ledger().assert_conserves(res.energy_mj.numpy())


# ---------------------------------------------------------------------------
# routed: the reference, per device and per tick
# ---------------------------------------------------------------------------
def _route(r, policy, alive, q_len, energy, budget, rr=0):
    counts, rr_next = route_counts(
        torch.tensor(r), ROUTER_CODES[policy], torch.tensor(alive), torch.tensor(q_len, dtype=torch.int32),
        torch.tensor(energy, dtype=torch.float64), torch.tensor(budget, dtype=torch.float64),
        torch.tensor(rr, dtype=torch.int32),
    )
    return counts.tolist(), int(rr_next)


def test_route_counts_policies():
    alive, zeros, ones = [True] * 4, [0.0] * 4, [1.0] * 4
    assert _route(6, "round_robin", alive, [0] * 4, zeros, ones) == ([2, 2, 1, 1], 2)
    assert _route(3, "round_robin", alive, [0] * 4, zeros, ones, rr=2) == ([1, 0, 1, 1], 1)
    for policy in ROUTER_CODES:
        assert sum(_route(13, policy, alive, [3, 0, 5, 1], [1, 9, 4, 0], ones)[0]) == 13
    counts, _ = _route(9, "round_robin", [True, False, True, False], [0] * 4, zeros, ones)
    assert counts[1] == counts[3] == 0 and sum(counts) == 9
    assert sum(_route(5, "least_loaded", [False] * 4, [0] * 4, zeros, ones)[0]) == 0
    assert _route(2, "least_loaded", alive, [5, 0, 3, 1], zeros, ones)[0] == [0, 1, 0, 1]
    assert _route(2, "power_aware", alive, [0] * 4, [0.9, 0.1, 0.5, 0.2], ones)[0] == [0, 1, 0, 1]
    # ties go to the lower device index (a stable sort, not topk)
    assert _route(2, "least_loaded", alive, [1, 0, 0, 0], zeros, ones)[0] == [0, 1, 1, 0]


@pytest.mark.parametrize("router", sorted(ROUTER_CODES))
@pytest.mark.parametrize("n", [1, 5, 64])
def test_run_routed_equals_the_reference(jref, router, n):
    ours_p, ref_p = _params(jref, _specs(n))
    counts = np.random.default_rng(n).poisson(0.7 * n, 300).astype(np.int32)
    kw = dict(router=router, queue_capacity=4, collect_events=True)
    ours = run_routed(ours_p, counts, 20.0, **kw)
    ref = jref["fleet"].run_routed(ref_p, counts, 20.0, **kw)
    _assert_routed_equal(ours, ref)
    assert fleet_summary(ours) == jref["fleet"].fleet_summary(ref)


@pytest.mark.parametrize("n", [3, 32])
def test_run_routed_direct_streams_equal_the_reference(jref, n):
    """Per-device (K, N) counts binned from sampled Poisson streams."""
    ours_p, ref_p = _params(jref, _specs(n, budgets=(500.0, 1e9)))
    t = PoissonArrivals(60.0).sample_batch(torch.Generator().manual_seed(n), n, 8000.0,
                                           include_origin=False)
    counts = bin_arrival_counts(t, 8000.0, 20.0)
    ours = run_routed(ours_p, counts, 20.0, router=None, collect_events=True)
    ref = jref["fleet"].run_routed(ref_p, counts.numpy(), 20.0, router=None, collect_events=True)
    _assert_routed_equal(ours, ref)
    assert (ours.final_modes() == ref.final_modes()).all()


@pytest.mark.parametrize("router", ["round_robin", None])
def test_chunked_continuation_is_bit_identical(router):
    n = 24
    params = FleetParams.from_specs(
        [DeviceSpec(paper_lstm_item(), **{**s, "method": IdlePowerMethod(s["method"])})
         for s in _specs(n, budgets=(300.0, 2000.0))], CPU)
    rng = np.random.default_rng(7)
    counts = (rng.poisson(n, 400) if router else rng.poisson(0.5, (400, n))).astype(np.int32)
    one = run_routed(params, counts, 20.0, router=router, queue_capacity=4)
    state, start, parts = None, 0, []
    for size in (130, 70, 200):
        r = run_routed(params, counts[start:start + size], 20.0, router=router, queue_capacity=4,
                       state0=state, start_tick=start)
        parts.append(r)
        state, start = r.state, start + size
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(one.state, f)), f
    for f in ("alive_over_time", "served_over_time", "queued_over_time", "latency_ms", "served_mask"):
        assert torch.equal(torch.cat([getattr(p, f) for p in parts]), getattr(one, f)), f


@pytest.mark.parametrize("kind", ["idle_waiting", "on_off", "adaptive"])
def test_n1_routed_against_simulate_trace(kind):
    item, period, dt, n_arr, budget = paper_lstm_item(), 80.0, 40.0, 400, 3000.0
    policy = (FixedTimeoutPolicy(break_even_timeout_ms(item, item.idle_power_mw), item.idle_power_mw)
              if kind == "adaptive" else StaticPolicy(kind, item))
    oracle = simulate_trace(item, [i * period for i in range(n_arr)], policy, budget)
    counts = np.zeros(int(n_arr * period / dt), np.int32)
    counts[:: int(period / dt)] = 1
    params = FleetParams.from_specs(
        [DeviceSpec(item, strategy=kind, request_period_ms=period, e_budget_mj=budget)], CPU)
    s = run_routed(params, counts, dt, router="round_robin").state
    assert int(s.n_served[0]) == oracle.n_items
    assert int(s.n_configs[0]) == oracle.configurations and int(s.n_released[0]) == oracle.releases
    assert bool(s.alive[0]) != oracle.exhausted
    assert abs(float(s.energy_mj[0]) - oracle.energy_used_mj) <= 1e-9


def test_request_conservation_and_validation():
    params = uniform_fleet(32, e_budget_mj=1e9, device=CPU)
    counts = np.random.default_rng(0).poisson(24.0, 300).astype(np.int32)
    for router in ROUTER_CODES:
        s = run_routed(params, counts, 10.0, router=router, queue_capacity=4).state
        assert int(s.n_served.sum() + s.q_len.sum() + s.n_dropped.sum()) == int(counts.sum())
    small = uniform_fleet(2, device=CPU)
    with pytest.raises(ValueError, match="router"):
        run_routed(small, np.ones(5, np.int32), 10.0, router=None)
    with pytest.raises(ValueError, match="columns"):
        run_routed(small, np.ones((5, 3), np.int32), 10.0, router=None)
    with pytest.raises(ValueError, match="dt_ms"):
        run_routed(small, np.ones(5, np.int32), 0.0)


# ---------------------------------------------------------------------------
# dtypes and the int32 guard
# ---------------------------------------------------------------------------
def _params9():
    return uniform_fleet(9, strategies=("idle_waiting", "on_off", "adaptive"), e_budget_mj=2500.0,
                         device=CPU)


def test_carry_dtypes_are_pinned():
    assert dtypes.periodic_carry_dtypes(_params9()) == dtypes.PERIODIC_CARRY_DTYPES == ("int32", "bool")
    assert dtypes.routed_carry_dtypes(_params9()) == dtypes.ROUTED_CARRY_DTYPES
    assert dtypes.ROUTED_CARRY_DTYPES["n_dropped"] == "int64"
    assert dtypes.ROUTED_CARRY_DTYPES["q_head"] == "int32"
    assert dtypes.ROUTED_CARRY_DTYPES["energy_mj"] == "float64"


def test_audit_catches_a_promoting_or_restructuring_body():
    carry = (torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    with pytest.raises(TypeError, match="int32 -> int64"):
        dtypes.audit_scan_body(lambda c, _: ((c[0].to(torch.int64) + 1, c[1]), None), carry, name="demo")
    with pytest.raises(TypeError, match="structure"):
        dtypes.scan_carry_dtypes(lambda c, _: ((c[0], c[1], c[0]), None), carry)
    assert dtypes.audit_scan_body(lambda c, _: ((c[0] + 1, c[1]), None), carry) == []


def test_int32_guard():
    assert INT32_STEP_LIMIT == 2**31 - 1 == np.iinfo(np.int32).max
    with pytest.raises(OverflowError, match="int32"):
        run_periodic(_params9(), INT32_STEP_LIMIT + 1)
    with pytest.raises(OverflowError, match="int32"):
        run_routed(_params9(), np.ones(4, np.int32), 40.0, start_tick=INT32_STEP_LIMIT - 2)
    _check_step_count(INT32_STEP_LIMIT, "test")
    with pytest.raises(ValueError, match="n_steps"):
        run_periodic(_params9(), -1)


# ---------------------------------------------------------------------------
# the fleet backend
# ---------------------------------------------------------------------------
def test_two_tenant_backend():
    from repro_torch.serving.fleet_backend import FleetBackend, FleetTenantSpec

    tenants = [
        FleetTenantSpec("hot", 300.0, 0.5, 170.0, 0.01, 100.0, policy="idle_waiting",
                        replicas=8, mean_period_ms=200.0, e_budget_mj=1e9),
        FleetTenantSpec("cold", 300.0, 0.5, 170.0, 0.01, 100.0, policy="on_off",
                        replicas=4, mean_period_ms=5000.0, e_budget_mj=1e9),
    ]
    backend = FleetBackend(tenants, device=CPU)
    assert backend.n_devices == 12
    out = backend.run(horizon_ms=60_000.0, dt_ms=100.0, seed=1)
    hot, cold = out["tenants"]["hot"], out["tenants"]["cold"]
    assert hot["served"] > cold["served"] > 0 and hot["replicas_alive"] == 8
    assert hot["configurations"] <= 8 and cold["configurations"] == cold["served"]
    assert out["fleet"]["requests"]["served"] == hot["served"] + cold["served"]
    assert backend.run(horizon_ms=60_000.0, dt_ms=100.0, seed=1) == out
    counts = backend._sample_counts(60_000.0, 100.0, seed=1, n_seeds=3, jitter=0.1)
    assert counts.shape == (3, 600, 12) and counts.dtype == torch.int32
    from repro_torch.optimize import replay_allocation

    alloc, per_tenant = backend.plan_budgets(1e6, 60_000.0)
    assert sum(t["planned_requests"] for t in per_tenant.values()) == alloc.total_requests
    assert float(alloc.budgets_mj.sum()) + alloc.leftover_mj == 1e6
    assert replay_allocation(backend.params, alloc)["exact"]
    mc = backend.run_mc(6_000.0, dt_ms=100.0, n_seeds=2, seed=1)
    assert mc["n_seeds"] == 2 and set(mc["tenants"]) == {"hot", "cold"}
    assert FleetTenantSpec.from_model("qwen3-1.7b").policy == "auto"
    with pytest.raises(ValueError, match="at least one tenant"):
        FleetBackend([], device=CPU)


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    from repro_torch.serving.fleet_backend import FleetBackend, FleetTenantSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: uniform_fleet(4),
                 lambda: FleetParams.from_specs([DeviceSpec(paper_lstm_item())]),
                 lambda: FleetState.init(4),
                 lambda: FleetBackend([FleetTenantSpec("t", 1, 1, 1, 1, 1)])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
