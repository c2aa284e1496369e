"""The port's control plane (``control/hierarchy.py``, ``autoscaler.py``,
``faults.py``, ``simulate.py``, ``report.py``) against the JAX package and
against its own lower layers, on the CPU.

* The exact integer splits equal the reference's on the same inputs.
* The differential spine: a 1-region/1-rack hierarchy is the port's
  ``run_routed`` bit for bit and the reference's ``run_hierarchy``; a
  1-device rack in periodic mode is the scalar oracle; the epoch partition
  does not change the racks.
* Full runs — a faulted, autoscaled, pack-routed 2 × 2 × 4 topology with
  the idle tail charged, under the crossover rule, a fixed-timeout policy
  and a learned policy loaded from one JSON — equal the reference's run on
  the same counts: every rack's state bit for bit, every rack event, the
  latencies and the reports.
* The reference tests' events (crash restart, fencing, the rack closed
  forms, no-flap, night off / flash on, the idle tail) hold with the
  reference's numbers.
"""
import dataclasses
import doctest
import json
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro_torch.control as control
from repro_torch.control import (
    CrossoverAutoscaler,
    FaultSchedule,
    PolicyAutoscaler,
    RackFault,
    RackSpec,
    concat_params,
    hierarchy_report,
    pareto_section,
    rack_break_even_ms,
    rack_crossover_ms,
    rack_idle_power_mw,
    rack_reconfig_energy_mj,
    rack_workload_item,
    random_schedule,
    run_hierarchy,
    run_rack_periodic,
    slo_metrics,
    uniform_topology,
    verify_hierarchy,
)
from repro_torch.control.simulate import pack_split, proportional_split
from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import FixedTimeoutPolicy
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.simulator import simulate
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.core.workload import ExperimentSpec, WorkloadSpec
from repro_torch.fleet import DeviceSpec, FleetParams
from repro_torch.fleet.step import run_routed
from repro_torch.policy import LearnedTimeoutPolicy, TrainedPolicy, untrained_policy

CPU = "cpu"
CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ

# every field of the routed carry, held bit for bit
STATE_FIELDS = (
    "energy_mj", "idle_energy_mj", "n_served", "n_configs", "n_released",
    "n_dropped", "resident", "alive", "completion_ms", "queue_ms", "q_head",
    "q_len", "rr_ptr",
)
RACK_EVENTS = (
    "region", "powered", "crashed", "unrecoverable", "usable_devices",
    "lost_devices", "arrived", "bringup_energy_mj", "idle_tail_mj",
    "n_power_ons", "n_power_offs", "n_restarts",
)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's control plane, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains.
    Submodules come by ``from`` imports (a JAX-package test file that failed
    to import on the same worker leaves them in ``sys.modules`` without
    their attribute on a re-imported parent package)."""
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.control import autoscaler as jauto
    from repro.control import faults as jfaults
    from repro.control import hierarchy as jhier
    from repro.control import report as jreport
    from repro.control import simulate as jsim
    from repro.core import adaptive as jadaptive
    from repro.fleet.step import run_routed as jrouted
    from repro.policy import controller as jcontroller
    from repro.policy import train as jtrain

    return dict(auto=jauto, faults=jfaults, hier=jhier, report=jreport, sim=jsim,
                adaptive=jadaptive, routed=jrouted, controller=jcontroller, train=jtrain)


def _small(**kwargs):
    defaults = dict(
        n_regions=1, racks_per_region=2, devices_per_rack=4,
        request_period_ms=100.0, bringup_ms=100.0, bringup_mj=50.0,
    )
    defaults.update(kwargs)
    return defaults


def _topologies(jref, **kwargs):
    """The same topology in both packages (the port's on the CPU)."""
    return uniform_topology(**kwargs, device=CPU), jref["hier"].uniform_topology(**kwargs)


def _faults(jref, faults):
    """A port :class:`FaultSchedule` and its reference twin."""
    j = jref["faults"]
    return faults, j.FaultSchedule(tuple(j.RackFault(f.rack, f.crash_tick, f.lost_devices)
                                         for f in faults))


def assert_same_state(ours, ref, label=""):
    for f in STATE_FIELDS:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, (label, f, a.dtype, b.dtype)
        assert np.array_equal(a, b), (label, f)


def assert_same_result(jref, ours, ref):
    """Every rack's state bit for bit, every rack event, the level counters,
    the latencies and the reports."""
    assert list(ours.racks) == list(ref.racks)
    for name in ours.racks:
        a, b = ours.racks[name], ref.racks[name]
        assert_same_state(a.state, b.state, name)
        for e in RACK_EVENTS:
            assert getattr(a, e) == getattr(b, e), (name, e)
        if a.autoscaler is not None:
            assert a.autoscaler.power_transitions == b.autoscaler.power_transitions
    for k in ("arrived", "global_dropped", "region_arrived", "region_dropped",
              "device_ticks", "n_ticks", "epoch_ticks", "served", "dropped", "in_flight",
              "total_energy_mj", "flat_device_energy_mj"):
        assert getattr(ours, k) == getattr(ref, k), k
    assert ours.latency_ms.dtype == ref.latency_ms.dtype
    assert np.array_equal(ours.latency_ms, ref.latency_ms)
    assert (ours.injector is None) == (ref.injector is None)
    if ours.injector is not None:
        assert (ours.injector.n_crashes, ours.injector.n_detected) == (
            ref.injector.n_crashes, ref.injector.n_detected)
    rep = jref["report"]
    assert hierarchy_report(ours) == rep.hierarchy_report(ref)
    assert slo_metrics(ours) == rep.slo_metrics(ref)
    assert verify_hierarchy(ours) == rep.verify_hierarchy(ref)
    assert ours.conservation() == ref.conservation()


# ---------------------------------------------------------------------------
# exact integer routing
# ---------------------------------------------------------------------------
class TestSplits:
    def test_single_target_is_identity(self, jref):
        counts = np.array([0, 3, 7, 1], dtype=np.int64)
        for split, jsplit in ((proportional_split, jref["sim"].proportional_split),
                              (pack_split, jref["sim"].pack_split)):
            out, dropped, ptr = split(counts, np.array([5]), ptr=0)
            assert np.array_equal(out[:, 0], counts)
            assert not dropped.any() and ptr == 0
            j = jsplit(counts, np.array([5]), ptr=0)
            assert np.array_equal(out, j[0]) and np.array_equal(dropped, j[1]) and ptr == j[2]

    def test_all_zero_weights_drop_everything(self):
        counts = np.array([2, 5], dtype=np.int64)
        for split in (proportional_split, pack_split):
            out, dropped, _ = split(counts, np.array([0, 0]), ptr=0)
            assert not out.any()
            assert np.array_equal(dropped, counts)

    def test_pack_fills_in_order(self):
        out, dropped, _ = pack_split(np.array([5]), np.array([4, 4]))
        assert out.tolist() == [[4, 1]] and not dropped.any()

    def test_pack_overflow_spills_proportionally(self):
        out, dropped, _ = pack_split(np.array([12]), np.array([4, 4]))
        assert out.sum() == 12 and not dropped.any()
        assert out.tolist() == [[6, 6]]

    @settings(max_examples=25, deadline=None)
    @given(
        st.lists(st.integers(min_value=0, max_value=40), min_size=1, max_size=12),
        st.lists(st.integers(min_value=0, max_value=6), min_size=1, max_size=5),
        st.integers(min_value=0, max_value=7),
    )
    def test_both_splits_conserve_and_equal_the_reference(self, jref, counts, weights, ptr):
        counts = np.asarray(counts, dtype=np.int64)
        weights = np.asarray(weights, dtype=np.int64)
        for split, jsplit in ((proportional_split, jref["sim"].proportional_split),
                              (pack_split, jref["sim"].pack_split)):
            out, dropped, new_ptr = split(counts, weights, ptr=ptr)
            assert np.array_equal(out.sum(axis=1) + dropped, counts)
            if weights.sum() > 0:
                assert not dropped.any()
            assert (out <= counts[:, None]).all()
            j_out, j_dropped, j_ptr = jsplit(counts, weights, ptr=ptr)
            assert np.array_equal(out, j_out) and np.array_equal(dropped, j_dropped)
            assert new_ptr == j_ptr


# ---------------------------------------------------------------------------
# the differential spine
# ---------------------------------------------------------------------------
class TestCollapse:
    def test_one_region_one_rack_is_run_routed_and_the_reference(self, jref):
        """1-region/1-rack, no autoscaler, no faults == the port's flat
        ``run_routed`` bit for bit, across epoch boundaries (257 ticks,
        epochs of 50), and == the reference's hierarchy."""
        topo, jtopo = _topologies(jref, n_regions=1, racks_per_region=1, devices_per_rack=8,
                                  request_period_ms=120.0)
        rack = topo.regions[0].racks[0]
        counts = np.random.default_rng(7).poisson(3.0, size=257).astype(np.int64)
        res = run_hierarchy(topo, counts, dt_ms=50.0, epoch_ticks=50)
        ref = run_routed(rack.params, counts, dt_ms=50.0, router=rack.router,
                         queue_capacity=rack.queue_capacity)
        state = res.racks[rack.name].state
        for f in STATE_FIELDS:
            assert torch.equal(getattr(ref.state, f), getattr(state, f)), f
        assert np.array_equal(np.sort(ref.latency_ms[ref.served_mask].numpy()),
                              np.sort(res.latency_ms))
        rr = res.racks[rack.name]
        assert rr.arrived == int(counts.sum())
        assert rr.served == int(ref.state.n_served.sum())
        assert res.global_dropped == 0 and not any(res.region_dropped.values())
        assert res.total_energy_mj == float(np.sum(ref.state.energy_mj.numpy()))
        ref_led = ref.ledger().aggregate().to_dict()
        for led in (rr.ledger(), res.region_ledger("r0"), res.total_ledger()):
            for axis, val in ref_led.items():
                assert led.to_dict()[axis] == pytest.approx(val, abs=1e-9)
        jres = jref["sim"].run_hierarchy(jtopo, counts, dt_ms=50.0, epoch_ticks=50)
        assert_same_result(jref, res, jres)

    @pytest.mark.parametrize("strategy", ["on_off", "idle_waiting"])
    def test_rack_n1_matches_scalar_oracle(self, strategy):
        spec = ExperimentSpec(
            workload=WorkloadSpec(41.47, 40.0),
            item=paper_lstm_item(),
            strategy_kind=strategy,
            method=IdlePowerMethod.METHOD1_2,
            powerup_overhead_mj=CAL,
        )
        oracle = simulate(spec)
        rack = RackSpec(name="solo", params=FleetParams.from_specs(
            [DeviceSpec.from_experiment(spec)], device=CPU))
        fleet = run_rack_periodic(rack, n_steps=oracle.n_items + 10)
        assert int(fleet.n_items[0]) == oracle.n_items
        assert abs(float(fleet.energy_mj[0]) - oracle.energy_used_mj) <= 1e-9
        assert float(fleet.lifetime_ms[0]) == oracle.lifetime_ms

    def test_epoch_partition_invariance(self):
        topo = uniform_topology(**_small(), device=CPU)
        counts = np.random.default_rng(3).poisson(2.0, size=96).astype(np.int64)
        runs = [run_hierarchy(topo, counts, dt_ms=40.0, epoch_ticks=e) for e in (7, 32, 96)]
        base = runs[0]
        for other in runs[1:]:
            for name in base.racks:
                a, b = base.racks[name].state, other.racks[name].state
                for f in STATE_FIELDS:
                    assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)


# ---------------------------------------------------------------------------
# full runs against the reference on the same counts
# ---------------------------------------------------------------------------
def _day_counts(n_ticks=1024, n_devices=16, seed=0):
    """A diurnal-plus-flash stream from the CLI's sampler (host generators)."""
    from repro_torch.launch.control import _global_counts

    args = type("Args", (), dict(load=0.5, days=1.0, amplitude=0.8, flash_every=64.0,
                                 flash_len=256, seed=seed))
    return _global_counts(args, n_ticks, 100.0, n_devices)


def _full_run(jref, factories, charge_idle_tail=True, n_ticks=1024):
    kwargs = dict(n_regions=2, racks_per_region=2, devices_per_rack=4,
                  strategies=("idle_waiting",), request_period_ms=100.0,
                  powerup_overhead_mj=CAL, bringup_ms=2000.0, bringup_mj=200.0, model_axis=2)
    topo, jtopo = _topologies(jref, **kwargs)
    counts = _day_counts(n_ticks, topo.n_devices)
    faults = random_schedule(topo, n_ticks, 3, seed=1)
    jfaults = jref["faults"].random_schedule(jtopo, n_ticks, 3, seed=1)
    assert [dataclasses.astuple(f) for f in faults] == [dataclasses.astuple(f) for f in jfaults]
    run = dict(dt_ms=100.0, epoch_ticks=64, heartbeat_timeout_s=12.8,
               rack_routing="pack", charge_idle_tail=charge_idle_tail)
    ours = run_hierarchy(topo, counts, autoscaler_factory=factories[0], faults=faults, **run)
    ref = jref["sim"].run_hierarchy(jtopo, counts, autoscaler_factory=factories[1],
                                    faults=jfaults, **run)
    return ours, ref


def _trained_json(seed=7):
    """One TrainedPolicy JSON with a non-zero network (both packages load it)."""
    from repro_torch.policy import features as F

    rng = np.random.default_rng(seed)
    sizes = (F.N_FEATURES, 8, 1)
    params = [{"w": rng.normal(0.0, 1.0, (a, b)) / math.sqrt(a), "b": 0.1 * rng.normal(0.0, 1.0, (b,))}
              for a, b in zip(sizes[:-1], sizes[1:])]
    base = untrained_policy(paper_lstm_item())
    return json.dumps(TrainedPolicy(params=params, consts=base.consts, history={},
                                    meta=base.meta).to_json_dict())


class TestFullRuns:
    def test_crossover_autoscaler_faults_pack_idle_tail(self, jref):
        ours, ref = _full_run(jref, (CrossoverAutoscaler.for_rack,
                                     jref["auto"].CrossoverAutoscaler.for_rack))
        assert_same_result(jref, ours, ref)
        assert ours.injector.n_crashes == 3
        assert sum(r.n_restarts for r in ours.racks.values()) >= 1
        ours.assert_conserves()

    def test_fixed_timeout_policy_autoscaler(self, jref):
        def factory(pkg_auto, fixed):
            def make(spec):
                t_be = pkg_auto.rack_break_even_ms(pkg_auto.rack_reconfig_energy_mj(spec),
                                                   pkg_auto.rack_idle_power_mw(spec))
                return pkg_auto.PolicyAutoscaler(fixed(timeout_ms=0.25 * t_be,
                                                       idle_power_mw=pkg_auto.rack_idle_power_mw(spec)))
            return make

        import repro_torch.control.autoscaler as auto

        ours, ref = _full_run(jref, (factory(auto, FixedTimeoutPolicy),
                                     factory(jref["auto"], jref["adaptive"].FixedTimeoutPolicy)))
        assert_same_result(jref, ours, ref)
        assert sum(r.n_power_offs for r in ours.racks.values()) >= 1

    def test_learned_policy_autoscaler_from_one_json(self, jref):
        blob = _trained_json()

        def ours_factory(spec):
            item = rack_workload_item(spec)
            return PolicyAutoscaler(LearnedTimeoutPolicy(
                TrainedPolicy.from_json_dict(json.loads(blob)), item=item,
                idle_power_mw=rack_idle_power_mw(spec)))

        def ref_factory(spec):
            a = jref["auto"]
            item = a.rack_workload_item(spec)
            return a.PolicyAutoscaler(jref["controller"].LearnedTimeoutPolicy(
                jref["train"].TrainedPolicy.from_json_dict(json.loads(blob)), item=item,
                idle_power_mw=a.rack_idle_power_mw(spec)))

        ours, ref = _full_run(jref, (ours_factory, ref_factory))
        assert_same_result(jref, ours, ref)
        for name, r in ours.racks.items():
            assert r.autoscaler.summary() == ref.racks[name].autoscaler.summary()

    def test_pareto_section_equals_the_reference(self, jref):
        points = [
            {"policy": "a", "energy_mj": 10.0, "latency_p99_ms": 5.0, "drop_fraction": 0.0},
            {"policy": "b", "energy_mj": 8.0, "latency_p99_ms": None, "drop_fraction": 0.1},
            {"policy": "c", "energy_mj": 8.0, "latency_p99_ms": 7.0, "drop_fraction": 0.0},
            {"policy": "d", "energy_mj": 12.0, "latency_p99_ms": 7.0, "drop_fraction": 0.2},
            {"policy": "e", "energy_mj": 8.0, "latency_p99_ms": 7.0, "drop_fraction": 0.0},
        ]
        ours = pareto_section(points)
        assert ours == jref["report"].pareto_section(points)
        assert ours["frontier"] == [0, 2, 4]
        assert pareto_section([]) == {"points": [], "frontier": []}


@pytest.mark.parametrize("edit", ["_drop_queues", "_derezident", "_mask_devices"])
def test_state_edits_keep_the_carry_and_continue_like_the_reference(jref, edit):
    """A crash, a power-off or a lost device rewrites the routed carry
    between chunks; the edited state keeps every dtype and shape, and the
    next chunk continues from it bit for bit as the reference's does."""
    import repro_torch.control.simulate as sim

    topo, jtopo = _topologies(jref, n_regions=1, racks_per_region=1, devices_per_rack=6,
                              request_period_ms=40.0)
    rack, jrack = topo.racks()[0], jtopo.racks()[0]
    counts = np.random.default_rng(5).poisson(9.0, size=80).astype(np.int64)
    ok = np.array([True, False, True, True, False, True])
    args = (ok,) if edit == "_mask_devices" else ()
    first = run_routed(rack.params, counts[:40], 20.0, queue_capacity=4)
    jfirst = jref["routed"](jrack.params, counts[:40], 20.0, queue_capacity=4)
    edited = getattr(sim, edit)(first.state, *args)
    jedited = getattr(jref["sim"], edit)(jfirst.state, *args)
    for f in STATE_FIELDS:
        a, b = getattr(edited, f), getattr(first.state, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
    assert_same_state(edited, jedited, edit)
    second = run_routed(rack.params, counts[40:], 20.0, state0=edited, start_tick=40)
    jsecond = jref["routed"](jrack.params, counts[40:], 20.0, state0=jedited, start_tick=40)
    assert_same_state(second.state, jsecond.state, edit)
    assert np.array_equal(second.latency_ms.numpy(), np.asarray(jsecond.latency_ms))


def test_random_schedule_draws_the_references_faults(jref):
    topo, jtopo = _topologies(jref, n_regions=3, racks_per_region=4, devices_per_rack=6)
    for seed in range(5):
        ours = random_schedule(topo, 4096, 7, seed=seed, max_lost_frac=0.75)
        ref = jref["faults"].random_schedule(jtopo, 4096, 7, seed=seed, max_lost_frac=0.75)
        assert [dataclasses.astuple(f) for f in ours] == [dataclasses.astuple(f) for f in ref]


def test_concat_params_is_the_column_concatenation(jref):
    topo, jtopo = _topologies(jref, n_regions=2, racks_per_region=2, devices_per_rack=3,
                              strategies=("on_off", "adaptive"))
    flat = concat_params([r.params for r in topo.racks()])
    jflat = jref["hier"].concat_params([r.params for r in jtopo.racks()])
    assert flat.n_devices == 12
    for f in dataclasses.fields(flat):
        a, b = getattr(flat, f.name).numpy(), np.asarray(getattr(jflat, f.name))
        assert a.dtype == b.dtype and np.array_equal(a, b), f.name
    with pytest.raises(ValueError):
        concat_params([])


# ---------------------------------------------------------------------------
# conservation under property-driven faults, against the reference
# ---------------------------------------------------------------------------
@settings(max_examples=6, deadline=None)
@given(
    st.integers(min_value=1, max_value=2),
    st.integers(min_value=1, max_value=3),
    st.integers(min_value=1, max_value=4),
    st.lists(st.tuples(st.integers(min_value=0, max_value=9),
                       st.integers(min_value=0, max_value=9999),
                       st.integers(min_value=0, max_value=9)),
             min_size=0, max_size=4),
    st.integers(min_value=0, max_value=10_000),
    st.sampled_from(["spread", "pack"]),
)
def test_random_faults_conserve_and_equal_the_reference(jref, n_regions, racks_per_region,
                                                         devices, fault_list, seed, routing):
    n_ticks = 96
    kwargs = dict(n_regions=n_regions, racks_per_region=racks_per_region,
                  devices_per_rack=devices, request_period_ms=80.0, bringup_ms=60.0,
                  bringup_mj=20.0, model_axis=2 if devices % 2 == 0 else 1)
    topo, jtopo = _topologies(jref, **kwargs)
    counts = np.random.default_rng(seed).poisson(0.4 * topo.n_devices, size=n_ticks).astype(np.int64)
    faults = FaultSchedule(tuple(
        RackFault(rack=topo.racks()[r % topo.n_racks].name, crash_tick=t % n_ticks,
                  lost_devices=lost % (devices + 1))
        for (r, t, lost) in fault_list
    ))
    faults, jfaults = _faults(jref, faults)
    run = dict(dt_ms=20.0, epoch_ticks=16, heartbeat_timeout_s=0.3, rack_routing=routing,
               charge_idle_tail=routing == "pack")
    res = run_hierarchy(topo, counts, autoscaler_factory=CrossoverAutoscaler.for_rack,
                        faults=faults, jit=False, **run)
    c = res.assert_conserves(rtol=1e-9)
    assert res.arrived == int(counts.sum())
    assert res.served + res.dropped + res.in_flight == res.arrived
    assert all(v == 0 for v in c["rack_requests"].values())
    flat = res.flat_device_energy_mj + sum(
        r.bringup_energy_mj + r.idle_tail_mj for r in res.racks.values())
    assert res.total_ledger().conservation_error(flat) <= 1e-9
    ref = jref["sim"].run_hierarchy(jtopo, counts,
                                    autoscaler_factory=jref["auto"].CrossoverAutoscaler.for_rack,
                                    faults=jfaults, jit=False, **run)
    assert_same_result(jref, res, ref)


# ---------------------------------------------------------------------------
# crash, restart and fencing
# ---------------------------------------------------------------------------
class TestFaultEvents:
    def _run(self, jref, lost):
        topo, jtopo = _topologies(jref, **_small(devices_per_rack=4, model_axis=2))
        victim = topo.racks()[0].name
        counts = np.full(96, 2, dtype=np.int64)
        faults, jfaults = _faults(jref, FaultSchedule((RackFault(victim, 20, lost),)))
        run = dict(dt_ms=20.0, epoch_ticks=16, heartbeat_timeout_s=0.3)
        res = run_hierarchy(topo, counts, faults=faults, **run)
        assert_same_result(jref, res, jref["sim"].run_hierarchy(jtopo, counts, faults=jfaults, **run))
        return topo, victim, res

    def test_crash_restart_charges_bringup(self, jref):
        topo, victim, res = self._run(jref, lost=1)
        rk = res.racks[victim]
        assert res.injector.n_crashes == 1 and res.injector.n_detected == 1
        assert rk.n_restarts == 1 and rk.n_power_ons == 0
        assert rk.bringup_energy_mj == topo.rack(victim).bringup_mj
        assert rk.usable_devices == 2 and rk.lost_devices == 1
        dev_cfg = rk.device_ledger().aggregate().to_dict()["configure_mj"]
        assert rk.ledger().to_dict()["configure_mj"] == pytest.approx(dev_cfg + 50.0, rel=1e-12)
        res.assert_conserves()

    def test_unrecoverable_rack_is_fenced(self, jref):
        topo, victim, res = self._run(jref, lost=3)
        rk = res.racks[victim]
        assert rk.unrecoverable and not rk.powered
        assert rk.n_restarts == 0 and rk.bringup_energy_mj == 0.0
        assert rk.usable_devices == 0
        other = [r for n, r in res.racks.items() if n != victim][0]
        assert other.arrived > 0
        res.assert_conserves()


# ---------------------------------------------------------------------------
# rack-level closed forms
# ---------------------------------------------------------------------------
class TestRackClosedForms:
    def test_reconfig_energy_is_bringup_plus_child_configs(self, jref):
        topo, jtopo = _topologies(jref, **_small())
        spec, jspec = topo.racks()[0], jtopo.racks()[0]
        expect = spec.bringup_mj + float(np.sum(spec.params.e_config_mj.numpy()))
        assert rack_reconfig_energy_mj(spec) == expect == jref["auto"].rack_reconfig_energy_mj(jspec)
        assert rack_idle_power_mw(spec) == float(np.sum(spec.params.p_idle_mw.numpy()))
        assert rack_idle_power_mw(spec) == jref["auto"].rack_idle_power_mw(jspec)

    def test_break_even_and_crossover_edges(self):
        assert rack_break_even_ms(10.0, 0.0) == math.inf
        assert rack_break_even_ms(0.0, 50.0) == 0.0
        assert rack_crossover_ms(0.0, 50.0, ready_ms=7.0) == 7.0
        assert rack_crossover_ms(10.0, 100.0) == 100.0

    def test_rack_workload_item_round_trips_the_constants(self, jref):
        topo, jtopo = _topologies(jref, **_small())
        spec = topo.racks()[0]
        item = rack_workload_item(spec)
        assert item.idle_power_mw == rack_idle_power_mw(spec)
        assert item.config_energy_mj == pytest.approx(rack_reconfig_energy_mj(spec), rel=1e-12)
        assert item.config_time_ms == spec.bringup_ms
        jitem = jref["auto"].rack_workload_item(jtopo.racks()[0])
        assert (item.name, item.idle_power_mw, item.config_energy_mj, item.config_time_ms) == (
            jitem.name, jitem.idle_power_mw, jitem.config_energy_mj, jitem.config_time_ms)


# ---------------------------------------------------------------------------
# autoscaler no-flap
# ---------------------------------------------------------------------------
class TestAutoscalerNoFlap:
    @pytest.fixture
    def specs(self, jref):
        topo, jtopo = _topologies(jref, **_small())
        return topo.racks()[0], jtopo.racks()[0]

    @pytest.mark.parametrize("eps", [0.02, 0.08])
    def test_crossover_autoscaler_at_most_one_transition(self, jref, specs, eps):
        a = CrossoverAutoscaler.for_rack(specs[0])
        j = jref["auto"].CrossoverAutoscaler.for_rack(specs[1])
        cross = a.crossover_ms()
        assert cross == j.crossover_ms()
        for i in range(400):
            gap = cross * (1.0 + (eps if i % 2 == 0 else -eps))
            a.observe_gap(gap)
            j.observe_gap(gap)
            assert a.idle_timeout_ms() == j.idle_timeout_ms()
        assert a.power_transitions <= 1
        assert a.summary() == j.summary()

    @pytest.mark.parametrize("eps", [0.02, 0.08])
    def test_learned_policy_autoscaler_at_most_one_transition(self, jref, specs, eps):
        item = rack_workload_item(specs[0])
        pol = LearnedTimeoutPolicy(untrained_policy(item), item=item,
                                   idle_power_mw=rack_idle_power_mw(specs[0]))
        jitem = jref["auto"].rack_workload_item(specs[1])
        jpol = jref["controller"].LearnedTimeoutPolicy(
            jref["train"].untrained_policy(jitem), item=jitem,
            idle_power_mw=jref["auto"].rack_idle_power_mw(specs[1]))
        pa, ja = PolicyAutoscaler(pol), jref["auto"].PolicyAutoscaler(jpol)
        cross = pol.crossover_ms()
        for i in range(400):
            gap = cross * (1.0 + (eps if i % 2 == 0 else -eps))
            pa.observe_gap(gap)
            ja.observe_gap(gap)
            assert pa.idle_timeout_ms() == ja.idle_timeout_ms()
        assert pa.power_transitions <= 1
        assert pa.power_transitions == ja.power_transitions

    def test_crossover_autoscaler_clear_regimes(self, specs):
        short = CrossoverAutoscaler.for_rack(specs[0])
        for _ in range(10):
            short.observe_gap(short.crossover_ms() * 0.3)
        assert short.idle_timeout_ms() == math.inf
        long = CrossoverAutoscaler.for_rack(specs[0])
        for _ in range(10):
            long.observe_gap(long.crossover_ms() * 3.0)
        assert long.idle_timeout_ms() == 0.0

    def test_warmup_uses_break_even(self, specs):
        a = CrossoverAutoscaler.for_rack(specs[0], min_observations=5)
        a.observe_gap(1.0)
        assert a.idle_timeout_ms() == a.break_even_ms()


# ---------------------------------------------------------------------------
# autoscaling inside the hierarchy
# ---------------------------------------------------------------------------
class TestAutoscaledHierarchy:
    def test_night_powers_off_flash_powers_on(self, jref):
        topo, jtopo = _topologies(jref, **_small())
        counts = np.concatenate([np.full(64, 4), np.zeros(64), np.full(32, 12)]).astype(np.int64)
        run = dict(dt_ms=50.0, epoch_ticks=16)
        res = run_hierarchy(topo, counts, autoscaler_factory=CrossoverAutoscaler.for_rack, **run)
        offs = {n: r.n_power_offs for n, r in res.racks.items()}
        ons = {n: r.n_power_ons for n, r in res.racks.items()}
        assert sum(offs.values()) == 1 and sum(ons.values()) == 1
        assert sorted(offs.values()) == [0, 1]
        cycled = [n for n, v in offs.items() if v == 1][0]
        assert ons[cycled] == 1
        assert res.racks[cycled].bringup_energy_mj == topo.rack(cycled).bringup_mj
        res.assert_conserves()
        ref = jref["sim"].run_hierarchy(
            jtopo, counts, autoscaler_factory=jref["auto"].CrossoverAutoscaler.for_rack, **run)
        assert_same_result(jref, res, ref)

    def test_idle_tail_makes_always_on_pay_for_the_night(self, jref):
        kwargs = dict(n_regions=1, racks_per_region=2, devices_per_rack=4,
                      strategies=("idle_waiting",), request_period_ms=100.0,
                      bringup_ms=100.0, bringup_mj=50.0)
        topo, jtopo = _topologies(jref, **kwargs)
        counts = np.concatenate([np.full(64, 6), np.zeros(192)]).astype(np.int64)
        run = dict(dt_ms=50.0, epoch_ticks=16, rack_routing="pack", charge_idle_tail=True)
        always_on = run_hierarchy(topo, counts, **run)
        scaled = run_hierarchy(topo, counts, autoscaler_factory=CrossoverAutoscaler.for_rack, **run)
        always_on.assert_conserves()
        scaled.assert_conserves()
        assert sum(r.n_power_offs for r in scaled.racks.values()) >= 1
        assert scaled.total_energy_mj < always_on.total_energy_mj
        j = jref["sim"]
        assert_same_result(jref, always_on, j.run_hierarchy(jtopo, counts, **run))
        assert_same_result(jref, scaled, j.run_hierarchy(
            jtopo, counts, autoscaler_factory=jref["auto"].CrossoverAutoscaler.for_rack, **run))


def test_walkthrough_doctest():
    """``repro_torch.control``'s walkthrough: (1, 1) power cycles, 0 for the
    rack that stays up, 640 requests conserved, the five contracts."""
    result = doctest.testmod(control, raise_on_error=False)
    assert result.attempted >= 8 and result.failed == 0


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        uniform_topology(1, 1, 2)
