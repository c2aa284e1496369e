"""The port's fault-tolerance primitives (``distributed/fault_tolerance.py``:
heartbeats, stragglers, elastic planning, the step watchdog) on a fake
clock, each scenario driven through the port and the JAX package's copy
with the same results; and the restart path through the port's control
plane, charged as a rack reconfiguration exactly as the reference charges
it.  The reference's training-resume test (``TestRestartPath``) calls
``repro.launch.train``, which comes with the training slice."""
import numpy as np
import pytest

from repro_torch.distributed import fault_tolerance as ft


@pytest.fixture(scope="module")
def jft():
    """The reference's module (pure Python; imports no jax)."""
    from repro.distributed import fault_tolerance as jft

    return jft


@pytest.fixture(scope="module")
def jref():
    """The JAX package's control plane, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.control import faults as jfaults
    from repro.control import hierarchy as jhier
    from repro.control import simulate as jsim

    return dict(faults=jfaults, hier=jhier, sim=jsim)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def both(jft):
    return (ft, jft)


class TestHeartbeat:
    def test_dead_node_detection(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            m = mod.HeartbeatMonitor(["n0", "n1", "n2"], timeout_s=10, clock=clock)
            clock.advance(5)
            m.beat("n0")
            m.beat("n1")
            clock.advance(7)
            assert m.dead_nodes() == ["n2"]
            assert set(m.alive_nodes()) == {"n0", "n1"}


class TestHeartbeatRevival:
    def test_beat_revives_dead_node(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            m = mod.HeartbeatMonitor(["n0", "n1"], timeout_s=10, clock=clock)
            clock.advance(11)
            assert set(m.dead_nodes()) == {"n0", "n1"}
            m.beat("n0")
            assert m.dead_nodes() == ["n1"]
            assert m.alive_nodes() == ["n0"]

    def test_exactly_at_timeout_is_alive(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            m = mod.HeartbeatMonitor(["n0"], timeout_s=10, clock=clock)
            clock.advance(10)
            assert m.dead_nodes() == []
            clock.advance(1e-6)
            assert m.dead_nodes() == ["n0"]


class TestStraggler:
    def test_outlier_flagged(self, jft):
        for mod in both(jft):
            d = mod.StragglerDetector(window=4, k=2.0)
            for _ in range(4):
                for n in ("n0", "n1", "n2", "n3"):
                    d.record(n, 1.0 if n != "n3" else 3.5)
            assert d.stragglers() == ["n3"]
            assert d.medians() == {"n0": 1.0, "n1": 1.0, "n2": 1.0, "n3": 3.5}

    def test_uniform_fleet_clean(self, jft):
        for mod in both(jft):
            d = mod.StragglerDetector()
            for n in ("n0", "n1"):
                d.record(n, 1.0)
            assert d.stragglers() == []

    def test_window_forgets_old_slowness(self, jft):
        for mod in both(jft):
            d = mod.StragglerDetector(window=3, k=2.0)
            for n in ("n0", "n1", "n2"):
                d.record(n, 1.0)
            d.record("n2", 9.0)
            assert d.stragglers() == ["n2"]
            for _ in range(3):
                for n in ("n0", "n1", "n2"):
                    d.record(n, 1.0)
            assert d.stragglers() == []


class TestElasticPlan:
    def test_shrink_keeps_model_axis(self, jft):
        for mod in both(jft):
            plan = mod.plan_elastic_mesh(488, model_axis=16)
            assert plan.model == 16 and plan.data == 30 and plan.devices == 480

    def test_infeasible_returns_none(self, jft):
        for mod in both(jft):
            assert mod.plan_elastic_mesh(8, model_axis=16) is None
            assert mod.plan_elastic_mesh(31, model_axis=16, min_data=2) is None


class TestWatchdog:
    def test_retry_then_escalate(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            failures = []
            w = mod.StepWatchdog(deadline_s=1.0, max_retries=1,
                                 on_failure=lambda: failures.append(1), clock=clock)

            def slow_step():
                clock.advance(5.0)
                return "x"

            assert w.run(slow_step) == "x"
            assert w.timeouts == 2
            assert failures == [1]

    def test_fast_step_passes(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            w = mod.StepWatchdog(deadline_s=1.0, clock=clock)

            def quick():
                clock.advance(0.1)
                return 42

            assert w.run(quick) == 42
            assert w.timeouts == 0

    def test_zero_retries_escalates_immediately(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            failures = []
            w = mod.StepWatchdog(deadline_s=1.0, max_retries=0,
                                 on_failure=lambda: failures.append(1), clock=clock)

            def slow():
                clock.advance(2.0)
                return "r"

            assert w.run(slow) == "r"
            assert w.timeouts == 1
            assert failures == [1]

    def test_recovery_on_retry_skips_escalation(self, jft):
        for mod in both(jft):
            clock = FakeClock()
            failures = []
            durations = iter([5.0, 0.1])

            def step():
                clock.advance(next(durations))
                return "ok"

            w = mod.StepWatchdog(deadline_s=1.0, max_retries=1,
                                 on_failure=lambda: failures.append(1), clock=clock)
            assert w.run(step) == "ok"
            assert w.timeouts == 1
            assert failures == []


class TestRestartCharging:
    def test_elastic_restart_charged_as_rack_reconfiguration(self, jref):
        """Through the port's control plane: rack crash → heartbeat
        detection → elastic restart, charged once as the rack's
        configuration phase (the bring-up on the ledger's configure axis),
        equal to the reference's run on the same schedule."""
        from repro_torch.control import FaultSchedule, RackFault, run_hierarchy, uniform_topology

        kwargs = dict(n_regions=1, racks_per_region=2, devices_per_rack=2,
                      request_period_ms=80.0, bringup_ms=40.0, bringup_mj=12.5)
        topo = uniform_topology(**kwargs, device="cpu")
        jtopo = jref["hier"].uniform_topology(**kwargs)
        victim = topo.racks()[0].name
        counts = np.full(64, 1, dtype=np.int64)
        run = dict(dt_ms=20.0, epoch_ticks=16, heartbeat_timeout_s=0.3)
        res = run_hierarchy(topo, counts, faults=FaultSchedule((RackFault(victim, crash_tick=10),)),
                            **run)
        rk = res.racks[victim]
        assert rk.n_restarts == 1 and rk.n_power_ons == 0
        assert rk.bringup_energy_mj == 12.5
        device_cfg = rk.device_ledger().aggregate().to_dict()["configure_mj"]
        assert rk.ledger().to_dict()["configure_mj"] == pytest.approx(device_cfg + 12.5, rel=1e-12)
        res.assert_conserves()

        j = jref["faults"]
        ref = jref["sim"].run_hierarchy(
            jtopo, counts, faults=j.FaultSchedule((j.RackFault(victim, crash_tick=10),)), **run)
        jrk = ref.racks[victim]
        assert rk.ledger().to_dict() == jrk.ledger().to_dict()
        assert (rk.n_restarts, rk.usable_devices, rk.served, rk.dropped) == (
            jrk.n_restarts, jrk.usable_devices, jrk.served, jrk.dropped)
        assert res.total_energy_mj == ref.total_energy_mj
