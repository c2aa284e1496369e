"""The rest of the port's Decide step vs the JAX package: the deployment
planner, the scalar arrival processes and ``bin_arrival_counts``,
``run_process_schedule`` under a fake clock, the adaptive-serving example
line for line, and the duty-cycle example on the CPU.

The planner and the arrival streams are pure-Python and numpy float math on
both sides, so values must be equal, not close; the counts are int32."""
import dataclasses
import io
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import arrivals, planner
from repro_torch.core import energy_model as em
from repro_torch.core.phases import paper_lstm_item
from test_torch_x64_shim import x64_shim

ROOT = Path(__file__).resolve().parents[1]
CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ


@pytest.fixture(scope="module")
def jref():
    """The JAX package's Decide modules, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` (imported by ``repro.core.arrivals``) is
    gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.core.duty_cycle
        import repro.serving.scheduler
        from repro.core import arrivals as jarrivals
        from repro.core import energy_model as jem
        from repro.core import phases, planner as jplanner

    return dict(arrivals=jarrivals, planner=jplanner, em=jem, phases=phases,
                duty=repro.core.duty_cycle, sched=repro.serving.scheduler)


# ---------------------------------------------------------------------------
# the planner: every case of tests/test_planner_multitenant.py::TestPlanner
# ---------------------------------------------------------------------------
def _items(jref):
    return paper_lstm_item(), jref["phases"].paper_lstm_item()


@pytest.mark.parametrize("p_mw", [134.3, 34.2, 24.0])
def test_required_idle_power_inverts_lifetime_as_jax(jref, p_mw):
    item, jitem = _items(jref)
    n = em.idlewait_n_max(item, 40.0, idle_power_mw=p_mw, powerup_overhead_mj=CAL)
    assert n == jref["em"].idlewait_n_max(jitem, 40.0, idle_power_mw=p_mw, powerup_overhead_mj=CAL)
    hours = n * 40.0 / 3.6e6
    req = planner.required_idle_power(item, 40.0, hours, powerup_overhead_mj=CAL)
    assert req == jref["planner"].required_idle_power(jitem, 40.0, hours, powerup_overhead_mj=CAL)
    assert req == pytest.approx(p_mw, rel=1e-3)


@pytest.mark.parametrize("period_ms,target_h", [(40.0, 10_000.0), (40.0, 0.0), (0.01, 1.0),
                                                (500.0, 30.0)])
def test_required_idle_power_edges_as_jax(jref, period_ms, target_h):
    """Unreachable (None), a single item (inf), a period shorter than the
    latency (None), and an ordinary point."""
    item, jitem = _items(jref)
    ours = planner.required_idle_power(item, period_ms, target_h, powerup_overhead_mj=CAL)
    theirs = jref["planner"].required_idle_power(jitem, period_ms, target_h, powerup_overhead_mj=CAL)
    assert ours == theirs
    if target_h == 10_000.0:
        assert ours is None


def test_required_budget_matches_forward_model_as_jax(jref):
    item, jitem = _items(jref)
    b = planner.required_budget(item, 40.0, 1000, powerup_overhead_mj=CAL)
    assert b == jref["planner"].required_budget(jitem, 40.0, 1000, powerup_overhead_mj=CAL)
    assert em.idlewait_n_max(item, 40.0, e_budget_mj=b, powerup_overhead_mj=CAL) == 1000
    assert planner.required_budget(item, 40.0, 1000, idle_power_mw=24.0) == \
        jref["planner"].required_budget(jitem, 40.0, 1000, idle_power_mw=24.0)


@pytest.mark.parametrize("delta_ms", [-5.0, 5.0])
def test_best_strategy_matches_crossover_as_jax(jref, delta_ms):
    item, jitem = _items(jref)
    cross = em.crossover_period_ms(item, powerup_overhead_mj=CAL)
    assert cross == jref["em"].crossover_period_ms(jitem, powerup_overhead_mj=CAL)
    ours = planner.best_strategy(item, cross + delta_ms, powerup_overhead_mj=CAL)
    assert ours == jref["planner"].best_strategy(jitem, cross + delta_ms, powerup_overhead_mj=CAL)
    assert ours == ("idle_waiting" if delta_ms < 0 else "on_off")


def test_best_strategy_infeasible_as_jax(jref):
    item, jitem = _items(jref)
    for period in (0.001, 40.0):
        for budget in (0.0, 1.0):
            assert planner.best_strategy(item, period, budget) == \
                jref["planner"].best_strategy(jitem, period, budget)
    assert planner.best_strategy(item, 0.001) == "infeasible"


@pytest.mark.parametrize(
    "period_ms,target_h,method",
    [(40.0, 30.0, "method1"),             # the paper's Exp. 3: 33.6 h
     (40.0, 45.0, "method1+2"),           # escalates
     (40.0, 60.0, "method1+2"),           # missed even at method 1+2: a note
     (40.0, 10_000.0, "baseline"),        # unreachable at any idle power: a note
     (40.0, None, "baseline"),
     (200.0, None, None)],                # On-Off for long periods
)
def test_plan_as_jax(jref, period_ms, target_h, method):
    item, jitem = _items(jref)
    ours = planner.plan(item, period_ms, target_lifetime_h=target_h, powerup_overhead_mj=CAL)
    theirs = jref["planner"].plan(jitem, period_ms, target_lifetime_h=target_h,
                                  powerup_overhead_mj=CAL)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.method == method
    assert ours.strategy == ("on_off" if period_ms == 200.0 else "idle_waiting")
    if target_h in (30.0, 45.0):
        assert ours.lifetime_h > target_h and not ours.notes
    if target_h in (60.0, 10_000.0):
        assert len(ours.notes) == 1


def test_plan_gives_the_papers_lifetime_ratio():
    """The paper's operating point, 40 ms at methods 1+2: 12.4108× On-Off's
    lifetime (ROADMAP's reference value), and the 499.0607 ms crossover."""
    item = paper_lstm_item()
    p = planner.plan(item, 40.0, target_lifetime_h=45.0, powerup_overhead_mj=CAL)
    oo = em.evaluate_onoff(item, 40.0, powerup_overhead_mj=CAL)
    assert round(p.lifetime_h / oo.lifetime_hours, 4) == 12.4108
    assert round(em.crossover_period_ms(item, 24.0, CAL), 4) == 499.0607


# ---------------------------------------------------------------------------
# arrival processes: sample for sample
# ---------------------------------------------------------------------------
PROCESSES = [
    ("deterministic", dict(period_ms=40.0)),
    ("jittered", dict(period_ms=100.0, jitter=0.2)),
    ("jittered", dict(period_ms=100.0, jitter=0.0)),
    ("poisson", dict(mean_ms=500.0)),
    ("mmpp", dict(burst_ms=50.0, quiet_ms=5000.0, mean_burst_len=8)),
    ("bursty", dict(burst_ms=5.0, quiet_ms=300.0)),
    ("diurnal", dict(mean_ms=100.0, day_ms=5000.0)),
    ("diurnal", dict(mean_ms=100.0, day_ms=20_000.0, amplitude=0.9, phase_frac=0.25,
                     burst_ms=5.0, mean_burst_len=4.0, mean_quiet_len=16.0)),
    ("flash_crowd", dict(quiet_ms=200.0, flash_gap_ms=5.0, flash_len=8, flash_every=3.0)),
    ("trace", dict(gaps_ms=(1.0, 0.0, 2.5, 40.0))),
]


@pytest.mark.parametrize("kind,kw", PROCESSES)
def test_arrival_streams_equal_jax_sample_for_sample(jref, kind, kw):
    ours = arrivals.make_process(kind, **kw)
    theirs = jref["arrivals"].make_process(kind, **kw)
    assert type(ours).__name__ == type(theirs).__name__ and ours.name == theirs.name
    assert ours.mean_period_ms() == theirs.mean_period_ms()
    for seed in (0, 1, 7, 12345):
        for n in (0, 1, 2, 17, 1000):
            a, b = ours.inter_arrival_times(n, seed), theirs.inter_arrival_times(n, seed)
            assert a.dtype == np.float64 and a.shape == (n,)
            np.testing.assert_array_equal(a, b)
            a, b = ours.arrival_times(n, seed), theirs.arrival_times(n, seed)
            assert a.dtype == np.float64 and a.shape == (n,)
            np.testing.assert_array_equal(a, b)
            if n:
                assert a[0] == 0.0


@pytest.mark.parametrize(
    "kind,kw",
    [("deterministic", dict(period_ms=0.0)), ("jittered", dict(period_ms=10.0, jitter=-1.0)),
     ("poisson", dict(mean_ms=math.nan)), ("mmpp", dict(burst_ms=1.0, quiet_ms=math.inf)),
     ("mmpp", dict(burst_ms=1.0, quiet_ms=2.0, mean_burst_len=0.5)),
     ("diurnal", dict(mean_ms=1.0, day_ms=10.0, amplitude=1.0)),
     ("diurnal", dict(mean_ms=1.0, day_ms=10.0, phase_frac=math.nan)),
     ("diurnal", dict(mean_ms=1.0, day_ms=10.0, burst_ms=1.0, mean_quiet_len=math.nan)),
     ("flash_crowd", dict(quiet_ms=1.0, flash_gap_ms=1.0, flash_len=0)),
     ("flash_crowd", dict(quiet_ms=1.0, flash_gap_ms=1.0, flash_every=0.5)),
     ("trace", dict(gaps_ms=())), ("trace", dict(gaps_ms=(1.0, -1.0))),
     ("trace", dict(gaps_ms=(1.0, math.nan))), ("trace", dict(gaps_ms=(0.0, 0.0))),
     ("psychic", dict())],
)
def test_arrival_validation_errors_as_jax(jref, kind, kw):
    with pytest.raises(ValueError) as theirs:
        jref["arrivals"].make_process(kind, **kw)
    with pytest.raises(ValueError) as ours:
        arrivals.make_process(kind, **kw)
    assert str(ours.value) == str(theirs.value)


def test_trace_files_and_record_as_jax(jref, tmp_path):
    proc = arrivals.MMPPArrivals(5.0, 300.0)
    ours = arrivals.TraceArrivals.record(proc, 50, seed=3)
    theirs = jref["arrivals"].TraceArrivals.record(jref["arrivals"].MMPPArrivals(5.0, 300.0), 50, seed=3)
    assert ours.gaps_ms == theirs.gaps_ms
    path = tmp_path / "trace.txt"
    ours.to_file(str(path))
    buf = io.StringIO()
    theirs.to_file(buf)
    assert path.read_text() == buf.getvalue()
    assert arrivals.TraceArrivals.from_file(str(path)).gaps_ms == ours.gaps_ms
    np.testing.assert_array_equal(ours.inter_arrival_times(120), theirs.inter_arrival_times(120))
    bad = "# gaps\n1.5\n\n2.0  # fine\nsoon\n"
    with pytest.raises(ValueError) as e_ours:
        arrivals.TraceArrivals.from_file(io.StringIO(bad))
    with pytest.raises(ValueError) as e_theirs:
        jref["arrivals"].TraceArrivals.from_file(io.StringIO(bad))
    assert str(e_ours.value) == str(e_theirs.value) == "<trace>:5: expected an inter-arrival gap in ms, got 'soon'"


@pytest.mark.parametrize("method", ["_batch_gaps", "sample_gaps", "sample_batch"])
def test_batched_sampling_raises_until_its_slice(method):
    """The batched sampling came with its slice (ROADMAP A6): it samples
    from a ``torch.Generator`` now; only the trace replay, which has no
    batched sampler in the reference either, still raises."""
    g = torch.Generator().manual_seed(0)
    out = getattr(arrivals.PoissonArrivals(10.0), method)(g, 4, 8)
    assert out.dtype == torch.float64 and out.shape[0] == 4
    with pytest.raises(NotImplementedError, match="no vectorized batch sampler"):
        getattr(arrivals.TraceArrivals((1.0, 2.0)), method)(g, 4, 8)


@pytest.mark.parametrize(
    "horizon_ms,dt_ms,n_devices,m",
    [(1000.0, 10.0, 5, 40), (1000.0, 7.0, 3, 200), (55.5, 1.25, 8, 64), (10.0, 100.0, 2, 4),
     (4000.0, 40.0, 1, 0)],
)
def test_bin_arrival_counts_equal_jax(jref, horizon_ms, dt_ms, n_devices, m):
    """int32 counts, exactly; ``+inf`` padding, negative times and times at
    or past the tick grid's end count nowhere."""
    rng = np.random.default_rng(int(horizon_ms) + m)
    times = np.full((n_devices, m), np.inf)
    for d in range(n_devices):
        k = rng.integers(0, m + 1)
        times[d, :k] = arrivals.PoissonArrivals(horizon_ms / max(m // 2, 1)).arrival_times(k, seed=d)
    if m >= 4:
        times[0, -3:] = (-1.0, math.ceil(horizon_ms / dt_ms) * dt_ms, 1e30)
    ours = arrivals.bin_arrival_counts(times, horizon_ms, dt_ms)
    theirs = np.asarray(jref["arrivals"].bin_arrival_counts(times, horizon_ms, dt_ms))
    assert ours.dtype == torch.int32 and theirs.dtype == np.int32
    assert tuple(ours.shape) == theirs.shape == (math.ceil(horizon_ms / dt_ms), n_devices)
    np.testing.assert_array_equal(ours.numpy(), theirs)
    ok = np.isfinite(times) & (times >= 0) & (times < ours.shape[0] * dt_ms)
    assert int(ours.sum()) == int(ok.sum())
    # a tensor input gives the same counts on its own device
    assert torch.equal(arrivals.bin_arrival_counts(torch.from_numpy(times), horizon_ms, dt_ms), ours)


def test_bin_arrival_counts_rejects_as_jax(jref):
    for args in ((np.zeros((2, 3)), 10.0, 0.0), (np.zeros((2, 3)), -1.0, 1.0), (np.zeros(3), 10.0, 1.0)):
        with pytest.raises(ValueError) as theirs:
            jref["arrivals"].bin_arrival_counts(*args)
        with pytest.raises(ValueError) as ours:
            arrivals.bin_arrival_counts(*args)
        assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# run_process_schedule under one fake clock
# ---------------------------------------------------------------------------
class FakeTime:
    def __init__(self, bring_up_s=0.3, infer_s=0.05):
        self.t = 0.0
        self.bring_up_s, self.infer_s = bring_up_s, infer_s
        self.served_at = []

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 0.0)

    def bring_up(self):
        self.t += self.bring_up_s
        return object()

    def infer(self, handle, x):
        self.served_at.append(self.t)
        self.t += self.infer_s
        return x

    def release(self, handle):
        pass


def _run_process(duty, sched, proc, strategy, n, seed, time_scale):
    ft = FakeTime()
    power = duty.PowerModel(config_mw=90_000.0, infer_mw=200_000.0, idle_mw=65_000.0)
    ctl = duty.DutyCycleController(ft.bring_up, ft.infer, ft.release, power, strategy, clock=ft.clock)
    res = sched.run_process_schedule(ctl, range(n), proc, seed=seed, time_scale=time_scale,
                                     sleep=ft.sleep, clock=ft.clock)
    return res, ft


@pytest.mark.parametrize("strategy", ["on_off", "idle_waiting", "auto", "adaptive"])
@pytest.mark.parametrize(
    "kind,kw,seed,time_scale",
    [("poisson", dict(mean_ms=500.0), 0, 1.0),
     ("mmpp", dict(burst_ms=50.0, quiet_ms=5000.0), 3, 1.0),
     ("deterministic", dict(period_ms=40.0), 0, 10.0)],
)
def test_run_process_schedule_equals_jax(jref, strategy, kind, kw, seed, time_scale):
    import repro_torch.core.duty_cycle as duty
    import repro_torch.serving.scheduler as sched

    n = 12
    ours, oft = _run_process(duty, sched, arrivals.make_process(kind, **kw), strategy, n, seed,
                             time_scale)
    theirs, jft = _run_process(jref["duty"], jref["sched"], jref["arrivals"].make_process(kind, **kw),
                               strategy, n, seed, time_scale)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.n_requests == n
    assert oft.served_at == jft.served_at
    # no request is served before its arrival offset
    offsets = arrivals.make_process(kind, **kw).arrival_times(n, seed) * time_scale / 1000.0
    assert all(t >= o for t, o in zip(oft.served_at, offsets))


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------
def test_adaptive_serving_prints_the_reference_lines(jref, capsys):
    from repro_torch.examples import adaptive_serving

    # the reference example's body is its __main__ block: run it as a script
    path = ROOT / "examples" / "adaptive_serving.py"
    ns = {"__name__": "__main__"}
    exec(compile(path.read_text(), str(path), "exec"), ns)
    theirs = capsys.readouterr().out.splitlines()
    out = adaptive_serving.main()
    ours = capsys.readouterr().out.splitlines()
    assert ours == theirs
    assert ours[0] == "analytical crossover: 499.06 ms (paper: 499.06 ms)"
    assert round(out["crossover_ms"], 4) == 499.0607
    assert out["fast"]["adaptive"].n_items == out["fast"]["idle_waiting"].n_items
    assert adaptive_serving.N == ns["N"] == 200_000


def test_duty_cycle_serving_runs_on_the_cpu(capsys):
    from repro_torch.examples import duty_cycle_serving as dcs

    out = dcs.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "== duty-cycle serving of qwen3-1.7b (reduced), period = 0.5 s ==" in text
    assert "✓ live measurements agree with the paper's strategy ordering" in text
    for strategy in ("on_off", "idle_waiting", "auto"):
        assert out[strategy].n_requests == dcs.N_REQ
    assert out["on_off"].n_configurations == dcs.N_REQ
    assert out["idle_waiting"].n_configurations == 1
    # the reduced model's bring-up has nothing to compile: its crossover is
    # far below the 0.5 s period, so On-Off wins and auto releases
    assert out["side"] == ("below" if dcs.PERIOD_S * 1000 < out["crossover_ms"] else "above")


@pytest.mark.parametrize("side", ["below", "above"])
def test_duty_cycle_ordering_holds_each_side_to_the_papers_rule(side):
    """Below the crossover the reference's asserts (Idle-Waiting wins, auto
    stays resident); above it the mirror; a result against the rule fails."""
    from repro_torch.examples.duty_cycle_serving import check_ordering

    @dataclasses.dataclass
    class R:
        energy_mj: float
        n_configurations: int

    cross = 2000.0 if side == "below" else 50.0
    win, lose = R(100.0, 1), R(300.0, 8)
    oo, iw = (lose, win) if side == "below" else (win, lose)
    auto = R(0.0, 1 if side == "below" else 8)
    assert check_ordering(0.5, cross, oo, iw, auto) == side
    with pytest.raises(AssertionError):
        check_ordering(0.5, cross, iw, oo, auto)
    with pytest.raises(AssertionError):
        check_ordering(0.5, cross, oo, iw, R(0.0, 8 if side == "below" else 2))


def test_duty_cycle_side_and_energies_come_from_the_same_phases():
    """A load spike in one run's configuration phase moves the shared
    median neither way, and both compared energies charge the same phase
    times, so the two runs cannot fall on different sides of one
    crossover; idle phases stay as measured."""
    from types import SimpleNamespace

    from repro_torch.core.duty_cycle import PhaseRecord, PowerModel
    from repro_torch.core.phases import CONFIGURATION, IDLE, INFERENCE
    from repro_torch.examples import duty_cycle_serving as dcs
    from repro_torch.serving.scheduler import ScheduleResult

    power = PowerModel(config_mw=300.0, infer_mw=200.0, idle_mw=100.0)

    def run(records):
        ctl = SimpleNamespace(power=power, records=[PhaseRecord(n, s, 0.0) for n, s in records])
        res = ScheduleResult("x", 4, 0, sum(power.energy_mj(r) for r in ctl.records), 0.0, {}, None)
        return res, ctl

    # On-Off: four bring-ups of 2 s, one spiked to 9 s; Idle-Waiting: one
    # bring-up, then 0.4 s idle gaps at a 0.5 s period
    oo = run([(CONFIGURATION, 9.0 if i == 0 else 2.0) for i in range(4)] + [(INFERENCE, 0.1)] * 4)
    iw = run([(CONFIGURATION, 2.0)] + [(INFERENCE, 0.1), (IDLE, 0.4)] * 4)
    assert dcs.shared_phases(oo[1], iw[1]) == (2.0, 0.1)
    cross, oo_s, iw_s = dcs.shared_results({"on_off": oo, "idle_waiting": iw})
    assert cross == pytest.approx(em.crossover_period_ms(
        dcs.adaptive.measured_workload_item("m", 300.0, 2.0, 200.0, 0.1, 100.0)))
    assert oo_s.energy_mj == pytest.approx(4 * (300.0 * 2.0 + 200.0 * 0.1))
    assert iw_s.energy_mj == pytest.approx(300.0 * 2.0 + 4 * (200.0 * 0.1 + 100.0 * 0.4))
    assert oo[0].energy_mj == pytest.approx(oo_s.energy_mj + 300.0 * 7.0)   # the live ledger keeps the spike
    auto = SimpleNamespace(n_configurations=1)
    assert dcs.check_ordering(0.5, cross, oo_s, iw_s, auto) == "below"
