"""The port's decision modules vs the JAX package: the configuration-phase
model and sweep, workload specs and their YAML round-trip, the duty-cycle
simulator in both modes and under traces, the energy ledger, and
``Strategy.sweep``; and the port quickstart's Experiments 1–3 against the
reference quickstart's output, line for line.

Both sides are pure-Python float math, so values must be equal, not close;
the ledger conserves to the reference's 1e-9 relative."""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

from repro_torch.core import (
    DEVICES,
    ExperimentSpec,
    IdlePowerMethod,
    PolicyController,
    StaticPolicy,
    WorkloadSpec,
    compare_strategies,
    energy_reduction_factor,
    optimal_params,
    paper_experiment,
    paper_lstm_item,
    simulate,
    simulate_trace,
    sweep_config_space,
    time_reduction_factor,
)
from repro_torch.core import config_phase, workload
from repro_torch.core.energy_model import CALIBRATED_POWERUP_OVERHEAD_MJ
from repro_torch.core.strategies import IdleWaitingStrategy, OnOffStrategy
from repro_torch.obs.ledger import AXES, PHASE_TO_AXIS, EnergyLedger, axis_of_phase

ROOT = Path(__file__).resolve().parents[1]
METHODS = list(IdlePowerMethod)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's core, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` (imported by ``repro.core.arrivals``)
    is gone but ``jax.enable_x64`` remains."""
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import repro.core as core
    from repro.core import adaptive, config_phase as jcp, simulator, strategies
    from repro.core import workload as jwl
    from repro.obs import ledger

    return dict(core=core, adaptive=adaptive, cp=jcp, sim=simulator, strat=strategies,
                wl=jwl, ledger=ledger)


def _jitem(jref):
    return jref["core"].paper_lstm_item()


def _jmethod(jref, method):
    return jref["strat"].IdlePowerMethod(method.value)


def _spec_pair(jref, kind, period, method=IdlePowerMethod.BASELINE, calibrated=True,
               budget_j=4147.0):
    ours = dataclasses.replace(
        paper_experiment(kind, period, method, calibrated),
        workload=WorkloadSpec(budget_j, period))
    theirs = dataclasses.replace(
        jref["core"].paper_experiment(kind, period, _jmethod(jref, method), calibrated),
        workload=jref["wl"].WorkloadSpec(budget_j, period))
    return ours, theirs


def _fields(res) -> dict:
    return {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}


# ---------------------------------------------------------------------------
# configuration phase (Experiment 1)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(DEVICES))
def test_config_sweep_and_factors_equal_jax(jref, name):
    dev, jdev = DEVICES[name], jref["cp"].DEVICES[name]
    assert dataclasses.asdict(dev) == dataclasses.asdict(jdev)
    ours, theirs = sweep_config_space(dev), jref["cp"].sweep_config_space(jdev)
    assert len(ours) == len(theirs) == 66
    for a, b in zip(ours, theirs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    for metric in ("energy", "time"):
        assert dataclasses.asdict(optimal_params(dev, metric)) == dataclasses.asdict(
            jref["cp"].optimal_params(jdev, metric))
    assert energy_reduction_factor(dev) == jref["cp"].energy_reduction_factor(jdev)
    assert time_reduction_factor(dev) == jref["cp"].time_reduction_factor(jdev)
    sub = dict(buswidths=(2, 4), clocks_mhz=(9, 33, 66), compression=(True,))
    assert [dataclasses.asdict(p) for p in sweep_config_space(dev, **sub)] == [
        dataclasses.asdict(p) for p in jref["cp"].sweep_config_space(jdev, **sub)]


@pytest.mark.parametrize("axis,values", [
    ("buswidths", ()), ("clocks_mhz", (66, 3)), ("compression", (True, False)),
])
def test_config_sweep_rejects_bad_axes_as_jax(jref, axis, values):
    dev = DEVICES["spartan7-xc7s15"]
    with pytest.raises(ValueError) as ours:
        sweep_config_space(dev, **{axis: values})
    with pytest.raises(ValueError) as theirs:
        jref["cp"].sweep_config_space(jref["cp"].DEVICES[dev.name], **{axis: values})
    assert str(ours.value) == str(theirs.value)


def test_config_params_validation_as_jax(jref):
    for kw in (dict(buswidth=3), dict(clock_mhz=5.0)):
        with pytest.raises(ValueError) as ours:
            config_phase.ConfigParams(**kw)
        with pytest.raises(ValueError) as theirs:
            jref["cp"].ConfigParams(**kw)
        assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# workload specs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,period,method", [
    ("idle_waiting", 40.0, IdlePowerMethod.BASELINE),
    ("on_off", 120.0, IdlePowerMethod.BASELINE),
    ("idle_waiting", 89.0, IdlePowerMethod.METHOD1_2),
])
def test_workload_dict_and_yaml_round_trip_equal_jax(jref, kind, period, method):
    ours = paper_experiment(kind, period, method)
    theirs = jref["core"].paper_experiment(kind, period, _jmethod(jref, method))
    assert ours.to_dict() == theirs.to_dict()
    text = workload.dumps(ours)
    assert text == jref["wl"].dumps(theirs)
    back = workload.loads(text)
    assert back == ours
    assert jref["wl"].loads(text) == theirs
    assert back.build_strategy().name == ours.build_strategy().name


def test_workload_file_round_trip(tmp_path):
    spec = paper_experiment("on_off", 60.0, calibrated=False)
    path = tmp_path / "exp.yaml"
    workload.dump(spec, str(path))
    assert workload.load(str(path)) == spec
    with open(path) as f:
        assert workload.load(f) == spec


def test_workload_rejects_unknown_strategy_and_unported_model_item(jref):
    bad = dataclasses.replace(paper_experiment(), strategy_kind="sometimes")
    with pytest.raises(ValueError, match="unknown strategy kind"):
        bad.build_strategy()
    d = paper_experiment().to_dict()
    d["item"] = {"model": "mixtral-8x7b", "batch": 8}
    with pytest.raises(NotImplementedError, match="costs slice"):
        ExperimentSpec.from_dict(d)


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------
CASES = [
    ("idle_waiting", 40.0, IdlePowerMethod.BASELINE, True),
    ("on_off", 40.0, IdlePowerMethod.BASELINE, True),
    ("idle_waiting", 89.0, IdlePowerMethod.METHOD1, True),
    ("idle_waiting", 120.0, IdlePowerMethod.METHOD1_2, False),
    ("on_off", 120.0, IdlePowerMethod.BASELINE, False),
    ("on_off", 10.0, IdlePowerMethod.BASELINE, True),        # infeasible period
]


@pytest.mark.parametrize("kind,period,method,calibrated", CASES)
def test_simulate_fast_equals_jax_and_conserves(jref, kind, period, method, calibrated):
    ours, theirs = _spec_pair(jref, kind, period, method, calibrated)
    a, b = simulate(ours), jref["sim"].simulate(theirs)
    assert _fields(a) == _fields(b)
    assert a.lifetime_hours == b.lifetime_hours
    led = a.ledger
    assert isinstance(led, EnergyLedger)
    assert led.to_dict() == b.ledger.to_dict()
    assert led.assert_conserves(a.energy_used_mj) <= 1e-9


@pytest.mark.parametrize("kind,period,method,calibrated", CASES)
def test_simulate_step_with_trace_equals_jax(jref, kind, period, method, calibrated):
    """A small budget keeps the event loop short; the events must agree
    one for one, and the step mode must agree with the fast mode."""
    ours, theirs = _spec_pair(jref, kind, period, method, calibrated, budget_j=2.0)
    (a, ev), (b, jev) = simulate(ours, "step", True), jref["sim"].simulate(theirs, "step", True)
    assert _fields(a) == _fields(b)
    assert [dataclasses.asdict(e) for e in ev] == [dataclasses.asdict(e) for e in jev]
    assert [e.energy_mj for e in ev] == [e.energy_mj for e in jev]
    fast = simulate(ours)
    assert fast.n_items == a.n_items
    assert a.ledger.assert_conserves(a.energy_used_mj) <= 1e-9


def test_simulate_rejects_bad_inputs_as_jax(jref):
    for period, budget in ((-1.0, 4147.0), (math.nan, 4147.0), (40.0, -1.0)):
        ours, theirs = _spec_pair(jref, "on_off", 40.0, budget_j=budget)
        ours = dataclasses.replace(ours, workload=WorkloadSpec(budget, period))
        theirs = dataclasses.replace(theirs, workload=jref["wl"].WorkloadSpec(budget, period))
        with pytest.raises(ValueError) as e1:
            simulate(ours)
        with pytest.raises(ValueError) as e2:
            jref["sim"].simulate(theirs)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="unknown mode"):
        simulate(paper_experiment(), mode="slow")


def _arrivals(seed, n=400):
    rng = np.random.default_rng(seed)
    gaps = np.where(rng.random(n) < 0.3, rng.exponential(900.0, n), rng.exponential(40.0, n))
    return np.cumsum(gaps).tolist()


class _Recorder:
    def __init__(self):
        self.events = []

    def instant(self, *args, **kw):
        self.events.append(("instant", args, tuple(sorted(kw.items()))))

    def complete(self, *args, **kw):
        self.events.append(("complete", args, tuple(sorted(kw.items()))))


@pytest.mark.parametrize("policy", ["on_off", "idle_waiting", "adaptive"])
@pytest.mark.parametrize("budget_mj,overhead", [(4147e3, CALIBRATED_POWERUP_OVERHEAD_MJ), (40.0, 0.0)])
def test_simulate_trace_equals_jax(jref, policy, budget_mj, overhead):
    item, jitem = paper_lstm_item(), _jitem(jref)
    if policy == "adaptive":
        ours, theirs = PolicyController(item), jref["adaptive"].PolicyController(jitem)
    else:
        ours, theirs = StaticPolicy(policy, item), jref["adaptive"].StaticPolicy(policy, jitem)
    times = _arrivals(1)
    rec, jrec = _Recorder(), _Recorder()
    a = simulate_trace(item, times, ours, budget_mj, overhead, recorder=rec)
    b = jref["sim"].simulate_trace(jitem, times, theirs, budget_mj, overhead, recorder=jrec)
    assert _fields(a) == _fields(b)
    assert rec.events == jrec.events
    assert a.energy_per_item_mj == b.energy_per_item_mj
    assert a.ledger.to_dict() == b.ledger.to_dict()
    assert a.ledger.assert_conserves(a.energy_used_mj) <= 1e-9


@pytest.mark.parametrize("bad", [[0.0, -1.0], [5.0, 4.0], [0.0, "x"], [math.inf]])
def test_simulate_trace_rejects_bad_timestamps_as_jax(jref, bad):
    item = paper_lstm_item()
    with pytest.raises(ValueError) as e1:
        simulate_trace(item, bad, StaticPolicy("on_off", item))
    with pytest.raises(ValueError) as e2:
        jref["sim"].simulate_trace(_jitem(jref), bad, jref["adaptive"].StaticPolicy("on_off", _jitem(jref)))
    assert str(e1.value) == str(e2.value)


# ---------------------------------------------------------------------------
# ledger and strategies
# ---------------------------------------------------------------------------
def test_ledger_axes_and_arithmetic_equal_jax(jref):
    jl = jref["ledger"]
    assert AXES == jl.AXES and PHASE_TO_AXIS == jl.PHASE_TO_AXIS
    for phase in ("configuration", "initial_powerup", "idle_waiting", "inference", "off"):
        assert axis_of_phase(phase) == jl.axis_of_phase(phase)
    rng = np.random.default_rng(0)
    vals = {a: rng.random(5) * 100 for a in AXES}
    ours, theirs = EnergyLedger.from_axes(**vals), jl.EnergyLedger.from_axes(**vals)
    np.testing.assert_array_equal(ours.total_mj, theirs.total_mj)
    assert ours.fractions() == theirs.fractions()
    assert ours.to_dict() == theirs.to_dict()
    assert (ours + ours).to_dict(aggregate=False) == (theirs + theirs).to_dict(aggregate=False)
    assert ours.assert_conserves(theirs.total_mj) == 0.0
    with pytest.raises(ValueError, match="mismatched shapes"):
        ours + EnergyLedger.zeros()
    with pytest.raises(AssertionError, match="conservation violated"):
        ours.assert_conserves(np.asarray(ours.total_mj) * (1 + 1e-6))
    with pytest.raises(ValueError, match="unknown ledger axes"):
        EnergyLedger.from_axes(heat=1.0)


@pytest.mark.parametrize("method", METHODS)
def test_strategy_sweep_equals_jax(jref, method):
    item, jitem = paper_lstm_item(), _jitem(jref)
    periods = [40.0, 60.0, 89.0, 120.0, 500.0]
    for ours, theirs in (
        (OnOffStrategy(item, CALIBRATED_POWERUP_OVERHEAD_MJ),
         jref["strat"].OnOffStrategy(jitem, CALIBRATED_POWERUP_OVERHEAD_MJ)),
        (IdleWaitingStrategy(item, CALIBRATED_POWERUP_OVERHEAD_MJ, method=method),
         jref["strat"].IdleWaitingStrategy(jitem, CALIBRATED_POWERUP_OVERHEAD_MJ,
                                           method=_jmethod(jref, method))),
    ):
        a, b = ours.sweep(periods, 4147e3), theirs.sweep(periods, 4147e3)
        assert [dataclasses.asdict(r) for r in a] == [dataclasses.asdict(r) for r in b]
        with pytest.raises(ValueError) as e1:
            ours.sweep([], 4147e3)
        with pytest.raises(ValueError) as e2:
            theirs.sweep([], 4147e3)
        assert str(e1.value) == str(e2.value)
    cmp_ = compare_strategies(item, 40.0, method=method, powerup_overhead_mj=CALIBRATED_POWERUP_OVERHEAD_MJ)
    jcmp = jref["core"].compare_strategies(jitem, 40.0, method=_jmethod(jref, method),
                                           powerup_overhead_mj=CALIBRATED_POWERUP_OVERHEAD_MJ)
    assert cmp_["items_ratio"] == jcmp["items_ratio"]


# ---------------------------------------------------------------------------
# the quickstart's Experiments 1–3
# ---------------------------------------------------------------------------
EXPECTED = [
    "475.56 mJ", "11.85 mJ", "reduction: 40.12×", "cross point: 89.22 ms",
    "IW   771,805 items vs OnOff   346,073", "IW   346,918 items", "IW   257,304 items",
    "771,805 items,   8.58 h  (2.23× vs On-Off)",
    "3,020,121 items,  33.56 h  (8.73× vs On-Off)",
    "4,295,042 items,  47.72 h  (12.41× vs On-Off)",
]


def test_quickstart_experiments_print_the_reference_lines(jref, capsys):
    from repro_torch.examples import quickstart

    spec = importlib.util.spec_from_file_location("jax_quickstart", ROOT / "examples" / "quickstart.py")
    jq = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jq)
    outs = []
    for mod in (jq, quickstart):
        mod.exp1()
        mod.exp2()
        mod.exp3()
        outs.append(capsys.readouterr().out.splitlines())
    theirs, ours = outs
    assert ours == theirs
    text = "\n".join(ours)
    for want in EXPECTED:
        assert want in text
