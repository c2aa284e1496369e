"""The port's vectorized closed forms (``core/batch_eval.py``) and Pareto
frontiers (``core/pareto.py``) against the JAX package and against the
port's own scalar closed forms, on the CPU.

Both sides compute every quantity with the same sequence of correctly
rounded float64 ops, so every comparison here is equality (``==`` /
``array_equal``), never a tolerance: integer counts, energies, lifetimes,
crossovers and masks alike.  One exception is the reference's, not the
port's: it folds a derived item's phases left to right where the scalar
path calls the built-in ``sum()``, which CPython compensates from 3.12 on,
so the reference's On-Off item energy and crossover depart from its own
scalar oracle in the last bit at about half the configuration points
(ROADMAP C-ref-6).  The port follows the scalar oracle; wherever it
differs from the reference, it is shown to equal the oracle and the
reference not to (:func:`assert_equal_to_reference`)."""
import itertools
import math

import numpy as np
import pytest
import torch

from repro_torch.core import batch_eval as be
from repro_torch.core import energy_model as em
from repro_torch.core import pareto
from repro_torch.core.adaptive import AdaptiveStrategy
from repro_torch.core.config_phase import (
    SPARTAN7_XC7S15,
    SPARTAN7_XC7S25,
    ConfigParams,
    sweep_config_space,
)
from repro_torch.core.phases import (
    CONFIGURATION,
    DATA_LOADING,
    DATA_OFFLOADING,
    INFERENCE,
    Phase,
    WorkloadItem,
    paper_lstm_item,
)
from repro_torch.core.strategies import IdlePowerMethod, IdleWaitingStrategy, OnOffStrategy
from test_torch_x64_shim import x64_shim

CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ
CPU = "cpu"


@pytest.fixture(scope="module")
def jref():
    """The JAX package's batch engine, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        from repro.core import batch_eval, config_phase, pareto as jpareto, phases, strategies

    return dict(be=batch_eval, pareto=jpareto, cp=config_phase, phases=phases, st=strategies)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _random_item(seed: int) -> WorkloadItem:
    rng = np.random.default_rng(seed)
    return WorkloadItem(
        name="random",
        phases=(
            Phase(CONFIGURATION, rng.uniform(1, 2000), rng.uniform(0.5, 100)),
            Phase(DATA_LOADING, rng.uniform(1, 2000), rng.uniform(1e-4, 5)),
            Phase(INFERENCE, rng.uniform(1, 2000), rng.uniform(1e-4, 5)),
            Phase(DATA_OFFLOADING, rng.uniform(1, 2000), rng.uniform(1e-4, 5)),
        ),
        idle_power_mw=rng.uniform(0, 500),
    )


def _jgrid(jref, **kw):
    jdev = {d.name: d for d in (jref["cp"].SPARTAN7_XC7S15, jref["cp"].SPARTAN7_XC7S25)}
    kw = dict(kw)
    if "devices" in kw:
        kw["devices"] = tuple(jdev[d.name] for d in kw["devices"])
    if "idle_methods" in kw:
        kw["idle_methods"] = tuple(jref["st"].IdlePowerMethod(m.value) for m in kw["idle_methods"])
    return jref["be"].SweepGrid(**kw)


GRIDS = {
    "mixed": dict(
        devices=(SPARTAN7_XC7S15, SPARTAN7_XC7S25),
        buswidths=(1, 4),
        clocks_mhz=(3, 66),
        request_periods_ms=(0.5, 10.0, 40.0, 600.0, 2000.0),
        idle_methods=tuple(IdlePowerMethod),
        e_budgets_mj=(1.0, 2000.0, em.PAPER_ENERGY_BUDGET_MJ),
        powerup_overhead_mj=CAL,
    ),
    "table1": dict(request_periods_ms=(10.0, 89.0, 120.0), idle_methods=tuple(IdlePowerMethod)),
    "off_table": dict(buswidths=(1, 3, 8), clocks_mhz=(2.5, 70.0), request_periods_ms=(37.5,),
                      e_budgets_mj=(5.0, 1e7)),
}


def _derived_item(grid, d, w, f, c) -> WorkloadItem:
    """The base item with its configuration phase from the device model at
    (buswidth, clock, compression) — off Table 1 too, where ``ConfigParams``
    would refuse the values (the stage models read only ``lanes_mhz`` and
    ``compression``)."""
    import types

    bw, clk, comp = grid.buswidths[w], grid.clocks_mhz[f], bool(grid.compression[c])
    params = types.SimpleNamespace(buswidth=bw, clock_mhz=clk, compression=comp, lanes_mhz=bw * clk)
    base = grid.item()
    exec_phases = tuple(p for p in base.phases if p.name != CONFIGURATION)
    return WorkloadItem(base.name, (grid.devices[d].config_phase(params),) + exec_phases,
                        base.idle_power_mw)


def oracle_at(grid, ix) -> dict:
    """Every GRID_QUANTITIES value at grid point ``ix`` through the port's
    scalar closed forms, on the per-point constructed WorkloadItem."""
    d, w, f, c, t, m, b = ix
    item = _derived_item(grid, d, w, f, c)
    period, budget, ovh = grid.request_periods_ms[t], grid.e_budgets_mj[b], grid.powerup_overhead_mj
    iw_strat = IdleWaitingStrategy(item, ovh, method=grid.idle_methods[m])
    iw = iw_strat.evaluate(period, budget)
    oo = OnOffStrategy(item, ovh).evaluate(period, budget)
    cross = em.crossover_period_ms(item, iw_strat.idle_power_mw, ovh)
    pick = period <= cross
    return {
        "config_time_ms": item.config_time_ms,
        "config_energy_mj": item.phases[0].energy_mj,
        "onoff_n_max": oo.n_max, "onoff_lifetime_ms": oo.lifetime_ms,
        "onoff_energy_per_item_mj": oo.energy_per_item_mj, "onoff_feasible": oo.feasible,
        "iw_n_max": iw.n_max, "iw_lifetime_ms": iw.lifetime_ms,
        "iw_energy_per_item_mj": iw.energy_per_item_mj, "iw_feasible": iw.feasible,
        "crossover_ms": cross,
        "adaptive_n_max": iw.n_max if pick else oo.n_max,
        "adaptive_lifetime_ms": iw.lifetime_ms if pick else oo.lifetime_ms,
        "adaptive_picks_iw": pick,
    }


#: The quantities of a derived item's phase totals (ROADMAP C-ref-6).
PHASE_SUM_QUANTITIES = ("onoff_energy_per_item_mj", "crossover_ms")


def _departs(ours, ref, want) -> bool:
    """``ours`` is the scalar oracle's value, the reference's is not, and
    they differ in the last bits only."""
    return ours == want and ref != want and abs(ours - ref) <= 4e-16 * abs(want)


def assert_equal_to_reference(grid, ours: dict, ref: dict) -> int:
    """Every quantity equal to the reference's, except phase-sum quantities
    at points where the reference departs from the scalar oracle: there the
    port equals the oracle.  Returns how many such points there were."""
    departures = 0
    for k in be.GRID_QUANTITIES:
        a, b = _np(ours[k]), np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        diff = np.argwhere(a != b)
        assert k in PHASE_SUM_QUANTITIES or len(diff) == 0, k
        for ix in map(tuple, diff):
            assert _departs(a[ix], b[ix], oracle_at(grid, ix)[k]), (k, ix)
        departures += len(diff)
    return departures


def assert_records_equal_to_reference(grid, ours: list, ref: list) -> None:
    """Records (``to_records``, frontiers) equal, with the same exception
    as :func:`assert_equal_to_reference`; a frontier record's
    ``energy_per_item_mj`` is its arm's."""
    labels = grid.axis_labels()
    assert len(ours) == len(ref)
    for r_ours, r_ref in zip(ours, ref):
        assert r_ours.keys() == r_ref.keys()
        for k in r_ours:
            if r_ours[k] == r_ref[k]:
                continue
            ix = tuple(vals.index(r_ours[name]) for name, vals in labels.items())
            src = k
            if k == "energy_per_item_mj":
                src = "onoff_energy_per_item_mj" if r_ours["onoff_energy_per_item_mj"] == r_ours[k] \
                    else "iw_energy_per_item_mj"
            assert src in PHASE_SUM_QUANTITIES, (k, r_ours[k], r_ref[k])
            assert _departs(r_ours[k], r_ref[k], oracle_at(grid, ix)[src]), (k, ix)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(GRIDS))
def test_sweep_batch_equals_the_reference_in_every_field(jref, name):
    kw = GRIDS[name]
    grid = be.SweepGrid(**kw)
    ours = be.sweep_batch(grid, device=CPU)
    ref = jref["be"].sweep_batch(_jgrid(jref, **kw))
    assert tuple(ours.arrays) == be.GRID_QUANTITIES == jref["be"].GRID_QUANTITIES
    assert_equal_to_reference(grid, ours.arrays, ref.arrays)
    ours_json, ref_json = ours.to_json_dict(limit=40), ref.to_json_dict(limit=40)
    assert {k: v for k, v in ours_json.items() if k != "records"} == \
        {k: v for k, v in ref_json.items() if k != "records"}
    assert len(ours_json["records"]) == min(40, grid.size)
    assert_records_equal_to_reference(grid, ours_json["records"], ref_json["records"])


def test_the_reference_departs_from_its_scalar_oracle_on_python_3_12():
    """ROADMAP C-ref-6, the reason for :func:`assert_equal_to_reference`:
    at buswidth 1, 66 MHz, uncompressed, the reference's left fold and the
    built-in ``sum()`` of the derived item's phases differ in the last bit
    on Python 3.12+, and the port takes the scalar path's value."""
    import sys

    grid = be.SweepGrid(buswidths=(1,), clocks_mhz=(66,), compression=(False,))
    got = float(be.sweep_batch(grid, device=CPU)["onoff_energy_per_item_mj"].reshape(-1)[0])
    want = oracle_at(grid, (0,) * 7)["onoff_energy_per_item_mj"]
    assert got == want
    fold = 0.0
    for p in _derived_item(grid, 0, 0, 0, 0).phases:
        fold = fold + p.energy_mj
    if sys.version_info >= (3, 12):
        assert fold + grid.powerup_overhead_mj != want


@pytest.mark.parametrize("device_name", ["spartan7-xc7s15", "spartan7-xc7s25"])
def test_config_phase_grid_equals_the_reference(jref, device_name):
    from repro_torch.core.config_phase import DEVICES

    ours = be.config_phase_grid(DEVICES[device_name], device=CPU)
    ref = jref["be"].config_phase_grid(jref["cp"].DEVICES[device_name])
    assert set(ours) == set(ref)
    for k in ours:
        assert np.array_equal(_np(ours[k]), np.asarray(ref[k])), k


@pytest.mark.parametrize("seed", range(4))
def test_strategy_batches_equal_the_reference(jref, seed):
    item = _random_item(seed)
    jitem = jref["phases"].WorkloadItem.from_dict(item.to_dict())
    periods = np.asarray([item.execution_time_ms * 0.5, item.total_time_ms, item.total_time_ms + 17.0])
    budget, p_idle = 10.0 ** (seed + 1), np.asarray([0.0, 24.0, 134.3])
    pairs = [
        (be.evaluate_onoff_batch(item, periods, budget, 0.1, device=CPU),
         jref["be"].evaluate_onoff_batch(jitem, periods, budget, 0.1)),
        (be.evaluate_idlewait_batch(item, periods[:, None], budget, p_idle, 0.1, device=CPU),
         jref["be"].evaluate_idlewait_batch(jitem, periods[:, None], budget, p_idle, 0.1)),
        (be.evaluate_adaptive_batch(item, periods[:, None], budget, p_idle, 0.1, device=CPU),
         jref["be"].evaluate_adaptive_batch(jitem, periods[:, None], budget, p_idle, 0.1)),
    ]
    for ours, ref in pairs:
        for f in ("request_period_ms", "n_max", "lifetime_ms", "energy_per_item_mj", "feasible"):
            a, b = _np(getattr(ours, f)), np.asarray(getattr(ref, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), (ours.strategy, f)
    assert np.array_equal(_np(be.crossover_batch(item, p_idle, 0.1, device=CPU)),
                          jref["be"].crossover_batch(jitem, p_idle, 0.1))


# ---------------------------------------------------------------------------
# against the port's own scalar closed forms (tests/test_batch_eval.py's
# contract, inside the port)
# ---------------------------------------------------------------------------
def _assert_result_equal(batch, scalar, i, context):
    assert int(batch.n_max[i]) == scalar.n_max, context
    assert float(batch.lifetime_ms[i]) == scalar.lifetime_ms, context
    assert bool(batch.feasible[i]) == scalar.feasible, context
    assert float(batch.energy_per_item_mj[i]) == scalar.energy_per_item_mj, context


@pytest.mark.parametrize("seed", range(6))
def test_batched_forms_equal_the_scalar_oracle(seed):
    item = _random_item(100 + seed)
    rng = np.random.default_rng(seed)
    budget, powerup, slack = 10.0 ** rng.uniform(-3, 7), rng.uniform(0, 1), rng.uniform(0, 2000)
    periods = np.asarray([item.total_time_ms * 0.5, item.total_time_ms, item.total_time_ms + slack])
    oo = be.evaluate_onoff_batch(item, periods, budget, powerup, device=CPU)
    for i, t in enumerate(periods):
        _assert_result_equal(oo, em.evaluate_onoff(item, float(t), budget, powerup), i, f"on_off T={t}")
    periods = np.asarray([item.execution_time_ms * 0.5, item.execution_time_ms,
                          item.execution_time_ms + slack])
    iw = be.evaluate_idlewait_batch(item, periods, budget, powerup_overhead_mj=powerup, device=CPU)
    for i, t in enumerate(periods):
        scalar = em.evaluate_idlewait(item, float(t), budget, powerup_overhead_mj=powerup)
        _assert_result_equal(iw, scalar, i, f"idle_waiting T={t}")
    p_idle = rng.uniform(0, 500)
    cross = em.crossover_period_ms(item, p_idle, powerup)
    got = float(be.crossover_batch(item, np.asarray([p_idle]), powerup, device=CPU)[0])
    assert got == cross or (math.isinf(cross) and math.isinf(got))
    strat = AdaptiveStrategy(item)
    periods = np.asarray([item.execution_time_ms + 1e-3, item.total_time_ms + slack])
    ad = be.evaluate_adaptive_batch(item, periods, budget, device=CPU)
    for i, t in enumerate(periods):
        scalar = strat.evaluate(float(t), budget)
        assert int(ad.n_max[i]) == scalar.n_max and float(ad.lifetime_ms[i]) == scalar.lifetime_ms


def test_sweep_batch_equals_the_scalar_oracle_at_every_point():
    """Every quantity of every point of a mixed grid equals scalar
    evaluation of the per-point constructed WorkloadItem."""
    grid = be.SweepGrid(**GRIDS["mixed"])
    res = be.sweep_batch(grid, device=CPU)
    arrays = {k: _np(v) for k, v in res.arrays.items()}
    base = grid.item()
    exec_phases = tuple(p for p in base.phases if p.name != CONFIGURATION)
    for ix in itertools.product(*(range(s) for s in grid.shape)):
        d, w, f, c, t, m, b = ix
        params = ConfigParams(grid.buswidths[w], grid.clocks_mhz[f], grid.compression[c])
        item = WorkloadItem(base.name, (grid.devices[d].config_phase(params),) + exec_phases,
                            base.idle_power_mw)
        period, budget = grid.request_periods_ms[t], grid.e_budgets_mj[b]
        iw_strat = IdleWaitingStrategy(item, CAL, method=grid.idle_methods[m])
        iw = iw_strat.evaluate(period, budget)
        oo = OnOffStrategy(item, CAL).evaluate(period, budget)
        cross = em.crossover_period_ms(item, iw_strat.idle_power_mw, CAL)
        ctx = f"at {ix}"
        assert arrays["iw_n_max"][ix] == iw.n_max and arrays["onoff_n_max"][ix] == oo.n_max, ctx
        assert arrays["iw_lifetime_ms"][ix] == iw.lifetime_ms, ctx
        assert arrays["onoff_lifetime_ms"][ix] == oo.lifetime_ms, ctx
        assert arrays["iw_energy_per_item_mj"][ix] == iw.energy_per_item_mj, ctx
        assert arrays["onoff_energy_per_item_mj"][ix] == oo.energy_per_item_mj, ctx
        assert arrays["crossover_ms"][ix] == cross, ctx
        assert arrays["iw_feasible"][ix] == iw.feasible and arrays["onoff_feasible"][ix] == oo.feasible
        assert arrays["adaptive_n_max"][ix] == (iw.n_max if period <= cross else oo.n_max), ctx


@pytest.mark.parametrize("device", [SPARTAN7_XC7S15, SPARTAN7_XC7S25], ids=lambda d: d.name)
def test_config_grid_equals_the_scalar_sweep(device):
    g = {k: _np(v) for k, v in be.config_phase_grid(device, device=CPU).items()}
    for k, (w, f, c) in enumerate(itertools.product(range(3), range(11), range(2))):
        s = sweep_config_space(device)[k]
        for field in ("load_time_ms", "load_power_mw", "load_energy_mj",
                      "config_time_ms", "config_power_mw", "config_energy_mj"):
            assert g[field][0, w, f, c] == getattr(s, field), (s.params, field)


# ---------------------------------------------------------------------------
# the contract's edge cases
# ---------------------------------------------------------------------------
def test_period_below_min_request_period_yields_zero():
    item = paper_lstm_item()
    for strategy, evaluate in ((OnOffStrategy(item), be.evaluate_onoff_batch),
                               (IdleWaitingStrategy(item), be.evaluate_idlewait_batch)):
        t = strategy.min_request_period_ms() * 0.99
        batch = evaluate(item, np.asarray([t]), device=CPU)
        scalar = strategy.evaluate(t, em.PAPER_ENERGY_BUDGET_MJ)
        assert int(batch.n_max[0]) == scalar.n_max == 0
        assert not bool(batch.feasible[0]) and float(batch.lifetime_ms[0]) == 0.0


def test_zero_idle_power_means_infinite_crossover_and_iw_always_wins():
    item = paper_lstm_item(idle_power_mw=0.0)
    assert math.isinf(em.crossover_period_ms(item))
    assert torch.isinf(be.crossover_batch(item, device=CPU)).all()
    periods = np.asarray([50.0, 5000.0, 5e6])
    ad = be.evaluate_adaptive_batch(item, periods, device=CPU)
    iw = be.evaluate_idlewait_batch(item, periods, device=CPU)
    assert torch.equal(ad.n_max, iw.n_max)


def test_budget_smaller_than_one_item():
    item = paper_lstm_item()
    t = item.total_time_ms + 10.0
    tiny = em.onoff_item_energy_mj(item) * 0.5
    oo = be.evaluate_onoff_batch(item, np.asarray([t]), tiny, device=CPU)
    assert int(oo.n_max[0]) == em.onoff_n_max(item, tiny) == 0
    tiny_iw = em.idlewait_init_energy_mj(item) * 0.5
    iw = be.evaluate_idlewait_batch(item, np.asarray([t]), tiny_iw, device=CPU)
    assert int(iw.n_max[0]) == em.idlewait_n_max(item, t, tiny_iw) == 0


def test_grid_axes_outer_product_layout():
    a, b, c = be.grid_axes([1.0, 2.0], [10.0, 20.0, 30.0], [100.0], device=CPU)
    assert a.shape == (2, 1, 1) and b.shape == (1, 3, 1) and c.shape == (1, 1, 1)
    assert a.dtype == torch.float64 and float((a + b + c)[1, 2, 0]) == 132.0


def test_records_gather_any_points_of_the_grid():
    res = be.sweep_batch(be.SweepGrid(**GRIDS["mixed"]), device=CPU)
    recs = res.to_records()
    assert len(recs) == res.grid.size
    picked = [5, 17, res.grid.size - 1]
    assert res.records_at(picked) == [recs[i] for i in picked]
    assert isinstance(recs[0]["iw_n_max"], int) and isinstance(recs[0]["iw_feasible"], bool)


# ---------------------------------------------------------------------------
# Pareto frontiers and crossover surfaces
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,k,levels,chunk", [(1, 1, 3, 7), (60, 2, 4, 7), (300, 3, 5, 7),
                                              (500, 3, 1000, 64), (1000, 2, 6, 2048)])
def test_pareto_mask_equals_the_reference_with_ties(jref, n, k, levels, chunk):
    costs = np.random.default_rng(n + k).integers(0, levels, (n, k)).astype(np.float64)
    if n > 10:
        costs[3] = costs[4]        # an exact duplicate
        costs[5, 0] = np.nan       # never dominates, never dominated
    ours = pareto.pareto_mask(costs, chunk=chunk, device=CPU)
    assert ours.dtype == torch.bool
    assert np.array_equal(ours.numpy(), jref["pareto"].pareto_mask(costs, chunk=7))


def test_pareto_mask_basics():
    costs = np.asarray([[1, 1], [2, 2], [1, 2], [2, 1], [0.5, 3]])
    assert pareto.pareto_mask(costs, device=CPU).tolist() == [True, False, False, False, True]
    assert pareto.pareto_mask(np.zeros((0, 2)), device=CPU).tolist() == []
    assert pareto.pareto_mask(np.asarray([[1, 1], [1, 1]]), device=CPU).tolist() == [True, True]
    assert pareto.pareto_mask_torch(torch.as_tensor(costs)).tolist() == [True, False, False, False, True]


def test_config_pareto_equals_the_reference(jref):
    ours = pareto.config_pareto((SPARTAN7_XC7S15, SPARTAN7_XC7S25), device=CPU)
    ref = jref["pareto"].config_pareto(tuple(jref["cp"].DEVICES.values()))
    assert ours == ref
    assert any(r["buswidth"] == 4 and r["clock_mhz"] == 66 and r["compression"] for r in ours)


@pytest.mark.parametrize("strategy", ["iw", "onoff", "adaptive"])
def test_strategy_pareto_equals_the_reference(jref, strategy):
    kw = dict(request_periods_ms=tuple(float(t) for t in range(10, 200, 10)),
              idle_methods=tuple(IdlePowerMethod), powerup_overhead_mj=CAL)
    grid = be.SweepGrid(**kw)
    ours = pareto.strategy_pareto(be.sweep_batch(grid, device=CPU), strategy)
    ref = jref["pareto"].strategy_pareto(jref["be"].sweep_batch(_jgrid(jref, **kw)), strategy)
    assert ours
    assert_records_equal_to_reference(grid, ours, ref)


def test_crossover_surface_equals_the_reference(jref):
    args = ([134.3, 34.2, 24.0],)
    ours = pareto.crossover_surface(paper_lstm_item(), (SPARTAN7_XC7S15, SPARTAN7_XC7S25), *args,
                                    powerup_overhead_mj=CAL, device=CPU)
    ref = jref["pareto"].crossover_surface(jref["phases"].paper_lstm_item(),
                                           tuple(jref["cp"].DEVICES.values()), *args,
                                           powerup_overhead_mj=CAL)
    assert ours["axes"] == ref["axes"]
    a, b = ours["crossover_ms"].numpy(), ref["crossover_ms"]
    # equal but where the reference's left fold departs from the scalar
    # path's sum() (C-ref-6): there the port equals the scalar crossover
    grid = be.SweepGrid(devices=(SPARTAN7_XC7S15, SPARTAN7_XC7S25))
    for d, w, f, c, p in map(tuple, np.argwhere(a != b)):
        want = em.crossover_period_ms(_derived_item(grid, d, w, f, c), args[0][p], CAL)
        assert _departs(a[d, w, f, c, p], b[d, w, f, c, p], want), (d, w, f, c, p)
    # the paper's cell (quad, 66 MHz, compressed, methods 1+2) from the
    # device model, against the paper item's Table-2 value 499.0607 ms
    cell = float(ours["crossover_ms"][0, -1, -1, 1, 2])
    assert cell == pytest.approx(499.06, rel=2e-3)
    assert round(float(be.crossover_batch(paper_lstm_item(), 24.0, CAL, device=CPU)), 4) == 499.0607


def test_entry_points_default_to_the_card_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: be.sweep_batch(be.SweepGrid()),
                 lambda: be.config_phase_grid(SPARTAN7_XC7S15),
                 lambda: be.evaluate_onoff_batch(paper_lstm_item(), [40.0]),
                 lambda: pareto.config_pareto(SPARTAN7_XC7S15),
                 lambda: pareto.pareto_mask(np.ones((2, 2))),
                 lambda: pareto.crossover_surface(paper_lstm_item(), SPARTAN7_XC7S15, [24.0])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
