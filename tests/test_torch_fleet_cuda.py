"""The vectorized closed forms and the fleet on the card: the CUDA-graph tick
loop against the eager one, and the card against the CPU on the same inputs.

These need a CUDA card and skip where there is none.  They import neither
jax nor the JAX package, so they run on a card machine without them:

    python -m pytest -m cuda tests/test_torch_fleet_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import arrivals as pa
from repro_torch.core import batch_eval as be
from repro_torch.core import energy_model as em
from repro_torch.core import pareto
from repro_torch.core.config_phase import DEVICES
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.fleet import FleetState, run_periodic, run_routed, uniform_fleet
from repro_torch.fleet.step import _run_loop

CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ
STRATEGIES = ("on_off", "idle_waiting", "adaptive")
STATE_FIELDS = [f.name for f in dataclasses.fields(FleetState)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA-graph tick loop has no CPU mode)")
    return torch.device("cuda")


def _fleet(n, device, budget=300.0):
    return uniform_fleet(n, strategies=STRATEGIES[:n], method=IdlePowerMethod.METHOD1_2,
                         e_budget_mj=budget, powerup_overhead_mj=CAL, device=device)


def _routed_equal(a, b):
    for f in STATE_FIELDS:
        assert torch.equal(getattr(a.state, f).cpu(), getattr(b.state, f).cpu()), f
    for f in ("alive_over_time", "served_over_time", "queued_over_time", "latency_ms", "served_mask",
              "reconfig_mask", "released_mask", "queue_depth", "dropped_per_tick"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert torch.equal(x.cpu(), y.cpu()), f


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["round_robin", "least_loaded", "power_aware"])
def test_graph_equals_eager_routed(cuda, router):
    params = _fleet(4096, cuda)
    counts = np.random.default_rng(0).poisson(2000, 150).astype(np.int32)
    kw = dict(router=router, queue_capacity=8, collect_events=True)
    _routed_equal(run_routed(params, counts, 20.0, jit=True, **kw),
                  run_routed(params, counts, 20.0, jit=False, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4096])
def test_graph_equals_eager_periodic(cuda, n):
    params = _fleet(n, cuda, budget=2000.0)
    a, b = run_periodic(params, 3000, jit=True), run_periodic(params, 3000, jit=False)
    for f in ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("router", ["round_robin", "power_aware", None])
def test_card_equals_cpu_per_device(cuda, router):
    n = 4096
    rng = np.random.default_rng(1)
    counts = (rng.poisson(1500, 200) if router else rng.poisson(0.4, (200, n))).astype(np.int32)
    kw = dict(router=router, queue_capacity=16)
    card = run_routed(_fleet(n, cuda), counts, 20.0, **kw)
    cpu = run_routed(_fleet(n, "cpu"), counts, 20.0, **kw)
    _routed_equal(card, cpu)
    e_card, e_cpu = float(card.energy_mj.sum()), float(cpu.energy_mj.sum())
    assert abs(e_card - e_cpu) <= 1e-12 * abs(e_cpu)


@pytest.mark.cuda
def test_periodic_card_equals_cpu(cuda):
    a, b = run_periodic(_fleet(4096, cuda, 2000.0), 2500), run_periodic(_fleet(4096, "cpu", 2000.0), 2500)
    for f in ("n_items", "energy_mj", "lifetime_ms", "alive", "alive_over_time"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f


@pytest.mark.cuda
def test_chunked_continuation_on_the_card(cuda):
    params = _fleet(2048, cuda)
    counts = np.random.default_rng(2).poisson(900, 300).astype(np.int32)
    one = run_routed(params, counts, 20.0)
    state, start = None, 0
    for size in (100, 37, 163):
        state = run_routed(params, counts[start:start + size], 20.0, state0=state, start_tick=start).state
        start += size
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(one.state, f)), f


@pytest.mark.cuda
def test_sweep_card_equals_cpu(cuda):
    grid = be.SweepGrid(devices=tuple(DEVICES.values()), request_periods_ms=tuple(np.arange(1.0, 301.0)),
                        idle_methods=tuple(IdlePowerMethod), e_budgets_mj=(1000.0, 4147000.0),
                        powerup_overhead_mj=CAL)
    card, cpu = be.sweep_batch(grid, device=cuda), be.sweep_batch(grid, device="cpu")
    for k in be.GRID_QUANTITIES:
        assert torch.equal(card[k].cpu(), cpu[k]), k


@pytest.mark.cuda
def test_pareto_and_surface_card_equal_cpu(cuda):
    costs = torch.from_numpy(np.random.default_rng(3).integers(0, 50, (20000, 3)).astype(np.float64))
    assert torch.equal(pareto.pareto_mask(costs.to(cuda)).cpu(), pareto.pareto_mask(costs))
    from repro_torch.core.phases import paper_lstm_item

    args = (paper_lstm_item(), tuple(DEVICES.values()), [134.3, 34.2, 24.0])
    assert torch.equal(pareto.crossover_surface(*args, powerup_overhead_mj=CAL, device=cuda)["crossover_ms"].cpu(),
                       pareto.crossover_surface(*args, powerup_overhead_mj=CAL, device="cpu")["crossover_ms"])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["poisson", "mmpp", "flash_crowd", "jittered", "diurnal"])
def test_arrival_transforms_card_equal_cpu(cuda, name):
    proc = {
        "poisson": pa.PoissonArrivals(40.0),
        "mmpp": pa.MMPPArrivals(5.0, 200.0),
        "flash_crowd": pa.FlashCrowdArrivals(100.0, 2.0, flash_len=8),
        "jittered": pa.JitteredArrivals(40.0, 0.2),
        "diurnal": pa.DiurnalArrivals(40.0, day_ms=3000.0, amplitude=0.6, burst_ms=4.0),
    }[name]
    draws = proc._draws(torch.Generator(cuda).manual_seed(0), 1000, 200)
    card = proc._gaps_from_draws(*draws).cpu()
    cpu = proc._gaps_from_draws(*(d.cpu() for d in draws))
    if name == "diurnal":
        torch.testing.assert_close(card, cpu, rtol=1e-12, atol=0)
    else:
        assert torch.equal(card, cpu)
    g = proc.sample_gaps(torch.Generator(cuda).manual_seed(1), 2000, 200)
    assert g.device.type == "cuda" and g.dtype == torch.float64
    if name != "diurnal":     # its arrival-weighted mean sits below mean_period_ms
        assert float(g.mean()) == pytest.approx(proc.mean_period_ms(), rel=0.05)


@pytest.mark.cuda
def test_a_body_that_syncs_cannot_be_captured(cuda):
    """No quiet fallback: a tick body that reads a value to the host fails
    the capture, and the failure reaches the caller.  (Last in the file:
    the failed capture stays behind on the card.)"""
    def body(carry, x):
        (n,) = carry
        if n.sum().item() < 0:          # a host sync inside the body
            pass
        return (n + 1,), (n.sum(),)

    with pytest.raises(RuntimeError):
        _run_loop(body, (torch.zeros(8, dtype=torch.int32, device=cuda),), (), 4, jit=True)
