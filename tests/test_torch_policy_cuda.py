"""The optimizer and the learned policy on the card against the CPU, fed the
same inputs: the rollout (counts exact, energies within 1e-9), one BP step
and one ES step and a short training run (within 1e-9), the descent's
answers, and the planner's replay through ``run_periodic`` on the card.

These need a CUDA card and skip where there is none.  They import neither
jax nor the JAX package, so they run on a card machine without them:

    python -m pytest -m cuda tests/test_torch_policy_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.arrivals import MMPPArrivals
from repro_torch.core.config_phase import SPARTAN7_XC7S15, SPARTAN7_XC7S25
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.fleet import DeviceSpec, FleetParams
from repro_torch.obs import ledger_from_rollout
from repro_torch.optimize import (
    DescentSettings,
    optimize_config,
    optimize_lifetime,
    plan_budgets,
    replay_allocation,
    trace_config_frontier,
)
from repro_torch.policy import TrainSettings, train_policy
from repro_torch.policy import net as N
from repro_torch.policy.rollout import make_consts, rollout
from repro_torch.policy.train import _bp_run, _es_run, sample_training_gaps, training_processes

M12 = IdlePowerMethod.METHOD1_2
OVERHEAD = em.CALIBRATED_POWERUP_OVERHEAD_MJ
FAST = DescentSettings(n_starts=6, steps=150)
TINY = TrainSettings(hidden=(8,), n_streams=8, n_gaps=48, bp_steps=3, es_steps=2, es_pop=4)
COUNTS = ("n_items", "configurations", "releases")
ENERGIES = ("energy_mj", "energy_smooth_mj", "idle_energy_mj", "lifetime_ms")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def consts():
    return make_consts(paper_lstm_item(), M12, OVERHEAD)


def _net(seed=7, hidden=(16, 16)):
    rng = np.random.default_rng(seed)
    sizes = (6, *hidden, 1)
    return [{"w": rng.normal(0.0, 1.0, (a, b)) / math.sqrt(a), "b": 0.1 * rng.normal(0.0, 1.0, (b,))}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _gaps(n_streams=64, n_gaps=256, seed=0):
    proc = MMPPArrivals(burst_ms=20.0, quiet_ms=4000.0, mean_burst_len=12.0, mean_quiet_len=3.0)
    return proc.sample_gaps(torch.Generator().manual_seed(seed), n_streams, n_gaps)


def _same_rollout(card, cpu):
    for k in COUNTS:
        np.testing.assert_array_equal(card[k].cpu().numpy(), cpu[k].numpy(), err_msg=k)
    for k in ENERGIES:
        np.testing.assert_allclose(card[k].cpu().numpy(), cpu[k].numpy(), rtol=1e-9, atol=1e-9, err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("budget", [math.inf, 400.0])
def test_rollout_on_the_card_equals_the_cpu(cuda, consts, smooth, budget):
    gaps, net = _gaps(), _net()
    c = dict(consts, budget=budget)
    card = rollout(net, gaps.to(cuda), c, smooth=smooth, device=cuda)
    assert card["energy_mj"].device.type == "cuda"
    _same_rollout(card, rollout(net, gaps, c, smooth=smooth, device="cpu"))
    ledger_from_rollout(card, c).assert_conserves(card["energy_mj"].cpu().numpy(), rtol=1e-9)


@pytest.mark.cuda
def test_population_rollout_on_the_card_equals_the_cpu(cuda, consts):
    nets = [_net(seed) for seed in (1, 2, 3, 4)]
    pop = [{k: np.stack([n[i][k] for n in nets]) for k in ("w", "b")} for i in range(3)]
    gaps = _gaps(32, 200, seed=3)
    card = rollout(pop, gaps, dict(consts, budget=300.0), device=cuda)
    assert card["n_items"].shape == (4, 32)
    _same_rollout(card, rollout(pop, gaps, dict(consts, budget=300.0), device="cpu"))


def _one_bp_es(device, consts):
    item_consts = consts
    gaps = sample_training_gaps(training_processes(consts["t_be"]), 16, 64, seed=0, device=device)
    params = N.to_tensors(N.init_mlp(torch.Generator().manual_seed(0), hidden=(16, 16)), device)
    lr = torch.tensor(0.02, dtype=torch.float64, device=device)
    params, bp = _bp_run(params, gaps, item_consts, lr, 1)
    after_bp = N.params_to_numpy(params)
    d = sum(t.numel() for layer in params for t in layer.values())
    noise = np.random.default_rng(5).normal(size=(1, 4, d))
    params, es = _es_run(params, gaps, item_consts, lr / 2, 0.05, 1, 4, noise=noise)
    return after_bp, N.params_to_numpy(params), bp.cpu().numpy(), es.cpu().numpy()


def _close_nets(a, b, tol):
    for x, y in zip(a, b):
        for k in ("w", "b"):
            np.testing.assert_allclose(x[k], y[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.cuda
def test_one_bp_step_and_one_es_step_on_the_card_equal_the_cpu(cuda, consts):
    card, cpu = _one_bp_es(cuda, consts), _one_bp_es("cpu", consts)
    _close_nets(card[0], cpu[0], 1e-9)
    _close_nets(card[1], cpu[1], 1e-9)
    np.testing.assert_allclose(card[2], cpu[2], rtol=1e-9)
    np.testing.assert_allclose(card[3], cpu[3], rtol=1e-9)


@pytest.mark.cuda
def test_a_short_training_run_on_the_card_equals_the_cpu(cuda):
    item = paper_lstm_item()
    card = train_policy(item, M12, OVERHEAD, settings=TINY, device=cuda)
    cpu = train_policy(item, M12, OVERHEAD, settings=TINY, device="cpu")
    _close_nets(card.params, cpu.params, 1e-9)
    assert card.history["baseline_hard"] == pytest.approx(cpu.history["baseline_hard"], rel=1e-12)
    assert card.history["final_hard"] == pytest.approx(cpu.history["final_hard"], rel=1e-9)


@pytest.mark.cuda
@pytest.mark.parametrize("device", [SPARTAN7_XC7S15, SPARTAN7_XC7S25])
def test_optimize_config_on_the_card_returns_the_cpus_answer(cuda, device):
    card = optimize_config(device, settings=FAST, torch_device=cuda)
    cpu = optimize_config(device, settings=FAST, torch_device="cpu")
    assert card.best == cpu.best
    assert card.candidates == cpu.candidates
    np.testing.assert_allclose(card.loss_curve, cpu.loss_curve, rtol=1e-9)


@pytest.mark.cuda
def test_optimize_lifetime_and_the_frontier_on_the_card_equal_the_cpu(cuda):
    kw = dict(powerup_overhead_mj=OVERHEAD, settings=FAST)
    assert optimize_lifetime(SPARTAN7_XC7S15, torch_device=cuda, **kw).best == \
        optimize_lifetime(SPARTAN7_XC7S15, torch_device="cpu", **kw).best
    kw = dict(lambdas=(0.1, 0.5, 0.9), settings=DescentSettings(n_starts=3, steps=120))
    assert trace_config_frontier(SPARTAN7_XC7S25, torch_device=cuda, **kw) == \
        trace_config_frontier(SPARTAN7_XC7S25, torch_device="cpu", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["min_lifetime", "total_requests"])
def test_plan_replays_exactly_on_the_card(cuda, objective):
    item = paper_lstm_item()
    template = [("idle_waiting", 40.0, M12), ("on_off", 80.0, IdlePowerMethod.BASELINE),
                ("adaptive", 120.0, IdlePowerMethod.METHOD1), ("idle_waiting", 200.0, IdlePowerMethod.BASELINE)]
    specs = [DeviceSpec(item=item, strategy=s, method=m, request_period_ms=p, powerup_overhead_mj=OVERHEAD)
             for s, p, m in template]
    card = FleetParams.from_specs(specs, cuda).tile(4096)
    cpu = FleetParams.from_specs(specs, "cpu").tile(4096)
    budget = 4096 * em.PAPER_ENERGY_BUDGET_MJ / 400.0
    a = plan_budgets(card, budget, 10**6, objective=objective)
    b = plan_budgets(cpu, budget, 10**6, objective=objective)
    np.testing.assert_array_equal(a.n_items, b.n_items)
    np.testing.assert_array_equal(a.budgets_mj, b.budgets_mj)
    rep = replay_allocation(card, a)
    assert rep["exact"] and rep["result"].n_items.device.type == "cuda"
