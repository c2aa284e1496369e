"""Observability, the Monte Carlo engine and the cost calibration on the
card: the in-loop histogram against numpy, the ensembles on the card
against the CPU on the same inputs, the CUDA-graph loops against the eager
ones, and each kernel at the calibration's pinned shapes against its plain
version.

These need a CUDA card and skip where there is none.  They import neither
jax nor the JAX package, so they run on a card machine without them:

    python -m pytest -m cuda tests/test_torch_mc_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.arrivals import PoissonArrivals
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.fleet import uniform_fleet
from repro_torch.launch import costs as costs_cli
from repro_torch.mc import periodic_ensemble, routed_ensemble, run_periodic_ensemble
from repro_torch.obs import default_latency_edges_ms, hist_update, scan_histogram

CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ
STRATEGIES = ("on_off", "idle_waiting", "adaptive")
PERIODIC = ("per_device_items", "per_device_energy_mj", "per_device_lifetime_ms", "lifetime_ms",
            "total_items", "total_energy_mj")
ROUTED = ("served", "total_energy_mj", "p50_latency_ms", "p99_latency_ms", "devices_alive",
          "per_device_served", "per_device_energy_mj")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels and graphs have no CPU mode)")
    return torch.device("cuda")


def _fleet(n, device, budget=1500.0):
    return uniform_fleet(n, strategies=STRATEGIES, method=IdlePowerMethod.METHOD1_2,
                         e_budget_mj=budget, powerup_overhead_mj=CAL, device=device)


def _equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_hist_update_and_scan_histogram_on_the_card_equal_numpy(cuda, seed):
    rng = np.random.default_rng(seed)
    edges = default_latency_edges_ms()
    values = rng.lognormal(2.0, 1.5, (300, 64))
    values[rng.random(values.shape) < 0.2] = rng.choice(edges, 1)     # ties on an edge
    mask = rng.random(values.shape) < 0.7
    want = np.bincount(np.searchsorted(edges, values[mask], side="left"), minlength=edges.size + 1)
    e = torch.as_tensor(edges, device=cuda)
    one = hist_update(torch.zeros(edges.size + 1, dtype=torch.int64, device=cuda), e,
                      torch.as_tensor(values, device=cuda), torch.as_tensor(mask, device=cuda))
    np.testing.assert_array_equal(one.cpu().numpy(), want)
    for jit in (True, False):
        got = scan_histogram(torch.as_tensor(values, device=cuda), edges,
                             mask=torch.as_tensor(mask, device=cuda), jit=jit)
        np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev,n_seeds,steps", [(9, 16, 500), (4096, 4, 300)])
def test_periodic_ensemble_on_the_card_equals_the_cpu_and_the_eager_loop(cuda, n_dev, n_seeds, steps):
    gaps = np.random.default_rng(n_dev).exponential(40.0, (n_seeds, steps, n_dev))
    card = periodic_ensemble(_fleet(n_dev, cuda), gaps, keep_device_samples=True)
    eager = periodic_ensemble(_fleet(n_dev, cuda), gaps, jit=False, keep_device_samples=True)
    cpu = periodic_ensemble(_fleet(n_dev, "cpu"), gaps, keep_device_samples=True)
    _equal(card, eager, PERIODIC)
    _equal(card, cpu, PERIODIC)
    a = run_periodic_ensemble(_fleet(n_dev, cuda), PoissonArrivals(40.0), steps, 2 * n_seeds,
                              seed=3, seed_chunk=n_seeds)
    b = run_periodic_ensemble(_fleet(n_dev, cuda), PoissonArrivals(40.0), steps, 2 * n_seeds,
                              seed=3, seed_chunk=n_seeds, jit=False)
    _equal(a, b, ("lifetime_ms", "total_items", "total_energy_mj"))


@pytest.mark.cuda
@pytest.mark.parametrize("n_dev,n_seeds", [(6, 8), (4096, 1)])
def test_routed_ensemble_on_the_card_equals_the_cpu_and_the_eager_loop(cuda, n_dev, n_seeds):
    counts = np.random.default_rng(n_dev).poisson(0.3, (n_seeds, 250, n_dev)).astype(np.int32)
    card = routed_ensemble(_fleet(n_dev, cuda), counts, 10.0, keep_device_samples=True)
    eager = routed_ensemble(_fleet(n_dev, cuda), counts, 10.0, jit=False, keep_device_samples=True)
    cpu = routed_ensemble(_fleet(n_dev, "cpu"), counts, 10.0, keep_device_samples=True)
    _equal(card, eager, ROUTED)
    _equal(card, cpu, ROUTED)


#: every check of ``calibration_accuracy``, by kernel
CAL_CHECKS = [("dequant", "bf16"), ("flash_attention", "bf16"), ("lstm", "fp32"), ("ssd", "bf16"),
              ("ssd", "fp32, the test's recipe, a = -1"),
              ("ssd", "fp32, the benchmark's recipe, a = -exp(normal)")]


@pytest.mark.cuda
@pytest.mark.parametrize("name,what", CAL_CHECKS)
def test_calibration_kernels_hold_their_plain_versions(cuda, name, what):
    """Each kernel at the calibration's pinned shape on its timed inputs:
    dequant bit for bit, the LSTM within 1e-5, flash and the SSD in bf16
    within twice the plain version's own distance from float64, relative
    to the largest output; the SSD also on fp32 inputs against a float64
    recurrence (y reaches ±231 there, ROADMAP C-ref-5)."""
    checks = costs_cli.calibration_accuracy(name, cuda)
    assert sorted(checks) == sorted(w for n, w in CAL_CHECKS if n == name)
    assert checks[what]["ok"], checks[what]
