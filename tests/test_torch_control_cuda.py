"""The control plane on the card against the CPU: a faulted, autoscaled,
pack-routed 2 × 2 × 4 day through CUDA graphs and through the eager loop
equals the CPU's run bit for bit (every rack's state, every rack event,
the latencies, the reports), and a 1-region/1-rack hierarchy of 4096
devices collapses onto ``run_routed`` on the card.

These need a CUDA card and skip where there is none.  They import neither
jax nor the JAX package, so they run on a card machine without them:

    python -m pytest -m cuda tests/test_torch_control_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.control import (
    CrossoverAutoscaler,
    hierarchy_report,
    random_schedule,
    run_hierarchy,
    slo_metrics,
    uniform_topology,
    verify_hierarchy,
)
from repro_torch.core import energy_model as em
from repro_torch.fleet.step import run_routed
from repro_torch.launch.control import _global_counts

STATE_FIELDS = (
    "energy_mj", "idle_energy_mj", "n_served", "n_configs", "n_released",
    "n_dropped", "resident", "alive", "completion_ms", "queue_ms", "q_head",
    "q_len", "rr_ptr",
)
RACK_EVENTS = (
    "powered", "crashed", "unrecoverable", "usable_devices", "lost_devices",
    "arrived", "bringup_energy_mj", "idle_tail_mj", "n_power_ons",
    "n_power_offs", "n_restarts",
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _day(device, jit, n_ticks=1024):
    topo = uniform_topology(2, 2, 4, strategies=("idle_waiting",), request_period_ms=100.0,
                            powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ,
                            bringup_ms=2000.0, bringup_mj=200.0, model_axis=2, device=device)
    args = type("Args", (), dict(load=0.5, days=1.0, amplitude=0.8, flash_every=64.0,
                                 flash_len=256, seed=0))
    counts = _global_counts(args, n_ticks, 100.0, topo.n_devices)
    return run_hierarchy(topo, counts, 100.0, epoch_ticks=64,
                         autoscaler_factory=CrossoverAutoscaler.for_rack,
                         faults=random_schedule(topo, n_ticks, 3, seed=1),
                         heartbeat_timeout_s=12.8, jit=jit, rack_routing="pack",
                         charge_idle_tail=True)


@pytest.mark.cuda
@pytest.mark.parametrize("jit", [True, False], ids=["graph", "eager"])
def test_full_run_on_the_card_equals_the_cpu(cuda, jit):
    card, cpu = _day(cuda, jit), _day("cpu", False)
    for name, a in card.racks.items():
        b = cpu.racks[name]
        assert a.state.energy_mj.device.type == cuda.type
        for f in STATE_FIELDS:
            assert torch.equal(getattr(a.state, f).cpu(), getattr(b.state, f)), (name, f)
        for e in RACK_EVENTS:
            assert getattr(a, e) == getattr(b, e), (name, e)
    assert np.array_equal(card.latency_ms, cpu.latency_ms)
    assert hierarchy_report(card) == hierarchy_report(cpu)
    assert slo_metrics(card) == slo_metrics(cpu)
    assert verify_hierarchy(card) == verify_hierarchy(cpu)
    assert card.injector.n_crashes == 3


@pytest.mark.cuda
def test_one_rack_of_4096_devices_collapses_onto_run_routed(cuda):
    topo = uniform_topology(1, 1, 4096, request_period_ms=120.0, device=cuda)
    rack = topo.regions[0].racks[0]
    counts = np.random.default_rng(0).poisson(0.5 * 4096, size=300).astype(np.int64)
    res = run_hierarchy(topo, counts, 100.0, epoch_ticks=64)
    ref = run_routed(rack.params, counts, 100.0, router=rack.router,
                     queue_capacity=rack.queue_capacity)
    state = res.racks[rack.name].state
    for f in STATE_FIELDS:
        assert torch.equal(getattr(ref.state, f), getattr(state, f)), f
    assert np.array_equal(np.sort(ref.latency_ms[ref.served_mask].cpu().numpy()),
                          np.sort(res.latency_ms))
    assert res.total_energy_mj == float(np.sum(ref.state.energy_mj.cpu().numpy()))
    res.assert_conserves()
