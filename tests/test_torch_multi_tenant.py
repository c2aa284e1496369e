"""The port's multi-tenant scheduler and the three dense configurations vs
the JAX package: every scenario of ``tests/test_planner_multitenant.py``'s
``TestMultiTenant`` and ``TestPerTenantPolicies`` on both sides under one
fake clock (energies, phases, configurations, evictions, residents,
regimes), the configs field for field, and the multi-tenant example on the
CPU.  Scheduler energies are pure-Python float math: equal, not close."""
import dataclasses

import jax
import pytest
import torch

from repro_torch.checkpoint.serializer import flatten
from repro_torch.configs import get_config
from repro_torch.core.phases import IDLE
from repro_torch.models import model_zoo as zoo
from repro_torch.serving import multi_tenant as mt
from test_torch_x64_shim import x64_shim

DENSE = ("yi-6b", "internlm2-20b", "qwen3-32b")


@pytest.fixture(scope="module")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` (imported by ``repro.core.arrivals``) is
    gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.serving.multi_tenant
        from repro.configs import base
        from repro.core import phases
        from repro.models import model_zoo

    return dict(mt=repro.serving.multi_tenant, base=base, zoo=model_zoo, phases=phases)


# ---------------------------------------------------------------------------
# the scheduler, as tests/test_planner_multitenant.py drives it
# ---------------------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def make_tenant(mod, name, clock, hbm_gb, config_s=0.3, policy="auto"):
    def bring_up():
        clock.advance(config_s)
        return name

    def infer(h, x):
        clock.advance(0.01)
        return x

    return mod.Tenant(
        name=name, bring_up=bring_up, infer=infer, release=lambda h: None,
        hbm_gb=hbm_gb, config_mw=300.0, infer_mw=170.0, idle_mw=100.0,
        policy=policy,
    )


def resident_served_without_reconfig(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler([make_tenant(mod, "a", clock, 4.0)], 16.0, clock)
    for _ in range(5):
        clock.advance(0.1)
        s.submit("a", None)
    assert s.summary()["configurations"] == 1
    return s


def eviction_under_hbm_pressure(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler(
        [make_tenant(mod, "a", clock, 10.0), make_tenant(mod, "b", clock, 10.0)],
        hbm_budget_gb=16.0, clock=clock,
    )
    s.submit("a", None)
    clock.advance(0.1)
    s.submit("b", None)              # must evict a
    assert s.summary()["evictions"] == 1
    assert s.summary()["resident"] == ["b"]
    return s


def two_models_coexist_when_they_fit(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler(
        [make_tenant(mod, "a", clock, 4.0), make_tenant(mod, "b", clock, 4.0)],
        hbm_budget_gb=16.0, clock=clock,
    )
    for _ in range(3):
        clock.advance(0.05)
        s.submit("a", None)
        clock.advance(0.05)
        s.submit("b", None)
    assert s.summary()["configurations"] == 2      # one each
    assert sorted(s.summary()["resident"]) == ["a", "b"]
    return s


def per_tenant_ski_rental_timeout(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler([make_tenant(mod, "a", clock, 4.0)], 16.0, clock)
    s.submit("a", None)
    # idle far beyond T* = 0.3·300/100 = 0.9 s → expired on next event
    clock.advance(5.0)
    s.submit("a", None)
    assert s.summary()["configurations"] == 2
    return s


def idle_energy_charged_for_residents_only(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler([make_tenant(mod, "a", clock, 4.0)], 16.0, clock)
    s.submit("a", None)
    clock.advance(0.5)
    s.submit("a", None)              # accounts 0.5 s idle @100 mW
    assert s.by_phase[IDLE] == pytest.approx(0.5 * 100.0, rel=1e-6)
    return s


def on_off_tenant_releases_every_request(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler([make_tenant(mod, "a", clock, 4.0, policy="on_off")], 16.0, clock)
    for _ in range(4):
        clock.advance(0.1)
        s.submit("a", None)
    assert s.summary()["configurations"] == 4
    assert s.summary()["resident"] == []
    return s


def idle_waiting_tenant_never_times_out(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler(
        [make_tenant(mod, "a", clock, 4.0, policy="idle_waiting")], 16.0, clock)
    s.submit("a", None)
    clock.advance(3600.0)            # far beyond any break-even timeout
    s.submit("a", None)
    assert s.summary()["configurations"] == 1
    assert s.summary()["resident"] == ["a"]
    return s


def idle_charged_only_until_timeout_release(mod):
    clock = FakeClock()
    s = mod.MultiTenantScheduler([make_tenant(mod, "a", clock, 4.0)], 16.0, clock)
    s.submit("a", None)              # auto: T* = 0.3·300/100 = 0.9 s
    clock.advance(10.0)
    s.submit("a", None)              # reconfigures; idle capped at T*
    assert s.by_phase[IDLE] == pytest.approx(0.9 * 100.0, rel=1e-6)
    return s


def adaptive_tenants_learn_per_tenant_regimes(mod):
    clock = FakeClock()
    fast = make_tenant(mod, "fast", clock, 4.0, policy="adaptive")
    slow = make_tenant(mod, "slow", clock, 4.0, policy="adaptive")
    s = mod.MultiTenantScheduler([fast, slow], 16.0, clock)
    next_fast, next_slow = 0.0, 0.0
    for _ in range(400):
        if next_fast <= next_slow:
            clock.t = max(clock.t, next_fast)
            s.submit("fast", None)
            next_fast += 0.05
        else:
            clock.t = max(clock.t, next_slow)
            s.submit("slow", None)
            next_slow += 2.0
    assert s.summary()["regimes"]["slow"] == "on_off"
    assert slow.handle is None
    assert fast.handle is not None
    assert fast.controller.idle_timeout_ms() > 50.0
    assert s.configurations == 1 + slow.controller.n_observed + 1
    return s


def mixed_policies_share_one_budget(mod):
    """Not in the reference's tests: three policies and an eviction on one
    slice, with idle gaps on both sides of the auto tenant's timeout."""
    clock = FakeClock()
    s = mod.MultiTenantScheduler(
        [make_tenant(mod, "auto", clock, 6.0), make_tenant(mod, "iw", clock, 6.0, policy="idle_waiting"),
         make_tenant(mod, "oo", clock, 3.0, config_s=0.1, policy="on_off")],
        hbm_budget_gb=12.0, clock=clock,
    )
    for i, (name, gap) in enumerate([("auto", 0.0), ("iw", 0.2), ("oo", 0.5), ("auto", 0.4),
                                     ("oo", 2.0), ("iw", 0.1), ("auto", 1.5), ("iw", 0.05)]):
        clock.advance(gap)
        s.submit(name, i)
    return s


SCENARIOS = [
    resident_served_without_reconfig, eviction_under_hbm_pressure,
    two_models_coexist_when_they_fit, per_tenant_ski_rental_timeout,
    idle_energy_charged_for_residents_only, on_off_tenant_releases_every_request,
    idle_waiting_tenant_never_times_out, idle_charged_only_until_timeout_release,
    adaptive_tenants_learn_per_tenant_regimes, mixed_policies_share_one_budget,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_multi_tenant_scheduler_equals_jax(jref, scenario):
    ours, theirs = scenario(mt), scenario(jref["mt"])
    assert ours.summary() == theirs.summary()
    assert ours.energy_mj == theirs.energy_mj and ours.by_phase == theirs.by_phase
    for name, t in ours.tenants.items():
        j = theirs.tenants[name]
        assert (t.last_used, t.last_arrival, t.measured_config_s, t.measured_infer_s) == \
            (j.last_used, j.last_arrival, j.measured_config_s, j.measured_infer_s)
        assert t.timeout_s() == j.timeout_s()


def test_infeasible_budget_and_unknown_policy_raise_as_jax(jref):
    for mod in (mt, jref["mt"]):
        clock = FakeClock()
        s = mod.MultiTenantScheduler([make_tenant(mod, "a", clock, 32.0)], 16.0, clock)
        with pytest.raises(MemoryError, match="cannot fit a: budget 16.0 GB"):
            s.submit("a", None)
        with pytest.raises(ValueError, match="unknown policy 'psychic'"):
            make_tenant(mod, "a", clock, 4.0, policy="psychic")


# ---------------------------------------------------------------------------
# the three dense configurations
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_equals_jax(jref, arch, reduced):
    ours, theirs = get_config(arch, reduced=reduced), jref["base"].get_config(arch, reduced=reduced)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for active in (False, True):
        assert ours.param_count(active_only=active) == theirs.param_count(active_only=active)
    assert ours.q_dim == theirs.q_dim and ours.kv_dim == theirs.kv_dim


@pytest.mark.parametrize("arch", DENSE)
def test_dense_param_tree_maps_one_to_one(jref, arch):
    jshapes = jref["zoo"].param_shapes(jref["base"].get_config(arch))
    ours = zoo.param_shapes(get_config(arch))
    jflat = {jax.tree_util.keystr(p): s.shape for p, s in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    oflat = {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
             jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert jflat == oflat
    # param_count leaves out the norms' scales
    weights = [t.numel() for path, t in flatten(ours) if "norm" not in path and "/ln" not in path]
    assert sum(weights) == get_config(arch).param_count()


def test_stacked_init_keeps_the_whole_leaf_draw_on_the_cpu():
    """Stacked leaves are drawn a layer at a time (so a 64-layer stack never
    needs its whole fp32 draw at once); on the CPU the values equal one draw
    of the whole leaf, so the served demos' weights from a seed stay."""
    import math

    from repro_torch.models.common import map_specs

    for arch in ("qwen3-1.7b", "yi-6b", "mamba2-370m"):
        cfg = get_config(arch, reduced=True)
        g = torch.Generator().manual_seed(0)

        def whole(spec):
            if spec.init != "normal":
                return torch.full(spec.shape, float(spec.init == "ones"), dtype=torch.bfloat16)
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
            w = torch.randn(spec.shape, generator=g, dtype=torch.float32)
            return (w * std).to(torch.bfloat16)

        ours = flatten(zoo.init_params(cfg, torch.Generator().manual_seed(0)))
        want = flatten(map_specs(whole, zoo.specs(cfg)))
        assert [p for p, _ in ours] == [p for p, _ in want]
        for (path, a), (_, b) in zip(ours, want):
            assert torch.equal(a, b), (arch, path)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------
def test_multi_tenant_serving_runs_on_the_cpu(capsys):
    from repro_torch.examples import multi_tenant_serving as mts

    s1, s2, timeouts = mts.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "tight budget (12 GB):  configs=6 evictions=5" in out
    assert "✓ eviction pays reconfiguration exactly when the budget forces it" in out
    assert s1["configurations"] == 6 and s1["evictions"] == 5
    assert s2["evictions"] == 0 and s2["configurations"] == 2 + timeouts
    assert s1["policies"] == {"qwen3-1.7b-reduced": "auto", "yi-6b-reduced": "auto"}


def test_serve_alternating_pays_two_bring_ups_when_timeouts_outlast_the_gaps():
    """Tenants whose bring-up (0.3 s) makes the break-even timeout (0.9 s)
    outlast the other tenant's work: the reference's assert, exactly two
    bring-ups under the roomy budget and no break-even release."""
    from repro_torch.examples.multi_tenant_serving import serve_alternating

    clock = FakeClock()

    def make_tenants():
        return [make_tenant(mt, name, clock, 10.0) for name in ("a", "b")]

    s1, s2, timeouts = serve_alternating(make_tenants, 12.0, 24.0, clock=clock)
    assert timeouts == 0 and s2["configurations"] == 2
    assert s1["evictions"] == 5 and s1["configurations"] == 6
