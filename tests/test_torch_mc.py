"""The port's Monte Carlo engine (``mc/intervals.py``, ``mc/ensemble.py``,
``mc/sensitivity.py``, ``launch/mc.py``, ``FleetBackend.run_mc``) against
the JAX package, on the CPU.

The intervals are numpy in both packages and equal bit for bit.  Fed the
same pre-sampled gaps or counts, the ensembles admit, serve and configure
exactly as the reference's; routed energies and latencies are equal bit
for bit; the periodic ensemble's energies lie within 1e-9 relative, because
XLA on the CPU fuses the reference's idle-energy product into its sums as a
fused multiply-add (ROADMAP C-ref-8).  The port draws from a
``torch.Generator`` where the reference draws from ``jax.random``, so
sampled ensembles are held to the reference's bands, not to its draws."""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro_torch.core import energy_model as em
from repro_torch.core.arrivals import (
    DeterministicArrivals,
    JitteredArrivals,
    MMPPArrivals,
    PoissonArrivals,
)
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.fleet import dtypes, fleet_mesh, run_periodic, run_routed, uniform_fleet
from repro_torch.mc import (
    Welford,
    bootstrap_interval,
    ci_dict,
    normal_interval,
    percentile_interval,
    periodic_ensemble,
    routed_ensemble,
    run_periodic_ensemble,
    run_routed_ensemble,
    sensitivity,
    welford_interval,
    z_value,
)
from repro_torch.mc.ensemble import _merge_welford, chunk_seed
from test_torch_x64_shim import x64_shim

CAL = em.CALIBRATED_POWERUP_OVERHEAD_MJ
STRATEGIES = ("on_off", "idle_waiting", "adaptive")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's Monte Carlo engine, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains.
    Submodules come by ``from`` imports: a JAX-package test file that failed
    to import on the same worker leaves them in ``sys.modules`` without
    their attribute on a re-imported parent package."""
    with x64_shim():
        from repro import fleet, mc
        from repro.core import arrivals, strategies
        from repro.fleet import dtypes as jdtypes
        from repro.launch import mc as launch_mc
        from repro.mc import ensemble
        from repro.serving import fleet_backend

    return dict(mc=mc, ens=ensemble, fleet=fleet, st=strategies, dtypes=jdtypes,
                launch_mc=launch_mc, backend=fleet_backend, arrivals=arrivals)


def _fleets(jref, n, budget_mj, strategies=STRATEGIES, period=40.0):
    kw = dict(strategies=strategies, request_period_ms=period, e_budget_mj=budget_mj,
              powerup_overhead_mj=CAL)
    return (uniform_fleet(n, method=IdlePowerMethod.METHOD1_2, device="cpu", **kw),
            jref["fleet"].uniform_fleet(n, method=jref["st"].IdlePowerMethod.METHOD1_2, **kw))


# ---------------------------------------------------------------------------
# Intervals and streaming moments
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("confidence", [0.9, 0.95, 0.99])
def test_every_interval_equals_the_reference_bit_for_bit(jref, confidence):
    jmc = jref["mc"]
    samples = np.random.default_rng(1).gamma(2.0, 3.0, 257)
    assert z_value(confidence) == jmc.z_value(confidence)
    for fn, jfn in ((normal_interval, jmc.normal_interval),
                    (percentile_interval, jmc.percentile_interval)):
        assert fn(samples, confidence).to_dict() == jfn(samples, confidence).to_dict()
    assert (bootstrap_interval(samples, confidence, n_boot=300, seed=4).to_dict()
            == jmc.bootstrap_interval(samples, confidence, n_boot=300, seed=4).to_dict())
    stat = lambda x: np.percentile(x, 99, axis=-1)  # noqa: E731
    assert (bootstrap_interval(samples, confidence, n_boot=50, stat=stat).to_dict()
            == jmc.bootstrap_interval(samples, confidence, n_boot=50, stat=stat).to_dict())
    with_nan = np.append(samples, [np.nan, np.inf])
    assert ci_dict(with_nan, confidence) == jmc.ci_dict(with_nan, confidence)
    assert ci_dict([np.nan]) == jmc.ci_dict([np.nan])
    x = samples[:256].reshape(64, 4)
    w, jw = Welford(), jref["ens"].Welford()
    for part in np.split(x, [5, 30]):
        w.update(part)
        jw.update(part)
    got, want = welford_interval(w, confidence), jmc.welford_interval(jw, confidence)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="non-finite"):
        normal_interval(with_nan)


def test_welford_over_chunks_equals_the_kept_samples_and_the_reference_merge(jref):
    x = np.random.default_rng(2).normal(3.0, 2.0, (50, 7))
    w = Welford()
    for part in np.split(x, [1, 9, 33]):
        w.update(part)
    np.testing.assert_allclose(w.mean, x.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(w.variance, x.var(axis=0, ddof=1), rtol=1e-12)
    a, b = Welford().update(x[:20]), Welford().update(x[20:])
    ja, jb = jref["ens"].Welford().update(x[:20]), jref["ens"].Welford().update(x[20:])
    m, jm = _merge_welford(a, b), jref["ens"]._merge_welford(ja, jb)
    assert m.count == jm.count
    np.testing.assert_array_equal(m.mean, jm.mean)
    np.testing.assert_array_equal(m.m2, jm.m2)
    assert Welford().update(np.float64(2.0)).count == 1


# ---------------------------------------------------------------------------
# Ensembles on the same inputs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("budget_mj,gap_scale", [(1500.0, 40.0), (900.0, 400.0), (3000.0, 12.0)])
def test_periodic_ensemble_equals_the_reference_on_the_same_gaps(jref, budget_mj, gap_scale):
    params, jparams = _fleets(jref, 9, budget_mj)
    gaps = np.random.default_rng(int(gap_scale)).exponential(gap_scale, (5, 400, 9))
    ens = periodic_ensemble(params, gaps, keep_device_samples=True)
    ref = jref["ens"].periodic_ensemble(jparams, gaps, keep_device_samples=True)
    np.testing.assert_array_equal(ens.per_device_items, ref.per_device_items)
    np.testing.assert_array_equal(ens.total_items, ref.total_items)
    np.testing.assert_array_equal(ens.per_device_lifetime_ms, ref.per_device_lifetime_ms)
    np.testing.assert_array_equal(ens.lifetime_ms, ref.lifetime_ms)
    # C-ref-8: the reference's energies carry XLA's fused multiply-add
    np.testing.assert_allclose(ens.per_device_energy_mj, ref.per_device_energy_mj, rtol=1e-9, atol=0)
    np.testing.assert_allclose(ens.total_energy_mj, ref.total_energy_mj, rtol=1e-9, atol=0)
    for axis in ("configure", "compute", "off", "overhead"):
        np.testing.assert_array_equal(getattr(ens.ledger, f"{axis}_mj"), getattr(ref.ledger, f"{axis}_mj"))
    np.testing.assert_allclose(ens.ledger.idle_mj, ref.ledger.idle_mj, rtol=1e-9, atol=0)
    ens.ledger.assert_conserves(ens.total_energy_mj)
    assert ens.n_seeds == 5 and ens.n_steps == 400 and ens.process == "direct"


def test_periodic_ensemble_eager_loop_equals_graph_request_and_the_ensemble_carry(jref):
    params, jparams = _fleets(jref, 6, 1500.0)
    gaps = np.random.default_rng(7).exponential(40.0, (3, 200, 6))
    a = periodic_ensemble(params, gaps, keep_device_samples=True)
    b = periodic_ensemble(params, gaps, jit=False, keep_device_samples=True)
    for f in ("per_device_items", "per_device_energy_mj", "per_device_lifetime_ms"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert dtypes.ensemble_carry_dtypes(params) == dtypes.ENSEMBLE_CARRY_DTYPES
    assert dtypes.ENSEMBLE_CARRY_DTYPES == jref["dtypes"].ENSEMBLE_CARRY_DTYPES
    assert jref["dtypes"].ensemble_carry_dtypes(jparams) == dtypes.ENSEMBLE_CARRY_DTYPES
    with pytest.raises(ValueError):
        periodic_ensemble(params, np.ones((2, 10, 5)))
    with pytest.raises(TypeError, match="Mesh"):
        periodic_ensemble(params, gaps, mesh=object())
    one = periodic_ensemble(params, gaps, keep_device_samples=True, mesh=fleet_mesh(1, 1))
    for f in ("per_device_items", "per_device_energy_mj", "per_device_lifetime_ms"):
        np.testing.assert_array_equal(getattr(a, f), getattr(one, f))


@pytest.mark.parametrize("n_seeds", [1, 4])
def test_routed_ensemble_equals_the_reference_and_run_routed(jref, n_seeds):
    params, jparams = _fleets(jref, 6, 1200.0)
    counts = np.random.default_rng(n_seeds).poisson(0.3, (n_seeds, 300, 6)).astype(np.int32)
    ens = routed_ensemble(params, counts, 10.0, keep_device_samples=True)
    ref = jref["ens"].routed_ensemble(jparams, counts, 10.0, keep_device_samples=True)
    for f in ("served", "total_energy_mj", "energy_per_request_mj", "p50_latency_ms",
              "p99_latency_ms", "devices_alive", "per_device_served", "per_device_energy_mj"):
        np.testing.assert_array_equal(getattr(ens, f), getattr(ref, f), err_msg=f)
    for axis in ("configure", "compute", "idle", "off", "overhead"):
        np.testing.assert_array_equal(getattr(ens.ledger, f"{axis}_mj"), getattr(ref.ledger, f"{axis}_mj"))
    # each seed is its own fleet: seed s equals run_routed on its own counts
    for s in range(n_seeds):
        one = run_routed(params, counts[s], 10.0, router=None)
        np.testing.assert_array_equal(ens.per_device_served[s], one.n_served.numpy())
        np.testing.assert_array_equal(ens.per_device_energy_mj[s], one.energy_mj.numpy())


def test_zero_jitter_ensemble_equals_run_periodic_and_the_closed_forms():
    params = uniform_fleet(6, strategies=STRATEGIES, method=IdlePowerMethod.METHOD1_2,
                           e_budget_mj=5000.0, powerup_overhead_mj=CAL, device="cpu")
    ref = run_periodic(params, 6000)
    item = paper_lstm_item()
    want = {"on_off": em.onoff_n_max(item, 5000.0, CAL),
            "idle_waiting": em.idlewait_n_max(item, 40.0, 5000.0, 24.0, CAL)}
    np.testing.assert_array_equal(ref.n_items.numpy()[:2], [want["on_off"], want["idle_waiting"]])
    for proc in (JitteredArrivals(40.0, 0.0), DeterministicArrivals(40.0)):
        ens = run_periodic_ensemble(params, proc, 6000, n_seeds=3, seed_chunk=2,
                                    keep_device_samples=True)
        np.testing.assert_array_equal(ens.per_device_items, np.broadcast_to(ref.n_items.numpy(), (3, 6)))
        np.testing.assert_array_equal(ens.per_device_lifetime_ms,
                                      np.broadcast_to(ref.lifetime_ms.numpy(), (3, 6)))
        np.testing.assert_allclose(ens.per_device_energy_mj,
                                   np.broadcast_to(ref.energy_mj.numpy(), (3, 6)), rtol=1e-12)
        ci = normal_interval(ens.lifetime_ms)
        assert ci.lo == ci.mean == ci.hi and np.all(ens.device_items.std == 0.0)


def test_sampled_ensembles_sit_inside_the_reference_bands(jref):
    """Poisson and MMPP ensembles from each package's own generator: the
    per-seed means agree within 5 joint standard errors (the
    ``tests/test_arrivals_stats.py`` convention of ≥ 4σ bands)."""
    ja = jref["arrivals"]
    params, jparams = _fleets(jref, 3, 1500.0)
    for proc, jproc in ((PoissonArrivals(40.0), ja.PoissonArrivals(40.0)),
                        (MMPPArrivals(20.0, 200.0), ja.MMPPArrivals(20.0, 200.0))):
        ens = run_periodic_ensemble(params, proc, 800, 96, seed=3, seed_chunk=40)
        ref = jref["ens"].run_periodic_ensemble(jparams, jproc, 800, 96, seed=3)
        for f in ("lifetime_ms", "total_items", "energy_per_request_mj"):
            a, b = getattr(ens, f).astype(np.float64), getattr(ref, f).astype(np.float64)
            se = math.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size)
            assert abs(a.mean() - b.mean()) <= 5.0 * se + 1e-12 * abs(b.mean()), (proc.name, f)
    item = paper_lstm_item()
    one = uniform_fleet(1, strategies=("idle_waiting",), method=IdlePowerMethod.METHOD1_2,
                        e_budget_mj=1500.0, powerup_overhead_mj=CAL, device="cpu")
    ens = run_periodic_ensemble(one, PoissonArrivals(40.0), 2500, 64, seed=5)
    assert np.mean(ens.total_items) == pytest.approx(
        em.idlewait_n_max(item, 40.0, 1500.0, 24.0, CAL), rel=0.02)


def test_ensembles_are_deterministic_in_seed_and_chunk():
    params = uniform_fleet(3, strategies=STRATEGIES, e_budget_mj=1500.0, device="cpu")
    a = run_periodic_ensemble(params, PoissonArrivals(40.0), 300, 10, seed=7, seed_chunk=4,
                              keep_device_samples=True)
    b = run_periodic_ensemble(params, PoissonArrivals(40.0), 300, 10, seed=7, seed_chunk=4,
                              keep_device_samples=True)
    c = run_periodic_ensemble(params, PoissonArrivals(40.0), 300, 10, seed=8, seed_chunk=4)
    np.testing.assert_array_equal(a.per_device_energy_mj, b.per_device_energy_mj)
    assert not np.array_equal(a.lifetime_ms, c.lifetime_ms)
    np.testing.assert_allclose(a.device_lifetime_ms.mean, a.per_device_lifetime_ms.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(a.device_lifetime_ms.variance,
                               a.per_device_lifetime_ms.var(axis=0, ddof=1), rtol=1e-9)
    assert len({chunk_seed(7, k) for k in range(3)} | {chunk_seed(8, 0)}) == 4
    r = run_routed_ensemble(params, PoissonArrivals(40.0), 2000.0, 10.0, n_seeds=5, seed=1, seed_chunk=2)
    r2 = run_routed_ensemble(params, PoissonArrivals(40.0), 2000.0, 10.0, n_seeds=5, seed=1, seed_chunk=2)
    np.testing.assert_array_equal(r.served, r2.served)
    assert r.process == "poisson" and r.device_served.count == 5
    assert np.all(r.p50_latency_ms <= r.p99_latency_ms)
    with pytest.raises(ValueError):
        run_periodic_ensemble(params, PoissonArrivals(40.0), 100, 0)
    with pytest.raises(TypeError, match="Mesh"):
        run_periodic_ensemble(params, PoissonArrivals(40.0), 100, 2, mesh=object())


def test_scaled_heterogeneous_ensemble_collapses_on_run_periodic():
    from repro_torch.costs import model_mix_fleet

    params = model_mix_fleet([("mamba2-370m", 2), "qwen3-1.7b"], n_devices=6,
                             e_budget_mj=5e7, device="cpu")
    ref = run_periodic(params, 150)
    ens = run_periodic_ensemble(params, DeterministicArrivals(float(params.period_ms.mean())), 150, 2,
                                scale_to_device_periods=True, keep_device_samples=True)
    np.testing.assert_array_equal(ens.per_device_items, np.broadcast_to(ref.n_items.numpy(), (2, 6)))
    np.testing.assert_allclose(ens.per_device_lifetime_ms, np.broadcast_to(ref.lifetime_ms.numpy(), (2, 6)),
                               rtol=1e-9)


# ---------------------------------------------------------------------------
# Delta method
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["crossover_uncertainty", "lifetime_ratio_uncertainty",
                                  "energy_per_request_uncertainty", "config_energy_uncertainty"])
@pytest.mark.parametrize("jitter", [0.0, 0.02])
def test_uncertainty_samples_equal_and_delta_within_1e_12(jref, name, jitter):
    kw = dict(jitter=jitter, n_seeds=64, seed=3)
    got = getattr(sensitivity, name)(**kw, **({"torch_device": "cpu"} if name.startswith("config")
                                              else {"device": "cpu"}))
    want = getattr(jref["mc"], name)(**kw)
    blocks = ([(got[k], want[k]) for k in ("min_energy", "reduction_ratio")]
              if name.startswith("config") else [(got, want)])
    for g, w in blocks:
        assert set(g) == set(w)
        for k in g:
            if k == "samples":
                np.testing.assert_array_equal(g[k], w[k])
            elif k == "delta_std":
                assert g[k] == pytest.approx(w[k], rel=1e-12, abs=0.0 if jitter else 1e-300)
            else:
                assert g[k] == w[k], k


def test_delta_method_and_cross_validate_equal_the_reference(jref):
    import jax.numpy as jnp
    import torch

    nominal = {"a": 3.0, "b": 0.5}
    got = sensitivity.delta_method(lambda p: p["a"] ** 2 * torch.exp(p["b"]), nominal, 0.05, device="cpu")
    want = jref["mc"].delta_method(lambda p: p["a"] ** 2 * jnp.exp(p["b"]), nominal, 0.05)
    assert got[0] == want[0] and got[1] == pytest.approx(want[1], rel=1e-12)
    s = np.random.default_rng(0).normal(10.0, 2.0, 100)
    assert sensitivity.cross_validate(s, 1.9) == jref["mc"].cross_validate(s, 1.9)
    for n, seed in ((5, 0), (3, 9)):
        got = sensitivity.jittered_params({"x": 2.0, "y": 5.0}, 0.1, n, seed)
        want = jref["mc"].jittered_params({"x": 2.0, "y": 5.0}, 0.1, n, seed)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# The CLI and the fleet backend
# ---------------------------------------------------------------------------
#: Payload fields derived from the delta method's gradients: autograd and
#: ``jax.grad`` may differ in the last bits of a sum of products.
_DELTA_KEYS = ("delta_std", "delta_half_width", "rel_disagreement")


def _assert_same_payload(got, want, path=""):
    """Equal keys and values; the delta-method fields within 1e-12 relative."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            if k in _DELTA_KEYS and want[k] is not None:
                assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15), f"{path}.{k}"
            else:
                _assert_same_payload(got[k], want[k], f"{path}.{k}")
    else:
        assert got == want, path


def test_mc_cli_headline_equals_the_reference_and_zero_jitter_is_exact(jref, tmp_path):
    from repro_torch.launch import mc as mc_cli

    argv = ["--smoke", "--seeds", "64", "--steps", "200", "--latency-horizon-s", "0.5"]
    assert mc_cli.main(argv + ["--device", "cpu", "--out", str(tmp_path / "p.json")]) == 0
    assert jref["launch_mc"].main(argv + ["--section", "headline", "--out", str(tmp_path / "r.json")]) == 0
    p, r = (json.loads((tmp_path / f).read_text()) for f in ("p.json", "r.json"))
    ph, rh = dict(p["headline"]), dict(r["headline"])
    ph.pop("elapsed_s"), rh.pop("elapsed_s")
    _assert_same_payload(ph, rh)
    ref = ph["deterministic_reference"]
    assert ref["crossover_ms"] == 499.06074583333327 and round(ref["crossover_ms"], 4) == 499.0607
    assert round(ref["lifetime_ratio"], 4) == 12.4108
    assert all(ref[k] for k in ("crossover_exact", "lifetime_ratio_exact", "energy_per_request_exact"))
    for key in ("crossover_ms", "lifetime_ratio", "energy_per_request_mj",
                "config_energy_min_mj", "config_reduction_ratio"):
        assert ph[key]["delta"]["rel_disagreement"] < 0.25
    assert set(p) - {"manifest"} == set(r) - {"manifest"} | {"ensemble", "latency", "throughput"}
    tp = p["throughput"]
    assert tp["ensemble"]["requests_simulated"] > 0 and tp["looped_baseline"]["seeds"] == 8
    assert p["manifest"]["backend"] == "cpu"

    assert mc_cli.main(["--smoke", "--jitter", "0", "--process", "jittered", "--section",
                        "headline,ensemble", "--device", "cpu", "--out", str(tmp_path / "z.json")]) == 0
    z = json.loads((tmp_path / "z.json").read_text())
    assert z["headline"]["crossover_ms"]["normal"]["lo"] == z["headline"]["crossover_ms"]["normal"]["hi"]
    assert z["ensemble"]["deterministic_agrees_with_fleet_kernel"] is True
    with pytest.raises(ValueError, match="bad mesh spec"):
        mc_cli.main(["--mesh", "2x2x2", "--device", "cpu"])


def test_mc_cli_mesh_2x2_ensemble_equals_mesh_1(tmp_path):
    """``--mesh 2x2`` spawns four CPU ranks: the ensemble section equals
    ``--mesh 1``'s bit for bit, and reports its runtime."""
    from repro_torch.launch import mc as mc_cli

    argv = ["--smoke", "--section", "ensemble", "--seeds", "32", "--steps", "200", "--device", "cpu"]
    outs = {}
    for mesh in ("1", "2x2"):
        assert mc_cli.main(argv + ["--mesh", mesh, "--out", str(tmp_path / f"{mesh}.json")]) == 0
        outs[mesh] = json.loads((tmp_path / f"{mesh}.json").read_text())["ensemble"]
    assert outs["1"]["runtime"] is None
    assert {k: outs["2x2"]["runtime"][k] for k in ("ranks", "backend", "staged")} == {
        "ranks": 4, "backend": "gloo", "staged": "host"}
    for blk in outs.values():
        for k in ("elapsed_s", "mesh", "runtime"):
            blk.pop(k)
    assert outs["1"] == outs["2x2"]


def test_mc_cli_writes_to_stdout_unless_given_out(tmp_path, monkeypatch, capsys):
    """No file is written by default: the repository's ``BENCH_mc.json``
    belongs to the JAX package."""
    from repro_torch.launch import mc as mc_cli

    monkeypatch.chdir(tmp_path)
    assert mc_cli.main(["--smoke", "--seeds", "8", "--boot", "20", "--section", "headline",
                        "--device", "cpu"]) == 0
    assert list(tmp_path.iterdir()) == []
    text = capsys.readouterr().out
    payload = json.loads(text[:text.rindex("}") + 1])
    assert payload["kind"] == "mc" and "headline" in payload


def _tenants(mod):
    return [
        mod.FleetTenantSpec("interactive", 500.0, 0.2, 900.0, 0.05, 30.0, policy="auto",
                            replicas=3, mean_period_ms=400.0, e_budget_mj=2000.0),
        mod.FleetTenantSpec("batch", 400.0, 0.1, 700.0, 0.03, 20.0, policy="on_off",
                            replicas=2, mean_period_ms=900.0, e_budget_mj=1000.0),
    ]


def test_backend_run_mc_equals_the_reference_ensemble_on_the_port_streams(jref):
    from repro_torch.serving import fleet_backend as fb

    backend = fb.FleetBackend(_tenants(fb), device="cpu")
    jbackend = jref["backend"].FleetBackend(_tenants(jref["backend"]))
    out = backend.run_mc(horizon_ms=6000.0, dt_ms=50.0, n_seeds=6, seed=2, jitter=0.05)
    jout = jbackend.run_mc(horizon_ms=6000.0, dt_ms=50.0, n_seeds=6, seed=2, jitter=0.05)
    assert out.keys() == jout.keys() and out["fleet"].keys() == jout["fleet"].keys()
    assert {k: v.keys() for k, v in out["tenants"].items()} == {k: v.keys() for k, v in jout["tenants"].items()}
    assert out["fleet"]["served"]["n"] == 6
    for t in out["tenants"].values():
        assert t["served"]["mean"] > 0
    counts = backend._sample_counts(6000.0, 50.0, 2, n_seeds=6, jitter=0.05)
    ens = routed_ensemble(backend.params, counts, 50.0, keep_device_samples=True)
    ref = jref["ens"].routed_ensemble(jbackend.params, counts.numpy(), 50.0, keep_device_samples=True)
    np.testing.assert_array_equal(ens.per_device_served, ref.per_device_served)
    np.testing.assert_array_equal(ens.per_device_energy_mj, ref.per_device_energy_mj)
    assert out["fleet"]["served"] == ci_dict(ens.served)
    with pytest.raises(ValueError):
        backend.run_mc(1000.0, n_seeds=0)


def test_result_dataclasses_mirror_the_reference(jref):
    import repro_torch.mc.ensemble as pe

    for name in ("PeriodicEnsembleResult", "RoutedEnsembleResult"):
        assert ([f.name for f in dataclasses.fields(getattr(pe, name))]
                == [f.name for f in dataclasses.fields(getattr(jref["ens"], name))])
