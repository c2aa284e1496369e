"""The port's learned timeout policy (``policy/features.py``, ``net.py``,
``rollout.py``, ``train.py``, ``controller.py``, ``obs/ledger.py::
ledger_from_rollout``, ``launch/policy.py``) against the JAX package and
the port's own scalar simulator, on the CPU.

Fed the same network, gaps and ES noise, the rollout, the smooth
objective's gradient and the two training phases follow the reference; the
rollout also replays ``simulate_trace`` with item counts exact.  Training
is held to the reference run op by op (``jax.disable_jit``, IEEE rounding
everywhere) within 1e-9, and to the compiled reference within the rounding
its fused fp32 Adam arithmetic adds (ROADMAP C-ref-9).  The port draws from
``torch.Generator``\\ s where the reference draws from ``jax.random``, so a
policy trained from the port's own draws is held to the reference's
acceptance criteria, not to its numbers."""
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.adaptive import (
    AdaptiveStrategy,
    FixedTimeoutPolicy,
    PolicyController,
    StaticPolicy,
)
from repro_torch.core.arrivals import (
    DeterministicArrivals,
    FlashCrowdArrivals,
    MMPPArrivals,
    PoissonArrivals,
)
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.simulator import simulate_trace
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.obs import ledger_from_rollout
from repro_torch.policy import (
    LearnedTimeoutPolicy,
    TrainedPolicy,
    TrainSettings,
    train_policy,
    untrained_policy,
)
from repro_torch.policy import features as F
from repro_torch.policy import net as N
from repro_torch.policy.rollout import make_consts, mean_energy_per_gap, rollout
from repro_torch.policy.train import (
    _bp_run,
    _es_run,
    ravel,
    sample_training_gaps,
    training_processes,
    unravel,
)
from test_torch_x64_shim import x64_shim

M12 = IdlePowerMethod.METHOD1_2
OVERHEAD = em.CALIBRATED_POWERUP_OVERHEAD_MJ
CPU = "cpu"
TINY = TrainSettings(hidden=(8,), n_streams=8, n_gaps=48, bp_steps=3, es_steps=2, es_pop=4)


@pytest.fixture(scope="module")
def jref():
    """The JAX package's policy, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains.
    Submodules come by ``from`` imports: a JAX-package test file that failed
    to import on the same worker leaves them in ``sys.modules`` without
    their attribute on a re-imported parent package; ``repro.policy``
    itself re-exports a function named ``rollout``."""
    import jax

    with x64_shim():
        import jax.numpy as jnp
        from repro.core import phases as jphases
        from repro.obs.ledger import ledger_from_rollout as jledger
        from repro.policy import controller as jcontroller
        from repro.policy import features as jF
        from repro.policy import net as jN
        from repro.policy import train as jtrain
        from repro.policy.rollout import make_consts as jconsts
        from repro.policy.rollout import mean_energy_per_gap as jmean
        from repro.policy.rollout import rollout as jrollout

    return dict(jax=jax, jnp=jnp, x64=jax.enable_x64, F=jF, N=jN, train=jtrain,
                rollout=jrollout, mean=jmean, consts=jconsts, ledger=jledger,
                controller=jcontroller, item=jphases.paper_lstm_item())


@pytest.fixture(scope="module")
def item():
    return paper_lstm_item()


@pytest.fixture(scope="module")
def consts(item):
    return make_consts(item, M12, OVERHEAD)


def random_params(seed=7, hidden=(8, 8)):
    """A small *non-zero* network as numpy arrays (the zero init is the
    anchor; parity must also hold when the net steers the timeout)."""
    rng = np.random.default_rng(seed)
    sizes = (F.N_FEATURES, *hidden, 1)
    return [{"w": rng.normal(0.0, 1.0, (a, b)) / math.sqrt(a) + 0.3 * rng.normal(0.0, 1.0, (a, b)),
             "b": 0.1 * rng.normal(0.0, 1.0, (b,))} for a, b in zip(sizes[:-1], sizes[1:])]


def _jparams(jref, params):
    jnp = jref["jnp"]
    return [{k: jnp.asarray(np.asarray(v)) for k, v in layer.items()} for layer in params]


def _gaps(proc, n_streams=4, n_gaps=300, seed=0):
    return proc.sample_gaps(torch.Generator().manual_seed(seed), n_streams, n_gaps).numpy()


def trace_from_gaps(gaps_row):
    return np.concatenate([[0.0], np.cumsum(np.asarray(gaps_row))])


def replica_policy(trained, item_):
    """The guard-less, snap-less LearnedTimeoutPolicy: the scalar twin of
    the rollout's timeout path."""
    return LearnedTimeoutPolicy(trained, item=item_, guard=False, snap_lo=0.0, snap_hi=math.inf)


MMPP = MMPPArrivals(burst_ms=2.0, quiet_ms=4000.0, mean_burst_len=12.0, mean_quiet_len=3.0)


# ---------------------------------------------------------------------------
# features and the network
# ---------------------------------------------------------------------------
T_BE = 493.831


def _gap_seqs():
    rng = np.random.default_rng(3)
    one = np.concatenate([rng.exponential(40.0, 50), np.full(20, 2000.0), rng.exponential(5.0, 30)])
    return np.stack([one, one[::-1], rng.exponential(600.0, one.size)])


def test_features_match_the_reference_and_the_python_twin(jref):
    seqs = _gap_seqs()
    jnp = jref["jnp"]
    t_be = torch.tensor(T_BE, dtype=torch.float64)
    s_t = F.init_state_tensor((seqs.shape[0],))
    s_p = [F.init_state() for _ in seqs]
    with jref["x64"]():
        s_j = [jref["F"].init_state_jnp() for _ in seqs]
        for t in range(seqs.shape[1]):
            s_t = F.update_state(s_t, torch.tensor(seqs[:, t]), t_be)
            f_t = F.feature_vector(s_t, t_be).numpy()
            for i in range(seqs.shape[0]):
                s_p[i] = F.update_state_py(s_p[i], float(seqs[i, t]), T_BE)
                s_j[i] = jref["F"].update_state(s_j[i], jnp.float64(seqs[i, t]), jnp.float64(T_BE))
                f_j = np.asarray(jref["F"].feature_vector(s_j[i], jnp.float64(T_BE)))
                np.testing.assert_allclose(f_t[i], f_j, rtol=0, atol=1e-12)
                np.testing.assert_allclose(f_t[i], F.feature_vector_py(s_p[i], T_BE), rtol=0, atol=1e-12)
    assert F.feature_vector(F.init_state_tensor((2, 3)), t_be).shape == (2, 3, F.N_FEATURES)


def test_feature_vector_is_bounded():
    s = F.init_state()
    for g in [0.0, 1e-3, 40.0, 1e6, 40.0] * 10:
        s = F.update_state_py(s, g, T_BE)
        f = np.asarray(F.feature_vector_py(s, T_BE))
        assert f.shape == (F.N_FEATURES,) and np.all(np.isfinite(f)) and np.all(np.abs(f) < 20.0)


def test_untrained_net_is_ski_rental(item):
    trained = untrained_policy(item, method=M12, powerup_overhead_mj=OVERHEAD)
    rng = np.random.default_rng(0)
    for _ in range(20):
        assert N.timeout_ms_np(trained.params, rng.normal(size=F.N_FEATURES), trained.t_be_ms) == trained.t_be_ms
    t_be = torch.tensor(trained.t_be_ms, dtype=torch.float64)
    feats = torch.tensor(rng.normal(size=(5, F.N_FEATURES)))
    assert torch.equal(N.timeout_ms(N.to_tensors(trained.params), feats, t_be), t_be.expand(5))


def test_mlp_equals_the_reference_numpy_and_population_forms(jref):
    params = random_params()
    feats = np.random.default_rng(1).normal(size=(10, F.N_FEATURES))
    got = N.apply_mlp(N.to_tensors(params), torch.tensor(feats)).numpy()
    with jref["x64"]():
        want = np.asarray(jref["N"].apply_mlp(_jparams(jref, params), jref["jnp"].asarray(feats)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    for i in range(3):
        assert N.apply_mlp_np(N.params_to_numpy(params), feats[i]) == pytest.approx(got[i], rel=1e-12, abs=1e-12)
    # a population of three networks in one batched matmul per layer
    nets = [random_params(seed) for seed in (7, 8, 9)]
    pop = [{k: torch.stack([torch.tensor(n[li][k]) for n in nets]) for k in ("w", "b")}
           for li in range(len(nets[0]))]
    x = torch.tensor(np.stack([feats] * 3))
    out = N.apply_mlp(pop, x)
    assert out.shape == (3, 10)
    for p, net in enumerate(nets):
        np.testing.assert_allclose(out[p].numpy(), N.apply_mlp(N.to_tensors(net), x[p]).numpy(),
                                   rtol=1e-13, atol=1e-14)


def test_timeout_is_clipped_and_positive():
    params = random_params()
    tau = N.timeout_ms_np(params, np.full(F.N_FEATURES, 50.0), 500.0)
    assert 0.0 < tau <= 500.0 * math.exp(N.LOG_SPAN) * (1 + 1e-12)


def test_init_mlp_draws_from_a_generator():
    a = N.init_mlp(torch.Generator().manual_seed(3), hidden=(5, 4))
    b = N.init_mlp(torch.Generator().manual_seed(3), hidden=(5, 4))
    assert [tuple(l["w"].shape) for l in a] == [(6, 5), (5, 4), (4, 1)]
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a, b))
    assert not a[-1]["w"].any() and not any(l["b"].any() for l in a)
    assert 0.5 < float(a[0]["w"].std() * math.sqrt(6)) < 1.6


# ---------------------------------------------------------------------------
# rollout == the reference's rollout == simulate_trace
# ---------------------------------------------------------------------------
def _held(out, want, energy_rtol):
    for k in ("n_items", "configurations", "releases"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(want[k]), err_msg=k)
    for k in ("energy_mj", "idle_energy_mj", "lifetime_ms", "energy_smooth_mj"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want[k]), rtol=energy_rtol, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("budget", [math.inf, 300.0])
def test_untrained_rollout_equals_the_reference_and_the_fixed_break_even(jref, item, budget):
    trained = untrained_policy(item, method=M12, powerup_overhead_mj=OVERHEAD)
    gaps = _gaps(MMPP)
    c = dict(trained.consts, budget=budget)
    out = rollout(trained.params, gaps, c, device=CPU)
    with jref["x64"]():
        want = jref["rollout"](_jparams(jref, trained.params), gaps, c)
    _held(out, want, 1e-9)
    for i in range(gaps.shape[0]):
        res = simulate_trace(item, trace_from_gaps(gaps[i]),
                             FixedTimeoutPolicy(timeout_ms=trained.t_be_ms,
                                                idle_power_mw=trained.consts["p_idle"]), budget, OVERHEAD)
        assert (res.n_items, res.configurations, res.releases) == (
            int(out["n_items"][i]), int(out["configurations"][i]), int(out["releases"][i]))
        assert res.energy_used_mj == pytest.approx(float(out["energy_mj"][i]), rel=1e-9, abs=1e-9)
        assert res.lifetime_ms == pytest.approx(float(out["lifetime_ms"][i]), rel=1e-12, abs=1e-9)


@pytest.mark.parametrize("proc_name", ["mmpp", "poisson", "flash"])
def test_random_net_rollout_equals_the_reference_and_the_replica_policy(jref, item, consts, proc_name):
    """Counts exact; energies within 1e-6 relative (the reference's own
    allowance: libm and XLA tanh differ in the last ulp)."""
    trained = TrainedPolicy(params=random_params(), consts=consts, history={},
                            meta={"method": "METHOD1_2", "powerup_overhead_mj": OVERHEAD})
    proc = {"mmpp": MMPP, "poisson": PoissonArrivals(600.0),
            "flash": FlashCrowdArrivals(quiet_ms=3000.0, flash_gap_ms=10.0)}[proc_name]
    gaps = _gaps(proc, seed=11)
    c = dict(consts, budget=400.0)
    out = rollout(trained.params, gaps, c, device=CPU)
    with jref["x64"]():
        want = jref["rollout"](_jparams(jref, trained.params), gaps, c)
    _held(out, want, 1e-6)
    for i in range(gaps.shape[0]):
        res = simulate_trace(item, trace_from_gaps(gaps[i]), replica_policy(trained, item), 400.0, OVERHEAD)
        assert (res.n_items, res.configurations, res.releases) == (
            int(out["n_items"][i]), int(out["configurations"][i]), int(out["releases"][i]))
        assert res.energy_used_mj == pytest.approx(float(out["energy_mj"][i]), rel=1e-6)


def test_population_rollout_equals_one_network_at_a_time(consts):
    nets = [random_params(seed) for seed in (1, 2, 3)]
    gaps = _gaps(MMPP, n_streams=5, n_gaps=120, seed=2)
    pop = [{k: np.stack([n[li][k] for n in nets]) for k in ("w", "b")} for li in range(3)]
    out = rollout(pop, gaps, dict(consts, budget=300.0), device=CPU)
    assert out["energy_mj"].shape == (3, 5)
    for p, net in enumerate(nets):
        one = rollout(net, gaps, dict(consts, budget=300.0), device=CPU)
        for k in one:
            np.testing.assert_allclose(out[k][p].numpy(), one[k].numpy(), rtol=1e-12, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("block", [1, 7, 1 << 25])
def test_blocks_of_timeouts_and_kept_features_give_the_same_rollout(monkeypatch, consts, block):
    """The timeouts are evaluated a block of gaps at a time; any block, and
    features kept from :func:`feature_sequence`, give the same rollout."""
    import sys

    from repro_torch.policy.rollout import feature_sequence

    ro = sys.modules["repro_torch.policy.rollout"]
    gaps = torch.tensor(_gaps(MMPP, n_streams=3, n_gaps=50, seed=8))
    params = N.to_tensors(random_params())
    c = dict(consts, budget=300.0)
    whole = rollout(params, gaps, c, smooth=True, device=CPU)
    monkeypatch.setattr(ro, "_BLOCK", block * 3 * 8)
    got = rollout(params, gaps, c, smooth=True, device=CPU)
    feats = feature_sequence(gaps, consts["t_be"])
    assert feats.shape == (3, 50, F.N_FEATURES)
    for layer in params:
        for t in layer.values():
            t.requires_grad_(True)
    kept = mean_energy_per_gap(params, gaps, c, True, feats)
    for k in whole:
        np.testing.assert_allclose(got[k].numpy(), whole[k].numpy(), rtol=1e-13, atol=1e-13, err_msg=k)
    assert float(kept.detach()) == pytest.approx(float(whole["energy_smooth_mj"].mean()) / (50 * c["e_config"]),
                                                 rel=1e-13)


def test_smooth_energy_tracks_hard_energy(item, consts):
    params = random_params()
    gaps = _gaps(PoissonArrivals(800.0), seed=5)
    errs = []
    for frac in (0.1, 1e-3):
        out = rollout(params, gaps, make_consts(item, M12, OVERHEAD, smooth_ms=frac * consts["t_be"]),
                      smooth=True, device=CPU)
        hard, smooth = out["energy_mj"].numpy(), out["energy_smooth_mj"].numpy()
        errs.append(float(np.max(np.abs(smooth - hard) / hard)))
    assert errs[1] < errs[0] and errs[1] < 1e-3


def test_smooth_objective_gradient_equals_jax_grad(jref, consts):
    params = random_params(hidden=(4, 4))
    gaps = _gaps(PoissonArrivals(600.0), seed=9)
    tp = N.to_tensors(params)
    for layer in tp:
        for t in layer.values():
            t.requires_grad_(True)
    loss = mean_energy_per_gap(tp, torch.tensor(gaps), consts, True)
    loss.backward()
    jax, jnp = jref["jax"], jref["jnp"]
    with jref["x64"]():
        cj = {k: jnp.float64(v) for k, v in consts.items()}
        jl, jg = jax.value_and_grad(lambda p: jref["mean"](p, jnp.asarray(gaps), cj, True))(_jparams(jref, params))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-12)
    for layer, jlayer in zip(tp, jg):
        for k in ("w", "b"):
            g, w = layer[k].grad.numpy(), np.asarray(jlayer[k])
            assert np.max(np.abs(g - w)) <= 1e-9 * max(np.max(np.abs(w)), 1e-300), k
            assert np.any(g != 0.0)


def test_rollout_validates_and_defaults_to_the_card(monkeypatch, consts):
    with pytest.raises(ValueError, match="n_streams"):
        rollout(random_params(), np.zeros(5), consts, device=CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rollout(random_params(), np.ones((2, 3)), consts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_policy(paper_lstm_item(), M12, settings=TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_training_gaps(training_processes(500.0), 8, 4, seed=0)


# ---------------------------------------------------------------------------
# training: the same inputs give the reference's steps
# ---------------------------------------------------------------------------
def _training_inputs(jref, consts, hidden=(8,), n_streams=8, n_gaps=48, seed=0):
    """The reference's own draws for a run seeded ``seed``: its initial
    network, its training gaps and its ES keys."""
    jax = jref["jax"]
    with jref["x64"]():
        procs = jref["train"].training_processes(consts["t_be"])
        gaps = np.asarray(jref["train"].sample_training_gaps(procs, n_streams, n_gaps, seed))
        params = [{k: np.asarray(v) for k, v in layer.items()}
                  for layer in jref["N"].init_mlp(jax.random.PRNGKey(seed), hidden=hidden)]
    return params, gaps


def _es_noise(jref, key, steps, half_pop, d):
    jax, jnp = jref["jax"], jref["jnp"]
    with jref["x64"]():
        keys = jax.random.split(key, steps)
        return np.stack([np.asarray(jax.random.normal(k, (half_pop, d), dtype=jnp.float64)) for k in keys])


def _bp_es_reference(jref, params, gaps, consts, bp_steps, es_steps, half_pop, jit):
    jax, jnp = jref["jax"], jref["jnp"]
    with jref["x64"](), jax.disable_jit(not jit):
        cj = {k: jnp.asarray(v, dtype=jnp.float64) for k, v in consts.items()}
        g = jnp.asarray(gaps)
        p1, bp = jref["train"]._bp_run(_jparams(jref, params), g, cj, jnp.float64(0.02), bp_steps)
        p2, es = jref["train"]._es_run(p1, g, cj, jax.random.PRNGKey(1), jnp.float64(0.01),
                                       jnp.float64(0.05), es_steps, half_pop)
        return ([{k: np.asarray(v) for k, v in l.items()} for l in p1],
                [{k: np.asarray(v) for k, v in l.items()} for l in p2], np.asarray(bp), np.asarray(es))


def _port_bp_es(params, gaps, consts, bp_steps, es_steps, half_pop, noise):
    tp = N.to_tensors(params)
    g = torch.tensor(gaps)
    tp, bp = _bp_run(tp, g, consts, torch.tensor(0.02, dtype=torch.float64), bp_steps)
    p1 = N.params_to_numpy(tp)
    tp, es = _es_run(tp, g, consts, torch.tensor(0.01, dtype=torch.float64), 0.05, es_steps, half_pop,
                     noise=noise)
    return p1, N.params_to_numpy(tp), bp.numpy(), es.numpy()


def _close(got, want, tol):
    for a, b in zip(got, want):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("jit,n_gaps,tol", [(False, 8, 1e-9), (True, 48, 1e-7)])
def test_three_bp_steps_and_two_es_steps_follow_the_reference(jref, consts, jit, n_gaps, tol):
    """Same network, gaps and ES noise (the reference's keys, flattened
    ``b`` before ``w``): within 1e-9 of the reference run op by op (8 gaps
    a stream: op by op is slow), and within the fused fp32 rounding of the
    compiled reference (ROADMAP C-ref-9)."""
    params, gaps = _training_inputs(jref, consts, n_gaps=n_gaps)
    d = sum(np.asarray(v).size for layer in params for v in layer.values())
    noise = _es_noise(jref, jref["jax"].random.PRNGKey(1), 2, 2, d)
    got = _port_bp_es(params, gaps, consts, 3, 2, 2, noise)
    want = _bp_es_reference(jref, params, gaps, consts, 3, 2, 2, jit)
    _close(got[0], want[0], tol)
    _close(got[1], want[1], tol)
    np.testing.assert_allclose(got[2], want[2], rtol=tol)
    np.testing.assert_allclose(got[3], want[3], rtol=tol)


def test_ravel_order_is_the_references(jref):
    params = random_params(hidden=(3,))
    flat = ravel(N.to_tensors(params)).numpy()
    with jref["x64"]():
        from jax.flatten_util import ravel_pytree

        want = np.asarray(ravel_pytree(_jparams(jref, params))[0])
    np.testing.assert_array_equal(flat, want)
    back = unravel(torch.tensor(np.stack([flat, 2 * flat])), N.to_tensors(params))
    assert back[0]["w"].shape == (2, 6, 3)
    np.testing.assert_array_equal(back[1]["b"][1].numpy(), 2 * params[1]["b"])


def test_train_policy_fed_the_references_draws_follows_it(jref, item, consts):
    """A few steps of both phases end to end, the reference's initial
    network, gaps and ES noise fed to the port: the trained network within
    the compiled reference's fp32 rounding, the baseline cost as the same
    float up to 1e-12."""
    params, gaps = _training_inputs(jref, consts, hidden=TINY.hidden, n_streams=TINY.n_streams,
                                    n_gaps=TINY.n_gaps, seed=TINY.seed)
    d = sum(np.asarray(v).size for layer in params for v in layer.values())
    noise = _es_noise(jref, jref["jax"].random.PRNGKey(TINY.seed + 1), TINY.es_steps, TINY.es_pop // 2, d)
    got = train_policy(item, M12, OVERHEAD, settings=TINY, device=CPU, init_params=params, gaps=gaps,
                       es_noise=noise)
    with jref["x64"]():
        from repro.core.strategies import IdlePowerMethod as JM
        from repro.policy.train import TrainSettings as JTS

        want = jref["train"].train_policy(jref["item"], JM.METHOD1_2, OVERHEAD,
                                          settings=JTS(**{f: getattr(TINY, f) for f in TINY.__dataclass_fields__}))
    _close(got.params, want.params, 1e-6)
    assert got.history["baseline_hard"] == pytest.approx(want.history["baseline_hard"], rel=1e-12)
    assert got.history["final_hard"] == pytest.approx(want.history["final_hard"], rel=1e-6)
    assert got.meta == want.meta
    assert got.history["bp_loss"].shape == (3,) and got.history["es_loss"].shape == (2,)


def test_train_policy_is_deterministic_in_its_seed(item):
    a = train_policy(item, M12, OVERHEAD, settings=TINY, device=CPU)
    b = train_policy(item, M12, OVERHEAD, settings=TINY, device=CPU)
    for x, y in zip(a.params, b.params):
        np.testing.assert_array_equal(x["w"], y["w"])
    assert a.history["final_hard"] == b.history["final_hard"]
    assert a.meta["trained"] and np.isfinite(a.history["baseline_hard"])


def test_training_gap_mixture_interleaves_rows(consts):
    procs = training_processes(consts["t_be"])
    gaps = sample_training_gaps(procs, 16, 64, seed=0, device=CPU)
    assert gaps.shape == (16, 64) and bool((gaps >= 0).all()) and bool(torch.isfinite(gaps).all())
    # row i is process (i mod P): three deterministic processes mark the rows
    marks = [DeterministicArrivals(float(k + 1)) for k in range(3)]
    g = sample_training_gaps(marks, 7, 4, seed=0, device=CPU)
    assert g[:, 0].tolist() == [1.0, 2.0, 3.0, 1.0, 2.0, 3.0, 1.0]


# ---------------------------------------------------------------------------
# the stationarity guard, serialisation, the serving integration
# ---------------------------------------------------------------------------
def _random_trained(item, consts):
    return TrainedPolicy(params=random_params(), consts=consts, history={},
                         meta={"method": "METHOD1_2", "powerup_overhead_mj": OVERHEAD})


@pytest.mark.parametrize("kind,period", [("deterministic", 40.0), ("deterministic", 2000.0),
                                         ("poisson", 40.0), ("poisson", 4000.0)])
def test_guard_matches_the_adaptive_strategy_exactly(item, consts, kind, period):
    trained = _random_trained(item, consts)
    ref = AdaptiveStrategy(item=item, method=M12, powerup_overhead_mj=OVERHEAD)
    choice = ref.decide(period)
    gaps = (np.full(599, period) if kind == "deterministic"
            else _gaps(PoissonArrivals(period), n_streams=1, n_gaps=599)[0])
    trace = trace_from_gaps(gaps)
    pol = LearnedTimeoutPolicy(trained, item=item, prior_period_ms=period)
    got = simulate_trace(item, trace, pol, 2000.0, OVERHEAD)
    want = simulate_trace(item, trace, StaticPolicy(choice, item, method=M12, powerup_overhead_mj=OVERHEAD),
                          2000.0, OVERHEAD)
    assert pol.regime() == choice and got.n_items == want.n_items
    assert abs(got.energy_used_mj - want.energy_used_mj) <= 1e-9
    assert pol.regime_switches <= 1


def test_guard_disengages_on_bursty_traffic_and_rejects_bad_priors(item):
    trained = untrained_policy(item, method=M12, powerup_overhead_mj=OVERHEAD)
    pol = LearnedTimeoutPolicy(trained, item=item)
    rng = np.random.default_rng(0)
    for _ in range(200):
        pol.observe_gap(2.0 if rng.random() < 0.8 else 8000.0)
    assert pol.regime() == "learned" and not pol.summary()["guard_engaged"]
    assert pol.idle_timeout_ms() == pytest.approx(pol.break_even_ms())
    for bad in (0.0, -1.0, math.inf, math.nan):
        with pytest.raises(ValueError):
            LearnedTimeoutPolicy(trained, item=item, prior_period_ms=bad)


def test_json_round_trip(item):
    trained = untrained_policy(item, method=M12, powerup_overhead_mj=OVERHEAD)
    back = TrainedPolicy.from_json_dict(json.loads(json.dumps(trained.to_json_dict())))
    assert back.consts == trained.consts and back.meta == trained.meta
    for a, b in zip(back.params, trained.params):
        np.testing.assert_array_equal(a["w"], b["w"])


def _timeouts(policy, gaps):
    out = []
    for g in gaps:
        policy.observe_gap(float(g))
        out.append((policy.idle_timeout_ms(), policy.regime()))
    return out


@pytest.mark.parametrize("guard", [True, False])
def test_a_policy_written_by_either_package_decides_the_same_in_the_other(jref, item, consts, guard):
    """A TrainedPolicy JSON written by the JAX package gives the port's
    LearnedTimeoutPolicy the same ``idle_timeout_ms`` sequence, exactly, and
    the port's JSON loads in the JAX package."""
    jTP, jLP = jref["train"].TrainedPolicy, jref["controller"].LearnedTimeoutPolicy
    jtrained = jTP(params=random_params(), consts=consts, history={"baseline_hard": 1.0},
                   meta={"method": "METHOD1_2", "powerup_overhead_mj": OVERHEAD})
    blob = json.dumps(jtrained.to_json_dict())
    port = TrainedPolicy.from_json_dict(json.loads(blob))
    assert json.dumps(port.to_json_dict()) == blob
    back = jTP.from_json_dict(json.loads(json.dumps(port.to_json_dict())))
    gaps = np.concatenate([_gaps(MMPP, n_streams=1, n_gaps=150, seed=4)[0], np.full(30, 40.0)])
    want = _timeouts(jLP(jtrained, item=jref["item"], guard=guard), gaps)
    assert _timeouts(LearnedTimeoutPolicy(port, item=item, guard=guard), gaps) == want
    assert _timeouts(jLP(back, item=jref["item"], guard=guard), gaps) == want


def _learned(item, prior=None, prior_weight=8.0):
    trained = untrained_policy(item, method=M12, powerup_overhead_mj=OVERHEAD)
    return LearnedTimeoutPolicy(trained, item=item, prior_period_ms=prior, prior_weight=prior_weight)


def test_duty_cycle_controller_accepts_the_learned_policy(item):
    from repro_torch.core.duty_cycle import DutyCycleController, PowerModel

    clock = [0.0]

    def bring_up():
        clock[0] += 0.5
        return "h"

    def infer(h, x):
        clock[0] += 0.01
        return x

    c = DutyCycleController(bring_up, infer, lambda h: None,
                            PowerModel(config_mw=300.0, infer_mw=170.0, idle_mw=134.0),
                            strategy="adaptive", clock=lambda: clock[0],
                            policy=_learned(item, prior=40.0, prior_weight=64.0))
    for x in range(4):
        c.submit(x)
        clock[0] += 0.04
    assert c.timeout_s() is None and c.policy.summary()["regime"] == "idle_waiting"


def test_tenant_and_simulate_trace_accept_the_learned_policy(item):
    from repro_torch.serving.multi_tenant import Tenant

    t = Tenant(name="m", bring_up=lambda: "h", infer=lambda h, x: x, release=lambda h: None, hbm_gb=1.0,
               config_mw=300.0, infer_mw=170.0, idle_mw=134.0, policy="adaptive",
               controller=_learned(item, prior=5000.0))
    assert isinstance(t.controller, LearnedTimeoutPolicy)
    t.observe_gap(5.0)
    assert t.controller.n_observed == 1 and t.controller.idle_timeout_ms() == 0.0
    res = simulate_trace(item, trace_from_gaps(np.full(50, 40.0)), _learned(item, prior=40.0), 100.0, OVERHEAD)
    assert res.policy == "learned" and res.n_items > 0 and res.releases == 0


def test_ledger_from_rollout_equals_the_reference_and_conserves(jref, item, consts):
    trained = _random_trained(item, consts)
    gaps = _gaps(MMPP, seed=6)
    c = dict(consts, budget=350.0)
    out = rollout(trained.params, gaps, c, device=CPU)
    led = ledger_from_rollout(out, c)
    led.assert_conserves(out["energy_mj"].numpy(), rtol=1e-9)
    with jref["x64"]():
        want = jref["ledger"](jref["rollout"](_jparams(jref, trained.params), gaps, c), c)
    for ax in ("configure", "compute", "idle", "off", "overhead"):
        np.testing.assert_allclose(getattr(led, f"{ax}_mj"), np.asarray(getattr(want, f"{ax}_mj")),
                                   rtol=1e-6, atol=1e-9, err_msg=ax)
    assert led.overhead_mj.sum() > 0.0


# ---------------------------------------------------------------------------
# the reference's acceptance criteria on the port's own draws (slow)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smoke_trained(item):
    return train_policy(item, method=M12, powerup_overhead_mj=OVERHEAD, settings=TrainSettings.smoke(),
                        device=CPU)


@pytest.mark.slow
def test_smoke_training_improves_the_hard_objective(smoke_trained):
    h = smoke_trained.history
    assert h["final_hard"] < h["baseline_hard"] * 0.95


@pytest.mark.slow
def test_smoke_training_is_deterministic_in_its_seed(item, smoke_trained):
    again = train_policy(item, method=M12, powerup_overhead_mj=OVERHEAD, settings=TrainSettings.smoke(),
                         device=CPU)
    for a, b in zip(again.params, smoke_trained.params):
        np.testing.assert_array_equal(a["w"], b["w"])


@pytest.mark.slow
def test_learned_beats_the_hybrid_on_the_flash_crowd(item, smoke_trained):
    t = smoke_trained.t_be_ms
    proc = FlashCrowdArrivals(quiet_ms=6.0 * t, flash_gap_ms=0.02 * t, flash_len=32, flash_every=4.0)
    learned_n = hybrid_n = 0
    for seed in range(6):
        trace = trace_from_gaps(_gaps(proc, n_streams=1, n_gaps=999, seed=seed)[0])
        learned_n += simulate_trace(item, trace, LearnedTimeoutPolicy(smoke_trained, item=item), 1500.0,
                                    OVERHEAD).n_items
        hybrid_n += simulate_trace(item, trace, PolicyController(item=item, method=M12,
                                                                 powerup_overhead_mj=OVERHEAD),
                                   1500.0, OVERHEAD).n_items
    assert learned_n > hybrid_n * 1.05


@pytest.mark.slow
def test_policy_cli_smoke_on_the_cpu(capsys):
    from repro_torch.launch import policy as cli

    cli.main(["--device", "cpu", "--smoke", "--seeds", "8", "--arrivals", "600"])
    payload = json.loads(capsys.readouterr().out)
    assert payload["stationary"]["all_exact"]
    assert payload["train"]["improvement_frac"] > 0.05
    assert payload["throughput"]["rollout"]["steps"] == 64 * 256


def test_policy_cli_writes_its_report_and_the_trained_policy(monkeypatch, capsys, tmp_path, item):
    """``launch.policy`` with the smoke settings shrunk to a few steps: the
    report on stdout with the reference's sections, the trained policy in
    the JAX package's JSON format at ``--policy-out``."""
    from repro_torch.launch import policy as cli

    monkeypatch.setattr(TrainSettings, "smoke", staticmethod(lambda: TINY))
    out = tmp_path / "trained.json"
    cli.main(["--device", "cpu", "--smoke", "--seeds", "3", "--arrivals", "60", "--policy-out", str(out)])
    captured = capsys.readouterr()
    payload = json.loads(captured.out)
    assert {"train", "stationary", "nonstationary", "throughput", "manifest"} <= set(payload)
    assert payload["stationary"]["all_exact"] and payload["train"]["settings"]["bp_steps"] == 3
    assert "wrote the trained policy" in captured.err
    trained = TrainedPolicy.from_json_dict(json.loads(out.read_text()))
    assert trained.meta["bp_steps"] == 3 and trained.history["final_hard"] == payload["train"]["final_hard_cost"]
    assert LearnedTimeoutPolicy(trained, item=item).idle_timeout_ms() >= 0.0
