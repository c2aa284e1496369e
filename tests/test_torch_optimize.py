"""The port's optimizer (``optim/adamw.py``, ``optim/schedules.py``,
``optimize/relax.py``, ``optimize/descent.py``, ``optimize/planner.py``,
``launch/optimize.py``, ``FleetBackend.plan_budgets``) against the JAX
package, on the CPU.

The relaxation, its gradients and the multi-start descent are held to the
reference fed the same initial parameters (the reference draws its starts
from ``jax.random``, the port from a ``torch.Generator``); every answer is
held to the exact oracle, as the reference's ``tests/test_optimize.py``
holds it.  The planner is host numpy in both packages and equal bit for
bit; its replay through the port's ``run_periodic`` is exact."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import energy_model as em
from repro_torch.core.batch_eval import DeviceArrays, SweepGrid, config_phase_grid, sweep_batch
from repro_torch.core.config_phase import (
    SPARTAN7_XC7S15,
    SPARTAN7_XC7S25,
    SPI_BUSWIDTHS,
    SPI_CLOCKS_MHZ,
    ConfigParams,
    optimal_params,
)
from repro_torch.core.phases import paper_lstm_item
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.fleet import DeviceSpec, FleetParams, run_periodic
from repro_torch.fleet.step import _np
from repro_torch.optim import adamw, constant, cosine_with_warmup
from repro_torch.optimize import (
    DescentSettings,
    optimize_config,
    optimize_lifetime,
    plan_budgets,
    relax,
    replay_allocation,
    trace_config_frontier,
)
from repro_torch.optimize import descent
from test_torch_x64_shim import x64_shim

OVERHEAD = em.CALIBRATED_POWERUP_OVERHEAD_MJ
FAST = DescentSettings(n_starts=6, steps=150)
CPU = "cpu"
LOSSES = ("config_energy", "config_scalarized", "adaptive_lifetime")


@pytest.fixture(scope="module")
def jref():
    """The JAX package's optimizer, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains.
    Submodules come by ``from`` imports: a JAX-package test file that failed
    to import on the same worker leaves them in ``sys.modules`` without
    their attribute on a re-imported parent package."""
    import jax

    with x64_shim():
        import jax.numpy as jnp
        from repro.core import config_phase as jcp
        from repro.fleet import state as jstate
        from repro.optim.adamw import adamw as jadamw
        from repro.optim import schedules as jsched
        from repro.optimize import descent as jdescent
        from repro.optimize import planner as jplanner
        from repro.optimize import relax as jrelax
        from repro.serving import fleet_backend as jbackend

    return dict(jax=jax, jnp=jnp, x64=jax.enable_x64, adamw=jadamw, sched=jsched,
                relax=jrelax, descent=jdescent, planner=jplanner, state=jstate,
                backend=jbackend, cp=jcp)


def _jdev(jref, dev):
    return {SPARTAN7_XC7S15.name: jref["cp"].SPARTAN7_XC7S15,
            SPARTAN7_XC7S25.name: jref["cp"].SPARTAN7_XC7S25}[dev.name]


PROBLEMS = {
    "xc7s15_40ms": (SPARTAN7_XC7S15, dict(request_period_ms=40.0, idle_power_mw=24.0,
                                          powerup_overhead_mj=OVERHEAD)),
    "xc7s25_600ms": (SPARTAN7_XC7S25, dict(request_period_ms=600.0, idle_power_mw=134.3,
                                           e_budget_mj=1.0e6)),
}


def _problems(jref, key):
    dev, kw = PROBLEMS[key]
    port = relax.RelaxedProblem.from_device(dev, torch_device=CPU, **kw)
    with jref["x64"]():
        ref = jref["relax"].RelaxedProblem.from_device(_jdev(jref, dev), **kw)
    return port, ref


def _start_params(seed, n_starts=5):
    rng = np.random.default_rng(seed)
    return {
        "f_raw": rng.uniform(1.0, 70.0, n_starts),
        "w_logits": rng.normal(0.0, 1.0, (n_starts, 3)),
        "c_logits": rng.normal(0.0, 1.0, (n_starts, 2)),
    }


def _torch(params, grad=False):
    return {k: torch.tensor(v, dtype=torch.float64, requires_grad=grad) for k, v in params.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300))) if a.size else 0.0


# ---------------------------------------------------------------------------
# AdamW's float64 update and the schedules
# ---------------------------------------------------------------------------
def _adamw_runs(jref, clip_norm, weight_decay, lr_wide: bool, steps=10):
    jax, jnp = jref["jax"], jref["jnp"]
    rng = np.random.default_rng(4)
    p0 = {"a": 1.0 + 1e-12 * np.arange(1, 6), "b": rng.normal(0.0, 3.0, (3, 4))}
    grads = [{k: rng.normal(0.0, 0.7, v.shape) for k, v in p0.items()} for _ in range(steps)]
    with jref["x64"]():
        opt = jref["adamw"](weight_decay=weight_decay, clip_norm=clip_norm,
                                  moment_dtype=jnp.float64)
        p = {k: jnp.asarray(v) for k, v in p0.items()}
        s = opt.init(p)
        lr = jnp.float64(0.02) if lr_wide else 0.02
        for g in grads:
            p, s, _ = opt.update({k: jnp.asarray(v) for k, v in g.items()}, s, p, lr)
        want = {k: np.asarray(v) for k, v in p.items()}
    opt = adamw(weight_decay=weight_decay, clip_norm=clip_norm, moment_dtype=torch.float64)
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    ts = opt.init(tp)
    lr = torch.tensor(0.02, dtype=torch.float64) if lr_wide else 0.02
    for g in grads:
        tp, ts, _ = opt.update({k: torch.tensor(v) for k, v in g.items()}, ts, tp, lr)
    return {k: v.numpy() for k, v in tp.items()}, want


@pytest.mark.parametrize("clip_norm", [None, 10.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_float64_lr_equals_the_reference_bit_for_bit(jref, clip_norm, weight_decay):
    """10 steps with a float64 ``lr`` against the reference's eager update;
    ``clip_norm`` 10 is the policy trainer's (the norm stays below it, so
    the clip's fp32 round trip runs with a scale of exactly 1)."""
    got, want = _adamw_runs(jref, clip_norm, weight_decay, lr_wide=True)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("clip_norm", [None, 10.0])
def test_adamw_python_float_lr_keeps_the_fp32_update(jref, clip_norm):
    got, want = _adamw_runs(jref, clip_norm, 0.1, lr_wide=False)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_adamw_with_the_clip_engaged_is_within_an_fp32_ulp_of_the_reference(jref):
    """With the clip engaged (norm ≈ 3 > 1) the scale depends on the global
    norm's last fp32 bit: XLA sums a small fp32 array left to right, torch
    in another order, and the two norms differ by an ulp on some steps; the
    parameter, rounded to fp32 before every update, then lands one fp32 ulp
    away at most (ROADMAP C-ref-9)."""
    got, want = _adamw_runs(jref, 1.0, 0.1, lr_wide=True)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2.0 ** -23, atol=0.0, err_msg=k)


def test_adamw_float64_lr_subtracts_in_float64():
    """p = 1 + 1e-12, one step at lr 0.02: a float64 ``lr`` subtracts in
    float64 (the reference under x64), a Python float in fp32."""
    opt = adamw(weight_decay=0.0, clip_norm=None, moment_dtype=torch.float64)
    outs = []
    for lr in (torch.tensor(0.02, dtype=torch.float64), 0.02):
        p = {"p": torch.tensor([1.0 + 1e-12], dtype=torch.float64)}
        s = opt.init(p)
        opt.update({"p": torch.tensor([0.5], dtype=torch.float64)}, s, p, lr)
        outs.append(float(p["p"]))
    assert outs[0] == pytest.approx(0.98, abs=1e-8)       # Adam's first step is ≈ 1
    assert outs[1] == float(np.float32(outs[1]))          # fp32 subtraction
    assert outs[0] != float(np.float32(outs[0]))          # float64 subtraction


@pytest.mark.parametrize("step", [0, 3, 10, 55, 100, 250])
def test_schedules_equal_the_reference(jref, step):
    want = float(jref["sched"].cosine_with_warmup(step, 3e-3, 10, 200, 0.1))
    assert float(cosine_with_warmup(step, 3e-3, 10, 200, 0.1)) == pytest.approx(want, rel=1e-6)
    assert cosine_with_warmup(step, 3e-3, 10, 200).dtype == torch.float32
    assert float(constant(step, 3e-3)) == float(jref["sched"].constant(step, 3e-3))


# ---------------------------------------------------------------------------
# The relaxation: values and gradients against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", sorted(PROBLEMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_and_relaxed_counts_equal_the_reference(jref, key, seed):
    port, ref = _problems(jref, key)
    params = _start_params(seed)
    jnp = jref["jnp"]
    with jref["x64"]():
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        want_dec = [np.asarray(x) for x in jref["relax"].decode(jp, ref)]
        want = {k: np.asarray(v) for k, v in jref["relax"].relaxed_counts(ref, *jref["relax"].decode(jp, ref)).items()}
    got_dec = relax.decode(_torch(params), port)
    for g, w in zip(got_dec, want_dec):
        assert _rel(g.numpy(), w) <= 1e-12
    got = relax.relaxed_counts(port, *got_dec)
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k].numpy(), want[k]) <= 1e-12, k


@pytest.mark.parametrize("key", sorted(PROBLEMS))
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_cores_and_their_gradients_equal_the_reference(jref, key, loss, seed):
    """Each core on five starts at once; the gradient of the summed losses
    is every start's own gradient (no operation mixes starts)."""
    port, ref = _problems(jref, key)
    params = _start_params(seed)
    jax, jnp = jref["jax"], jref["jnp"]
    with jref["x64"]():
        core = jref["relax"].LOSS_CORES[loss]
        lv, n_w = jref["relax"].leaves(ref), len(ref.buswidths)
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        fn = lambda p: core(p, lv, n_w, jnp.float64(0.3))  # noqa: E731
        want = np.asarray(jax.vmap(fn)(jp))
        wgrad = jax.vmap(jax.grad(fn))(jp)
        wgrad = {k: np.asarray(v) for k, v in wgrad.items()}
    tp = _torch(params, grad=True)
    lam = torch.tensor(0.3, dtype=torch.float64)
    got = relax.LOSS_CORES[loss](tp, relax.leaves(port), len(port.buswidths), lam)
    got.sum().backward()
    assert got.shape == (5,)
    assert _rel(got.detach().numpy(), want) <= 1e-12
    for k in params:
        g, w = tp[k].grad.numpy(), wgrad[k]
        scale = max(float(np.max(np.abs(w))), 1e-300)
        assert float(np.max(np.abs(g - w))) / scale <= 1e-9, k


def test_public_losses_equal_their_cores():
    port = relax.RelaxedProblem.from_device(SPARTAN7_XC7S15, torch_device=CPU)
    p = _torch(_start_params(3))
    lv, n_w = relax.leaves(port), len(port.buswidths)
    assert torch.equal(relax.config_energy_loss(p, port), relax.config_energy_core(p, lv, n_w, 0.0))
    assert torch.equal(relax.lifetime_loss(p, port), relax.lifetime_core(p, lv, n_w, 0.0))
    lam = torch.tensor(0.25, dtype=torch.float64)
    assert torch.equal(relax.config_scalarized_loss(p, port, 0.25),
                       relax.config_scalarized_core(p, lv, n_w, lam))


@pytest.mark.parametrize("loss_name", ["config_energy_loss", "lifetime_loss"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grad_matches_central_differences(loss_name, seed):
    """The reference test's own check, on the port's autograd."""
    problem = relax.RelaxedProblem.from_device(
        SPARTAN7_XC7S15, request_period_ms=40.0, idle_power_mw=24.0,
        powerup_overhead_mj=OVERHEAD, torch_device=CPU)
    loss = getattr(relax, loss_name)
    rng = np.random.default_rng(seed)
    params = {"f_raw": np.float64(rng.uniform(5.0, 60.0)), "w_logits": rng.normal(0, 1, 3),
              "c_logits": rng.normal(0, 1, 2)}
    tp = _torch(params, grad=True)
    loss(tp, problem).backward()
    h = 1e-4
    for k, v in params.items():
        for idx in np.ndindex(np.shape(v) or (1,)):
            def perturbed(delta):
                arr = np.array(v, dtype=np.float64)
                if arr.ndim:
                    arr[idx] += delta
                else:
                    arr = arr + delta
                return float(loss(_torch({**params, k: arr}), problem))

            fd = (perturbed(h) - perturbed(-h)) / (2 * h)
            an = float(tp[k].grad.numpy()[idx] if np.ndim(v) else tp[k].grad)
            assert an == pytest.approx(fd, rel=1e-4, abs=1e-7 * max(1.0, abs(fd)))


def test_kernel_accepts_scalar_booleans():
    from repro_torch.core.batch_eval import config_phase_kernel

    cols = DeviceArrays.from_devices([SPARTAN7_XC7S15], CPU).reshape(()).cols()
    out = config_phase_kernel(cols, 4, 66.0, True)
    assert float(out["config_energy_mj"]) == SPARTAN7_XC7S15.config_energy_mj(ConfigParams(4, 66, True))


@pytest.mark.parametrize("w_i,f,c", [(0, 3.0, False), (2, 66.0, True), (1, 22.0, True)])
def test_one_hot_corner_is_the_exact_oracle(jref, w_i, f, c):
    """At a one-hot choice the expectation collapses to the exact oracle
    value of that grid point — the same float — in both packages."""
    port, ref = _problems(jref, "xc7s15_40ms")
    w_probs = torch.zeros(3, dtype=torch.float64)
    w_probs[w_i] = 1.0
    e, t = relax.relaxed_config(port, torch.tensor(f, dtype=torch.float64), w_probs,
                                torch.tensor(1.0 if c else 0.0, dtype=torch.float64))
    g = config_phase_grid(SPARTAN7_XC7S15, (SPI_BUSWIDTHS[w_i],), (f,), (c,), device=CPU)
    assert float(e) == float(g["config_energy_mj"].reshape(()))
    assert float(t) == float(g["config_time_ms"].reshape(()))
    jnp = jref["jnp"]
    with jref["x64"]():
        je, jt = jref["relax"].relaxed_config(
            ref, jnp.float64(f), jnp.zeros(3, jnp.float64).at[w_i].set(1.0),
            jnp.float64(1.0 if c else 0.0))
    assert float(e) == float(je) and float(t) == float(jt)


def test_straight_through_operators_behave_as_the_reference(jref):
    grid = torch.tensor([3.0, 6.0, 9.0], dtype=torch.float64)
    x = torch.tensor(7.2, dtype=torch.float64, requires_grad=True)
    y = relax.straight_through_round(x, grid)
    assert float(y.detach()) == 6.0
    (y ** 2).backward()
    assert float(x.grad) == pytest.approx(2 * 6.0)

    logits = torch.tensor([0.1, 2.0, -1.0], dtype=torch.float64, requires_grad=True)
    oh = relax.straight_through_onehot(logits)
    assert oh.tolist() == [0.0, 1.0, 0.0]
    (oh * logits).sum().backward()
    jax, jnp = jref["jax"], jref["jnp"]
    with jref["x64"]():
        jl = jnp.asarray([0.1, 2.0, -1.0], jnp.float64)
        jg = jax.grad(lambda v: jnp.sum(jref["relax"].straight_through_onehot(v) * v))(jl)
        jx = jax.grad(lambda v: jref["relax"].straight_through_round(v, jnp.asarray([3.0, 6.0, 9.0])) ** 2)(
            jnp.float64(7.2))
    np.testing.assert_allclose(logits.grad.numpy(), np.asarray(jg), rtol=1e-12, atol=1e-15)
    assert float(x.grad) == float(jx)


def test_snap_and_nearest_clock_index():
    port = relax.RelaxedProblem.from_device(SPARTAN7_XC7S15, torch_device=CPU)
    p = {"f_raw": torch.tensor([2.0, 7.4, 7.6, 80.0], dtype=torch.float64),
         "w_logits": torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0, 0, 1.0]],
                                  dtype=torch.float64),
         "c_logits": torch.tensor([[1.0, 0], [0, 1.0], [0, 1.0], [1.0, 0]], dtype=torch.float64)}
    s = relax.snap(p, port)
    assert s["clock_mhz"].tolist() == [3.0, 6.0, 9.0, 66.0]
    assert s["buswidth"].tolist() == [1, 2, 4, 4]
    assert s["compression"].tolist() == [False, True, True, False]


def test_soft_pareto_weight_grad_and_limit():
    from repro_torch.core.pareto import pareto_mask, soft_pareto_weight

    costs = np.random.default_rng(3).random((40, 2))
    c = torch.tensor(costs, requires_grad=True)
    soft_pareto_weight(c, 0.1).sum().backward()
    assert torch.isfinite(c.grad).all()
    w = soft_pareto_weight(torch.tensor(costs), 1e-5).numpy()
    assert np.array_equal(w > 0.5, pareto_mask(costs, device=CPU).numpy())


# ---------------------------------------------------------------------------
# Descent: the same starts give the reference's chains
# ---------------------------------------------------------------------------
def _jax_chain(jref, ref, loss, params, steps, jit, lam=0.3, lr=0.5):
    """The reference's multi-start loop (``descent._make_run``) from
    ``params``: compiled, as the reference runs it, or op by op under
    ``jax.disable_jit`` (every op rounded as IEEE float arithmetic)."""
    jax, jnp = jref["jax"], jref["jnp"]
    with jref["x64"](), (jax.disable_jit(not jit)):
        jp = {k: jnp.asarray(v) for k, v in params.items()}
        state = jax.vmap(jref["descent"]._OPT.init)(jp)
        run = jref["descent"]._make_run(jref["relax"].LOSS_CORES[loss], len(ref.buswidths), steps)
        (p, _), curve = (jax.jit(run) if jit else run)(
            jp, state, jref["relax"].leaves(ref), jnp.float64(lr), jnp.float64(lam))
        return {k: np.asarray(v) for k, v in p.items()}, np.asarray(curve)


@pytest.mark.parametrize("loss", LOSSES)
def test_first_step_and_twenty_steps_follow_the_reference(jref, loss):
    """From the same six starts: the first step's losses (and, through the
    loss-core test above, its gradients) within 1e-9; the parameters after
    5 steps within 1e-9 of the reference run op by op, and after 20 steps
    within 1e-6 of the compiled one, whose fused fp32 Adam arithmetic
    departs from IEEE rounding by up to ~5e-8 a step (ROADMAP C-ref-9)."""
    port, ref = _problems(jref, "xc7s15_40ms")
    params = _start_params(7, n_starts=6)
    lv, n_w = relax.leaves(port), len(port.buswidths)
    lam = torch.tensor(0.3, dtype=torch.float64)
    fn = lambda p: relax.LOSS_CORES[loss](p, lv, n_w, lam)  # noqa: E731
    p1, c1 = descent._run(fn, _torch(params), 0.5, 1)
    for jit in (False, True):
        w1, wc1 = _jax_chain(jref, ref, loss, params, 1, jit)
        assert _rel(c1, wc1) <= 1e-9
    for steps, jit, tol in ((5, False, 1e-9), (20, True, 1e-6)):
        got, curve = descent._run(fn, _torch(params), 0.5, steps)
        want, wcurve = _jax_chain(jref, ref, loss, params, steps, jit)
        assert _rel(curve, wcurve) <= tol, jit
        for k in params:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=tol, atol=tol * 1e-3,
                                       err_msg=f"{k} jit={jit}")


def test_descend_runs_a_custom_loss_from_given_starts():
    port = relax.RelaxedProblem.from_device(SPARTAN7_XC7S15, torch_device=CPU)
    params = _start_params(5, n_starts=4)
    p, curve = descent.descend(lambda q: (q["f_raw"] - 30.0) ** 2, port,
                               DescentSettings(n_starts=4, steps=200), init_params=params)
    assert curve.shape == (200,) and curve[-1] < curve[0]
    np.testing.assert_allclose(p["f_raw"].numpy(), 30.0, atol=0.5)
    # no gradient there: the update only rounds them to fp32, as the reference's does
    np.testing.assert_array_equal(p["w_logits"].numpy(),
                                  params["w_logits"].astype(np.float32).astype(np.float64))


@pytest.mark.parametrize("device", [SPARTAN7_XC7S15, SPARTAN7_XC7S25])
def test_optimize_config_equals_the_reference_and_the_oracle(jref, device):
    params = _start_params(11, n_starts=FAST.n_starts)
    res = optimize_config(device, settings=FAST, torch_device=CPU, init_params=params)
    oracle = optimal_params(device)
    assert (res.best["buswidth"], res.best["clock_mhz"], res.best["compression"]) == (
        oracle.params.buswidth, oracle.params.clock_mhz, oracle.params.compression)
    assert res.best["config_energy_mj"] == oracle.config_energy_mj
    with jref["x64"]():
        want = jref["descent"].optimize_config(_jdev(jref, device), settings=jref["descent"].DescentSettings(
            n_starts=FAST.n_starts, steps=FAST.steps))
    assert res.best == want.best


def test_optimize_lifetime_equals_the_reference_and_the_sweep(jref):
    grid = SweepGrid(devices=(SPARTAN7_XC7S15,), request_periods_ms=(40.0,),
                     idle_methods=(IdlePowerMethod.METHOD1_2,), powerup_overhead_mj=OVERHEAD)
    lt = sweep_batch(grid, device=CPU)["adaptive_lifetime_ms"].numpy()
    ix = np.unravel_index(np.argmax(lt), lt.shape)
    res = optimize_lifetime(SPARTAN7_XC7S15, powerup_overhead_mj=OVERHEAD, settings=FAST,
                            torch_device=CPU)
    assert res.best == {"buswidth": grid.buswidths[ix[1]], "clock_mhz": float(grid.clocks_mhz[ix[2]]),
                        "compression": bool(grid.compression[ix[3]]), "lifetime_ms": float(lt[ix])}
    with jref["x64"]():
        want = jref["descent"].optimize_lifetime(
            _jdev(jref, SPARTAN7_XC7S15), powerup_overhead_mj=OVERHEAD,
            settings=jref["descent"].DescentSettings(n_starts=FAST.n_starts, steps=FAST.steps))
    assert res.best == want.best
    assert res.to_json_dict()["grid_points_considered"] == len(res.candidates)


def test_densified_axis_is_still_exact_at_10001_clocks():
    clocks = tuple(np.linspace(min(SPI_CLOCKS_MHZ), max(SPI_CLOCKS_MHZ), 10_001))
    e = config_phase_grid(SPARTAN7_XC7S15, clocks_mhz=clocks, device=CPU)["config_energy_mj"].numpy()
    ix = np.unravel_index(np.argmin(e), e.shape)
    res = optimize_config(SPARTAN7_XC7S15, clocks_mhz=clocks, settings=FAST, torch_device=CPU)
    assert res.best["clock_mhz"] == float(clocks[ix[2]])
    assert res.best["config_energy_mj"] == float(e[ix])


@pytest.mark.parametrize("device", [SPARTAN7_XC7S15, SPARTAN7_XC7S25])
def test_frontier_trace_covers_the_exact_frontier(device):
    from repro_torch.core.pareto import config_pareto

    traced = trace_config_frontier(device, lambdas=(0.1, 0.5, 0.9),
                                   settings=DescentSettings(n_starts=3, steps=120), torch_device=CPU)
    exact = {(r["buswidth"], r["clock_mhz"], r["compression"]) for r in config_pareto(device, device=CPU)}
    got = {(r["buswidth"], r["clock_mhz"], r["compression"]) for r in traced["points"]}
    assert exact <= got
    assert all(0.0 <= r["soft_weight"] <= 1.0 for r in traced["points"])


def test_descent_settings_validate():
    for bad in (dict(n_starts=0), dict(steps=0), dict(lr=0.0)):
        with pytest.raises(ValueError):
            DescentSettings(**bad)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_config(SPARTAN7_XC7S15, settings=FAST)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        optimize_lifetime(SPARTAN7_XC7S15, settings=FAST)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trace_config_frontier(SPARTAN7_XC7S15, lambdas=(0.5,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        relax.RelaxedProblem.from_device(SPARTAN7_XC7S15)


# ---------------------------------------------------------------------------
# The fleet budget planner
# ---------------------------------------------------------------------------
TEMPLATE = [
    ("idle_waiting", 40.0, IdlePowerMethod.METHOD1_2),
    ("on_off", 80.0, IdlePowerMethod.BASELINE),
    ("adaptive", 120.0, IdlePowerMethod.METHOD1),
    ("idle_waiting", 200.0, IdlePowerMethod.BASELINE),
]


def _fleets(jref, n=12, template=TEMPLATE, overhead=OVERHEAD):
    from repro.core.phases import paper_lstm_item as jitem
    from repro.core.strategies import IdlePowerMethod as JM

    specs = [DeviceSpec(item=paper_lstm_item(), strategy=s, method=m, request_period_ms=p,
                        powerup_overhead_mj=overhead) for s, p, m in template]
    jspecs = [jref["state"].DeviceSpec(item=jitem(), strategy=s, method=JM(m.value), request_period_ms=p,
                                       powerup_overhead_mj=overhead) for s, p, m in template]
    with jref["x64"]():
        jparams = jref["state"].FleetParams.from_specs([jspecs[i % len(jspecs)] for i in range(n)])
    return FleetParams.from_specs([specs[i % len(specs)] for i in range(n)], CPU), jparams


def _same_allocation(a, b):
    assert a.objective == b.objective and a.fleet_budget_mj == b.fleet_budget_mj
    for f in ("n_items", "budgets_mj", "predicted_lifetime_ms", "n_cap"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.leftover_mj == b.leftover_mj
    assert json.dumps(a.to_json_dict()) == json.dumps(b.to_json_dict())


@pytest.mark.parametrize("objective", ["min_lifetime", "total_requests"])
@pytest.mark.parametrize("budget_div,cap", [(40.0, 300_000), (400.0, 10**7), (4.0, 1000)])
def test_plan_equals_the_reference_bit_for_bit_and_replays_exactly(jref, objective, budget_div, cap):
    params, jparams = _fleets(jref)
    budget = 12 * em.PAPER_ENERGY_BUDGET_MJ / budget_div
    alloc = plan_budgets(params, budget, n_cap=cap, objective=objective)
    with jref["x64"]():
        want = jref["planner"].plan_budgets(jparams, budget, n_cap=cap, objective=objective)
    _same_allocation(alloc, want)
    # conservation holds by construction, nothing over-spent, caps respected
    assert float(alloc.budgets_mj.sum()) + alloc.leftover_mj == budget
    assert alloc.leftover_mj >= 0.0
    assert (alloc.n_items <= alloc.n_cap).all()
    rep = replay_allocation(params, alloc)
    assert rep["exact"] and rep["n_items_match"]
    assert rep["lifetime_max_rel_err"] == 0.0 and rep["energy_max_rel_err"] == 0.0
    r = rep["result"]
    np.testing.assert_array_equal(_np(r.n_items), alloc.n_items)
    np.testing.assert_array_equal(_np(r.lifetime_ms), alloc.predicted_lifetime_ms)
    np.testing.assert_array_equal(_np(r.energy_mj), alloc.budgets_mj)


def test_total_requests_dominates_min_lifetime(jref):
    params, _ = _fleets(jref)
    budget = 12 * em.PAPER_ENERGY_BUDGET_MJ / 40.0
    a = plan_budgets(params, budget, 300_000, objective="total_requests")
    b = plan_budgets(params, budget, 300_000, objective="min_lifetime")
    assert a.total_requests >= b.total_requests
    assert b.min_lifetime_ms >= a.min_lifetime_ms


def test_min_lifetime_waterfills(jref):
    params, _ = _fleets(jref)
    alloc = plan_budgets(params, 12 * em.PAPER_ENERGY_BUDGET_MJ / 40.0, 10**7, objective="min_lifetime")
    spread = alloc.predicted_lifetime_ms.max() - alloc.predicted_lifetime_ms.min()
    assert spread <= float(params.period_ms.max())


def test_zero_budget_infeasible_devices_and_per_device_caps(jref):
    item = paper_lstm_item()
    params = FleetParams.from_specs([
        DeviceSpec(item=item, strategy="on_off", request_period_ms=1.0),      # infeasible
        DeviceSpec(item=item, strategy="idle_waiting", request_period_ms=40.0),
    ], CPU)
    zero = plan_budgets(params, 0.0, 100)
    assert zero.total_requests == 0 and replay_allocation(params, zero)["exact"]
    alloc = plan_budgets(params, 1e5, 1000, objective="total_requests")
    assert alloc.n_items.tolist() == [0, 1000]
    assert replay_allocation(params, alloc)["exact"]
    four, jfour = _fleets(jref, 4)
    caps = np.asarray([1, 2, 3, 4], dtype=np.int64)
    alloc = plan_budgets(four, 1e6, caps, objective="total_requests")
    assert (alloc.n_items == caps).all() and replay_allocation(four, alloc)["exact"]
    with jref["x64"]():
        _same_allocation(alloc, jref["planner"].plan_budgets(jfour, 1e6, caps, objective="total_requests"))


def test_planner_rejects_bad_inputs(jref):
    params, _ = _fleets(jref, 4)
    with pytest.raises(ValueError, match="objective"):
        plan_budgets(params, 1.0, 10, objective="nope")
    with pytest.raises(ValueError, match="non-negative"):
        plan_budgets(params, -1.0, 10)
    with pytest.raises(ValueError, match="n_cap"):
        plan_budgets(params, 1.0, -3)
    with pytest.raises(ValueError, match="shape"):
        params.with_budgets(np.ones(3))


def test_spec_with_budget_matches_column_replacement():
    item = paper_lstm_item()
    specs = [DeviceSpec(item=item, strategy=s, request_period_ms=p, powerup_overhead_mj=OVERHEAD)
             for s, p in [("idle_waiting", 40.0), ("on_off", 80.0)]]
    params = FleetParams.from_specs(specs, CPU)
    alloc = plan_budgets(params, 1e4, 10_000, objective="total_requests")
    rebuilt = FleetParams.from_specs([s.with_budget(b) for s, b in zip(specs, alloc.budgets_mj)], CPU)
    replaced = params.with_budgets(alloc.budgets_mj)
    for field in ("e_budget_mj", "e_item_mj", "e_init_mj", "e_idle_mj"):
        assert torch.equal(getattr(rebuilt, field), getattr(replaced, field))


def test_periodic_replay_matches_the_scalar_oracle_budget():
    item = paper_lstm_item()
    spec = DeviceSpec(item=item, strategy="idle_waiting", method=IdlePowerMethod.METHOD1_2,
                      request_period_ms=40.0, powerup_overhead_mj=OVERHEAD)
    params = FleetParams.from_specs([spec], CPU)
    alloc = plan_budgets(params, 50_000.0, 10**6, objective="total_requests")
    n_scalar = em.idlewait_n_max(item, 40.0, float(alloc.budgets_mj[0]), idle_power_mw=24.0,
                                 powerup_overhead_mj=OVERHEAD)
    assert int(alloc.n_items[0]) == n_scalar
    assert int(run_periodic(params.with_budgets(alloc.budgets_mj), n_scalar + 1).n_items[0]) == n_scalar


TENANTS = [
    ("a", 300.0, 0.04, 180.0, 0.03, 24.0, "auto", 3, 500.0),
    ("b", 300.0, 0.04, 160.0, 0.02, 34.2, "idle_waiting", 2, 200.0),
    ("c", 300.0, 0.04, 200.0, 0.05, 134.3, "on_off", 2, 2000.0),
]


@pytest.mark.parametrize("objective", ["min_lifetime", "total_requests"])
def test_fleet_backend_plan_budgets_equals_the_reference(jref, objective):
    from repro_torch.serving.fleet_backend import FleetBackend, FleetTenantSpec

    def specs(cls):
        return [cls(n, cm, cs, im, is_, idle, policy=pol, replicas=r, mean_period_ms=per)
                for n, cm, cs, im, is_, idle, pol, r, per in TENANTS]

    be = FleetBackend(specs(FleetTenantSpec), device=CPU)
    alloc, per_tenant = be.plan_budgets(2e5, horizon_ms=3_600_000.0, objective=objective)
    with jref["x64"]():
        jbe = jref["backend"].FleetBackend(specs(jref["backend"].FleetTenantSpec))
        jalloc, jper = jbe.plan_budgets(2e5, horizon_ms=3_600_000.0, objective=objective)
    _same_allocation(alloc, jalloc)
    assert per_tenant == jper
    assert sum(t["planned_requests"] for t in per_tenant.values()) == alloc.total_requests
    assert replay_allocation(be.params, alloc)["exact"]
    planned = be.with_allocation(alloc)
    np.testing.assert_array_equal(planned.params.e_budget_mj.numpy(), alloc.budgets_mj)
    assert torch.equal(planned.params.e_item_mj, be.params.e_item_mj)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------
def test_optimize_cli_smoke_on_the_cpu(jref, capsys):
    """``launch.optimize --smoke`` on the CPU (its frontier section is
    covered above): every section's self-check holds, the JSON goes to
    stdout, and the planner section equals the JAX package's planner on the
    same fleet bit for bit."""
    from repro_torch.launch import optimize as cli

    assert cli.main(["--device", "cpu", "--smoke", "--section", "config,densify,planner"]) == 0
    out = capsys.readouterr()
    payload = json.loads(out.out)
    assert "planner[min_lifetime]" in out.err
    assert payload["config"]["exact_match"]
    assert all(r["agree"] for r in payload["densify"]["rows"])
    assert payload["config"]["descent_argmin"]["config_energy_mj"] == optimal_params(SPARTAN7_XC7S15).config_energy_mj
    template = [("idle_waiting", 40.0, IdlePowerMethod.METHOD1_2), ("on_off", 80.0, IdlePowerMethod.BASELINE),
                ("adaptive", 120.0, IdlePowerMethod.METHOD1), ("idle_waiting", 200.0, IdlePowerMethod.BASELINE),
                ("adaptive", 500.0, IdlePowerMethod.METHOD1_2)]
    _, jparams = _fleets(jref, 16, template, overhead=OVERHEAD)
    pl = payload["planner"]
    for obj, s in pl["objectives"].items():
        assert s["replay"]["exact"]
        with jref["x64"]():
            caps = np.maximum(np.floor(3_600_000.0 / np.asarray(jparams.period_ms)), 0.0).astype(np.int64)
            want = jref["planner"].plan_budgets(jparams, pl["fleet_budget_mj"], caps, objective=obj)
        jd = want.to_json_dict(limit=8)
        assert {k: s[k] for k in jd} == jd
