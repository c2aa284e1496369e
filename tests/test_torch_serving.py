"""The ported serving path vs the JAX package: a small config that still
reaches dequant (its embedding and MLP matrices pass the quantization
floor), weights carried by ``params_from_numpy``; the duty-cycle
controller and scheduler under one fake clock; and the CLI's demo."""
import dataclasses
import gc
import math
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serializer import flatten
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.dequant import ops as dq
from repro_torch.launch.serve import build_demo
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine, bring_up_from_checkpoint
from repro_torch.serving.scheduler import compare_live_strategies, run_schedule
from test_torch_x64_shim import x64_shim

SMALL = dict(
    name="qwen3-small", family="dense", num_layers=2, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024, qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)


@pytest.fixture(scope="session")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` (imported by ``repro.core.arrivals``)
    is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.checkpoint
        import repro.core.duty_cycle
        import repro.launch.serve  # noqa: F401
        import repro.serving.engine
        import repro.serving.scheduler
        from repro.configs import base, perf
        from repro.models import model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dict(
        base=base, perf=perf, zoo=model_zoo, engine=repro.serving.engine,
        ckpt=repro.checkpoint, ckpt_ser=repro.checkpoint.serializer,
        duty=repro.core.duty_cycle, sched=repro.serving.scheduler,
    )


def _configs(jref, **over):
    return jref["base"].ArchConfig(**{**SMALL, **over}), ArchConfig(**{**SMALL, **over})


def _tokens(cfg, b=2, s=16, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _jax_params(jref, jcfg, dtype):
    return jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(0), dtype))


# ---------------------------------------------------------------------------
# model parity
# ---------------------------------------------------------------------------
def test_param_tree_maps_one_to_one(jref):
    jcfg, cfg = _configs(jref)
    jshapes = jref["zoo"].param_shapes(jcfg)
    ours = zoo.param_shapes(cfg)
    jflat = {jax.tree_util.keystr(p): s.shape for p, s in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    oflat = {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
             jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert jflat == oflat
    assert all(t.device.type == "meta" for t in jax.tree.leaves(ours))


def test_fp32_prefill_and_greedy_tokens_match(jref):
    jcfg, cfg = _configs(jref)
    jparams = _jax_params(jref, jcfg, jnp.float32)
    params = zoo.params_from_numpy(jparams, device="cpu")
    toks = _tokens(cfg)
    jperf = jref["perf"].PerfConfig(attention_impl="pallas_interpret")
    jlogits, _ = jref["zoo"].prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 48, jperf)
    logits, _ = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)

    jtok = jref["engine"].ServingEngine(jcfg, jparams, 48, jperf).generate(
        {"tokens": jnp.asarray(toks)}, n_new=8).tokens
    tok = ServingEngine(cfg, params, 48).generate({"tokens": torch.from_numpy(toks)}, n_new=8).tokens
    assert tok.dtype == torch.int32 and tok.shape == (2, 8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize(
    "window,prompt,max_len,steps",
    [(0, 12, 16, 6),      # decode runs past the cache: the last slot is reused
     (8, 12, 24, 5)],     # sliding window: ring-buffer cache
)
def test_fp32_decode_steps_match_cache_slot_rules(jref, window, prompt, max_len, steps):
    jcfg, cfg = _configs(jref, sliding_window=window)
    jparams = _jax_params(jref, jcfg, jnp.float32)
    params = zoo.params_from_numpy(jparams, device="cpu")
    toks = _tokens(cfg, s=prompt, seed=1)
    jlogits, jstate = jref["zoo"].prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, max_len)
    logits, state = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, max_len)
    for _ in range(steps):
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
        jlogits, jstate = jref["zoo"].decode_fn(jparams, jstate, jnp.asarray(tok), jcfg)
        logits, state = zoo.decode_fn(params, state, torch.from_numpy(tok), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


def test_bf16_bring_up_through_jax_written_checkpoint(jref, tmp_path, monkeypatch):
    monkeypatch.setattr(jref["ckpt_ser"], "HAVE_ZSTD", False)   # the zlib codec
    jcfg, cfg = _configs(jref)
    jparams = jref["zoo"].init_params(jcfg, jax.random.PRNGKey(0))
    jm = jref["ckpt"].CheckpointManager(str(tmp_path), mode="zstd+int8")
    jm.save(0, jparams)
    toks = _tokens(cfg, seed=2)
    jeng = jref["engine"].bring_up_from_checkpoint(jcfg, jm, 48)
    jlogits, _ = jref["zoo"].prefill_fn(jeng.params, {"tokens": jnp.asarray(toks)}, jcfg, 48)

    before = dq.launches
    eng = bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path)), 48, device="cpu")
    assert dq.launches == before                  # CPU: the plain dequant
    assert eng.params["embed"].dtype == torch.bfloat16
    logits, _ = zoo.prefill_fn(eng.params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits, np.float32), atol=5e-2, rtol=0)
    # the restored weights themselves are bit-equal
    for (p, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jeng.params)[0],
                              jax.tree_util.tree_flatten_with_path(eng.params)[0]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16), b.view(torch.int16).numpy())


def test_engine_release_drops_weights(jref, tmp_path):
    _, cfg = _configs(jref)
    m = CheckpointManager(str(tmp_path), mode="zstd+int8")
    m.save(0, zoo.init_params(cfg, torch.Generator().manual_seed(0)))
    eng = bring_up_from_checkpoint(cfg, m, 48, device="cpu",
                                   warmup_batch={"tokens": torch.from_numpy(_tokens(cfg))})
    assert eng.resident and eng.param_bytes() > 0
    r = eng.generate({"tokens": torch.from_numpy(_tokens(cfg))}, n_new=3,
                     greedy=False, generator=torch.Generator().manual_seed(7))
    assert r.tokens.shape == (2, 3) and r.prefill_s > 0 and r.decode_s > 0
    eng.release()
    assert not eng.resident and eng.param_bytes() == 0
    with pytest.raises(RuntimeError, match="released"):
        eng.generate({"tokens": torch.from_numpy(_tokens(cfg))}, n_new=1)
    with pytest.raises(FileNotFoundError):
        bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path / "empty")), 8, device="cpu")


def test_release_frees_weights_without_waiting_for_gc(jref, tmp_path):
    """On-Off's power-off must free the weights at once (as ``delete()``
    does in the reference): no reference cycle may keep them alive."""
    _, cfg = _configs(jref)
    m = CheckpointManager(str(tmp_path), mode="zstd+int8")
    m.save(0, zoo.init_params(cfg, torch.Generator().manual_seed(0)))
    gc.disable()
    try:
        eng = bring_up_from_checkpoint(cfg, m, 48, device="cpu")
        refs = [weakref.ref(t) for _, t in flatten(eng.params)]
        eng.release()
        assert all(r() is None for r in refs)
    finally:
        gc.enable()


def test_bring_up_defaults_to_cuda(jref, tmp_path, monkeypatch):
    _, cfg = _configs(jref)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path)), 8)


@pytest.mark.parametrize("reduced", [True, False])
def test_every_config_matches_jax_field_and_tree(jref, reduced):
    """Every architecture of the reference, full and reduced: the port's
    config equal field for field, the same parameter count, and the same
    parameter tree (every leaf's path and shape): hybrid periods, MoE
    stacks, GELU FFNs and the frontends' projections included."""
    from repro_torch.configs import get_config, list_archs

    assert list_archs() == jref["base"].list_archs()
    for name in list_archs():
        jcfg, cfg = jref["base"].get_config(name, reduced), get_config(name, reduced)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert cfg.param_count() == jcfg.param_count()
        jflat = {jax.tree_util.keystr(p): s.shape for p, s in
                 jax.tree_util.tree_flatten_with_path(jref["zoo"].param_shapes(jcfg))[0]}
        oflat = {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
                 jax.tree_util.tree_flatten_with_path(zoo.param_shapes(cfg))[0]}
        assert oflat == jflat, name


def test_generate_attends_through_the_kernel_wrapper_once_per_layer(monkeypatch):
    """Prefill has no other route to attention than the kernel's wrapper
    (one call per layer); decode stays on the plain version."""
    from repro_torch.kernels.flash_attention import ops as fa

    cfg = ArchConfig(**SMALL)
    calls = []
    wrapper = fa.attention

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return wrapper(*args, **kw)

    monkeypatch.setattr(fa, "attention", counting)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    out = ServingEngine(cfg, params, 48).generate({"tokens": torch.from_numpy(_tokens(cfg))}, n_new=3)
    assert out.tokens.shape == (2, 3)
    assert calls == [(2, 16, cfg.num_heads, cfg.head_dim)] * cfg.num_layers


# ---------------------------------------------------------------------------
# controller + scheduler parity under one fake clock
# ---------------------------------------------------------------------------
class FakeTime:
    def __init__(self, bring_up_s=0.3, infer_s=0.05):
        self.t = 0.0
        self.bring_up_s, self.infer_s = bring_up_s, infer_s

    def clock(self):
        return self.t

    def sleep(self, dt):
        self.t += max(dt, 0.0)

    def bring_up(self):
        self.t += self.bring_up_s
        return object()

    def infer(self, handle, x):
        self.t += self.infer_s
        return x

    def release(self, handle):
        pass


def _run(module_duty, module_sched, strategy, period_s, n):
    ft = FakeTime()
    power = module_duty.PowerModel(config_mw=90_000.0, infer_mw=200_000.0, idle_mw=65_000.0)
    ctl = module_duty.DutyCycleController(
        ft.bring_up, ft.infer, ft.release, power, strategy, clock=ft.clock)
    res = module_sched.run_schedule(ctl, range(n), period_s, sleep=ft.sleep, clock=ft.clock)
    return res, ctl


@pytest.mark.parametrize("strategy", ["on_off", "idle_waiting", "auto", "adaptive"])
@pytest.mark.parametrize("period_s", [0.2, 0.9, 3.0])
def test_controller_and_scheduler_match_reference(jref, strategy, period_s):
    import repro_torch.core.duty_cycle as duty
    import repro_torch.serving.scheduler as sched

    ours, octl = _run(duty, sched, strategy, period_s, 9)
    theirs, jctl = _run(jref["duty"], jref["sched"], strategy, period_s, 9)
    assert ours.n_requests == theirs.n_requests == 9
    assert ours.n_configurations == theirs.n_configurations
    assert math.isclose(ours.energy_mj, theirs.energy_mj, rel_tol=1e-9, abs_tol=1e-9)
    assert ours.energy_by_phase_mj.keys() == theirs.energy_by_phase_mj.keys()
    for k, v in theirs.energy_by_phase_mj.items():
        assert math.isclose(ours.energy_by_phase_mj[k], v, rel_tol=1e-9, abs_tol=1e-9)
    assert (ours.crossover_ms is None) == (theirs.crossover_ms is None)
    if ours.crossover_ms is not None:
        assert math.isclose(ours.crossover_ms, theirs.crossover_ms, rel_tol=1e-9)
    assert ours.policy == theirs.policy
    assert octl.summary()["timeout_s"] == jctl.summary()["timeout_s"]


def test_compare_live_strategies_ratio(jref):
    import repro_torch.core.duty_cycle as duty

    def make(strategy):
        ft = FakeTime()
        power = duty.PowerModel(config_mw=90_000.0, infer_mw=200_000.0, idle_mw=65_000.0)
        ctl = duty.DutyCycleController(ft.bring_up, ft.infer, ft.release, power, strategy,
                                       clock=ft.clock)
        return ctl

    # compare_live_strategies sleeps on the real clock: keep the period tiny
    out = compare_live_strategies(make, lambda: range(3), period_s=0.001)
    assert out["on_off"].n_configurations == 3
    assert out["idle_waiting"].n_configurations == 1
    assert out["energy_ratio_onoff_over_iw"] > 1.0


# ---------------------------------------------------------------------------
# the CLI's demo on the CPU
# ---------------------------------------------------------------------------
def test_build_demo_reduced_serves_three_requests(tmp_path):
    controller, make_request = build_demo(
        "qwen3-1.7b", reduced=True, device="cpu", ckpt_dir=str(tmp_path), strategy="on_off")
    assert make_request()["tokens"].shape == (2, 32)
    res = run_schedule(controller, (make_request() for _ in range(3)), period_s=0.01)
    assert res.n_requests == 3 and res.n_configurations == 3
    assert res.energy_mj > 0 and res.crossover_ms is not None
    assert controller.handle is None            # on_off released after each


def test_build_demo_reuses_checkpoint_and_tokens_follow_seed(tmp_path):
    c1, r1 = build_demo("qwen3-1.7b", device="cpu", ckpt_dir=str(tmp_path), strategy="idle_waiting")
    build_demo("qwen3-1.7b", device="cpu", ckpt_dir=str(tmp_path), strategy="auto")
    assert [p.name for p in tmp_path.iterdir()] == ["step_0.ckpt"]
    expect = np.random.default_rng(0).integers(0, 256, (2, 32))
    assert np.array_equal(r1()["tokens"].numpy(), expect)
    res = run_schedule(c1, (r1() for _ in range(2)), period_s=0.01)
    assert res.n_configurations == 1 and c1.handle is not None


def test_cli_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--period-ms", "10",
                "--strategy", "idle_waiting"])
    out = capsys.readouterr().out
    assert "strategy       : idle_waiting" in out
    assert "requests       : 2" in out and "configurations : 1" in out


def test_model_helpers_default_to_the_card_and_raise_without_it(monkeypatch):
    """``params_from_numpy``, ``init_cache`` and ``init_ssm_cache`` put their
    tensors on the card unless the caller passes ``device="cpu"``; with no
    card they raise instead of landing on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention, mamba2

    cfg = ArchConfig(**SMALL)
    mcfg = get_config("mamba2-370m")
    tree = {"embed": np.arange(8, dtype=np.float32).reshape(2, 4)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = (lambda: zoo.params_from_numpy(tree), lambda: attention.init_cache(cfg, 1, 8),
             lambda: mamba2.init_ssm_cache(mcfg, 1))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert zoo.params_from_numpy(tree, device="cpu")["embed"].device.type == "cpu"
    assert attention.init_cache(cfg, 1, 8, device="cpu").k.device.type == "cpu"
    assert mamba2.init_ssm_cache(mcfg, 1, device="cpu").state.device.type == "cpu"
