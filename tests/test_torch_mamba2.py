"""The ported Mamba-2 path vs the JAX package: the mixer block and its
decode step at the reduced and the full published widths, the full-width
48-layer prefill logits, greedy decoding, checkpoints both ways and the
CLI's demo, with weights carried across by ``params_from_numpy`` and inputs
drawn with numpy."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serializer import _should_quantize, flatten, unflatten_like
from repro_torch.configs import get_config
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.serve import build_demo
from repro_torch.models import mamba2 as m2
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine, bring_up_from_checkpoint
from repro_torch.serving.scheduler import run_schedule
from test_torch_x64_shim import x64_shim

ATOL = 1e-4          # tests/test_torch_serving.py's, for logits and block outputs


@pytest.fixture(scope="session")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.checkpoint
        import repro.serving.engine
        from repro.configs import base
        from repro.models import common, mamba2, model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(base=base, zoo=model_zoo, m2=mamba2, common=common,
                engine=repro.serving.engine, ckpt=repro.checkpoint,
                ckpt_ser=repro.checkpoint.serializer)


def _configs(jref, reduced, **over):
    j = jref["base"].get_config("mamba2-370m", reduced=reduced)
    t = get_config("mamba2-370m", reduced=reduced)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _tokens(cfg, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _block_params(jref, jcfg, seed=0):
    jp = jax.device_get(jref["common"].init_from_specs(
        jref["m2"].mamba2_specs(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    return jp, zoo.params_from_numpy(jp, device="cpu")


def _close(ours, theirs, atol=ATOL):
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(theirs, np.float32), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# the mixer block and its decode step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("prompt", [32, 200])
@pytest.mark.parametrize("reduced", [True, False])
def test_mamba2_block_and_decode_match_jax(jref, reduced, prompt):
    """Prefill over the prompt (one chunk, or two with a ragged second: the
    padding and the carried state), its cache, then three decode steps."""
    jcfg, cfg = _configs(jref, reduced)
    jp, p = _block_params(jref, jcfg)
    rng = np.random.default_rng(prompt)
    x = rng.standard_normal((2, prompt, cfg.d_model)).astype(np.float32)
    jout, jcache = jref["m2"].mamba2_block(jp, jnp.asarray(x), jcfg, return_state=True)
    out, cache = m2.mamba2_block(p, torch.from_numpy(x), cfg, return_state=True)
    assert out.shape == (2, prompt, cfg.d_model)
    assert cache.state.dtype == torch.float32
    assert cache.conv.shape == (2, cfg.ssm_conv_width - 1, cfg.ssm_d_inner + 2 * cfg.ssm_state)
    _close(out, jout)
    _close(cache.state, jcache.state)
    _close(cache.conv, jcache.conv)               # the un-convolved projections
    for _ in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jout, jcache = jref["m2"].mamba2_decode(jp, jnp.asarray(xt), jcache, jcfg)
        out, cache = m2.mamba2_decode(p, torch.from_numpy(xt), cache, cfg)
        assert out.shape == (2, 1, cfg.d_model)
        _close(out, jout)
        _close(cache.state, jcache.state)
        _close(cache.conv, jcache.conv)


def test_short_prompt_pads_the_conv_cache_and_decode_matches_init_cache(jref):
    """A prompt shorter than the conv window leaves zeros at the front of
    the cache, as the reference does; a zero cache is ``init_ssm_cache``."""
    jcfg, cfg = _configs(jref, True)
    jp, p = _block_params(jref, jcfg, seed=1)
    x = np.random.default_rng(9).standard_normal((2, 2, cfg.d_model)).astype(np.float32)
    _, jcache = jref["m2"].mamba2_block(jp, jnp.asarray(x), jcfg, return_state=True)
    _, cache = m2.mamba2_block(p, torch.from_numpy(x), cfg, return_state=True)
    _close(cache.conv, jcache.conv)
    assert bool((cache.conv[:, 0] == 0).all())
    jinit = jref["m2"].init_ssm_cache(jcfg, 2, jnp.float32)
    init = m2.init_ssm_cache(cfg, 2, torch.float32, device="cpu")
    assert init.state.shape == jinit.state.shape and init.conv.shape == jinit.conv.shape
    xt = x[:, :1]
    jout, _ = jref["m2"].mamba2_decode(jp, jnp.asarray(xt), jinit, jcfg)
    out, _ = m2.mamba2_decode(p, torch.from_numpy(xt), init, cfg)
    _close(out, jout)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [True, False])
def test_param_tree_maps_one_to_one(jref, reduced):
    jcfg, cfg = _configs(jref, reduced)
    jshapes = jref["zoo"].param_shapes(jcfg)
    ours = zoo.param_shapes(cfg)
    jflat = {jax.tree_util.keystr(p): s.shape for p, s in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    oflat = {jax.tree_util.keystr(p): tuple(t.shape) for p, t in
             jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert jflat == oflat
    assert "['periods']['pos0']['ssm']['w_x']" in oflat


def test_full_width_bring_up_dequantizes_nine_leaves(jref):
    """The leaves a zstd+int8 checkpoint quantizes at the published size,
    on both sides: one dequant launch each per bring-up."""
    jcfg, cfg = _configs(jref, False)
    ours = [p for p, t in flatten(zoo.param_shapes(cfg)) if _should_quantize(t)]
    jleaves = jax.tree_util.tree_flatten_with_path(jref["zoo"].param_shapes(jcfg))[0]
    names = ["/".join(k.key for k in path) for path, _ in jleaves]
    theirs = [name for name, (_, s) in zip(names, jleaves)
              if jref["ckpt_ser"]._should_quantize(name, s)]
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == 9


def test_full_width_full_depth_prefill_logits_match_jax(jref):
    """48 layers at the published widths, fp32, batch 2, prompt 32, the JAX
    init carried across.  The two fp32 results are held to each other within
    1e-4 of the largest logit (the card's end-to-end limit): each lies about
    that far from the float64 result of the same model, which the port also
    computes here (the JAX package's own rounding over 48 layers is of that
    size), so the comparison is of rounding, not of function.  The logits
    must be finite, spread (standard deviation over the vocabulary above
    0.1; the init gives about 0.64) and agree on every row's argmax."""
    jcfg, cfg = _configs(jref, False)
    jparams = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    params = zoo.params_from_numpy(jparams, device="cpu")
    toks = _tokens(cfg)
    jlogits, _ = jref["zoo"].prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    jlogits = np.asarray(jlogits, np.float64)
    del jparams
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
        p64 = unflatten_like(params, [t.double() for _, t in flatten(params)])
        del params
        logits64, _ = zoo.prefill_fn(p64, {"tokens": torch.from_numpy(toks)}, cfg, 48)
        del p64
    assert logits.shape == (2, cfg.vocab_size) and logits.dtype == torch.float32
    assert len(state.caches) == 48 and isinstance(state.caches[0]["pos0"], m2.SSMCache)
    ours, exact = logits.double().numpy(), logits64.numpy()
    assert np.isfinite(ours).all()
    assert (ours.std(-1) > 0.1).all(), ours.std(-1)
    np.testing.assert_array_equal(ours.argmax(-1), jlogits.argmax(-1))
    limit = 1e-4 * np.abs(jlogits).max()
    diffs = {"port-jax": np.abs(ours - jlogits).max(), "port-float64": np.abs(ours - exact).max(),
             "jax-float64": np.abs(jlogits - exact).max()}
    print(f"max |logit| {np.abs(jlogits).max():.4g}, limit {limit:.3g}, "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()))
    assert all(v <= limit for v in diffs.values()), (diffs, limit)


def test_greedy_decoding_full_width_matches_jax(jref):
    """8 greedy steps at the published widths (depth cut to 4 layers to keep
    the test short): equal tokens and logits within 1e-4 at every step."""
    jcfg, cfg = _configs(jref, False, num_layers=4)
    jparams = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(1), jnp.float32))
    params = zoo.params_from_numpy(jparams, device="cpu")
    toks = _tokens(cfg, s=20, seed=1)
    jlogits, jstate = jref["zoo"].prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    for _ in range(8):
        _close(logits, jlogits)
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
        np.testing.assert_array_equal(logits.argmax(-1).numpy(), tok)
        jlogits, jstate = jref["zoo"].decode_fn(jparams, jstate, jnp.asarray(tok), jcfg)
        with torch.inference_mode():
            logits, state = zoo.decode_fn(params, state, torch.from_numpy(tok), cfg)
    _close(logits, jlogits)

    jtok = jref["engine"].ServingEngine(jcfg, jparams, 48).generate(
        {"tokens": jnp.asarray(toks)}, n_new=8).tokens
    tok = ServingEngine(cfg, params, 48).generate({"tokens": torch.from_numpy(toks)}, n_new=8).tokens
    assert tok.dtype == torch.int32 and tok.shape == (2, 8)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))


def test_prefill_scans_through_the_kernel_wrapper_once_per_layer(monkeypatch):
    """Prefill has no other route to the scan than the kernel's wrapper (one
    call per layer, the prompt padded to the chunk); decode stays on the
    plain decode step."""
    cfg = get_config("mamba2-370m", reduced=True)
    calls = []
    wrapper = ssd_ops.ssd

    def counting(*args, **kw):
        calls.append((tuple(args[0].shape), kw["chunk"]))
        return wrapper(*args, **kw)

    monkeypatch.setattr(ssd_ops, "ssd", counting)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    toks = torch.from_numpy(_tokens(cfg, s=200))
    out = ServingEngine(cfg, params, 208).generate({"tokens": toks}, n_new=3)
    assert out.tokens.shape == (2, 3)
    shape = (2, 256, cfg.ssm_num_heads, cfg.ssm_head_dim)
    assert calls == [(shape, 128)] * cfg.num_layers


# ---------------------------------------------------------------------------
# checkpoints and serving
# ---------------------------------------------------------------------------
def _bits(t):
    return t.contiguous().view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_jax_written_checkpoint_restores_in_the_port(jref, tmp_path, monkeypatch):
    """A zstd+int8 checkpoint (zlib codec) of the published widths, two
    layers, written by the JAX package: the port's restore equals the JAX
    package's bit for bit, and serves the same logits."""
    monkeypatch.setattr(jref["ckpt_ser"], "HAVE_ZSTD", False)
    jcfg, cfg = _configs(jref, False, num_layers=2, vocab_size=1024)
    jm = jref["ckpt"].CheckpointManager(str(tmp_path), mode="zstd+int8")
    jm.save(0, jref["zoo"].init_params(jcfg, jax.random.PRNGKey(2)))
    jeng = jref["engine"].bring_up_from_checkpoint(jcfg, jm, 48)
    eng = bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path)), 48, device="cpu")
    assert eng.params["periods"]["pos0"]["ssm"]["w_x"].dtype == torch.bfloat16
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jeng.params)[0],
                                 jax.tree_util.tree_flatten_with_path(eng.params)[0]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16), _bits(b), err_msg=str(path))
    toks = _tokens(cfg, s=16, seed=3)
    jlogits, _ = jref["zoo"].prefill_fn(jeng.params, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    logits, _ = zoo.prefill_fn(eng.params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    assert np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits, np.float32), atol=5e-2, rtol=0)


def test_port_written_checkpoint_restores_in_jax(jref, tmp_path):
    jcfg, cfg = _configs(jref, False, num_layers=2, vocab_size=1024)
    m = CheckpointManager(str(tmp_path), mode="zstd+int8")
    m.save(0, zoo.init_params(cfg, torch.Generator().manual_seed(4)))
    eng = bring_up_from_checkpoint(cfg, m, 48, device="cpu")
    jeng = jref["engine"].bring_up_from_checkpoint(
        jcfg, jref["ckpt"].CheckpointManager(str(tmp_path)), 48)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jeng.params)[0],
                                 jax.tree_util.tree_flatten_with_path(eng.params)[0]):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16), _bits(b), err_msg=str(path))


@pytest.mark.parametrize("strategy,configurations", [("on_off", 3), ("idle_waiting", 1)])
def test_build_demo_serves_mamba2_on_the_cpu(tmp_path, strategy, configurations):
    """The CLI's demo at the reduced width, with the served path's prompt of
    200 tokens (two chunks, the second ragged)."""
    controller, make_request = build_demo(
        "mamba2-370m", device="cpu", ckpt_dir=str(tmp_path), strategy=strategy,
        prompt_len=200, max_len=208)
    assert make_request()["tokens"].shape == (2, 200)
    res = run_schedule(controller, (make_request() for _ in range(3)), period_s=0.01)
    assert res.n_requests == 3 and res.n_configurations == configurations
    assert res.energy_mj > 0 and res.crossover_ms is not None


def test_cli_serves_mamba2_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "mamba2-370m", "--device", "cpu", "--requests", "2",
                "--period-ms", "10", "--strategy", "on_off"])
    out = capsys.readouterr().out
    assert "strategy       : on_off" in out
    assert "requests       : 2" in out and "configurations : 2" in out
