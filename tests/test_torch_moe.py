"""The ported MoE FFN and the MoE families vs the JAX package: routing, the
dense oracle, the grouped dispatch against the oracle, the reduced
mixtral-8x7b and qwen3-moe-235b-a22b (prefill logits, decode against the
full forward, the sliding window's ring cache wrapping), and their
checkpoints with 4-D expert stacks both ways.  The JAX init is carried
across by ``params_from_numpy``; inputs are drawn with numpy.  The two
models at their full published widths are in ``tests/test_torch_dense.py``
(one fp32 copy of 7–15 GB each)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.serializer import _should_quantize, flatten
from repro_torch.configs import get_config
from repro_torch.models import decoder, moe
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import bring_up_from_checkpoint
from test_torch_x64_shim import x64_shim

ATOL = 1e-4          # tests/test_torch_serving.py's, for logits and block outputs
ROUTE_TOL = 1e-6     # tests/test_model_properties.py::TestMoERouting's
DECODE_TOL = 1e-3    # tests/test_arch_smoke.py::TestDecodeConsistency's
MOE = ("mixtral-8x7b", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.checkpoint
        import repro.serving.engine
        from repro.configs import base
        from repro.models import common, decoder as jdecoder, model_zoo
        from repro.models import moe as jmoe

    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(base=base, zoo=model_zoo, moe=jmoe, common=common, decoder=jdecoder,
                ckpt=repro.checkpoint, ckpt_ser=repro.checkpoint.serializer,
                engine=repro.serving.engine)


def _configs(jref, arch, reduced=True):
    return jref["base"].get_config(arch, reduced=reduced), get_config(arch, reduced=reduced)


def _moe_params(jref, jcfg, seed=0):
    jp = jax.device_get(jref["common"].init_from_specs(
        jref["moe"].moe_specs(jcfg), jax.random.PRNGKey(seed), jnp.float32))
    return jp, zoo.params_from_numpy(jp, device="cpu")


def _tokens(cfg, b=2, s=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# routing and the FFN
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (7, 3), (42, 4), (129, 1), (129, 2), (2**31 - 2, 4)])
def test_route_matches_jax(jref, seed, k):
    """The reference test's inputs (x (32, 16), router (16, 8) × 0.1): the
    same weights within 1e-6, the same expert ids, the same aux loss
    within 1e-6.  At seed 129, k 1 the reference's aux is 0.99759, below the
    1 − 1e-6 its own test asserts (ROADMAP C-ref-3): the port gives the
    reference's value, not the bound."""
    xt = np.array(jax.random.normal(jax.random.PRNGKey(seed), (32, 16)))
    router = np.array(jax.random.normal(jax.random.PRNGKey(seed + 1), (16, 8)) * 0.1)
    jw, jids, jaux = jref["moe"].route(jnp.asarray(xt), jnp.asarray(router), k)
    w, ids, aux = moe.route(torch.from_numpy(xt), torch.from_numpy(router), k)
    assert w.dtype == torch.float32 and w.shape == (32, k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=ROUTE_TOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL
    if (seed, k) == (129, 1):
        assert float(jaux) < 1.0 - 1e-6 and abs(float(aux) - 0.99759) < 1e-5


@pytest.mark.parametrize("arch", MOE + ("jamba-1.5-large-398b",))
def test_moe_reference_matches_jax(jref, arch):
    jcfg, cfg = _configs(jref, arch)
    jp, p = _moe_params(jref, jcfg)
    x = np.random.default_rng(1).standard_normal((2, 64, cfg.d_model)).astype(np.float32)
    jy, jaux = jref["moe"].moe_reference(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe_reference(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=ATOL, rtol=0)
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL


@pytest.mark.parametrize("shape", [(2, 64), (1, 1)])
@pytest.mark.parametrize("arch", MOE + ("jamba-1.5-large-398b",))
def test_grouped_dispatch_matches_the_dense_oracle(jref, arch, shape):
    """The dispatch against ``moe_reference`` in fp32 at the reduced shapes
    (B 2, S 64: every expert gets tokens), and at one token, which leaves
    E − k experts without one.  Experts that hold no token are set to NaN:
    the dispatch must not read them."""
    _, cfg = _configs(jref, arch)
    _, p = _moe_params(jref, jref["base"].get_config(arch, reduced=True), seed=3)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((*shape, cfg.d_model)).astype(np.float32))
    want, want_aux = moe.moe_reference(p, x, cfg)
    _, ids, _ = moe.route(x.reshape(-1, cfg.d_model), p["router"], cfg.experts_per_token)
    idle = sorted(set(range(cfg.num_experts)) - set(ids.flatten().tolist()))
    assert bool(idle) == (shape != (2, 64))
    for name in ("w_gate", "w_up", "w_down"):
        p[name][idle] = float("nan")
    got, aux = moe.moe_block(p, x, cfg)
    assert got.shape == x.shape and got.dtype == x.dtype
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    assert float(aux) == float(want_aux)


def test_moe_specs_match_jax(jref):
    """Leaf paths and shapes, (E, d, f) and (E, f, d), at the full widths."""
    for arch in MOE + ("jamba-1.5-large-398b",):
        jcfg, cfg = _configs(jref, arch, reduced=False)
        js, ours = jref["moe"].moe_specs(jcfg), moe.moe_specs(cfg)
        assert {k: s.shape for k, s in js.items()} == {k: s.shape for k, s in ours.items()}


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def _model(jref, arch, seed=0):
    jcfg, cfg = _configs(jref, arch)
    jp = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    return jcfg, cfg, jp, zoo.params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("arch", MOE)
def test_reduced_prefill_logits_match_jax(jref, arch):
    """``tests/test_arch_smoke.py``'s prefill shape (B 2, S 64), fp32."""
    jcfg, cfg, jp, p = _model(jref, arch)
    toks = _tokens(cfg)
    jlogits, _ = jref["zoo"].prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg, 80)
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(p, {"tokens": torch.from_numpy(toks)}, cfg, 80)
    assert logits.shape == (2, cfg.vocab_size) and len(state.caches) == cfg.num_layers
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("arch,t0", [("mixtral-8x7b", 40), ("mixtral-8x7b", 20),
                                     ("qwen3-moe-235b-a22b", 40)])
def test_decode_matches_full_forward(jref, arch, t0):
    """Prefill ``t0`` tokens, then decode to 48, in fp32: every step's logits
    within 1e-3 of the JAX package's full forward at that position (and of
    the port's own).  mixtral's reduced window is 32: a prefill of 40 keeps
    the last 32 keys ring-aligned, and from a prefill of 20 the decode steps
    fill the ring and wrap around it."""
    jcfg, cfg, jp, p = _model(jref, arch)
    s = 48
    toks = _tokens(cfg, s=s, seed=5)
    jx = jref["decoder"].embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    jhidden, _ = jref["decoder"].forward_hidden(jp, jx, jcfg)
    jfull = np.asarray(jref["decoder"].logits_at(jp, jhidden, jcfg))
    with torch.inference_mode():
        x = decoder.embed_inputs(p, {"tokens": torch.from_numpy(toks)}, cfg)
        hidden, _ = decoder.forward_hidden(p, x, cfg)
        full = decoder.logits_at(p, hidden, cfg).numpy()
        np.testing.assert_allclose(full, jfull, atol=ATOL, rtol=0)
        logits, state = zoo.prefill_fn(p, {"tokens": torch.from_numpy(toks[:, :t0])}, cfg, s)
        errs = [np.abs(logits.numpy() - jfull[:, t0 - 1]).max()]
        for t in range(t0, s):
            logits, state = zoo.decode_fn(p, state, torch.from_numpy(toks[:, t]), cfg)
            errs.append(np.abs(logits.numpy() - jfull[:, t]).max())
    if cfg.sliding_window:
        cache = state.caches[0]["pos0"]
        assert cache.k.shape[1] == cfg.sliding_window and cache.index == s
        assert sorted(cache.positions.tolist()) == list(range(s - cfg.sliding_window, s))
    assert max(errs) < DECODE_TOL, (arch, t0, errs)


@pytest.mark.parametrize("arch", MOE)
def test_forward_aux_matches_jax(jref, arch):
    """``forward_hidden``'s summed aux loss over the MoE layers."""
    jcfg, cfg, jp, p = _model(jref, arch, seed=2)
    toks = _tokens(cfg, s=32, seed=6)
    _, jaux = jref["decoder"].forward_hidden(
        jp, jref["decoder"].embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jcfg), jcfg)
    _, aux = decoder.forward_hidden(p, decoder.embed_inputs(p, {"tokens": torch.from_numpy(toks)}, cfg), cfg)
    assert abs(float(aux) - float(jaux)) <= ROUTE_TOL * cfg.num_layers


# ---------------------------------------------------------------------------
# checkpoints with 4-D expert stacks
# ---------------------------------------------------------------------------
def _bits(t):
    return t.contiguous().view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_expert_stacks_quantize_as_the_reference_flattens_them():
    """The reduced mixtral's w_gate and w_up, (L 2, E 4, d 64, f 128), are
    65536 elements with C 128: quantized as one (L·E·d, f) matrix, the
    dequant kernel's first 4-D leaf.  Its w_down (C 64) is not."""
    cfg = get_config("mixtral-8x7b", reduced=True)
    quant = {p for p, t in flatten(zoo.param_shapes(cfg)) if _should_quantize(t)}
    assert quant == {"periods/pos0/moe/w_gate", "periods/pos0/moe/w_up"}
    shape = zoo.param_shapes(cfg)["periods"]["pos0"]["moe"]["w_gate"].shape
    assert tuple(shape) == (2, 4, 64, 128)


def test_jax_written_moe_checkpoint_restores_bit_equal(jref, tmp_path, monkeypatch):
    monkeypatch.setattr(jref["ckpt_ser"], "HAVE_ZSTD", False)
    jcfg, cfg = _configs(jref, "mixtral-8x7b")
    jm = jref["ckpt"].CheckpointManager(str(tmp_path), mode="zstd+int8")
    jm.save(0, jref["zoo"].init_params(jcfg, jax.random.PRNGKey(4)))
    jeng = jref["engine"].bring_up_from_checkpoint(jcfg, jm, 48)
    eng = bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path)), 48, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jeng.params)[0]
    oflat = jax.tree_util.tree_flatten_with_path(eng.params)[0]
    assert len(jflat) == len(oflat)
    for (path, a), (_, b) in zip(jflat, oflat):
        np.testing.assert_array_equal(np.asarray(a).view(np.int16), _bits(b), err_msg=str(path))
    toks = _tokens(cfg, s=16, seed=3)
    jlogits, _ = jref["zoo"].prefill_fn(jeng.params, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    out = eng.generate({"tokens": torch.from_numpy(toks)}, n_new=2)
    logits, _ = zoo.prefill_fn(eng.params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    assert out.tokens.shape == (2, 2)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits, np.float32), atol=5e-2, rtol=0)


def test_port_written_moe_checkpoint_restores_bit_equal_in_jax(jref, tmp_path):
    jcfg, cfg = _configs(jref, "qwen3-moe-235b-a22b")
    cfg_m = get_config("mixtral-8x7b", reduced=True)
    for c, jc in ((cfg, jcfg), (cfg_m, jref["base"].get_config("mixtral-8x7b", reduced=True))):
        d = tmp_path / c.name
        m = CheckpointManager(str(d), mode="zstd+int8")
        m.save(0, zoo.init_params(c, torch.Generator().manual_seed(4)))
        eng = bring_up_from_checkpoint(c, m, 48, device="cpu")
        jeng = jref["engine"].bring_up_from_checkpoint(jc, jref["ckpt"].CheckpointManager(str(d)), 48)
        for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jeng.params)[0],
                                     jax.tree_util.tree_flatten_with_path(eng.params)[0]):
            np.testing.assert_array_equal(np.asarray(a).view(np.int16), _bits(b), err_msg=str(path))
