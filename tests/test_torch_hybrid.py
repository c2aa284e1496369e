"""The hybrid family vs the JAX package: the reduced jamba-1.5-large-398b,
one 8-layer period with attention at position 4, Mamba-2 mixers at the
other seven and the MoE FFN at the odd positions.  Prefill logits, decode
against the full forward, the period's parameter tree and caches, and a
checkpoint both ways; the JAX init carried across by ``params_from_numpy``,
inputs drawn with numpy.  Positions 0 and 4 at the published widths are in
``tests/test_torch_dense.py``."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models import attention, decoder, mamba2, moe
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine, bring_up_from_checkpoint
from test_torch_x64_shim import x64_shim

ARCH = "jamba-1.5-large-398b"
ATOL = 1e-4          # tests/test_torch_serving.py's, for logits and block outputs
DECODE_TOL = 1e-3    # tests/test_arch_smoke.py::TestDecodeConsistency's


@pytest.fixture(scope="module")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        import repro.checkpoint
        import repro.serving.engine
        from repro.configs import base
        from repro.models import decoder as jdecoder, model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(base=base, zoo=model_zoo, decoder=jdecoder, ckpt=repro.checkpoint,
                ckpt_ser=repro.checkpoint.serializer, engine=repro.serving.engine)


@pytest.fixture(scope="module")
def model(jref):
    jcfg, cfg = jref["base"].get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)
    jp = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))
    return jcfg, cfg, jp, zoo.params_from_numpy(jp, device="cpu")


def _tokens(cfg, b=2, s=64, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_period_structure_and_tree_match_jax(jref, model):
    """One period of 8 positions: attention at 4, MoE at the odd positions;
    every leaf's path and shape as in the reference."""
    jcfg, cfg, jp, p = model
    assert decoder.period_len(cfg) == 8 and decoder.num_periods(cfg) == 1
    period = p["periods"]
    assert sorted(period) == [f"pos{i}" for i in range(8)]
    for i in range(8):
        assert ("attn" in period[f"pos{i}"]) == (i == 4)
        assert ("ssm" in period[f"pos{i}"]) == (i != 4)
        assert ("moe" in period[f"pos{i}"]) == (i % 2 == 1)
        assert ("mlp" in period[f"pos{i}"]) == (i % 2 == 0)
    jflat = {jax.tree_util.keystr(k): np.shape(v) for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    oflat = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in jax.tree_util.tree_flatten_with_path(p)[0]}
    assert jflat == oflat
    full = get_config(ARCH)
    assert decoder.num_periods(full) == 9
    assert zoo.param_shapes(full)["periods"]["pos1"]["moe"]["w_gate"].shape == (9, 16, 8192, 24576)


def test_reduced_prefill_logits_match_jax(jref, model):
    """``tests/test_arch_smoke.py``'s prefill shape (B 2, S 64), fp32: seven
    Mamba-2 mixers through the SSD op, one attention layer through the flash
    op (their plain versions here), four MoE FFNs; the caches by kind."""
    jcfg, cfg, jp, p = model
    toks = _tokens(cfg)
    jlogits, _ = jref["zoo"].prefill_fn(jp, {"tokens": jnp.asarray(toks)}, jcfg, 80)
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(p, {"tokens": torch.from_numpy(toks)}, cfg, 80)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)
    assert len(state.caches) == 1 and sorted(state.caches[0]) == [f"pos{i}" for i in range(8)]
    for i, cache in enumerate(state.caches[0][f"pos{i}"] for i in range(8)):
        assert isinstance(cache, attention.KVCache if i == 4 else mamba2.SSMCache)


def test_decode_matches_full_forward(jref, model):
    """Prefill 40, then decode to 48, in fp32: every step within 1e-3 of the
    JAX package's full forward at that position, and of the port's own."""
    jcfg, cfg, jp, p = model
    s, t0 = 48, 40
    toks = _tokens(cfg, s=s, seed=5)
    jx = jref["decoder"].embed_inputs(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    jhidden, _ = jref["decoder"].forward_hidden(jp, jx, jcfg)
    jfull = np.asarray(jref["decoder"].logits_at(jp, jhidden, jcfg))
    with torch.inference_mode():
        hidden, aux = decoder.forward_hidden(p, decoder.embed_inputs(p, {"tokens": torch.from_numpy(toks)}, cfg), cfg)
        np.testing.assert_allclose(decoder.logits_at(p, hidden, cfg).numpy(), jfull, atol=ATOL, rtol=0)
        logits, state = zoo.prefill_fn(p, {"tokens": torch.from_numpy(toks[:, :t0])}, cfg, s)
        errs = [np.abs(logits.numpy() - jfull[:, t0 - 1]).max()]
        for t in range(t0, s):
            logits, state = zoo.decode_fn(p, state, torch.from_numpy(toks[:, t]), cfg)
            errs.append(np.abs(logits.numpy() - jfull[:, t]).max())
    assert state.caches[0]["pos4"].index == s
    assert max(errs) < DECODE_TOL, errs


def test_generate_goes_through_each_op_once_per_layer(model, monkeypatch):
    """A prefill calls the flash op once (position 4), the SSD op seven
    times and the MoE block four times; each decode step calls neither
    kernel op and the MoE block four times."""
    _, cfg, _, p = model
    calls = {"flash": 0, "ssd": 0, "moe": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(fa, "attention", counting("flash", fa.attention))
    monkeypatch.setattr(ssd_ops, "ssd", counting("ssd", ssd_ops.ssd))
    monkeypatch.setattr(moe, "moe_block", counting("moe", moe.moe_block))
    out = ServingEngine(cfg, p, 48).generate({"tokens": torch.from_numpy(_tokens(cfg, s=16))}, n_new=3)
    assert out.tokens.shape == (2, 3)
    assert calls == {"flash": 1, "ssd": 7, "moe": 4 * (1 + 3)}


def test_checkpoint_restores_bit_equal_both_ways(jref, tmp_path, monkeypatch):
    """A zstd+int8 checkpoint of the reduced jamba: the port's restore of the
    JAX package's file, and the JAX package's of the port's, bit for bit
    (both on the zlib codec)."""
    import repro_torch.checkpoint.serializer as ser

    monkeypatch.setattr(jref["ckpt_ser"], "HAVE_ZSTD", False)
    monkeypatch.setattr(ser, "HAVE_ZSTD", False)
    jcfg, cfg = jref["base"].get_config(ARCH, reduced=True), get_config(ARCH, reduced=True)

    def bits(t):
        return t.contiguous().view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()

    jm = jref["ckpt"].CheckpointManager(str(tmp_path / "jax"), mode="zstd+int8")
    jm.save(0, jref["zoo"].init_params(jcfg, jax.random.PRNGKey(4)))
    m = CheckpointManager(str(tmp_path / "port"), mode="zstd+int8")
    m.save(0, zoo.init_params(cfg, torch.Generator().manual_seed(4)))
    for d in ("jax", "port"):
        jeng = jref["engine"].bring_up_from_checkpoint(jcfg, jref["ckpt"].CheckpointManager(str(tmp_path / d)), 48)
        eng = bring_up_from_checkpoint(cfg, CheckpointManager(str(tmp_path / d)), 48, device="cpu")
        jflat = jax.tree_util.tree_flatten_with_path(jeng.params)[0]
        oflat = jax.tree_util.tree_flatten_with_path(eng.params)[0]
        assert len(jflat) == len(oflat)
        for (path, a), (_, b) in zip(jflat, oflat):
            np.testing.assert_array_equal(np.asarray(a).view(np.int16), bits(b), err_msg=str(path))
