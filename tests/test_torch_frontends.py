"""The modality frontends and the GELU FFN vs the JAX package: hubert-xlarge
(audio frames, bidirectional attention at head dim 80, GELU, encoder only)
and llava-next-mistral-7b (projected image patches ahead of the tokens),
reduced and at their full published widths, with the JAX init carried
across leaf by leaf and inputs drawn with numpy.

Host memory: hubert at full depth holds one fp32 copy (3.8 GB) on each
side at a time, then the port's float64 run widens it leaf by leaf (7.6
GB); llava at one layer holds 1.9 GB a copy.  The peaks are in the
docstrings (each measured with the test alone)."""
import dataclasses
import resource

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config
from repro_torch.models import decoder, mlp
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine
from test_torch_x64_shim import x64_shim

ATOL = 1e-4          # tests/test_torch_serving.py's, for logits and block outputs
LIMIT = 1e-4         # of the largest logit, at full width (tests/test_torch_dense.py)
DECODE_TOL = 1e-3    # tests/test_arch_smoke.py::TestDecodeConsistency's


@pytest.fixture(scope="module")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        from repro.configs import base
        from repro.models import decoder as jdecoder, mlp as jmlp, model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(base=base, zoo=model_zoo, decoder=jdecoder, mlp=jmlp)


def _configs(jref, arch, reduced=True, **over):
    j = jref["base"].get_config(arch, reduced=reduced)
    t = get_config(arch, reduced=reduced)
    return dataclasses.replace(j, **over), dataclasses.replace(t, **over)


def _batch(cfg, b, s, seed=0) -> dict:
    """The reference's input layout, drawn with numpy: frames for audio;
    for vision the patch embeddings and S − frontend_tokens tokens."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32)}
    n = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s - n)).astype(np.int32)}
    if n:
        out["patch_embeds"] = rng.standard_normal((b, n, cfg.frontend_dim)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _carry(tree: dict) -> dict:
    """The JAX tree's leaves as torch tensors, each JAX leaf dropped (and
    its buffer freed) once its copy is made."""
    out = {}
    for key in sorted(tree):
        leaf = tree.pop(key)
        out[key] = _carry(leaf) if isinstance(leaf, dict) else torch.from_numpy(np.array(leaf))
        del leaf
    return out


def _to_float64(tree: dict) -> dict:
    """The same weights in float64, each fp32 leaf dropped as it is widened."""
    out = {}
    for key in sorted(tree):
        leaf = tree.pop(key)
        out[key] = _to_float64(leaf) if isinstance(leaf, dict) else leaf.double()
        del leaf
    return out


def _peak_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


# ---------------------------------------------------------------------------
# GELU and the input adapters
# ---------------------------------------------------------------------------
def test_gelu_is_jax_default_tanh_form(jref):
    """``jax.nn.gelu``'s default is the tanh approximation; the port's GELU
    FFN uses the same form (the exact erf form differs by up to 5e-4)."""
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = torch.nn.functional.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - want).max() > 1e-4


@pytest.mark.parametrize("reduced", [True, False])
def test_gelu_mlp_matches_jax(jref, reduced):
    jcfg, cfg = _configs(jref, "hubert-xlarge", reduced)
    from repro.models.common import init_from_specs

    jp = jax.device_get(init_from_specs(jref["mlp"].mlp_specs(jcfg), jax.random.PRNGKey(0), jnp.float32))
    p = zoo.params_from_numpy(jp, device="cpu")
    assert set(p) == {"w_up", "w_down"}
    x = np.random.default_rng(1).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    want = np.asarray(jref["mlp"].mlp_block(jp, jnp.asarray(x), jcfg))
    got = mlp.mlp_block(p, torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b"])
def test_embed_inputs_and_specs_match_jax(jref, arch):
    """The frontend projection's spec and the embedded input: audio frames
    projected (no token embedding, an ``lm_head`` always); image patches
    projected ahead of the token embeddings.  Inputs are rounded to bf16
    first on both sides."""
    jcfg, cfg = _configs(jref, arch)
    jp = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(2), jnp.float32))
    p = zoo.params_from_numpy(jp, device="cpu")
    assert tuple(p["frontend_proj"].shape) == (cfg.frontend_dim, cfg.d_model)
    assert ("embed" in p) == (cfg.frontend != "audio") and "lm_head" in p
    batch = _batch(cfg, 2, 64, seed=3)
    want = np.asarray(jref["decoder"].embed_inputs(jp, _jax(batch), jcfg))
    got = decoder.embed_inputs(p, _torch(batch), cfg)
    assert got.shape == (2, 64, cfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_make_batch_draws_the_reference_layout():
    g = torch.Generator().manual_seed(0)
    hub, llava = get_config("hubert-xlarge"), get_config("llava-next-mistral-7b")
    a = zoo.make_batch(hub, 2, 512, g)
    assert set(a) == {"features"} and a["features"].shape == (2, 512, 512)
    assert a["features"].dtype == torch.bfloat16
    v = zoo.make_batch(llava, 2, 576 + 32, g)
    assert v["patch_embeds"].shape == (2, 576, 1024) and v["tokens"].shape == (2, 32)
    assert v["tokens"].dtype == torch.int32 and int(v["tokens"].max()) < llava.vocab_size
    again = zoo.make_batch(llava, 2, 576 + 32, torch.Generator().manual_seed(0))
    assert set(again) == {"tokens", "patch_embeds"}


# ---------------------------------------------------------------------------
# the reduced models
# ---------------------------------------------------------------------------
def _model(jref, arch, seed=0, reduced=True, **over):
    jcfg, cfg = _configs(jref, arch, reduced, **over)
    jp = jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32))
    return jcfg, cfg, jp, zoo.params_from_numpy(jp, device="cpu")


def test_reduced_hubert_encode_matches_jax(jref):
    """``encode_fn`` at ``tests/test_arch_smoke.py``'s prefill shape (B 2,
    S 64): per-position logits of the bidirectional encoder, fp32."""
    jcfg, cfg, jp, p = _model(jref, "hubert-xlarge")
    batch = _batch(cfg, 2, 64)
    want = np.asarray(jref["zoo"].encode_fn(jp, _jax(batch), jcfg))
    with torch.inference_mode():
        got = zoo.encode_fn(p, _torch(batch), cfg)
    assert got.shape == (2, 64, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # bidirectional: the first position sees the last frame
    moved = _torch(batch)
    moved["features"][:, -1] += 1.0
    with torch.inference_mode():
        assert not torch.allclose(zoo.encode_fn(p, moved, cfg)[:, 0], got[:, 0])


def test_serving_engine_refuses_the_encoder(jref):
    cfg = get_config("hubert-xlarge", reduced=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    with pytest.raises(ValueError, match="encoder-only"):
        ServingEngine(cfg, params, 80)


def test_reduced_llava_prefill_and_decode_match_jax(jref):
    """Prefill (8 patches + 56 tokens, B 2) against the JAX package, then
    the prefill of the first 40 positions and decode to 64, each step within
    1e-3 of the JAX full forward at that position."""
    jcfg, cfg, jp, p = _model(jref, "llava-next-mistral-7b")
    batch = _batch(cfg, 2, 64, seed=4)
    jlogits, _ = jref["zoo"].prefill_fn(jp, _jax(batch), jcfg, 80)
    with torch.inference_mode():
        logits, _ = zoo.prefill_fn(p, _torch(batch), cfg, 80)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=ATOL, rtol=0)

    jhidden, _ = jref["decoder"].forward_hidden(jp, jref["decoder"].embed_inputs(jp, _jax(batch), jcfg), jcfg)
    jfull = np.asarray(jref["decoder"].logits_at(jp, jhidden, jcfg))
    n, t0 = cfg.frontend_tokens, 40
    head = dict(batch, tokens=batch["tokens"][:, : t0 - n])
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(p, _torch(head), cfg, 64)
        errs = [np.abs(logits.numpy() - jfull[:, t0 - 1]).max()]
        for t in range(t0, 64):
            logits, state = zoo.decode_fn(p, state, torch.from_numpy(batch["tokens"][:, t - n]), cfg)
            errs.append(np.abs(logits.numpy() - jfull[:, t]).max())
    assert max(errs) < DECODE_TOL, errs


# ---------------------------------------------------------------------------
# the published widths
# ---------------------------------------------------------------------------
def test_hubert_full_width_full_depth_encode_matches_jax(jref):
    """hubert-xlarge at its published widths and depth (48 layers, d_model
    1280, 16 heads of dim 80 without a causal mask, GELU d_ff 5120, frames
    of 512, vocab 504): 0.95 B parameters, fp32, B 2 × 64 frames through
    ``encode_fn``, the JAX init carried across.  Held as the mamba2 test
    holds its 48 layers: the two fp32 results within 1e-4 of the largest
    logit of each other and of the port's float64 run of the same weights
    (the comparison is of rounding), finite, spread (std over the
    vocabulary above 0.1) and with equal argmax at every position.  Peak
    resident memory 9.18 GB (test alone, 20 s)."""
    jcfg, cfg = _configs(jref, "hubert-xlarge", reduced=False)
    assert cfg.num_layers == 48 and cfg.head_dim == 80 and not cfg.causal
    jparams = jref["zoo"].init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    batch = _batch(cfg, 2, 64, seed=5)
    want = np.asarray(jref["zoo"].encode_fn(jparams, _jax(batch), jcfg), np.float64)
    params = _carry(jparams)
    del jparams
    with torch.inference_mode():
        got = zoo.encode_fn(params, _torch(batch), cfg)
        p64 = _to_float64(params)
        del params
        exact = zoo.encode_fn(p64, _torch(batch), cfg).double().numpy()
        del p64
    assert got.shape == (2, 64, cfg.vocab_size)
    ours = got.double().numpy()
    assert np.isfinite(ours).all() and (ours.std(-1) > 0.1).all(), ours.std(-1).min()
    np.testing.assert_array_equal(ours.argmax(-1), want.argmax(-1))
    limit = LIMIT * np.abs(want).max()
    diffs = {"port-jax": np.abs(ours - want).max(), "port-float64": np.abs(ours - exact).max(),
             "jax-float64": np.abs(want - exact).max()}
    print(f"hubert 48 layers: max |logit| {np.abs(want).max():.4g}, limit {limit:.3g}, "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items()) + f", peak RSS {_peak_gb():.2f} GB")
    assert all(v <= limit for v in diffs.values()), (diffs, limit)


def test_llava_full_width_prefill_with_576_patches_matches_jax(jref):
    """llava-next-mistral-7b at its published widths (d_model 4096, 32/8
    heads of dim 128, d_ff 14336, vocab 32000, patches of 1024 projected),
    depth cut from 32 to 1 layer (0.48 B parameters): one image's 576 patch
    tokens ahead of 32 text tokens, B 2, fp32; then two greedy decode steps.
    Within 1e-4 of the largest logit, equal argmax, spread.  Peak resident
    memory 3.10 GB (test alone, 13 s)."""
    jcfg, cfg = _configs(jref, "llava-next-mistral-7b", reduced=False, num_layers=1)
    assert cfg.frontend_tokens == 576 and cfg.frontend_dim == 1024
    jparams = jref["zoo"].init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    batch = _batch(cfg, 2, 576 + 32, seed=6)
    jlogits, jstate = jref["zoo"].prefill_fn(jparams, _jax(batch), jcfg, 640)
    steps = [np.asarray(jlogits, np.float64)]
    tok = np.array(jnp.argmax(jlogits, -1), np.int32)
    jlogits, _ = jref["zoo"].decode_fn(jparams, jstate, jnp.asarray(tok), jcfg)
    steps.append(np.asarray(jlogits, np.float64))
    del jstate, jlogits
    params = _carry(jparams)
    del jparams
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(params, _torch(batch), cfg, 640)
        ours = [logits.double().numpy()]
        logits, state = zoo.decode_fn(params, state, torch.from_numpy(tok), cfg)
        ours.append(logits.double().numpy())
    assert state.caches[0]["pos0"].index == 576 + 32 + 1
    for got, want in zip(ours, steps):
        assert np.isfinite(got).all() and (got.std(-1) > 0.1).all(), got.std(-1)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
        limit = LIMIT * np.abs(want).max()
        err = np.abs(got - want).max()
        assert err <= limit, (err, limit)
    print(f"llava 1 layer, 576 patches + 32 tokens: max |logit| {np.abs(steps[0]).max():.4g}, "
          f"errors {[float(np.abs(a - b).max()) for a, b in zip(ours, steps)]}, peak RSS {_peak_gb():.2f} GB")
