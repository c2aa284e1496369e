"""The families at their full published widths vs the JAX package, each at
a cut depth that keeps every layer kind it has: the dense yi-6b,
internlm2-20b, qwen3-32b and qwen3-1.7b (fp32 prefill logits at batch 2,
prompt 32, with the JAX init carried across; and four greedy decode steps
of qwen3-32b, whose query width (64 × 128 = 8192) is not its d_model
(5120)); mixtral-8x7b and qwen3-moe-235b-a22b at one layer; and jamba's
period positions 0 (Mamba-2 mixer) and 4 (attention), each with its dense
FFN.

These tests sit in one file so that they run one after another on one test
worker: each holds one fp32 copy of a model of 0.5–3.7 B parameters.  The
dense tests convert the JAX tree leaf by leaf, freeing every JAX leaf as its
copy is made, so the host never holds a third copy; the MoE and hybrid
tests draw every matrix from its own seed into buffers that the side
reading them owns.  Each docstring states the peak resident memory of its
process, measured with ``resource.getrusage`` when the test ran alone."""
import dataclasses
import resource

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.configs import get_config
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine
from test_torch_x64_shim import x64_shim

LIMIT = 1e-4        # of the largest logit, as tests/test_torch_mamba2.py


@pytest.fixture(scope="module")
def jref():
    """The JAX package, imported under jax 0.9.0, where
    ``jax.experimental.enable_x64`` is gone but ``jax.enable_x64`` remains."""
    with x64_shim():
        from repro.configs import base
        from repro.models import model_zoo

    torch.backends.cuda.matmul.allow_tf32 = False
    return dict(base=base, zoo=model_zoo)


def _configs(jref, arch, layers):
    j = jref["base"].get_config(arch)
    t = get_config(arch)
    return dataclasses.replace(j, num_layers=layers), dataclasses.replace(t, num_layers=layers)


def _tokens(cfg, b=2, s=32, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _carry(tree: dict) -> dict:
    """The JAX tree's leaves as torch tensors, each JAX leaf dropped (and
    its buffer freed) once its copy is made: the host holds one leaf twice,
    never the tree."""
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


def _prefill_parity(jref, arch, layers, with_float64, seed=0):
    """JAX fp32 prefill logits first (then the JAX tree goes), the port's
    on the carried weights, and optionally the port's in float64."""
    jcfg, cfg = _configs(jref, arch, layers)
    jparams = jref["zoo"].init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32)
    toks = _tokens(cfg)
    jlogits, _ = jref["zoo"].prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    jlogits = np.asarray(jlogits, np.float64)
    params = _carry(jparams)
    del jparams
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
        exact = None
        if with_float64:
            p64 = _to_float64(params)
            del params
            exact, _ = zoo.prefill_fn(p64, {"tokens": torch.from_numpy(toks)}, cfg, 48)
            exact = exact.numpy()
            del p64
    assert logits.shape == (2, cfg.vocab_size) and logits.dtype == torch.float32
    assert len(state.caches) == layers
    ours = logits.double().numpy()
    assert np.isfinite(ours).all()
    assert (ours.std(-1) > 0.1).all(), ours.std(-1)
    np.testing.assert_array_equal(ours.argmax(-1), jlogits.argmax(-1))
    limit = LIMIT * np.abs(jlogits).max()
    diffs = {"port-jax": np.abs(ours - jlogits).max()}
    if exact is not None:
        diffs["port-float64"] = np.abs(ours - exact).max()
        diffs["jax-float64"] = np.abs(jlogits - exact).max()
    print(f"{arch} at {layers} layers: max |logit| {np.abs(jlogits).max():.4g}, limit {limit:.3g}, "
          + ", ".join(f"{k} {v:.3g}" for k, v in diffs.items())
          + f", logit std {ours.std(-1).round(4).tolist()}, peak RSS {_peak_gb():.2f} GB")
    assert all(v <= limit for v in diffs.values()), (diffs, limit)


def test_qwen3_1_7b_full_width_prefill_logits_match_jax(jref):
    """qwen3-1.7b at its published widths (d_model 2048, 16/8 heads of dim
    128, d_ff 6144, vocab 151936, tied), depth cut from 28 to 4 layers:
    0.51 B parameters.  Held to the JAX package within 1e-4 of the largest
    logit, and both to the port's float64 run of the same weights (each
    about 1e-5 apart against a limit of 4.7e-4).  Peak resident memory
    5.35 GB (test alone, 15 s)."""
    _prefill_parity(jref, "qwen3-1.7b", 4, with_float64=True)


def test_yi_6b_full_width_prefill_logits_match_jax(jref):
    """yi-6b at its published widths (d_model 4096, 32/4 heads of dim 128:
    GQA group 8, d_ff 11008, vocab 64000, untied), depth cut from 32 to 2
    layers: 0.87 B parameters.  Held to the JAX package within 1e-4 of the
    largest logit, and both to the port's float64 run (each about 1e-5
    apart against a limit of 4.4e-4).  Peak resident memory 7.80 GB (test
    alone, 19 s)."""
    _prefill_parity(jref, "yi-6b", 2, with_float64=True)


def test_internlm2_20b_full_width_prefill_logits_match_jax(jref):
    """internlm2-20b at its published widths (d_model 6144, 48/8 heads of
    dim 128: GQA group 6, d_ff 16384, vocab 92544, untied), depth cut from
    48 to 1 layer: 1.53 B parameters.  No float64 run (12.2 GB more): at one
    layer the fp32 rounding of either side is a few ulps of each logit's
    sum of 6144 products (measured: 1.1e-5 against a limit of 4.4e-4), while
    a wrong function (a head or a norm misplaced) moves logits by the size
    of the logits themselves.  Peak resident memory 11.59 GB (test alone,
    24 s)."""
    _prefill_parity(jref, "internlm2-20b", 1, with_float64=False)


def test_qwen3_32b_full_width_prefill_logits_match_jax(jref):
    """qwen3-32b at its published widths (d_model 5120, 64/8 heads of dim
    128: GQA group 8 and a query width of 8192 ≠ d_model, qk_norm, d_ff
    25600, vocab 151936, untied), depth cut from 64 to 1 layer: 2.04 B
    parameters, 8.2 GB in fp32.  No float64 run (16.3 GB more); the 1e-4
    limit separates rounding from function at one layer as in the
    internlm2-20b test (measured: 1.05e-5 against 5.1e-4).  Peak resident
    memory 15.69 GB (test alone, 27 s)."""
    _prefill_parity(jref, "qwen3-32b", 1, with_float64=False)


def test_qwen3_32b_full_width_greedy_decode_matches_jax(jref):
    """Four greedy decode steps of qwen3-32b at its published widths, depth
    cut to 1 layer: the port's first decode where the query width (8192)
    differs from d_model (5120).  The JAX package runs first (prefill and
    four steps, each fed its own argmax); the port, on the carried weights,
    gives the same tokens through ``ServingEngine.generate`` and logits
    within 1e-4 of the largest at every step.  Peak resident memory
    15.69 GB (test alone, 34 s)."""
    jcfg, cfg = _configs(jref, "qwen3-32b", 1)
    assert cfg.q_dim == 8192 != cfg.d_model
    jparams = jref["zoo"].init_params(jcfg, jax.random.PRNGKey(1), jnp.float32)
    toks = _tokens(cfg, s=20, seed=1)
    jlogits, jstate = jref["zoo"].prefill_fn(jparams, {"tokens": jnp.asarray(toks)}, jcfg, 48)
    steps, jtokens = [np.asarray(jlogits, np.float64)], []
    for _ in range(4):
        tok = np.array(jnp.argmax(jlogits, -1), np.int32)
        jtokens.append(tok)
        jlogits, jstate = jref["zoo"].decode_fn(jparams, jstate, jnp.asarray(tok), jcfg)
        steps.append(np.asarray(jlogits, np.float64))
    del jstate, jlogits
    params = _carry(jparams)
    del jparams

    out = ServingEngine(cfg, params, 48).generate({"tokens": torch.from_numpy(toks)}, n_new=4)
    assert out.tokens.dtype == torch.int32 and out.tokens.shape == (2, 4)
    np.testing.assert_array_equal(out.tokens.numpy(), np.stack(jtokens, axis=1))

    with torch.inference_mode():
        logits, state = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
        for i, want in enumerate(steps):
            limit = LIMIT * np.abs(want).max()
            err = np.abs(logits.double().numpy() - want).max()
            assert err <= limit, (i, err, limit)
            if i < 4:
                logits, state = zoo.decode_fn(params, state, torch.from_numpy(jtokens[i]), cfg)
    print(f"qwen3-32b greedy decode: tokens {out.tokens.tolist()}, peak RSS {_peak_gb():.2f} GB")


# ---------------------------------------------------------------------------
# the MoE and hybrid families at full width
# ---------------------------------------------------------------------------
def _draw(specs, seed: int, owner: str):
    """Random fp32 weights for a spec tree, every matrix from its own seed,
    drawn in place by eight threads: the same values whatever holds them.
    ``owner="torch"`` → a torch tree; ``owner="jax"`` → (a JAX tree, torch
    views of its buffers): JAX copies every buffer it imports each time an
    operation reads it, so the JAX side computes on buffers it owns, filled
    through DLPack views, and the port may read the same buffers."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.models.common import map_specs

    jobs = []

    def leaf(spec):
        if owner == "jax":
            j = jnp.zeros(spec.shape, jnp.float32)
            t = torch.from_dlpack(j)
            assert t.data_ptr() == j.unsafe_buffer_pointer()
        else:
            j = t = torch.zeros(spec.shape)
        if spec.init == "ones":
            t.fill_(1.0)
        elif spec.init == "normal":
            fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
            std = spec.scale if spec.scale is not None else fan_in ** -0.5
            for m in t.view(-1, *t.shape[-2:]) if t.dim() > 2 else [t]:
                jobs.append((m, std, seed * 1_000_003 + len(jobs)))
        return j, t

    pairs = map_specs(leaf, specs)
    with ThreadPoolExecutor(8) as pool:
        list(pool.map(lambda job: job[0].normal_(0.0, job[1], generator=torch.Generator().manual_seed(job[2])), jobs))
    split = lambda tree, k: {key: split(v, k) if isinstance(v, dict) else v[k] for key, v in tree.items()}
    return (split(pairs, 0), split(pairs, 1)) if owner == "jax" else split(pairs, 1)


def _moe_parity(jref, arch, seed):
    """One layer at the published widths, fp32, batch 2, prompt 32: the port's
    prefill logits against the JAX package's prefill taken in its three
    parts (``embed_inputs``; the layer, ``_apply_block``: attention and the
    MoE FFN; final norm and ``logits_at``), each on leaves drawn from the
    same seeds: within 1e-4 of the largest logit, spread, equal argmax.
    The JAX package's dense MoE oracle copies an expert stack to multiply
    it, so its parts hold their own leaves only; the port's prefill reads
    the layer's JAX-owned buffers and redraws the embedding."""
    from repro.configs.perf import BASELINE
    from repro.models import decoder as jdec
    from repro.models.common import rms_norm as jnorm
    from repro_torch.models import decoder

    jcfg, cfg = _configs(jref, arch, 1)
    specs = decoder.decoder_specs(cfg)
    toks = _tokens(cfg, seed=seed)
    emb = {"embed": specs["embed"]}
    jemb, _ = _draw(emb, seed, "jax")
    jx = jdec.embed_inputs(jemb, {"tokens": jnp.asarray(toks)}, jcfg)
    del jemb
    jblock, block = _draw(decoder._block_specs(cfg, 0), seed + 1, "jax")
    jx, _ = jdec._apply_block(jblock, jx, jcfg, 0, BASELINE)
    jhead, head = _draw({"lm_head": specs["lm_head"], "final_norm": specs["final_norm"]}, seed + 2, "jax")
    jx = jnorm(jx, jhead["final_norm"], jcfg.norm_eps)
    jlogits = np.asarray(jdec.logits_at(jhead, jx[:, -1:, :], jcfg)[:, 0], np.float64)
    stacked = lambda tree: {k: stacked(v) if isinstance(v, dict) else v[None] for k, v in tree.items()}
    params = {"periods": {"pos0": stacked(block)}, **head, **_draw(emb, seed, "torch")}
    with torch.inference_mode():
        logits, state = zoo.prefill_fn(params, {"tokens": torch.from_numpy(toks)}, cfg, 48)
    ours = logits.double().numpy()
    assert logits.shape == (2, cfg.vocab_size) and len(state.caches) == 1
    assert np.isfinite(ours).all() and (ours.std(-1) > 0.1).all(), ours.std(-1)
    np.testing.assert_array_equal(ours.argmax(-1), jlogits.argmax(-1))
    limit = LIMIT * np.abs(jlogits).max()
    err = np.abs(ours - jlogits).max()
    print(f"{arch} at 1 layer: {cfg.param_count() / 1e9:.3f} B parameters, "
          f"max |logit| {np.abs(jlogits).max():.4g}, limit {limit:.3g}, port-jax {err:.3g}, "
          f"logit std {ours.std(-1).round(4).tolist()}, peak RSS {_peak_gb():.2f} GB")
    assert err <= limit, (err, limit)
    del jblock, jhead


def test_mixtral_8x7b_full_width_prefill_logits_match_jax(jref):
    """mixtral-8x7b at its published widths (d_model 4096, 32/8 heads of dim
    128, 8 experts of d_ff 14336, top 2, vocab 32000, window 4096), depth
    cut from 32 to 1 layer: 1.71 B parameters.  Peak resident memory
    8.16 GB (test alone, 23 s)."""
    _moe_parity(jref, "mixtral-8x7b", seed=3)


def test_qwen3_moe_full_width_prefill_logits_match_jax(jref):
    """qwen3-moe-235b-a22b at its published widths (d_model 4096, 64/4 heads
    of dim 128: GQA group 16, qk_norm, 128 experts of d_ff 1536, top 8,
    vocab 151936), depth cut from 94 to 1 layer: 3.73 B parameters, 14.9 GB
    in fp32.  Peak resident memory 15.24 GB (test alone, 35 s)."""
    _moe_parity(jref, "qwen3-moe-235b-a22b", seed=4)


@pytest.mark.parametrize("pos", [0, 4])
def test_jamba_full_width_blocks_match_jax(jref, pos):
    """jamba-1.5-large-398b's period positions 0 (Mamba-2 mixer: d_inner
    16384, 256 SSM heads of dim 64, state 128; dense FFN 24576) and 4
    (attention: 64/8 heads of dim 128; dense FFN) at the published widths,
    fp32, B 2 × 32 positions: the JAX package's ``_apply_block`` against the
    port's per-position steps (``forward_block`` and ``prefill_block``) on
    the same JAX-owned buffers.  The block's contribution (output − input)
    within 1e-4 of its largest value.  The MoE positions (16 experts of
    24576) are not held here: one such layer is 9.66 B parameters, 38.7 GB
    per fp32 copy; their code is the ``moe_block`` that mixtral and
    qwen3-moe hold above, and the card holds the whole period.  Peak
    resident memory 5.21 / 3.64 GB (test alone, 12 / 11 s)."""
    from repro.configs.perf import BASELINE
    from repro.models import decoder as jdec
    from repro_torch.models import decoder

    jcfg, cfg = _configs(jref, "jamba-1.5-large-398b", 8)
    assert cfg.layer_kind(pos) == ("attn" if pos == 4 else "ssm") and not cfg.layer_is_moe(pos)
    assert cfg.ssm_num_heads == 256 and cfg.ssm_d_inner == 16384
    jblock, block = _draw(decoder._block_specs(cfg, pos), 7 + pos, "jax")
    x = np.random.default_rng(pos).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    jy, _ = jdec._apply_block(jblock, jnp.asarray(x), jcfg, pos, BASELINE)
    want = np.asarray(jy, np.float64) - x
    with torch.inference_mode():
        y, aux = decoder.forward_block(block, torch.from_numpy(x), cfg, pos)
        y2, cache = decoder.prefill_block(block, torch.from_numpy(x), cfg, pos, 48)
    assert aux is None and torch.equal(y, y2)
    assert type(cache).__name__ == ("KVCache" if pos == 4 else "SSMCache")
    ours = y.double().numpy() - x
    limit = LIMIT * np.abs(want).max()
    err = np.abs(ours - want).max()
    print(f"jamba position {pos}: max |contribution| {np.abs(want).max():.4g}, limit {limit:.3g}, "
          f"port-jax {err:.3g}, std {ours.std():.4g}, peak RSS {_peak_gb():.2f} GB")
    assert np.isfinite(ours).all() and ours.std() > 0.1
    assert err <= limit, (err, limit)
