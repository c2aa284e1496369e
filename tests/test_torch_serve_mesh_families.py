"""Serving on a mesh of ranks for the MoE, Mamba-2, hybrid and frontend
families, and with the KV cache split over its sequence
(``model_zoo.prefill_fn`` / ``decode_fn`` / ``encode_fn`` with ``mesh=``),
against the JAX package's single-device step, on the CPU.

Every multi-rank case runs in one spawn of 4 gloo ranks (``multi_rank``),
on the reduced configs at B 4 (B 1 for the long-context cases), a prompt
of 16 and 4 greedy decode steps (hubert: ``encode_fn`` on 16 frames):

* mamba2 and jamba on (data 2, model 2): the SSD on each rank's heads, the
  conv's channels gathered, the gated norm's sum over ``model``;
* mixtral on (data 2, model 2) with a window of 8, so that the prefill
  keeps a ring and decode wraps it: the f-sharded MoE body;
* qwen3-moe, widened to 16 experts top 2, on (data 1, model 4): the
  expert-parallel body;
* llava (patch embeddings ahead of the tokens) and hubert (non-causal,
  frames) on (data 2, model 2);
* qwen3 with ``shard_cache_seq_over_model`` on (2, 2) and (1, 4), and
  mixtral with it, where the ring splits over ``model`` at the first
  decode step: each rank's partial attention over its block of the cache,
  combined over ``model``;
* jamba and mamba2 with ``long_context`` at B 1: the batch replicated over
  ``data``, jamba's KV cache split over ``data``.

The MoE cases run at capacity factor 64, where nothing drops, which must
equal the reference's dropless single-device step.  Each rank's logits,
gathered over the batch, are held to the reference's single-device
``prefill_fn`` / ``decode_fn`` / ``encode_fn`` on the weights carried
across (the port's draw, as numpy): within 1e-5 of the largest logit, the
greedy tokens equal.  At the config's own capacity factor each MoE layer
of mixtral and qwen3-moe, fed an input with a shared direction so that
slots drop, is held to ``moe_capacity_reference`` (the bodies' plain
version on one device; 2e-5, ``tests/test_torch_moe_sharded.py``'s bound).
Each rank also runs the same step on ``meta`` on the descriptor mesh at its
coordinate, whose staged collectives must equal the live run's
``ranks.stats``, call for call and byte for byte, by tag.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun_lib, roofline
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import decoder
from repro_torch.models import model_zoo as zoo
from repro_torch.models import moe as moe_mod

S, STEPS = 16, 4
MAX_LEN = S + STEPS
LIMIT = 1e-5                        # of the largest logit
MOE_LIMIT = 2e-5                    # tests/test_multidevice.py's, as tests/test_torch_moe_sharded.py
DROPLESS = 64.0
SKEW = 2.0                          # the shared direction of the capacity check's input
SEQ = {"shard_cache_seq_over_model": True}
CASES = {           # case → (arch, (data, model), PerfConfig fields, config changes, B, long_context)
    "mamba2": ("mamba2-370m", (2, 2), {}, {}, 4, False),
    "jamba": ("jamba-1.5-large-398b", (2, 2), dict(moe_capacity_factor=DROPLESS), {}, 4, False),
    "mixtral": ("mixtral-8x7b", (2, 2), dict(moe_capacity_factor=DROPLESS), dict(sliding_window=8), 4, False),
    "qwen3-moe": ("qwen3-moe-235b-a22b", (1, 4), dict(moe_capacity_factor=DROPLESS), dict(num_experts=16), 4,
                  False),
    "llava": ("llava-next-mistral-7b", (2, 2), {}, {}, 4, False),
    "hubert": ("hubert-xlarge", (2, 2), {}, {}, 4, False),
    "qwen3 seq (2, 2)": ("qwen3-1.7b", (2, 2), SEQ, {}, 4, False),
    "qwen3 seq (1, 4)": ("qwen3-1.7b", (1, 4), SEQ, {}, 4, False),
    "mixtral seq": ("mixtral-8x7b", (2, 2), dict(SEQ, moe_capacity_factor=DROPLESS), dict(sliding_window=8), 4,
                    False),
    "jamba long": ("jamba-1.5-large-398b", (2, 2), dict(moe_capacity_factor=DROPLESS), {}, 1, True),
    "mamba2 long": ("mamba2-370m", (2, 2), {}, {}, 1, True),
}
CAPACITY = ("mixtral", "qwen3-moe")     # the cases whose MoE layers the capacity check holds


def _config(configs, name):
    """The reduced config of a case (the port's or the reference's
    ``configs`` module), with the case's changes."""
    arch, _, _, changes, _, _ = CASES[name]
    return dataclasses.replace(configs.get_config(arch, reduced=True), **changes)


def _inputs(cfg, b) -> dict:
    """The prompt batch of B rows as numpy, in the reference's layout."""
    rng = np.random.default_rng(2)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((b, S, cfg.frontend_dim)).astype(np.float32)}
    n = S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, n)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal((b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _moe_input(cfg) -> np.ndarray:
    rng = np.random.default_rng(3)
    return (rng.standard_normal((4, S, cfg.d_model)) + SKEW * rng.standard_normal(cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _serve(blocks, batch, cfg, perf, mesh, long_context, replicated):
    """The prefill and STEPS greedy decode steps (hubert: the encoder) →
    (each step's logits of this rank's rows, the caches after the prefill
    and after the last step)."""
    on = dict(mesh=mesh, replicated_batch=replicated)
    if not cfg.decode_supported:
        return [zoo.encode_fn(blocks, batch, cfg, perf, **on)], None, None
    logits, state = zoo.prefill_fn(blocks, batch, cfg, MAX_LEN, perf, long_context, **on)
    out, first = [logits], _shapes(state)
    for _ in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, state = zoo.decode_fn(blocks, state, tok, cfg, perf, long_context, **on)
        out.append(logits)
    return out, first, _shapes(state)


def _shapes(state) -> dict:
    """Each position's cache block shapes in the first period."""
    return {pos: tuple(tuple(t.shape) for t in cache[:2]) for pos, cache in state.caches[0].items()}


def _capacity_check(cfg, params, mesh) -> tuple:
    """Every MoE layer at the config's capacity factor on this rank's rows,
    against ``moe_capacity_reference`` on the whole input → (the largest
    error over the largest output, the slots dropped)."""
    x = torch.from_numpy(_moe_input(cfg))
    layout = zoo.serving_layout(cfg, PerfConfig(), mesh)
    blocks = zoo.shard_params(params, cfg, mesh)
    rows = ranks.shard(x, shd.P("data"), mesh)
    err, dropped = 0.0, 0
    for p in range(decoder.num_periods(cfg)):
        period = layout.fetch(decoder._layer(blocks["periods"], p), "periods", stacked=True)
        whole = decoder._layer(params["periods"], p)
        for i in range(decoder.period_len(cfg)):
            if not cfg.layer_is_moe(i):
                continue
            y, _ = moe_mod.moe_block(period[f"pos{i}"]["moe"], rows, cfg, cfg.capacity_factor, layout=layout)
            got = ranks.all_gather(y, ("data",), 0, mesh)
            want, _, drops = moe_mod.moe_capacity_reference(whole[f"pos{i}"]["moe"], x, cfg, cfg.capacity_factor,
                                                            mesh.shape)
            err = max(err, float((got - want).abs().max() / want.abs().max()))
            dropped += drops
    return err, dropped


def _case(name, params_np) -> dict | None:
    arch, shape, perf_kw, _, b, long_context = CASES[name]
    cfg, perf = _config(configs, name), PerfConfig(**perf_kw)
    mesh = make_rank_mesh(shape)
    if not mesh.is_member:
        return None
    replicated = b % shape[0] != 0
    batch_np = _inputs(cfg, b)
    with shd.use_sharding(mesh):
        params = zoo.params_from_numpy(params_np, device="cpu")
        blocks = zoo.shard_params(params, cfg, mesh)
        batch = shard_batch(batch_np, mesh)
        ranks.stats = {}
        with torch.no_grad():
            logits, first, last = _serve(blocks, batch, cfg, perf, mesh, long_context, replicated)
        live = {k: (v["calls"], v["bytes"]) for k, v in ranks.stats.items()}
        ranks.stats = None
        whole = [x if replicated else ranks.all_gather(x, ("data",), 0, mesh) for x in logits]
        capacity = None
        if name in CAPACITY:
            with torch.no_grad():
                capacity = _capacity_check(cfg, params, mesh)
        # the same step on meta, on the descriptor mesh at this rank's coordinate
        dry = dryrun_lib.dry_mesh(shd.Mesh(mesh.axis_sizes, mesh.axis_names), mesh.coordinate)
        meta_blocks = zoo.shard_params(zoo.param_shapes(cfg, torch.float32), cfg, dry)
        meta_batch = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta") for k, v in batch.items()}
    with shd.use_sharding(dry), torch.no_grad():
        _, cost = roofline.count(_serve, meta_blocks, meta_batch, cfg, perf, dry, long_context, replicated)
    return {"logits": whole, "live": live, "dry": {k: (v["calls"], v["bytes"]) for k, v in cost.staged.items()},
            "prefill_cache": first, "cache": last, "capacity": capacity}


def _ranks_body(params: dict) -> dict:
    torch.set_num_threads(1)
    return {name: _case(name, params[name]) for name in CASES}


# ---------------------------------------------------------------------------
# The test process: the reference's single-device steps (jax is imported
# here and not at the top: the spawned ranks import this module)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jref():
    from test_torch_x64_shim import x64_shim

    with x64_shim():
        import repro.configs
        import repro.configs.perf
        from repro.models import model_zoo

    return dict(configs=repro.configs, perf=repro.configs.perf, zoo=model_zoo)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _reference(jref, name, params):
    """The reference's prefill and greedy decode (or encoder) on one
    device, at the case's capacity factor and long-context flag."""
    import jax
    import jax.numpy as jnp

    arch, _, perf_kw, _, b, long_context = CASES[name]
    jcfg = _config(jref["configs"], name)
    jperf = jref["perf"].PerfConfig(**perf_kw)
    batch = {k: jnp.asarray(v) for k, v in _inputs(jcfg, b).items()}
    if not jcfg.decode_supported:
        return [np.asarray(jax.jit(jref["zoo"].encode_fn, static_argnums=(2, 3))(params, batch, jcfg, jperf))]
    # under jit: its scans compile once, where each eager call compiles its own
    prefill = jax.jit(jref["zoo"].prefill_fn, static_argnums=(2, 3, 4, 5))
    decode = jax.jit(jref["zoo"].decode_fn, static_argnums=(3, 4, 5))
    logits, state = prefill(params, batch, jcfg, MAX_LEN, jperf, long_context)
    out = [np.asarray(logits)]
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, state = decode(params, state, tok, jcfg, jperf, long_context)
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def multi_rank(request):
    """The ranks' results (spawned first, so that their start overlaps this
    process's import of the JAX package), and the reference's single-device
    runs meanwhile, on the same weights."""
    params, box = {}, {}
    for name in CASES:
        drawn = zoo.init_params(_config(configs, name), torch.Generator().manual_seed(0), torch.float32)
        params[name] = _numpy_tree(drawn)

    def run():
        try:
            box["ours"] = ranks.spawn(4, _ranks_body, params, device="cpu", timeout_s=300)
        except BaseException as e:      # re-raised below
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    jref = request.getfixturevalue("jref")
    reference = {name: _reference(jref, name, params[name]) for name in CASES}
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ours"], reference


@pytest.mark.parametrize("name", CASES)
def test_mesh_serving_equals_the_reference_single_device(multi_rank, name):
    ours, reference = multi_rank
    want, got = reference[name], [x.numpy() for x in ours[name]["logits"]]
    cfg = _config(configs, name)
    assert len(got) == len(want) == (1 if not cfg.decode_supported else STEPS + 1)
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (name, step)
        assert np.isfinite(g).all() and w.std() > 0, (name, step)
        assert np.abs(g - w).max() <= LIMIT * np.abs(w).max(), (name, step, np.abs(g - w).max() / np.abs(w).max())
        np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=f"{name} step {step}")


def test_dry_collectives_equal_the_live_ranks_stats(multi_rank):
    ours, _ = multi_rank
    for name in CASES:
        got = ours[name]
        assert got["live"] and got["dry"] == got["live"], name
    assert {"conv gather", "norm sum"} <= set(ours["mamba2"]["live"])
    assert "attention combine" in ours["qwen3 seq (2, 2)"]["live"]
    assert "cache split" in ours["qwen3 seq (1, 4)"]["live"]          # the prefill's cache to its blocks
    assert "attention combine" in ours["jamba long"]["live"]
    assert "attention combine" not in ours["mixtral"]["live"]


def test_cache_blocks_split_as_the_rules_say(multi_rank):
    ours, _ = multi_rank
    # (B rows a rank, slots a rank, KV heads, head dim): every KV head where
    # model splits the sequence
    assert ours["qwen3 seq (2, 2)"]["cache"]["pos0"][0] == (2, MAX_LEN // 2, 2, 16)
    assert ours["qwen3 seq (1, 4)"]["cache"]["pos0"][0] == (4, MAX_LEN // 4, 2, 16)
    # the ring stays whole in the prefill and splits at the first decode step
    assert ours["mixtral seq"]["prefill_cache"]["pos0"][0] == (2, 8, 2, 16)
    assert ours["mixtral seq"]["cache"]["pos0"][0] == (2, 4, 2, 16)
    assert ours["mixtral"]["cache"]["pos0"][0] == (2, 8, 1, 16)
    # long context: the one row on every rank, the sequence over data, the heads over model
    assert ours["jamba long"]["cache"]["pos4"][0] == (1, MAX_LEN // 2, 1, 16)
    # the SSM cache: this rank's heads (8 over model 2) and their conv channels (4 · 16 + 2 · 16)
    assert ours["mamba2"]["cache"]["pos0"] == ((2, 4, 16, 16), (2, 3, 96))
    assert ours["mamba2 long"]["cache"]["pos0"] == ((1, 4, 16, 16), (1, 3, 96))


def test_moe_layers_at_the_config_capacity_equal_moe_capacity_reference(multi_rank):
    ours, _ = multi_rank
    dropped = 0
    for name in CAPACITY:
        err, drops = ours[name]["capacity"]
        assert err <= MOE_LIMIT, (name, err)
        dropped += drops
    assert dropped > 0                          # the check decides which slots drop
