"""Sharded prefill and decode of the dense decoders on a mesh of ranks
(``model_zoo.prefill_fn`` / ``decode_fn`` with ``mesh=``), against one
device, on the CPU.

Every multi-rank case runs in one spawn of 4 gloo ranks (``multi_rank``),
on the reduced configs at B 4, a prompt of 16 and 4 greedy decode steps:
qwen3 on (data 2, model 2), where each rank holds one of the two KV heads;
the same with ``gather_weights_once``; qwen3 on (data 1, model 4), where
``wk``'s split cuts a KV head in two (each rank gathers it and keeps the KV
head its query head reads); and yi-6b with 6 query heads (3 a KV head) on
(data 1, model 4), where the query heads do not divide over ``model`` and
every head runs on every rank.  Each rank's logits, gathered over the batch, are held to the
reference's single-device ``prefill_fn`` / ``decode_fn`` (1e-5 of the
largest logit, the greedy tokens equal) on the weights carried across.
Each rank also runs the same step on ``meta`` on the descriptor mesh at
its coordinate (``launch/roofline.py``'s dry mode), whose staged
collectives must equal the live run's ``ranks.stats``, call for call and
byte for byte, by tag.
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs import SHAPES_BY_NAME, get_config, list_archs
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun_lib, roofline
from repro_torch.launch.mesh import make_production_mesh, make_rank_mesh
from repro_torch.models import attention as attn
from repro_torch.models import model_zoo as zoo

B, S, STEPS = 4, 16, 4
MAX_LEN = S + STEPS
CASES = {           # case → (arch, (data, model), PerfConfig fields)
    "qwen3 (2, 2)": ("qwen3-1.7b", (2, 2), {}),
    "qwen3 (2, 2) gather once": ("qwen3-1.7b", (2, 2), dict(gather_weights_once=True)),
    "qwen3 (1, 4)": ("qwen3-1.7b", (1, 4), {}),
    "yi-6b (1, 4)": ("yi-6b", (1, 4), {}),
}
HEADS = {"yi-6b": 6}   # the reduced config's query heads where a case changes them


def _config(configs, arch):
    """The reduced config of ``arch`` (the port's or the reference's
    ``configs`` module), with ``HEADS``' query heads."""
    cfg = configs.get_config(arch, reduced=True)
    return dataclasses.replace(cfg, num_heads=HEADS[arch]) if arch in HEADS else cfg


def _tokens(cfg) -> np.ndarray:
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _serve(blocks, tokens, cfg, perf, mesh):
    """The prefill and STEPS greedy decode steps → (each step's logits of
    this rank's rows, their greedy tokens)."""
    logits, state = zoo.prefill_fn(blocks, {"tokens": tokens}, cfg, MAX_LEN, perf=perf, mesh=mesh)
    out = [logits]
    for _ in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, state = zoo.decode_fn(blocks, state, tok, cfg, perf=perf, mesh=mesh)
        out.append(logits)
    return out


def _case(arch, shape, perf_kw, params_np) -> dict | None:
    cfg, perf = _config(configs, arch), PerfConfig(**perf_kw)
    mesh = make_rank_mesh(shape)
    if not mesh.is_member:
        return None
    with shd.use_sharding(mesh):
        blocks = zoo.shard_params(zoo.params_from_numpy(params_np, device="cpu"), cfg, mesh)
        tokens = shard_batch({"tokens": _tokens(cfg)}, mesh)["tokens"]
        ranks.stats = {}
        with torch.no_grad():
            logits = _serve(blocks, tokens, cfg, perf, mesh)
        live = {k: (v["calls"], v["bytes"]) for k, v in ranks.stats.items()}
        ranks.stats = None
        whole = [ranks.all_gather(x, ("data",), 0, mesh) for x in logits]
        # the same step on meta, on the descriptor mesh at this rank's coordinate
        dry = dryrun_lib.dry_mesh(shd.Mesh(mesh.axis_sizes, mesh.axis_names), mesh.coordinate)
        meta_blocks = zoo.shard_params(zoo.param_shapes(cfg, torch.float32), cfg, dry)
        meta_tokens = torch.empty(tuple(tokens.shape), dtype=torch.int32, device="meta")
    with shd.use_sharding(dry), torch.no_grad():
        _, cost = roofline.count(_serve, meta_blocks, meta_tokens, cfg, perf, dry)
    return {"logits": whole, "live": live, "dry": {k: (v["calls"], v["bytes"]) for k, v in cost.staged.items()},
            "cache_heads": attn.cache_heads(cfg, zoo.serving_layout(cfg, perf, mesh)), "all_heads": cfg.num_kv_heads,
            "flops": cost.flops}


def _ranks_body(params: dict) -> dict:
    torch.set_num_threads(1)
    return {name: _case(arch, shape, kw, params[arch]) for name, (arch, shape, kw) in CASES.items()}


# ---------------------------------------------------------------------------
# The test process: the reference's single-device steps (jax is imported
# here and not at the top: the spawned ranks import this module, and eight
# processes importing jax at once take most of a minute)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jref():
    from test_torch_x64_shim import x64_shim

    with x64_shim():
        import repro.compat
        import repro.configs
        import repro.configs.perf
        import repro.launch.dryrun_lib
        from repro.models import model_zoo

    return dict(compat=repro.compat, configs=repro.configs, perf=repro.configs.perf,
                zoo=model_zoo, dryrun=repro.launch.dryrun_lib)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _reference(jref, arch, params):
    """The reference's prefill and greedy decode on one device."""
    import jax.numpy as jnp

    jcfg = _config(jref["configs"], arch)
    logits, state = jref["zoo"].prefill_fn(params, {"tokens": jnp.asarray(_tokens(jcfg))}, jcfg, MAX_LEN)
    out = [np.asarray(logits)]
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, state = jref["zoo"].decode_fn(params, state, tok, jcfg)
        out.append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def multi_rank(request):
    """The ranks' results (spawned first, so that their start overlaps this
    process's import of the JAX package), and the reference's single-device
    runs meanwhile, on the same weights (the port's draw, as numpy)."""
    params, box = {}, {}
    for arch in ("qwen3-1.7b", "yi-6b"):
        drawn = zoo.init_params(_config(configs, arch), torch.Generator().manual_seed(0), torch.float32)
        params[arch] = _numpy_tree(drawn)

    def run():
        try:
            box["ours"] = ranks.spawn(4, _ranks_body, params, device="cpu", timeout_s=300)
        except BaseException as e:      # re-raised below
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    jref = request.getfixturevalue("jref")
    reference = {arch: _reference(jref, arch, params[arch]) for arch in params}
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ours"], reference


# One test a property over every case of ``CASES``.
def test_sharded_prefill_and_decode_equal_the_reference_single_device(multi_rank):
    ours, reference = multi_rank
    for name, (arch, _, _) in CASES.items():
        want = reference[arch]
        got = [x.numpy() for x in ours[name]["logits"]]
        assert len(got) == len(want) == STEPS + 1
        for step, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (B, _config(configs, arch).vocab_size), (name, step)
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), (name, step)
            np.testing.assert_array_equal(g.argmax(-1), w.argmax(-1), err_msg=f"{name} step {step}")


def test_dry_collectives_equal_the_live_ranks_stats(multi_rank):
    ours, _ = multi_rank
    for name in CASES:
        got = ours[name]
        assert got["live"] and got["dry"] == got["live"], name
    assert set(ours["qwen3 (2, 2)"]["live"]) == {"weight gather", "tensor parallel", "logits"}
    assert "weight gather" not in ours["yi-6b (1, 4)"]["live"]           # data 1: nothing to gather


def test_each_rank_keeps_the_kv_heads_its_query_heads_read(multi_rank):
    ours, _ = multi_rank
    assert ours["qwen3 (2, 2)"]["cache_heads"] == 1          # 2 KV heads over model 2
    assert ours["qwen3 (1, 4)"]["cache_heads"] == 1          # one query head, one KV head
    assert ours["yi-6b (1, 4)"]["cache_heads"] == ours["yi-6b (1, 4)"]["all_heads"] == 2


def test_gather_weights_once_serves_the_same_numbers(multi_rank):
    ours, _ = multi_rank
    off, on = ours["qwen3 (2, 2)"], ours["qwen3 (2, 2) gather once"]
    for a, b in zip(off["logits"], on["logits"]):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
    assert on["dry"]["weight gather"][0] < off["dry"]["weight gather"][0]


def test_decode_batch_pspecs_equal_the_reference(jref):
    perf, jperf = PerfConfig(), jref["perf"].PerfConfig()
    for multi_pod in (False, True):
        mesh = make_production_mesh(multi_pod=multi_pod)
        jmesh = jref["compat"].abstract_mesh(mesh.axis_sizes, mesh.axis_names)
        for arch in list_archs():
            cfg, jcfg = get_config(arch), jref["configs"].get_config(arch)
            for shape in ("decode_32k", "long_500k"):
                ours = dryrun_lib.batch_pspecs(cfg, SHAPES_BY_NAME[shape], mesh, perf)
                theirs = jref["dryrun"].batch_pspecs(jcfg, jref["configs"].SHAPES_BY_NAME[shape], jmesh, jperf)
                assert tuple(ours["token"]) == tuple(theirs["token"]), (arch, shape)
                assert ours["state"].caches.keys() == theirs["state"].caches.keys()
                for pos, spec in ours["state"].caches.items():
                    want = theirs["state"].caches[pos]
                    assert type(spec).__name__ == type(want).__name__
                    for field in spec._fields:
                        assert tuple(getattr(spec, field)) == tuple(getattr(want, field)), (arch, shape, pos, field)
    for flag in ("shard_cache_seq_over_model", "shard_long_cache_over_model"):
        with pytest.raises(NotImplementedError, match="log-sum-exp"):
            dryrun_lib.batch_pspecs(get_config("qwen3-32b"), SHAPES_BY_NAME["decode_32k"], mesh,
                                    PerfConfig(**{flag: True}))


def test_serving_on_a_mesh_raises_for_the_other_families():
    mesh = make_production_mesh()
    for arch in ("mixtral-8x7b", "mamba2-370m", "jamba-1.5-large-398b", "llava-next-mistral-7b"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            zoo.serving_layout(get_config(arch), PerfConfig(), mesh)
    with pytest.raises(NotImplementedError, match="log-sum-exp"):
        zoo.serving_layout(get_config("qwen3-1.7b"), PerfConfig(), mesh, long_context=True)
