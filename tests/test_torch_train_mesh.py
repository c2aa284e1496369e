"""The GSPMD train step on a mesh of ranks (``training/train_loop.py`` with
``mesh=``), against one device, on the CPU.

Every multi-rank case runs in one spawn of 8 gloo ranks (``multi_rank``),
on the reduced configs at B 8, S 32: a train step of the reduced yi-6b on
(data 4, model 2) and of the reduced qwen3 on (data 2, model 4), where
``wk``'s split cuts a KV head in two (so each rank gathers the KV heads
and keeps those its query head reads), both with two microbatches, under
``gather_weights_once`` and each ``remat`` mode, and on (data 8, model 1)
and (data 1, model 8), where the query heads do not divide over
``model``.  Each is held to the reference's single-device
``make_train_step`` (the loss within 1e-4, ``tests/test_multidevice.py``'s
bound; its own mesh runs fail under jax 0.9.0, ROADMAP C-ref-2) and to the
port's single-device step on the same weights and batch: the loss and the
gradient norm within 1e-6 relative, every gathered gradient within 1e-5 of
its leaf's largest entry (only the order of the sums differs), the
parameters after the step within 1e-6 of a leaf's largest entry where
``sqrt(v̂) ≥ 1e3·eps`` and at least 100 times the leaf's largest gradient
difference, and within 2·lr elsewhere (C-ref-9: there one rounding of the
gradient moves an element by a different part of ``lr``).  The spawn also
saves the reduced qwen3 on (4, 2) and restores it onto (2, 4), resumes a
run elastically from (4, 2) onto the (2, 2) survivors through
``launch.train.train(mesh=)``, runs the compressed cross-pod step on
(pod 2, data 2, model 2) under ``perf_rules``, and places batches and
checks blocks with ``shard_batch`` and ``constrain``.
"""
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import SHAPES_BY_NAME, get_config, list_archs
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import shard_batch
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import plan_elastic_mesh
from repro_torch.launch import dryrun_lib
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_production_mesh, make_rank_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.training.train_loop import make_train_step, state_pspecs
from repro_torch.tree import paths, unflatten_like
from test_torch_x64_shim import x64_shim

B, S, LR = 8, 32, 1e-3
EPS, B2 = 1e-8, 0.95
UPDATE_REL = 1e-6
STEPS = {           # case → (arch, (data, model), PerfConfig fields)
    "yi-6b (4, 2)": ("yi-6b", (4, 2), dict(num_microbatches=2)),
    "qwen3 (2, 4)": ("qwen3-1.7b", (2, 4), dict(num_microbatches=2)),
    "yi-6b (4, 2) gather once": ("yi-6b", (4, 2), dict(num_microbatches=2, gather_weights_once=True)),
    "qwen3 (2, 4) gather once": ("qwen3-1.7b", (2, 4), dict(num_microbatches=2, gather_weights_once=True)),
    "qwen3 (2, 4) remat dots": ("qwen3-1.7b", (2, 4), dict(num_microbatches=2, remat="dots")),
    "qwen3 (2, 4) remat none": ("qwen3-1.7b", (2, 4), dict(num_microbatches=2, remat="none")),
    "qwen3 (8, 1)": ("qwen3-1.7b", (8, 1), dict()),
    "yi-6b (1, 8)": ("yi-6b", (1, 8), dict()),
}
ELASTIC = dict(batch=4, seq=32, seed=3, log_every=100, device="cpu")
COMPRESS_STEPS, COMPRESS_LR = 3, 1e-2


def _batch(cfg) -> dict:
    rng = np.random.default_rng(1)
    return {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for k in ("tokens", "labels")}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _step_case(arch, shape, perf_kw, params_np) -> dict | None:
    cfg = get_config(arch, reduced=True)
    mesh = make_rank_mesh(shape)
    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, PerfConfig(**perf_kw), mesh=mesh)
        state = fns.init_state(zoo.params_from_numpy(params_np, device="cpu"))
        if state is None:
            return None
        batch = shard_batch(_batch(cfg), mesh)
        specs = paths(fns.param_pspecs)
        loss, grads = fns.loss_and_grads(state.params, batch)
        grads = {k: ranks.unshard(g, specs[k], mesh) for k, g in grads.items()}
        state, metrics = fns.train_step(state, batch, LR)
        params = {k: ranks.unshard(t, specs[k], mesh) for k, t in paths(state.params).items()}
    return {"loss": float(loss), "grads": grads, "metrics": {k: float(metrics[k]) for k in ("loss", "grad_norm")},
            "params": params}


def _remesh(directory) -> dict | None:
    """The reduced qwen3's bf16 weights saved from (4, 2) blocks, restored
    onto (2, 4)."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0))
    mesh_a, mesh_b = make_rank_mesh((4, 2)), make_rank_mesh((2, 4))
    with shd.use_sharding(mesh_a):
        specs_a = zoo.param_pspecs(cfg, mesh_a)
    with shd.use_sharding(mesh_b):
        specs_b = zoo.param_pspecs(cfg, mesh_b)
    flat_a = paths(specs_a)
    blocks = unflatten_like(params, [ranks.shard(t, flat_a[k], mesh_a).clone() for k, t in paths(params).items()])
    manager = CheckpointManager(str(directory))
    manager.save(1, blocks, specs_a, mesh_a)
    step, restored = manager.restore_latest(zoo.param_shapes(cfg), device="cpu", pspecs=specs_b, mesh=mesh_b)
    flat_b = paths(specs_b)
    whole = {k: ranks.unshard(t, flat_b[k], mesh_b) for k, t in paths(restored).items()}
    shapes_b = {k: tuple(t.shape) for k, t in paths(restored).items()}
    return {"step": step, "whole": whole, "blocks_b": shapes_b, "params": params}


def _elastic(directory) -> dict | None:
    """6 uninterrupted steps on (4, 2); 3 steps and a save on (4, 2), then
    a resume on the (2, 2) survivors to step 6."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    mesh_a = make_rank_mesh((4, 2))
    full = train_mod.train("qwen3-1.7b", steps=6, mesh=mesh_a, **ELASTIC)
    first = train_mod.train("qwen3-1.7b", steps=3, mesh=mesh_a, ckpt_dir=str(directory), ckpt_every=3, **ELASTIC)
    with shd.use_sharding(mesh_a):
        specs = paths(state_pspecs(first["state"], zoo.param_pspecs(cfg, mesh_a)))
    saved = {k: ranks.unshard(t, specs[k], mesh_a) if isinstance(t, torch.Tensor) else t
             for k, t in paths(first["state"]).items()}
    plan = plan_elastic_mesh(survivors=4, model_axis=2)
    mesh_b = make_rank_mesh((plan.data, plan.model))
    second = train_mod.train("qwen3-1.7b", steps=6, mesh=mesh_b, ckpt_dir=str(directory), **ELASTIC)
    if second is None:                  # a rank the survivors' mesh leaves out
        return None
    return {"full": full["losses"], "first": first["losses"], "second": second["losses"],
            "plan": (plan.data, plan.model), "saved": saved}


def _compressed(params_np) -> dict:
    """3 steps of the reduced yi-6b on (pod 2, data 2, model 2) under
    ``perf_rules``, compressed and not."""
    cfg = get_config("yi-6b", reduced=True)
    mesh = make_rank_mesh((2, 2, 2))
    batch = shard_batch(_batch(cfg), mesh)
    out = {}
    for compress in (False, True):
        perf = PerfConfig(grad_compress_pod=compress)
        with shd.use_sharding(mesh, dryrun_lib.perf_rules(perf)):
            fns = make_train_step(cfg, perf, mesh=mesh)
            state = fns.init_state(zoo.params_from_numpy(params_np, device="cpu"))
            losses = []
            for _ in range(COMPRESS_STEPS):
                state, m = fns.train_step(state, batch, COMPRESS_LR)
                losses.append(float(m["loss"]))
        out[compress] = {"losses": losses, "err": state.compress_err is not None,
                         "specs": {k: tuple(v) for k, v in paths(fns.param_pspecs).items()}}
    return out


def _placement() -> dict:
    """``shard_batch`` and ``constrain`` on (data 4, model 2)."""
    mesh = make_rank_mesh((4, 2))
    rows = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    odd = np.arange(6 * 4, dtype=np.int32).reshape(6, 4)
    got = {"coordinate": mesh.coordinate,
           "rows": shard_batch({"t": rows}, mesh)["t"].numpy(),
           "odd": shard_batch({"t": odd}, mesh)["t"].numpy(),
           "cols": shard_batch({"t": rows}, mesh, pspecs={"t": shd.P(None, "model")})["t"].numpy()}
    x = torch.zeros(2, 16, 2, 16)
    with shd.use_sharding(mesh):
        got["fits"] = shd.constrain(x, ("batch", "act_seq", "act_heads", None), (8, 16, 4, 16)) is x
        try:
            shd.constrain(x, ("batch", "act_seq", "act_heads", None), (8, 16, 8, 16))
            got["misfit"] = None
        except ValueError as e:
            got["misfit"] = str(e)
    return got


def _ranks_body(step_params: dict, yi_params, directory) -> dict:
    torch.set_num_threads(1)
    out = {"steps": {name: _step_case(arch, shape, kw, step_params[arch])
                     for name, (arch, shape, kw) in STEPS.items()}}
    out["remesh"] = _remesh(directory / "remesh")
    out["elastic"] = _elastic(directory / "elastic")
    out["compressed"] = _compressed(yi_params)
    out["placement"] = _placement()
    return out


# ---------------------------------------------------------------------------
# The test process: the reference's and the port's single-device steps
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jref():
    with x64_shim():
        import repro.compat
        import repro.configs
        import repro.configs.perf
        import repro.launch.dryrun_lib
        import repro.training.train_loop
        from repro.models import model_zoo

    return dict(compat=repro.compat, configs=repro.configs, perf=repro.configs.perf,
                loop=repro.training.train_loop, zoo=model_zoo, dryrun=repro.launch.dryrun_lib)


def _reference_init(jref, arch):
    jcfg = jref["configs"].get_config(arch, reduced=True)
    return jcfg, jax.device_get(jref["zoo"].init_params(jcfg, jax.random.PRNGKey(0), jnp.float32))


@pytest.fixture(scope="module")
def multi_rank(jref, tmp_path_factory):
    """The ranks' results, and meanwhile here the reference's single-device
    step losses and the port's single-device steps."""
    directory = tmp_path_factory.mktemp("train_mesh")
    inits = {arch: _reference_init(jref, arch) for arch in ("yi-6b", "qwen3-1.7b")}
    box = {}

    def run():
        try:
            box["ours"] = ranks.spawn(8, _ranks_body, {a: p for a, (_, p) in inits.items()}, inits["yi-6b"][1],
                                      directory, device="cpu", timeout_s=300)
        except BaseException as e:      # re-raised below
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    single, reference = {}, {}
    for name, (arch, _, kw) in STEPS.items():
        jcfg, jp = inits[arch]
        cfg = get_config(arch, reduced=True)
        raw = _batch(cfg)
        fns = jref["loop"].make_train_step(jcfg, jref["perf"].PerfConfig(**kw))
        _, m = jax.jit(fns.train_step)(fns.init_state(jp), {k: jnp.asarray(v) for k, v in raw.items()}, LR)
        reference[name] = float(m["loss"])
        fns = make_train_step(cfg, PerfConfig(**kw))
        state = fns.init_state(zoo.params_from_numpy(jp, device="cpu"))
        batch = {k: torch.from_numpy(v) for k, v in raw.items()}
        loss, grads = fns.loss_and_grads(state.params, batch)
        grads = {k: g.clone() for k, g in grads.items()}
        state, m = fns.train_step(state, batch, LR)
        single[name] = {"loss": float(loss), "grads": grads,
                        "metrics": {k: float(m[k]) for k in ("loss", "grad_norm")},
                        "params": {k: t.detach().clone() for k, t in paths(state.params).items()},
                        "v": {k: t.clone() for k, t in paths(state.opt.v).items()}}
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ours"], single, reference, directory


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
# One test a property over every case of ``STEPS`` (a test function a case
# would put this file ahead of the small files in pytest-xdist's
# largest-file-first queue and reorder the suite's workers).
def test_mesh_steps_loss_equals_the_reference_single_device_step(multi_rank):
    ours, _, reference, _ = multi_rank
    for name in STEPS:
        assert abs(ours["steps"][name]["metrics"]["loss"] - reference[name]) < 1e-4, name


def test_mesh_steps_equal_the_port_single_device_step(multi_rank):
    ours, single, _, _ = multi_rank
    for name in STEPS:
        got, want = ours["steps"][name], single[name]
        for key in ("loss", "grad_norm"):
            assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=1e-6), (name, key)
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-6), name
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            assert got["grads"][k].shape == g.shape
            assert float((got["grads"][k] - g).abs().max()) <= 1e-5 * float(g.abs().max()), (name, k)


def test_mesh_steps_update_the_parameters_as_one_device(multi_rank):
    ours, single, _, _ = multi_rank
    for name in STEPS:
        got, want = ours["steps"][name]["params"], single[name]["params"]
        for k, p in want.items():
            root = torch.sqrt(single[name]["v"][k] / (1 - B2))
            grad_diff = float((ours["steps"][name]["grads"][k] - single[name]["grads"][k]).abs().max())
            decided = (root >= 1e3 * EPS) & (root >= 100 * grad_diff)
            err = (got[k] - p).abs()
            assert float(torch.where(decided, err, 0).max()) <= UPDATE_REL * float(p.abs().max()), (name, k)
            assert float(torch.where(decided, 0, err).max()) <= 2 * LR, (name, k)


def test_gather_weights_once_equals_gathering_at_each_use(multi_rank):
    ours = multi_rank[0]["steps"]
    for name in ("yi-6b (4, 2)", "qwen3 (2, 4)"):
        off, on = ours[name], ours[f"{name} gather once"]
        assert on["metrics"]["loss"] == pytest.approx(off["metrics"]["loss"], rel=1e-6), name
        assert on["metrics"]["grad_norm"] == pytest.approx(off["metrics"]["grad_norm"], rel=1e-6), name
        for k, g in off["grads"].items():
            assert float((on["grads"][k] - g).abs().max()) <= 1e-5 * float(g.abs().max()), (name, k)


def test_split_kv_head_case_is_the_one_the_reference_remeshes_to():
    """On (data 2, model 4) the rule table splits the reduced qwen3's wk
    (64, 32) into 8-column blocks, half of a 16-wide head."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    mesh = shd.Mesh((2, 4), ("data", "model"))
    spec = paths(zoo.param_pspecs(cfg, mesh))["periods/pos0/attn/wk"]
    assert spec == shd.P(None, "data", "model")
    assert cfg.kv_dim // 4 == cfg.head_dim // 2 and cfg.num_kv_heads % 4


# ---------------------------------------------------------------------------
# Checkpoints across meshes
# ---------------------------------------------------------------------------
def test_checkpoint_elastic_remesh_is_bit_identical(multi_rank, tmp_path):
    ours, _, _, directory = multi_rank
    got = ours["remesh"]
    assert got["step"] == 1
    for k, p in paths(got["params"]).items():
        assert p.dtype == torch.bfloat16 and torch.equal(got["whole"][k], p), k
    assert got["blocks_b"]["periods/pos0/attn/wq"] == (2, 32, 16)      # (L, d / data 2, q / model 4)
    CheckpointManager(str(tmp_path)).save(1, got["params"])
    assert (tmp_path / "step_1.ckpt").read_bytes() == (directory / "remesh" / "step_1.ckpt").read_bytes()


def test_elastic_resume_continues_the_uninterrupted_losses(multi_rank):
    got = multi_rank[0]["elastic"]
    assert got["plan"] == (2, 2)
    assert len(got["first"]) == 3 and len(got["second"]) == 3
    np.testing.assert_allclose(got["first"] + got["second"], got["full"], rtol=0, atol=1e-4)
    assert got["first"] == got["full"][:3]          # the same mesh, the same numbers


def test_elastic_checkpoint_is_a_single_device_save_of_the_state(multi_rank, tmp_path):
    ours, _, _, directory = multi_rank
    saved = ours["elastic"]["saved"]
    cfg = get_config("qwen3-1.7b", reduced=True)
    fns = make_train_step(cfg, PerfConfig())
    state = fns.init_state(zoo.init_params(cfg, torch.Generator().manual_seed(0)))
    leaves = paths(state)
    assert saved.keys() == leaves.keys()
    flat = iter(saved[k] for k in leaves)
    CheckpointManager(str(tmp_path)).save(3, unflatten_like(state, flat))
    assert (tmp_path / "step_3.ckpt").read_bytes() == (directory / "elastic" / "step_3.ckpt").read_bytes()


# ---------------------------------------------------------------------------
# The compressed cross-pod step
# ---------------------------------------------------------------------------
def test_compressed_crosspod_step_stays_with_the_exact_one(multi_rank):
    got = multi_rank[0]["compressed"]
    exact, compressed = got[False]["losses"], got[True]["losses"]
    assert all(np.isfinite(compressed))
    assert abs(compressed[0] - exact[0]) < 1e-3
    assert abs(compressed[-1] - exact[-1]) < 0.05
    assert got[True]["err"] and not got[False]["err"]
    assert compressed[-1] < compressed[0]


def test_compressed_step_replicates_the_parameters_across_pods(multi_rank):
    specs = multi_rank[0]["compressed"][True]["specs"]
    assert all("pod" not in str(s) for s in specs.values())
    assert specs["embed"] == ("model", "data")


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------
def test_shard_batch_and_constrain_on_a_mesh_of_ranks(multi_rank):
    got = multi_rank[0]["placement"]
    assert got["coordinate"] == (0, 0)
    rows = np.arange(8 * 4, dtype=np.int32).reshape(8, 4)
    np.testing.assert_array_equal(got["rows"], rows[:2])                  # (4 data ranks) → 2 rows each
    np.testing.assert_array_equal(got["odd"], np.arange(24).reshape(6, 4))  # 6 rows do not split 4 ways
    np.testing.assert_array_equal(got["cols"], rows[:, :2])
    assert got["fits"] is True
    assert got["misfit"] is not None and "(2, 16, 4, 16)" in got["misfit"]


def test_perf_rules_and_batch_pspecs_equal_the_reference(jref):
    for multi_pod in (False, True):
        for compress in (False, True):
            perf = PerfConfig(grad_compress_pod=compress, shard_cache_seq_over_model=compress)
            jperf = jref["perf"].PerfConfig(grad_compress_pod=compress, shard_cache_seq_over_model=compress)
            assert dryrun_lib.perf_rules(perf) == jref["dryrun"].perf_rules(jperf)
            mesh = make_production_mesh(multi_pod=multi_pod)
            jmesh = jref["compat"].abstract_mesh(mesh.axis_sizes, mesh.axis_names)
            for arch in list_archs():
                cfg, jcfg = get_config(arch), jref["configs"].get_config(arch)
                for shape in ("train_4k", "prefill_32k"):
                    ours = dryrun_lib.batch_pspecs(cfg, SHAPES_BY_NAME[shape], mesh, perf)
                    theirs = jref["dryrun"].batch_pspecs(jcfg, jref["configs"].SHAPES_BY_NAME[shape], jmesh, jperf)
                    assert ours.keys() == theirs.keys()
                    for k in ours:
                        assert tuple(ours[k]) == tuple(theirs[k]), (multi_pod, compress, arch, shape, k)
    # a decode cell's cache splits its sequence over model under the flag
    # (test_torch_serve_mesh.py holds every decode cell's specs to the reference's)
    state = dryrun_lib.batch_pspecs(get_config("qwen3-1.7b"), SHAPES_BY_NAME["decode_32k"], mesh,
                                    PerfConfig(shard_cache_seq_over_model=True))["state"]
    assert tuple(state.caches["pos0"].k) == (None, ("pod", "data"), "model", None, None)
