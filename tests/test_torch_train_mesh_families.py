"""The train step on a mesh of ranks for the MoE, Mamba-2, hybrid and
frontend families (``training/train_loop.py`` with ``mesh=``), against
one device, on the CPU.

Every multi-rank case runs in one spawn of 4 gloo ranks (``multi_rank``),
on the reduced configs at B 8, S 32:

* mixtral on (data 2, model 2), the f-sharded MoE body (the experts'
  ``d_ff`` over ``model``, their parts summed by ``value_psum``, the
  dispatched tokens entered by ``grad_psum``), at the config's capacity
  factor (slots drop) and at E / k (nothing drops);
* qwen3-moe widened to 16 experts, top 2, on (data 1, model 4), the
  expert-parallel body (``ranks.exchange`` there and back, the sequence
  split over ``model`` and gathered back), at E / k and at the config's
  capacity factor (the reduced config's 8 experts do not divide the
  production EP axis of 16, so it would take f-TP);
* mamba2 on (2, 2), gathering its weights at each use and once a step: the
  SSD on each rank's heads, the conv's channels gathered (their gradient
  summed back), the gated norm's sum over ``model`` summed both ways;
* the reduced jamba on (2, 2): attention, Mamba-2 and MoE in one period;
* llava (patch embeddings ahead of the tokens, labels over the patches too)
  and hubert (frames, non-causal labels through the vocab-parallel
  log-sum-exp) on (2, 2);

with two microbatches in two cases and each ``remat`` mode in at least one.
Each is held

* to the reference's single device, the loss within 1e-4
  (``tests/test_multidevice.py``'s bound): its ``make_train_step`` where
  the model has no MoE; where it has, at E / k, its ``lm_loss`` with
  ``aux_weight=0`` (the dropless oracle's negative log-likelihood) plus
  0.01 × the blocks' mean aux of ``moe_capacity_reference``, since a mesh
  takes the mean of its token blocks' Switch losses, not one device's over
  all tokens (``src/repro/models/moe.py:240-243``);
* to the port's single-device step on the same weights and batch, each MoE
  layer routed through ``moe_capacity_reference`` at the mesh's shape, so
  that its aux and its drops are the bodies' own: the loss and the
  gradient norm within 1e-6 relative, every gathered gradient (the
  router's among them) within 1e-5 of its leaf's largest entry or, where
  fp32 rounding alone goes further, as close to the same step in float64
  as twice the single device's gradient (the repo's rule for a plain
  version; the reduced jamba's 8 random layers of Mamba-2 and MoE round
  its small leaves 1.0e-5–1.7e-5 of their largest entry away from float64
  on one device), the parameters after the step by the dense step's rule
  (``test_torch_train_mesh.py``),
  and the MoE's aux (the ranks' terms summed over the batch axes) within
  1e-6 of the blocks' mean;
* and to the dry mode: the same step on ``meta`` at the rank's coordinate
  stages the same calls and bytes by tag as the live one.

The spawn also trains the reduced mixtral through
``launch.train.train(mesh=)`` for 2 steps on (2, 2), saves, and resumes
on the survivors' (data 1, model 2) mesh: the restored state equals the
saved one bit for bit, and the resumed losses equal, bit for bit, the
same two steps run from the restored blocks in memory on that mesh.  They
are not held to an uninterrupted run on (2, 2), as the dense decoders'
are (``test_torch_train_mesh.py``, 1e-4): the MoE routes, drops slots and
takes its aux by token block, a ``data`` rank's rows, so the survivors'
one block of 4 rows computes another loss than two blocks of 2 (they part
by 1e-2 at the config's capacity factor, 3e-4 where nothing drops).
"""
import dataclasses
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch, shard_batch
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import plan_elastic_mesh
from repro_torch.launch import dryrun_lib, roofline
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.models import decoder
from repro_torch.models import model_zoo as zoo
from repro_torch.models import moe as moe_mod
from repro_torch.optim import cosine_with_warmup
from repro_torch.training.train_loop import make_train_step, state_pspecs
from repro_torch.tree import paths

B, S, LR = 8, 32, 1e-3
EPS, B2 = 1e-8, 0.95
UPDATE_REL = 1e-6
GRAD_REL = 1e-5                    # of a leaf's largest entry, or twice one device's distance from float64
REFERENCE_LIMIT = 1e-4             # tests/test_multidevice.py:116-122
DROPLESS = "dropless"              # E / k: an expert's slots a block hold every slot the block routes
#: case → (arch, (data, model), PerfConfig fields, config changes)
CASES = {
    "mixtral": ("mixtral-8x7b", (2, 2), {}, {}),
    "mixtral dropless": ("mixtral-8x7b", (2, 2), dict(moe_capacity_factor=DROPLESS, remat="none"), {}),
    "qwen3-moe EP dropless": ("qwen3-moe-235b-a22b", (1, 4), dict(moe_capacity_factor=DROPLESS),
                              dict(num_experts=16, experts_per_token=2)),
    "qwen3-moe EP": ("qwen3-moe-235b-a22b", (1, 4), {}, dict(num_experts=16, experts_per_token=2)),
    "mamba2": ("mamba2-370m", (2, 2), dict(remat="dots"), {}),
    "mamba2 gather once": ("mamba2-370m", (2, 2), dict(gather_weights_once=True, num_microbatches=2), {}),
    "jamba": ("jamba-1.5-large-398b", (2, 2), dict(moe_capacity_factor=DROPLESS), {}),
    "llava": ("llava-next-mistral-7b", (2, 2), dict(num_microbatches=2), {}),
    "hubert": ("hubert-xlarge", (2, 2), dict(remat="none"), {}),
}
ELASTIC = dict(batch=4, seq=32, seed=3, log_every=100, device="cpu")
ELASTIC_STEPS = (4, 2)             # uninterrupted; then the first run's, saved, and a resume to the first
ELASTIC_LIMIT = 1e-4               # test_torch_train_mesh.py's bound across a re-mesh of a dense decoder


def _config(configs, name):
    arch, _, _, changes = CASES[name]
    return dataclasses.replace(configs.get_config(arch, reduced=True), **changes)


def _perf_fields(name, cfg) -> dict:
    kw = dict(CASES[name][2])
    if kw.get("moe_capacity_factor") == DROPLESS:
        kw["moe_capacity_factor"] = cfg.num_experts / cfg.experts_per_token
    return kw


def _has_moe(cfg) -> bool:
    return any(cfg.layer_is_moe(i) for i in range(decoder.period_len(cfg)))


def _batch(cfg) -> dict:
    """The train batch as numpy, in the reference's layout
    (``data.pipeline.batch_for_arch``): labels over every position."""
    rng = np.random.default_rng(4)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "audio":
        return {"features": rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32), "labels": labels}
    n = S - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32), "labels": labels}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.standard_normal((B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def _aux_recorded(box: list):
    """``decoder.forward_hidden`` that appends each call's aux to ``box``."""
    real = decoder.forward_hidden

    def forward_hidden(*args, **kw):
        hidden, aux = real(*args, **kw)
        box.append(aux.detach())
        return hidden, aux

    return mock.patch.object(decoder, "forward_hidden", forward_hidden)


def _tagged(stats: dict) -> dict:
    return {tag: (v["calls"], v["bytes"]) for tag, v in stats.items()}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------
def _case(name, params_np) -> dict | None:
    _, shape, _, _ = CASES[name]
    cfg = _config(configs, name)
    perf = PerfConfig(**_perf_fields(name, cfg))
    mesh = make_rank_mesh(shape)
    if not mesh.is_member:
        return None
    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, perf, mesh=mesh)
        state = fns.init_state(zoo.params_from_numpy(params_np, device="cpu"))
        batch = shard_batch(_batch(cfg), mesh)
        specs = paths(fns.param_pspecs)
        auxes: list = []
        ranks.stats = {}
        with _aux_recorded(auxes):
            loss, grads = fns.loss_and_grads(state.params, batch)
        live, ranks.stats = _tagged(ranks.stats), None
        grads = {k: ranks.unshard(g, specs[k], mesh) for k, g in grads.items()}
        batch_axes = tuple(a for a in ("pod", "data") if mesh.shape.get(a, 1) > 1)
        aux = float(ranks.psum(sum(auxes), batch_axes, mesh)) / perf.num_microbatches if _has_moe(cfg) else None
        state, metrics = fns.train_step(state, batch, LR)
        params = {k: ranks.unshard(t, specs[k], mesh) for k, t in paths(state.params).items()}
        # the same step on meta, on the descriptor mesh at this rank's coordinate
        dry = dryrun_lib.dry_mesh(shd.Mesh(mesh.axis_sizes, mesh.axis_names), mesh.coordinate)
    with shd.use_sharding(dry):
        dry_fns = make_train_step(cfg, perf, mesh=dry)
        dry_state = dry_fns.init_state(zoo.param_shapes(cfg, torch.float32))
        meta = {k: torch.empty(tuple(v.shape), dtype=v.dtype, device="meta") for k, v in batch.items()}
        _, cost = roofline.count(dry_fns.loss_and_grads, dry_state.params, meta)
    return {"loss": float(loss), "grads": grads, "aux": aux, "params": params,
            "metrics": {k: float(metrics[k]) for k in ("loss", "grad_norm")},
            "live": live, "dry": _tagged(cost.staged)}


def _elastic(directory) -> dict | None:
    """The reduced mixtral through ``train(mesh=)``: 4 steps on (2, 2)
    uninterrupted; 2 steps and a save on (2, 2), the saved state gathered;
    the state restored onto the survivors' mesh and gathered; the resume
    there to step 4 and, beside it, steps 3 and 4 run in this process from
    the restored blocks on the same mesh."""
    arch = "mixtral-8x7b"
    cfg = configs.get_config(arch, reduced=True)
    full_steps, first_steps = ELASTIC_STEPS
    mesh_a = make_rank_mesh((2, 2))
    full = train_mod.train(arch, steps=full_steps, mesh=mesh_a, **ELASTIC)
    first = train_mod.train(arch, steps=first_steps, mesh=mesh_a, ckpt_dir=str(directory), ckpt_every=first_steps,
                            **ELASTIC)
    with shd.use_sharding(mesh_a):
        specs = paths(state_pspecs(first["state"], zoo.param_pspecs(cfg, mesh_a)))
    saved = {k: ranks.unshard(t, specs[k], mesh_a) if isinstance(t, torch.Tensor) else t
             for k, t in paths(first["state"]).items()}
    plan = plan_elastic_mesh(survivors=2, model_axis=2)
    mesh_b = make_rank_mesh((plan.data, plan.model))
    if not mesh_b.is_member:                # a rank the survivors' mesh leaves out
        return None
    second = train_mod.train(arch, steps=full_steps, mesh=mesh_b, ckpt_dir=str(directory), **ELASTIC)
    with shd.use_sharding(mesh_b):
        fns = make_train_step(cfg, PerfConfig(), mesh=mesh_b)
        specs_b = state_pspecs(first["state"], fns.param_pspecs)
        manager = CheckpointManager(str(directory))
        state = manager.restore(first_steps, first["state"], device="cpu", pspecs=specs_b, mesh=mesh_b)
        flat_b = paths(specs_b)
        restored = {k: ranks.unshard(t, flat_b[k], mesh_b).clone() if isinstance(t, torch.Tensor) else t
                    for k, t in paths(state).items()}      # a copy: the steps below update the blocks in place
        stream = SyntheticLMStream(cfg.vocab_size, ELASTIC["batch"], ELASTIC["seq"], seed=ELASTIC["seed"])
        stream.restore({"step": first_steps, "seed": ELASTIC["seed"]})
        in_memory = []
        for i in range(first_steps, full_steps):
            batch = shard_batch(batch_for_arch(cfg, stream.next_batch()), mesh_b)
            state, m = fns.train_step(state, batch, cosine_with_warmup(i, 3e-4, 20, full_steps))
            in_memory.append(float(m["loss"]))
    return {"full": full["losses"], "first": first["losses"], "second": second["losses"], "steps": manager.steps(),
            "in_memory": in_memory, "plan": (plan.data, plan.model), "saved": saved, "restored": restored}


def _ranks_body(params: dict, directory) -> dict:
    torch.set_num_threads(1)
    out = {"cases": {name: _case(name, params[name]) for name in CASES}}
    out["elastic"] = _elastic(directory / "elastic")
    return out


# ---------------------------------------------------------------------------
# The test process: the reference's and the port's single-device steps
# (jax is imported here and not at the top: the spawned ranks import this
# module)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jref():
    from test_torch_x64_shim import x64_shim

    with x64_shim():
        import repro.configs
        import repro.configs.perf
        import repro.training.train_loop
        from repro.models import decoder as jdecoder

    return dict(configs=repro.configs, perf=repro.configs.perf, loop=repro.training.train_loop, decoder=jdecoder)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def _capacity_moe(mesh_shape: dict, dropped: list | None = None):
    """``moe_block`` on one device as the bodies on a mesh of
    ``mesh_shape`` compute it: ``moe_capacity_reference`` (each call's
    dropped slots appended to ``dropped``)."""
    def moe_block(params, x, cfg, capacity_factor=None, layout=None):
        cf = capacity_factor if capacity_factor is not None else cfg.capacity_factor
        y, aux, drops = moe_mod.moe_capacity_reference(params, x, cfg, cf, mesh_shape)
        if dropped is not None:
            dropped.append(drops)
        return y, aux

    return mock.patch.object(moe_mod, "moe_block", moe_block)


def _single(name, params_np) -> dict:
    """The port's single-device step, each MoE layer through
    ``moe_capacity_reference`` at the case's mesh shape, its gradients
    also in float64; ``dropped`` counts the slots its forwards drop."""
    _, shape, _, _ = CASES[name]
    cfg = _config(configs, name)
    perf = PerfConfig(**_perf_fields(name, cfg))
    fns = make_train_step(cfg, perf)
    state = fns.init_state(zoo.params_from_numpy(params_np, device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    auxes: list = []
    dropped: list = []
    with _capacity_moe({"data": shape[0], "model": shape[1]}, dropped):
        with _aux_recorded(auxes):
            loss, grads = fns.loss_and_grads(state.params, batch)
        grads = {k: g.clone() for k, g in grads.items()}
        aux = float(sum(auxes)) / perf.num_microbatches if _has_moe(cfg) else None
        _, wide = fns.loss_and_grads(zoo.params_from_numpy(params_np, device="cpu", dtype=torch.float64), batch)
        state, m = fns.train_step(state, batch, LR)
    return {"loss": float(loss), "grads": grads, "aux": aux, "dropped": sum(dropped), "wide": wide,
            "metrics": {k: float(m[k]) for k in ("loss", "grad_norm")},
            "params": {k: t.detach().clone() for k, t in paths(state.params).items()},
            "v": {k: t.clone() for k, t in paths(state.opt.v).items()}}


def _reference(jref, name, params_np, aux):
    """The reference's single-device loss: its train step's, or for a MoE
    its dropless negative log-likelihood plus 0.01 × ``aux``."""
    import jax
    import jax.numpy as jnp

    jcfg = _config(jref["configs"], name)
    jperf = jref["perf"].PerfConfig(**_perf_fields(name, jcfg))
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg).items()}
    if aux is None:
        fns = jref["loop"].make_train_step(jcfg, jperf)
        _, m = jax.jit(fns.train_step)(fns.init_state(params_np), batch, LR)
        return float(m["loss"])
    nll = jax.jit(lambda p, b: jref["decoder"].lm_loss(p, b, jcfg, jperf, aux_weight=0.0))(params_np, batch)
    return float(nll) + 0.01 * aux


@pytest.fixture(scope="module")
def multi_rank(request, tmp_path_factory):
    """The ranks' results (spawned first, so that their start overlaps this
    process's work), and meanwhile here the port's single-device steps and
    the reference's losses, on the same weights."""
    directory = tmp_path_factory.mktemp("train_mesh_families")
    params = {}
    for name in CASES:
        drawn = zoo.init_params(_config(configs, name), torch.Generator().manual_seed(0), torch.float32)
        params[name] = _numpy_tree(drawn)
    box = {}

    def run():
        try:
            box["ours"] = ranks.spawn(4, _ranks_body, params, directory, device="cpu", timeout_s=300)
        except BaseException as e:      # re-raised below
            box["error"] = e

    thread = threading.Thread(target=run)
    thread.start()
    torch.set_num_threads(2)
    single = {name: _single(name, params[name]) for name in CASES}
    jref = request.getfixturevalue("jref")
    reference = {name: _reference(jref, name, params[name], single[name]["aux"]) for name in CASES
                 if single[name]["dropped"] == 0}
    thread.join()
    if "error" in box:
        raise box["error"]
    return box["ours"], single, reference


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", CASES)
def test_mesh_step_loss_equals_the_reference_single_device(multi_rank, name):
    ours, single, reference = multi_rank
    if single[name]["dropped"]:         # slots drop: only the bodies' plain version computes that
        assert name in ("mixtral", "qwen3-moe EP"), name
        return
    got = ours["cases"][name]["metrics"]["loss"]
    assert np.isfinite(got) and abs(got - reference[name]) < REFERENCE_LIMIT, (name, got, reference[name])


@pytest.mark.parametrize("name", CASES)
def test_mesh_step_equals_the_port_single_device_step(multi_rank, name):
    ours, single, _ = multi_rank
    got, want = ours["cases"][name], single[name]
    for key in ("loss", "grad_norm"):
        assert got["metrics"][key] == pytest.approx(want["metrics"][key], rel=1e-6), key
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-6)
    assert got["grads"].keys() == want["grads"].keys()
    for k, g in want["grads"].items():
        assert got["grads"][k].shape == g.shape, k
        assert float(g.abs().max()) > 0, k
        near = float((got["grads"][k] - g).abs().max()) <= GRAD_REL * float(g.abs().max())
        wide = want["wide"][k]
        as_close = float((got["grads"][k] - wide).abs().max()) <= 2 * float((g - wide).abs().max())
        assert near or as_close, k
    for k, p in want["params"].items():
        root = torch.sqrt(want["v"][k] / (1 - B2))
        grad_diff = float((got["grads"][k] - want["grads"][k]).abs().max())
        decided = (root >= 1e3 * EPS) & (root >= 100 * grad_diff)
        err = (got["params"][k] - p).abs()
        assert float(torch.where(decided, err, 0).max()) <= UPDATE_REL * float(p.abs().max()), k
        assert float(torch.where(decided, 0, err).max()) <= 2 * LR, k


def test_moe_aux_is_the_mean_of_the_blocks(multi_rank):
    ours, single, _ = multi_rank
    moe = [name for name in CASES if single[name]["aux"] is not None]
    assert set(moe) == {"mixtral", "mixtral dropless", "qwen3-moe EP dropless", "qwen3-moe EP", "jamba"}
    for name in moe:
        got, want = ours["cases"][name]["aux"], single[name]["aux"]
        assert want > 0 and got == pytest.approx(want, rel=1e-6), (name, got, want)
    # the config's capacity factor drops slots on both branches, E / k none
    assert single["mixtral"]["dropped"] > 0 and single["qwen3-moe EP"]["dropped"] > 0
    assert single["mixtral dropless"]["dropped"] == single["qwen3-moe EP dropless"]["dropped"] == 0


def test_dry_collectives_equal_the_live_ranks_stats(multi_rank):
    ours = multi_rank[0]["cases"]
    for name in CASES:
        assert ours[name]["live"] and ours[name]["dry"] == ours[name]["live"], name
    assert {"conv gather", "norm sum"} <= set(ours["mamba2"]["live"])
    assert "all_to_all" in ours["qwen3-moe EP"]["live"] and "expert parallel" in ours["qwen3-moe EP"]["live"]
    assert "all_to_all" not in ours["mixtral"]["live"]


# ---------------------------------------------------------------------------
# train(mesh=) and the elastic resume
# ---------------------------------------------------------------------------
def test_elastic_resume_restores_the_saved_state_and_continues_the_losses(multi_rank):
    got = multi_rank[0]["elastic"]
    full_steps, first_steps = ELASTIC_STEPS
    assert got["plan"] == (1, 2) and got["steps"] == [first_steps, full_steps]
    assert got["saved"].keys() == got["restored"].keys()
    for k, t in got["saved"].items():
        if isinstance(t, torch.Tensor):
            assert t.dtype == got["restored"][k].dtype and torch.equal(got["restored"][k], t), k
        else:
            assert got["restored"][k] == t, k
    assert len(got["first"]) == first_steps and len(got["second"]) == full_steps - first_steps
    assert all(np.isfinite(got["full"])) and all(np.isfinite(got["second"]))
    assert got["first"] == got["full"][:first_steps]          # the same mesh, the same numbers
    assert got["second"] == got["in_memory"]                  # the resume, bit for bit
    # the survivors' one token block routes, drops and takes its aux otherwise than (2, 2)'s two
    assert max(abs(a - b) for a, b in zip(got["second"], got["full"][first_steps:])) > ELASTIC_LIMIT
