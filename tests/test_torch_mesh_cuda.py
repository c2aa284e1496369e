"""The multi-rank runtime on the card, at a reduced size: four ranks on one
card (gloo, collectives staged through host memory) for the sharded
acceptance scan, the sharded ensemble, the MoE's expert-parallel and
f-sharded bodies, ``compress_psum``, a train step of the reduced qwen3
on (data 2, model 2), its sharded prefill and decode, the reduced
mamba2's and jamba's with the SSD kernel on each rank's heads, and a
train step of the reduced MoE, Mamba-2, hybrid and frontend models, each held
to its single-device version on the card (and ``compress_psum`` to the
CPU's ranks bit for bit).

These need a CUDA card and skip where there is none.  They import neither
jax nor the JAX package, so they run on a card machine without them:

    python -m pytest -m cuda tests/test_torch_mesh_cuda.py
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import energy_model as em
from repro_torch.core.arrivals import PoissonArrivals
from repro_torch.core.strategies import IdlePowerMethod
from repro_torch.distributed import ranks
from repro_torch.distributed import sharding as shd
from repro_torch.fleet import fleet_mesh, uniform_fleet
from repro_torch.launch import fleet as fleet_cli
from repro_torch.launch import mc as mc_cli
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.mc import run_periodic_ensemble
from repro_torch.models import moe
from repro_torch.obs.ledger import AXES
from repro_torch.optim import grad_compress as gc
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, shard_batch
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.training.train_loop import make_train_step
from repro_torch.tree import paths

pytestmark = pytest.mark.cuda

MOE_LIMIT = {torch.float32: 1e-5, torch.bfloat16: 3e-2}   # chip_smoke.MOE_DISPATCH_LIMIT
MESHES = ((1, 4), (2, 2))
CASES = (("ep", 64.0), ("ep", 1.0), ("ftp", 64.0), ("ftp", 1.0))
ENS = (64, 256, 200, 16)                  # seeds, devices, steps, seeds a chunk


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the ranks compute on it)")
    return torch.device("cuda")


def _fleet(n, device):
    return uniform_fleet(n, strategies=("on_off", "idle_waiting", "adaptive"), method=IdlePowerMethod.METHOD1_2,
                         e_budget_mj=1500.0, powerup_overhead_mj=em.CALIBRATED_POWERUP_OVERHEAD_MJ, device=device)


def _cfg(branch):
    if branch == "ep":
        return dataclasses.replace(get_config("qwen3-moe-235b-a22b", reduced=True),
                                   num_experts=16, experts_per_token=2)
    return get_config("mixtral-8x7b", reduced=True)


def _inputs(branch, cf, dtype, device):
    cfg = _cfg(branch)
    rng = np.random.default_rng(0 if branch == "ep" else 1)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    params = {"router": rng.standard_normal((d, e)) * 0.02,
              "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((4, 16, d)) if cf == 64.0 else rng.standard_normal((8, 64, d)) + 0.5 * rng.standard_normal(d)
    put = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)  # noqa: E731
    return {k: put(v) for k, v in params.items()}, put(x)


def _grads(pod, device):
    rng = np.random.default_rng((3, pod))
    return {"w": torch.from_numpy(rng.standard_normal((512, 384), dtype=np.float32)).to(device),
            "b": torch.from_numpy(rng.standard_normal(384, dtype=np.float32) * np.float32(1e-3)).to(device)}


def _compress():
    mesh = make_rank_mesh((2,), ("pod",))
    if not mesh.is_member:
        return None
    g = _grads(mesh.index("pod"), ranks.device())
    out, err = gc.compress_psum(g, gc.init_error(g), "pod", mesh)
    return {"out": out, "err": err.error}


def _train_inputs():
    """The reduced qwen3's fp32 weights (drawn on the CPU, so every rank and
    the test process hold the same) and one (8, 32) batch."""
    cfg = get_config("qwen3-1.7b", reduced=True)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    return cfg, params, SyntheticLMStream(cfg.vocab_size, 8, 32, seed=2).next_batch()


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def _train_step():
    """One train step on (data 2, model 2): the loss, the gradient norm, the
    gathered gradients and this rank's flash launches."""
    cfg, params, raw = _train_inputs()
    mesh = make_rank_mesh((2, 2))
    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, PerfConfig(), mesh=mesh)
        state = fns.init_state(_to(params, ranks.device()))
        fa.launches = 0
        loss, grads = fns.loss_and_grads(state.params, shard_batch(raw, mesh))
        launches = fa.launches
        specs = paths(fns.param_pspecs)
        whole = {k: ranks.unshard(g, specs[k], mesh) for k, g in grads.items()}
        _, m = fns.apply_grads(state, loss, grads, 1e-3)
    return {"loss": float(loss), "grad_norm": float(m["grad_norm"]), "grads": whole, "launches": launches}


def _ranks_body():
    dev = ranks.device()
    n_seeds, n_dev, n_steps, chunk = ENS
    out = {"ens": run_periodic_ensemble(_fleet(n_dev, dev), PoissonArrivals(40.0), n_steps, n_seeds, seed=1,
                                        seed_chunk=chunk, mesh=fleet_mesh(2, 2)),
           "moe": {}, "runtime": ranks.info()}
    for shape in MESHES:
        mesh = make_rank_mesh(shape)
        for branch, cf in CASES:
            for dtype in MOE_LIMIT:
                cfg = _cfg(branch)
                params, x = _inputs(branch, cf, dtype, dev)
                specs = moe.moe_pspecs(cfg, mesh, x.shape)
                with shd.use_sharding(mesh), torch.inference_mode():
                    y, _ = moe.moe_block({k: ranks.shard(v, specs[k]) for k, v in params.items()},
                                         ranks.shard(x, specs["x"]), cfg, capacity_factor=cf)
                out["moe"][shape, branch, cf, dtype] = ranks.unshard(y, specs["x"], mesh)
    out["compress"] = _compress()
    out["train"] = _train_step()
    return out


@pytest.fixture(scope="module")
def on_card(cuda):
    return ranks.spawn(4, _ranks_body, device="cuda", timeout_s=600)


def test_sharded_acceptance_through_the_fleet_cli(cuda, tmp_path):
    path = tmp_path / "fleet.json"
    assert fleet_cli.main(["--smoke", "--mode", "periodic", "--devices", "512", "--mesh", "4",
                           "--acceptance-devices", "65536", "--out", str(path)]) == 0
    payload = json.loads(path.read_text())
    acc, sh = payload["sharded_acceptance"], payload["throughput"]["sharded"]
    assert acc["unsharded"]["bit_identical"] and sh["bit_identical_to_unsharded"]
    assert acc["all_budget_exhausted"] and acc["ledger_conservation"]["within_1e-9"]
    assert acc["runtime"]["ranks"] == 4
    assert acc["runtime"]["ranks_per_card"] == -(-4 // torch.cuda.device_count())
    assert payload["manifest"]["card"] is not None


def test_sharded_ensemble_equals_the_unsharded_run(on_card, cuda):
    n_seeds, n_dev, n_steps, chunk = ENS
    ref = run_periodic_ensemble(_fleet(n_dev, cuda), PoissonArrivals(40.0), n_steps, n_seeds, seed=1,
                                seed_chunk=chunk)
    ens = on_card["ens"]
    for f in ("lifetime_ms", "total_items", "total_energy_mj"):
        np.testing.assert_array_equal(getattr(ref, f), getattr(ens, f), err_msg=f)
    np.testing.assert_array_equal(ref.device_energy_mj.m2, ens.device_energy_mj.m2)
    for ax in AXES:
        np.testing.assert_array_equal(getattr(ref.ledger, f"{ax}_mj"), getattr(ens.ledger, f"{ax}_mj"))
    assert on_card["runtime"]["staged"] == "host"


def test_mc_cli_mesh_2x2_equals_mesh_1_on_the_card(cuda, tmp_path):
    outs = {}
    for mesh in ("1", "2x2"):
        assert mc_cli.main(["--smoke", "--section", "ensemble", "--seeds", "32", "--steps", "200", "--mesh", mesh,
                            "--out", str(tmp_path / f"{mesh}.json")]) == 0
        blk = json.loads((tmp_path / f"{mesh}.json").read_text())["ensemble"]
        for k in ("elapsed_s", "mesh", "runtime"):
            blk.pop(k)
        outs[mesh] = blk
    assert outs["1"] == outs["2x2"]


@pytest.mark.parametrize("dtype", list(MOE_LIMIT), ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"data{s[0]}-model{s[1]}")
@pytest.mark.parametrize("branch,cf", CASES, ids=[f"{b}-cf{cf:g}" for b, cf in CASES])
def test_sharded_moe_bodies_on_the_card(on_card, cuda, branch, cf, shape, dtype):
    cfg = _cfg(branch)
    params, x = _inputs(branch, cf, dtype, cuda)
    y = on_card["moe"][shape, branch, cf, dtype].to(cuda)
    capped, _, dropped = moe.moe_capacity_reference(params, x, cfg, cf, dict(zip(("data", "model"), shape)))
    want = moe.moe_block(params, x, cfg)[0] if cf == 64.0 else capped
    assert (dropped == 0) if cf == 64.0 else (dropped > 0)
    err = float((y.float() - want.float()).abs().max() / want.float().abs().max())
    assert bool(torch.isfinite(y).all()) and err <= MOE_LIMIT[dtype], err


def test_compress_psum_card_equals_cpu_and_the_exact_mean(on_card, cuda):
    cpu = ranks.spawn(2, _compress, device="cpu", timeout_s=120)
    card = on_card["compress"]
    g0, g1 = _grads(0, "cpu"), _grads(1, "cpu")
    for k in g0:
        assert torch.equal(card["out"][k], cpu["out"][k]) and torch.equal(card["err"][k], cpu["err"][k]), k
        exact = (g0[k].double() + g1[k].double()) / 2
        assert float((card["out"][k].double() - exact).abs().max() / exact.abs().max()) < 0.02


def test_train_step_on_a_mesh_of_ranks_equals_one_card(on_card, cuda):
    """The reduced qwen3 on (data 2, model 2), four ranks on the card,
    against the single-card step: loss and gradient norm within 1e-5
    relative, each gathered gradient within 1e-4 of its leaf's largest
    entry (chip_smoke's MESH_TRAIN_LIMIT), two flash launches a layer a
    step on each rank (remat full)."""
    cfg, params, raw = _train_inputs()
    fns = make_train_step(cfg, PerfConfig())
    state = fns.init_state(_to(params, cuda))
    loss, grads = fns.loss_and_grads(state.params, shard_batch(raw, make_host_mesh()))
    _, m = fns.apply_grads(state, loss, {k: g.clone() for k, g in grads.items()}, 1e-3)
    got = on_card["train"]
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-5)
    for k, g in grads.items():
        assert float((got["grads"][k].to(cuda) - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
    assert got["launches"] == 2 * cfg.num_layers


def test_a_cuda_tensor_under_the_roofline_counter_launches_flash(cuda):
    """The counter sends only ``meta`` tensors to the kernels' meta ops: on
    CUDA tensors the flash kernel launches as ever, its output the plain
    version's within the fp32 tolerance."""
    from repro_torch.kernels.flash_attention.ref import attention_reference
    from repro_torch.launch import roofline

    g = torch.Generator(cuda).manual_seed(0)
    q, k, v = (torch.randn(2, 64, h, 128, generator=g, device=cuda) for h in (8, 4, 4))
    before = fa.launches
    out, cost = roofline.count(fa.attention, q, k, v)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.is_cuda and float((out - attention_reference(q, k, v)).abs().max()) <= 2e-5
    assert cost.flops == 0          # the kernel is opaque to the counter on the card


def test_sharded_prefill_and_decode_on_the_card_equal_one_card(cuda):
    """The reduced qwen3 served on (data 2, model 2) by four ranks on the
    card: each rank's logits against one card's run, the flash kernel on
    its local heads (a launch a layer in the prefill, none in decode)."""
    got = ranks.spawn(4, _serve_ranks, device="cuda", timeout_s=300)
    for rank in got:
        assert rank["err"] <= 1e-5 and rank["same_tokens"], rank
        assert rank["launches"] == (2, 0)


def _serve_ranks() -> list:
    import torch.distributed as dist

    dev = ranks.device()
    cfg = get_config("qwen3-1.7b", reduced=True)
    mesh = make_rank_mesh((2, 2))
    whole = zoo.init_params(cfg, torch.Generator(dev).manual_seed(3), torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=torch.Generator(dev).manual_seed(4), device=dev,
                           dtype=torch.int32)
    rows = ranks.shard(tokens, shd.P("data"), mesh)
    with shd.use_sharding(mesh), torch.no_grad():
        blocks = zoo.shard_params(whole, cfg, mesh)
        fa.launches = 0
        logits, state = zoo.prefill_fn(blocks, {"tokens": rows}, cfg, 40, mesh=mesh)
        pre = fa.launches
        outs = [logits]
        for _ in range(4):
            logits, state = zoo.decode_fn(blocks, state, torch.argmax(logits, -1).to(torch.int32), cfg, mesh=mesh)
            outs.append(logits)
        launches = (pre, fa.launches - pre)
        ref_logits, ref_state = zoo.prefill_fn(whole, {"tokens": tokens}, cfg, 40)
        ref = [ref_logits]
        for _ in range(4):
            ref_logits, ref_state = zoo.decode_fn(whole, ref_state, torch.argmax(ref_logits, -1).to(torch.int32), cfg)
            ref.append(ref_logits)
    lo = mesh.index("data") * rows.shape[0]
    mine = [r[lo:lo + rows.shape[0]] for r in ref]
    rec = {"err": max(float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(outs, mine)),
           "same_tokens": all(bool(torch.equal(a.argmax(-1), w.argmax(-1))) for a, w in zip(outs, mine)),
           "launches": launches}
    everyone = [None] * ranks.world_size()
    dist.all_gather_object(everyone, rec)
    return everyone


@pytest.mark.parametrize("arch", ("mamba2-370m", "jamba-1.5-large-398b"))
def test_sharded_ssd_prefill_on_local_heads_equals_one_card(cuda, arch):
    """The reduced Mamba-2 and hybrid served on (data 2, model 2) by four
    ranks on the card, prompt 160 (two SSD chunks, the second ragged): the
    SSD kernel on each rank's heads (a launch a Mamba-2 layer in the
    prefill, none in decode), each rank's logits against one card's run."""
    got = ranks.spawn(4, _ssd_serve_ranks, arch, device="cuda", timeout_s=300)
    cfg = get_config(arch, reduced=True)
    n_ssm = sum(cfg.layer_kind(i) == "ssm" for i in range(cfg.num_layers))
    for rank in got:
        assert rank["err"] <= 1e-5 and rank["same_tokens"], rank
        assert rank["launches"] == (n_ssm, 0)


def _ssd_serve_ranks(arch: str) -> list:
    import torch.distributed as dist

    from repro_torch.kernels.ssd import ops as ssd_ops

    dev = ranks.device()
    cfg = get_config(arch, reduced=True)
    perf = PerfConfig(moe_capacity_factor=cfg.num_experts / cfg.experts_per_token if cfg.num_experts else None)
    mesh = make_rank_mesh((2, 2))
    whole = zoo.init_params(cfg, torch.Generator(dev).manual_seed(5), torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (4, 160), generator=torch.Generator(dev).manual_seed(6), device=dev,
                           dtype=torch.int32)
    rows = ranks.shard(tokens, shd.P("data"), mesh)
    with shd.use_sharding(mesh), torch.no_grad():
        blocks = zoo.shard_params(whole, cfg, mesh)
        ssd_ops.launches = 0
        logits, state = zoo.prefill_fn(blocks, {"tokens": rows}, cfg, 164, perf, mesh=mesh)
        pre = ssd_ops.launches
        outs = [logits]
        for _ in range(4):
            logits, state = zoo.decode_fn(blocks, state, torch.argmax(logits, -1).to(torch.int32), cfg, perf,
                                          mesh=mesh)
            outs.append(logits)
        launches = (pre, ssd_ops.launches - pre)
    with torch.no_grad():                       # one card: no mesh installed, the MoE's own dispatch
        ref_logits, ref_state = zoo.prefill_fn(whole, {"tokens": tokens}, cfg, 164)
        ref = [ref_logits]
        for _ in range(4):
            ref_logits, ref_state = zoo.decode_fn(whole, ref_state, torch.argmax(ref_logits, -1).to(torch.int32), cfg)
            ref.append(ref_logits)
    lo = mesh.index("data") * rows.shape[0]
    mine = [r[lo:lo + rows.shape[0]] for r in ref]
    rec = {"err": max(float((a - w).abs().max()) / float(w.abs().max()) for a, w in zip(outs, mine)),
           "same_tokens": all(bool(torch.equal(a.argmax(-1), w.argmax(-1))) for a, w in zip(outs, mine)),
           "launches": launches}
    everyone = [None] * ranks.world_size()
    dist.all_gather_object(everyone, rec)
    return everyone


#: the train step of the other families: case → (arch, (data, model), config changes, S)
TRAIN_FAMILIES = {
    "mamba2": ("mamba2-370m", (2, 2), {}, 160),
    "jamba": ("jamba-1.5-large-398b", (2, 2), {}, 160),
    "mixtral": ("mixtral-8x7b", (2, 2), {}, 64),
    "qwen3-moe EP": ("qwen3-moe-235b-a22b", (1, 4), dict(num_experts=16, experts_per_token=2), 64),
    "llava": ("llava-next-mistral-7b", (2, 2), {}, 32),
    "hubert": ("hubert-xlarge", (2, 2), {}, 32),
}


def _family_inputs(name):
    """A case's reduced config, its PerfConfig (E / k for a MoE: nothing
    drops), fp32 weights drawn on the CPU and one (4, S) batch."""
    from repro_torch.data.pipeline import batch_for_arch

    arch, _, changes, s = TRAIN_FAMILIES[name]
    cfg = dataclasses.replace(get_config(arch, reduced=True), **changes)
    perf = PerfConfig(moe_capacity_factor=cfg.num_experts / cfg.experts_per_token if cfg.num_experts else None)
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)
    return cfg, perf, params, batch_for_arch(cfg, SyntheticLMStream(cfg.vocab_size, 4, s, seed=2).next_batch())


def _train_families_ranks() -> dict:
    """Every case of ``TRAIN_FAMILIES``: one train step on its mesh → the
    loss, the gradient norm, the gathered gradients and every rank's flash
    and SSD launches."""
    import torch.distributed as dist

    from repro_torch.kernels.ssd import ops as ssd_ops

    out = {}
    for name, (_, shape, _, _) in TRAIN_FAMILIES.items():
        cfg, perf, params, raw = _family_inputs(name)
        mesh = make_rank_mesh(shape)
        with shd.use_sharding(mesh):
            fns = make_train_step(cfg, perf, mesh=mesh)
            state = fns.init_state(_to(params, ranks.device()))
            fa.launches = ssd_ops.launches = 0
            loss, grads = fns.loss_and_grads(state.params, shard_batch(raw, mesh))
            launches = [None] * ranks.world_size()
            dist.all_gather_object(launches, (fa.launches, ssd_ops.launches))
            specs = paths(fns.param_pspecs)
            whole = {k: ranks.unshard(g, specs[k], mesh).cpu() for k, g in grads.items()}
            _, m = fns.apply_grads(state, loss, grads, 1e-3)
        out[name] = {"loss": float(loss), "grad_norm": float(m["grad_norm"]), "grads": whole, "launches": launches}
    return out


@pytest.fixture(scope="module")
def families_on_card(cuda):
    return ranks.spawn(4, _train_families_ranks, device="cuda", timeout_s=600)


@pytest.mark.parametrize("name", TRAIN_FAMILIES)
def test_train_step_of_the_other_families_on_a_mesh_equals_one_card(families_on_card, cuda, name):
    """The reduced MoE, Mamba-2, hybrid and frontend models' train step on
    their meshes, four ranks on the card, against the single-card step with
    each MoE layer through ``moe_capacity_reference`` at the mesh's shape
    (its aux the mean of the token blocks', as the mesh takes it): loss and
    gradient norm within 1e-5 relative, each gathered gradient within 1e-4
    of its leaf's largest entry (chip_smoke's MESH_TRAIN_LIMIT, as the
    dense decoders' above), and on each rank two flash launches an
    attention layer and two SSD launches a Mamba-2 layer (forward and remat
    replay on its heads; none in the backward)."""
    from unittest import mock

    cfg, perf, params, raw = _family_inputs(name)
    shape = dict(zip(("data", "model"), TRAIN_FAMILIES[name][1]))

    def capacity(p, x, cfg_, capacity_factor=None, layout=None):
        y, aux, _ = moe.moe_capacity_reference(p, x, cfg_, capacity_factor, shape)
        return y, aux

    fns = make_train_step(cfg, perf)
    state = fns.init_state(_to(params, cuda))
    with mock.patch.object(moe, "moe_block", capacity):
        loss, grads = fns.loss_and_grads(state.params, shard_batch(raw, make_host_mesh()))
    _, m = fns.apply_grads(state, loss, {k: g.clone() for k, g in grads.items()}, 1e-3)
    got = families_on_card[name]
    assert got["loss"] == pytest.approx(float(loss), rel=1e-5)
    assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]), rel=1e-5)
    for k, g in grads.items():
        assert float((got["grads"][k].to(cuda) - g).abs().max()) <= 1e-4 * float(g.abs().max()), k
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    assert got["launches"] == [(2 * n_attn, 2 * (cfg.num_layers - n_attn))] * 4
