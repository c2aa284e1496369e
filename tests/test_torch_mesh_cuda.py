"""The multi-rank runtime on the card, at a reduced size: four ranks on one
card (gloo, collectives staged through host memory) for the sharded
acceptance scan, the sharded ensemble, the MoE's expert-parallel and
f-sharded bodies and ``compress_psum``, each held to its single-device
version on the card (and ``compress_psum`` to the CPU's ranks bit for bit).

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
