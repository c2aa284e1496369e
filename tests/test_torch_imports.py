"""The port stands alone: no module of ``repro_torch`` imports ``jax`` or
``repro``, and its entry points refuse to fall back to the CPU silently."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


def _modules() -> list[str]:
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def test_every_module_imports_with_jax_and_repro_blocked():
    code = f"""
import importlib, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"blocked import of {{name}}")
        return None

sys.meta_path.insert(0, Block())
for name in {_modules()!r}:
    importlib.import_module(name)
assert not any(m.split(".")[0] in ("jax", "repro") for m in sys.modules)
print("imported", len({_modules()!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        timeout=300, cwd=str(ROOT),
    )
    assert out.returncode == 0, out.stderr
    assert f"imported {len(_modules())}" in out.stdout


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")) + ["chip_smoke.py", "kernel_ab.py"],
)
def test_no_jax_or_repro_import_statement(path):
    text = (ROOT / path).read_text()
    assert not _FORBIDDEN.search(text), f"{path} imports jax or repro"


def test_module_list_covers_the_slice():
    mods = set(_modules())
    for name in (
        "repro_torch.configs.qwen3_1_7b",
        "repro_torch.models.decoder",
        "repro_torch.kernels.dequant.ops",
        "repro_torch.kernels.flash_attention.ops",
        "repro_torch.checkpoint._msgpack",
        "repro_torch.core.duty_cycle",
        "repro_torch.serving.scheduler",
        "repro_torch.launch.serve",
        "repro_torch.configs.paper_lstm",
        "repro_torch.data.pipeline",
        "repro_torch.kernels.lstm.ops",
        "repro_torch.kernels.lstm.ref",
        "repro_torch.models.lstm",
        "repro_torch.optim.adamw",
        "repro_torch.core.config_phase",
        "repro_torch.core.workload",
        "repro_torch.core.simulator",
        "repro_torch.obs.ledger",
        "repro_torch.examples.quickstart",
        "repro_torch.configs.mamba2_370m",
        "repro_torch.kernels.ssd.ops",
        "repro_torch.kernels.ssd.ref",
        "repro_torch.models.mamba2",
        "repro_torch.core.planner",
        "repro_torch.core.arrivals",
        "repro_torch.serving.multi_tenant",
        "repro_torch.examples.adaptive_serving",
        "repro_torch.examples.duty_cycle_serving",
        "repro_torch.examples.multi_tenant_serving",
        "repro_torch.configs.yi_6b",
        "repro_torch.configs.internlm2_20b",
        "repro_torch.configs.qwen3_32b",
        "repro_torch.models.moe",
        "repro_torch.configs.mixtral_8x7b",
        "repro_torch.configs.qwen3_moe_235b_a22b",
        "repro_torch.configs.jamba_1_5_large_398b",
        "repro_torch.configs.hubert_xlarge",
        "repro_torch.configs.llava_next_mistral_7b",
        "repro_torch.launch._cli",
        "repro_torch.core.batch_eval",
        "repro_torch.core.pareto",
        "repro_torch.launch.sweep",
        "repro_torch.fleet",
        "repro_torch.fleet.state",
        "repro_torch.fleet.router",
        "repro_torch.fleet.step",
        "repro_torch.fleet.dtypes",
        "repro_torch.fleet.metrics",
        "repro_torch.serving.fleet_backend",
        "repro_torch.launch.fleet",
        "repro_torch.obs",
        "repro_torch.obs.metrics",
        "repro_torch.obs.trace",
        "repro_torch.obs.report",
        "repro_torch.mc",
        "repro_torch.mc.ensemble",
        "repro_torch.mc.intervals",
        "repro_torch.mc.sensitivity",
        "repro_torch.costs",
        "repro_torch.costs.counts",
        "repro_torch.costs.calibrate",
        "repro_torch.costs.zoo",
        "repro_torch.core.tpu_energy",
        "repro_torch.launch.obs",
        "repro_torch.launch.mc",
        "repro_torch.launch.costs",
        "repro_torch.optim.schedules",
        "repro_torch.optimize",
        "repro_torch.optimize.relax",
        "repro_torch.optimize.descent",
        "repro_torch.optimize.planner",
        "repro_torch.launch.optimize",
        "repro_torch.policy",
        "repro_torch.policy.features",
        "repro_torch.policy.net",
        "repro_torch.policy.rollout",
        "repro_torch.policy.train",
        "repro_torch.policy.controller",
        "repro_torch.launch.policy",
        "repro_torch.distributed",
        "repro_torch.distributed.fault_tolerance",
        "repro_torch.control",
        "repro_torch.control.hierarchy",
        "repro_torch.control.autoscaler",
        "repro_torch.control.faults",
        "repro_torch.control.simulate",
        "repro_torch.control.report",
        "repro_torch.launch.control",
        "repro_torch.configs.perf",
        "repro_torch.distributed.sharding",
        "repro_torch.launch.mesh",
        "repro_torch.optim.grad_compress",
        "repro_torch.training",
        "repro_torch.training.train_loop",
        "repro_torch.launch.train",
        "repro_torch.examples.train_lm",
        "repro_torch.tree",
        "repro_torch.distributed.ranks",
        "repro_torch.fleet.shard",
    ):
        assert name in mods


def _modules_of_a_rank() -> list:
    import sys

    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))


def test_the_multi_rank_modules_import_no_jax_in_their_ranks():
    """``distributed/ranks.py`` and ``fleet/shard.py`` import neither jax
    nor the JAX package, and a spawned rank that runs the sharded fleet
    holds no module of either."""
    from repro_torch.distributed import ranks

    for rel in ("distributed/ranks.py", "fleet/shard.py"):
        assert not _FORBIDDEN.search((PKG / rel).read_text()), rel
    assert ranks.spawn(2, _sharded_fleet_modules, device="cpu", timeout_s=120) == []


def _sharded_fleet_modules() -> list:
    from repro_torch.fleet import fleet_mesh, run_periodic_sharded, uniform_fleet

    run_periodic_sharded(uniform_fleet(6, device="cpu"), 20, mesh=fleet_mesh(2, 1))
    return _modules_of_a_rank()


def test_cuda_sources_ship_beside_the_package():
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} == {
        "dequant.cu", "flash_attention.cu", "lstm.cu", "ssd.cu"
    }


def test_build_demo_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    from repro_torch.launch.serve import build_demo

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_demo("qwen3-1.7b", ckpt_dir=str(tmp_path))


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    from repro_torch.launch import fleet, mc, serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])
    # a mesh spawns no rank, and no CPU run, without the card
    for main in (fleet.main, mc.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--smoke", "--mesh", "2"])


def test_quickstart_defaults_to_cuda_and_raises_without_it(monkeypatch, capsys):
    from repro_torch.examples import quickstart

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quickstart.train_accelerator(steps=1)
    assert capsys.readouterr().out == ""      # nothing ran on the CPU


@pytest.mark.parametrize("example", ["duty_cycle_serving", "multi_tenant_serving"])
def test_serving_examples_default_to_cuda_and_raise_without_it(monkeypatch, capsys, example):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{example}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
    assert "requests" not in capsys.readouterr().out      # nothing was served


@pytest.mark.parametrize("cli", ["sweep", "fleet", "obs", "mc", "costs", "optimize", "policy", "control"])
def test_analytics_clis_default_to_cuda_and_raise_without_it(monkeypatch, capsys, cli):
    import importlib

    mod = importlib.import_module(f"repro_torch.launch.{cli}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
    assert capsys.readouterr().out == ""      # nothing ran on the CPU


def test_analytics_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The vectorized closed forms, the Pareto frontiers, the fleet and its
    backend: each runs on the card unless given ``device="cpu"``."""
    from repro_torch.core import batch_eval, pareto
    from repro_torch.core.config_phase import SPARTAN7_XC7S15
    from repro_torch.core.phases import paper_lstm_item
    from repro_torch.fleet import DeviceSpec, FleetParams, FleetState, uniform_fleet
    from repro_torch.serving.fleet_backend import FleetBackend, FleetTenantSpec

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: batch_eval.sweep_batch(batch_eval.SweepGrid()),
        lambda: batch_eval.grid_axes([1.0]),
        lambda: batch_eval.crossover_batch(paper_lstm_item()),
        lambda: pareto.crossover_surface(paper_lstm_item(), SPARTAN7_XC7S15, [24.0]),
        lambda: pareto.pareto_mask([[1.0, 2.0]]),
        lambda: uniform_fleet(3),
        lambda: FleetParams.from_specs([DeviceSpec(paper_lstm_item())]),
        lambda: FleetState.init(3),
        lambda: FleetBackend([FleetTenantSpec("t", 1, 1, 1, 1, 1)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_workload_imports_yaml_only_for_the_round_trip():
    code = """
import sys
sys.modules["yaml"] = None      # as on a host without PyYAML
from repro_torch.core import paper_experiment, simulate
from repro_torch.examples import quickstart
quickstart.exp1(); quickstart.exp2(); quickstart.exp3()
print("ran", simulate(paper_experiment()).n_items)
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert "ran 771805" in out.stdout


def test_registry_holds_every_config_of_the_reference():
    """All ten of the reference's architectures, full and reduced; the
    paper's LSTM is not an arch of the registry, as in the reference."""
    import dataclasses

    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import model_zoo as zoo

    assert list_archs() == [
        "hubert-xlarge", "internlm2-20b", "jamba-1.5-large-398b", "llava-next-mistral-7b",
        "mamba2-370m", "mixtral-8x7b", "qwen3-1.7b", "qwen3-32b", "qwen3-moe-235b-a22b", "yi-6b",
    ]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("paper-lstm-h20")
    for name in list_archs():
        full, reduced = get_config(name), get_config(name, reduced=True)
        assert reduced.name == f"{name}-reduced" and reduced.family == full.family
        assert dataclasses.replace(reduced, name=full.name).mlp_kind == full.mlp_kind
        assert zoo.param_shapes(reduced)["final_norm"].shape == (reduced.d_model,)


def test_mc_and_costs_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The Monte Carlo engine, the delta method, the cost zoo's fleets and
    the in-loop histogram: each runs on the card unless given ``"cpu"``."""
    from repro_torch.costs import model_mix_fleet
    from repro_torch.mc import sensitivity
    from repro_torch.obs.metrics import scan_histogram

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: sensitivity.crossover_uncertainty(n_seeds=2),
        lambda: sensitivity.lifetime_ratio_uncertainty(n_seeds=2),
        lambda: sensitivity.energy_per_request_uncertainty(n_seeds=2),
        lambda: sensitivity.config_energy_uncertainty(n_seeds=2),
        lambda: sensitivity.delta_method(lambda p: p["x"] * 2.0, {"x": 1.0}, 0.1),
        lambda: model_mix_fleet(["qwen3-1.7b"]),
        lambda: scan_histogram([[1.0]], [0.5]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_training_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, capsys):
    """``launch.train``'s CLI and ``train()``, the 100M example, the host
    mesh and ``shard_batch``: each runs on the card unless given the CPU."""
    import numpy as np

    from repro_torch.configs import base as cfg_base
    from repro_torch.data.pipeline import shard_batch
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_host_mesh

    monkeypatch.setattr(cfg_base, "_REGISTRY", dict(cfg_base._REGISTRY))
    monkeypatch.setattr(cfg_base, "_REDUCED", dict(cfg_base._REDUCED))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: train.main(["--arch", "qwen3-1.7b", "--reduced", "--steps", "1"]),
        lambda: train.train("qwen3-1.7b", steps=1),
        lambda: train_lm.main(["--steps", "1"]),
        lambda: make_host_mesh(),
        lambda: shard_batch({"tokens": np.zeros((1, 2), np.int32)}, None),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert "step" not in capsys.readouterr().out      # nothing trained on the CPU


def test_no_perf_config_value_routes_to_a_plain_version():
    """``PerfConfig`` has no kernel-choice field: on the card the flash and
    SSD kernels always run, and the reference's fields that pick a plain
    version are refused as unknown keywords."""
    import dataclasses

    from repro_torch.configs.perf import PerfConfig

    fields = {f.name for f in dataclasses.fields(PerfConfig)}
    kernel_choices = {"attention_impl", "ssd_impl", "attn_scores_dtype", "attn_triangular"}
    assert not fields & kernel_choices
    assert not [f for f in fields if f.endswith("_impl")]
    for name in kernel_choices:
        for value in ("xla", "ref", "pallas", "pallas_interpret", "chunked", "auto", "bfloat16", True):
            with pytest.raises(TypeError, match=name):
                PerfConfig(**{name: value})
