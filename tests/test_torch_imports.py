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
    ):
        assert name in mods


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
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--requests", "1"])


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


def test_later_slice_configs_raise_with_their_slice():
    from repro_torch.configs import LATER_SLICES, get_config, list_archs
    from repro_torch.configs.base import register

    assert list_archs() == ["internlm2-20b", "mamba2-370m", "qwen3-1.7b", "qwen3-32b", "yi-6b"]
    # the paper's LSTM is not an arch of the registry, as in the reference
    assert "paper-lstm-h20" not in LATER_SLICES
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("paper-lstm-h20")
    with pytest.raises(NotImplementedError, match="MoE and hybrid"):
        get_config("jamba-1.5-large-398b")
    assert "mixtral-8x7b" in LATER_SLICES
    assert not {"yi-6b", "internlm2-20b", "qwen3-32b"} & set(LATER_SLICES)
    cfg = get_config("qwen3-1.7b")

    import dataclasses

    with pytest.raises(NotImplementedError, match="remaining-model-families"):
        register(lambda: dataclasses.replace(cfg, name="mixtral-8x7b"), lambda: cfg)
