"""Serving entry point: duty-cycle strategy demo on a live engine (port of
``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen3-1.7b --no-reduced \
        --period-ms 500 --requests 3 --strategy idle_waiting

Runs on the card by default (``--device cuda``); ``--device cpu`` runs the
plain PyTorch path, as the tests do.  ``--reduced``/``--no-reduced`` picks
the reduced or the full published width.
"""
from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.core.duty_cycle import DutyCycleController, PowerModel
from repro_torch.device import resolve_device
from repro_torch.kernels import _lib
from repro_torch.models import model_zoo as zoo
from repro_torch.serving.engine import ServingEngine, bring_up_from_checkpoint
from repro_torch.serving.scheduler import run_schedule


def build_demo(
    arch: str,
    reduced: bool = True,
    max_len: int = 96,
    prompt_len: int = 32,
    batch: int = 2,
    n_new: int = 8,
    ckpt_dir: str | None = None,
    power: PowerModel | None = None,
    strategy: str = "auto",
    device="cuda",
    seed: int = 0,
    policy=None,
):
    """(controller, make_request) for a live duty-cycle demo of ``arch``.
    Writes a ``zstd+int8`` checkpoint of random weights (from ``seed``)
    unless ``ckpt_dir`` already holds one.  ``policy`` is the
    ``strategy="adaptive"`` controller's timeout policy (default the
    analytical :class:`~repro_torch.core.adaptive.PolicyController`; e.g. a
    :class:`~repro_torch.policy.LearnedTimeoutPolicy`)."""
    device = resolve_device(device)
    if device.type == "cuda":
        # build the kernels now, so the build does not land in the first
        # measured configuration phase
        _lib.library()
    cfg = get_config(arch, reduced=reduced)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="repro-torch-serve-")
    manager = CheckpointManager(ckpt_dir, mode="zstd+int8")
    if not manager.steps():
        params = zoo.init_params(cfg, torch.Generator(device).manual_seed(seed))
        manager.save(0, params)
        del params

    rng = np.random.default_rng(seed)

    def make_request():
        tokens = rng.integers(0, cfg.vocab_size, (batch, prompt_len))
        return {"tokens": torch.as_tensor(tokens, dtype=torch.int32, device=device)}

    # conservative single-host power placeholders (mW) — examples report
    # RATIOS between strategies, which are power-model independent
    power = power or PowerModel(
        config_mw=90_000.0, infer_mw=200_000.0, idle_mw=65_000.0
    )

    def bring_up():
        return bring_up_from_checkpoint(
            cfg, manager, max_len, warmup_batch=make_request(), device=device
        )

    def infer(engine: ServingEngine, request):
        return engine.generate(request, n_new=n_new)

    def release(engine: ServingEngine):
        engine.release()

    controller = DutyCycleController(bring_up, infer, release, power, strategy, policy=policy)
    return controller, make_request


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--period-ms", type=float, default=300.0)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--strategy", default="auto",
                    choices=["auto", "adaptive", "on_off", "idle_waiting"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    controller, make_request = build_demo(
        args.arch, reduced=args.reduced, strategy=args.strategy, device=args.device
    )
    result = run_schedule(
        controller,
        (make_request() for _ in range(args.requests)),
        period_s=args.period_ms / 1000.0,
    )
    print(f"strategy       : {result.strategy}")
    print(f"requests       : {result.n_requests}")
    print(f"configurations : {result.n_configurations}")
    print(f"energy (mJ)    : {result.energy_mj:.1f}")
    print(f"by phase       : { {k: round(v,1) for k,v in result.energy_by_phase_mj.items()} }")
    print(f"crossover (ms) : {result.crossover_ms and round(result.crossover_ms,1)}")


if __name__ == "__main__":
    main()
