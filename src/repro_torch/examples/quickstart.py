"""Quickstart on the port: the paper in a minute, on the card.

1. Reproduce Experiment 1 (configuration-parameter optimization, 40.13×).
2. Reproduce Experiment 2 (Idle-Waiting vs On-Off, cross point 89.21 ms).
3. Reproduce Experiment 3 (idle power-saving methods, 12.39× lifetime).
4. Train the paper's LSTM accelerator on the sensor workload through the
   CUDA LSTM kernel and time one inference on the card.

Run:  python -m repro_torch.examples.quickstart            (on the card)
      python -m repro_torch.examples.quickstart --device cpu
                                       (the plain PyTorch path on the CPU)

Experiments 1–3 are pure Python and print what the JAX package's
``examples/quickstart.py`` prints.  The training loop is that file's
``train_accelerator``, run eagerly (the reference's step is ``jax.jit``).
"""
from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import paper_lstm
from repro_torch.core import (
    CALIBRATED_POWERUP_OVERHEAD_MJ as CAL,
    SPARTAN7_XC7S15,
    WORST_PARAMS,
    IdlePowerMethod,
    compare_strategies,
    crossover_period_ms,
    energy_reduction_factor,
    optimal_params,
    paper_experiment,
    paper_lstm_item,
    simulate,
)
from repro_torch.data.pipeline import TimeSeriesStream
from repro_torch.device import resolve_device
from repro_torch.models import lstm as lstm_model
from repro_torch.optim import adamw

PRINT_EVERY = 75


def exp1():
    print("== Experiment 1: configuration-phase parameter optimization ==")
    dev = SPARTAN7_XC7S15
    worst_e = dev.config_energy_mj(WORST_PARAMS)
    best = optimal_params(dev)
    print(f"  worst (single SPI, 3 MHz, raw):   {worst_e:8.2f} mJ")
    print(f"  best  {best.params}: {best.config_energy_mj:8.2f} mJ")
    print(f"  reduction: {energy_reduction_factor(dev):.2f}×   (paper: 40.13×)")


def exp2():
    print("\n== Experiment 2: Idle-Waiting vs On-Off ==")
    item = paper_lstm_item()
    cross = crossover_period_ms(item, powerup_overhead_mj=CAL)
    print(f"  cross point: {cross:.2f} ms   (paper: 89.21 ms)")
    for t in (40.0, 89.0, 120.0):
        iw = simulate(paper_experiment("idle_waiting", t))
        oo = simulate(paper_experiment("on_off", t))
        winner = "idle-waiting" if iw.n_items > oo.n_items else "on-off"
        print(
            f"  T_req={t:5.1f} ms: IW {iw.n_items:9,d} items vs OnOff "
            f"{oo.n_items:9,d} → {winner}"
        )


def exp3():
    print("\n== Experiment 3: idle power-saving methods ==")
    item = paper_lstm_item()
    for method, tag in (
        (IdlePowerMethod.BASELINE, "baseline    "),
        (IdlePowerMethod.METHOD1, "method 1    "),
        (IdlePowerMethod.METHOD1_2, "method 1+2  "),
    ):
        cmp_ = compare_strategies(item, 40.0, method=method, powerup_overhead_mj=CAL)
        print(
            f"  {tag}: {cmp_['idle_waiting'].n_max:9,d} items, "
            f"{cmp_['idle_waiting'].lifetime_hours:6.2f} h  "
            f"({cmp_['items_ratio']:.2f}× vs On-Off)"
        )


def card_label(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi reports them, or
    ``"cpu"``; printed beside every time."""
    if device.type != "cuda":
        return "cpu"
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return f"{name}, power limit not read"
    if out.returncode != 0 or not out.stdout.strip():
        return f"{name}, power limit not read"
    return out.stdout.strip().splitlines()[0]


def single_inference_ms(params: dict, x: torch.Tensor) -> float:
    """Time of one forward pass: CUDA events on the card, the host clock
    on the CPU.  The caller warms up first."""
    if x.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lstm_model.apply(params, x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    lstm_model.apply(params, x)
    return (time.perf_counter() - t0) * 1000.0


def train_accelerator(device="cuda", steps: int = 300) -> dict:
    """Train the paper's LSTM for ``steps`` AdamW steps on batches of 32,
    score one fresh batch and time one inference at batch 1.

    The initial weights come from a CPU generator seeded with 0 (the same
    weights on every device).  On the card every forward pass goes
    through the LSTM kernel: ``steps`` training forwards, one evaluation
    forward, one warm-up and the timed inference.  Returns the losses,
    the accuracy and the inference time."""
    dev = resolve_device(device)
    print("\n== The paper's LSTM accelerator on the sensor workload ==")
    cfg = paper_lstm.full()
    stream = TimeSeriesStream(cfg.input_dim, cfg.seq_len, cfg.num_classes, batch=32)
    params = lstm_model.init_params(cfg, torch.Generator().manual_seed(0))
    params = {k: p.to(dev).requires_grad_(True) for k, p in params.items()}
    opt = adamw(weight_decay=0.0, clip_norm=1.0)
    opt_state = opt.init(params)

    def to_dev(x: np.ndarray, y: np.ndarray):
        return torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)

    losses = []
    for i in range(steps):
        x, y = to_dev(*stream.next_batch())
        loss = lstm_model.loss_fn(params, x, y)
        grads = torch.autograd.grad(loss, list(params.values()))
        params, opt_state, _ = opt.update(dict(zip(params, grads)), opt_state, params, 3e-3)
        losses.append(loss.detach())
        if i % PRINT_EVERY == 0:
            print(f"  step {i:3d}  loss {float(losses[-1]):.4f}")
    losses = [float(v) for v in losses]
    x, y = to_dev(*stream.next_batch())
    with torch.no_grad():
        acc = float(torch.mean((lstm_model.apply(params, x).argmax(-1) == y).float()))
        print(f"  final loss {losses[-1]:.4f}, accuracy {acc:.2%}")
        lstm_model.apply(params, x[:1])        # warm-up
        ms = single_inference_ms(params, x[:1])
    print(f"  single inference time: {ms:.4f} ms on {dev.type} [{card_label(dev)}] "
          f"(paper's accelerator: 0.0281 ms on the FPGA)")
    return {"losses": losses, "accuracy": acc, "inference_ms": ms}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device for the LSTM (default: cuda; raises without a card)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    exp1()
    exp2()
    exp3()
    return train_accelerator(args.device)


if __name__ == "__main__":
    main()
