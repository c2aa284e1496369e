"""Training entry point (port of ``repro.launch.train``): data pipeline → train
step → checkpoints → metrics, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch qwen3-1.7b --reduced \
        --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

The mesh is the one-card 1×1 mesh; the model's attention and SSD layers
run the flash and SSD kernels in the forward pass (and again where
``remat`` recomputes a period), their gradients through the plain
versions (``kernels/*/ops.py``).  With ``--ckpt-dir`` the state is saved
every ``--ckpt-every`` steps on a writer thread, and a restart resumes from
the newest complete checkpoint and the data stream's step.

Called inside ``distributed.ranks.spawn`` with ``mesh=make_rank_mesh(...)``
(a dense decoder), :func:`train` runs the train step on that mesh of ranks:
each rank takes its rows of the same stream's batches (``shard_batch``)
and holds its blocks of the state; checkpoints are the whole state, so a
run may resume on a mesh of another shape (``plan_elastic_mesh``).  The
CLI has no mesh option, as the reference's has none.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import AsyncCheckpointer, CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.perf import PerfConfig
from repro_torch.data.pipeline import SyntheticLMStream, batch_for_arch, shard_batch
from repro_torch.device import synchronize
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault_tolerance import StragglerDetector
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as zoo
from repro_torch.optim import cosine_with_warmup
from repro_torch.training.train_loop import make_train_step, state_pspecs


def train(
    arch: str,
    reduced: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    lr: float = 3e-4,
    warmup: int = 20,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    num_microbatches: int = 1,
    seed: int = 0,
    mesh=None,
    log_every: int = 10,
    resume: bool = True,
    device="cuda",
) -> dict:
    """Train ``arch`` for ``steps`` steps → {"final_loss", "first_loss",
    "losses", "step_s", "state"}, from bf16 weights drawn from ``seed`` as
    in the reference.  ``step_s`` holds each step's seconds, the device
    synchronized.  On a mesh of ranks every rank of it calls this and gets
    its blocks of the state (a rank outside the mesh gets ``None``); the
    first rank prints."""
    cfg = get_config(arch, reduced=reduced)
    perf = PerfConfig(num_microbatches=num_microbatches)
    mesh = mesh if mesh is not None else make_host_mesh(device)
    if not mesh.is_member:
        return None
    dev = mesh.device
    say = print if not any(mesh.coordinate) else (lambda *a, **k: None)

    stream = SyntheticLMStream(
        vocab_size=max(cfg.vocab_size, 2), global_batch=batch, seq_len=seq, seed=seed
    )

    with shd.use_sharding(mesh):
        fns = make_train_step(cfg, perf, mesh=mesh)
        params = zoo.init_params(cfg, torch.Generator(dev).manual_seed(seed))
        state = fns.init_state(params)
        del params
        pspecs = state_pspecs(state, fns.param_pspecs) if mesh.size > 1 else None
        start_step = 0

        manager = ckpt = None
        if ckpt_dir:
            manager = CheckpointManager(ckpt_dir, keep=3)
            ckpt = AsyncCheckpointer(manager)
            if resume:
                latest, restored = manager.restore_latest(state, device=dev, pspecs=pspecs, mesh=mesh)
                if restored is not None:
                    state = restored
                    start_step = latest
                    stream.restore({"step": latest, "seed": seed})
                    say(f"resumed from step {latest}")

        detector = StragglerDetector()
        losses, step_s = [], []
        for step in range(start_step, steps):
            raw = batch_for_arch(cfg, stream.next_batch())
            b = shard_batch(raw, mesh)
            lr_t = cosine_with_warmup(step, lr, warmup, steps)
            t0 = time.perf_counter()
            state, metrics = fns.train_step(state, b, lr_t)
            loss = float(metrics["loss"])
            synchronize(dev)
            dt = time.perf_counter() - t0
            detector.record("host0", dt)
            losses.append(loss)
            step_s.append(dt)
            if step % log_every == 0 or step == steps - 1:
                say(
                    f"step {step:5d}  loss {loss:.4f}  gnorm "
                    f"{float(metrics['grad_norm']):.3f}  {dt*1000:.0f} ms"
                )
            if ckpt and (step + 1) % ckpt_every == 0:
                ckpt.save(step + 1, state, pspecs, mesh)
        if ckpt:
            ckpt.save(steps, state, pspecs, mesh)
            ckpt.wait()
    return {
        "final_loss": losses[-1] if losses else float("nan"),
        "first_loss": losses[0] if losses else float("nan"),
        "losses": losses,
        "step_s": step_s,
        "state": state,
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.reset_peak_memory_stats(dev)
    out = train(
        args.arch,
        reduced=args.reduced,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=args.lr,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        num_microbatches=args.microbatches,
        device=dev,
    )
    print(f"loss {out['first_loss']:.4f} → {out['final_loss']:.4f}")
    timed = out["step_s"][1:] or out["step_s"]
    if timed:
        per_step = sum(timed) / len(timed)
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
                if dev.type == "cuda" else "not measured on the CPU")
        print(f"{per_step:.4f} s a step after the first, "
              f"{args.batch * args.seq / per_step:.0f} tokens/s, peak memory {peak}")
    return out


if __name__ == "__main__":
    main()
