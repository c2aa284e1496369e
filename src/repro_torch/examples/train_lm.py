"""Train a ~100M-parameter LM for a few hundred steps, on the card (port of
the JAX package's ``examples/train_lm.py``).

The training stack end to end: synthetic data pipeline → microbatched
train step (the flash kernel in every attention layer's forward) → async
checkpoints → resume.

Run:  python -m repro_torch.examples.train_lm [--steps 300]             (card)
      python -m repro_torch.examples.train_lm --device cpu --steps 20
"""
from __future__ import annotations

import argparse
import tempfile

from repro_torch.configs import base as cfg_base
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.train import train


# ~100M-parameter qwen3-style config (d=512, 8 layers, vocab 32k):
#   2·32000·512 (embeddings) + 8·(512·1024+2·512·512+1024·512 + 3·512·2048)
#   ≈ 100M — registered for this example.
def make_100m() -> ArchConfig:
    return ArchConfig(
        name="qwen3-100m-example",
        family="dense",
        num_layers=8,
        d_model=512,
        num_heads=8,
        num_kv_heads=4,
        head_dim=128,
        d_ff=2048,
        vocab_size=32000,
        qk_norm=True,
        rope_theta=1_000_000.0,
        subquadratic=False,
    )


def register() -> ArchConfig:
    """Put the example's config in the registry (full and reduced alike)."""
    cfg = make_100m()
    cfg_base._REGISTRY[cfg.name] = make_100m
    cfg_base._REDUCED[cfg.name] = make_100m
    return cfg


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None, help="default: a new temporary directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = register()
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M parameters")
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="repro-train100m-")
    out = train(
        cfg.name,
        reduced=False,
        steps=args.steps,
        batch=args.batch,
        seq=args.seq,
        lr=1e-3,
        ckpt_dir=ckpt,
        ckpt_every=args.ckpt_every,
        num_microbatches=2,
        device=device,
    )
    print(f"loss: {out['first_loss']:.4f} → {out['final_loss']:.4f}")
    print(f"checkpoints in {ckpt}")
    return out


if __name__ == "__main__":
    main()
