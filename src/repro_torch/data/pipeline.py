"""Data streams (port of ``repro.data.pipeline``), in numpy as in the
reference, so the two give the same batches element for element:

  * ``SyntheticLMStream`` — deterministic per-step token batches (seeded
    counter-based PRNG: batch ``i`` is identical across restarts, so
    resume-after-failure is exact and data needs no checkpoint beyond the
    step counter);
  * ``batch_for_arch`` — adapt a token batch to the arch's modality;
  * ``shard_batch`` — place a host batch on the mesh's device as tensors
    (on a mesh of ranks, this rank's rows);
  * ``TimeSeriesStream`` — the paper's sensor workload (windowed IMU-like
    series → class labels) feeding the LSTM accelerator examples.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ranks
from repro_torch.distributed.sharding import P


@dataclasses.dataclass
class SyntheticLMStream:
    """Deterministic LM batches: tokens[i] = f(seed, step) — resumable."""

    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    step: int = 0                     # mutable cursor (checkpointable)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self.seed = int(state["seed"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(np.random.SeedSequence([self.seed, step]))

    def next_batch(self) -> dict:
        rng = self._rng(self.step)
        tokens = rng.integers(
            0, self.vocab_size, size=(self.global_batch, self.seq_len), dtype=np.int32
        )
        self.step += 1
        # next-token LM: labels are the same sequence (the loss shifts)
        return {"tokens": tokens, "labels": tokens.copy()}

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield self.next_batch()


def batch_for_arch(cfg: ArchConfig, stream_batch: dict) -> dict:
    """Adapt a token batch to the arch's modality (stub frontends)."""
    tokens = stream_batch["tokens"]
    b, s = tokens.shape
    if cfg.frontend == "vision":
        n = cfg.frontend_tokens
        rng = np.random.default_rng(int(tokens[0, 0]))
        return {
            "tokens": tokens[:, : s - n],
            "patch_embeds": rng.standard_normal((b, n, cfg.frontend_dim)).astype(
                np.float32
            ),
            "labels": stream_batch["labels"],
        }
    if cfg.frontend == "audio":
        rng = np.random.default_rng(int(tokens[0, 0]))
        return {
            "features": rng.standard_normal((b, s, cfg.frontend_dim)).astype(np.float32),
            "labels": np.mod(stream_batch["labels"], cfg.vocab_size),
        }
    return {
        "tokens": tokens,
        "labels": np.mod(stream_batch["labels"], cfg.vocab_size),
    }


def shard_batch(batch: dict, mesh, pspecs: Optional[dict] = None) -> Optional[dict]:
    """Host arrays → tensors on the mesh's device (the card when ``mesh`` is
    None).  On one device the whole batch goes there.  On a mesh of more
    devices this rank gets its block of each leaf: under ``pspecs[k]``
    where given, else its rows along the leading axis when the product of
    the mesh's (pod, data) axes divides them, and the whole leaf otherwise
    (the reference's rule); a rank outside the mesh gets ``None``."""
    if mesh is None:
        device = resolve_device("cuda")
    elif mesh.size == 1:
        device = mesh.device if mesh.device is not None else resolve_device("cuda")
    else:
        if not mesh.is_member:
            return None
        dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        n = int(np.prod([mesh.shape[a] for a in dp])) if dp else 1

        def spec(k, x):
            if pspecs is not None and k in pspecs:
                return pspecs[k]
            return P(dp if dp and x.shape[0] % n == 0 else None)

        return {k: ranks.shard(torch.from_numpy(np.ascontiguousarray(v)), spec(k, v), mesh).to(mesh.device)
                for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# The paper's sensor workload (IMU-like windows → activity classes)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class TimeSeriesStream:
    """Synthetic periodic sensor data for the LSTM accelerator [13]:
    class k = sinusoid bank at frequency ~(k+1)·f0 + noise."""

    input_dim: int = 6
    seq_len: int = 64
    num_classes: int = 5
    batch: int = 16
    seed: int = 0
    step: int = 0

    def next_batch(self) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.step]))
        self.step += 1
        y = rng.integers(0, self.num_classes, self.batch)
        t = np.arange(self.seq_len)[None, :, None] / self.seq_len
        freq = (y[:, None, None] + 1.0) * 2.0 * np.pi
        phase = rng.uniform(0, 2 * np.pi, (self.batch, 1, self.input_dim))
        x = np.sin(freq * t + phase) + 0.1 * rng.standard_normal(
            (self.batch, self.seq_len, self.input_dim)
        )
        return x.astype(np.float32), y.astype(np.int32)
