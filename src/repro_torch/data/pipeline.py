"""Data streams (port of ``repro.data.pipeline``): the paper's sensor
workload, :class:`TimeSeriesStream`, in numpy as in the reference, so the
two give the same batches sample for sample.  The LM streams
(``SyntheticLMStream``, ``batch_for_arch``, ``shard_batch``) come with
training (ROADMAP A13).
"""
from __future__ import annotations

import dataclasses

import numpy as np


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
