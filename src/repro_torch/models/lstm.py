"""The paper's DL accelerator as a model: LSTM (hidden 20) time-series
classifier [13] (port of ``repro.models.lstm``).  Drives the quickstart;
its inference phase is what Table 2 characterizes.

There is no ``impl=`` switch: ``kernels.lstm.ops.lstm`` launches the CUDA
kernel for card tensors and runs the plain version for CPU tensors.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_lstm import LstmConfig
from repro_torch.kernels.lstm import ops as lstm_ops
from repro_torch.models.common import Spec, init_from_specs


def lstm_specs(cfg: LstmConfig) -> dict:
    i, h, c = cfg.input_dim, cfg.hidden_size, cfg.num_classes
    return {
        "w_ih": Spec((i, 4 * h), (None, None)),
        "w_hh": Spec((h, 4 * h), (None, None)),
        "b": Spec((4 * h,), (None,), init="zeros"),
        "w_out": Spec((h, c), (None, None)),
        "b_out": Spec((c,), (None,), init="zeros"),
    }


def init_params(
    cfg: LstmConfig, generator: torch.Generator, dtype=torch.float32
) -> dict:
    """Random parameters on ``generator.device``."""
    return init_from_specs(lstm_specs(cfg), generator, dtype)


def apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, I) → class logits (B, C): last hidden state → linear head."""
    _, (h, _) = lstm_ops.lstm(x, params["w_ih"], params["w_hh"], params["b"])
    return h @ params["w_out"] + params["b_out"]


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against integer labels ``y`` (B,)."""
    logits = apply(params, x).float()
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, y.long()[:, None]))
