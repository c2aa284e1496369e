"""Dense FFN: SwiGLU (port of ``repro.models.mlp``; the GELU FFN comes
with the encoder family, in a later slice)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Spec


def mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": Spec((d, f), ("embed", "mlp")),
        "w_up": Spec((d, f), ("embed", "mlp")),
        "w_down": Spec((f, d), ("mlp", "embed")),
    }


def mlp_block(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    return h @ params["w_down"]
