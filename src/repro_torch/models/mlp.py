"""Dense FFN: SwiGLU (3 matrices) or GELU (2 matrices) (port of
``repro.models.mlp``).

The GELU is On a mesh of ranks (a ``Layout``) whose ``model`` axis splits ``d_ff``,
the block runs on this rank's columns of ``w_gate``/``w_up`` and rows of
``w_down``, and the parts are summed over ``model``.

The GELU is ``jax.nn.gelu``'s default, the tanh approximation
0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³))): ``approximate="tanh"``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Spec


def mlp_specs(cfg: ArchConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "swiglu":
        return {
            "w_gate": Spec((d, f), ("embed", "mlp")),
            "w_up": Spec((d, f), ("embed", "mlp")),
            "w_down": Spec((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": Spec((d, f), ("embed", "mlp")),
        "w_down": Spec((f, d), ("mlp", "embed")),
    }


def mlp_block(params: dict, x: torch.Tensor, cfg: ArchConfig, layout=None) -> torch.Tensor:
    split = layout is not None and params["w_up"].shape[-1] != cfg.d_ff
    if split:
        x = layout.enter(x)
    if cfg.mlp_kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    if not split:
        return h @ params["w_down"]
    b, s, _ = x.shape
    h = layout.check(h, ("batch", "act_seq", "act_mlp"), (b * layout.batch_size, s, cfg.d_ff))
    return layout.exit(h @ params["w_down"])
