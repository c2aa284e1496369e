"""Model zoo: config → specs / params / serving steps (port of
``repro.models.model_zoo``).

The parameter tree keeps the reference's pytree paths and stacked shapes
(``periods/pos0/attn/wq`` of shape (L, d, q), ...), so a weight carried
over with :func:`params_from_numpy` and a checkpoint leaf both map 1:1.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import decoder
from repro_torch.models.common import init_from_specs, shapes_from_specs


def specs(cfg: ArchConfig) -> dict:
    return decoder.decoder_specs(cfg)


def init_params(
    cfg: ArchConfig, generator: torch.Generator, dtype=torch.bfloat16
) -> dict:
    """Random parameters on ``generator.device``."""
    return init_from_specs(specs(cfg), generator, dtype)


def param_shapes(cfg: ArchConfig, dtype=torch.bfloat16) -> dict:
    """Meta tensors of every parameter's shape and dtype."""
    return shapes_from_specs(specs(cfg), dtype)


def params_from_numpy(tree: Any, device="cpu", dtype=None) -> Any:
    """The reference's parameter pytree, as numpy arrays (bf16 ones as
    ``ml_dtypes.bfloat16``), → the port's parameters on ``device``, with
    the same paths and shapes.  ``dtype`` casts every leaf if given."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def prefill_fn(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    max_len: int,
):
    return decoder.prefill(params, batch, cfg, max_len)


def decode_fn(
    params: dict,
    state: decoder.DecodeState,
    token: torch.Tensor,
    cfg: ArchConfig,
):
    return decoder.decode_step(params, state, token, cfg)
