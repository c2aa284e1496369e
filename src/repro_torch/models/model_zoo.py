"""Model zoo: config → specs / params / inputs / loss / serving steps
(port of ``repro.models.model_zoo``, without the dry run's abstract input
specs).

The parameter tree keeps the reference's pytree paths and stacked shapes
(``periods/pos0/attn/wq`` of shape (L, d, q), ...), so a weight carried
over with :func:`params_from_numpy` and a checkpoint leaf both map 1:1.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import logical_to_pspec
from repro_torch.models import decoder
from repro_torch.models.common import init_from_specs, map_specs, shapes_from_specs


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


def param_pspecs(cfg: ArchConfig, mesh=None) -> dict:
    """Every parameter's PartitionSpec under the rule table (all empty on a
    1×1 mesh or with none)."""
    return map_specs(lambda s: logical_to_pspec(s.axes, mesh=mesh, shape=s.shape), specs(cfg))


def params_from_numpy(tree: Any, device="cuda", dtype=None) -> Any:
    """The reference's parameter pytree, as numpy arrays (bf16 ones as
    ``ml_dtypes.bfloat16``), → the port's parameters on ``device`` (the
    card by default; raises without one unless ``device="cpu"``), with the
    same paths and shapes.  ``dtype`` casts every leaf if given."""
    device = resolve_device(device)
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


def make_batch(
    cfg: ArchConfig, batch: int, seq_len: int, generator: torch.Generator
) -> dict:
    """A random prefill batch on ``generator.device``, in the reference's
    input layout: token ids (int32) and, for a frontend, bf16 embeddings
    drawn from a standard normal — frames ``features`` (B, S, frontend_dim)
    for audio, which take the place of tokens; for vision, ``patch_embeds``
    (B, frontend_tokens, frontend_dim) ahead of S − frontend_tokens tokens."""
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev).to(torch.bfloat16)

    if cfg.frontend == "audio":
        return {"features": normal(batch, seq_len, cfg.frontend_dim)}
    n_tok = seq_len - (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, n_tok), generator=generator,
                                   device=dev, dtype=torch.int32)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = normal(batch, cfg.frontend_tokens, cfg.frontend_dim)
    return out


def loss_fn(
    params: dict, batch: dict, cfg: ArchConfig, perf: PerfConfig = BASELINE, layout=None
) -> torch.Tensor:
    """The training loss (:func:`decoder.lm_loss`; this rank's share of it
    on local blocks with a ``layout``)."""
    return decoder.lm_loss(params, batch, cfg, perf, layout=layout)


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


def encode_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Encoder-only forward → per-position logits (B, S, V) fp32 (hubert's
    serving path)."""
    x = decoder.embed_inputs(params, batch, cfg)
    hidden, _ = decoder.forward_hidden(params, x, cfg)
    return decoder.logits_at(params, hidden, cfg)
