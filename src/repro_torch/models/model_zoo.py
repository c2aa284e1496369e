"""Model zoo: config → specs / params / inputs / loss / serving steps
(port of ``repro.models.model_zoo``).

The parameter tree keeps the reference's pytree paths and stacked shapes
(``periods/pos0/attn/wq`` of shape (L, d, q), ...), so a weight carried
over with :func:`params_from_numpy` and a checkpoint leaf both map 1:1.
:func:`batch_spec` gives one dry-run cell's inputs as ``meta`` tensors
(the reference's ``ShapeDtypeStruct`` stand-ins).

**Serving on a mesh of ranks** (``mesh=`` of :func:`prefill_fn` and
:func:`decode_fn`; the dense decoders): the parameters are this rank's
blocks under :func:`param_pspecs` (:func:`shard_params`), the batch and the
decode state this rank's rows (``launch.dryrun_lib.batch_pspecs``), under
the rule table ``use_sharding`` installs (the defaults otherwise); the
step runs on a :func:`serving_layout` (``models/decoder.py``).  The other
families and the cache's two sequence-split flags raise, naming the later
slice (ROADMAP).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import ranks
from repro_torch.distributed.sharding import Layout, current_rules, logical_to_pspec
from repro_torch.models import decoder
from repro_torch.models.common import init_from_specs, map_specs, shapes_from_specs
from repro_torch.tree import paths, unflatten_like


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


def shard_params(params: dict, cfg: ArchConfig, mesh) -> dict:
    """This rank's block of every parameter under :func:`param_pspecs`
    (contiguous copies)."""
    specs = paths(param_pspecs(cfg, mesh))
    return unflatten_like(params, [ranks.shard(t.detach(), specs[k], mesh).contiguous()
                                   for k, t in paths(params).items()])


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


def batch_spec(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """One (arch × shape) cell's input batch as ``meta`` tensors, in the
    reference's layout: train and prefill cells ``tokens`` (int32; a
    vision frontend's ``patch_embeds`` ahead of fewer tokens, an audio
    frontend's ``features`` in their place, bf16) and, to train,
    ``labels``; a decode cell ``token`` (B,) and the ``state`` of a cache
    of ``seq_len`` positions."""
    b, s = shape.global_batch, shape.seq_len
    meta = torch.device("meta")
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            n = cfg.frontend_tokens
            batch = {"tokens": torch.empty((b, s - n), dtype=torch.int32, device=meta),
                     "patch_embeds": torch.empty((b, n, cfg.frontend_dim), dtype=torch.bfloat16, device=meta)}
        elif cfg.frontend == "audio":
            batch = {"features": torch.empty((b, s, cfg.frontend_dim), dtype=torch.bfloat16, device=meta)}
        else:
            batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device=meta)}
        if shape.kind == "train":
            batch["labels"] = torch.empty((b, s), dtype=torch.int32, device=meta)
        return batch
    if shape.kind == "decode":
        return {"token": torch.empty((b,), dtype=torch.int32, device=meta),
                "state": decoder.init_decode_state(cfg, b, s, device=meta)}
    raise ValueError(shape.kind)


def dense_decoder(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` is of the dense decoder family, the one a mesh of
    ranks trains and serves."""
    return cfg.family == "dense" and cfg.frontend == "none" and not cfg.attn_every and not any(
        cfg.layer_is_moe(i) for i in range(cfg.num_layers))


def serving_layout(cfg: ArchConfig, perf: PerfConfig, mesh, long_context: bool = False) -> Layout:
    """The ``Layout`` a serving step on a mesh of ranks runs on (module
    docstring); raises for what waits for a later slice (ROADMAP Queue A)."""
    if not dense_decoder(cfg):
        raise NotImplementedError(
            f"{cfg.name}: prefill and decode on a mesh of ranks take the dense decoder family; the "
            "MoE, Mamba-2, hybrid and frontend families wait for mesh serving of the other "
            "families (ROADMAP Queue A)")
    if perf.shard_cache_seq_over_model or perf.shard_long_cache_over_model or long_context:
        raise NotImplementedError(
            "a KV cache split over its sequence (shard_cache_seq_over_model, "
            "shard_long_cache_over_model, the long-context placement) needs the flash kernel's "
            "log-sum-exp combined across ranks, which waits for a later slice (ROADMAP Queue A)")
    return Layout(mesh, dict(current_rules()), paths(param_pspecs(cfg, mesh)),
                  gathered=perf.gather_weights_once)


def loss_fn(
    params: dict, batch: dict, cfg: ArchConfig, perf: PerfConfig = BASELINE, layout=None
) -> torch.Tensor:
    """The training loss (:func:`decoder.lm_loss`; this rank's share of it
    on local blocks with a ``layout``)."""
    return decoder.lm_loss(params, batch, cfg, perf, layout=layout)


def _mesh_layout(cfg, perf, mesh, long_context: bool):
    if mesh is None or mesh.size == 1:
        return None
    return serving_layout(cfg, perf, mesh, long_context)


def prefill_fn(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    max_len: int,
    perf: PerfConfig = BASELINE,
    long_context: bool = False,
    mesh=None,
):
    """(last-position logits (B, V), decode state); on a ``mesh`` of ranks
    this rank's rows from its parameter blocks (module docstring)."""
    layout = _mesh_layout(cfg, perf, mesh, long_context)
    return decoder.prefill(params, batch, cfg, max_len, perf, long_context, layout)


def decode_fn(
    params: dict,
    state: decoder.DecodeState,
    token: torch.Tensor,
    cfg: ArchConfig,
    perf: PerfConfig = BASELINE,
    long_context: bool = False,
    mesh=None,
):
    """One decode step → (logits (B, V), state); on a ``mesh`` of ranks
    this rank's rows (module docstring)."""
    layout = _mesh_layout(cfg, perf, mesh, long_context)
    return decoder.decode_step(params, state, token, cfg, perf, long_context, layout)


def encode_fn(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """Encoder-only forward → per-position logits (B, S, V) fp32 (hubert's
    serving path)."""
    x = decoder.embed_inputs(params, batch, cfg)
    hidden, _ = decoder.forward_hidden(params, x, cfg)
    return decoder.logits_at(params, hidden, cfg)
