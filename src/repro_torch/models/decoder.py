"""Decoder-LM assembly for serving: specs → prefill / decode (port of the
attention, Mamba-2 and dense-MLP paths of ``repro.models.decoder``).

Per-layer parameters are stacked on a leading layer axis, as in the
reference (``periods/pos0/...``); the reference's ``lax.scan`` over that
axis is a Python loop here.  A layer is attention (``attn``) or Mamba-2
(``ssm``) as ``cfg.layer_kind`` says; hybrid periods (``attn_every``) and
MoE layers raise: they come with a later slice of the port.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import Spec, rms_norm, stack_specs


def _unported(cfg: ArchConfig) -> None:
    if cfg.attn_every:
        raise NotImplementedError(
            f"{cfg.name}: hybrid attention/Mamba-2 periods (attn_every) come with "
            "the remaining-model-families slice of the port"
        )
    if cfg.num_experts:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers come with the remaining-model-families slice of the port"
        )
    if cfg.frontend != "none" or cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: modality frontends and GELU FFNs come with the "
            "remaining-model-families slice of the port"
        )


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _block_specs(cfg: ArchConfig) -> dict:
    specs: dict[str, Any] = {"ln1": Spec((cfg.d_model,), ("norm",), init="ones")}
    if cfg.layer_kind(0) == "attn":
        specs["attn"] = attn.attention_specs(cfg)
    else:
        specs["ssm"] = m2.mamba2_specs(cfg)
    if cfg.d_ff:
        specs["ln2"] = Spec((cfg.d_model,), ("norm",), init="ones")
        specs["mlp"] = mlp_mod.mlp_specs(cfg)
    return specs


def decoder_specs(cfg: ArchConfig) -> dict:
    _unported(cfg)
    specs: dict[str, Any] = {
        "periods": stack_specs({"pos0": _block_specs(cfg)}, cfg.num_layers),
        "final_norm": Spec((cfg.d_model,), ("norm",), init="ones"),
    }
    if cfg.vocab_size:
        specs["embed"] = Spec(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=0.02
        )
        if not cfg.tie_embeddings:
            specs["lm_head"] = Spec(
                (cfg.d_model, cfg.vocab_size), ("embed", "vocab")
            )
    return specs


def _layer(tree: Any, i: int) -> Any:
    """Layer ``i``'s slice of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Input embedding and head
# ---------------------------------------------------------------------------
def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """{'tokens': (B, S)} → (B, S, d) residual stream input."""
    return params["embed"][batch["tokens"].long()]


def _lm_head(params: dict) -> torch.Tensor:
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T   # tied


def logits_at(params: dict, hidden: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Vocab logits for given hidden positions (B, S', d) → (B, S', V) fp32."""
    return (hidden @ _lm_head(params)).float()


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    caches: list           # per layer: {"pos0": KVCache or SSMCache}


def _mlp_residual(lp: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.d_ff:
        x = x + mlp_mod.mlp_block(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
    return x


def prefill(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    max_len: int,
) -> tuple[torch.Tensor, DecodeState]:
    """Full-context forward that materializes decode caches.
    Returns (last-position logits (B, V), state)."""
    _unported(cfg)
    x = embed_inputs(params, batch, cfg)
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["periods"], i)["pos0"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if "attn" in lp:
            mix, cache = attn.prefill_cache(lp["attn"], h, cfg, max_len)
        else:
            mix, cache = m2.mamba2_block(lp["ssm"], h, cfg, return_state=True)
        caches.append({"pos0": cache})
        x = _mlp_residual(lp, x + mix, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_at(params, x[:, -1:, :], cfg)[:, 0]
    return logits, DecodeState(caches=caches)


def decode_step(
    params: dict,
    state: DecodeState,
    token: torch.Tensor,         # (B,) int
    cfg: ArchConfig,
) -> tuple[torch.Tensor, DecodeState]:
    """One decode step for every sequence in the batch → (logits (B,V), state)."""
    x = params["embed"][token.long()[:, None]]
    new_caches = []
    for i in range(cfg.num_layers):
        lp = _layer(params["periods"], i)["pos0"]
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if "attn" in lp:
            mix, cache = attn.attention_decode(lp["attn"], h, state.caches[i]["pos0"], cfg)
        else:
            mix, cache = m2.mamba2_decode(lp["ssm"], h, state.caches[i]["pos0"], cfg)
        new_caches.append({"pos0": cache})
        x = _mlp_residual(lp, x + mix, cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_at(params, x, cfg)[:, 0]
    return logits, DecodeState(caches=new_caches)
