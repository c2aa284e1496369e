"""Decoder-LM assembly: specs → forward → loss / prefill / decode (port of
``repro.models.decoder``).

Deep stacks are *periods*: ``cfg.attn_every`` layers for a hybrid, else one
layer, with per-period parameters stacked on a leading axis
(``periods/pos{i}/...``), as in the reference.  The reference's
``lax.scan`` over periods is a Python loop here, and each period runs its
positions in order through one per-position step (:func:`prefill_block`,
:func:`decode_block`, :func:`forward_block`).  A position is attention
(``attn``) or Mamba-2 (``ssm``) as ``cfg.layer_kind`` says, and its FFN is
the MoE block where ``cfg.layer_is_moe``, else the dense MLP.

The same module serves the encoder-only family (hubert): ``causal=False``,
frame features in place of tokens, and :func:`forward_hidden` with no
decode entry points.

Training (:func:`lm_loss`) rematerializes each period as the reference's
``jax.checkpoint`` does, by ``perf.remat``: ``full`` keeps only the
period's input (``torch.utils.checkpoint``, non-reentrant), ``dots`` also
keeps the outputs of the unbatched matmuls (a selective-checkpoint policy,
the counterpart of ``checkpoint_dots_with_no_batch_dims``), ``none`` keeps
everything.  A rematerialized period runs its forward again in the
backward pass, kernels included.

On a mesh of ranks the train step passes a ``Layout``
(``distributed/sharding.py``) to :func:`lm_loss`, which runs the dense
decoder on local blocks: each period's weights are fetched (gathered over
their FSDP axes) inside its rematerialized forward, so a replay gathers
them again; attention and the MLP run their tensor-parallel bodies; the
token embedding is vocab-parallel (rows outside this rank's block give 0,
then a sum over ``model``), and so are the tied or untied head's logits,
whose log-sum-exp and label pick take the max and the sums over
``model``.  Each rank's loss is its rows' negative log-likelihood over the
count of every rank's labels (a sum over the batch axes), so the ranks'
losses and gradients add up to the global mean's.  The reference's
``constrain`` calls have their counterparts here as
``Layout.check``.

The serving step takes the same kind of ``Layout`` (built by
``model_zoo.prefill_fn`` / ``decode_fn`` from a mesh): :func:`prefill` and
:func:`decode_step` run on this rank's rows, each period's weights fetched
over their FSDP axes before use (or gathered once a call with
``gather_weights_once``), attention and the MLP on local heads and
columns, the cache a local block (``models/attention.py``), the embedding
vocab-parallel; :func:`logits_at` assembles each row's whole (V,) logits
over ``model``.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.perf import BASELINE, PerfConfig
from repro_torch.distributed import ranks
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import Spec, rms_norm, stack_specs
from repro_torch.tree import paths


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def _block_specs(cfg: ArchConfig, pos: int) -> dict:
    """One block at position ``pos`` within a period."""
    specs: dict[str, Any] = {"ln1": Spec((cfg.d_model,), ("norm",), init="ones")}
    if cfg.layer_kind(pos) == "attn":
        specs["attn"] = attn.attention_specs(cfg)
    else:
        specs["ssm"] = m2.mamba2_specs(cfg)
    if cfg.d_ff:
        specs["ln2"] = Spec((cfg.d_model,), ("norm",), init="ones")
        if cfg.layer_is_moe(pos):
            specs["moe"] = moe_mod.moe_specs(cfg)
        else:
            specs["mlp"] = mlp_mod.mlp_specs(cfg)
    return specs


def period_len(cfg: ArchConfig) -> int:
    return cfg.attn_every if cfg.attn_every else 1


def num_periods(cfg: ArchConfig) -> int:
    return cfg.num_layers // period_len(cfg)


def decoder_specs(cfg: ArchConfig) -> dict:
    period = {f"pos{i}": _block_specs(cfg, i) for i in range(period_len(cfg))}
    specs: dict[str, Any] = {
        "periods": stack_specs(period, num_periods(cfg)),
        "final_norm": Spec((cfg.d_model,), ("norm",), init="ones"),
    }
    if cfg.frontend != "none":
        specs["frontend_proj"] = Spec((cfg.frontend_dim, cfg.d_model), (None, "embed"))
    if cfg.vocab_size:
        if cfg.frontend != "audio":      # audio inputs are frames: no token embedding
            specs["embed"] = Spec(
                (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), scale=0.02
            )
        if not cfg.tie_embeddings or cfg.frontend == "audio":
            specs["lm_head"] = Spec(
                (cfg.d_model, cfg.vocab_size), ("embed", "vocab")
            )
    return specs


def _layer(tree: Any, i: int) -> Any:
    """Period ``i``'s slice of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def blocks(params: dict, cfg: ArchConfig):
    """(position in its period, block parameters) for every layer, in order."""
    for p in range(num_periods(cfg)):
        period = _layer(params["periods"], p)
        for i in range(period_len(cfg)):
            yield i, period[f"pos{i}"]


# ---------------------------------------------------------------------------
# Input embedding (modality adapters) and head
# ---------------------------------------------------------------------------
def embed_inputs(params: dict, batch: dict, cfg: ArchConfig) -> torch.Tensor:
    """batch → (B, S, d) residual stream input.

    vlm  : {'tokens': (B, S−N), 'patch_embeds': (B, N, frontend_dim)}
    audio: {'features': (B, S, frontend_dim)}
    else : {'tokens': (B, S)}

    Frontend inputs are rounded to bf16 first, as in the reference, then
    multiply the projection in its own dtype (the reference's bf16 × fp32
    promotes to fp32)."""
    if cfg.frontend == "audio":
        return _project_frontend(params, batch["features"])
    tok = params["embed"][batch["tokens"].long()]
    if cfg.frontend == "vision":
        return torch.cat([_project_frontend(params, batch["patch_embeds"]), tok], dim=1)
    return tok


def _project_frontend(params: dict, x: torch.Tensor) -> torch.Tensor:
    proj = params["frontend_proj"]
    return x.to(torch.bfloat16).to(proj.dtype) @ proj


def _lm_head(params: dict) -> torch.Tensor:
    if "lm_head" in params:
        return params["lm_head"]
    return params["embed"].T   # tied


def logits_at(params: dict, hidden: torch.Tensor, cfg: ArchConfig, layout=None) -> torch.Tensor:
    """Vocab logits for given hidden positions (B, S', d) → (B, S', V) fp32;
    with a ``layout`` whose head is split over ``model``, this rank's
    columns gathered into every row's whole logits."""
    logits = (hidden @ _lm_head(params)).float()
    if layout is not None and logits.shape[-1] != cfg.vocab_size:
        logits = ranks.all_gather(logits, layout.tp, logits.dim() - 1, layout.mesh, tag="logits")
    return logits


# ---------------------------------------------------------------------------
# The per-position steps
# ---------------------------------------------------------------------------
def _ffn_residual(bp: dict, x: torch.Tensor, cfg: ArchConfig, pos: int):
    """x + FFN(norm(x)) → (x, MoE aux loss or None)."""
    if not cfg.d_ff:
        return x, None
    h = rms_norm(x, bp["ln2"], cfg.norm_eps)
    if cfg.layer_is_moe(pos):
        f, aux = moe_mod.moe_block(bp["moe"], h, cfg)
        return x + f, aux
    return x + mlp_mod.mlp_block(bp["mlp"], h, cfg), None


def forward_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, pos: int,
                  perf: PerfConfig = BASELINE, layout=None):
    """The block at position ``pos`` over a full sequence, with no cache
    → (x, MoE aux loss or None); with a ``layout``, on local blocks (a
    dense block: attention and the MLP)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if layout is not None:
        x = x + attn.attention_block(bp["attn"], h, cfg, layout=layout)
        x = x + mlp_mod.mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps), cfg, layout)
        b, s, d = x.shape
        return layout.check(x, ("batch", "act_seq", None), (b * layout.batch_size, s, d)), None
    if cfg.layer_kind(pos) == "attn":
        mix = attn.attention_block(bp["attn"], h, cfg)
    else:
        mix = m2.mamba2_block(bp["ssm"], h, cfg, chunk=perf.ssd_chunk)
    return _ffn_residual(bp, x + mix, cfg, pos)


def prefill_block(bp: dict, x: torch.Tensor, cfg: ArchConfig, pos: int, max_len: int,
                  perf: PerfConfig = BASELINE, layout=None):
    """The block at position ``pos`` over a full sequence → (x, its decode
    cache: a ``KVCache`` or an ``SSMCache``); with a serving ``layout``, a
    dense block on local blocks (module docstring)."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if layout is not None:
        mix, cache = attn.prefill_cache(bp["attn"], h, cfg, max_len, layout)
        x = x + mix
        return x + mlp_mod.mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps), cfg, layout), cache
    if cfg.layer_kind(pos) == "attn":
        mix, cache = attn.prefill_cache(bp["attn"], h, cfg, max_len)
    else:
        mix, cache = m2.mamba2_block(bp["ssm"], h, cfg, chunk=perf.ssd_chunk, return_state=True)
    x, _ = _ffn_residual(bp, x + mix, cfg, pos)
    return x, cache


def decode_block(bp: dict, x: torch.Tensor, cache, cfg: ArchConfig, pos: int, layout=None):
    """The block at position ``pos`` for one token (B, 1, d) → (x, cache);
    with a serving ``layout``, a dense block on local blocks."""
    h = rms_norm(x, bp["ln1"], cfg.norm_eps)
    if layout is not None:
        mix, cache = attn.attention_decode(bp["attn"], h, cache, cfg, layout)
        x = x + mix
        return x + mlp_mod.mlp_block(bp["mlp"], rms_norm(x, bp["ln2"], cfg.norm_eps), cfg, layout), cache
    if cfg.layer_kind(pos) == "attn":
        mix, cache = attn.attention_decode(bp["attn"], h, cache, cfg)
    else:
        mix, cache = m2.mamba2_decode(bp["ssm"], h, cache, cfg)
    x, _ = _ffn_residual(bp, x + mix, cfg, pos)
    return x, cache


# ---------------------------------------------------------------------------
# Forward (full sequence) and loss
# ---------------------------------------------------------------------------
def _period_forward(pp: dict, x: torch.Tensor, aux: torch.Tensor, cfg: ArchConfig,
                    perf: PerfConfig, layout=None):
    """One period's positions in order → (x, aux); with a ``layout``, its
    weights fetched first."""
    if layout is not None:
        pp = layout.fetch(pp, "periods", stacked=True)
    for i in range(period_len(cfg)):
        x, a = forward_block(pp[f"pos{i}"], x, cfg, i, perf, layout)
        if a is not None:
            aux = aux + a
    return x, aux


_UNBATCHED_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_matmuls(ctx, op, *args, **kwargs):
    """``dots``: keep the unbatched matmuls' outputs, recompute the rest."""
    if op in _UNBATCHED_MATMULS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _rematerialized(remat: str):
    """``_period_forward`` under the ``remat`` policy."""
    if remat == "none":
        return _period_forward
    extra = {}
    if remat == "dots":
        extra["context_fn"] = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                                _save_matmuls)
    return functools.partial(ckpt.checkpoint, _period_forward, use_reentrant=False, **extra)


def _needs_grad(params: dict, x: torch.Tensor) -> bool:
    if not torch.is_grad_enabled():
        return False
    return x.requires_grad or any(t.requires_grad for t in paths(params["periods"]).values())


def forward_hidden(params: dict, x: torch.Tensor, cfg: ArchConfig,
                   perf: PerfConfig = BASELINE, layout=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Embedding-space input → final hidden states (+ summed aux loss).
    Under autograd each period is rematerialized by ``perf.remat``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    run = _rematerialized(perf.remat) if _needs_grad(params, x) else _period_forward
    for p in range(num_periods(cfg)):
        x, aux = run(_layer(params["periods"], p), x, aux, cfg, perf, layout)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


def lm_loss(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    perf: PerfConfig = BASELINE,
    aux_weight: float = 0.01,
    layout=None,
) -> torch.Tensor:
    """Mean next-token (or frame-label) CE, chunked over the sequence by
    ``perf.loss_chunk`` so the full (B, S, V) logits are never formed at
    once; labels of −1 are masked; plus ``aux_weight`` × the MoE aux loss.
    With a ``layout``, this rank's share of it on local blocks (module
    docstring)."""
    if layout is None:
        x = embed_inputs(params, batch, cfg)
    else:
        params = {**layout.fetch({k: v for k, v in params.items() if k != "periods"}, ""),
                  "periods": params["periods"]}
        x = _embed_sharded(params["embed"], batch["tokens"], cfg, layout)
        rows = x.shape[0] * layout.batch_size
        x = layout.check(x, ("batch", "act_seq", None), (rows, x.shape[1], cfg.d_model))
    hidden, aux = forward_hidden(params, x, cfg, perf, layout)
    labels = batch["labels"].long()
    if cfg.causal:
        # next-token prediction: shift left
        hidden = hidden[:, :-1]
        labels = labels[:, 1:]
    head = _lm_head(params)
    split = head.shape[1] != cfg.vocab_size        # a vocab-parallel head on a mesh
    if split:
        hidden = layout.enter(hidden)
    s = hidden.shape[1]
    chunk = min(perf.loss_chunk, s)
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, s, chunk):
        hc, lc = hidden[:, start:start + chunk], labels[:, start:start + chunk]
        logits = (hc @ head).float()
        if layout is not None:
            logits = layout.check(logits, ("batch", None, "act_vocab"), (rows, hc.shape[1], cfg.vocab_size))
        if split:
            lse, ll = _vocab_parallel_lse_and_pick(logits, lc, layout)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, lc.clamp(min=0)[..., None])[..., 0]
        mask = (lc != -1).float()
        nll = nll + torch.sum((lse - ll) * mask)
        count = count + torch.sum(mask)
    if layout is not None:                      # every rank's labels
        count = ranks.psum(count, layout.batch_axes, layout.mesh, tag="loss")
    loss = nll / torch.clamp(count, min=1.0)
    return loss + aux_weight * aux


def _embed_sharded(embed: torch.Tensor, tokens: torch.Tensor, cfg: ArchConfig, layout) -> torch.Tensor:
    """The token embedding from this rank's rows of ``embed``: a row
    outside the block gives 0, and the parts are summed over ``model``."""
    tok = tokens.long()
    n = embed.shape[0]
    if n == cfg.vocab_size:
        return embed[tok]
    local = tok - layout.tp_index * n
    inside = (local >= 0) & (local < n)
    rows = embed[local.clamp(0, n - 1)]
    return layout.exit(torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))


def _vocab_parallel_lse_and_pick(logits: torch.Tensor, labels: torch.Tensor, layout):
    """The log-sum-exp over the whole vocabulary and the label's logit from
    this rank's columns of it: the max and the sums over ``model``."""
    n = logits.shape[-1]
    top = ranks.all_gather(logits.detach().amax(-1, keepdim=True), layout.tp, -1, layout.mesh,
                           tag="tensor parallel").amax(-1)
    lse = top + torch.log(layout.exit(torch.sum(torch.exp(logits - top[..., None]), dim=-1)))
    local = labels - layout.tp_index * n
    inside = (local >= 0) & (local < n)
    pick = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse, layout.exit(torch.where(inside, pick, torch.zeros((), device=pick.device)))


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    caches: list           # per period: {"pos{i}": KVCache or SSMCache}


def init_decode_state(
    cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda",
    kv_heads: int | None = None,
) -> DecodeState:
    """Empty caches for every period on ``device`` (the card by default;
    raises without one unless ``device="cpu"``), each its own tensors since
    decode writes them in place; ``kv_heads`` as ``attention.init_cache``
    takes it (a serving rank's, ``attention.cache_heads``)."""
    caches = []
    for _ in range(num_periods(cfg)):
        period = {}
        for i in range(period_len(cfg)):
            if cfg.layer_kind(i) == "attn":
                period[f"pos{i}"] = attn.init_cache(cfg, batch, max_len, dtype, device, kv_heads)
            else:
                period[f"pos{i}"] = m2.init_ssm_cache(cfg, batch, dtype, device)
        caches.append(period)
    return DecodeState(caches=caches)


def _serving_params(params: dict, layout) -> dict:
    """The top-level leaves fetched over their FSDP axes (all of them with
    ``gather_weights_once``); the periods are fetched one at a time."""
    if layout.gathered:
        return layout.gather_all(params)
    return {**layout.fetch({k: v for k, v in params.items() if k != "periods"}, ""),
            "periods": params["periods"]}


def _serving_blocks(params: dict, cfg: ArchConfig, layout):
    """:func:`blocks` of a serving step: each period fetched (by
    ``layout``, when given) as it is reached."""
    for p in range(num_periods(cfg)):
        period = _layer(params["periods"], p)
        if layout is not None:
            period = layout.fetch(period, "periods", stacked=True)
        for i in range(period_len(cfg)):
            yield i, period[f"pos{i}"]


def prefill(
    params: dict,
    batch: dict,
    cfg: ArchConfig,
    max_len: int,
    perf: PerfConfig = BASELINE,
    long_context: bool = False,
    layout=None,
) -> tuple[torch.Tensor, DecodeState]:
    """Full-context forward that materializes decode caches.
    Returns (last-position logits (B, V), state).  ``long_context`` names
    the reference's long-cache placement, which a mesh takes in a later
    slice (``model_zoo.serving_layout`` raises); with a serving ``layout``
    this rank's rows on local blocks (module docstring)."""
    if layout is None:
        x = embed_inputs(params, batch, cfg)
    else:
        params = _serving_params(params, layout)
        x = _embed_sharded(params["embed"], batch["tokens"], cfg, layout)
    caches: list = []
    for pos, bp in _serving_blocks(params, cfg, layout):
        if pos == 0:
            caches.append({})
        x, caches[-1][f"pos{pos}"] = prefill_block(bp, x, cfg, pos, max_len, perf, layout)
        if layout is not None:
            b, s, d = x.shape
            x = layout.check(x, ("batch", "act_seq", None), (b * layout.batch_size, s, d))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_at(params, x[:, -1:, :], cfg, layout)[:, 0]
    return logits, DecodeState(caches=caches)


def decode_step(
    params: dict,
    state: DecodeState,
    token: torch.Tensor,         # (B,) int
    cfg: ArchConfig,
    perf: PerfConfig = BASELINE,
    long_context: bool = False,
    layout=None,
) -> tuple[torch.Tensor, DecodeState]:
    """One decode step for every sequence in the batch → (logits (B,V), state);
    with a serving ``layout`` this rank's rows on local blocks."""
    if layout is None:
        x = params["embed"][token.long()[:, None]]
    else:
        params = _serving_params(params, layout)
        x = _embed_sharded(params["embed"], token[:, None], cfg, layout)
        x = layout.check(x, ("batch", None, None), (x.shape[0] * layout.batch_size, 1, cfg.d_model))
    caches: list = []
    for layer, (pos, bp) in enumerate(_serving_blocks(params, cfg, layout)):
        if pos == 0:
            caches.append({})
        old = state.caches[layer // period_len(cfg)][f"pos{pos}"]
        x, caches[-1][f"pos{pos}"] = decode_block(bp, x, old, cfg, pos, layout)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = logits_at(params, x, cfg, layout)[:, 0]
    return logits, DecodeState(caches=caches)
